"""bfloat16 through the port's NDArray and the ops of the bf16 decoder
path, against the JAX package on the same values: a bf16 NDArray's
``dtype``, ``asnumpy()`` and ``nd.array(dtype="bfloat16")``;
``FullyConnected`` with mixed and bf16 operands, ``LayerNorm``,
``Embedding`` and ``Activation`` in bf16, forward and gradient;
``SoftmaxCrossEntropyLoss`` on bf16 logits; and the Adam class's
multi-precision update on a bf16 weight.

Bounds. One bf16 rounding of the same f32 value is exact; two roundings
of f32 values that differ in their last bits land at most one bf16 ulp
apart, and an ulp of a bf16 value is at most 2^-7 of it (``ULP``). Where
a function rounds to bf16 at several places (LayerNorm's normalised
value, its gradient, the log-softmax), the two packages may round an
intermediate to neighbouring values, and each bound names how many such
steps it allows. f32 results whose sums run in another order: rtol 1e-5.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import registry

CPU = tmx.cpu()
ULP = 2.0 ** -7
F32_RTOL = 1e-5


def _np(a):
    return np.asarray(a.asnumpy(), np.float32) \
        if hasattr(a, "asnumpy") else np.asarray(a, np.float32)


def test_bf16_ndarray_dtype_and_asnumpy_equal_jax():
    x = np.arange(6, dtype=np.float32).reshape(2, 3) / 3
    j = mx.nd.array(x).astype("bfloat16")
    t = tmx.nd.array(x, ctx=CPU).astype("bfloat16")
    assert t.dtype == j.dtype and str(t.dtype) == "bfloat16"
    jn, tn = j.asnumpy(), t.asnumpy()
    assert tn.dtype == jn.dtype and tn.shape == jn.shape
    np.testing.assert_array_equal(tn.view(np.uint16), jn.view(np.uint16))
    # nd.array(dtype="bfloat16") rounds to nearest even, as JAX's astype
    jd = mx.nd.array(x, dtype="bfloat16")
    td = tmx.nd.array(x, ctx=CPU, dtype="bfloat16")
    assert td.dtype == jd.dtype
    np.testing.assert_array_equal(td.asnumpy().view(np.uint16),
                                  jd.asnumpy().view(np.uint16))
    # a bf16 numpy array (the JAX package's asnumpy) in, bit for bit
    back = tmx.nd.array(jn, ctx=CPU)
    assert back.dtype == jn.dtype
    np.testing.assert_array_equal(back.asnumpy().view(np.uint16),
                                  jn.view(np.uint16))
    assert tmx.nd.array(t, ctx=CPU).dtype == t.dtype
    assert float(t[1, 2].asscalar()) == float(jn[1, 2])
    # a 0-d bf16 array (a scalar loss read through asnumpy) keeps shape ()
    j0 = j.sum().asnumpy()
    t0 = tmx.nd.array(j0, ctx=CPU)
    assert j0.shape == () and t0.shape == () and t0.dtype == j0.dtype
    np.testing.assert_array_equal(t0.asnumpy().view(np.uint16),
                                  j0.view(np.uint16))


def test_bf16_asnumpy_without_ml_dtypes_raises(monkeypatch):
    """Without ml_dtypes numpy has no bfloat16: asnumpy raises rather
    than return another dtype; the values stay readable through torch."""
    import builtins
    real_import = builtins.__import__

    def no_ml_dtypes(name, *a, **kw):
        if name == "ml_dtypes":
            raise ImportError(name)
        return real_import(name, *a, **kw)

    t = tmx.nd.array([1.5, 2.25], ctx=CPU, dtype="bfloat16")
    monkeypatch.setattr(builtins, "__import__", no_ml_dtypes)
    with pytest.raises(MXNetError, match="ml_dtypes"):
        t.asnumpy()
    with pytest.raises(MXNetError, match="ml_dtypes"):
        t.dtype
    assert t._data.float().tolist() == [1.5, 2.25]
    assert registry.numpy_dtype(torch.float32) == np.float32


def _grads(pkg, op, arrays, dtypes, head, **attrs):
    """Output and input gradients of ``op`` under autograd, each input
    made in its dtype from the same f32 values."""
    ctx = {"ctx": CPU} if pkg is tmx else {}
    xs = []
    for a, dt in zip(arrays, dtypes):
        x = pkg.nd.array(a, **ctx)
        if dt != "float32":
            x = x.astype(dt)
        x.attach_grad()
        xs.append(x)
    with pkg.autograd.record():
        out = getattr(pkg.nd, op)(*xs, **attrs)
    h = pkg.nd.array(head, **ctx)
    out.backward(h.astype(str(out.dtype)) if str(out.dtype) != "float32"
                 else h)
    return out, [x.grad for x in xs]


def _both(op, arrays, dtypes, seed, head_out=None, **attrs):
    """(port, JAX) outputs and per input (port, JAX) gradients for a
    seeded head gradient (appended to ``head_out`` when given)."""
    rng = np.random.default_rng(seed)
    jout = getattr(mx.nd, op)(*[
        mx.nd.array(a).astype(dt) for a, dt in zip(arrays, dtypes)], **attrs)
    head = rng.standard_normal(jout.shape).astype(np.float32)
    if head_out is not None:
        head_out.append(head)
    jout, jgrads = _grads(mx, op, arrays, dtypes, head, **attrs)
    tout, tgrads = _grads(tmx, op, arrays, dtypes, head, **attrs)
    assert str(tout.dtype) == str(jout.dtype)
    for tg, jg in zip(tgrads, jgrads):
        assert str(tg.dtype) == str(jg.dtype)
    return (_np(tout), _np(jout)), [(_np(a), _np(b))
                                    for a, b in zip(tgrads, jgrads)]


@pytest.mark.parametrize("dtypes,out_type", [
    (("float32", "bfloat16", "bfloat16"), "float32"),
    (("bfloat16", "bfloat16", "bfloat16"), "bfloat16"),
    (("float32", "bfloat16", "float32"), "float32")])
def test_fully_connected_promotes_as_jax(dtypes, out_type):
    """f32 data x bf16 weight gives f32 (the decoder's second Dense on),
    bf16 x bf16 gives bf16; each gradient in its input's type. f32
    results: rtol 1e-5; bf16 products, each one rounding of an f32 sum:
    one ulp. A bf16 bias's gradient sums the head over the n = 10 rows:
    the port rounds the f32 sum once (half an ulp, 2^-8 of it), JAX
    rounds after each add of a bf16 running sum, up to 2^-8 of
    (n - 1) sum |head| in all."""
    rng = np.random.default_rng(1)
    arrays = [rng.standard_normal((2, 5, 16)).astype(np.float32),
              rng.standard_normal((12, 16)).astype(np.float32),
              rng.standard_normal(12).astype(np.float32)]
    heads = []
    (t, j), grads = _both("FullyConnected", arrays, dtypes, 2,
                          head_out=heads, num_hidden=12, flatten=False)
    rtol = F32_RTOL if out_type == "float32" else ULP
    np.testing.assert_allclose(t, j, rtol=rtol, atol=1e-6)
    for (a, b), dt in zip(grads[:2], dtypes):
        np.testing.assert_allclose(
            a, b, rtol=F32_RTOL if dt == "float32" else ULP, atol=1e-6)
    (a, b), head = grads[2], heads[0]
    if dtypes[2] == "float32":
        np.testing.assert_allclose(a, b, rtol=F32_RTOL, atol=1e-6)
    else:
        hb = torch.from_numpy(head).bfloat16().float().numpy()
        n = hb.shape[0] * hb.shape[1]
        bound = 2.0 ** -8 * (np.abs(b) + (n - 1) * np.abs(hb).sum((0, 1)))
        assert (np.abs(a - b) <= bound).all()


@pytest.mark.parametrize("gamma_type", ["float32", "bfloat16"])
def test_layer_norm_bf16_matches_jax(gamma_type):
    """bf16 data; gamma / beta f32 (the bf16 decoder's LayerNorm) or bf16
    (the block after ``cast``). The mean and variance are taken in f32
    and rounded once on both sides, the rest rounds at each op: up to
    two neighbouring roundings reach the output (two ulps) and four the
    data's gradient."""
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((4, 32)) * 3 + 1).astype(np.float32)
    g = rng.uniform(0.5, 1.5, 32).astype(np.float32)
    b = rng.standard_normal(32).astype(np.float32)
    dtypes = ("bfloat16", gamma_type, gamma_type)
    (t, j), grads = _both("LayerNorm", [x, g, b], dtypes, 4)
    scale = np.abs(j).max()
    np.testing.assert_allclose(t, j, rtol=2 * ULP, atol=2 * ULP * scale)
    gx = grads[0]
    np.testing.assert_allclose(gx[0], gx[1], rtol=4 * ULP,
                               atol=4 * ULP * np.abs(gx[1]).max())
    for a, w in grads[1:]:
        np.testing.assert_allclose(a, w, rtol=4 * ULP,
                                   atol=4 * ULP * np.abs(w).max())


def test_embedding_and_relu_bf16_match_jax():
    """Row lookup and ReLU are exact in bf16, forward and gradient (each
    vocabulary row's gradient sums at most two rows here: one rounding
    of an exact sum)."""
    rng = np.random.default_rng(5)
    idx = np.array([[0, 3, 5, 3], [7, 1, 0, 6]], np.float32)
    w = rng.standard_normal((8, 6)).astype(np.float32)
    (t, j), grads = _both("Embedding", [idx, w], ("float32", "bfloat16"), 6,
                          input_dim=8, output_dim=6)
    np.testing.assert_array_equal(t, j)
    np.testing.assert_array_equal(grads[1][0], grads[1][1])
    x = rng.standard_normal((3, 7)).astype(np.float32)
    (t, j), grads = _both("Activation", [x], ("bfloat16",), 7,
                          act_type="relu")
    np.testing.assert_array_equal(t, j)
    np.testing.assert_array_equal(*grads[0])


def test_softmax_cross_entropy_loss_on_bf16_logits_matches_jax():
    """The JAX loss on bf16 logits is bf16; so is the port's. Each side
    rounds the log-softmax and the mean over the sequence axis: the loss
    within two ulps, the logits' gradient within two ulps of its
    scale."""
    rng = np.random.default_rng(8)
    logits = (rng.standard_normal((2, 6, 11)) * 2).astype(np.float32)
    label = rng.integers(0, 11, (2, 6)).astype(np.float32)
    out = {}
    for pkg in (mx, tmx):
        ctx = {"ctx": CPU} if pkg is tmx else {}
        z = pkg.nd.array(logits, **ctx).astype("bfloat16")
        z.attach_grad()
        with pkg.autograd.record():
            loss = pkg.gluon.loss.SoftmaxCrossEntropyLoss()(
                z, pkg.nd.array(label, **ctx))
        loss.backward()
        assert str(loss.dtype) == "bfloat16" and str(z.grad.dtype) == \
            "bfloat16"
        out[pkg] = (_np(loss), _np(z.grad))
    np.testing.assert_allclose(out[tmx][0], out[mx][0], rtol=2 * ULP)
    gscale = np.abs(out[mx][1]).max()
    np.testing.assert_allclose(out[tmx][1], out[mx][1], rtol=2 * ULP,
                               atol=2 * ULP * gscale)


def test_adam_multi_precision_update_is_bitwise_jax():
    """The Adam class with ``multi_precision`` on a bf16 weight: the f32
    master made from the weight, the bf16 gradient cast to f32, the
    master and both moments updated, the weight set to the master rounded
    to bf16 (nearest even). Given the same gradients, three updates
    equal the JAX Updater's bit for bit."""
    rng = np.random.default_rng(9)
    w0 = rng.standard_normal((33, 17)).astype(np.float32)
    grads = [rng.standard_normal(w0.shape).astype(np.float32) * 1e-2
             for _ in range(3)]
    hyper = dict(learning_rate=1e-3, wd=1e-4, rescale_grad=0.5,
                 multi_precision=True)
    res = {}
    for pkg in (mx, tmx):
        ctx = {"ctx": CPU} if pkg is tmx else {}
        w = pkg.nd.array(w0, **ctx).astype("bfloat16")
        upd = pkg.optimizer.get_updater(pkg.optimizer.create("adam",
                                                             **hyper))
        for g in grads:
            upd(0, pkg.nd.array(g, **ctx).astype("bfloat16"), w)
        master, (m, v) = upd.states[0]
        assert str(w.dtype) == "bfloat16" and str(master.dtype) == "float32"
        res[pkg] = [w.asnumpy().view(np.uint16)] + [
            x.asnumpy() for x in (master, m, v)]
    for a, b in zip(res[tmx], res[mx]):
        np.testing.assert_array_equal(a, b)
