"""K2, the fused optimizer updates, held against the JAX package on the
CPU: the plain versions of ``ops/fused_opt.py`` and the port's update
ops equal the JAX package's jitted ``mx.nd.sgd_mom_update`` /
``mx.nd.adam_update`` (and ``sgd_update``) bitwise; they stay within the
JAX package's own 2e-6 of its Pallas kernels run in interpret mode; the
in-place call surface writes the states back and honours ``out=``; and
a CPU tensor never launches the kernel."""
import torch_test_env  # noqa: F401  (first: one torch thread a process)

from fractions import Fraction

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as tmx
from mxnet_tpu.ops import pallas_kernels as pk
from mxnet_tpu_torch.ops import fused_opt

F32 = np.float32
CPU = tmx.cpu()
SIZES = [1, 37, 1024, 1_000_003]

SGD_CASES = {
    "plain": dict(lr=0.1, momentum=0.9, wd=1e-4, rescale_grad=1 / 128),
    "clip": dict(lr=0.037, momentum=0.87, wd=3e-4, rescale_grad=1 / 3,
                 clip_gradient=0.25),
    "no_wd": dict(lr=0.05, momentum=0.9, wd=0.0, rescale_grad=0.7),
    "unit_factors": dict(lr=0.2, momentum=1.0, wd=5e-4, rescale_grad=1.0),
    "defaults": dict(),
}
ADAM_CASES = {
    "plain": dict(lr=0.01, wd=1e-4, rescale_grad=1 / 32),
    "clip": dict(lr=0.0037, beta1=0.85, beta2=0.99, epsilon=1e-6, wd=3e-4,
                 rescale_grad=1 / 3, clip_gradient=0.25),
    "no_wd": dict(lr=0.002, wd=0.0, rescale_grad=0.7),
    "unit_rescale": dict(lr=0.001, wd=2e-4, rescale_grad=1.0),
}


def _inputs(n, seed, k):
    """Weights, gradients and states at the scales training gives them;
    the last array (Adam's variance) is non-negative with zeros."""
    rng = np.random.default_rng(seed)
    scales = (0.05, 3.0, 0.01, 1e-3)[:k]
    out = [(rng.standard_normal(n) * s).astype(F32) for s in scales]
    if k == 4:
        out[3] = np.abs(out[3])
        out[3][::7] = 0
    return out


def _t(x):
    return torch.from_numpy(np.array(x))


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


def test_fma32_rounds_once():
    """The f32 FMA of the plain versions against exact rationals, and on
    a case where rounding the f64 sum first lands on an f32 tie."""
    a, b, c = F32(1 + 2 ** -12), F32((1 - 2 ** -12 + 2 ** -24) * 2 ** -24), \
        F32(1)
    assert float(F32(float(a) * float(b) + float(c))) == 1.0   # the trap
    got = fused_opt.fma32(_t([a, -a]), float(b), _t([c, -c])).numpy()
    _same(got, np.array([1 + 2 ** -23, -1 - 2 ** -23], F32))
    rng = np.random.default_rng(5)
    x, y, z = (rng.standard_normal(500).astype(F32)
               * F32(2.0) ** rng.integers(-30, 30, 500).astype(F32)
               for _ in range(3))
    got = fused_opt.fma32(_t(x), float(y[0]), _t(z)).numpy()
    for xi, zi, gi in zip(x, z, got):
        exact = Fraction(float(xi)) * Fraction(float(y[0])) + \
            Fraction(float(zi))
        near = [np.nextafter(gi, F32(-np.inf)), gi,
                np.nextafter(gi, F32(np.inf))]
        errs = [abs(Fraction(float(v)) - exact) for v in near]
        assert errs[1] == min(errs)


@pytest.mark.parametrize("case", sorted(SGD_CASES))
@pytest.mark.parametrize("n", SIZES)
def test_sgd_mom_plain_and_op_equal_jax_bitwise(n, case):
    hp = SGD_CASES[case]
    w, g, m = _inputs(n, n % 97, 3)
    jw, jm = mx.nd.array(w), mx.nd.array(m)
    mx.nd.sgd_mom_update(jw, mx.nd.array(g), jm, out=jw, **hp)
    want_w, want_m = jw.asnumpy(), jm.asnumpy()
    got_w, got_m = fused_opt.sgd_mom_plain(_t(w), _t(g), _t(m), **hp)
    _same(want_w, got_w.numpy())
    _same(want_m, got_m.numpy())
    with tmx.cpu():
        tw, tm = tmx.nd.array(w), tmx.nd.array(m)
        tmx.nd.sgd_mom_update(tw, tmx.nd.array(g), tm, out=tw, **hp)
    _same(want_w, tw.asnumpy())
    _same(want_m, tm.asnumpy())


@pytest.mark.parametrize("case", sorted(ADAM_CASES))
@pytest.mark.parametrize("n", SIZES)
def test_adam_plain_and_op_equal_jax_bitwise(n, case):
    hp = ADAM_CASES[case]
    w, g, m, v = _inputs(n, n % 89, 4)
    jw, jm, jv = mx.nd.array(w), mx.nd.array(m), mx.nd.array(v)
    mx.nd.adam_update(jw, mx.nd.array(g), jm, jv, out=jw, **hp)
    want = [jw.asnumpy(), jm.asnumpy(), jv.asnumpy()]
    got = fused_opt.adam_plain(_t(w), _t(g), _t(m), _t(v), **hp)
    for a, b in zip(want, got):
        _same(a, b.numpy())
    with tmx.cpu():
        tw, tm, tv = tmx.nd.array(w), tmx.nd.array(m), tmx.nd.array(v)
        tmx.nd.adam_update(tw, tmx.nd.array(g), tm, tv, out=tw, **hp)
    for a, b in zip(want, (tw, tm, tv)):
        _same(a, b.asnumpy())


@pytest.mark.parametrize("hp", [
    dict(lr=0.1, wd=1e-4, rescale_grad=1 / 3),
    dict(lr=0.05, wd=0.0, rescale_grad=0.7, clip_gradient=0.5),
    dict(lr=0.3, wd=2e-3, rescale_grad=1.0, clip_gradient=1.0)],
    ids=["wd", "clip_no_wd", "clip_wd"])
def test_sgd_update_equals_jax_bitwise(hp):
    w, g = _inputs(4099, 3, 2)
    want = mx.nd.sgd_update(mx.nd.array(w), mx.nd.array(g), **hp)
    with tmx.cpu():
        got = tmx.nd.sgd_update(tmx.nd.array(w), tmx.nd.array(g), **hp)
    _same(want.asnumpy(), got.asnumpy())


@pytest.mark.parametrize("clip", [-1.0, 0.5])
@pytest.mark.parametrize("n", [16 * 128, 40 * 128])
def test_plain_versions_match_pallas_interpret(n, clip):
    """Within the JAX package's own 2e-6 of its Pallas kernels, run as
    its tests run them on the CPU."""
    import jax.numpy as jnp
    w, g, m, v = _inputs(n, 11, 4)
    sgd = dict(lr=0.05, momentum=0.9, wd=1e-4, rescale_grad=1 / 32,
               clip_gradient=clip)
    want = pk.fused_sgd_mom(*(jnp.asarray(a) for a in (w, g, m)), **sgd,
                            force=True, interpret=True)
    got = fused_opt.sgd_mom_plain(_t(w), _t(g), _t(m), **sgd)
    for a, b in zip(want, got):
        assert np.abs(np.asarray(a) - b.numpy()).max() <= 2e-6
    adam = dict(lr=0.01, wd=1e-4, rescale_grad=1 / 32, clip_gradient=clip)
    want = pk.fused_adam(*(jnp.asarray(a) for a in (w, g, m, v)), **adam,
                         force=True, interpret=True)
    got = fused_opt.adam_plain(_t(w), _t(g), _t(m), _t(v), **adam)
    for a, b in zip(want, got):
        assert np.abs(np.asarray(a) - b.numpy()).max() <= 2e-6


def test_inplace_surface_writes_states_and_honours_out():
    w, g, m, v = _inputs(300, 7, 4)
    hp = dict(lr=0.1, momentum=0.9, wd=1e-4)
    want_w, want_m = fused_opt.sgd_mom_plain(_t(w), _t(g), _t(m), **hp)
    with tmx.cpu():
        # positional states, out=None: a new weight, states in place
        tw, tg, tm = (tmx.nd.array(a) for a in (w, g, m))
        mom_tensor = tm._data
        res = tmx.nd.sgd_mom_update(tw, tg, tm, **hp)
        _same(want_w.numpy(), res.asnumpy())
        _same(w, tw.asnumpy())
        _same(want_m.numpy(), tm.asnumpy())
        assert tm._data is mom_tensor           # written, not rebound
        # keyword states, out= a third array
        tm2, dst = tmx.nd.array(m), tmx.nd.zeros(w.shape)
        res = tmx.nd.sgd_mom_update(weight=tw, grad=tg, mom=tm2, out=dst,
                                    **hp)
        assert res is dst
        _same(want_w.numpy(), dst.asnumpy())
        _same(want_m.numpy(), tm2.asnumpy())
        # Adam, states by keyword, out= the weight itself
        ta, tb = tmx.nd.array(m), tmx.nd.array(v)
        weight = tw._data
        tmx.nd.adam_update(tw, tg, mean=ta, var=tb, out=tw, lr=0.01)
        assert tw._data is weight
        want = fused_opt.adam_plain(_t(w), _t(g), _t(m), _t(v), lr=0.01)
        for a, b in zip(want, (tw, ta, tb)):
            _same(a.numpy(), b.asnumpy())
        # the registered op itself stays pure
        tw = tmx.nd.array(w)
        out = tmx.nd.invoke("sgd_mom_update", [tw, tg, tm2], hp)
        _same(w, tw.asnumpy())
        assert len(out) == 2


def test_cpu_tensors_take_the_plain_version():
    fused_opt.reset_launches()
    w, g, m, v = (_t(a) for a in _inputs(64, 2, 4))
    fused_opt.fused_sgd_mom(w, g, m, out=(w, m))
    fused_opt.fused_adam(w, g, m, v)
    assert fused_opt.fused_sgd_mom.launches == 0
    assert fused_opt.fused_adam.launches == 0
    # what the kernel would be refused: arrays of different shapes
    with pytest.raises(tmx.MXNetError):
        fused_opt._check("fused_sgd_mom", (w, g[:3], m), w.device)
