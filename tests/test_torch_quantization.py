"""The port's INT8 inference path held against the JAX package on the CPU:
every quantized op and the requantize epilogue (K1) bitwise, the
quantization flow (BatchNorm folding, the QuantizeGraph pass, the XLA
partition), and the slice end to end: a resnet18_v1 checkpoint the JAX
package wrote, quantized and calibrated by the JAX package, gives
bitwise the JAX package's fused INT8 logits through the port.

Inputs are made with numpy from fixed seeds and handed to both packages;
the JAX package runs its Pallas kernel in interpret mode, as its own
tests do.
"""
import torch_test_env  # noqa: F401  (first: one torch thread a process)

import collections
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as tmx
from mxnet_tpu.contrib import quantization as jq
from mxnet_tpu.ops import pallas_kernels as pk
from mxnet_tpu.ops import quantized as jqops
from mxnet_tpu.subgraph import partition_graph as j_partition
from mxnet_tpu_torch.contrib import quantization as tq
from mxnet_tpu_torch.ops import int8 as tint8
from mxnet_tpu_torch.ops import quantized as tqops

F32 = np.float32
CPU = tmx.cpu()
ZOO = os.path.join(os.path.dirname(tmx.__file__), "model_zoo")


@pytest.fixture(autouse=True)
def _always_fire_partitioner(monkeypatch):
    # the port partitions without the JAX package's HLO cost gate
    monkeypatch.setenv("MXTPU_FUSE_COST", "0")


def _assert_same(j, t):
    j, t = np.asarray(j), np.asarray(t)
    assert j.dtype == t.dtype and j.shape == t.shape, (j.dtype, t.dtype,
                                                       j.shape, t.shape)
    np.testing.assert_array_equal(t, j)


def _both(op, arrays, attrs):
    """Run ``op`` eagerly in both packages on the same numpy inputs and
    assert every output is bitwise equal."""
    j = mx.nd.invoke(op, [mx.nd.array(a) for a in arrays], dict(attrs))
    t = tmx.nd.invoke(op, [tmx.nd.array(a, ctx=CPU) for a in arrays],
                      dict(attrs))
    j = j if isinstance(j, tuple) else (j,)
    t = t if isinstance(t, tuple) else (t,)
    assert len(j) == len(t)
    for a, b in zip(j, t):
        _assert_same(a.asnumpy(), b.asnumpy())
    return [b.asnumpy() for b in t]


def _i8(rng, shape):
    return rng.integers(-127, 128, shape).astype(np.int8)


def _range(rng, lo=0.5, hi=8.0):
    a = F32(rng.uniform(lo, hi))
    return F32(-a * F32(rng.uniform(0.5, 1.0))), a


# ---------------------------------------------------------------------------
# K1: the requantize epilogue
# ---------------------------------------------------------------------------

def _epilogue_cases():
    rng = np.random.default_rng(0)
    # exact .5 ties and both clip edges: acc * 2^-3 * 4 = acc / 2
    ties = np.arange(-300, 300, dtype=np.int32)
    ties = np.concatenate([ties, [255, -255, 253, -253, 254, -254]])
    real = rng.integers(-(2 ** 30), 2 ** 30, 4 * 64 * 8 * 8,
                        dtype=np.int64).astype(np.int32)
    return [("ties", ties, F32(0.125), F32(4.0)),
            ("odd", real[:1237], F32(3.7e-9), F32(2.9e7)),
            ("tiled", real.reshape(4, 64, 8, 8), F32(4.1e-9), F32(3.3e7))]


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("case", _epilogue_cases(), ids=lambda c: c[0])
def test_epilogue_plain_equals_reference_and_pallas(case, relu):
    _, acc, s_in, s_out = case
    want = np.asarray(pk._int8_epilogue_reference(
        jnp.asarray(acc), jnp.float32(s_in), jnp.float32(s_out), relu))
    import torch
    got = tint8.int8_conv_epilogue_plain(torch.from_numpy(acc), s_in,
                                         s_out, relu)
    _assert_same(want, got.numpy())
    # the wrapper takes the plain version for a CPU tensor
    _assert_same(want, tint8.int8_conv_epilogue(
        torch.from_numpy(acc), torch.tensor(s_in), s_out, relu).numpy())
    if acc.size % 128 == 0 and acc.size >= 1024:
        pallas = pk.int8_conv_epilogue(jnp.asarray(acc), s_in, s_out,
                                       relu=relu, force=True)
        _assert_same(np.asarray(pallas), got.numpy())


@pytest.mark.parametrize("calibrated", [True, False])
@pytest.mark.parametrize("relu", [False, True])
def test_quantized_conv_epilogue_matches_jax(calibrated, relu):
    import torch
    rng = np.random.default_rng(1)
    acc = rng.integers(-(2 ** 29), 2 ** 29, (2, 64, 8, 8),
                       dtype=np.int64).astype(np.int32)
    mn, mx_ = _range(rng, 1e3, 1e5)
    calib = dict(min_calib_range=-3.217, max_calib_range=2.5) \
        if calibrated else {}
    want = pk.quantized_conv_epilogue(jnp.asarray(acc), jnp.float32(mn),
                                      jnp.float32(mx_), relu=relu,
                                      force=True, **calib)
    got = tint8.quantized_conv_epilogue(
        torch.from_numpy(acc), torch.tensor(mn), torch.tensor(mx_),
        relu=relu, **calib)
    for w, g in zip(want, got):
        _assert_same(np.asarray(w), np.asarray(g))


# ---------------------------------------------------------------------------
# the quantized ops, eagerly in both packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("calibrated", [True, False])
def test_quantize_v2(calibrated):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((3, 5, 7)).astype(F32) * 3
    # ties: with range 127 the scale is 1 and k + 0.5 rounds to even
    x[0, 0, :] = np.arange(-3.5, 3.5, 1.0, dtype=F32)
    attrs = dict(min_calib_range=-127.0, max_calib_range=120.0) \
        if calibrated else {}
    _both("_contrib_quantize_v2", [x], attrs)


def test_dequantize_and_requantize():
    rng = np.random.default_rng(3)
    mn, mx_ = _range(rng)
    _both("_contrib_dequantize", [_i8(rng, (4, 9)), mn, mx_], {})
    acc = rng.integers(-(2 ** 31) + 1, 2 ** 31 - 1, (6, 33),
                       dtype=np.int64).astype(np.int32)
    big = _range(rng, 1e2, 1e4)
    _both("_contrib_requantize", [acc, *big], {})
    _both("_contrib_requantize", [acc, *big],
          dict(min_calib_range=-1.5, max_calib_range=7.25))


CONV_CASES = [
    dict(kernel=(3, 3), pad=(1, 1), num_filter=8),
    dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1), num_filter=8,
         num_group=2, no_bias=True),
    dict(kernel=(3, 3), dilate=(2, 2), pad=(2, 2), num_filter=16),
    dict(kernel=(1, 1), stride=(2, 2), num_filter=8, no_bias=True),
    dict(kernel=(7, 7), stride=(2, 2), pad=(3, 3), num_filter=8),
]


@pytest.mark.parametrize("attrs", CONV_CASES,
                         ids=lambda a: "k{kernel[0]}s{s}g{g}b{b}".format(
                             s=a.get("stride", (1,))[0],
                             g=a.get("num_group", 1),
                             b=int(not a.get("no_bias", False)), **a))
def test_quantized_conv(attrs):
    rng = np.random.default_rng(4)
    c, nf = 4, attrs["num_filter"]
    g = attrs.get("num_group", 1)
    data = _i8(rng, (2, c, 9, 9))
    weight = _i8(rng, (nf, c // g) + attrs["kernel"])
    ins = [data, weight]
    if not attrs.get("no_bias"):
        ins.append(_i8(rng, (nf,)))
    for _ in range(len(ins)):
        ins.extend(_range(rng))
    # reference arity: arrays first, then the (min, max) pair per array
    arrays = ins[:len(ins) // 3]
    pairs = ins[len(ins) // 3:]
    _both("_contrib_quantized_conv", arrays + pairs, attrs)


@pytest.mark.parametrize("no_bias", [False, True])
def test_quantized_fully_connected(no_bias):
    rng = np.random.default_rng(5)
    arrays = [_i8(rng, (3, 2, 10)), _i8(rng, (12, 20))]
    if not no_bias:
        arrays.append(_i8(rng, (12,)))
    pairs = [v for _ in arrays for v in _range(rng)]
    _both("_contrib_quantized_fully_connected", arrays + pairs,
          dict(num_hidden=12, no_bias=no_bias))


@pytest.mark.parametrize("attrs", [
    dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1), pool_type="max"),
    dict(kernel=(7, 7), pool_type="avg", global_pool=True),
    dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1), pool_type="avg",
         count_include_pad=False),
    dict(kernel=(3, 3), stride=(2, 2), pool_type="avg",
         pooling_convention="full"),
], ids=["max", "global_avg", "avg_nopad", "avg_full"])
def test_quantized_pooling(attrs):
    rng = np.random.default_rng(6)
    _both("_contrib_quantized_pooling",
          [_i8(rng, (2, 3, 8, 8)), *_range(rng)], attrs)


def test_quantized_avg_pool_divides_by_the_f32_reciprocal():
    """XLA lowers the JAX op's window-sum / 14 to sum * f32(1/14); on
    these sums the two round to different integers."""
    f32_inv, n = F32(1) / F32(14), 14
    sums = [s for s in range(-127 * n, 127 * n + 1)
            if np.rint(F32(s) * f32_inv) != np.rint(F32(s) / F32(n))
            and abs(s) >= 127 * (n - 2)]
    assert sums
    # one 2x7 window per channel whose values sum to s
    fill = np.sign(sums) * 127
    data = np.repeat(fill, n).reshape(1, len(sums), 2, 7).astype(np.int8)
    data[0, :, 1, 6] = np.asarray(sums) - fill * (n - 1)
    out = _both("_contrib_quantized_pooling", [data, F32(-1), F32(1)],
                dict(kernel=(2, 7), pool_type="avg"))[0]
    np.testing.assert_array_equal(
        out.ravel(), np.rint(np.asarray(sums, F32) * f32_inv))


def test_quantized_flatten_and_act():
    rng = np.random.default_rng(7)
    _both("_contrib_quantized_flatten", [_i8(rng, (2, 3, 4)),
                                         *_range(rng)], {})
    _both("_contrib_quantized_act", [_i8(rng, (2, 3, 4)), *_range(rng)],
          dict(act_type="relu"))


@pytest.mark.parametrize("calibrated", [True, False])
def test_quantized_elemwise_add(calibrated):
    rng = np.random.default_rng(8)
    attrs = dict(min_calib_range=-6.5, max_calib_range=9.25) \
        if calibrated else {}
    _both("_contrib_quantized_elemwise_add",
          [_i8(rng, (2, 4, 5, 5)), _i8(rng, (2, 4, 5, 5)), *_range(rng),
           *_range(rng)], attrs)


def test_elemwise_add_sum_is_the_fused_multiply_add():
    """Uncalibrated, the output range is max|lhs*ls + rhs*rs|: one
    element per call exposes the f32 sum itself, which XLA contracts to
    fma(lhs, ls, rhs*rs)."""
    rng = np.random.default_rng(9)
    for _ in range(200):
        ins = [_i8(rng, (1,)), _i8(rng, (1,)), *_range(rng), *_range(rng)]
        _both("_contrib_quantized_elemwise_add", ins, {})


def _static_range_cases(n):
    """(k, w) pairs for which w * f32(k / 127^2) (the folded form)
    differs from f32(k * w) / 127^2 (the runtime form)."""
    rng = np.random.default_rng(10)
    r = F32(1) / F32(16129)
    out = []
    while len(out) < n:
        k, w = F32(rng.uniform(0.5, 8)), F32(rng.uniform(0.01, 0.5))
        if w * (k * r) != (k * w) * r:
            out.append((k, w))
    return out


def test_constant_ranges_fold_as_xla_folds_them():
    """In a JAX graph a calibrated data range is a constant, and XLA
    folds it with 1/127^2 before the runtime weight range multiplies in;
    the port's executor carries that range as a host scalar and folds
    the same way (ops/quantized.py). The conv's output range shows it."""
    import torch
    data = np.zeros((1, 1, 3, 3), np.int8)
    weight = np.zeros((1, 1, 1, 1), np.int8)
    for k, w in _static_range_cases(8):
        def jax_graph(wmin, wmax, k=k):
            return jqops.quantized_conv(
                jnp.asarray(data), jnp.asarray(weight), jnp.float32(-k),
                jnp.float32(k), wmin, wmax, kernel=(1, 1), num_filter=1,
                no_bias=True)[2]
        want = jax.jit(jax_graph)(F32(-w), w)
        got = tqops.quantized_conv(
            torch.from_numpy(data), torch.from_numpy(weight), F32(-k), k,
            torch.tensor(-w), torch.tensor(w), kernel=(1, 1), num_filter=1,
            no_bias=True)[2]
        _assert_same(np.asarray(want), got.numpy())


# ---------------------------------------------------------------------------
# the quantization flow
# ---------------------------------------------------------------------------

def _params_for(sym, data_shape, seed, module):
    """Seeded fp32 params and BatchNorm statistics for ``sym``, as numpy."""
    rng = np.random.default_rng(seed)
    arg_shapes, _, aux_shapes = sym.infer_shape(data=data_shape)
    arg = {}
    for n, sh in zip(sym.list_arguments(), arg_shapes):
        if n == "data":
            continue
        if n.endswith("gamma"):
            v = rng.uniform(0.5, 1.5, sh)
        elif n.endswith("beta"):
            v = rng.uniform(-0.2, 0.2, sh)
        else:
            v = rng.standard_normal(sh) * np.sqrt(2.0 / np.prod(sh[1:]))
        arg[n] = v.astype(F32)
    aux = {}
    for n, sh in zip(sym.list_auxiliary_states(), aux_shapes):
        v = rng.uniform(-0.1, 0.1, sh) if "mean" in n \
            else rng.uniform(0.5, 2.0, sh)
        aux[n] = v.astype(F32)
    return arg, aux


def _jnd(d):
    return {k: mx.nd.array(v) for k, v in d.items()}


def _tnd(d):
    return {k: tmx.nd.array(v, ctx=CPU) for k, v in d.items()}


def _np(d):
    return {k: v.asnumpy() for k, v in d.items()}


def test_fold_batch_norm_matches_jax():
    """Both packages fold in numpy, so the folded weights and the
    rewritten graph are identical (bitwise, byte for byte)."""
    js = mx.sym.load(os.path.join(ZOO, "resnet50_v1-symbol.json"))
    ts = tmx.model_zoo.load_symbol("resnet50_v1")
    arg, aux = _params_for(js, (1, 3, 32, 32), 11, mx)
    jsym, jarg = jq.fold_batch_norm(js, _jnd(arg), _jnd(aux))
    tsym, targ = tq.fold_batch_norm(ts, _tnd(arg), _tnd(aux))
    assert tsym.tojson() == jsym.tojson()
    assert sorted(targ) == sorted(jarg)
    for k in jarg:
        _assert_same(jarg[k].asnumpy(), targ[k].asnumpy())


def test_resnet50_quantize_and_partition_counts_match_jax():
    """The QuantizeGraph pass and the XLA partition give the JAX
    package's graph on resnet50_v1 (no forward run: calib_mode none)."""
    js = mx.sym.load(os.path.join(ZOO, "resnet50_v1-symbol.json"))
    ts = tmx.model_zoo.load_symbol("resnet50_v1")
    arg, aux = _params_for(js, (1, 3, 32, 32), 12, mx)
    jqs, jqa, _ = jq.quantize_model(js, _jnd(arg), _jnd(aux),
                                    calib_mode="none")
    tqs, tqa, _ = tq.quantize_model(ts, _tnd(arg), _tnd(aux),
                                    calib_mode="none")
    assert tqs.tojson() == jqs.tojson()
    assert sorted(tqa) == sorted(jqa)
    jf, tf = j_partition(jqs, "XLA"), tqs.get_backend_symbol("XLA")
    assert tf.tojson() == jf.tojson()
    counts = collections.Counter(n.op for n in tf._topo() if n.op)
    assert counts == {
        "_sg_xla_quant_conv": 53, "_contrib_quantized_act": 16,
        "_contrib_quantized_elemwise_add": 16,
        "_contrib_quantized_pooling": 2,
        "_contrib_quantized_fully_connected": 1,
        "_contrib_requantize": 1, "_contrib_dequantize": 1}


# ---------------------------------------------------------------------------
# the slice end to end
# ---------------------------------------------------------------------------

R18_SHAPE = (2, 3, 32, 32)


@pytest.fixture(scope="module")
def r18(tmp_path_factory):
    """resnet18_v1 traced by the JAX package, checkpointed with its
    save_checkpoint, quantized (naive calibration, 8 seeded images),
    partitioned and run: the JAX side of the end-to-end comparison."""
    os.environ["MXTPU_FUSE_COST"] = "0"
    from mxnet_tpu.gluon.block import infer_shapes
    from mxnet_tpu.gluon.model_zoo import vision
    from mxnet_tpu.symbol.trace import trace_block
    net = vision.resnet18_v1()
    net.initialize()
    infer_shapes(net, (1,) + R18_SHAPE[1:])
    sym, _ = trace_block(net)
    arg, aux = _params_for(sym, R18_SHAPE, 13, mx)
    prefix = str(tmp_path_factory.mktemp("r18") / "resnet18_v1")
    mx.model.save_checkpoint(prefix, 0, sym, _jnd(arg), _jnd(aux))
    rng = np.random.default_rng(14)
    calib = rng.standard_normal((8,) + R18_SHAPE[1:]).astype(F32)
    x = rng.standard_normal(R18_SHAPE).astype(F32)
    qsym, qarg, qaux = jq.quantize_model(
        sym, _jnd(arg), _jnd(aux), calib_mode="naive",
        calib_data=mx.io.NDArrayIter(calib, batch_size=8),
        num_calib_examples=8)
    fused = qsym.get_backend_symbol("XLA")
    ex = fused.simple_bind(grad_req="null", data=R18_SHAPE,
                           **{k: v.shape for k, v in qarg.items()})
    ex.copy_params_from(qarg, qaux, allow_extra_params=True)
    logits = ex.forward(data=mx.nd.array(x))[0].asnumpy()
    return dict(prefix=prefix, qsym=qsym, qarg=_np(qarg), qaux=_np(qaux),
                fused=fused, calib=calib, x=x, logits=logits)


@pytest.mark.parametrize("epilogue", ["kernel", "unfused"])
def test_resnet18_int8_logits_bitwise_equal_jax(r18, epilogue,
                                                 monkeypatch):
    if epilogue == "unfused":
        monkeypatch.setenv("MXTPU_KERNEL_INT8_EPILOGUE", "0")
    tmx.ops.int8.reset_launches()
    with tmx.cpu():
        qsym = tmx.sym.load_json(r18["qsym"].tojson())
        qarg, qaux = tmx.model.params_from_jax(r18["qarg"], r18["qaux"])
        fused = qsym.get_backend_symbol("XLA")
        assert fused.tojson() == r18["fused"].tojson()
        ex = fused.simple_bind(grad_req="null", data=R18_SHAPE,
                               **{k: v.shape for k, v in qarg.items()})
        ex.copy_params_from(qarg, qaux, allow_extra_params=True)
        out = ex.forward(data=tmx.nd.array(r18["x"]))[0]
    assert out.context == CPU
    _assert_same(r18["logits"], out.asnumpy())
    # a CPU run takes the plain epilogue: the kernel is never launched
    assert tmx.ops.int8.int8_conv_epilogue.launches == 0


def test_resnet18_port_calibration_matches_jax(r18):
    """The port loads the JAX checkpoint and calibrates on its own: the
    same graph, ranges within rtol 1e-5 (fp32 convolutions sum in
    another order than XLA's)."""
    with tmx.cpu():
        sym, arg, aux = tmx.model.load_checkpoint(r18["prefix"], 0)
        qsym, qarg, _ = tq.quantize_model(
            sym, arg, aux, calib_mode="naive",
            calib_data=tmx.io.NDArrayIter(r18["calib"], batch_size=8),
            num_calib_examples=8)
    assert sorted(qarg) == sorted(r18["qarg"])
    for k, v in qarg.items():
        _assert_same(r18["qarg"][k], v.asnumpy())
    jnodes, tnodes = r18["qsym"]._topo(), qsym._topo()
    assert [(n.op, n.name) for n in jnodes] == [(n.op, n.name)
                                               for n in tnodes]
    baked = 0
    for a, b in zip(jnodes, tnodes):
        for key in ("min_calib_range", "max_calib_range"):
            assert (key in a.attrs) == (key in b.attrs)
            if key in a.attrs:
                baked += 1
                np.testing.assert_allclose(b.attrs[key], a.attrs[key],
                                           rtol=1e-5)
    assert baked > 40


@pytest.mark.slow
def test_resnet50_int8_at_224_bitwise_equal_jax(tmp_path):
    """The full-width model of chip_smoke.py, one image at 224x224."""
    shape = (1, 3, 224, 224)
    js = mx.sym.load(os.path.join(ZOO, "resnet50_v1-symbol.json"))
    arg, aux = _params_for(js, shape, 15, mx)
    rng = np.random.default_rng(16)
    calib = rng.standard_normal((2,) + shape[1:]).astype(F32)
    x = rng.standard_normal(shape).astype(F32)
    qsym, qarg, qaux = jq.quantize_model(
        js, _jnd(arg), _jnd(aux), calib_mode="naive",
        calib_data=mx.io.NDArrayIter(calib, batch_size=2),
        num_calib_examples=2)
    fused = qsym.get_backend_symbol("XLA")
    ex = fused.simple_bind(grad_req="null", data=shape,
                           **{k: v.shape for k, v in qarg.items()})
    ex.copy_params_from(qarg, qaux, allow_extra_params=True)
    want = ex.forward(data=mx.nd.array(x))[0].asnumpy()
    with tmx.cpu():
        tf = tmx.sym.load_json(fused.tojson())
        targ, taux = tmx.model.params_from_jax(_np(qarg), _np(qaux))
        tex = tf.bind(args={**targ, "data": tmx.nd.array(x)})
        got = tex.forward()[0].asnumpy()
    _assert_same(want, got)
