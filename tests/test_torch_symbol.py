"""The port's array and graph layers held against the JAX package on the
CPU: NDArray files (the npz container and the reference ``.params``
format) and symbol JSON cross between the packages in both directions
unchanged; the shipped resnet50_v1 graph is the JAX model zoo's;
inference of shapes, the fp32 executor (plain and XLA-partitioned),
checkpoints and the calibration iterator agree with the JAX package."""
import torch_test_env  # noqa: F401  (first: one torch thread a process)

import json
import os
import re

import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as tmx
from mxnet_tpu.ndarray import ref_serde as j_serde
from mxnet_tpu_torch.ndarray import ref_serde as t_serde

F32 = np.float32
CPU = tmx.cpu()


@pytest.fixture(autouse=True)
def _always_fire_partitioner(monkeypatch):
    monkeypatch.setenv("MXTPU_FUSE_COST", "0")


def _arrays(seed=0):
    rng = np.random.default_rng(seed)
    return {"arg:w": rng.standard_normal((3, 4)).astype(F32),
            "arg:q": rng.integers(-127, 128, (5,)).astype(np.int8),
            "aux:i": rng.integers(-9, 9, (2, 2)).astype(np.int32),
            "aux:s": np.array(1.25, F32)}


def _same(a, b):
    assert set(a) == set(b)
    for k in a:
        x = a[k].asnumpy() if hasattr(a[k], "asnumpy") else a[k]
        y = b[k].asnumpy() if hasattr(b[k], "asnumpy") else b[k]
        assert x.dtype == y.dtype and x.shape == y.shape, k
        np.testing.assert_array_equal(x, y)


def test_npz_files_cross_both_ways(tmp_path):
    ref = _arrays()
    mx.nd.save(str(tmp_path / "j.params"),
               {k: mx.nd.array(v) for k, v in ref.items()})
    _same(ref, tmx.nd.load(str(tmp_path / "j.params"), ctx=CPU))
    tmx.nd.save(str(tmp_path / "t.params"),
                {k: tmx.nd.array(v, ctx=CPU) for k, v in ref.items()})
    _same(ref, mx.nd.load(str(tmp_path / "t.params")))
    # the list form keeps its order
    tmx.nd.save(str(tmp_path / "l.params"),
                [tmx.nd.array(v, ctx=CPU) for v in ref.values()])
    got = mx.nd.load(str(tmp_path / "l.params"))
    assert [g.shape for g in got] == [v.shape for v in ref.values()]


def test_reference_params_format_is_byte_identical(tmp_path):
    # the reference format has no 0-d arrays
    ref = {k: v for k, v in _arrays(1).items() if v.ndim}
    raw = j_serde.save_reference_buffer(ref)
    assert t_serde.save_reference_buffer(ref) == raw
    tmx.nd.save_reference(str(tmp_path / "t.params"),
                          {k: tmx.nd.array(v, ctx=CPU)
                           for k, v in ref.items()})
    assert (tmp_path / "t.params").read_bytes() == raw
    _same(ref, mx.nd.load(str(tmp_path / "t.params")))
    (tmp_path / "j.params").write_bytes(raw)
    _same(ref, tmx.nd.load(str(tmp_path / "j.params"), ctx=CPU))


def _zoo_json():
    with open(tmx.model_zoo.symbol_path("resnet50_v1")) as f:
        return f.read()


def test_symbol_json_crosses_both_ways_unchanged():
    text = _zoo_json()
    assert tmx.sym.load_json(text).tojson() == text
    assert mx.sym.load_json(text).tojson() == text
    # a partitioned fp32 graph carries the fused nodes' stringified attrs
    fused = mx.sym.load_json(text).get_backend_symbol("XLA")
    ftext = fused.tojson()
    assert "_sg_xla_conv" in ftext and "_sg_xla_fc" in ftext
    assert tmx.sym.load_json(ftext).tojson() == ftext
    assert tmx.sym.load_json(text).get_backend_symbol("XLA").tojson() \
        == ftext
    assert mx.sym.load_json(
        tmx.sym.load_json(ftext).tojson()).tojson() == ftext


def _canonical(text):
    """The graph with gluon's instance and op counters renamed in order
    of appearance (resnetv10_ vs resnetv17_, broadcast_add0 vs 8,
    _plus3): the counted token that opens a quoted name, underscores
    included, up to its digits."""
    seen = {}

    def rename(m):
        return seen.setdefault(m.group(0), f"n{len(seen)}")

    return re.sub(r"(?<=\")[a-z_]+?\d+(?=_|\")", rename, text)


@pytest.mark.parametrize("text,want", [
    ('"resnetv17_conv0_weight", "broadcast_add8", "_plus3", "resnetv17_x"',
     '"n0_conv0_weight", "n1", "n2", "n0_x"'),
    ('"broadcast_add0", "broadcast_add0_x", "data", "(3, 3)", "64"',
     '"n0", "n0_x", "data", "(3, 3)", "64"'),
])
def test_canonical_renames_every_counter_in_order(text, want):
    assert _canonical(text) == want


def test_shipped_resnet50_is_the_jax_model_zoo_graph():
    from mxnet_tpu.gluon.block import infer_shapes
    from mxnet_tpu.gluon.model_zoo import vision
    from mxnet_tpu.symbol.trace import trace_block
    net = vision.resnet50_v1()
    net.initialize()
    infer_shapes(net, (1, 3, 224, 224))
    sym, _ = trace_block(net)
    fresh, shipped = sym.tojson(), _zoo_json()
    assert len(json.loads(fresh)["nodes"]) == \
        len(json.loads(shipped)["nodes"])
    assert _canonical(fresh) == _canonical(shipped)


def test_infer_shape_and_type_match_jax():
    text = _zoo_json()
    j, t = mx.sym.load_json(text), tmx.sym.load_json(text)
    assert t.list_arguments() == j.list_arguments()
    assert t.list_auxiliary_states() == j.list_auxiliary_states()
    assert t.list_outputs() == j.list_outputs()
    assert t.infer_shape(data=(2, 3, 224, 224)) == \
        j.infer_shape(data=(2, 3, 224, 224))
    assert t.infer_type(data="float32") == j.infer_type(data="float32")
    internals = t.get_internals()
    assert internals.list_outputs() == j.get_internals().list_outputs()


def _small_net(sym):
    data = sym.var("data")
    c = sym.Convolution(data, name="c0", kernel=(3, 3), num_filter=8,
                        pad=(1, 1), no_bias=True)
    b = sym.BatchNorm(c, name="bn0", fix_gamma=False, eps=1e-3)
    r = sym.Activation(b, name="r0", act_type="relu")
    p = sym.Pooling(r, name="p0", kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                    pool_type="max")
    c1 = sym.Convolution(p, name="c1", kernel=(1, 1), num_filter=8)
    s = sym.broadcast_add(c1, p, name="add0")
    g = sym.Pooling(s, name="g0", kernel=(1, 1), global_pool=True,
                    pool_type="avg")
    return sym.FullyConnected(g, name="fc", num_hidden=5)


@pytest.mark.parametrize("backend", [None, "XLA"])
def test_fp32_executor_matches_jax(backend):
    """fp32 forward, plain and partitioned (conv+BN folding, FC
    epilogue): within 1e-5 of the largest logit, the reach of float32
    sums taken in another order."""
    j, t = _small_net(mx.sym), _small_net(tmx.sym)
    assert t.tojson() == j.tojson()
    shape = (2, 3, 10, 10)
    arg_shapes, _, aux_shapes = j.infer_shape(data=shape)
    assert t.infer_shape(data=shape) == j.infer_shape(data=shape)
    rng = np.random.default_rng(2)
    args = {n: rng.standard_normal(s).astype(F32)
            for n, s in zip(j.list_arguments(), arg_shapes)}
    aux = {n: rng.uniform(0.5, 1.5, s).astype(F32)
           for n, s in zip(j.list_auxiliary_states(), aux_shapes)}
    if backend:
        j, t = j.get_backend_symbol(backend), t.get_backend_symbol(backend)
        assert t.tojson() == j.tojson()
    want = j.bind(args={k: mx.nd.array(v) for k, v in args.items()},
                  aux_states={k: mx.nd.array(v) for k, v in aux.items()},
                  grad_req="null").forward()[0].asnumpy()
    ex = t.bind(CPU, args={k: tmx.nd.array(v, ctx=CPU)
                           for k, v in args.items()},
                aux_states={k: tmx.nd.array(v, ctx=CPU)
                            for k, v in aux.items()}, grad_req="null")
    got = ex.forward()[0].asnumpy()
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())
    # simple_bind allocates from inferred shapes and partitions under
    # MXNET_SUBGRAPH_BACKEND, as the JAX package does
    sb = _small_net(tmx.sym).simple_bind(CPU, grad_req="null", data=shape)
    assert sorted(sb.arg_dict) == sorted(args)


def test_simple_bind_honours_subgraph_backend(monkeypatch):
    monkeypatch.setenv("MXNET_SUBGRAPH_BACKEND", "XLA")
    ex = _small_net(tmx.sym).simple_bind(CPU, grad_req="null",
                                         data=(1, 3, 10, 10))
    ops = {n.op for n in ex._symbol._topo() if n.op}
    assert "_sg_xla_conv" in ops and "Convolution" not in ops


def test_checkpoints_cross_both_ways(tmp_path):
    j = _small_net(mx.sym)
    arg_shapes, _, aux_shapes = j.infer_shape(data=(1, 3, 10, 10))
    rng = np.random.default_rng(3)
    arg = {n: rng.standard_normal(s).astype(F32)
           for n, s in zip(j.list_arguments(), arg_shapes) if n != "data"}
    aux = {n: rng.uniform(0.5, 1.5, s).astype(F32)
           for n, s in zip(j.list_auxiliary_states(), aux_shapes)}
    jp, tp = str(tmp_path / "j"), str(tmp_path / "t")
    mx.model.save_checkpoint(jp, 3, j, {k: mx.nd.array(v)
                                        for k, v in arg.items()},
                             {k: mx.nd.array(v) for k, v in aux.items()})
    ts, ta, tx = tmx.model.load_checkpoint(jp, 3, ctx=CPU)
    assert ts.tojson() == j.tojson()
    _same(arg, ta)
    _same(aux, tx)
    tmx.model.save_checkpoint(tp, 3, ts, ta, tx)
    js, ja, jx = mx.model.load_checkpoint(tp, 3)
    assert js.tojson() == j.tojson()
    _same(arg, ja)
    _same(aux, jx)


@pytest.mark.parametrize("n,batch", [(10, 4), (8, 8), (3, 8)])
def test_ndarray_iter_pads_like_jax(n, batch):
    x = np.arange(n * 2, dtype=F32).reshape(n, 2)
    j = mx.io.NDArrayIter(x, batch_size=batch)
    with tmx.cpu():
        t = tmx.io.NDArrayIter(x, batch_size=batch)
        tb = [(b.data[0].asnumpy(), b.pad) for b in t]
    jb = [(b.data[0].asnumpy(), b.pad) for b in j]
    assert len(tb) == len(jb)
    for (a, pa), (b, pb) in zip(jb, tb):
        np.testing.assert_array_equal(a, b)
        assert pa == pb
    assert [(d.name, d.shape) for d in t.provide_data] == \
        [(d.name, d.shape) for d in j.provide_data]


def test_ndarray_arithmetic_and_generated_ops():
    rng = np.random.default_rng(4)
    a, b = (rng.standard_normal((3, 4)).astype(F32) for _ in range(2))
    ta, tb = tmx.nd.array(a, ctx=CPU), tmx.nd.array(b, ctx=CPU)
    np.testing.assert_array_equal(((ta + tb) * 2 - tb / 4).asnumpy(),
                                  (a + b) * F32(2) - b / F32(4))
    got = tmx.nd.FullyConnected(ta, tb, num_hidden=3, no_bias=True)
    want = mx.nd.FullyConnected(mx.nd.array(a), mx.nd.array(b),
                                num_hidden=3, no_bias=True)
    np.testing.assert_allclose(got.asnumpy(), want.asnumpy(), rtol=1e-6)
    assert got.context == CPU and got.dtype == np.float32
