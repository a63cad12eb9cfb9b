"""The port's gluon held against the JAX package on the CPU: parameters
and deferred initialization, parameter names, every ported layer from
the same weights (rtol 1e-5), hybridize, ``.params`` files and exported
checkpoints crossing both ways, the export of resnet50_v1 against the
shipped graph, ``SymbolBlock.imports`` and the initializers (by
distribution: the packages draw from different generators).

Weights and inputs are made with numpy from fixed seeds and set in both
packages; nets are built under explicit prefixes, so no test depends on
the per-process name counters.
"""
import torch_test_env  # noqa: F401  (first: one torch thread a process)

import json

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import initializer as tinit
from mxnet_tpu_torch.gluon import nn as tnn
from mxnet_tpu_torch.gluon.block import infer_shapes
from mxnet_tpu_torch.gluon.parameter import (DeferredInitializationError,
                                             Parameter, ParameterDict)
from mxnet_tpu_torch.gluon.utils import (clip_global_norm, params_from_jax,
                                         split_and_load, split_data)

F32 = np.float32
CPU = tmx.cpu()


def _rand_params(jblock, seed):
    """Seeded numpy values for every parameter of the JAX block, set
    there too: weights N(0, 0.3), gammas and variances in [0.5, 1.5]."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, p in jblock.collect_params().items():
        shape = p.shape
        if name.endswith(("gamma", "running_var")):
            v = rng.uniform(0.5, 1.5, shape)
        else:
            v = rng.normal(0, 0.3, shape)
        out[name] = v.astype(F32)
        p.set_data(mx.nd.array(out[name]))
    return out


def _both(build, x, seed=0):
    """(JAX output, port output) of a layer built by ``build(nn)`` under
    one prefix, from the same weights."""
    jl = build(mx.gluon.nn)
    jl.initialize()
    jl(mx.nd.array(x))                      # resolve deferred shapes
    weights = _rand_params(jl, seed)
    want = jl(mx.nd.array(x)).asnumpy()
    tl = build(tnn)
    tl.initialize(ctx=CPU)
    with CPU:
        tl(tmx.nd.array(x))
        params_from_jax(tl, weights, ctx=CPU)
        got = tl(tmx.nd.array(x))
    assert list(tl.collect_params().keys()) == \
        list(jl.collect_params().keys())
    assert got.context == CPU
    return want, got.asnumpy()


def _x(shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape).astype(F32)


NCHW, NHWC = (2, 3, 8, 8), (2, 8, 8, 3)
LAYERS = {
    "dense": (lambda nn: nn.Dense(5, prefix="d_"), (2, 3, 4)),
    "dense_noflat_relu": (lambda nn: nn.Dense(
        5, flatten=False, activation="relu", prefix="d_"), (2, 3, 4)),
    "conv_nchw": (lambda nn: nn.Conv2D(4, 3, padding=1, prefix="c_"), NCHW),
    "conv_nhwc": (lambda nn: nn.Conv2D(4, 3, strides=2, padding=1,
                                       layout="NHWC", prefix="c_"), NHWC),
    "conv_groups": (lambda nn: nn.Conv2D(6, 3, groups=3, in_channels=3,
                                         use_bias=False, prefix="c_"), NCHW),
    "batchnorm": (lambda nn: nn.BatchNorm(prefix="b_"), NCHW),
    "batchnorm_nhwc": (lambda nn: nn.BatchNorm(axis=-1, prefix="b_"),
                       NHWC),
    "batchnorm_fixgamma": (lambda nn: nn.BatchNorm(scale=False,
                                                   prefix="b_"), NCHW),
    "maxpool": (lambda nn: nn.MaxPool2D(3, 2, 1), NCHW),
    "avgpool": (lambda nn: nn.AvgPool2D(2), NCHW),
    "avgpool_ceil_nopad": (lambda nn: nn.AvgPool2D(
        3, 2, 1, ceil_mode=True, count_include_pad=False), NCHW),
    "maxpool_nhwc": (lambda nn: nn.MaxPool2D(2, layout="NHWC"), NHWC),
    "global_avg": (lambda nn: nn.GlobalAvgPool2D(), NCHW),
    "global_avg_nhwc": (lambda nn: nn.GlobalAvgPool2D(layout="NHWC"), NHWC),
    "global_max": (lambda nn: nn.GlobalMaxPool2D(), NCHW),
    "relu": (lambda nn: nn.Activation("relu"), NCHW),
    "sigmoid": (lambda nn: nn.Activation("sigmoid"), NCHW),
    "leaky": (lambda nn: nn.LeakyReLU(0.1), NCHW),
    "flatten": (lambda nn: nn.Flatten(), NCHW),
    "dropout_predict": (lambda nn: nn.Dropout(0.5), NCHW),
    "layernorm": (lambda nn: nn.LayerNorm(prefix="l_"), (2, 5, 6)),
    "sequential": (lambda nn: _seq(nn), NCHW),
}


def _seq(nn):
    net = nn.HybridSequential(prefix="s_")
    with net.name_scope():
        net.add(nn.Conv2D(4, 3, padding=1, use_bias=False),
                nn.BatchNorm(), nn.Activation("relu"), nn.MaxPool2D(2),
                nn.Dense(3))
    return net


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_layer_matches_jax(name):
    build, shape = LAYERS[name]
    want, got = _both(build, _x(shape))
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


def test_embedding_matches_jax():
    idx = np.array([[0, 3, 9], [2, 2, 1]], F32)
    want, got = _both(lambda nn: nn.Embedding(10, 4, prefix="e_"), idx)
    np.testing.assert_array_equal(got, want)


def test_ops_softmax_log_softmax_dropout_match_jax():
    x = _x((3, 7))
    for op, kw in (("softmax", {}), ("log_softmax", {"axis": 0}),
                   ("softmax", {"temperature": 2.0})):
        want = getattr(mx.nd, op)(mx.nd.array(x), **kw).asnumpy()
        got = getattr(tmx.nd, op)(tmx.nd.array(x, ctx=CPU), **kw).asnumpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    # Dropout: the identity in predict mode, as in the JAX package
    np.testing.assert_array_equal(
        tmx.nd.Dropout(tmx.nd.array(x, ctx=CPU), p=0.5).asnumpy(), x)


def test_dropout_trains_by_distribution():
    """In training the kept share is 1 - p and kept values are scaled by
    1 / (1 - p) (the packages draw from different generators, so the
    masks are compared by distribution); a layer's draws repeat with its
    seed and differ between layers."""
    x = np.ones((200, 100), F32)
    layer = tnn.Dropout(0.3, generator=tmx.random.generator(5))
    with CPU, tmx.autograd.train_mode():
        y = layer(tmx.nd.array(x)).asnumpy()
        again = tnn.Dropout(0.3, generator=tmx.random.generator(5))(
            tmx.nd.array(x)).asnumpy()
        other = tnn.Dropout(0.3, generator=tmx.random.generator(6))(
            tmx.nd.array(x)).asnumpy()
    kept = y != 0
    assert abs(kept.mean() - 0.7) < 0.01
    np.testing.assert_allclose(y[kept], 1 / F32(0.7), rtol=1e-6)
    np.testing.assert_array_equal(y, again)
    assert not np.array_equal(y, other)


def test_parameter_deferred_init_and_dict():
    p = Parameter("w", shape=(3, 0), allow_deferred_init=True)
    p.initialize(ctx=CPU)
    with pytest.raises(DeferredInitializationError):
        p.data()
    p.shape_inferred((3, 4))
    assert p.data().shape == (3, 4) and p.data().context == CPU
    with pytest.raises(tmx.MXNetError):
        p.shape_inferred((3, 5))
    q = Parameter("q", shape=(2, 0))
    with pytest.raises(tmx.MXNetError):
        q.initialize(ctx=CPU)
    with pytest.raises(tmx.MXNetError):
        Parameter("u", shape=(2,)).data()
    pd = ParameterDict("net_")
    w = pd.get("weight", shape=(3, 0), allow_deferred_init=True)
    assert w.name == "net_weight" and pd.get("weight", shape=(3, 4)) is w
    with pytest.raises(tmx.MXNetError):
        pd.get("weight", shape=(5, 4))
    shared = ParameterDict("net_", shared=pd)
    assert shared.get("weight") is w
    c = pd.get_constant("c", np.arange(3, dtype=F32))
    pd.initialize(ctx=CPU)
    np.testing.assert_array_equal(c.data().asnumpy(), np.arange(3))
    # a Dense layer's deferred weight takes its shape from the first call
    dense = tnn.Dense(3, prefix="d_")
    dense.initialize(ctx=CPU)
    with pytest.raises(DeferredInitializationError):
        dense.weight.data()
    with CPU:
        dense(tmx.nd.array(_x((2, 4))))
    assert dense.weight.shape == (3, 4)
    dense.cast("float64")
    assert dense.weight.data().dtype == np.float64


def test_parameter_names_equal_jax():
    from mxnet_tpu.gluon.model_zoo import vision as jv
    from mxnet_tpu_torch.gluon.model_zoo import vision as tv
    assert list(_seq(tnn).collect_params().keys()) == \
        list(_seq(mx.gluon.nn).collect_params().keys())
    jr = jv.resnet18_v1(prefix="resnetv10_")
    tr = tv.resnet18_v1(prefix="resnetv10_")
    names = list(tr.collect_params().keys())
    assert names == list(jr.collect_params().keys())
    assert "resnetv10_stage1_conv2d0_weight" in names
    assert tr.collect_params("stage4_.*|.*dense").keys() == \
        jr.collect_params("stage4_.*|.*dense").keys()
    assert list(tr._collect_params_with_prefix()) == \
        list(jr._collect_params_with_prefix())


def test_hybridize_gives_the_same_output():
    net = _seq(tnn)
    net.initialize(ctx=CPU)
    x = tmx.nd.array(_x(NCHW), ctx=CPU)
    eager = net(x).asnumpy()
    net.hybridize()
    out = net(x)
    np.testing.assert_array_equal(out.asnumpy(), eager)
    assert out._data.is_inference()     # predict mode: inference_mode
    with tmx.autograd.train_mode():
        assert not net(x)._data.is_inference()


def test_hybridized_deferred_init_makes_normal_parameters():
    net = tnn.HybridSequential(prefix="defer_")
    with net.name_scope():
        net.add(tnn.Dense(4))
    net.initialize(ctx=CPU)
    net.hybridize()
    net(tmx.nd.array(_x(NCHW), ctx=CPU))   # shapes resolved in the call
    for p in net.collect_params().values():
        assert not p.data()._data.is_inference()


def _jax_net(seed):
    jnet = _seq(mx.gluon.nn)
    jnet.initialize()
    jnet(mx.nd.array(_x(NCHW)))
    _rand_params(jnet, seed)
    return jnet


def _port_net():
    tnet = _seq(tnn)
    tnet.initialize(ctx=CPU)
    with CPU:
        tnet(tmx.nd.array(_x(NCHW)))
    return tnet


def _out(net, pkg, x):
    if pkg is tmx:
        with CPU:
            return net(tmx.nd.array(x)).asnumpy()
    return net(mx.nd.array(x)).asnumpy()


@pytest.mark.parametrize("how", ["save_parameters", "collect_params"])
def test_params_files_cross_both_ways(tmp_path, how):
    x = _x(NCHW, seed=3)
    jnet = _jax_net(4)
    want = _out(jnet, mx, x)
    jf, tf = str(tmp_path / "j.params"), str(tmp_path / "t.params")
    if how == "save_parameters":
        jnet.save_parameters(jf)
    else:
        jnet.collect_params().save(jf)
    tnet = _port_net()
    tnet.load_parameters(jf, ctx=CPU)
    got = _out(tnet, tmx, x)
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())
    if how == "save_parameters":
        tnet.save_parameters(tf)
    else:
        tnet.collect_params().save(tf)
    back = _seq(mx.gluon.nn)
    back.initialize()
    back(mx.nd.array(x))
    back.load_parameters(tf)
    np.testing.assert_array_equal(_out(back, mx, x), want)
    # a file that lacks parameters raises unless allow_missing
    partial = str(tmp_path / "partial.params")
    tmx.nd.save(partial, {"0.weight": tmx.nd.array(
        np.zeros((4, 3, 3, 3), F32), ctx=CPU)})
    with pytest.raises(tmx.MXNetError):
        _port_net().load_parameters(partial, ctx=CPU)
    _port_net().load_parameters(partial, ctx=CPU, allow_missing=True)


def test_exports_and_symbolblock_imports_cross_both_ways(tmp_path):
    x = _x(NCHW, seed=5)
    jnet = _jax_net(6)
    want = _out(jnet, mx, x)
    jnet.export(str(tmp_path / "j"))
    sb = tmx.gluon.SymbolBlock.imports(str(tmp_path / "j-symbol.json"),
                                       ["data"], str(tmp_path /
                                                     "j-0000.params"),
                                       ctx=CPU)
    got = _out(sb, tmx, x)
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())
    tnet = _port_net()
    tnet.load_parameters(_saved(jnet, tmp_path), ctx=CPU)
    tnet.export(str(tmp_path / "t"), epoch=3)
    with open(tmp_path / "t-symbol.json") as f, \
            open(tmp_path / "j-symbol.json") as g:
        assert _canonical(f.read()) == _canonical(g.read())
    jsb = mx.gluon.SymbolBlock.imports(str(tmp_path / "t-symbol.json"),
                                       ["data"],
                                       str(tmp_path / "t-0003.params"))
    np.testing.assert_allclose(_out(jsb, mx, x), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())
    # the port's checkpoint loads through its symbolic executor too
    sym, arg, aux = tmx.model.load_checkpoint(str(tmp_path / "t"), 3,
                                              ctx=CPU)
    ex = sym.bind(CPU, args={**arg, "data": tmx.nd.array(x, ctx=CPU)},
                  aux_states=aux, grad_req="null")
    np.testing.assert_array_equal(ex.forward()[0].asnumpy(),
                                  _out(tnet, tmx, x))


def _saved(jnet, tmp_path):
    path = str(tmp_path / "jnet.params")
    jnet.save_parameters(path)
    return path


def _canonical(text):
    from test_torch_symbol import _canonical as canon
    return canon(text)


def test_export_of_resnet50_equals_the_shipped_graph(tmp_path):
    from mxnet_tpu_torch.gluon.model_zoo import vision as tv
    net = tv.resnet50_v1()
    net.initialize(tinit.Zero(), ctx=CPU)
    infer_shapes(net, (1, 3, 224, 224))
    sym_file, _ = net.export(str(tmp_path / "r50"))
    with open(sym_file) as f:
        fresh = f.read()
    with open(tmx.model_zoo.symbol_path("resnet50_v1")) as f:
        shipped = f.read()
    assert len(json.loads(fresh)["nodes"]) == len(json.loads(shipped)["nodes"])
    assert _canonical(fresh) == _canonical(shipped)


def test_gluon_utils():
    x = tmx.nd.array(np.arange(24, dtype=F32).reshape(6, 4), ctx=CPU)
    parts = split_data(x, 3)
    assert [p.shape for p in parts] == [(2, 4)] * 3
    with pytest.raises(tmx.MXNetError):
        split_data(x, 4)
    assert [p.shape for p in split_data(x, 4, even_split=False)] == \
        [(1, 4), (1, 4), (1, 4), (3, 4)]
    assert split_and_load(x, [CPU])[0].shape == (6, 4)
    a = tmx.nd.array(np.full((3,), 3.0, F32), ctx=CPU)
    b = tmx.nd.array(np.full((4,), 4.0, F32), ctx=CPU)
    want = mx.gluon.utils.clip_global_norm(
        [mx.nd.array(np.full((3,), 3.0, F32)),
         mx.nd.array(np.full((4,), 4.0, F32))], 1.0)
    total = clip_global_norm([a, b], 1.0)
    np.testing.assert_allclose(total, want, rtol=1e-6)
    got = np.sqrt((a.asnumpy() ** 2).sum() + (b.asnumpy() ** 2).sum())
    np.testing.assert_allclose(got, 1.0, rtol=1e-6)
    with pytest.raises(tmx.MXNetError):
        params_from_jax(_seq(tnn), {"nope": np.zeros(1, F32)}, ctx=CPU)


# -- initializers, by distribution -------------------------------------------
SHAPE = (64, 32, 3, 3)


def _jax_draw(init, name="w_weight"):
    arr = mx.nd.zeros(SHAPE)
    init(mx.init.InitDesc(name), arr)
    return arr.asnumpy()


def _port_draw(init, name="w_weight", seed=0):
    t = torch.zeros(SHAPE)
    init(name, t, tmx.random.generator(seed))
    return t.numpy()


@pytest.mark.parametrize("name,kwargs", [
    ("Uniform", {"scale": 0.2}), ("Normal", {"sigma": 0.05}),
    ("Xavier", {}), ("Xavier", {"rnd_type": "gaussian",
                                "factor_type": "in", "magnitude": 2}),
    ("MSRAPrelu", {}),
])
def test_initializers_match_jax_by_distribution(name, kwargs):
    j = _jax_draw(getattr(mx.init, name)(**kwargs))
    t = _port_draw(getattr(tinit, name)(**kwargs))
    assert t.dtype == np.float32
    assert abs(t.mean()) < 0.05 * t.std()
    np.testing.assert_allclose(t.std(), j.std(), rtol=0.05)
    np.testing.assert_allclose(np.abs(t).max(), np.abs(j).max(), rtol=0.25)
    # the same generator seed gives the same draw, another seed another
    np.testing.assert_array_equal(
        t, _port_draw(getattr(tinit, name)(**kwargs)))
    assert not np.array_equal(
        t, _port_draw(getattr(tinit, name)(**kwargs), seed=1))


def test_initializer_rules_and_create():
    for name in ("b_bias", "b_beta", "b_running_mean", "b_moving_mean"):
        assert (_port_draw(tinit.Uniform(), name) == 0).all()
    for name in ("b_gamma", "b_running_var", "b_moving_var"):
        assert (_port_draw(tinit.Uniform(), name) == 1).all()
    assert (_port_draw(tinit.create("zeros")) == 0).all()
    assert (_port_draw(tinit.create("ones")) == 1).all()
    assert (_port_draw(tinit.Constant(0.5)) == F32(0.5)).all()
    xav = tinit.create(tinit.Xavier(magnitude=2).dumps())
    assert isinstance(xav, tinit.Xavier) and xav.magnitude == 2
    mixed = tinit.Mixed([".*conv.*", ".*"], [tinit.One(), "zeros"])
    assert (_port_draw(mixed, "a_conv_weight") == 1).all()
    assert (_port_draw(mixed, "a_fc_weight") == 0).all()
    src = np.arange(np.prod(SHAPE), dtype=F32).reshape(SHAPE)
    np.testing.assert_array_equal(
        _port_draw(tinit.Load({"w_weight": src})), src)
    with pytest.raises(tmx.MXNetError):
        tinit.create("nope")
    # a net initializes the same from the same generator seed
    a, b = _seq(tnn), _seq(tnn)
    for net in (a, b):
        net.initialize(tinit.Xavier(), ctx=CPU,
                       generator=tmx.random.generator(3))
        with CPU:
            net(tmx.nd.array(_x(NCHW)))
    for (k, p), (_, q) in zip(a.collect_params().items(),
                              b.collect_params().items()):
        np.testing.assert_array_equal(p.data().asnumpy(),
                                      q.data().asnumpy(), err_msg=k)
