"""The port's ResNet model zoo held against the JAX package on the CPU:
resnet18 v1 and v2 at 64x64, batch 2, in NCHW and NHWC with the
standard and the space-to-depth stem, from the same weights (logits
within 1e-4 of their scale); the port's NHWC / s2d logits against its
NCHW ones; the s2d stem op; every resnet name of ``get_model``; and,
marked slow, resnet50_v1 at 224x224.

Both packages build each net under one explicit prefix, so the
parameter names agree whatever the per-process counters are.
"""
import torch_test_env  # noqa: F401  (first: one torch thread a process)

import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as tmx
from mxnet_tpu.gluon.block import infer_shapes as j_infer_shapes
from mxnet_tpu.gluon.model_zoo import vision as jv
from mxnet_tpu_torch import initializer as tinit
from mxnet_tpu_torch.gluon.block import infer_shapes
from mxnet_tpu_torch.gluon.model_zoo import vision as tv
from mxnet_tpu_torch.gluon.utils import params_from_jax

F32 = np.float32
CPU = tmx.cpu()
SHAPE = (2, 3, 64, 64)
CONFIGS = [("NCHW", "standard"), ("NHWC", "standard"), ("NHWC", "s2d")]


def _weights(jnet, seed):
    """He-normal weights and BatchNorm parameters and statistics away
    from the identity, seeded numpy, set in the JAX net."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, p in jnet.collect_params().items():
        shape = p.shape
        if name.endswith("gamma"):
            v = rng.uniform(0.5, 1.5, shape)
        elif name.endswith("beta"):
            v = rng.uniform(-0.2, 0.2, shape)
        elif name.endswith("running_mean"):
            v = rng.uniform(-0.1, 0.1, shape)
        elif name.endswith("running_var"):
            v = rng.uniform(0.5, 2.0, shape)
        else:
            v = rng.standard_normal(shape) * np.sqrt(2.0 / np.prod(shape[1:]))
        out[name] = v.astype(F32)
        p.set_data(mx.nd.array(out[name]))
    return out


def _port_logits(name, weights, x, **kwargs):
    net = getattr(tv, name)(prefix="net_", **kwargs)
    net.initialize(tinit.Zero(), ctx=CPU)   # every value is set below
    infer_shapes(net, (1,) + x.shape[1:])
    params_from_jax(net, weights, ctx=CPU)
    with CPU:
        return net(tmx.nd.array(x)).asnumpy()


@pytest.fixture(scope="module", params=["resnet18_v1", "resnet18_v2"])
def jax_logits(request):
    """The JAX net's weights and logits in every configuration."""
    name = request.param
    x = np.random.default_rng(1).standard_normal(SHAPE).astype(F32)
    weights, logits = None, {}
    for layout, stem in CONFIGS:
        jnet = getattr(jv, name)(prefix="net_", layout=layout, stem=stem)
        jnet.initialize()
        # shapes from one abstract pass: every value is set below, so no
        # eager forward at another batch needs to compile for it
        j_infer_shapes(jnet, (1,) + x.shape[1:])
        if weights is None:
            weights = _weights(jnet, 7)
        else:
            for k, p in jnet.collect_params().items():
                p.set_data(mx.nd.array(weights[k]))
        logits[layout, stem] = jnet(mx.nd.array(x)).asnumpy()
    return name, weights, x, logits


@pytest.mark.parametrize("layout,stem", CONFIGS)
def test_resnet18_logits_match_jax(jax_logits, layout, stem):
    name, weights, x, logits = jax_logits
    want = logits[layout, stem]
    got = _port_logits(name, weights, x, layout=layout, stem=stem)
    assert got.shape == (2, 1000) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-4 * np.abs(want).max())


def test_port_layouts_and_stems_agree(jax_logits):
    """One checkpoint serves every layout and stem: the port's NHWC and
    s2d logits against its own NCHW ones."""
    name, weights, x, _ = jax_logits
    base = _port_logits(name, weights, x)
    for layout, stem in CONFIGS[1:] + [("NCHW", "s2d")]:
        got = _port_logits(name, weights, x, layout=layout, stem=stem)
        np.testing.assert_allclose(got, base, rtol=0,
                                   atol=1e-4 * np.abs(base).max())


@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
def test_s2d_stem_conv_matches_jax_and_the_standard_stem(layout):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 3, 32, 30)).astype(F32)
    w = rng.standard_normal((8, 3, 7, 7)).astype(F32)
    if layout == "NHWC":
        x = x.transpose(0, 2, 3, 1).copy()
    want = mx.nd._contrib_s2d_stem_conv(mx.nd.array(x), mx.nd.array(w),
                                        layout=layout).asnumpy()
    got = tmx.nd._contrib_s2d_stem_conv(
        tmx.nd.array(x, ctx=CPU), tmx.nd.array(w, ctx=CPU),
        layout=layout).asnumpy()
    std = tmx.nd.Convolution(
        tmx.nd.array(x, ctx=CPU), tmx.nd.array(w, ctx=CPU), kernel=(7, 7),
        stride=(2, 2), pad=(3, 3), num_filter=8, no_bias=True,
        layout=layout).asnumpy()
    assert got.shape == want.shape == std.shape
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * scale)
    np.testing.assert_allclose(got, std, rtol=0, atol=1e-5 * scale)
    with pytest.raises(tmx.MXNetError):
        tmx.nd._contrib_s2d_stem_conv(tmx.nd.array(x, ctx=CPU),
                                      tmx.nd.array(w, ctx=CPU), pad=2,
                                      layout=layout)


def test_get_model_covers_every_resnet():
    names = sorted(n for n in jv._models if n.startswith("resnet"))
    assert names == sorted(tv._models)
    for name in names:
        t = tv.get_model(name, prefix="r_")
        j = jv.get_model(name, prefix="r_")
        assert type(t).__name__ == type(j).__name__
        assert list(t.collect_params().keys()) == \
            list(j.collect_params().keys()), name
    with pytest.raises(tmx.MXNetError):
        tv.resnet50_v1(pretrained=True)
    with pytest.raises(ValueError):
        tv.get_model("vgg16")


@pytest.mark.slow
def test_resnet50_v1_at_224_matches_jax():
    x = np.random.default_rng(2).standard_normal(
        (1, 3, 224, 224)).astype(F32)
    jnet = jv.resnet50_v1(prefix="net_")
    jnet.initialize()
    jnet(mx.nd.array(x))
    weights = _weights(jnet, 8)
    want = jnet(mx.nd.array(x)).asnumpy()
    got = _port_logits("resnet50_v1", weights, x)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-4 * np.abs(want).max())
