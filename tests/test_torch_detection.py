"""The port's detection ops and SSD against the JAX package on the CPU:
``stack`` / ``flip`` / ``Concat`` bitwise, ``MultiBoxPrior`` bitwise,
``MultiBoxTarget`` (class targets and masks bitwise, box targets within
fp32 rounding: 1e-6 absolute on values of order 1), ``box_iou``
(bitwise on corner boxes), ``box_nms`` and ``MultiBoxDetection`` with
tied scores and ``topk`` (ids, scores and order bitwise, boxes within
fp32 rounding), then ``examples/ssd``'s detector (the port's block in
``chip_smoke.py``) from the JAX block's ``.params``: the forward, its
targets and losses at batch 2 (tier 1), and one training step
(``slow``: the JAX step compiles for some 20 s here), at the JAX fp32
bounds, rtol 1e-4 / atol 1e-5."""
import torch_test_env  # noqa: F401  (first: one torch thread a process)

import importlib.util
import os

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as tmx

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = tmx.cpu()
F32 = np.float32


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CS = _load("chip_smoke", os.path.join(REPO, "chip_smoke.py"))


def _pair(fn, *arrays, **attrs):
    """``fn`` of the JAX package's nd and of the port's on the same
    arrays, as numpy (a tuple of outputs gives tuples)."""
    j = getattr(mx.nd, fn)(*[mx.nd.array(a) for a in arrays], **attrs)
    with CPU:
        t = getattr(tmx.nd, fn)(*[tmx.nd.array(a) for a in arrays], **attrs)
    if isinstance(j, (tuple, list)):
        return [o.asnumpy() for o in j], [o.asnumpy() for o in t]
    return j.asnumpy(), t.asnumpy()


def _same(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("case", ["stack0", "stack2", "concat1", "concat0",
                                  "flip1", "flip_axes", "reverse"])
def test_stack_concat_flip_bitwise(case):
    rng = np.random.default_rng(1)
    a, b, c = (rng.standard_normal((2, 3, 4)).astype(F32) for _ in range(3))
    fn, arrays, attrs = {
        "stack0": ("stack", (a, b, c), {}),
        "stack2": ("stack", (a, b), {"axis": 2}),
        "concat1": ("Concat", (a, b, c), {}),
        "concat0": ("concat", (a, b), {"dim": 0}),
        "flip1": ("flip", (a,), {"axis": 1}),
        "flip_axes": ("flip", (a,), {"axis": (0, 2)}),
        "reverse": ("reverse", (a,), {"axis": 2}),
    }[case]
    _same(*_pair(fn, *arrays, **attrs))


def test_symbolic_stack_concat_flip_equal_nd():
    rng = np.random.default_rng(2)
    a, b = (rng.standard_normal((2, 3)).astype(F32) for _ in range(2))
    x, y = tmx.sym.var("x"), tmx.sym.var("y")
    out = tmx.sym.Group([tmx.sym.stack(x, y, axis=1),
                         tmx.sym.concat(x, y, dim=0),
                         tmx.sym.flip(x, axis=1)])
    with CPU:
        ex = out.bind(CPU, {"x": tmx.nd.array(a), "y": tmx.nd.array(b)})
        got = [o.asnumpy() for o in ex.forward()]
    _same(got[0], np.stack([a, b], 1))
    _same(got[1], np.concatenate([a, b], 0))
    _same(got[2], a[:, ::-1])


def _feat(h, w):
    return np.zeros((1, 3, h, w), F32)


@pytest.mark.parametrize("h,w,attrs", [
    (8, 8, {"sizes": (0.2, 0.272), "ratios": (1.0, 2.0, 0.5)}),
    (5, 7, {"sizes": (0.71, 0.79), "ratios": (1.0, 2.0, 0.5)}),
    (1, 1, {"sizes": (0.88, 0.961), "ratios": (1.0, 2.0, 0.5)}),
    (4, 6, {"sizes": (0.5, 0.9), "ratios": (1.0, 3.0), "clip": True}),
    (3, 3, {"sizes": (0.3,), "steps": (0.25, 0.2), "offsets": (0.2, 0.7)}),
])
def test_multibox_prior_bitwise(h, w, attrs):
    _same(*_pair("MultiBoxPrior", _feat(h, w), **attrs))


def _anchors():
    return np.concatenate([mx.nd.MultiBoxPrior(
        mx.nd.array(_feat(s, s)), sizes=CS.SSD_SIZES[i],
        ratios=CS.SSD_RATIOS[i]).asnumpy() for i, s in enumerate(
            (8, 4, 2, 1))], axis=1)


def _gt(rng, b, m):
    """(b, m, 5) labels, some images padded with cls -1 rows; image 1
    holds a duplicated box (a tie in every round of the matching)."""
    lab = np.full((b, m, 5), -1, F32)
    for i in range(b):
        for k in range(int(rng.integers(1, m + 1))):
            x0, y0 = rng.uniform(0, 0.6, 2)
            w, h = rng.uniform(0.1, 0.4, 2)
            lab[i, k] = [rng.integers(0, 2), x0, y0, x0 + w, y0 + h]
    lab[1, 1] = lab[1, 0]
    return lab


@pytest.mark.parametrize("attrs", [
    {},
    {"negative_mining_ratio": 3.0},
    {"negative_mining_ratio": 3.0, "minimum_negative_samples": 5,
     "overlap_threshold": 0.3, "negative_mining_thresh": 0.4},
    {"overlap_threshold": 0.0, "ignore_label": -2.0,
     "negative_mining_ratio": 1.0},
])
def test_multibox_target_matches_jax(attrs):
    rng = np.random.default_rng(3)
    anc = _anchors()
    n = anc.shape[1]
    lab = _gt(rng, 4, 6)
    lab[3] = -1                    # an image without objects
    cls = rng.random((4, 3, n)).astype(F32)
    cls[:, :, 10:40] = 0.5         # tied negatives in the mining sort
    (jl, jm, jc), (tl, tm, tc) = _pair("MultiBoxTarget", anc, lab, cls,
                                       **attrs)
    _same(tm, jm)
    _same(tc, jc)
    assert (jc > 0).any() and (jc == 0).any()
    np.testing.assert_allclose(tl, jl, rtol=0, atol=1e-6)


def test_argmax_takes_the_first_maximum():
    """MultiBoxTarget's rounds rely on it, as on jnp.argmax."""
    x = torch.tensor([[0.5, 0.9, 0.9, 0.1], [0.3, 0.3, 0.3, 0.3]])
    assert torch.argmax(x, dim=1).tolist() == [1, 0]
    assert torch.argmax(x.reshape(-1)).item() == 1


def _dets(rng, shape):
    d = rng.random(shape).astype(F32)
    d[..., 0] = rng.integers(0, 3, shape[:-1])
    d[..., 2:4] *= 0.5
    d[..., 4:6] = d[..., 2:4] + rng.uniform(0.1, 0.4, shape[:-1] + (2,))
    d[..., 3:5, 1] = d[..., 2:3, 1]          # tied scores
    d[..., 6, 2:] = d[..., 7, 2:]            # a duplicated box
    return d


@pytest.mark.parametrize("attrs", [
    {}, {"topk": 10}, {"id_index": 0}, {"id_index": 0, "background_id": 1},
    {"id_index": 0, "force_suppress": True, "overlap_thresh": 0.2},
    {"in_format": "center", "valid_thresh": 0.3, "topk": 25},
])
def test_box_nms_matches_jax_bitwise(attrs):
    j, t = _pair("box_nms", _dets(np.random.default_rng(4), (2, 3, 50, 6)),
                 **attrs)
    _same(t, j)
    assert 0 < (j[..., 1] >= 0).sum() < j[..., 1].size


def test_box_iou_matches_jax():
    """Corner boxes bitwise; center boxes within fp32 rounding (the
    jitted JAX op contracts ``xy - wh / 2`` into a fused multiply-add)."""
    d = _dets(np.random.default_rng(5), (2, 30, 6))
    _same(*_pair("box_iou", d[0, :, 2:], d[1, :20, 2:]))
    j, t = _pair("box_iou", d[0, :, 2:], d[1, :20, 2:], format="center")
    np.testing.assert_allclose(t, j, rtol=0, atol=1e-6)


@pytest.mark.parametrize("attrs", [
    {"nms_threshold": 0.45, "threshold": 0.01}, {"nms_topk": 20},
    {"force_suppress": True, "clip": False},
])
def test_multibox_detection_matches_jax(attrs):
    rng = np.random.default_rng(6)
    anc = _anchors()
    n = anc.shape[1]
    cls = rng.random((3, 3, n)).astype(F32)
    cls /= cls.sum(axis=1, keepdims=True)
    cls[:, :, 30:40] = cls[:, :, 30:31]      # tied scores
    loc = rng.normal(0, 0.5, (3, n * 4)).astype(F32)
    j, t = _pair("MultiBoxDetection", cls, loc, anc, **attrs)
    _same(t[..., :2], j[..., :2])
    np.testing.assert_allclose(t[..., 2:], j[..., 2:], rtol=0, atol=1e-6)
    assert (j[..., 0] >= 0).sum() > 0


# -- examples/ssd's detector -------------------------------------------------
@pytest.fixture(scope="module")
def ssd_pair(tmp_path_factory):
    """The JAX block (examples/ssd/model.py) initialized, hybridized and
    saved; the port's (chip_smoke.ssd_class) loaded from that file."""
    from mxnet_tpu.gluon.block import infer_shapes as j_infer_shapes
    jm = _load("ssd_model", os.path.join(REPO, "examples", "ssd",
                                         "model.py"))
    mx.random.seed(7)
    jnet = jm.SSD(CS.SSD_CLASSES)
    jnet.initialize()
    j_infer_shapes(jnet, (2, 3, CS.SSD_IMG, CS.SSD_IMG))
    jnet.hybridize()
    path = str(tmp_path_factory.mktemp("ssd") / "ssd.params")
    jnet.save_parameters(path)
    tnet = CS.ssd_class(tmx)(CS.SSD_CLASSES)
    tnet.load_parameters(path, ctx=CPU)
    tnet.hybridize()
    assert list(tnet.collect_params()) == list(jnet.collect_params())
    x, y = CS.ssd_synth(np.random.default_rng(42), 2)
    return jnet, tnet, x, y


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def _targets_and_losses(pkg, outs, y):
    anchors, cls_preds, box_preds = outs
    box_t, box_m, cls_t = pkg.nd.MultiBoxTarget(
        anchors, pkg.nd.array(y), pkg.nd.transpose(cls_preds, axes=(0, 2, 1)),
        negative_mining_ratio=3.0)
    l_cls = pkg.gluon.loss.SoftmaxCrossEntropyLoss()(cls_preds, cls_t)
    l_box = pkg.gluon.loss.L1Loss()(box_preds * box_m, box_t * box_m)
    return [v.asnumpy() for v in (box_t, box_m, cls_t, l_cls, l_box)]


def test_ssd_forward_targets_and_losses_match_jax(ssd_pair):
    jnet, tnet, x, y = ssd_pair
    jout = jnet(mx.nd.array(x))
    with CPU:
        tout = tnet(tmx.nd.array(x))
    ja, jc, jb = (o.asnumpy() for o in jout)
    ta, tc, tb = (o.asnumpy() for o in tout)
    assert ta.shape == (1, CS.SSD_ANCHORS, 4)
    assert tc.shape == (2, CS.SSD_ANCHORS, CS.SSD_CLASSES + 1)
    assert tb.shape == (2, CS.SSD_ANCHORS * 4)
    _same(ta, ja)
    _close(tc, jc)
    _close(tb, jb)
    jt = _targets_and_losses(mx, jout, y)
    with CPU:
        tt = _targets_and_losses(tmx, tout, y)
    _same(tt[1], jt[1])
    _same(tt[2], jt[2])
    np.testing.assert_allclose(tt[0], jt[0], rtol=0, atol=1e-6)
    _close(tt[3], jt[3])
    _close(tt[4], jt[4])


@pytest.mark.slow
def test_ssd_training_step_matches_jax(ssd_pair):
    """One train_ssd.py step (chip_smoke.ssd_step) on each package from
    the same weights: the loss, every gradient and every updated
    weight."""
    jnet, tnet, x, y = ssd_pair
    jtrainer = mx.gluon.Trainer(jnet.collect_params(), "sgd",
                                dict(CS.SSD_SGD))
    jloss, jcls = CS.ssd_step(mx, jnet, jtrainer, mx.nd.array(x),
                              mx.nd.array(y))
    with CPU:
        ttrainer = tmx.gluon.Trainer(tnet.collect_params(), "sgd",
                                     dict(CS.SSD_SGD))
        tloss, tcls = CS.ssd_step(tmx, tnet, ttrainer, tmx.nd.array(x),
                                  tmx.nd.array(y))
    _same(tcls.asnumpy(), jcls.asnumpy())
    _close(tloss.asnumpy(), jloss.asnumpy())
    jp, tp = jnet.collect_params(), tnet.collect_params()
    for name, p in jp.items():
        if p.grad_req != "null":
            _close(tp[name].grad().asnumpy(), p.grad().asnumpy())
        _close(tp[name].data().asnumpy(), p.data().asnumpy())
