"""The port's imperative autograd held against the JAX package on the
CPU: the counterparts of ``tests/test_autograd.py``'s cases, each run in
both packages on the same inputs and compared (not restated), then the
cases the tape on torch has to get right on its own: a frozen
(predict-mode, hybridized) feature extractor feeding a recorded head,
``record(train_mode=False)`` through a hybridized block, ``grad_req``
"write" over two backwards, a second backward without
``retain_graph`` (it raises in both packages), the NDArray operators
the port added, and an in-place weight update outside ``record``.

Tolerance: rtol 1e-6 / atol 1e-7, float32 rounding of the same ops
(torch and XLA may sum a reduction in another order)."""
import torch_test_env  # noqa: F401  (first: one torch thread a process)

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.gluon.utils import params_from_jax

F32 = np.float32
CPU = tmx.cpu()
RTOL, ATOL = 1e-6, 1e-7


def _run(case, pkg):
    if pkg is tmx:
        with CPU:
            return case(pkg)
    return case(pkg)


def _np(x):
    return x.asnumpy() if hasattr(x, "asnumpy") else np.asarray(x)


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(F32)


# -- the counterparts of tests/test_autograd.py ------------------------------
def basic_backward(pkg):
    nd, ag = pkg.nd, pkg.autograd
    x = nd.array([1.0, 2.0, 3.0])
    x.attach_grad()
    with ag.record():
        y = (x * x).sum()
    y.backward()
    return [x.grad]


def chain_and_broadcast(pkg):
    nd, ag = pkg.nd, pkg.autograd
    x, w = nd.array(_rand((3, 4), 0)), nd.array(_rand((4, 2), 1))
    x.attach_grad()
    w.attach_grad()
    with ag.record():
        z = (nd.relu(nd.dot(x, w)) * 2).sum()
    z.backward()
    return [z, x.grad, w.grad]


def head_gradient(pkg):
    nd, ag = pkg.nd, pkg.autograd
    x = nd.array([1.0, 2.0])
    x.attach_grad()
    with ag.record():
        y = x * 3
    y.backward(nd.array([10.0, 100.0]))
    return [x.grad]


def grad_req_add(pkg):
    nd, ag = pkg.nd, pkg.autograd
    x = nd.array([1.0, 2.0])
    x.attach_grad(grad_req="add")
    for _ in range(3):
        with ag.record():
            y = (x * x).sum()
        y.backward()
    return [x.grad]


def detach_blocks_grad(pkg):
    nd, ag = pkg.nd, pkg.autograd
    x = nd.array([2.0])
    x.attach_grad()
    with ag.record():
        z = (x * 3).detach() * x
    z.backward()
    return [x.grad]


def blockgrad_op(pkg):
    nd, ag = pkg.nd, pkg.autograd
    x = nd.array([2.0])
    x.attach_grad()
    with ag.record():
        y = nd.BlockGrad(x * 3) * x
    y.backward()
    return [x.grad]


def pause_scope(pkg):
    nd, ag = pkg.nd, pkg.autograd
    x = nd.array([1.0])
    x.attach_grad()
    with ag.record():
        y = x * 2
        with ag.pause():
            c = x * 10
        z = y + c.detach()
    z.backward()
    return [x.grad, z]


def is_recording_training(pkg):
    ag = pkg.autograd
    flags = [ag.is_recording()]
    with ag.record():
        flags += [ag.is_recording(), ag.is_training()]
        with ag.pause():
            flags.append(ag.is_recording())
    with ag.record(train_mode=False):
        flags.append(ag.is_training())
    with ag.train_mode():
        flags.append(ag.is_training())
    with ag.predict_mode():
        flags.append(ag.is_training())
    return [np.array(flags)]


def grad_function(pkg):
    nd, ag = pkg.nd, pkg.autograd
    x = nd.array([3.0])
    x.attach_grad()
    with ag.record():
        y = x * x * x
    return ag.grad([y], [x])


def second_order_grad(pkg):
    nd, ag = pkg.nd, pkg.autograd
    x = nd.array([2.0])
    x.attach_grad()
    with ag.record():
        y = x * x * x
        g = ag.grad([y], [x], create_graph=True, retain_graph=True)[0]
        z = g.sum()
    z.backward()
    return [g, x.grad]


def getitem_grad(pkg):
    nd, ag = pkg.nd, pkg.autograd
    x = nd.array(np.arange(6, dtype=F32).reshape(2, 3))
    x.attach_grad()
    with ag.record():
        y = (x[0] * 2).sum() + (x[1, 1:] ** 2).sum()
    y.backward()
    return [x.grad]


def multi_output_heads(pkg):
    nd, ag = pkg.nd, pkg.autograd
    x = nd.array([1.0, 2.0])
    x.attach_grad()
    with ag.record():
        y1 = x * 2
        y2 = x * 3
    ag.backward([y1, y2])
    return [x.grad]


def mark_variables(pkg):
    nd, ag = pkg.nd, pkg.autograd
    x = nd.array([1.0, 2.0])
    g = nd.zeros((2,))
    ag.mark_variables([x], [g])
    with ag.record():
        y = (x * x).sum()
    y.backward()
    return [x.grad, g]


def custom_function(pkg):
    nd, ag = pkg.nd, pkg.autograd

    class Square(ag.Function):
        def forward(self, x):
            self.save_for_backward(x)
            return x * x

        def backward(self, dy):
            x, = self.saved_tensors
            return dy * x * 2

    x = nd.array([3.0, -1.5])
    x.attach_grad()
    sq = Square()
    with ag.record():
        y = (sq(x) * nd.array([1.0, 4.0])).sum()
    y.backward()
    return [y, x.grad]


def softmax_output_backward(pkg):
    nd, ag = pkg.nd, pkg.autograd
    x = nd.array(_rand((4, 3), 2))
    label = nd.array([0, 1, 2, 1])
    x.attach_grad()
    with ag.record():
        out = nd.SoftmaxOutput(x, label)
    out.backward()
    return [out, x.grad]


def training_flag_injection(pkg):
    """Dropout at p=0 follows the flag without drawing; the predict-mode
    identity is checked at p=0.9 (no draw either)."""
    nd, ag = pkg.nd, pkg.autograd
    x = nd.ones((50,))
    with ag.record(train_mode=False):
        y1 = nd.Dropout(x, p=0.9)
    y2 = nd.Dropout(x, p=0.9)
    return [y1, y2]


CASES = {f.__name__: f for f in (
    basic_backward, chain_and_broadcast, head_gradient, grad_req_add,
    detach_blocks_grad, blockgrad_op, pause_scope, is_recording_training,
    grad_function, second_order_grad, getitem_grad, multi_output_heads,
    mark_variables, custom_function, softmax_output_backward,
    training_flag_injection)}


@pytest.mark.parametrize("name", sorted(CASES))
def test_case_matches_jax(name):
    want = _run(CASES[name], mx)
    got = _run(CASES[name], tmx)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), _np(w), rtol=RTOL, atol=ATOL)


def test_dropout_gradient_is_the_mask_drawn_in_forward():
    """The 17th case, by distribution: the packages draw from different
    generators (the port's Dropout takes an explicit one)."""
    x = tmx.nd.ones((1000,), ctx=CPU)
    x.attach_grad()
    with tmx.autograd.record():
        y = tmx.nd.Dropout(x, p=0.5, generator=torch.Generator())
        z = y.sum()
    z.backward()
    g = x.grad.asnumpy()
    assert set(np.unique(g)) <= {0.0, 2.0}
    np.testing.assert_array_equal(g, y.asnumpy())
    assert 400 < (g == 0).sum() < 600


# -- what the tape on torch must get right -----------------------------------
def _nets(build, x_shape, seed=0):
    """The same block in both packages with the same weights."""
    jnet = build(mx.gluon.nn)
    jnet.initialize()
    jnet(mx.nd.array(_rand(x_shape, 9)))
    rng = np.random.default_rng(seed)
    weights = {}
    for name, p in jnet.collect_params().items():
        v = rng.uniform(0.5, 1.5, p.shape) if name.endswith(
            ("gamma", "running_var")) else rng.normal(0, 0.3, p.shape)
        weights[name] = v.astype(F32)
        p.set_data(mx.nd.array(weights[name]))
    tnet = build(tmx.gluon.nn)
    tnet.initialize(ctx=CPU)
    with CPU:
        tnet(tmx.nd.array(_rand(x_shape, 9)))
    params_from_jax(tnet, weights, ctx=CPU)
    return jnet, tnet


def _extractor(nn):
    net = nn.HybridSequential(prefix="feat_")
    with net.name_scope():
        net.add(nn.Conv2D(4, 3, padding=1), nn.BatchNorm(),
                nn.Activation("relu"), nn.GlobalAvgPool2D())
    return net


def _head(nn):
    return nn.Dense(3, prefix="head_")


@pytest.mark.parametrize("hybridize", [False, True])
def test_frozen_extractor_feeds_a_recorded_head(hybridize):
    """Features computed in predict mode outside record (inference
    tensors when hybridized) are the input of a head trained under
    record; the extractor gets no gradient and its BatchNorm statistics
    stay put."""
    x = _rand((4, 3, 8, 8), 1)
    jf, tf = _nets(_extractor, x.shape, 0)
    jh, th = _nets(_head, (4, 4), 1)
    if hybridize:
        jf.hybridize()
        tf.hybridize()
    res = {}
    for pkg, f, h in ((mx, jf, jh), (tmx, tf, th)):
        def step(pkg=pkg, f=f, h=h):
            feats = f(pkg.nd.array(x))
            with pkg.autograd.record():
                loss = (h(feats) ** 2).mean()
            loss.backward()
            return [loss, h.weight.grad(), h.bias.grad(),
                    f[1].running_mean.data()]
        res[pkg] = _run(lambda _: step(), pkg)
    if hybridize:
        assert tf(tmx.nd.array(x, ctx=CPU))._data.is_inference()
    for g, w in zip(res[tmx], res[mx]):
        np.testing.assert_allclose(_np(g), _np(w), rtol=1e-5, atol=1e-6)
    assert tf[0].weight.grad().asnumpy().any() == \
        jf[0].weight.grad().asnumpy().any()


def test_record_predict_mode_through_a_hybridized_block():
    """record(train_mode=False) records a hybridized block run on its
    moving statistics: gradients match the JAX package's and the
    statistics do not move."""
    x = _rand((4, 3, 8, 8), 2)
    jf, tf = _nets(_extractor, x.shape, 3)
    jf.hybridize()
    tf.hybridize()
    res = {}
    for pkg, f in ((mx, jf), (tmx, tf)):
        def step(pkg=pkg, f=f):
            with pkg.autograd.record(train_mode=False):
                loss = (f(pkg.nd.array(x)) ** 2).sum()
            loss.backward()
            return [loss, f[0].weight.grad(), f[1].gamma.grad(),
                    f[1].running_mean.data()]
        res[pkg] = _run(lambda _: step(), pkg)
    for g, w in zip(res[tmx], res[mx]):
        np.testing.assert_allclose(_np(g), _np(w), rtol=1e-5, atol=1e-6)


def _write_twice(pkg):
    nd, ag = pkg.nd, pkg.autograd
    x = nd.array([1.0, -2.0, 0.5])
    x.attach_grad()
    with ag.record():
        y = (x * x * x).sum()
    y.backward()
    first = x.grad.asnumpy().copy()
    with ag.record():
        y = (x * 5).sum()
    y.backward()
    return [first, x.grad]


def test_grad_req_write_over_two_backwards_replaces():
    want, got = _run(_write_twice, mx), _run(_write_twice, tmx)
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), _np(w), rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(_np(got[1]), [5.0, 5.0, 5.0])


def _second_backward(pkg, retain):
    nd, ag = pkg.nd, pkg.autograd
    x = nd.array([1.0, 2.0])
    x.attach_grad(grad_req="add")
    with ag.record():
        y = (x * x).sum()
        other = (x * 3).sum()
    y.backward(retain_graph=retain)
    try:
        y.backward(retain_graph=retain)
    except pkg.MXNetError:
        raised = True
    else:
        raised = False
    try:   # another head of the same tape
        other.backward()
    except pkg.MXNetError:
        raised_other = True
    else:
        raised_other = False
    return raised, raised_other, x.grad.asnumpy()


@pytest.mark.parametrize("retain", [False, True])
def test_second_backward_follows_the_jax_tape(retain):
    """Without retain_graph the JAX tape is cleared: a second backward,
    of the same heads or of another recorded before, raises in both
    packages; with it both accumulate."""
    want = _run(lambda p: _second_backward(p, retain), mx)
    got = _run(lambda p: _second_backward(p, retain), tmx)
    assert got[:2] == want[:2] == ((not retain,) * 2)
    np.testing.assert_allclose(got[2], want[2], rtol=RTOL)


def _operators(pkg):
    nd, ag = pkg.nd, pkg.autograd
    a = nd.array(_rand((3, 4), 5))
    b = nd.array(np.abs(_rand((3, 4), 6)) + 0.5)
    m = nd.array(_rand((4, 2), 7))
    a.attach_grad()
    b.attach_grad()
    with ag.record():
        c = a * 1.0
        c[1] = b[1] * 2            # recorded slice assignment
        y = ((c ** 2) + (b ** a) + (2.0 ** a) + (a @ m).sum()
             + (a % 0.7) + (3.0 - a) / b).sum()
    y.backward()
    cmp = [a > 0, a >= b, a < 0.1, a <= b, a == a, a != b,
           b.max(axis=1), a.mean(axis=0, keepdims=True), a.T,
           a.reshape((2, -1)), a.astype("float16")]
    return [y, a.grad, b.grad] + cmp


def test_ndarray_operators_forward_and_gradient_match_jax():
    want, got = _run(_operators, mx), _run(_operators, tmx)
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = _np(g), _np(w)
        assert g.shape == w.shape and g.dtype == w.dtype, i
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6)


def test_ndarray_index_pickle_and_setitem_outside_record():
    import pickle
    with CPU:
        x = tmx.nd.array(np.arange(6, dtype=F32))
        assert [1, 2, 3][tmx.nd.array([2.0])] == 3
        x[2:4] = 7.0
        np.testing.assert_array_equal(x.asnumpy(), [0, 1, 7, 7, 4, 5])
        y = pickle.loads(pickle.dumps(x))
        np.testing.assert_array_equal(y.asnumpy(), x.asnumpy())


def test_in_place_update_outside_record_keeps_the_variable():
    """The imperative recipe ``w -= lr * w.grad`` runs outside record:
    the weight keeps its leaf and its gradient buffer, and a linear
    regression converges."""
    rng = np.random.default_rng(0)
    with CPU:
        nd, ag = tmx.nd, tmx.autograd
        X = nd.array(rng.standard_normal((256, 2)).astype(F32))
        y = nd.dot(X, nd.array([[2.0], [-3.4]])) + 4.2
        w = nd.array(rng.normal(0, 0.1, (2, 1)).astype(F32))
        b = nd.zeros((1,))
        w.attach_grad()
        b.attach_grad()
        leaf = w._data
        for _ in range(60):
            with ag.record():
                loss = ((nd.dot(X, w) + b - y) ** 2).mean()
            loss.backward()
            w -= 0.1 * w.grad
            b -= 0.1 * b.grad
        assert w._data is leaf and w._data.requires_grad
        assert float(loss.asscalar()) < 1e-3


# -- the ops the losses, metrics and optimizers reach, forward and gradient --
A, B = _rand((3, 4), 11), _rand((3, 4), 12)
POS = np.abs(_rand((3, 4), 13)) + 0.5
OPS = {
    "pick": ("pick", [A, np.array([0, 3, 1], F32)],
             dict(axis=1, keepdims=True)),
    "pick_axis0": ("pick", [A, np.array([2, 0, 1, 1], F32)], dict(axis=0)),
    "sum_axis_exclude": ("sum", [A], dict(axis=1, exclude=True)),
    "sum_keepdims": ("sum", [A], dict(axis=0, keepdims=True)),
    "mean_all": ("mean", [A], {}),
    "mean_exclude": ("mean", [A], dict(axis=0, exclude=True)),
    "max": ("max", [A], dict(axis=1)),
    "square": ("square", [A], {}),
    "sqrt": ("sqrt", [POS], {}),
    "abs": ("abs", [A], {}),
    "exp": ("exp", [A], {}),
    "log": ("log", [POS], {}),
    "log1p": ("log1p", [POS], {}),
    "relu": ("relu", [A], {}),
    "sigmoid": ("sigmoid", [A], {}),
    "softrelu": ("Activation", [A], dict(act_type="softrelu")),
    "maximum": ("broadcast_maximum", [A, B[:1]], {}),
    "minimum": ("broadcast_minimum", [A, B], {}),
    "maximum_scalar": ("_maximum_scalar", [A], dict(scalar=0.2)),
    "clip": ("clip", [A], dict(a_min=-0.5, a_max=0.7)),
    "where": ("where", [(A > 0).astype(F32), A, B], {}),
    "sign": ("sign", [A], {}),
    "blockgrad": ("BlockGrad", [A], {}),
    "reshape_like": ("reshape_like", [A, np.zeros((4, 3), F32)], {}),
    "reshape_codes": ("Reshape", [A.reshape(3, 2, 2)], dict(shape=(0, -1))),
    "reshape_split": ("Reshape", [A], dict(shape=(-4, 1, 3, -2))),
    "norm": ("norm", [A], {}),
    "norm_axis": ("norm", [A], dict(axis=1)),
    "dot": ("dot", [A, _rand((4, 2), 14)], {}),
    "dot_transposed": ("dot", [A, _rand((2, 4), 14)],
                       dict(transpose_b=True)),
    "equal_scalar": ("_equal_scalar", [np.round(A)], dict(scalar=0.0)),
    "greater": ("broadcast_greater", [A, B], {}),
    "power": ("broadcast_power", [POS, B], {}),
    "mod_scalar": ("_mod_scalar", [A], dict(scalar=0.3)),
}


# the input whose gradient is compared; None: the op has no gradient
# (comparisons, BlockGrad), its forward alone is compared
GRAD_INPUT = {"where": 1, "blockgrad": None, "equal_scalar": None,
              "greater": None}


def _op_run(pkg, name):
    op, inputs, attrs = OPS[name]
    arrays = [pkg.nd.array(a) for a in inputs]
    which = GRAD_INPUT.get(name, 0)
    if which is None:
        return [getattr(pkg.nd, op)(*arrays, **attrs).asnumpy()]
    x = arrays[which]
    x.attach_grad()
    with pkg.autograd.record():
        out = getattr(pkg.nd, op)(*arrays, **attrs)
    head = pkg.nd.array(_rand(out.shape, 15)) if out.shape else None
    out.backward(head)
    return out.asnumpy(), x.grad.asnumpy()


@pytest.mark.parametrize("name", sorted(OPS))
def test_op_forward_and_gradient_match_jax(name):
    want = _run(lambda p: _op_run(p, name), mx)
    got = _run(lambda p: _op_run(p, name), tmx)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6)
