"""The symbolic training path held against the JAX package on the CPU:
training-mode BatchNorm and its moving statistics, SoftmaxOutput's
gradient rule, ``Executor.backward`` under every ``grad_req``, and the
slice end to end: resnet18_v1 traced and checkpointed by the JAX
package, trained three SGD-momentum steps (and one Adam step) in both
packages through ``simple_bind -> forward(is_train=True) -> backward ->
nd.sgd_mom_update / nd.adam_update``, each of the port's steps from the
JAX package's state before it.

Tolerances: float32 sums (convolutions, batch statistics, the softmax)
are taken in another order than XLA's, so results agree to rounding:
rtol 1e-4 / atol 1e-5 on one graph evaluation, looser where three
training steps compound it, each stated where it is used."""
import torch_test_env  # noqa: F401  (first: one torch thread a process)

import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.base import MXNetError

F32 = np.float32
CPU = tmx.cpu()


def _jnd(d):
    return {k: mx.nd.array(v) for k, v in d.items()}


def _tnd(d):
    return {k: tmx.nd.array(v, ctx=CPU) for k, v in d.items()}


def _close(got, want, rtol=1e-4, atol=1e-5):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=rtol, atol=atol)


def _params(sym, data_shape, seed, extra=()):
    """Seeded fp32 parameters and BatchNorm statistics, as numpy."""
    rng = np.random.default_rng(seed)
    arg_shapes, _, aux_shapes = sym.infer_shape(
        data=data_shape, **{n: s for n, s in extra})
    skip = {"data"} | {n for n, _ in extra}
    arg = {}
    for n, sh in zip(sym.list_arguments(), arg_shapes):
        if n in skip:
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


# ---------------------------------------------------------------------------
# ops
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fix_gamma", [False, True])
def test_batchnorm_training_matches_jax(fix_gamma):
    """Output, batch mean and biased variance of the op, then the moving
    statistics an executor's training forward leaves in aux_dict."""
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((4, 6, 5, 5)) * 2 + 0.5).astype(F32)
    gamma, beta = rng.uniform(0.5, 1.5, 6).astype(F32), \
        rng.uniform(-0.2, 0.2, 6).astype(F32)
    mm, mv = rng.uniform(-0.1, 0.1, 6).astype(F32), \
        rng.uniform(0.5, 2.0, 6).astype(F32)
    attrs = dict(eps=1e-5, momentum=0.9, fix_gamma=fix_gamma,
                 training=True, output_mean_var=True)
    want = mx.nd.BatchNorm(*(mx.nd.array(a) for a in (x, gamma, beta, mm,
                                                      mv)), **attrs)
    with tmx.cpu():
        got = tmx.nd.BatchNorm(*(tmx.nd.array(a) for a in (x, gamma, beta,
                                                          mm, mv)), **attrs)
    for a, b in zip(want, got):
        _close(b.asnumpy(), a.asnumpy())

    def graph(sym):
        return sym.BatchNorm(sym.var("data"), name="bn", eps=1e-5,
                             momentum=0.9, fix_gamma=fix_gamma)

    args = {"data": x, "bn_gamma": gamma, "bn_beta": beta}
    aux = {"bn_moving_mean": mm, "bn_moving_var": mv}
    jex = graph(mx.sym).bind(args=_jnd(args), aux_states=_jnd(aux))
    jout = jex.forward(is_train=True)[0].asnumpy()
    tex = graph(tmx.sym).bind(CPU, args=_tnd(args), aux_states=_tnd(aux))
    tout = tex.forward(is_train=True)[0].asnumpy()
    _close(tout, jout)
    for n in aux:
        _close(tex.aux_dict[n].asnumpy(), jex.aux_dict[n].asnumpy(),
               rtol=1e-5, atol=1e-6)
    # an inference forward leaves the moving statistics alone
    before = tex.aux_dict["bn_moving_var"].asnumpy()
    tex.forward()
    np.testing.assert_array_equal(tex.aux_dict["bn_moving_var"].asnumpy(),
                                  before)


SOFTMAX_CASES = {
    "null": dict(),
    "batch_scaled": dict(normalization="batch", grad_scale=2.5),
    "valid_ignore": dict(normalization="valid", use_ignore=True,
                         ignore_label=-1.0),
    "ignore_null": dict(use_ignore=True, ignore_label=2.0),
    "smooth": dict(smooth_alpha=0.1, normalization="batch"),
    "multi_output": dict(multi_output=True, normalization="valid",
                         use_ignore=True),
}


@pytest.mark.parametrize("case", sorted(SOFTMAX_CASES))
def test_softmax_output_forward_and_gradient_match_jax(case):
    """The reference's loss-layer gradient, whatever the head gradient;
    the label gets none."""
    attrs = SOFTMAX_CASES[case]
    rng = np.random.default_rng(1)
    if attrs.get("multi_output"):
        x = rng.standard_normal((3, 5, 2, 2)).astype(F32)
        y = rng.integers(-1, 5, (3, 2, 2)).astype(F32)
    else:
        x = rng.standard_normal((6, 5)).astype(F32)
        y = np.array([0, 4, -1, 2, 2, 1], F32)

    def graph(sym):
        return sym.SoftmaxOutput(sym.var("data"), name="softmax", **attrs)

    head = rng.standard_normal(x.shape).astype(F32)
    args = {"data": x, "softmax_label": y}
    jex = graph(mx.sym).bind(args=_jnd(args), grad_req="write")
    jout = jex.forward(is_train=True)[0].asnumpy()
    jex.backward(mx.nd.array(head))
    tex = graph(tmx.sym).bind(CPU, args=_tnd(args), grad_req="write")
    tout = tex.forward(is_train=True)[0].asnumpy()
    tex.backward(tmx.nd.array(head, ctx=CPU))
    _close(tout, jout, rtol=1e-6, atol=1e-7)
    _close(tex.grad_dict["data"].asnumpy(), jex.grad_dict["data"].asnumpy(),
           rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(tex.grad_dict["softmax_label"].asnumpy(),
                                  np.zeros_like(y))


def test_softmax_label_shape_is_inferred_and_n1_labels_reshape():
    s = tmx.sym.SoftmaxOutput(tmx.sym.var("data"), name="softmax")
    assert s.list_arguments() == ["data", "softmax_label"]
    args, outs, _ = s.infer_shape(data=(7, 10))
    assert args == [(7, 10), (7,)] and outs == [(7, 10)]
    m = tmx.sym.SoftmaxOutput(tmx.sym.var("data"), multi_output=True)
    assert m.infer_shape(data=(2, 3, 4, 5))[0][1] == (2, 4, 5)
    x = np.random.default_rng(2).standard_normal((4, 3)).astype(F32)
    y = np.array([[0], [2], [1], [1]], F32)
    with tmx.cpu():
        ex = s.bind(args={"data": tmx.nd.array(x),
                          "softmax_label": tmx.nd.array(y)})
        ex.forward(is_train=True)
        ex.backward()
    want = np.exp(x) / np.exp(x).sum(1, keepdims=True)
    want[np.arange(4), y[:, 0].astype(int)] -= 1
    _close(ex.grad_dict["data"].asnumpy(), want, rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# Executor.backward
# ---------------------------------------------------------------------------

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
    fc = sym.FullyConnected(g, name="fc", num_hidden=5)
    return sym.SoftmaxOutput(fc, name="softmax")


SMALL_SHAPE = (4, 3, 10, 10)


@pytest.fixture(scope="module")
def small():
    j = _small_net(mx.sym)
    arg, aux = _params(j, SMALL_SHAPE, 3, extra=(("softmax_label", (4,)),))
    rng = np.random.default_rng(4)
    arg["data"] = rng.standard_normal(SMALL_SHAPE).astype(F32)
    arg["softmax_label"] = np.array([0, 3, 1, 4], F32)
    return arg, aux


GRAD_REQS = {
    "write": "write",
    "add": "add",
    "mixed": {"c0_weight": "write", "bn0_gamma": "add", "fc_weight": "write",
              "c1_bias": "null", "data": "write"},
}


@pytest.mark.parametrize("req", sorted(GRAD_REQS))
def test_executor_backward_matches_jax(small, req):
    """Every gradient of a conv/BN/relu/pool/add/FC graph against the JAX
    executor's; "add" accumulates over two passes; "null" args get no
    gradient array."""
    arg, aux = small
    grad_req = GRAD_REQS[req]
    j, t = _small_net(mx.sym), _small_net(tmx.sym)
    assert t.tojson() == j.tojson()
    jex = j.bind(args=_jnd(arg), aux_states=_jnd(aux), grad_req=grad_req)
    tex = t.bind(CPU, args=_tnd(arg), aux_states=_tnd(aux),
                 grad_req=grad_req)
    passes = 2 if req == "add" else 1
    for _ in range(passes):
        jout = jex.forward(is_train=True)[0].asnumpy()
        jex.backward()
        tout = tex.forward(is_train=True)[0].asnumpy()
        tex.backward()
        _close(tout, jout)
    wanted = {n for n in j.list_arguments()
              if (grad_req if isinstance(grad_req, str)
                  else grad_req.get(n, "null")) != "null"}
    assert set(tex.grad_dict) == wanted
    for n in wanted:
        _close(tex.grad_dict[n].asnumpy(), jex.grad_dict[n].asnumpy())
    for n in aux:
        _close(tex.aux_dict[n].asnumpy(), jex.aux_dict[n].asnumpy())


def test_backward_needs_a_training_forward(small):
    arg, aux = small
    ex = _small_net(tmx.sym).bind(CPU, args=_tnd(arg), aux_states=_tnd(aux))
    assert set(ex.grad_dict) == set(arg)       # allocated at bind
    assert all(not g.asnumpy().any() for g in ex.grad_arrays)
    with pytest.raises(MXNetError):
        ex.backward()
    ex.forward()
    with pytest.raises(MXNetError):
        ex.backward()
    ex.forward(is_train=True)
    ex.backward()
    first = {n: g.asnumpy() for n, g in ex.grad_dict.items()}
    ex.backward()      # the graph is kept until the next forward, as the
    for n, g in first.items():     # JAX executor recomputes: "write"
        np.testing.assert_array_equal(ex.grad_dict[n].asnumpy(), g)


def _fc_softmax_twice(pkg, req):
    """One forward(is_train=True), two backward(): FullyConnected ->
    SoftmaxOutput at data (2, 4)."""
    sym = pkg.sym
    net = sym.SoftmaxOutput(sym.FullyConnected(sym.var("data"), name="fc",
                                               num_hidden=3),
                            name="softmax")
    rng = np.random.default_rng(7)
    arg = {"data": rng.standard_normal((2, 4)).astype(F32),
           "fc_weight": rng.standard_normal((3, 4)).astype(F32),
           "fc_bias": rng.standard_normal(3).astype(F32),
           "softmax_label": np.array([0, 2], F32)}
    if pkg is tmx:
        ex = net.simple_bind(CPU, grad_req=req, data=(2, 4),
                             softmax_label=(2,))
        ex.copy_params_from(_tnd(arg))
    else:
        ex = net.simple_bind(mx.cpu(), grad_req=req, data=(2, 4),
                             softmax_label=(2,))
        ex.copy_params_from(_jnd(arg))
    ex.forward(is_train=True)
    ex.backward()
    once = {n: g.asnumpy() for n, g in ex.grad_dict.items()}
    ex.backward()
    return once, {n: g.asnumpy() for n, g in ex.grad_dict.items()}


@pytest.mark.parametrize("req", ["add", "write"])
def test_second_backward_after_one_forward_matches_jax(req):
    """The JAX executor recomputes from the forward's saved state, so a
    second backward succeeds: "add" accumulates twice, "write" writes
    the same gradient again. The port keeps the recorded graph until
    the next forward and does the same."""
    j_once, j_twice = _fc_softmax_twice(mx, req)
    t_once, t_twice = _fc_softmax_twice(tmx, req)
    assert sorted(t_twice) == sorted(j_twice)
    for n in j_twice:
        _close(t_once[n], j_once[n])
        _close(t_twice[n], j_twice[n])
        factor = 2 if req == "add" else 1
        np.testing.assert_array_equal(t_twice[n], factor * t_once[n])


def test_copy_params_from_leaves_the_callers_arrays_alone(small):
    arg, aux = small
    with tmx.cpu():
        params = _tnd({k: v for k, v in arg.items()
                       if k not in ("data", "softmax_label")})
        ex = _small_net(tmx.sym).simple_bind(
            grad_req="write", data=SMALL_SHAPE, softmax_label=(4,))
        ex.copy_params_from(params, _tnd(aux), allow_extra_params=True)
        ex.forward(is_train=True, data=tmx.nd.array(arg["data"]),
                   softmax_label=tmx.nd.array(arg["softmax_label"]))
        ex.backward()
        for n, p in params.items():
            tmx.nd.sgd_mom_update(ex.arg_dict[n], ex.grad_dict[n],
                                  tmx.nd.zeros(p.shape), out=ex.arg_dict[n],
                                  lr=0.5)
            assert np.abs(ex.grad_dict[n].asnumpy()).max() > 0
            assert not np.array_equal(ex.arg_dict[n].asnumpy(), arg[n])
            np.testing.assert_array_equal(p.asnumpy(), arg[n])


# ---------------------------------------------------------------------------
# the slice end to end: resnet18_v1, SGD momentum and Adam
# ---------------------------------------------------------------------------

# 64 x 64 so that stage 4's BatchNorm sees 2 x 2 positions per image: at
# 32 x 32 it normalises over 4 values, nearly singular, and the rounding
# noise of either package decides the steps that follow
R18_SHAPE = (4, 3, 64, 64)
STEPS = 3
SGD = dict(lr=0.05, momentum=0.9, wd=1e-4, rescale_grad=1.0 / R18_SHAPE[0])
ADAM = dict(beta1=0.9, beta2=0.999, epsilon=1e-8, wd=1e-4,
            rescale_grad=1.0 / R18_SHAPE[0])
ADAM_LR = 1e-3


def _loss(prob, label):
    return float(-np.log(prob[np.arange(len(label)),
                              label.astype(int)]).mean())


def _step(pkg, ex, params, states, x, y, t, adam):
    """Step t of the §1 loop: forward(is_train=True), backward, then one
    nd update op per parameter (SGD momentum, or Adam with its bias
    correction folded into lr). Returns a snapshot: the forward's loss
    and probabilities, the parameters, BatchNorm statistics and optimizer
    states after the update."""
    ctx = ex_ctx(pkg)
    out = ex.forward(is_train=True, data=pkg.nd.array(x, ctx=ctx),
                     softmax_label=pkg.nd.array(y, ctx=ctx))
    prob = out[0].asnumpy()
    ex.backward()
    for n in params:
        w, g = ex.arg_dict[n], ex.grad_dict[n]
        if adam:
            lr_t = ADAM_LR * np.sqrt(1 - ADAM["beta2"] ** t) \
                / (1 - ADAM["beta1"] ** t)
            pkg.nd.adam_update(w, g, *states[n], out=w, lr=lr_t, **ADAM)
        else:
            pkg.nd.sgd_mom_update(w, g, states[n][0], out=w, **SGD)
    return dict(loss=_loss(prob, y), prob=prob,
                arg={n: ex.arg_dict[n].asnumpy() for n in params},
                aux={n: v.asnumpy() for n, v in ex.aux_dict.items()},
                states={n: [s.asnumpy() for s in v]
                        for n, v in states.items()})


def _steps(kind):
    return 1 if kind == "adam" else STEPS


def ex_ctx(pkg):
    return CPU if pkg is tmx else mx.cpu()


@pytest.fixture(scope="module")
def r18(tmp_path_factory):
    """resnet18_v1 traced by the JAX package and written with its
    save_checkpoint; the JAX side of the training loop run from it, one
    snapshot per step."""
    from mxnet_tpu.gluon.block import infer_shapes
    from mxnet_tpu.gluon.model_zoo import vision
    from mxnet_tpu.symbol.trace import trace_block
    net = vision.resnet18_v1()
    net.initialize()
    infer_shapes(net, (1,) + R18_SHAPE[1:])
    sym, _ = trace_block(net)
    arg, aux = _params(sym, R18_SHAPE, 21)
    prefix = str(tmp_path_factory.mktemp("r18t") / "resnet18_v1")
    mx.model.save_checkpoint(prefix, 0, sym, _jnd(arg), _jnd(aux))
    rng = np.random.default_rng(22)
    x = rng.standard_normal(R18_SHAPE).astype(F32)
    y = rng.integers(0, 1000, R18_SHAPE[0]).astype(F32)
    net = mx.sym.SoftmaxOutput(sym, name="softmax")
    ex = net.simple_bind(mx.cpu(), grad_req="write", data=R18_SHAPE,
                         softmax_label=(R18_SHAPE[0],))
    res = {"prefix": prefix, "x": x, "y": y, "params": sorted(arg)}
    for kind in ("sgd", "adam"):
        ex.copy_params_from(_jnd(arg), _jnd(aux))
        states = {n: [mx.nd.zeros(ex.arg_dict[n].shape, ctx=mx.cpu())
                      for _ in range(2 if kind == "adam" else 1)]
                  for n in arg}
        res[kind] = [_step(mx, ex, arg, states, x, y, t, kind == "adam")
                     for t in range(1, _steps(kind) + 1)]
    return res


@pytest.fixture(scope="module")
def r18_port(r18):
    """The port's run of the same loop from the JAX checkpoint. Step 1
    starts from the checkpoint; every later step from the JAX package's
    state after the step before (parameters, BatchNorm statistics and
    optimizer states), so each step is held to the bounds of one step.
    Chained, the two runs part at step 2: a pre-activation within
    rounding of 0 takes the ReLU's other side in one package, and the
    gradients of the convolution before it differ by a few % of their
    scale, with both packages right."""
    with tmx.cpu():
        sym, arg, aux = tmx.model.load_checkpoint(r18["prefix"], 0)
        net = tmx.sym.SoftmaxOutput(sym, name="softmax")
        ex = net.simple_bind(grad_req="write", data=R18_SHAPE,
                             softmax_label=(R18_SHAPE[0],))
        res = {"graph": net.tojson(), "n_params": len(arg)}
        for kind in ("sgd", "adam"):
            ex.copy_params_from(arg, aux)
            states = {n: [tmx.nd.zeros(ex.arg_dict[n].shape)
                          for _ in range(2 if kind == "adam" else 1)]
                      for n in arg}
            res[kind] = []
            for t in range(1, _steps(kind) + 1):
                if t > 1:
                    prev = r18[kind][t - 2]
                    ex.copy_params_from(_tnd(prev["arg"]), _tnd(prev["aux"]))
                    states = {n: [tmx.nd.array(s) for s in v]
                              for n, v in prev["states"].items()}
                res[kind].append(_step(tmx, ex, arg, states, r18["x"],
                                       r18["y"], t, kind == "adam"))
    return res


def test_resnet18_graph_and_parameters_cross(r18, r18_port):
    net = mx.sym.SoftmaxOutput(mx.sym.load(r18["prefix"] + "-symbol.json"),
                               name="softmax")
    assert r18_port["graph"] == net.tojson()
    assert r18_port["n_params"] == len(r18["params"])


# One training step from the same state runs the fp32 sums of both
# packages in another order: the worst weight after it differs by about
# 1e-6 of the largest of its tensor. The bounds below hold each tensor to
# 1e-4 of its own scale (the momenta, differences of nearly equal
# weights, to 1e-3).
def _close_scaled(got, want, rel):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-12)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale)


def _logits(prob):
    """SoftmaxOutput's input up to the per-row constant softmax ignores:
    the log-probabilities less each row's mean, in f64."""
    lp = np.log(np.asarray(prob, np.float64))
    return lp - lp.mean(axis=1, keepdims=True)


LOGIT_REL = 1e-4


@pytest.mark.parametrize("kind", ["sgd", "adam"])
def test_resnet18_training_matches_jax(r18, r18_port, kind):
    js, ts = r18[kind], r18_port[kind]
    if kind == "sgd":
        assert ts[-1]["loss"] < ts[0]["loss"]
    for j, t in zip(js, ts):
        # the step's forward: logits to 1e-4 of their scale
        want = _logits(j["prob"])
        delta = LOGIT_REL * np.abs(want).max()
        np.testing.assert_allclose(_logits(t["prob"]), want, rtol=0,
                                   atol=delta)
        # its loss from that bound. A row's loss is L = -log p_y =
        # log sum_j exp(z_j - z_y), so dL = sum_{j != y} p_j (dz_j - dz_y)
        # and |dL| <= (1 - p_y) 2 delta <= 2 delta L, as 1 - p <= -log p:
        # the relative error of a loss is the error of a logit margin,
        # and a loss near 0 (step 3's is 1e-3) is held to that, not to a
        # fixed atol. The mean over rows keeps the bound; rtol 1e-5
        # covers the loss's own rounding.
        assert abs(t["loss"] - j["loss"]) <= (1e-5 + 2 * delta) * j["loss"]
        for n in r18["params"]:
            tw, jw = t["arg"][n], j["arg"][n]
            if kind == "adam":
                # Adam's first step moves each weight by about 3.16 * lr_t
                # * sign(g) whatever the size of g, so where g is at the
                # rounding noise of the fp32 sums (|mean| under 1e-3 of the
                # tensor's largest) either sign is right: there the weights
                # agree to two such steps, elsewhere to 1e-4
                m = j["states"][n][0]
                keep = np.abs(m) >= 1e-3 * np.abs(m).max()
                step = ADAM_LR * np.sqrt(1 - ADAM["beta2"]) \
                    / (1 - ADAM["beta1"])
                assert np.abs(tw - jw).max() <= 2 * 3.17 * step
                tw, jw = tw[keep], jw[keep]
            _close_scaled(tw, jw, 1e-4)
            for a, b in zip(t["states"][n], j["states"][n]):
                _close_scaled(a, b, 1e-3)
        for n in j["aux"]:
            _close_scaled(t["aux"][n], j["aux"][n], 1e-4)


def test_trained_state_crosses_back_to_jax(r18, r18_port, tmp_path):
    """The port's save_checkpoint writes the trained weights; the JAX
    package reads them back unchanged."""
    t = r18_port["sgd"][-1]
    prefix = str(tmp_path / "trained")
    with tmx.cpu():
        net = tmx.sym.load_json(r18_port["graph"])
        tmx.model.save_checkpoint(prefix, 3, net, _tnd(t["arg"]),
                                  _tnd(t["aux"]))
    sym, arg, aux = mx.model.load_checkpoint(prefix, 3)
    assert sym.tojson() == r18_port["graph"]
    for n, v in t["arg"].items():
        np.testing.assert_array_equal(arg[n].asnumpy(), v)
    for n, v in t["aux"].items():
        np.testing.assert_array_equal(aux[n].asnumpy(), v)
