"""The port's gluon training held against the JAX package on the CPU:
every ported loss (forward and gradient), each optimizer class over one
and three updates (weight decay, clipping, momentum, multi-precision
bf16), the learning-rate schedulers, the metrics, the ``Updater``'s
states round-tripped and carried over from the JAX package, the dense
update ops, and three SGD-momentum ``Trainer`` steps of gluon
resnet18_v1 at 64x64, each from the JAX package's state before it.

Tolerances, stated where used:
- losses: 1e-6 of each output's scale (exp / log are not correctly
  rounded on either side);
- optimizer classes: 2 ulp of each tensor's largest value. The jitted
  JAX steps (SGD, LBSGD) contract products into fused multiply-adds,
  which the port reproduces; LBSGD's norms sum in another order; the
  rest are eager op for op;
- update ops: bitwise, but the RMSProp pair's weight and delta (XLA's
  approximate reciprocal square root): 2 ulp of the largest value;
- lr schedulers exact; metrics 1e-6;
- Trainer steps: one step's bounds as the symbolic training test's
  (logits 1e-4 of their scale, weights and statistics 1e-4, momenta
  1e-3 of each tensor's scale).
"""
import torch_test_env  # noqa: F401  (first: one torch thread a process)

import pickle

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as tmx
from mxnet_tpu.ops import registry as jreg
from mxnet_tpu_torch.ops import fused_opt
from mxnet_tpu_torch.ops import registry as treg
from mxnet_tpu_torch.gluon.utils import params_from_jax, \
    updater_states_from_jax

F32 = np.float32
CPU = tmx.cpu()


@pytest.fixture(scope="module", autouse=True)
def _jax_health_off():
    """The JAX package's health plane only observes its steps (a
    sentry and norm program a step or an update, each compiled): off
    here, it leaves every value these tests compare unchanged."""
    from mxnet_tpu.profiling import health
    before = health.policy()
    health.set_enabled(False)
    yield
    health.set_enabled(before if before is not None else "0")


def _rand(shape, seed, lo=None, hi=None):
    rng = np.random.default_rng(seed)
    if lo is not None:
        return rng.uniform(lo, hi, shape).astype(F32)
    return rng.standard_normal(shape).astype(F32)


def _scaled(got, want, rel):
    want = np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=0,
                               atol=rel * scale)


def _ulps(got, want, n=2):
    """|got - want| <= n ulp of the tensor's largest |value|."""
    want = np.asarray(want, F32)
    got = np.asarray(got, F32)
    assert got.shape == want.shape
    tol = n * np.spacing(np.abs(want).max().astype(F32))
    err = np.abs(got.astype(np.float64) - want).max()
    assert err <= tol, f"{err} > {n} ulp ({tol})"


# -- losses ------------------------------------------------------------------
def _sig(x):
    return (1 / (1 + np.exp(-x))).astype(F32)


def _softmax(x):
    e = np.exp(x - x.max(-1, keepdims=True))
    return (e / e.sum(-1, keepdims=True)).astype(F32)


P = (4, 5)
LABELS = np.array([0, 3, 1, 4], F32)
SIGNS = np.where(_rand(P, 3) > 0, 1, -1).astype(F32)
LOSSES = {
    "l2": (lambda L: L.L2Loss(), [_rand(P, 1), _rand(P, 2)]),
    "l2_weighted": (lambda L: L.L2Loss(weight=0.5),
                    [_rand(P, 1), _rand(P, 2), _rand((4, 1), 4, 0, 1)]),
    "l1": (lambda L: L.L1Loss(), [_rand(P, 1), _rand(P, 2)]),
    "sigmoid_bce": (lambda L: L.SigmoidBCELoss(),
                    [_rand(P, 1), _rand(P, 5, 0, 1)]),
    "sigmoid_bce_pos_weight": (
        lambda L: L.SigmoidBCELoss(),
        [_rand(P, 1), _rand(P, 5, 0, 1), None, _rand((5,), 6, 0.5, 2)]),
    "sigmoid_bce_from_sigmoid": (
        lambda L: L.SigmoidBCELoss(from_sigmoid=True),
        [_sig(_rand(P, 1)), _rand(P, 5, 0, 1)]),
    "softmax_ce": (lambda L: L.SoftmaxCELoss(), [_rand(P, 1), LABELS]),
    "softmax_ce_weighted": (lambda L: L.SoftmaxCELoss(weight=2.0),
                            [_rand(P, 1), LABELS, _rand((4, 1), 4, 0, 1)]),
    "softmax_ce_dense": (lambda L: L.SoftmaxCELoss(sparse_label=False),
                         [_rand(P, 1), _softmax(_rand(P, 7))]),
    "softmax_ce_from_logits": (
        lambda L: L.SoftmaxCELoss(from_logits=True),
        [np.log(_softmax(_rand(P, 1))), LABELS]),
    "kl_div": (lambda L: L.KLDivLoss(from_logits=False),
               [_rand(P, 1), _softmax(_rand(P, 7))]),
    "kl_div_logits": (lambda L: L.KLDivLoss(),
                      [np.log(_softmax(_rand(P, 1))),
                       _softmax(_rand(P, 7))]),
    "huber": (lambda L: L.HuberLoss(rho=0.5), [_rand(P, 1), _rand(P, 2)]),
    "hinge": (lambda L: L.HingeLoss(), [_rand(P, 1), SIGNS]),
    "squared_hinge": (lambda L: L.SquaredHingeLoss(),
                      [_rand(P, 1), SIGNS]),
    "logistic": (lambda L: L.LogisticLoss(), [_rand(P, 1), SIGNS]),
    "logistic_binary": (lambda L: L.LogisticLoss(label_format="binary"),
                        [_rand(P, 1), (SIGNS + 1) / 2]),
    "triplet": (lambda L: L.TripletLoss(margin=2.0),
                [_rand(P, 1), _rand(P, 2), _rand(P, 8)]),
    "cosine_embedding": (lambda L: L.CosineEmbeddingLoss(margin=0.1),
                         [_rand(P, 1), _rand(P, 2), SIGNS[:, 0]]),
}


def _loss_run(pkg, name):
    build, inputs = LOSSES[name]
    loss_fn = build(pkg.gluon.loss)
    arrays = [None if a is None else pkg.nd.array(a) for a in inputs]
    pred = arrays[0]
    pred.attach_grad()
    with pkg.autograd.record():
        out = loss_fn(*arrays)
    out.backward()
    return out.asnumpy(), pred.grad.asnumpy()


@pytest.mark.parametrize("name", sorted(LOSSES))
def test_loss_forward_and_gradient_match_jax(name):
    want = _loss_run(mx, name)
    with CPU:
        got = _loss_run(tmx, name)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        _scaled(g, w, 1e-6)


def test_ctc_loss_waits_for_its_op():
    with pytest.raises(tmx.MXNetError):
        tmx.gluon.loss.CTCLoss()


# -- optimizer classes -------------------------------------------------------
OPTIMIZERS = {
    "sgd": ("sgd", dict(learning_rate=0.1, wd=1e-2)),
    "sgd_mom_clip": ("sgd", dict(learning_rate=0.1, momentum=0.9, wd=0.3,
                                 clip_gradient=0.4, rescale_grad=0.5)),
    "sgd_mom_bf16": ("sgd", dict(learning_rate=0.1, momentum=0.9, wd=1e-3,
                                 multi_precision=True)),
    "signum": ("signum", dict(learning_rate=0.01, momentum=0.9, wd=1e-2,
                              wd_lh=0.01)),
    "nag": ("nag", dict(learning_rate=0.1, momentum=0.9, wd=1e-2,
                        clip_gradient=0.5)),
    "adam": ("adam", dict(learning_rate=0.01, wd=1e-2, rescale_grad=0.25)),
    "adam_bf16": ("adam", dict(learning_rate=0.01, multi_precision=True)),
    "adagrad": ("adagrad", dict(learning_rate=0.1, wd=1e-2)),
    "rmsprop": ("rmsprop", dict(learning_rate=0.01, wd=1e-2)),
    "rmsprop_centered": ("rmsprop", dict(learning_rate=0.01, centered=True,
                                         clip_weights=0.8)),
    "adadelta": ("adadelta", dict(wd=1e-2)),
    "ftrl": ("ftrl", dict(learning_rate=0.1, wd=1e-2, lamda1=0.05)),
    "adamax": ("adamax", dict(wd=1e-2)),
    "nadam": ("nadam", dict(wd=1e-2)),
    "ftml": ("ftml", dict(wd=1e-2)),
    "dcasgd": ("dcasgd", dict(learning_rate=0.1, momentum=0.9, wd=1e-2)),
    "lbsgd": ("lbsgd", dict(learning_rate=0.1, momentum=0.9, wd=1e-2,
                            warmup_epochs=1, updates_per_epoch=2,
                            batch_scale=2)),
    "test": ("test", dict(rescale_grad=0.5)),
}
W_SHAPES = ((6, 5), (7,))


def _opt_run(pkg, name, steps):
    """``steps`` updates of two weights through ``Updater``; the weights
    and states after each, as fp32 numpy."""
    kind, kwargs = OPTIMIZERS[name]
    opt = pkg.optimizer.create(kind, **kwargs)
    upd = pkg.optimizer.get_updater(opt)
    bf16 = kwargs.get("multi_precision", False)
    weights = [pkg.nd.array(_rand(s, 10 + i)) for i, s in
               enumerate(W_SHAPES)]
    if bf16:
        weights = [w.astype("bfloat16") for w in weights]
    snaps = []
    for t in range(steps):
        for i, w in enumerate(weights):
            g = pkg.nd.array(_rand(w.shape, 100 * t + i))
            if bf16:
                g = g.astype("bfloat16")
            upd(i, g, w)
        snaps.append(([w.astype("float32").asnumpy() for w in weights],
                      pickle.loads(upd.get_states())["states"]))
    return snaps


def _leaves(state):
    if state is None:
        return []
    if isinstance(state, tuple):
        return [x for s in state for x in _leaves(s)]
    return [np.asarray(state, F32)]


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizer_class_matches_jax(name):
    want = _opt_run(mx, name, 3)
    with CPU:
        got = _opt_run(tmx, name, 3)
    for (gw, gs), (ww, ws) in zip(got, want):
        for a, b in zip(gw, ww):
            _ulps(a, b)
        assert sorted(gs) == sorted(ws)
        for k in ws:
            la, lb = _leaves(gs[k]), _leaves(ws[k])
            assert len(la) == len(lb)
            for a, b in zip(la, lb):
                _ulps(a, b)


def test_sgld_noise_by_distribution():
    """SGLD: the deterministic part is the JAX formula; the noise, from
    the port's own generator, has the std sqrt(lr)."""
    with CPU:
        opt = tmx.optimizer.create("sgld", learning_rate=0.01, seed=3)
        w0 = _rand((200, 50), 1)
        g = _rand((200, 50), 2)
        w = tmx.nd.array(w0)
        opt.update(0, w, tmx.nd.array(g), None)
    noise = w.asnumpy() - (w0 - 0.01 / 2 * g)
    assert abs(noise.mean()) < 3 * 0.1 / 100
    assert abs(noise.std() - 0.1) < 0.005


def test_weight_keeps_its_leaf_and_object():
    with CPU:
        net = tmx.gluon.nn.Dense(3, in_units=4, prefix="d_")
        net.initialize(ctx=CPU)
        trainer = tmx.gluon.Trainer(net.collect_params(), "sgd",
                                    {"learning_rate": 0.1, "momentum": 0.9})
        data, leaf = net.weight.data(), net.weight.data()._data
        x = tmx.nd.array(_rand((2, 4), 1))
        for _ in range(2):
            with tmx.autograd.record():
                loss = (net(x) ** 2).sum()
            loss.backward()
            trainer.step(2)
        assert net.weight.data() is data and data._data is leaf
        assert leaf.requires_grad and leaf.is_leaf


def test_trainer_never_reaches_the_fused_kernels(monkeypatch):
    """The Trainer's SGD and Adam classes compute their own updates: no
    K2 wrapper runs during Trainer.step, as in the JAX package. On a CPU
    tensor a K2 wrapper runs its plain version, so the plain versions
    are watched (the ``nd.sgd_mom_update`` call shows the watch works)."""
    calls = []
    for name in ("sgd_mom_plain", "adam_plain"):
        real = getattr(fused_opt, name)

        def spy(*a, _real=real, _name=name, **k):
            calls.append(_name)
            return _real(*a, **k)
        monkeypatch.setattr(fused_opt, name, spy)
    with CPU:
        for kind, kw in (("sgd", {"momentum": 0.9}), ("adam", {})):
            net = tmx.gluon.nn.Dense(3, in_units=4, prefix="k_")
            net.initialize(ctx=CPU)
            trainer = tmx.gluon.Trainer(net.collect_params(), kind, kw)
            with tmx.autograd.record():
                loss = (net(tmx.nd.array(_rand((2, 4), 1))) ** 2).sum()
            loss.backward()
            trainer.step(2)
        assert calls == []
        w = net.weight.data()
        tmx.nd.sgd_mom_update(w, net.weight.grad(), tmx.nd.zeros(w.shape),
                              out=w, lr=0.1, momentum=0.9)
    assert calls == ["sgd_mom_plain"]


def _param_api(pkg):
    """Parameter / Block gradient surface: grad after a backward,
    zero_grad, the grad_req setter, set_data and cast keeping the
    gradient buffer, clip_global_norm on the gradients."""
    nn, nd, ag = pkg.gluon.nn, pkg.nd, pkg.autograd
    net = nn.Dense(3, in_units=4, prefix="p_")
    net.initialize()
    net.weight.set_data(nd.array(_rand((3, 4), 1)))
    net.bias.set_data(nd.array(_rand((3,), 2)))
    x = nd.array(_rand((5, 4), 3))

    def backward(data=x):
        with ag.record():
            loss = (net(data) ** 2).sum()
        loss.backward()
    out = []

    def snap(x):
        out.append(_np_of(x))    # now: later steps rebind the buffers
    backward()
    snap(net.weight.grad())
    snap(net.bias.list_grad()[0])
    net.zero_grad()
    snap(net.weight.grad())
    net.bias.grad_req = "null"
    backward()
    snap(net.weight.grad())
    net.bias.grad_req = "add"
    backward()
    backward()
    snap(net.bias.grad())
    net.weight.set_data(nd.array(_rand((3, 4), 4)))
    backward()
    snap(net.weight.grad())
    norm = pkg.gluon.utils.clip_global_norm(
        [net.weight.grad(), net.bias.grad()], 1.0)
    for v in (np.float32(norm), net.weight.grad(), net.bias.grad()):
        snap(v)
    net.collect_params().zero_grad()
    snap(net.bias.grad())
    net.cast("float16")
    backward(x.astype("float16"))
    snap(net.weight.grad().astype("float32"))
    return out


def _np_of(x):
    return x.asnumpy() if hasattr(x, "asnumpy") else np.asarray(x)


def test_parameter_gradient_surface_matches_jax():
    want = _param_api(mx)
    with CPU:
        got = _param_api(tmx)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape, (g.shape, w.shape)
        _scaled(g, w, 1e-3 if g.dtype == np.float16 else 1e-6)


def _trainer_api(pkg, tmp):
    nn, nd, ag = pkg.gluon.nn, pkg.nd, pkg.autograd
    net = nn.Dense(3, in_units=4, prefix="t_")
    net.initialize()
    net.weight.set_data(nd.array(_rand((3, 4), 1)))
    net.bias.set_data(nd.array(_rand((3,), 2)))
    trainer = pkg.gluon.Trainer(net.collect_params(), "adam",
                                {"learning_rate": 0.1, "wd": 0.01})
    x = nd.array(_rand((5, 4), 3))

    def step(how):
        with ag.record():
            loss = (net(x) ** 2).sum()
        loss.backward()
        if how == "step":
            trainer.step(5)
        else:
            trainer.allreduce_grads()
            trainer.update(5)
    step("step")
    trainer.set_learning_rate(0.05)
    step("update")
    trainer.save_states(tmp)
    step("step")
    after = [net.weight.data().asnumpy(), net.bias.data().asnumpy()]
    trainer.load_states(tmp)
    return after + [trainer.learning_rate,
                    pickle.loads(trainer._updaters.get_states())["states"]
                    [0][0]]


def test_trainer_api_matches_jax(tmp_path):
    want = _trainer_api(mx, str(tmp_path / "j.states"))
    with CPU:
        got = _trainer_api(tmx, str(tmp_path / "t.states"))
    for g, w in zip(got, want):
        _ulps(g, w)
    with CPU:
        net = tmx.gluon.nn.Dense(3, in_units=4, prefix="s_")
        net.initialize()
        trainer = tmx.gluon.Trainer(net.collect_params(), "sgd")
        trainer.step(1)     # no backward yet: zero gradients
        # outside a launched job a dist kvstore is a one-worker store
        # that updates in place, as the JAX package's is
        dist = tmx.gluon.Trainer(net.collect_params(), "sgd",
                                 kvstore="dist_sync")
        dist.step(1)
        assert dist._kvstore.num_workers == 1 and dist._update_on_kvstore
        late = tmx.gluon.nn.Dense(2, prefix="late_")
        late.initialize()   # deferred: no data yet
        trainer = tmx.gluon.Trainer(late.collect_params(), "sgd")
        with pytest.raises(tmx.MXNetError):
            trainer.step(1)
        trainer.step(1, ignore_stale_grad=True)


# -- lr schedulers -----------------------------------------------------------
SCHEDULERS = {
    "factor": ("FactorScheduler", dict(step=5, factor=0.5, base_lr=0.1,
                                       stop_factor_lr=0.01)),
    "factor_warmup": ("FactorScheduler", dict(step=3, factor=0.9,
                                              base_lr=0.1, warmup_steps=4,
                                              warmup_begin_lr=0.01)),
    "multifactor": ("MultiFactorScheduler", dict(step=[4, 9, 15],
                                                 factor=0.3, base_lr=1.0)),
    "poly": ("PolyScheduler", dict(max_update=30, base_lr=0.2, pwr=2,
                                   final_lr=0.01, warmup_steps=5,
                                   warmup_mode="constant",
                                   warmup_begin_lr=0.05)),
    "cosine": ("CosineScheduler", dict(max_update=25, base_lr=0.3,
                                       final_lr=0.001, warmup_steps=3)),
}


@pytest.mark.parametrize("name", sorted(SCHEDULERS))
def test_lr_scheduler_matches_jax_exactly(name):
    cls, kwargs = SCHEDULERS[name]
    j = getattr(mx.lr_scheduler, cls)(**kwargs)
    t = getattr(tmx.lr_scheduler, cls)(**kwargs)
    assert [t(n) for n in range(40)] == [j(n) for n in range(40)]
    with pytest.raises(ValueError):
        getattr(tmx.lr_scheduler, cls)(**dict(kwargs, warmup_mode="x"))


def test_optimizer_with_a_scheduler_matches_jax():
    def run(pkg):
        sched = pkg.lr_scheduler.FactorScheduler(step=2, factor=0.5)
        opt = pkg.optimizer.create("sgd", learning_rate=0.4,
                                   lr_scheduler=sched)
        w = pkg.nd.array(_rand((5,), 1))
        lrs = []
        for t in range(6):
            opt.update(0, w, pkg.nd.array(_rand((5,), t)), None)
            lrs.append(opt.learning_rate)
        return lrs, w.asnumpy()
    want = run(mx)
    with CPU:
        got = run(tmx)
    assert got[0] == want[0]
    _ulps(got[1], want[1])


# -- metrics -----------------------------------------------------------------
def _probs(seed, n=8, c=4):
    return _softmax(_rand((n, c), seed))


BATCHES = [
    (np.array([0, 1, 3, 2, 1, 0, 3, 3], F32), _probs(1)),
    (np.array([2, 1, 0, 0, 3, 1, 2, 2], F32), _probs(2)),
]
BINARY = [
    (np.array([0, 1, 1, 0, 1, 0, 1, 1], F32), _probs(3, c=2)),
    (np.array([1, 1, 0, 0, 0, 1, 1, 0], F32), _probs(4, c=2)),
]
REGRESSION = [(_rand((8,), 5), _rand((8,), 6)),
              (_rand((8, 1), 7), _rand((8, 1), 8))]
METRICS = {
    "acc": (lambda m: m.create("acc"), BATCHES),
    "top_k": (lambda m: m.TopKAccuracy(top_k=2), BATCHES),
    "f1_macro": (lambda m: m.F1(), BINARY),
    "f1_micro": (lambda m: m.F1(average="micro"), BINARY),
    "mcc_macro": (lambda m: m.MCC(), BINARY),
    "mcc_micro": (lambda m: m.MCC(average="micro"), BINARY),
    "mae": (lambda m: m.MAE(), REGRESSION),
    "mse": (lambda m: m.MSE(), REGRESSION),
    "rmse": (lambda m: m.RMSE(), REGRESSION),
    "ce": (lambda m: m.create("ce"), BATCHES),
    "nll": (lambda m: m.NegativeLogLikelihood(), BATCHES),
    "perplexity": (lambda m: m.Perplexity(ignore_label=3), BATCHES),
    "pearson": (lambda m: m.PearsonCorrelation(), REGRESSION),
    "loss": (lambda m: m.Loss(), REGRESSION),
    "custom": (lambda m: m.CustomMetric(
        lambda lab, pred: float(np.abs(lab.ravel() - pred.ravel()).sum()),
        name="l1sum"), REGRESSION),
    "np_metric": (lambda m: m.np_metric(name="mean_pred")(
        lambda lab, pred: (float(pred.sum()), pred.size)), REGRESSION),
    "composite": (lambda m: m.create(["acc", "ce"]), BATCHES),
}


def _metric_run(pkg, name):
    build, batches = METRICS[name]
    metric = build(pkg.metric)
    out = []
    for i, (label, pred) in enumerate(batches):
        metric.update([pkg.nd.array(label)], [pkg.nd.array(pred)])
        out.append((metric.get(), metric.get_global()))
        if i == 0:
            metric.reset_local()
    metric.reset()
    out.append(metric.get())
    return out


@pytest.mark.parametrize("name", sorted(METRICS))
def test_metric_matches_jax(name):
    want = _metric_run(mx, name)
    with CPU:
        got = _metric_run(tmx, name)

    def flat(x):
        if isinstance(x, (tuple, list)):
            return [y for v in x for y in flat(v)]
        return [x]
    fg, fw = flat(got), flat(want)
    assert len(fg) == len(fw)
    for a, b in zip(fg, fw):
        if isinstance(b, str):
            assert a == b
        elif np.isnan(b):
            assert np.isnan(a)
        else:
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)


# -- Updater states ----------------------------------------------------------
def test_updater_states_round_trip_and_carry_over_from_jax(tmp_path):
    """get_states / set_states in the port continue exactly where they
    stopped; the JAX package's states (fp32 masters of bf16 weights
    included) carried over continue the JAX run."""
    kw = dict(learning_rate=0.1, momentum=0.9, wd=1e-3,
              multi_precision=True)
    w0 = _rand((6, 5), 1)
    g = [_rand((6, 5), 10 + t) for t in range(3)]

    def two(pkg, upd, w):
        for t in range(2):
            gr = pkg.nd.array(g[t]).astype("bfloat16")
            upd(0, gr, w)

    jopt = mx.optimizer.create("sgd", **kw)
    jupd = mx.optimizer.get_updater(jopt)
    jw = mx.nd.array(w0).astype("bfloat16")
    two(mx, jupd, jw)
    jupd(0, mx.nd.array(g[2]).astype("bfloat16"), jw)
    with CPU:
        # round trip: save after two updates, load into a fresh updater
        opt = tmx.optimizer.create("sgd", **kw)
        upd = tmx.optimizer.get_updater(opt)
        w = tmx.nd.array(w0).astype("bfloat16")
        two(tmx, upd, w)
        fname = str(tmp_path / "opt.states")
        with open(fname, "wb") as f:
            f.write(upd.get_states())
        upd2 = tmx.optimizer.get_updater(tmx.optimizer.create("sgd", **kw))
        with open(fname, "rb") as f:
            upd2.set_states(f.read())
        w2 = w.copy()
        for u, ww in ((upd, w), (upd2, w2)):
            u(0, tmx.nd.array(g[2]).astype("bfloat16"), ww)
        np.testing.assert_array_equal(w.astype("float32").asnumpy(),
                                      w2.astype("float32").asnumpy())
        # carried over from the JAX package after its two updates
        jopt3 = mx.optimizer.create("sgd", **kw)
        jupd3 = mx.optimizer.get_updater(jopt3)
        jw3 = mx.nd.array(w0).astype("bfloat16")
        two(mx, jupd3, jw3)
        upd3 = tmx.optimizer.get_updater(tmx.optimizer.create("sgd", **kw))
        upd3.states = updater_states_from_jax(jupd3)
        w3 = tmx.nd.array(jw3.astype("float32").asnumpy()).astype(
            "bfloat16")
        upd3(0, tmx.nd.array(g[2]).astype("bfloat16"), w3)
    _ulps(w3.astype("float32").asnumpy(), jw.astype("float32").asnumpy())
    master = upd3.states[0][0].asnumpy()
    _ulps(master, jupd.states[0][0].asnumpy())


# -- update ops --------------------------------------------------------------
N = 4099


def _arr(seed, pos=False, dtype=F32):
    a = _rand((N,), seed)
    return (np.abs(a) + 0.01 if pos else a).astype(dtype)


UPDATE_OPS = {
    "mp_sgd_update": (lambda: [_arr(1, dtype=np.float16),
                               _arr(2, dtype=np.float16), _arr(1)],
                      dict(lr=0.1, wd=1e-3, rescale_grad=1 / 32)),
    "mp_sgd_update_clip": (lambda: [_arr(1, dtype=np.float16),
                                    _arr(2, dtype=np.float16), _arr(1)],
                           dict(lr=0.05, clip_gradient=0.5)),
    "mp_sgd_mom_update": (lambda: [_arr(1, dtype=np.float16),
                                   _arr(2, dtype=np.float16), _arr(3),
                                   _arr(1)],
                          dict(lr=0.1, momentum=0.9, wd=1e-3,
                               rescale_grad=1 / 32)),
    "signsgd_update": (lambda: [_arr(1), _arr(2)], dict(lr=0.1, wd=1e-3)),
    "signum_update": (lambda: [_arr(1), _arr(2), _arr(3)],
                      dict(lr=0.1, momentum=0.9, wd=0.3,
                           rescale_grad=1 / 32, wd_lh=0.01)),
    "signum_update_clip": (lambda: [_arr(1), _arr(2), _arr(3)],
                           dict(lr=0.05, momentum=0.5, clip_gradient=0.5)),
    "ftml_update": (lambda: [_arr(1), _arr(2), _arr(3, True),
                             _arr(4, True), _arr(5)],
                    dict(lr=0.01, t=3, wd=0.3, rescale_grad=1 / 32)),
    "ftml_update_clip": (lambda: [_arr(1), _arr(2), _arr(3, True),
                                  _arr(4, True), _arr(5)],
                         dict(lr=0.02, t=1, clip_grad=0.5)),
    "ftrl_update": (lambda: [_arr(1), _arr(2), _arr(3), _arr(4, True)],
                    dict(lr=0.3, lamda1=0.1, wd=0.3, rescale_grad=0.7)),
    "ftrl_update_clip": (lambda: [_arr(1), _arr(2), _arr(3),
                                  _arr(4, True)],
                         dict(lr=0.05, lamda1=0.5, clip_gradient=0.5)),
    "rmsprop_update": (lambda: [_arr(1), _arr(2), _arr(3, True)],
                       dict(lr=0.02, wd=0.3, rescale_grad=1 / 32)),
    "rmsprop_update_clip": (lambda: [_arr(1), _arr(2), _arr(3, True)],
                            dict(lr=0.02, gamma1=0.9, clip_gradient=0.5,
                                 clip_weights=1.0)),
    "rmspropalex_update": (lambda: [_arr(1), _arr(2), 20 + _arr(3, True),
                                    _arr(4) * 0.5, _arr(5)],
                           dict(lr=0.02, wd=0.3)),
    "rmspropalex_update_rescaled": (lambda: [_arr(1), _arr(2),
                                             20 + _arr(3, True),
                                             _arr(4) * 0.5, _arr(5)],
                                    dict(lr=0.01, wd=1e-3,
                                         rescale_grad=1 / 32)),
}
# outputs held to 2 ulp instead of bitwise (see the module docstring)
NEAR = {"rmsprop_update": (0,), "rmspropalex_update": (0, 3)}


@pytest.mark.parametrize("case", sorted(UPDATE_OPS))
def test_update_op_matches_jax(case):
    import jax.numpy as jnp
    name = case.replace("_clip", "").replace("_rescaled", "")
    make, hp = UPDATE_OPS[case]
    ins = make()
    want = jreg.get(name)(*[jnp.asarray(a) for a in ins], **hp)
    got = treg.get(name)(*[torch.from_numpy(a.copy()) for a in ins], **hp)
    want = want if isinstance(want, (tuple, list)) else [want]
    got = got if isinstance(got, (tuple, list)) else [got]
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        w = np.asarray(w)
        g = g.numpy()
        assert g.dtype == w.dtype, (i, g.dtype, w.dtype)
        if i in NEAR.get(name, ()):
            _ulps(g, w)
        else:
            np.testing.assert_array_equal(g, w)


# -- gluon resnet18: Trainer steps, each from the JAX state ------------------
R18 = (4, 3, 64, 64)
STEPS = 3
SGD = {"learning_rate": 0.05, "momentum": 0.9, "wd": 1e-4}
PREFIX = "resnetv10_"


def _jax_snapshot(net, trainer, out, loss):
    return {"out": out.asnumpy(), "loss": loss.asnumpy(),
            "params": {n: p.data().asnumpy()
                       for n, p in net.collect_params().items()},
            "states": updater_states_from_jax(trainer._updaters),
            "counts": dict(trainer._optimizer._index_update_count)}


@pytest.fixture(scope="module")
def r18_gluon():
    from mxnet_tpu.gluon.block import infer_shapes as j_infer_shapes
    from mxnet_tpu.gluon.model_zoo import vision as jvision
    from mxnet_tpu_torch.gluon.block import infer_shapes
    from mxnet_tpu_torch.gluon.model_zoo import vision as tvision
    rng = np.random.default_rng(31)
    jnet = jvision.resnet18_v1(prefix=PREFIX)
    jnet.initialize()
    # the parameters' shapes from one abstract pass: every value is set
    # below, so no eager forward needs to compile for it
    j_infer_shapes(jnet, (1,) + R18[1:])
    weights = {}
    for name, p in jnet.collect_params().items():
        if name.endswith("gamma"):
            v = rng.uniform(0.5, 1.5, p.shape)
        elif name.endswith("beta"):
            v = rng.uniform(-0.2, 0.2, p.shape)
        elif name.endswith("running_mean"):
            v = rng.uniform(-0.1, 0.1, p.shape)
        elif name.endswith("running_var"):
            v = rng.uniform(0.5, 2.0, p.shape)
        else:
            v = rng.standard_normal(p.shape) * np.sqrt(
                2.0 / np.prod(p.shape[1:]))
        weights[name] = v.astype(F32)
        p.set_data(mx.nd.array(weights[name]))
    jnet.hybridize()        # one jitted training step (bench.py's path)
    x = rng.standard_normal(R18).astype(F32)
    y = rng.integers(0, 1000, R18[0]).astype(F32)
    jloss = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    jtrainer = mx.gluon.Trainer(jnet.collect_params(), "sgd", dict(SGD))
    jax_steps = []
    for _ in range(STEPS):
        with mx.autograd.record():
            out = jnet(mx.nd.array(x))
            loss = jloss(out, mx.nd.array(y))
        loss.backward()
        jtrainer.step(R18[0])
        jax_steps.append(_jax_snapshot(jnet, jtrainer, out, loss))

    tnet = tvision.resnet18_v1(prefix=PREFIX)
    tnet.initialize(tmx.initializer.Zero(), ctx=CPU)
    infer_shapes(tnet, (1,) + R18[1:])
    tnet.hybridize()
    tloss = tmx.gluon.loss.SoftmaxCrossEntropyLoss()
    ttrainer = tmx.gluon.Trainer(tnet.collect_params(), "sgd", dict(SGD))
    port_steps = []
    with CPU:
        for t in range(STEPS):
            if t == 0:
                params_from_jax(tnet, weights, ctx=CPU)
            else:
                prev = jax_steps[t - 1]
                params_from_jax(tnet, prev["params"], ctx=CPU)
                ttrainer._updaters.states = dict(prev["states"])
                ttrainer._optimizer._index_update_count = dict(
                    prev["counts"])
            with tmx.autograd.record():
                out = tnet(tmx.nd.array(x))
                loss = tloss(out, tmx.nd.array(y))
            loss.backward()
            ttrainer.step(R18[0])
            port_steps.append({
                "out": out.asnumpy(), "loss": loss.asnumpy(),
                "params": {n: p.data().asnumpy()
                           for n, p in tnet.collect_params().items()},
                "states": {k: s.asnumpy() for k, s in
                           ttrainer._updaters.states.items()}})
    names = list(jnet.collect_params().keys())
    assert names == list(tnet.collect_params().keys())
    return jax_steps, port_steps, names


def test_resnet18_trainer_steps_match_jax(r18_gluon):
    jax_steps, port_steps, names = r18_gluon
    assert jax_steps[-1]["loss"].mean() < jax_steps[0]["loss"].mean()
    for j, t in zip(jax_steps, port_steps):
        _scaled(t["out"], j["out"], 1e-4)
        delta = 1e-4 * np.abs(j["out"]).max()
        # a row's loss moves by at most twice a logit's error
        np.testing.assert_allclose(t["loss"], j["loss"], rtol=1e-5,
                                   atol=2 * delta)
        for i, n in enumerate(names):
            _scaled(t["params"][n], j["params"][n], 1e-4)
            if i in j["states"] and j["states"][i] is not None:
                _scaled(t["states"][i], j["states"][i], 1e-3)
