"""The port's Module API (mxnet_tpu_torch.module), FeedForward and the
training callbacks against the JAX package in one process, on the CPU:
``train_mnist.py``'s MLP and LeNet step by step (each of the port's
steps from the JAX state of the step before: parameters and SGD
momenta through numpy), ``predict`` / ``score``, checkpoints and
optimizer-state files written by either package and loaded by the
other, ``BucketingModule`` and ``SequentialModule`` on one small case
each, ``FeedForward`` and the callbacks. Batches come from
``test_utils``' offline MNIST."""
import torch_test_env  # noqa: F401  (first: one torch thread a process)

import logging

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.base import MXNetError

BATCH = 8
STEPS = 2
SGD = dict(learning_rate=0.1, momentum=0.9, wd=1e-4)


def _mlp(sym):
    """examples/image-classification/train_mnist.py:21-29"""
    data = sym.var("data")
    data = sym.Flatten(data)
    fc1 = sym.FullyConnected(data, name="fc1", num_hidden=128)
    act1 = sym.Activation(fc1, act_type="relu")
    fc2 = sym.FullyConnected(act1, name="fc2", num_hidden=64)
    act2 = sym.Activation(fc2, act_type="relu")
    fc3 = sym.FullyConnected(act2, name="fc3", num_hidden=10)
    return sym.SoftmaxOutput(fc3, name="softmax")


def _lenet(sym):
    """examples/image-classification/train_mnist.py:31-45"""
    data = sym.var("data")
    c1 = sym.Convolution(data, name="conv1", kernel=(5, 5), num_filter=20)
    a1 = sym.Activation(c1, act_type="tanh")
    p1 = sym.Pooling(a1, pool_type="max", kernel=(2, 2), stride=(2, 2))
    c2 = sym.Convolution(p1, name="conv2", kernel=(5, 5), num_filter=50)
    a2 = sym.Activation(c2, act_type="tanh")
    p2 = sym.Pooling(a2, pool_type="max", kernel=(2, 2), stride=(2, 2))
    fl = sym.Flatten(p2)
    f1 = sym.FullyConnected(fl, name="fc1", num_hidden=500)
    a3 = sym.Activation(f1, act_type="tanh")
    f2 = sym.FullyConnected(a3, name="fc2", num_hidden=10)
    return sym.SoftmaxOutput(f2, name="softmax")


NETS = {"mlp": _mlp, "lenet": _lenet}


@pytest.fixture(autouse=True, scope="module")
def _jax_health_off():
    """The JAX package's numerics sentinel (its health plane, which the
    port has not yet) compiles a check per step; it changes no value."""
    from mxnet_tpu.profiling import health
    was = health.policy()
    health.set_enabled(False)
    yield
    health.set_enabled(was or "0")


def _mnist(n, seed):
    x, y = tmx.test_utils._synthetic_mnist(n, seed)
    return x, y


def _batches(n_batches, seed):
    x, y = _mnist(n_batches * BATCH, seed)
    return [(x[i:i + BATCH], y[i:i + BATCH])
            for i in range(0, len(x), BATCH)]


def _jbatch(x, y):
    return mx.io.DataBatch(data=[mx.nd.array(x)], label=[mx.nd.array(y)])


def _tbatch(x, y):
    cpu = tmx.cpu()
    return tmx.io.DataBatch(data=[tmx.nd.array(x, ctx=cpu)],
                            label=[tmx.nd.array(y, ctx=cpu)])


def _np(d):
    return {k: v.asnumpy() for k, v in d.items()}


def _close_scaled(got, want, rel):
    """Within ``rel`` of the largest value of ``want`` (weights after
    one update: 1e-4; momenta, sums of nearly equal gradients: 1e-3), as
    tests/test_torch_train.py holds resnet18's steps."""
    scale = max(float(np.abs(want).max()), 1e-12)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale)


def _bound_pair(net, optimizer="sgd", params=SGD, seed=0):
    """A JAX and a port Module of ``net`` bound for training at BATCH,
    the port's parameters the JAX package's Xavier draw."""
    shapes = ([("data", (BATCH, 1, 28, 28))], [("softmax_label", (BATCH,))])
    jmod = mx.mod.Module(NETS[net](mx.sym))
    jmod.bind(*shapes)
    np.random.seed(seed)
    jmod.init_params(mx.init.Xavier(magnitude=2.0))
    jmod.init_optimizer(optimizer=optimizer, optimizer_params=dict(params))
    tmod = tmx.mod.Module(NETS[net](tmx.sym), context=tmx.cpu())
    tmod.bind(*shapes)
    arg, aux = jmod.get_params()
    tmod.init_params(None, arg_params=_np(arg), aux_params=_np(aux))
    tmod.init_optimizer(optimizer=optimizer, optimizer_params=dict(params))
    return jmod, tmod


def _sync(jmod, tmod):
    """The port module's parameters and optimizer states set to the JAX
    module's."""
    arg, aux = jmod.get_params()
    tmod.set_params(_np(arg), _np(aux))
    for i, js in jmod._opt_states.items():
        ts = tmod._opt_states[i]
        if js is not None:
            ts._data.copy_(torch.from_numpy(np.array(js.asnumpy())))


@pytest.fixture(scope="module")
def lenet_pair():
    """LeNet in both packages, the port's parameters and momenta the
    JAX package's after one SGD step."""
    jmod, tmod = _bound_pair("lenet", seed=1)
    (x, y), = _batches(1, seed=4)
    jmod.forward_backward(_jbatch(x, y))
    jmod.update()
    _sync(jmod, tmod)
    return jmod, tmod


@pytest.mark.parametrize("net", ["mlp", "lenet"])
def test_module_steps_match_jax(net, request):
    """``forward_backward`` + ``update`` with SGD momentum at batch 8, step
    by step, each of the port's from the JAX parameters and momenta
    before it: outputs and gradients to the executor's bound (rtol 1e-4,
    atol 1e-5), parameters to 1e-4 and momenta to 1e-3 of their scale."""
    jmod, tmod = _bound_pair(net) if net == "mlp" \
        else request.getfixturevalue("lenet_pair")
    names = tmod._param_names
    assert names == jmod._param_names
    for x, y in _batches(STEPS, seed=3):
        _sync(jmod, tmod)
        jmod.forward_backward(_jbatch(x, y))
        tmod.forward_backward(_tbatch(x, y))
        np.testing.assert_allclose(tmod.get_outputs()[0].asnumpy(),
                                   jmod.get_outputs()[0].asnumpy(),
                                   rtol=1e-4, atol=1e-5)
        for n in names:
            np.testing.assert_allclose(
                tmod._exec.grad_dict[n].asnumpy(),
                jmod._exec.grad_dict[n].asnumpy(), rtol=1e-4, atol=1e-5,
                err_msg=n)
        jmod.update()
        tmod.update()
        targ, _ = tmod.get_params()
        jarg, _ = jmod.get_params()
        for i, n in enumerate(names):
            _close_scaled(targ[n].asnumpy(), jarg[n].asnumpy(), 1e-4)
            _close_scaled(tmod._opt_states[i].asnumpy(),
                          jmod._opt_states[i].asnumpy(), 1e-3)


def test_predict_and_score_match_jax(lenet_pair):
    """Over 20 images at batch 8 (the last batch padded by 4): the padded
    rows are dropped, the outputs concatenated, the accuracy equal."""
    jmod, tmod = lenet_pair
    _sync(jmod, tmod)
    x, y = _mnist(20, seed=5)
    jit = mx.io.NDArrayIter(x, y, batch_size=BATCH)
    with tmx.cpu():
        tit = tmx.io.NDArrayIter(x, y, batch_size=BATCH)
        got = tmod.predict(tit)
        score = tmod.score(tit, "acc")
        rows = [outs[0].shape[0] for outs, _, _ in tmod.iter_predict(tit)]
    want = jmod.predict(jit).asnumpy()
    assert got.shape == want.shape == (20, 10) and rows == [8, 8, 4]
    np.testing.assert_allclose(got.asnumpy(), want, rtol=1e-4, atol=1e-5)
    assert score == jmod.score(jit, "acc")


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_and_optimizer_states_cross(lenet_pair, tmp_path, writer):
    """``save_checkpoint(..., save_optimizer_states=True)`` in one package,
    ``Module.load(..., load_optimizer_states=True)`` and bind in the
    other: the same symbol, parameters and momenta, bit for bit (the
    states file passes the reader's manifest CRC check)."""
    jmod, tmod = lenet_pair
    _sync(jmod, tmod)
    prefix = str(tmp_path / "lenet")
    shapes = ([("data", (BATCH, 1, 28, 28))], [("softmax_label", (BATCH,))])
    if writer == "jax":
        jmod.save_checkpoint(prefix, 3, save_optimizer_states=True)
        loaded = tmx.mod.Module.load(prefix, 3, load_optimizer_states=True,
                                     context=tmx.cpu())
    else:
        tmod.save_checkpoint(prefix, 3, save_optimizer_states=True)
        loaded = mx.mod.Module.load(prefix, 3, load_optimizer_states=True)
    src = tmod if writer == "jax" else jmod
    loaded.bind(*shapes)
    loaded.init_optimizer(optimizer="sgd", optimizer_params=dict(SGD))
    assert loaded.symbol.list_arguments() == src.symbol.list_arguments()
    arg, _ = loaded.get_params()
    want, _ = src.get_params()
    assert set(arg) == set(want)
    for n in want:
        np.testing.assert_array_equal(arg[n].asnumpy(), want[n].asnumpy())
    for i, s in src._opt_states.items():
        np.testing.assert_array_equal(loaded._opt_states[i].asnumpy(),
                                      s.asnumpy())


def _bucket_sym(sym):
    def sym_gen(rows):
        data = sym.var("data")
        fc = sym.FullyConnected(data, name="fc", num_hidden=4)
        return (sym.SoftmaxOutput(fc, name="softmax"), ["data"],
                ["softmax_label"])
    return sym_gen


def _sequential(pkg):
    net1 = pkg.sym.Activation(pkg.sym.FullyConnected(
        pkg.sym.var("data"), name="fc1", num_hidden=16), act_type="relu")
    net2 = pkg.sym.SoftmaxOutput(pkg.sym.FullyConnected(
        pkg.sym.var("data"), name="fc2", num_hidden=4), name="softmax")
    kw = {} if pkg is mx else {"context": tmx.cpu()}
    seq = pkg.mod.SequentialModule()
    # the JAX SequentialModule reads auto_wiring from the module whose
    # outputs are wired (the reference: from the module they feed)
    seq.add(pkg.mod.Module(net1, label_names=[], **kw), auto_wiring=True)
    seq.add(pkg.mod.Module(net2, **kw), take_labels=True)
    return seq


def _bucketing(pkg):
    kw = {} if pkg is mx else {"context": tmx.cpu()}
    return pkg.mod.BucketingModule(_bucket_sym(pkg.sym),
                                   default_bucket_key=4, **kw)


@pytest.mark.parametrize("kind", ["bucketing", "sequential"])
def test_bucketing_and_sequential_modules_match_jax(kind):
    """A BucketingModule over batches of 4 and 6 rows (two executors
    sharing one parameter set and one optimizer) and a two-module
    SequentialModule (auto-wired, labels to the second), three SGD
    steps each from the same initial parameters: every parameter after
    every step to 1e-4 of its scale."""
    rng = np.random.default_rng(9)
    build = _bucketing if kind == "bucketing" else _sequential
    jm, tm = build(mx), build(tmx)
    shapes = ([("data", (4, 8))], [("softmax_label", (4,))])
    jm.bind(*shapes)
    tm.bind(*shapes)
    np.random.seed(2)
    jm.init_params(initializer=mx.init.Uniform(0.1))
    arg, aux = jm.get_params()
    tm.init_params(initializer=None, arg_params=_np(arg),
                   aux_params=_np(aux))
    for m in (jm, tm):
        m.init_optimizer(optimizer="sgd",
                         optimizer_params=dict(SGD, rescale_grad=0.25))
    for rows in ((4, 6, 4) if kind == "bucketing" else (4, 4, 4)):
        x = rng.standard_normal((rows, 8)).astype(np.float32)
        y = rng.integers(0, 4, rows).astype(np.float32)
        for pkg, m in ((mx, jm), (tmx, tm)):
            io = pkg.io
            kw = {} if pkg is mx else {"ctx": tmx.cpu()}
            batch = io.DataBatch(
                data=[pkg.nd.array(x, **kw)], label=[pkg.nd.array(y, **kw)],
                bucket_key=rows,
                provide_data=[io.DataDesc("data", (rows, 8))],
                provide_label=[io.DataDesc("softmax_label", (rows,))])
            m.forward_backward(batch)
            m.update()
        targ, _ = tm.get_params()
        jarg, _ = jm.get_params()
        assert set(targ) == set(jarg)
        for n in jarg:
            _close_scaled(targ[n].asnumpy(), jarg[n].asnumpy(), 1e-4)
    if kind == "bucketing":
        assert sorted(tm._buckets) == [4, 6]
        shared = [b._exec.arg_dict["fc_weight"] for b in
                  tm._buckets.values()]
        assert shared[0] is shared[1]


def test_feedforward_matches_jax(tmp_path):
    """``FeedForward.create`` of the MLP for one epoch (SGD, both from
    the same parameters, shuffled with numpy's global stream from one
    seed), then ``predict``, ``score``, ``save`` and ``load`` across the
    packages."""
    x, y = _mnist(48, seed=6)
    np.random.seed(3)
    jnet = mx.sym
    jmod = mx.mod.Module(_mlp(jnet))
    jmod.bind([("data", (16, 1, 28, 28))], [("softmax_label", (16,))])
    jmod.init_params(mx.init.Xavier(magnitude=2.0))
    arg, aux = (_np(d) for d in jmod.get_params())
    kw = dict(num_epoch=1, numpy_batch_size=16, learning_rate=0.1)
    np.random.seed(4)
    jff = mx.model.FeedForward.create(
        _mlp(mx.sym), x, y, arg_params={k: mx.nd.array(v)
                                        for k, v in arg.items()},
        aux_params={}, **kw)
    np.random.seed(4)
    with tmx.cpu():
        tff = tmx.model.FeedForward.create(
            _mlp(tmx.sym), x, y, ctx=tmx.cpu(), arg_params=dict(arg),
            aux_params={}, **kw)
        got = tff.predict(x)
        acc = tff.score(x, eval_metric="acc")
    want = jff.predict(x)
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4)
    assert acc == pytest.approx(jff.score(x, eval_metric="acc"))
    prefix = str(tmp_path / "ff")
    tff.save(prefix, 1)
    back = mx.model.FeedForward.load(prefix, 1)
    np.testing.assert_allclose(back.predict(x), got, rtol=1e-5, atol=1e-6)


def test_callbacks_write_what_jax_reads_and_log(tmp_path, caplog):
    """``do_checkpoint`` and ``module_checkpoint`` write files the JAX
    package loads; ``Speedometer`` and ``log_train_metric`` log through
    ``logging``; ``ProgressBar`` draws."""
    net = _mlp(tmx.sym)
    mod = tmx.mod.Module(net, context=tmx.cpu())
    mod.bind([("data", (4, 1, 28, 28))], [("softmax_label", (4,))])
    mod.init_params(tmx.initializer.Xavier(magnitude=2.0))
    mod.init_optimizer(optimizer="sgd", optimizer_params=dict(SGD))
    arg, aux = mod.get_params()
    prefix = str(tmp_path / "cb")
    tmx.callback.do_checkpoint(prefix)(0, net, arg, aux)
    tmx.callback.module_checkpoint(mod, prefix + "m",
                                   save_optimizer_states=True)(1)
    for pre, epoch in ((prefix, 1), (prefix + "m", 2)):
        sym, jarg, _ = mx.model.load_checkpoint(pre, epoch)
        assert sym.list_arguments() == net.list_arguments()
        for n, v in arg.items():
            np.testing.assert_array_equal(jarg[n].asnumpy(), v.asnumpy())
    metric = tmx.metric.create("acc")
    metric.update([tmx.nd.array(np.zeros(4, np.float32), ctx=tmx.cpu())],
                  [tmx.nd.array(np.eye(4, 10, dtype=np.float32),
                                ctx=tmx.cpu())])
    speed = tmx.callback.Speedometer(4, frequent=2)
    log = tmx.callback.log_train_metric(2)
    bar = tmx.callback.ProgressBar(4)
    with caplog.at_level(logging.INFO):
        for nbatch in range(5):
            p = tmx.model.BatchEndParam(epoch=0, nbatch=nbatch,
                                        eval_metric=metric, locals={})
            speed(p)
            log(p)
            bar(p)
    text = caplog.text
    assert "samples/sec" in text and "accuracy=" in text
    assert "Train-accuracy" in text and "[====" in text


def test_module_binds_one_device_and_refuses_what_waits(caplog):
    """A context list of distinct contexts binds a dp mesh (``cpu(0)``
    and ``cpu(1)``: two positions on the CPU), one that repeats a
    context binds its device with the JAX package's warning, absent
    cards raise, and ``install_monitor`` installs a plain callback on the
    dp executor (``test_torch_profiler.py`` holds the Monitor's stats to
    the JAX package's)."""
    net = _mlp(tmx.sym)
    shapes = ([("data", (4, 784))], [("softmax_label", (4,))])
    mod = tmx.mod.Module(net, context=[tmx.cpu(0), tmx.cpu(1)])
    mod.bind(*shapes)
    assert mod._device == torch.device("cpu")
    assert mod._exec._mesh.shape == {"dp": 2}
    assert str(mod._exec._arg_specs["data"]) == "PartitionSpec('dp')"
    def tap(*a):
        return None
    mod.install_monitor(tap)
    assert mod._exec._monitor is tap
    with caplog.at_level(logging.WARNING):
        one = tmx.mod.Module(net, context=[tmx.cpu(0), tmx.cpu(0)])
        one.bind(*shapes)
    assert one._exec._mesh is None and one._device == torch.device("cpu")
    assert "does not map to distinct devices" in caplog.text
    with pytest.raises(MXNetError, match="CUDA is not available"):
        tmx.mod.Module(net, context=[tmx.gpu(0), tmx.gpu(1)]).bind(*shapes)
    mod.init_params()
    mod.init_optimizer(kvstore="device")
    assert mod._kvstore_type == "device"
    assert mod.output_shapes == [("softmax_output", (4, 10))]
