"""The port's data parallelism over a dp mesh held to the JAX package on
the CPU (counterpart of ``tests/test_data_parallel.py``), the port's
mesh naming the CPU once a position (``cpu(0)`` ... ``cpu(7)``, the
counterpart of the JAX package's eight virtual CPU devices):

- ``context.dp_mesh``'s rule (distinct contexts are positions; a
  repeated one gives None; absent cards raise);
- gluon: ``split_and_load`` over a dp mesh returns the whole batch in a
  one-element list, so the JAX test's loop runs one forward and one
  backward (``test_gluon_trainer_multi_device_matches_single`` and
  ``test_split_and_load_shards_over_mesh``, their values and bounds:
  rtol 2e-4 / atol 2e-5); before the repair the port returned eight
  slices, each backward overwrote the last, and the trained weights
  differed;
- ``Module`` over eight contexts against the JAX Module over
  ``tpu(0..7)`` (the JAX test's MLP, 3 epochs, rtol 2e-4 / atol 2e-5),
  and a conv + BatchNorm net's gradients and moving statistics over
  the whole batch, against the JAX package's dp Module; a batch that
  does not divide raises the JAX package's message;
- ``simple_bind(mesh=, arg_specs=)`` directly, fed a ``Sharded`` batch,
  against the one-device executor;
- sharded input: ``to_device``, ``DeviceFeeder``, ``PrefetchingIter``
  and ``DataLoader`` with ``sharding=`` give the JAX package's values
  and blocks bit for bit, and a Module fed so trains as one fed host
  batches."""
import torch_test_env  # noqa: F401  (first: one torch thread a process)

import logging

import numpy as np
import pytest
from jax.sharding import NamedSharding as JNamedSharding
from jax.sharding import PartitionSpec as JP

import mxnet_tpu as mx
import mxnet_tpu_torch as tmx
from mxnet_tpu import parallel as jpar
from mxnet_tpu.io import pipeline as jpipe
from mxnet_tpu_torch import parallel as par
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.io import pipeline as tpipe
from mxnet_tpu_torch.parallel.mesh import PartitionSpec as P

RTOL, ATOL = 2e-4, 2e-5
CPU = tmx.cpu()
DP = 8


def _ctxs(pkg, n=DP):
    return [pkg.cpu(i) for i in range(n)] if pkg is tmx \
        else [pkg.tpu(i) for i in range(n)]


def _mlp_sym(pkg, num_hidden=16, num_classes=4):
    data = pkg.sym.var("data")
    fc1 = pkg.sym.FullyConnected(data, name="fc1", num_hidden=num_hidden)
    act = pkg.sym.Activation(fc1, act_type="relu")
    fc2 = pkg.sym.FullyConnected(act, name="fc2", num_hidden=num_classes)
    return pkg.sym.SoftmaxOutput(fc2, name="softmax")


def _bn_sym(pkg):
    """Convolution, BatchNorm over the batch, pooling and a dense head,
    the loss normalized by the batch size."""
    s = pkg.sym
    h = s.Convolution(s.var("data"), name="conv", num_filter=4,
                      kernel=(3, 3), pad=(1, 1))
    h = s.Activation(s.BatchNorm(h, name="bn", fix_gamma=False),
                     act_type="relu")
    h = s.Pooling(h, pool_type="max", kernel=(2, 2), stride=(2, 2))
    h = s.FullyConnected(s.Flatten(h), name="fc", num_hidden=4)
    return s.SoftmaxOutput(h, name="softmax", normalization="batch")


def _toy_data(n=256, dim=8, classes=4, seed=0):
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(dim, classes)).astype("float32")
    x = rng.normal(size=(n, dim)).astype("float32")
    y = (x @ w).argmax(axis=1).astype("float32")
    return x, y


def _init(pkg, mod, seed=7):
    """The JAX test's deterministic parameters (``_init_deterministic``)."""
    mod.init_params(initializer=pkg.initializer.Zero())
    arg_p, aux_p = mod.get_params()
    rng = np.random.default_rng(seed)
    arg_p = {k: pkg.nd.array(
        rng.normal(scale=0.1, size=v.shape).astype("float32"))
        for k, v in sorted(arg_p.items())}
    mod.set_params(arg_p, aux_p)


def _fit(pkg, ctx, x, y, epochs=3, sym=_mlp_sym, it=None):
    it = it or pkg.io.NDArrayIter(x, y, batch_size=64,
                                  label_name="softmax_label")
    mod = pkg.mod.Module(sym(pkg), context=ctx)
    mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
    _init(pkg, mod)
    mod.init_optimizer(optimizer="sgd",
                       optimizer_params={"learning_rate": 0.1})
    for _ in range(epochs):
        it.reset()
        for batch in it:
            mod.forward(batch, is_train=True)
            mod.backward()
            mod.update()
    arg_p, aux_p = mod.get_params()
    return {k: v.asnumpy() for k, v in {**arg_p, **aux_p}.items()}


def _close(got, want):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=ATOL,
                                   err_msg=k)


@pytest.fixture(scope="module")
def toy():
    return _toy_data()


def test_dp_mesh_rule():
    mesh = tmx.context.dp_mesh(_ctxs(tmx))
    assert mesh.shape == {"dp": DP}
    assert [str(d) for d in mesh.devices.flat] == ["cpu"] * DP
    assert tmx.context.dp_mesh([tmx.cpu(0), tmx.cpu(0)]) is None
    with pytest.raises(MXNetError, match="CUDA is not available"):
        tmx.context.dp_mesh([tmx.gpu(0), tmx.gpu(1)])


# -- gluon --------------------------------------------------------------------
def _train_gluon(pkg, ctx_list, x, y, steps=20):
    """The JAX test's ``_train_gluon``."""
    g = pkg.gluon
    net = g.nn.Sequential()
    net.add(g.nn.Dense(16, activation="relu"))
    net.add(g.nn.Dense(4))
    net.initialize(pkg.initializer.Zero())
    rng = np.random.default_rng(7)
    shapes = {"w0": (16, 8), "b0": (16,), "w1": (4, 16), "b1": (4,)}
    vals = {k: rng.normal(scale=0.1, size=s).astype("float32")
            for k, s in shapes.items()}
    net(pkg.nd.zeros((2, 8)))
    plist = list(net.collect_params().values())
    for p, k in zip(plist, ["w0", "b0", "w1", "b1"]):
        p.set_data(pkg.nd.array(vals[k]))
    loss_fn = g.loss.SoftmaxCrossEntropyLoss()
    trainer = g.Trainer(net.collect_params(), "sgd",
                        {"learning_rate": 0.1}, kvstore="device")
    bs = 64
    for i in range(steps):
        lo = (i * bs) % (len(x) - bs)
        xs = g.utils.split_and_load(pkg.nd.array(x[lo:lo + bs]), ctx_list)
        ys = g.utils.split_and_load(pkg.nd.array(y[lo:lo + bs]), ctx_list)
        with pkg.autograd.record():
            losses = [loss_fn(net(xb), yb) for xb, yb in zip(xs, ys)]
        for lo_ in losses:
            lo_.backward()
        trainer.step(bs)
    return {i: p.data().asnumpy()
            for i, p in enumerate(net.collect_params().values())}


def test_gluon_trainer_multi_device_matches_single(toy):
    """split_and_load over 8 contexts: one step over the whole batch,
    the single-context run's weights (and the JAX package's)."""
    x, y = toy
    with CPU:
        ref = _train_gluon(tmx, [tmx.cpu(0)], x, y)
        dp = _train_gluon(tmx, _ctxs(tmx), x, y)
    _close(dp, ref)
    _close(dp, _train_gluon(mx, [mx.tpu(0)], x, y))


def test_split_and_load_shards_over_mesh():
    data = np.arange(64, dtype=np.float32).reshape(16, 4)
    with CPU:
        out = tmx.gluon.utils.split_and_load(tmx.nd.array(data), _ctxs(tmx))
        assert len(out) == 1 and out[0].context == tmx.cpu()
        np.testing.assert_array_equal(out[0].asnumpy(), data)
        # a repeated context, or a batch that does not divide: slices
        sl = tmx.gluon.utils.split_and_load(tmx.nd.array(data),
                                            [tmx.cpu(0)] * 4)
        assert [s.shape for s in sl] == [(4, 4)] * 4
        sl = tmx.gluon.utils.split_and_load(
            tmx.nd.array(data[:15]), _ctxs(tmx, 4), even_split=False)
        assert [s.shape[0] for s in sl] == [3, 3, 3, 6]
        with pytest.raises(MXNetError, match="evenly split"):
            tmx.gluon.utils.split_and_load(tmx.nd.array(data[:15]),
                                           _ctxs(tmx, 4))
        with pytest.raises(MXNetError, match="CUDA is not available"):
            tmx.gluon.utils.split_and_load(tmx.nd.array(data),
                                           [tmx.gpu(0), tmx.gpu(1)])
    jout = mx.gluon.utils.split_and_load(mx.nd.array(data), _ctxs(mx))
    assert len(jout) == 1
    np.testing.assert_array_equal(jout[0].asnumpy(), data)


# -- Module -------------------------------------------------------------------
def test_module_multi_device_matches_jax(toy):
    """Module over cpu(0..7) against the JAX Module over tpu(0..7) (and
    the port's one-device Module)."""
    x, y = toy
    with CPU:
        dp = _fit(tmx, _ctxs(tmx), x, y)
        one = _fit(tmx, tmx.cpu(0), x, y)
    _close(dp, _fit(mx, _ctxs(mx), x, y))
    _close(dp, one)


def _bn_step(pkg, ctx, x, y, steps=2):
    """Two training steps of the BatchNorm net from numpy parameters:
    the first step's gradients, then the parameters and moving
    statistics."""
    mod = pkg.mod.Module(_bn_sym(pkg), context=ctx)
    mod.bind(data_shapes=[("data", x.shape)],
             label_shapes=[("softmax_label", y.shape)])
    _init(pkg, mod, seed=3)
    mod.init_optimizer(optimizer="sgd",
                       optimizer_params={"learning_rate": 0.1,
                                         "rescale_grad": 1.0})
    batch = pkg.io.DataBatch(data=[pkg.nd.array(x)],
                             label=[pkg.nd.array(y)])
    grads = None
    for _ in range(steps):
        mod.forward(batch, is_train=True)
        mod.backward()
        if grads is None:
            grads = {k: v.asnumpy() for k, v in mod._exec.grad_dict.items()
                     if k not in ("data", "softmax_label")}
        mod.update()
    arg_p, aux_p = mod.get_params()
    return grads, {k: v.asnumpy() for k, v in {**arg_p, **aux_p}.items()}


def test_module_batchnorm_over_the_whole_batch_matches_jax():
    """BatchNorm's batch moments merged across the eight positions: the
    gradients, parameters and moving statistics of the JAX package's dp
    Module (whose GSPMD program sees the whole batch), and of the port
    on one device."""
    rng = np.random.default_rng(5)
    x = rng.normal(size=(16, 3, 8, 8)).astype(np.float32)
    y = rng.integers(0, 4, 16).astype(np.float32)
    with CPU:
        g_dp, p_dp = _bn_step(tmx, _ctxs(tmx), x, y)
        g_one, p_one = _bn_step(tmx, tmx.cpu(0), x, y)
    g_jax, p_jax = _bn_step(mx, _ctxs(mx), x, y)
    assert {"bn_moving_mean", "bn_moving_var"} <= set(p_dp)
    for got in ((g_dp, g_jax), (p_dp, p_jax), (g_dp, g_one), (p_dp, p_one)):
        _close(*got)


def test_indivisible_batch_raises_the_jax_message():
    x, y = _toy_data(n=12)
    with CPU:
        mod = tmx.mod.Module(_mlp_sym(tmx), context=_ctxs(tmx))
        mod.bind(data_shapes=[("data", (12, 8))],
                 label_shapes=[("softmax_label", (12,))])
        mod.init_params()
        batch = tmx.io.DataBatch(data=[tmx.nd.array(x)],
                                 label=[tmx.nd.array(y)])
        with pytest.raises(MXNetError, match="not divisible by the 8 "
                           "devices in the context list"):
            mod.forward(batch, is_train=True)


def test_simple_bind_over_a_mesh_takes_a_sharded_batch():
    """``simple_bind(mesh=, arg_specs=)``: a batch laid out over the mesh
    used in place, outputs assembled to the global batch, the
    replicated gradients summed and the data's gradient (inputs that
    need one) assembled, as the one-device executor computes them."""
    x, y = _toy_data(n=32)
    rng = np.random.default_rng(2)
    net = _mlp_sym(tmx)
    mesh = par.create_mesh({"dp": 4}, devices=["cpu"] * 4)
    try:
        with CPU:
            shapes = {"data": (32, 8), "softmax_label": (32,)}
            req = {n: "null" if n == "softmax_label" else "write"
                   for n in net.list_arguments()}
            one = net.simple_bind(grad_req=req, **shapes)
            dp = net.simple_bind(
                grad_req=req, mesh=mesh, **shapes,
                arg_specs={"data": P("dp"), "softmax_label": P("dp")})
            params = {n: rng.normal(scale=0.1, size=a.shape).astype(
                np.float32) for n, a in one.arg_dict.items()
                if n not in shapes}
            one.copy_params_from(params)
            dp.copy_params_from(params)
            placed = par.shard_batch({"data": x, "softmax_label": y}, mesh)
            out_one = one.forward(is_train=True, data=x, softmax_label=y)
            out_dp = dp.forward(is_train=True, **placed)
            one.backward()
            dp.backward()
        assert dp._sharded["data"] is placed["data"]
        np.testing.assert_allclose(out_dp[0].asnumpy(), out_one[0].asnumpy(),
                                   rtol=1e-6, atol=1e-7)
        for n in req:
            if req[n] == "write":
                np.testing.assert_allclose(
                    dp.grad_dict[n].asnumpy(), one.grad_dict[n].asnumpy(),
                    rtol=1e-5, atol=1e-7, err_msg=n)
    finally:
        mesh.close()


# -- sharded input --------------------------------------------------------------
@pytest.fixture(scope="module")
def shardings():
    """(port, JAX) dp 8 shardings."""
    mesh = par.create_mesh({"dp": DP}, devices=["cpu"] * DP)
    jmesh = jpar.create_mesh({"dp": DP})
    yield par.NamedSharding(mesh, P("dp")), JNamedSharding(jmesh, JP("dp"))
    mesh.close()


def _blocks(a):
    """The port's Sharded blocks, or a JAX array's in index order."""
    if isinstance(a, par.Sharded):
        return [s.numpy() for s in a.shards.flat]
    data = a._data if hasattr(a, "_data") else a
    shards = sorted(data.addressable_shards, key=lambda s: s.index[0].start)
    return [np.asarray(s.data) for s in shards]


def _same_laid(got, want):
    assert isinstance(got, par.Sharded)
    a, b = np.asarray(got), np.asarray(want._data if hasattr(want, "_data")
                                       else want)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)
    for g, w in zip(_blocks(got), _blocks(want)):
        np.testing.assert_array_equal(g, w)


def _host_batch(seed=0, n=16):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, 3)).astype(np.float32),
            rng.integers(0, 4, n).astype(np.float32))


def test_to_device_and_device_feeder_lay_batches_out_as_jax(shardings):
    sh, jsh = shardings
    x, y = _host_batch()
    with CPU:
        got = tpipe.to_device(tmx.io.DataBatch(data=[x], label=[y]), sh)
    want = jpipe.to_device(mx.io.DataBatch(data=[x], label=[y]), jsh)
    _same_laid(got.data[0], want.data[0])
    _same_laid(got.label[0], want.label[0])
    batches = [_host_batch(s) for s in range(3)]
    with CPU:
        feeder = tmx.io.DeviceFeeder(
            iter([tmx.io.DataBatch(data=[tmx.nd.array(a)], label=[])
                  for a, _ in batches]), sharding=sh)
        try:
            fed = list(feeder)
        finally:
            feeder.close()
    jfeeder = mx.io.DeviceFeeder(
        iter([mx.io.DataBatch(data=[a], label=[]) for a, _ in batches]),
        sharding=jsh)
    try:
        jfed = [jfeeder.get() for _ in batches]
    finally:
        jfeeder.close()
    assert len(fed) == len(jfed) == 3
    for g, w in zip(fed, jfed):
        _same_laid(g.data[0], w.data[0])


def test_prefetching_iter_and_data_loader_lay_batches_out_as_jax(shardings):
    sh, jsh = shardings
    rng = np.random.default_rng(4)
    x = rng.normal(size=(48, 5)).astype(np.float32)
    y = rng.integers(0, 4, 48).astype(np.float32)
    with CPU:
        it = tmx.io.PrefetchingIter(tmx.io.NDArrayIter(x, y, batch_size=16),
                                    sharding=sh)
        got = list(it)
        loader = list(tmx.gluon.data.DataLoader(
            tmx.gluon.data.ArrayDataset(x, y), batch_size=16, sharding=sh))
    jit = mx.io.PrefetchingIter(mx.io.NDArrayIter(x, y, batch_size=16),
                                prefetch_to_device=True, sharding=jsh)
    want = list(jit)
    jloader = list(mx.gluon.data.DataLoader(
        mx.gluon.data.ArrayDataset(x, y), batch_size=16,
        prefetch_to_device=True, sharding=jsh))
    assert len(got) == len(want) == len(loader) == len(jloader) == 3
    for g, w in zip(got, want):
        _same_laid(g.data[0], w.data[0])
        _same_laid(g.label[0], w.label[0])
    for g, w in zip(loader, jloader):
        for a, b in zip(g, w):
            _same_laid(a, b)


def test_module_fed_sharded_batches_trains_as_host_batches(toy, shardings):
    """A dp Module fed through ``PrefetchingIter(sharding=)`` takes each
    batch's blocks in place and ends with the weights of the same Module
    fed host batches, bit for bit."""
    sh, _ = shardings
    x, y = toy
    with CPU:
        fed = _fit(tmx, _ctxs(tmx), x, y, epochs=1, it=tmx.io.PrefetchingIter(
            tmx.io.NDArrayIter(x, y, batch_size=64,
                               label_name="softmax_label"), sharding=sh))
        host = _fit(tmx, _ctxs(tmx), x, y, epochs=1)
    for k in host:
        np.testing.assert_array_equal(fed[k], host[k], err_msg=k)


def test_a_repeated_context_list_binds_one_device(caplog):
    with CPU, caplog.at_level(logging.WARNING):
        mod = tmx.mod.Module(_mlp_sym(tmx), context=[tmx.cpu(1)] * 2)
        mod.bind(data_shapes=[("data", (4, 8))],
                 label_shapes=[("softmax_label", (4,))])
    assert mod._exec._mesh is None
    assert "does not map to distinct devices" in caplog.text
