"""The port's KVStore (``mxnet_tpu_torch.kvstore``) against the JAX
package's in one process, on the same numpy inputs: the factory's names,
``local`` / ``device`` init, list pushes (summed) and pulls (broadcast)
with int and string keys, ``set_optimizer`` updates and the optimizer
states saved and loaded, the 2-bit gradient compression (packed words,
decoded values and residuals bit for bit, over rounds that carry a
residual), the fault-plan parser and the recovery backoff schedule, and
a ``Trainer`` over a ``KVStore`` instance with both ``update_on_kvstore``
values. A ``dist`` type outside a launched job is a one-worker store in
both packages. The multi-process paths are tests/test_torch_dist_kvstore.py.

Tolerances: sums and 2-bit codes exact; optimizer updates 2 ulp of each
tensor's largest value (the JAX updates are jitted XLA programs that
contract products into FMAs, which the port reproduces).
"""
import torch_test_env  # noqa: F401  (first: one torch thread a process)

import dataclasses
import random

import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as tmx
from mxnet_tpu.kvstore import fault as jfault
from mxnet_tpu.kvstore.gradient_compression import \
    GradientCompression as JaxGC
from mxnet_tpu_torch.kvstore import fault as tfault
from mxnet_tpu_torch.kvstore.gradient_compression import \
    GradientCompression as TorchGC

F32 = np.float32
CPU = tmx.cpu()
KNOWN = ("local", "device", "local_allreduce_cpu", "local_allreduce_device",
         "nccl", "dist_sync", "dist_async", "dist_device_sync",
         "dist_sync_device", "dist")


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(F32)


def _ulps(got, want, n=2):
    want = np.asarray(want, F32)
    got = np.asarray(got, F32)
    assert got.shape == want.shape
    tol = n * np.spacing(np.abs(want).max().astype(F32))
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


@pytest.mark.parametrize("name", KNOWN)
def test_create_knows_the_jax_names(name):
    with CPU:
        kv = tmx.kv.create(name)
    jkv = mx.kv.create(name)
    assert kv.type == jkv.type == name
    assert (kv.rank, kv.num_workers) == (0, 1)
    assert (jkv.rank, jkv.num_workers) == (0, 1)


def test_create_refuses_unknown_names():
    for pkg in (mx, tmx):
        with pytest.raises(pkg.MXNetError):
            pkg.kv.create("dist_bogus")
    with pytest.raises(tmx.MXNetError):
        tmx.kv.create("local").row_sparse_pull(0, row_ids=[0])


def _kv_flow(pkg, name, tmp):
    """init / list push / pull, then an SGD-momentum updater over three
    rounds, its states saved after the second and loaded into a second
    store that runs the third: every value pulled, in order."""
    nd = pkg.nd
    kv = pkg.kv.create(name)
    shapes = {3: (2, 5), "w": (4,)}
    for i, (k, shp) in enumerate(shapes.items()):
        kv.init(k, nd.array(_rand(shp, i)))
    seen = []
    for k, shp in shapes.items():
        out = nd.zeros(shp)
        kv.pull(k, out=out)
        seen.append(out.asnumpy())
        # a push of three devices' values is their sum
        kv.push(k, [nd.array(_rand(shp, 10 + j)) for j in range(3)])
        outs = [nd.zeros(shp), nd.zeros(shp)]
        kv.pull(k, out=outs)
        seen += [o.asnumpy() for o in outs]
    # several keys at once
    kv.push([3, "w"], [nd.array(_rand((2, 5), 20)), nd.array(_rand((4,), 21))])
    outs = [nd.zeros((2, 5)), nd.zeros((4,))]
    kv.pull([3, "w"], out=outs)
    seen += [o.asnumpy() for o in outs]

    def sgd():
        return pkg.optimizer.SGD(learning_rate=0.1, momentum=0.9, wd=1e-3,
                                 rescale_grad=0.5)

    kv.set_optimizer(sgd())
    for rnd in range(3):
        if rnd == 2:
            kv.save_optimizer_states(tmp)
            kv2 = pkg.kv.create(name)
            for k in shapes:
                cur = nd.zeros(shapes[k])
                kv.pull(k, out=cur)
                kv2.init(k, cur)
            kv2.set_optimizer(sgd())
            kv2.load_optimizer_states(tmp)
            kv = kv2
        for j, (k, shp) in enumerate(shapes.items()):
            kv.push(k, nd.array(_rand(shp, 30 + 3 * rnd + j)))
            out = nd.zeros(shp)
            kv.pull(k, out=out)
            seen.append(out.asnumpy())
    return seen


@pytest.mark.parametrize("name", ["local", "device"])
def test_local_kvstore_matches_jax(name, tmp_path):
    want = _kv_flow(mx, name, str(tmp_path / "j.states"))
    with CPU:
        got = _kv_flow(tmx, name, str(tmp_path / "t.states"))
    assert len(got) == len(want)
    for g, w in zip(got[:9], want[:9]):
        np.testing.assert_array_equal(g, w)     # copies and sums
    for g, w in zip(got[9:], want[9:]):
        _ulps(g, w)                             # optimizer updates


def test_gradient_compression_is_bitwise_the_jax_quantizer():
    """Three rounds on two keys (the residual carried from round to
    round, a shape change resetting it), the words, decoded values and
    residuals equal bit for bit, and the wire payload byte for byte;
    unpack inverts the packing of both."""
    jgc, tgc = JaxGC(threshold=0.5), TorchGC(threshold=0.5)
    assert jgc.get_params() == tgc.get_params()
    for rnd in range(4):
        for key, shape in ((0, (37,)), ("b", (3, 11))):
            if rnd == 3 and key == 0:
                shape = (5, 2)      # a new shape starts a new residual
            g = _rand(shape, 100 + rnd) * 0.7
            jw, jdec = jgc.quantize(key, g)
            tw, tdec = tgc.quantize(key, g)
            assert tw.dtype == jw.dtype == np.uint32
            np.testing.assert_array_equal(tw, jw)
            np.testing.assert_array_equal(tdec.numpy(), jdec)
            np.testing.assert_array_equal(tgc._residual[key].numpy(),
                                          jgc._residual[key])
            np.testing.assert_array_equal(
                TorchGC.unpack(tw, g.size, 0.5), JaxGC.unpack(jw, g.size, 0.5))
            np.testing.assert_array_equal(
                TorchGC.unpack(tw, g.size, 0.5), jdec.ravel())
    g = _rand((50,), 7)
    assert JaxGC(threshold=0.25).wire_payload(1, g) == \
        TorchGC(threshold=0.25).wire_payload(1, g)
    for bad in (dict(type="1bit"), dict(threshold=0)):
        with pytest.raises(tmx.MXNetError):
            TorchGC(**bad)


PLANS = ["drop_conn@round=3;delay_ms=500@key=0;kill_server@round=5",
         "drop_conn@op=barrier@rank=1",
         "trunc_frame@round=2@key=4;reject_accept=2",
         "delay_ms=20@server=1;die_server@round=7@key=3",
         "kill_worker@batch=12@rank=0;trunc_checkpoint@round=2",
         "slow_worker=40@rank=1;borrow_wedge@round=2;replay_storm",
         " ; drop_conn ; "]
BAD_PLANS = ["explode", "drop_conn@when=3", "delay_ms", "kill_server",
             "drop_conn@op=fly", "kill_worker@round=2", "slow_worker",
             "borrow_wedge=3"]


def test_fault_plans_parse_as_the_jax_parser_does():
    for plan in PLANS:
        want = [dataclasses.asdict(r) for r in jfault.parse_fault_plan(plan)]
        got = [dataclasses.asdict(r) for r in tfault.parse_fault_plan(plan)]
        assert got == want, plan
        assert [tfault.FaultRule(**r).is_server_side for r in got] == \
            [jfault.FaultRule(**r).is_server_side for r in want]
    for plan in BAD_PLANS:
        with pytest.raises(mx.MXNetError):
            jfault.parse_fault_plan(plan)
        with pytest.raises(tmx.MXNetError):
            tfault.parse_fault_plan(plan)
    plan = "slow_worker=40@rank=1;slow_worker=5"
    for rank in (0, 1):
        assert tfault.straggler_delay_ms(rank, plan) == \
            jfault.straggler_delay_ms(rank, plan)


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _backoff(mod, budget):
    clock = _Clock()
    sched = mod.BackoffSchedule(budget, base_ms=50, max_ms=400,
                                clock=clock, rng=random.Random(9))
    waits = []
    while True:
        w = sched.next_wait()
        if w is None:
            return waits, sched.attempts, sched.total_wait_ms
        waits.append(w)
        clock.t += w + 0.001


@pytest.mark.parametrize("budget", [30, 1000, 5000])
def test_backoff_schedule_equals_jax(budget):
    assert _backoff(tfault, budget) == _backoff(jfault, budget)
    with pytest.raises(tmx.MXNetError):
        tfault.BackoffSchedule(0)


def _trainer_over_kvstore(pkg, update_on_kvstore):
    nn, nd, ag = pkg.gluon.nn, pkg.nd, pkg.autograd
    net = nn.Dense(3, in_units=4, prefix="kvt_")
    net.initialize()
    net.weight.set_data(nd.array(_rand((3, 4), 1)))
    net.bias.set_data(nd.array(_rand((3,), 2)))
    kv = pkg.kv.create("device")
    trainer = pkg.gluon.Trainer(net.collect_params(), "sgd",
                                {"learning_rate": 0.1, "momentum": 0.9},
                                kvstore=kv,
                                update_on_kvstore=update_on_kvstore)
    x = nd.array(_rand((5, 4), 3))
    for _ in range(3):
        with ag.record():
            loss = (net(x) ** 2).sum()
        loss.backward()
        trainer.step(5)
    assert trainer._kvstore is kv
    return [net.weight.data().asnumpy(), net.bias.data().asnumpy()]


@pytest.mark.parametrize("update_on_kvstore", [True, False])
def test_trainer_over_a_kvstore_instance_matches_jax(update_on_kvstore):
    """True: each gradient pushed to the store, whose updater moves the
    stored weight, pulled back; False: pushed and pulled back (the
    allreduce of one process), then the Trainer's own updater."""
    want = _trainer_over_kvstore(mx, update_on_kvstore)
    with CPU:
        got = _trainer_over_kvstore(tmx, update_on_kvstore)
    for g, w in zip(got, want):
        _ulps(g, w)
