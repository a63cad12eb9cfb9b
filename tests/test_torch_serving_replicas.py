"""The port's one-shot replicas held to the JAX package on the CPU
(counterparts of tests/test_serving.py's replica tests and its
placement helper): a replica whose execution fails drains itself and its
batch redistributes to the healthy one, with replies equal to one
replica's bit for bit and to the JAX gateway's; the last replica down
fast-rejects ``no_replica``; replicas wrap onto fewer devices with the
``degraded`` flag, warned once; a probe drains and ``check_health``
revives without leaking a lane thread (also from the health thread of
``MXTPU_SERVING_HEALTH_SEC``); two replicas failing together fail their
requests cleanly; zero replicas raise; ``scale`` grows and shrinks the
lanes; and ``replica_devices`` places as the JAX helper does. Telemetry
assertions of the JAX tests read ``stats()``. Every wait is bounded.
"""
import torch_test_env  # noqa: F401  (first: one torch thread a process)

import logging
import threading
import time

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as tmx
from mxnet_tpu.serving import Gateway as JaxGateway
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.parallel import mesh as port_mesh
from mxnet_tpu_torch.serving import Gateway, RejectedError, ServingError

F32 = np.float32
CPU = tmx.cpu()
DIN, HIDDEN, DOUT = 8, 16, 4


def _mlp(pkg):
    sym = pkg.sym
    data = sym.var("data")
    h = sym.FullyConnected(data, sym.var("fc1_weight"), sym.var("fc1_bias"),
                           num_hidden=HIDDEN, name="fc1")
    a = sym.Activation(h, act_type="relu", name="act1")
    return sym.FullyConnected(a, sym.var("fc2_weight"), sym.var("fc2_bias"),
                              num_hidden=DOUT, name="fc2")


def _weights():
    rng = np.random.default_rng(0)
    return {"fc1_weight": rng.normal(0, 0.5, (HIDDEN, DIN)).astype(F32),
            "fc1_bias": rng.normal(0, 0.5, (HIDDEN,)).astype(F32),
            "fc2_weight": rng.normal(0, 0.5, (DOUT, HIDDEN)).astype(F32),
            "fc2_bias": rng.normal(0, 0.5, (DOUT,)).astype(F32)}


def _x(seed=1):
    return np.random.default_rng(seed).normal(0, 1, (1, DIN)).astype(F32)


def _register(gw, name="m", **kw):
    args = {k: tmx.nd.array(v, ctx=CPU) for k, v in _weights().items()}
    kw.setdefault("buckets", (1,))
    kw.setdefault("max_wait_ms", 0.0)
    return gw.register(name, _mlp(tmx), args, {},
                       input_shapes={"data": (DIN,)}, **kw)


SEEDS = range(8)


@pytest.fixture(scope="module")
def jax_replies():
    """The JAX gateway's replies to inputs ``_x(seed)``."""
    jgw = JaxGateway()
    try:
        jgw.register("m", _mlp(mx), {k: mx.nd.array(v) for k, v in
                                     _weights().items()}, {},
                     input_shapes={"data": (DIN,)}, buckets=(1,),
                     max_wait_ms=0.0)
        return {s: jgw.infer("m", _x(s))[0] for s in SEEDS}
    finally:
        jgw.close()


@pytest.fixture(scope="module")
def one_replica():
    """The port's one-replica replies to the same inputs."""
    gw = Gateway(device="cpu")
    try:
        _register(gw)
        return {s: gw.infer("m", _x(s))[0] for s in SEEDS}
    finally:
        gw.close()


def _fault(rep, msg="injected replica fault"):
    def boom(variant, batch):
        raise RuntimeError(msg)
    rep.variant_set.run = boom


def _block(rep):
    """Park one replica's executor on an Event: deterministic overload
    without timing games."""
    release, parked = threading.Event(), threading.Event()
    orig = rep.variant_set.run

    def blocked(variant, batch):
        parked.set()
        release.wait(20.0)
        return orig(variant, batch)

    rep.variant_set.run = blocked
    return release, parked


def _lane_threads(name="m"):
    return [t for t in threading.enumerate()
            if t.name.startswith(f"mxtpu-serve-{name}-r") and t.is_alive()]


def _wait(cond, deadline_s=10.0):
    deadline = time.monotonic() + deadline_s
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.001)
    return cond()


def test_replica_failure_drains_and_redistributes(jax_replies, one_replica):
    gw = Gateway(devices=["cpu", "cpu"])
    try:
        # buckets (1,): every batch is one request, so the parked replica
        # holds exactly one and the failing one is guaranteed work
        _register(gw, replicas=2)
        reps = gw._get_model("m").replicas
        assert reps[0].variant_set is not reps[1].variant_set
        assert reps[0].variant_set._fns == reps[1].variant_set._fns
        gw.infer("m", _x())
        release, parked = _block(reps[1])
        orig0 = reps[0].variant_set.run
        _fault(reps[0])
        queue = gw._get_model("m").queue
        # submit until the fault lands: replica 1 parks on the first
        # batch it takes, so replica 0 takes (and fails) the next
        reqs = []
        for s in SEEDS:
            reqs.append((s, gw.submit("m", _x(s))))
            if _wait(lambda: not reps[0].healthy or parked.is_set()
                     and queue.depth() == 0) and not reps[0].healthy:
                break
        assert not reps[0].healthy, "fault never drained replica 0"
        release.set()                       # replica 1 serves all
        for s, r in reqs:
            out = r.result(10.0)[0]
            np.testing.assert_array_equal(out, one_replica[s])
            np.testing.assert_allclose(out, jax_replies[s], rtol=1e-5,
                                       atol=1e-6)
        assert gw.health()["m"] == [False, True]
        st = gw.stats()["m"]
        assert st["failures"] >= 1
        assert st["replicas"][0]["healthy"] is False
        assert "injected replica fault" in st["replicas"][0]["last_error"]
        assert max(r.attempts for _, r in reqs) == 2
        # heal the executor; check_health revives the drained replica
        reps[0].variant_set.run = orig0
        assert gw.check_health("m", revive=True)["m"] == [True, True]
        np.testing.assert_array_equal(gw.infer("m", _x(3))[0],
                                      one_replica[3])
    finally:
        gw.close()


def test_poison_request_fails_after_every_replica():
    """A request that fails on every replica fails with the replicas'
    error once none is left, instead of cycling between them."""
    gw = Gateway(devices=["cpu", "cpu"])
    try:
        _register(gw, replicas=2)
        for rep in gw._get_model("m").replicas:
            _fault(rep, "poison")
        req = gw.submit("m", _x())
        with pytest.raises(ServingError, match="poison"):
            req.result(10.0)
        assert req.attempts <= 2 and gw.health()["m"] == [False, False]
    finally:
        gw.close()


def test_all_replicas_down_rejects_no_replica():
    gw = Gateway(device="cpu")
    try:
        _register(gw)
        gw.infer("m", _x())
        _fault(gw._get_model("m").replicas[0], "boom")
        req = gw.submit("m", _x())
        with pytest.raises(ServingError):
            req.result(10.0)
        with pytest.raises(RejectedError) as ei:
            gw.submit("m", _x())
        assert ei.value.reason == "no_replica"
    finally:
        gw.close()


def test_replica_degrade_to_fewer_devices(caplog):
    port_mesh._reset_degrade_warnings()
    gw = Gateway(devices=["cpu"])
    try:
        with caplog.at_level(logging.WARNING,
                             logger="mxnet_tpu_torch.serving.gateway"):
            _register(gw, replicas=3)
        assert "degrading" in caplog.text
        st = gw.stats()["m"]
        assert len(st["replicas"]) == 3 and st["degraded"] is True
        assert len({r["device"] for r in st["replicas"]}) == 1
        assert gw.infer("m", _x())[0].shape == (1, DOUT)
        # the same (ask, devices) wrap warns exactly once
        caplog.clear()
        with caplog.at_level(logging.WARNING,
                             logger="mxnet_tpu_torch.serving.gateway"):
            _register(gw, "m2", replicas=3)
        assert "degrading" not in caplog.text
        assert gw.stats()["m2"]["degraded"] is True
    finally:
        gw.close()


def test_probe_drain_and_revive_does_not_leak_threads(one_replica):
    """A probe-drained replica's thread stays parked in take_batch;
    revive starts a FRESH generation and the stale thread retires on its
    next wake instead of serving — no thread accumulates across
    drain -> revive cycles."""
    gw = Gateway(device="cpu")
    try:
        _register(gw, "m_probe")
        gw.infer("m_probe", _x())
        rep = gw._get_model("m_probe").replicas[0]
        orig = rep.variant_set.run
        _fault(rep, "probe fault")
        assert gw.check_health("m_probe")["m_probe"] == [False]
        before = rep._thread
        assert before.is_alive()              # parked in take_batch
        rep.variant_set.run = orig
        assert gw.check_health("m_probe", revive=True)["m_probe"] == [True]
        for s in range(3):
            np.testing.assert_array_equal(gw.infer("m_probe", _x(s))[0],
                                          one_replica[s])
        before.join(5.0)
        assert not before.is_alive(), "stale lane still running"
        assert rep._thread is not before and rep._thread.is_alive()
        assert _wait(lambda: len(_lane_threads("m_probe")) == 1)
    finally:
        gw.close()


def test_health_thread_revives_a_drained_replica(monkeypatch):
    monkeypatch.setenv("MXTPU_SERVING_HEALTH_SEC", "0.02")
    gw = Gateway(devices=["cpu", "cpu"])
    try:
        _register(gw, replicas=2)
        rep = gw._get_model("m").replicas[0]
        rep.healthy = False                   # drained, executor fine
        assert _wait(lambda: gw.health()["m"] == [True, True])
        assert gw.infer("m", _x())[0].shape == (1, DOUT)
    finally:
        gw.close()
    assert not gw._health_thread.is_alive()


def test_concurrent_last_replica_failures_fail_cleanly():
    """Both replicas failing in the same window must not strand
    requeued requests in a queue nobody serves."""
    gw = Gateway(devices=["cpu", "cpu"])
    try:
        _register(gw, replicas=2)
        gw.infer("m", _x())
        for rep in gw._get_model("m").replicas:
            _fault(rep, "double fault")
        reqs = []
        for s in range(4):
            try:
                reqs.append(gw.submit("m", _x(s)))
            except RejectedError as e:
                assert e.reason == "no_replica"
        assert reqs, "no request was admitted before the lanes died"
        for r in reqs:
            with pytest.raises(ServingError):
                r.result(10.0)                # clean error, no hang
        assert gw.health()["m"] == [False, False]
    finally:
        gw.close()


def test_register_rejects_zero_replicas():
    gw = Gateway(device="cpu")
    try:
        with pytest.raises(ServingError):
            _register(gw, replicas=0)
        with pytest.raises(ServingError):
            Gateway(devices=[])
        with pytest.raises(ServingError):
            Gateway(devices=["cpu"], device="cpu")
    finally:
        gw.close()


def test_scale_grows_and_shrinks_without_leaking_threads(one_replica):
    gw = Gateway(devices=["cpu", "cpu"])
    try:
        _register(gw, "m_scale", replicas=2)
        assert _wait(lambda: len(_lane_threads("m_scale")) == 2)
        rep = gw.scale("m_scale", 3)
        assert (rep["added"], rep["degraded"]) == (1, True)
        assert gw.replica_count("m_scale") == 3
        assert _wait(lambda: len(_lane_threads("m_scale")) == 3)
        idx = [r["idx"] for r in gw.stats()["m_scale"]["replicas"]]
        assert idx == [0, 1, 2]
        rep = gw.scale("m_scale", 1)
        assert (rep["retired"], rep["degraded"]) == (2, False)
        assert gw.replica_count("m_scale") == 1
        for s in SEEDS:
            np.testing.assert_array_equal(gw.infer("m_scale", _x(s))[0],
                                          one_replica[s])
        assert _wait(lambda: len(_lane_threads("m_scale")) == 1)
        idx = [r["idx"] for r in gw.stats()["m_scale"]["replicas"]]
        assert idx == [0]
        with pytest.raises(ServingError):
            gw.scale("m_scale", 0)
    finally:
        gw.close()


def test_replica_devices_helper():
    """The port's placement over torch devices, beside the JAX helper's
    over JAX devices: the same wrap, the same degraded flags, and
    ``exclude`` honoured until nothing is left."""
    import jax
    from mxnet_tpu.parallel.mesh import replica_devices as jax_place
    jdevs = jax.local_devices()[:2]
    tdevs = ["cpu", "cpu"]
    for n, k, exclude in ((2, 2, ()), (3, 1, ()), (3, 2, (0,)),
                          (2, 1, (0,))):
        jp, jdeg = jax_place(n, devices=jdevs[:k],
                             exclude=[jdevs[i] for i in exclude])
        tp, tdeg = port_mesh.replica_devices(
            n, devices=tdevs[:k], exclude=[tdevs[i] for i in exclude])
        assert tdeg == jdeg and len(tp) == len(jp) == n
        assert all(str(d) == "cpu" for d in tp)
    # the port's devices default to the CUDA cards
    if not torch.cuda.is_available():
        with pytest.raises(MXNetError):
            port_mesh.replica_devices(2)
    port_mesh._reset_degrade_warnings()
    assert port_mesh.should_warn_degraded(3, ["cpu"] * 3)
    assert not port_mesh.should_warn_degraded(3, ["cpu"] * 3)
