"""The port's distributed KVStore in real multi-process jobs, launched
through the port's own launcher (``mxnet_tpu_torch/tools/launch.py``) on
the CPU, each job 2 workers (this file is also their program):

1. ``-s 1`` (the server's optimizer on the CPU: ``--env-server
   MXNET_KVSTORE_SERVER_DEVICE=cpu``): a ``dist_sync`` Trainer with
   ``update_on_kvstore=False`` (gradients summed by the server, updated
   on the workers), then ``tests/dist_sync_kvstore.py``'s push/pull
   semantics (sums over rounds, the server-side optimizer, 2-bit pushes
   with their error feedback; string keys are numbered from 0, the
   Trainer's keys, so tests/test_torch_kvstore.py holds them in one
   process); worker 1's connection is
   dropped at its 4th push (``MXNET_KVSTORE_FAULT_PLAN``) under a
   recovery budget, and it reconnects and resends;
2. ``-s 1``: a ``dist_sync`` Trainer with ``update_on_kvstore=True`` (the
   port's SGD class applied on the server) and 2-bit compression;
3. ``-s 0``: two ``dist_device_sync`` Trainers (update on the kvstore and
   not) over gloo.

Each Trainer takes 10 SGD-momentum steps of a 4-16-1 MLP from the same
numpy weights, each worker on its half of a 64-row batch. The two
workers' final weights are the same bits, and equal the JAX package's
single-process Trainer on the full batch, computed here, within rtol
2e-4 / atol 2e-5 (tests/dist_train_gluon.py's bounds). With 2-bit
compression the single-process reference sums each half's gradient as
the JAX package's quantizer decodes it (a quantizer, and residual, per
worker), which is what the server sums.
"""
import torch_test_env  # noqa: F401  (first: one torch thread a process)

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
LAUNCH = os.path.join(ROOT, "mxnet_tpu_torch", "tools", "launch.py")
STEPS, ROWS, LR, MOMENTUM, THRESHOLD = 10, 64, 0.1, 0.9, 0.5
JOB_TIMEOUT_S = 60


def _data():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(ROWS, 4)).astype(np.float32)
    y = (x.sum(axis=1, keepdims=True) * 0.5).astype(np.float32)
    w = [rng.normal(scale=0.5, size=s).astype(np.float32)
         for s in ((16, 4), (16,), (1, 16), (1,))]
    return x, y, w


def _net(pkg, weights):
    nn = pkg.gluon.nn
    net = nn.HybridSequential(prefix="dkv_")
    with net.name_scope():
        net.add(nn.Dense(16, in_units=4, activation="relu"),
                nn.Dense(1, in_units=16))
    net.initialize()
    params = list(net.collect_params().values())
    assert [p.shape for p in params] == [w.shape for w in weights]
    for p, w in zip(params, weights):
        p.set_data(pkg.nd.array(w))
    return net, params


def _step(pkg, net, x, y):
    with pkg.autograd.record():
        loss = pkg.gluon.loss.L2Loss()(net(pkg.nd.array(x)),
                                       pkg.nd.array(y))
    loss.backward()


def _trainer(pkg, params, kvstore, **kw):
    return pkg.gluon.Trainer(params, "sgd", {"learning_rate": LR,
                                             "momentum": MOMENTUM},
                             kvstore=kvstore, **kw)


def _train(pkg, weights, x, y, kvstore, **kw):
    net, params = _net(pkg, weights)
    trainer = _trainer(pkg, params, kvstore, **kw)
    for _ in range(STEPS):
        _step(pkg, net, x, y)
        trainer.step(ROWS)
    return trainer, [p.data().asnumpy() for p in params]


def _semantics(tmx, kv):
    """tests/dist_sync_kvstore.py's checks, on keys the Trainer's do not
    hold (a key's first init wins on the server)."""
    nd, nw, rank = tmx.nd, kv.num_workers, kv.rank
    shape = (3, 4)
    kv.init(100, nd.ones(shape))
    kv.barrier()
    out = nd.zeros(shape)
    for rnd in range(1, 4):
        kv.push(100, nd.ones(shape) * (rank + 1) * rnd)
        kv.pull(100, out=out)
        assert np.all(out.asnumpy() == rnd * nw * (nw + 1) / 2), out
        kv.barrier()
    kv.init(107, nd.ones(shape))
    kv.barrier()
    kv.set_optimizer(tmx.optimizer.SGD(learning_rate=0.1))
    kv.push(107, nd.ones(shape))
    kv.pull(107, out=out)
    np.testing.assert_allclose(out.asnumpy(), 1 - 0.1 * nw, rtol=1e-6)
    kv.barrier()
    kv.set_gradient_compression({"type": "2bit", "threshold": 0.5})
    kv.init(109, nd.zeros(shape))
    kv.barrier()
    kv.push(109, nd.ones(shape) * 2.0)      # each worker sends +0.5
    kv.pull(109, out=out)
    np.testing.assert_allclose(out.asnumpy(), -0.05 * nw, rtol=1e-6)
    kv.barrier()
    kv.push(109, nd.zeros(shape))           # the residual 1.5 sends +0.5
    kv.pull(109, out=out)
    np.testing.assert_allclose(out.asnumpy(), -0.1 * nw, rtol=1e-6)
    kv.barrier()


def _worker(mode, out_dir):
    import torch
    import mxnet_tpu_torch as tmx

    torch.set_num_threads(1)
    wid = int(os.environ["DMLC_WORKER_ID"])
    x, y, w = _data()
    half = ROWS // 2
    xs, ys = x[wid * half:(wid + 1) * half], y[wid * half:(wid + 1) * half]
    result, info = {}, {}
    with tmx.cpu():
        if mode == "ps":
            kv = tmx.kv.create("dist_sync")
            _, result["ps_false"] = _train(tmx, w, xs, ys, kv,
                                           update_on_kvstore=False)
            _semantics(tmx, kv)
            info["reconnects"] = kv._conn.telemetry.reconnects
            info["recovered"] = kv._conn.telemetry.recovered
            kv.close()
        elif mode == "ps_2bit":
            tr, result["ps_true_2bit"] = _train(
                tmx, w, xs, ys, "dist_sync", update_on_kvstore=True,
                compression_params={"type": "2bit",
                                    "threshold": THRESHOLD})
            info["rank"] = tr._kvstore.rank
            tr._kvstore.close()
        else:
            tr, result["coll_true"] = _train(tmx, w, xs, ys,
                                             "dist_device_sync")
            tr2, result["coll_false"] = _train(
                tmx, w, xs, ys, "dist_device_sync", update_on_kvstore=False)
            info["backend"] = tr._kvstore._coll.backend
            tr._kvstore.close()
    np.savez(os.path.join(out_dir, f"{mode}_{wid}.npz"),
             **{f"{k}_{i}": a for k, v in result.items()
                for i, a in enumerate(v)})
    print(f"[worker {wid}] OK " + json.dumps(info), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(_worker(sys.argv[1], sys.argv[2]))


import pytest  # noqa: E402

JOBS = {
    "ps": (["-s", "1", "--env-server", "MXNET_KVSTORE_SERVER_DEVICE=cpu"],
           {"MXNET_KVSTORE_FAULT_PLAN": "drop_conn@round=4@rank=1",
            "MXNET_KVSTORE_RECOVERY_BUDGET_MS": "20000"}),
    "ps_2bit": (["-s", "1", "--env-server",
                 "MXNET_KVSTORE_SERVER_DEVICE=cpu"], {}),
    "coll": (["-s", "0"], {}),
}


def _jax_reference(two_bit):
    """The JAX package's single-process Trainer on the full batch; with
    ``two_bit``, each step's gradient is the sum of the two halves'
    gradients as the JAX quantizer decodes them."""
    import mxnet_tpu as mx
    from mxnet_tpu.kvstore.gradient_compression import GradientCompression

    x, y, w = _data()
    net, params = _net(mx, w)
    trainer = _trainer(mx, params, "device")
    gcs = [GradientCompression(threshold=THRESHOLD) for _ in range(2)]
    half = ROWS // 2
    for _ in range(STEPS):
        if not two_bit:
            _step(mx, net, x, y)
        else:
            total = [0.0] * len(params)
            for r in range(2):
                _step(mx, net, x[r * half:(r + 1) * half],
                      y[r * half:(r + 1) * half])
                for i, p in enumerate(params):
                    total[i] = total[i] + gcs[r].quantize(
                        i, p.grad().asnumpy())[1]
            for p, t in zip(params, total):
                p.grad()._data = mx.nd.array(t)._data
        trainer.step(ROWS)
    return [p.data().asnumpy() for p in params]


@pytest.fixture(scope="module")
def jobs():
    """The three jobs, started together (the comm library built first,
    once), and the JAX references computed while they run."""
    from mxnet_tpu_torch import _native
    _native.load_comm()
    out = tempfile.mkdtemp(prefix="torch_dist_kv_")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = {}
    for mode, (flags, extra) in JOBS.items():
        procs[mode] = subprocess.Popen(
            [sys.executable, LAUNCH, "-n", "2", *flags, sys.executable,
             os.path.abspath(__file__), mode, out],
            env=dict(env, **extra), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
    t0 = time.monotonic()
    refs = {"plain": _jax_reference(False), "two_bit": _jax_reference(True)}
    done = {}

    def result(mode):
        if mode not in done:
            p = procs[mode]
            try:
                log, _ = p.communicate(
                    timeout=max(1.0, JOB_TIMEOUT_S - (time.monotonic() - t0)))
            except subprocess.TimeoutExpired:
                p.kill()
                log = p.communicate()[0]
                pytest.fail(f"{mode} job over {JOB_TIMEOUT_S} s:\n{log}")
            assert p.returncode == 0, f"{mode} job failed:\n{log}"
            ws = [np.load(os.path.join(out, f"{mode}_{i}.npz"))
                  for i in range(2)]
            done[mode] = (log, ws)
        return done[mode]

    yield result, refs
    for p in procs.values():
        if p.poll() is None:
            p.kill()
            p.wait()


def _check(ws, name, want):
    for i, w in enumerate(want):
        a, b = ws[0][f"{name}_{i}"], ws[1][f"{name}_{i}"]
        np.testing.assert_array_equal(a, b)      # the workers agree
        np.testing.assert_allclose(a, w, rtol=2e-4, atol=2e-5)


def test_dist_sync_worker_update_semantics_and_recovery(jobs):
    result, refs = jobs
    log, ws = result("ps")
    _check(ws, "ps_false", refs["plain"])
    infos = {int(line.split()[1].rstrip("]")): json.loads(
        line.split(" OK ", 1)[1]) for line in log.splitlines()
        if line.startswith("[worker ") and " OK " in line}
    assert sorted(infos) == [0, 1], log
    assert infos[1]["reconnects"] >= 1 and infos[1]["recovered"] >= 1, log
    assert infos[0]["reconnects"] == 0, log


def test_dist_sync_server_update_with_2bit_compression(jobs):
    result, refs = jobs
    log, ws = result("ps_2bit")
    _check(ws, "ps_true_2bit", refs["two_bit"])
    assert "kvstore server: " in log and '"device": "cpu"' in log, log


def test_dist_device_sync_serverless_over_gloo(jobs):
    result, refs = jobs
    log, ws = result("coll")
    _check(ws, "coll_true", refs["plain"])
    _check(ws, "coll_false", refs["plain"])
    assert log.count('"backend": "gloo"') == 2, log
