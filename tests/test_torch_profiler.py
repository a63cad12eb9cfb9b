"""The port's profiler and Monitor (``mxnet_tpu_torch.profiler``,
``mxnet_tpu_torch.monitor``) against the JAX package's
(tests/test_profiler.py, tests/test_custom_monitor.py): the events of the
same calls (op dispatch, the executor, the user objects) equal the JAX
package's in name, ph, cat and args, and ``dumps`` tables have the same
rows; the device capture round-trips to ``op_attribution``; the Monitor's
statistics equal the JAX Monitor's (rtol 1e-5) in the same order, on a
bound executor, through ``Module.fit`` and over a dp 2 mesh, and its tap
reads nothing before ``toc``. Last, one 2-worker job of the port's
launcher (this file is the workers' program, ``python tests/
test_torch_profiler.py OUTDIR``) drives the server's profiler and
pulls its metrics and trace through the directive channel, and its
traced pushes carry their span context to the server.
"""
import torch_test_env  # noqa: F401  (first: one torch thread a process)

import json
import os
import re
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
LAUNCH = os.path.join(ROOT, "mxnet_tpu_torch", "tools", "launch.py")
TRACE_MERGE = os.path.join(ROOT, "tools", "trace_merge.py")
JOB_TIMEOUT_S = 60
JOB_STEPS = 2


def _worker(out_dir):
    """One worker of the job: traced pushes and pulls of one key updated
    on the server; worker 0 runs the server's profiler over them, then
    pulls the server's metrics and trace."""
    import mxnet_tpu_torch as tmx
    from mxnet_tpu_torch import profiler, tracing

    wid = int(os.environ["DMLC_WORKER_ID"])
    with tmx.cpu():
        kv = tmx.kv.create("dist_sync")
        kv.init(0, tmx.nd.zeros((8,)))
        kv.set_optimizer(tmx.optimizer.SGD(learning_rate=0.5))
        if wid == 0:
            profiler.set_config(
                profile_process="server",
                filename=os.path.join(out_dir, "server_profile.json"))
            profiler.set_state("run", profile_process="server")
            # a directive is applied by the server's poll loop after its
            # acknowledgement; the server runs them in order, so once a
            # later pull has its answer the profiler runs there
            tmx.telemetry.export.pull_server_metrics(
                kv, os.path.join(out_dir, "server_metrics_before.json"))
        kv.barrier()
        kv._conn.trace_clock_sync(2)
        out = tmx.nd.zeros((8,))
        for n in range(JOB_STEPS):
            with tracing.span("step", cat="step", step=n, rank=wid):
                kv.push(0, tmx.nd.ones((8,)) * (wid + 1))
                kv.pull(0, out=out)
        kv.barrier()
        if wid == 0:
            profiler.set_state("stop", profile_process="server")
            profiler.dump(profile_process="server")
            tmx.telemetry.export.pull_server_metrics(
                kv, os.path.join(out_dir, "server_metrics.json"))
            tracing.export.pull_server_trace(
                kv, os.path.join(out_dir, "trace.server0.json"))
        tracing.export.write_trace(
            os.path.join(out_dir, f"trace.worker{wid}.json"),
            meta={"role": "worker", "rank": wid})
        weights = out.asnumpy().tolist()
        kv.barrier()
        kv.close()
    print(f"[worker {wid}] OK " + json.dumps({"weights": weights}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(_worker(sys.argv[1]))


import pytest  # noqa: E402
import torch  # noqa: E402

import mxnet_tpu as jmx  # noqa: E402
import mxnet_tpu_torch as tmx  # noqa: E402
from mxnet_tpu_torch import profiler  # noqa: E402
from mxnet_tpu_torch.base import MXNetError  # noqa: E402

import observability_harness as oh  # noqa: E402



@pytest.fixture(scope="module")
def job():
    """The launcher job, started first and read by the last test."""
    from mxnet_tpu_torch import _native
    _native.load_comm()
    out = tempfile.mkdtemp(prefix="torch_profiler_job_")
    proc = subprocess.Popen(
        [sys.executable, LAUNCH, "-n", "2", "-s", "1", "--env-server",
         "MXNET_KVSTORE_SERVER_DEVICE=cpu", sys.executable,
         os.path.abspath(__file__), out],
        env=dict(os.environ, OMP_NUM_THREADS="1"), cwd=out,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    yield proc, out, time.monotonic()
    if proc.poll() is None:
        proc.kill()
        proc.wait()


@pytest.fixture(autouse=True)
def _clean(job):
    def clean():
        oh.reset_both()
        for mx in (jmx, tmx):
            mx.profiler.set_state("stop")
            with mx.profiler._lock:
                mx.profiler._events.clear()
    clean()
    yield
    clean()


def _events(mx, tmp_path, calls):
    """(name, ph, cat, args) of the events ``calls(mx)`` records while
    the profiler runs, read back from its chrome JSON."""
    path = str(tmp_path / f"{mx.__name__}.json")
    mx.profiler.set_config(filename=path)
    mx.profiler.set_state("run")
    with oh.scope(mx):
        calls(mx)
    mx.profiler.set_state("stop")
    mx.profiler.dump()
    events = json.load(open(path))["traceEvents"]
    return [(e["name"], e["ph"], e.get("cat"), e.get("args"))
            for e in events]


def _dispatch(mx):
    a = mx.nd.array(np.ones((8, 8), np.float32))
    for _ in range(3):
        c = mx.nd.dot(a, a)
    mx.nd.relu(c).wait_to_read()


def _user_objects(mx):
    domain = mx.profiler.Domain("app")
    task = mx.profiler.Task(domain, "load_data")
    task.start()
    task.stop()
    frame = mx.profiler.Frame(domain, "frame")
    frame.start()
    frame.stop()
    counter = mx.profiler.Counter(domain, "batches", 0)
    counter.increment(5)
    counter.decrement(2)
    counter.set_value(7)
    mx.profiler.marker("epoch_end")


@pytest.mark.parametrize("calls", [_dispatch, oh.executor_flow,
                                   _user_objects],
                         ids=["dispatch", "executor", "user_objects"])
def test_events_equal_the_jax_packages(tmp_path, calls):
    mine = _events(tmx, tmp_path, calls)
    theirs = _events(jmx, tmp_path, calls)
    assert mine == theirs
    assert mine


def test_dumps_table_rows_equal_the_jax_packages():
    def rows(mx):
        mx.profiler.set_state("run")
        with oh.scope(mx):
            _dispatch(mx)
            oh.executor_flow(mx)
        table = mx.profiler.dumps(reset=True)
        mx.profiler.set_state("stop")
        # name and count of each row (the times are each run's own)
        return sorted(tuple(line.split()[:2])
                      for line in table.splitlines()[1:])
    mine = rows(tmx)
    assert mine == rows(jmx)
    assert ("executor_forward", "1") in mine
    assert ("executor_backward", "1") in mine
    assert ("dot", "3") in mine


def test_profiler_off_by_default_records_nothing(tmp_path):
    assert profiler.state() == "stop"
    profiler.set_config(filename=str(tmp_path / "x.json"))
    with tmx.cpu():
        _dispatch(tmx)
    profiler.dump()
    assert json.load(open(tmp_path / "x.json"))["traceEvents"] == []


def test_counter_is_thread_safe_and_every_event_lands(tmp_path):
    out = tmp_path / "mt.json"
    profiler.set_config(filename=str(out))
    profiler.set_state("run")
    counter = profiler.Counter(profiler.Domain("mt"), "evts", 0)

    def work():
        for _ in range(500):
            counter.increment()
            profiler.record_event("w", "mt", 0.0, 1.0)

    threads = [threading.Thread(target=work) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    profiler.set_state("stop")
    profiler.dump()
    events = json.load(open(out))["traceEvents"]
    assert counter.value == 2000
    assert sum(e["name"] == "w" for e in events) == 2000
    assert sum(e["name"] == "evts" for e in events) == 2000


def test_device_capture_round_trips_to_op_attribution(tmp_path):
    """``set_config(xla_trace_dir=)`` + run / stop captures a Kineto
    trace into the directory, ``last_xplane_dir`` names it, and
    ``op_attribution`` joins it onto the same step's cost ledger: every
    framework op of the step a measured row, as the JAX package's
    capture gives."""
    from mxnet_tpu_torch.profiling import ledger
    x = tmx.nd.array(np.ones((4, 8), np.float32), ctx=tmx.cpu())
    w = tmx.nd.array(np.ones((3, 8), np.float32), ctx=tmx.cpu())

    def step():
        y = tmx.nd.FullyConnected(x, w, no_bias=True, num_hidden=3)
        return tmx.nd.relu(y)
    led = ledger.from_fn(step)
    assert {r["instr"] for r in led["rows"]} == {"FullyConnected#0",
                                                 "relu#0"}
    profiler.set_config(xla_trace_dir=str(tmp_path))
    try:
        profiler.set_state("run")
        tmx.telemetry.step.step_boundary("capture_test")
        step()
    finally:
        profiler.set_state("stop")
        profiler.set_config(xla_trace_dir=None)
    assert profiler.last_xplane_dir() == str(tmp_path)
    assert [f for f in os.listdir(tmp_path) if f.endswith(".pt.trace.json")]
    doc = profiler.op_attribution(compiled=led, steps=1)
    assert doc["kind"] == "mfu_attribution"
    measured = {r["instr"]: r.get("measured_s", 0) for r in doc["rows"]}
    assert measured["FullyConnected#0"] > 0 and measured["relu#0"] > 0
    assert doc["measured"]["device_window_s_per_step"] >= \
        doc["measured"]["named_s_per_step"] > 0
    with pytest.raises(MXNetError, match="unknown profiler config"):
        profiler.set_config(nonsense=1)
    with pytest.raises(MXNetError, match="needs a connected dist"):
        profiler.set_state("run", profile_process="server")


def test_server_directives_run_the_servers_profiler(tmp_path, capsys):
    """The directives a worker sends, applied as the server's poll loop
    applies them (in this process); a malformed one is reported and
    skipped."""
    import pickle
    from mxnet_tpu_torch.kvstore import dist
    path = str(tmp_path / "srv.json")
    for d in ({"cmd": "set_config", "kwargs": {"filename": path}},
              {"cmd": "set_state", "state": "run"}, {"cmd": "pause"},
              {"cmd": "resume"}, {"cmd": "noop"}):
        dist._apply_profiler_directive(pickle.dumps(d))
    assert profiler.is_running()
    dist._apply_profiler_directive(pickle.dumps({"cmd": "dump"}))
    names = [e["name"] for e in json.load(open(path))["traceEvents"]]
    assert names == ["server_profiler_cmd:set_state",
                     "server_profiler_cmd:resume",
                     "server_profiler_cmd:noop"]
    dist._apply_profiler_directive(b"not a pickle")
    assert "profiler command '?' failed" in capsys.readouterr().err
    trace = str(tmp_path / "srv_trace.json")
    with tmx.tracing.span("on_server", cat="comm"):
        pass
    dist._apply_profiler_directive(pickle.dumps(
        {"cmd": "trace_dump", "path": trace}))
    assert "on_server" in {s["name"] for s in
                           tmx.tracing.export.load_trace(trace)["spans"]}


# -- the Monitor --------------------------------------------------------------
def _bound_stats(mx, monitor_all=False, sort=False):
    """``Monitor.toc()`` after one forward of a FullyConnected + ReLU
    bound on given arrays (tests/test_custom_monitor.py's graph)."""
    rs = np.random.RandomState(0)
    args = {"data": rs.normal(size=(2, 3)), "fc_weight": rs.normal(
        size=(4, 3)), "fc_bias": rs.normal(size=(4,))}
    with oh.scope(mx):
        d = mx.sym.var("data")
        out = mx.sym.Activation(
            mx.sym.FullyConnected(d, name="fc", num_hidden=4),
            name="relu", act_type="relu")
        ex = out.bind(mx.cpu() if mx is tmx else None,
                      args={k: mx.nd.array(v.astype(np.float32))
                            for k, v in args.items()}, grad_req="null")
        mon = mx.Monitor(interval=1, pattern=".*", sort=sort,
                         monitor_all=monitor_all)
        mon.install(ex)
        mon.tic()
        ex.forward()
        return mon.toc()


def _same_stats(mine, theirs):
    assert [(s, n) for s, n, _ in mine] == [(s, n) for s, n, _ in theirs]
    for (_, name, a), (_, _, b) in zip(mine, theirs):
        np.testing.assert_allclose(
            np.array(a.strip("[]").split(), np.float64),
            np.array(b.strip("[]").split(), np.float64), rtol=1e-5,
            err_msg=name)


@pytest.mark.parametrize("monitor_all,sort", [(False, False), (True, True)])
def test_monitor_stats_equal_the_jax_monitors(monitor_all, sort):
    mine = _bound_stats(tmx, monitor_all, sort)
    _same_stats(mine, _bound_stats(jmx, monitor_all, sort))
    names = [n for _, n, _ in mine]
    assert "fc_output" in names and "relu_output" in names
    assert ("data_input" in names) == monitor_all


class _Recording:
    """A Monitor of ``mx`` whose ``toc_print`` keeps what it would log."""

    def __init__(self, mx):
        class Rec(mx.Monitor):
            def toc_print(self):
                self.seen.extend(self.toc())
        self.monitor = Rec(interval=1)
        self.monitor.seen = []


def _small_convnet(mx):
    # every node named: the generated names follow each package's
    # counters, which depend on what the process built before
    d = mx.sym.var("data")
    d = mx.sym.Activation(mx.sym.Convolution(
        d, name="conv1", kernel=(3, 3), num_filter=4), name="act1",
        act_type="tanh")
    d = mx.sym.Pooling(d, name="pool1", pool_type="max", kernel=(2, 2),
                       stride=(2, 2))
    d = mx.sym.FullyConnected(mx.sym.Flatten(d, name="flat1"), name="fc1",
                              num_hidden=5)
    return mx.sym.SoftmaxOutput(d, name="softmax")


def _fit_stats(mx, contexts=None):
    """The Monitor's statistics over 2 batches of ``Module.fit`` from the
    same numpy parameters."""
    rs = np.random.RandomState(1)
    x = rs.normal(size=(16, 1, 8, 8)).astype(np.float32)
    y = rs.randint(0, 5, (16,)).astype(np.float32)
    params = {"conv1_weight": rs.normal(0, .3, (4, 1, 3, 3)),
              "conv1_bias": np.zeros(4), "fc1_weight": rs.normal(
                  0, .3, (5, 36)), "fc1_bias": np.zeros(5)}
    rec = _Recording(mx)
    with oh.scope(mx):
        it = mx.io.NDArrayIter(x, y, batch_size=8,
                               label_name="softmax_label")
        mod = mx.mod.Module(_small_convnet(mx),
                            context=contexts or mx.cpu())
        mod.fit(it, num_epoch=1, monitor=rec.monitor,
                arg_params={k: mx.nd.array(v.astype(np.float32))
                            for k, v in params.items()},
                optimizer_params={"learning_rate": 0.1})
    return rec.monitor.seen


def test_monitor_through_module_fit_equals_the_jax_monitors():
    mine = _fit_stats(tmx)
    _same_stats(mine, _fit_stats(jmx))
    assert sorted({s for s, _, _ in mine}) == [1, 2]


def test_monitor_over_a_dp_mesh_equals_the_jax_monitors():
    """Over two contexts each statistic is the whole batch's, as the JAX
    executor's global arrays give it."""
    mine = _fit_stats(tmx, [tmx.cpu(0), tmx.cpu(1)])
    _same_stats(mine, _fit_stats(jmx, [jmx.tpu(0), jmx.tpu(1)]))


def test_monitor_reads_nothing_before_toc():
    with tmx.cpu():
        ex = oh.softmax_net(tmx).simple_bind(tmx.cpu(), data=(4, 8),
                                             softmax_label=(4,))
        mon = tmx.Monitor(interval=1)
        mon.install(ex)
        mon.tic()
        with oh.SyncCounter() as sc:
            ex.forward(is_train=True)
            ex.backward()
        assert sc.count == 0 and mon.queue
        assert all(isinstance(s._data, torch.Tensor)
                   for _, _, s in mon.queue)
        assert len(mon.toc()) == len(ex._symbol.get_internals()._outputs)
        mon.tic()           # interval 1: collecting again
        ex.set_monitor_callback(None)
        ex.forward()
        assert mon.toc() == []


# -- the launcher job ---------------------------------------------------------
def test_dist_job_profiler_directives_and_wire_context(job):
    proc, out, t0 = job
    try:
        log, _ = proc.communicate(
            timeout=max(1.0, JOB_TIMEOUT_S - (time.monotonic() - t0)))
    except subprocess.TimeoutExpired:
        proc.kill()
        pytest.fail(f"job over {JOB_TIMEOUT_S} s:\n{proc.communicate()[0]}")
    assert proc.returncode == 0, log
    # the processes share the pipe: a line may start inside another's
    infos = {}
    for m in re.finditer(r"\[worker (\d)\] OK ", log):
        infos[int(m.group(1))] = json.JSONDecoder().raw_decode(
            log, m.end())[0]
    assert sorted(infos) == [0, 1] and infos[0] == infos[1], log
    # two rounds of SGD(0.5) over the summed pushes (1 + 2) from zeros
    np.testing.assert_allclose(infos[0]["weights"], [-3.0] * 8)
    before = json.load(open(os.path.join(out, "server_metrics_before.json")))
    assert "mx_server_updates_total" not in before["metrics"]
    metrics = json.load(open(os.path.join(out, "server_metrics.json")))
    updates = metrics["metrics"]["mx_server_updates_total"]["series"]
    assert [(s["labels"], s["value"]) for s in updates] == \
        [({"key": "0"}, float(JOB_STEPS))]
    prof = json.load(open(os.path.join(out, "server_profile.json")))
    names = [e["name"] for e in prof["traceEvents"]]
    assert names.count("server_update:key0") == JOB_STEPS
    assert "server_profiler_cmd:set_state" in names
    docs = {r: tmx.tracing.export.load_trace(
        os.path.join(out, f"trace.{r}.json"))
        for r in ("worker0", "worker1", "server0")}
    pushes = {s["span"]: s for r in ("worker0", "worker1")
              for s in docs[r]["spans"] if s["name"] == "kv.push"}
    assert len(pushes) == 2 * JOB_STEPS
    server = docs["server0"]["spans"]
    recv = [s for s in server if s["name"] == "server_recv:push"]
    assert sorted(s["parent"] for s in recv) == sorted(pushes)
    assert all(s["trace"] == pushes[s["parent"]]["trace"] for s in recv)
    upd = [s for s in server if s["name"] == "server_update"]
    assert len(upd) == JOB_STEPS and all(s["parent"] in pushes
                                         for s in upd)
    merged = os.path.join(out, "merged.json")
    run = subprocess.run(
        [sys.executable, TRACE_MERGE, *[os.path.join(out, f"trace.{r}.json")
                                        for r in docs], "-o", merged],
        capture_output=True, text=True, timeout=60)
    assert run.returncode == 0, run.stdout + run.stderr
    assert json.load(open(merged))["traceEvents"]
