"""The port's metrics plane (``mxnet_tpu_torch.telemetry``) against the
JAX package's (tests/test_telemetry.py): registry semantics, the lazy
device-scalar window, the exports (JSON, Prometheus text byte-equal to
the JAX package's for registries filled alike, the chrome-trace merge,
snapshot diff, the server pull through the profiler directive channel,
the flusher, tools/telemetry_dump.py over the port's dumps), and the
family schema and event counters of the same small flows (a gluon
Trainer over a local KVStore fed by an NDArrayIter, ``Module.fit``),
which equal the JAX package's but for the families
``observability_harness.EXCLUDED_FAMILIES`` names, each with its reason.
The disabled plane records nothing, and the instrumentation adds no
host read of a tensor: the counted ``Tensor.item`` / ``tolist`` / ``cpu``
and ``torch.cuda.synchronize`` calls of a flow are the same with the
planes on and off.
"""
import torch_test_env  # noqa: F401  (first: one torch thread a process)

import json
import os
import pickle
import subprocess
import sys
import threading
import time

import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import telemetry
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.telemetry import export, metrics, step

import observability_harness as oh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TELEMETRY_DUMP = os.path.join(REPO, "tools", "telemetry_dump.py")



@pytest.fixture(autouse=True)
def _clean_state():
    """Each test sees both packages' planes on and empty, and leaves them
    so (a step interval left open would be charged to the next file's
    first step)."""
    oh.reset_both()
    yield
    oh.reset_both()


# -- registry semantics -----------------------------------------------------
def test_counter_labels_and_value():
    reg = metrics.registry()
    c = reg.counter("tt_requests_total", "test", labelnames=("code",))
    c.labels(code="200").inc()
    c.labels(code="200").inc(2)
    c.labels(code="500").inc()
    assert c.labels(code="200").value == 3
    assert c.labels(code="500").value == 1
    with pytest.raises(ValueError):
        c.labels(verb="GET")              # wrong label set
    with pytest.raises(ValueError):
        reg.gauge("tt_requests_total")    # kind mismatch
    with pytest.raises(ValueError):
        reg.counter("tt_requests_total", labelnames=("other",))
    with pytest.raises(ValueError):
        c.inc()                           # labeled: no default series


def test_gauge_set_max_high_water():
    g = metrics.registry().gauge("tt_depth")
    g.set(5)
    g.set_max(3)
    assert g.value == 5
    g.set_max(9)
    assert g.value == 9
    g.dec(2)
    assert g.value == 7


def test_histogram_buckets():
    h = metrics.registry().histogram("tt_latency", buckets=(0.01, 0.1, 1.0))
    for v in (0.005, 0.05, 0.5, 5.0):
        h.observe(v)
    s = h.labels()
    assert s.count == 4
    assert s.sum == pytest.approx(5.555)
    cum = {str(le): c for le, c in s.cumulative_buckets()}
    assert cum == {"0.01": 1, "0.1": 2, "1.0": 3, "+Inf": 4}


def test_histogram_bucket_mismatch_rejected():
    reg = metrics.registry()
    reg.histogram("tt_bm_seconds", buckets=(0.1, 1.0))
    reg.histogram("tt_bm_seconds", buckets=(1.0, 0.1))   # same set: ok
    with pytest.raises(ValueError, match="buckets"):
        reg.histogram("tt_bm_seconds", buckets=(0.5, 5.0))


def test_lazy_values_drain_at_read_not_at_record():
    """inc_lazy buffers tensors; the fold happens at read, once."""
    c = metrics.registry().counter("tt_lazy_total")
    for i in range(5):
        c.inc_lazy(torch.tensor(float(i)))
    assert c.labels()._pending             # still buffered
    assert c.value == 10.0                 # drained exactly once
    assert not c.labels()._pending
    g = metrics.registry().gauge("tt_lazy_gauge")
    g.set_lazy(torch.tensor(3.0))
    g.set_lazy(torch.tensor(4.0))
    assert g.value == 4.0
    h = metrics.registry().histogram("tt_lazy_hist", buckets=(1.0,))
    h.observe_lazy(torch.tensor(0.5))
    assert h.labels().count == 1


class _InFlight(metrics._Pending):
    """A CUDA scalar's pinned copy whose event has not completed (built
    without a card: only ``ready`` and ``float`` are read)."""

    def __init__(self, v):
        self.v = v
        self.landed = False

    def ready(self):
        return self.landed

    def __float__(self):
        return self.v


def test_lazy_window_folds_only_values_that_have_landed(monkeypatch):
    """Past the window the oldest entries fold while recording only once
    their copies have landed (Event.query): a value still in flight
    waits for the read instead of stalling the recording thread."""
    monkeypatch.setattr(metrics, "_lazy_entry", lambda v: v)
    c = metrics.registry().counter("tt_window_total").labels()
    first = _InFlight(100.0)
    c.inc_lazy(first)
    for _ in range(metrics._PENDING_WINDOW + 3):
        c.inc_lazy(1.0)
    # the oldest is in flight: nothing folded while recording
    assert len(c._pending) == metrics._PENDING_WINDOW + 4
    assert c._value == 0.0
    first.landed = True
    c.inc_lazy(1.0)
    # now the landed head and the host values behind it fold
    assert len(c._pending) == metrics._PENDING_WINDOW
    assert c._value == 100.0 + 4
    assert c.value == 100.0 + metrics._PENDING_WINDOW + 4


def test_registry_reset_zeroes_but_keeps_schema():
    reg = metrics.registry()
    c = reg.counter("tt_reset_total", labelnames=("k",))
    c.labels(k="a").inc(7)
    reg.reset()
    assert c.labels(k="a").value == 0
    assert reg.find("tt_reset_total") is c


def test_registry_counters_are_thread_safe():
    c = metrics.registry().counter("tt_mt_total")
    h = metrics.registry().histogram("tt_mt_seconds", buckets=(1.0,))
    n, t = 2000, 8

    def work():
        for _ in range(n):
            c.inc()
            h.observe(0.5)

    threads = [threading.Thread(target=work) for _ in range(t)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert c.value == n * t
    assert h.labels().count == n * t


# -- exports ----------------------------------------------------------------
def _fill(mod):
    """One registry of ``mod`` filled the same way in either package."""
    reg = mod.MetricRegistry()
    c = reg.counter("tp_requests_total", "requests\nby code",
                    labelnames=("code", "op"))
    c.labels(code="200", op='do"t').inc(2)
    c.labels(code="500", op="a\\b").inc(0.5)
    g = reg.gauge("tp_depth", "queue depth")
    g.set(3)
    g.set_max(7.25)
    h = reg.histogram("tp_seconds", "latency", labelnames=("stage",),
                      buckets=(0.001, 0.1, 1.0))
    for v in (0.0005, 0.05, 0.5, 2.0):
        h.labels(stage="e2e").observe(v)
    reg.counter("tp_big_total").inc(1e16)
    return reg


def test_prometheus_text_equals_the_jax_packages():
    from mxnet_tpu.telemetry import export as jexport
    from mxnet_tpu.telemetry import metrics as jmetrics
    mine = export.to_prometheus(_fill(metrics).snapshot())
    theirs = jexport.to_prometheus(_fill(jmetrics).snapshot())
    assert mine == theirs
    assert 'tp_requests_total{code="200",op="do\\"t"} 2' in mine
    assert 'tp_seconds_bucket{le="+Inf",stage="e2e"} 4' in mine
    assert "# HELP tp_requests_total requests by code" in mine


def test_snapshot_json_round_trip_and_diff(tmp_path):
    reg = metrics.registry()
    c = reg.counter("tt_a_total", "help a")
    c.inc(3)
    reg.histogram("tt_b_seconds", buckets=(0.1, 1.0)).observe(0.05)
    a = export.snapshot()
    back = export.from_json(export.to_json(a, indent=1))
    assert back["metrics"]["tt_a_total"]["series"][0]["value"] == 3
    assert back["metrics"]["tt_b_seconds"]["series"][0]["count"] == 1
    p = tmp_path / "snap.json"
    export.dump(str(p))
    assert export.from_json(p.read_text())["version"] == 1
    c.inc(4)
    d = export.diff(a, export.snapshot())
    assert d["tt_a_total"]["{}"] == {"before": 3, "after": 7, "delta": 4}
    with pytest.raises(MXNetError):
        export.from_json("{}")
    with pytest.raises(MXNetError):
        export.dump(str(p), fmt="xml")


def test_chrome_trace_merge_carries_both_halves():
    metrics.registry().counter("tt_m_total").inc(4)
    with tmx.tracing.span("merge_me", cat="io"):
        pass
    ev = [{"name": "opX", "cat": "operator", "ph": "X",
           "ts": 1.0, "dur": 2.0, "pid": 0, "tid": 0}]
    trace = export.merge_chrome_trace(events=ev)
    names = [e["name"] for e in trace["traceEvents"]]
    assert {"opX", "tt_m_total", "merge_me"} <= set(names)
    assert trace["metadata"]["telemetry"]["metrics"][
        "tt_m_total"]["series"][0]["value"] == 4
    tl = telemetry.timeline.Timeline(window=4)
    tl.tick()
    trace = export.merge_chrome_trace(events=[], timeline=tl.to_doc())
    assert trace["metadata"]["timeline"]["frames"] == 1
    json.dumps(trace)
    # the census and health tracks ride along, and a cost ledger's
    # ranked rows fold in as the attribution strip, as the JAX package
    # folds them
    trace = export.merge_chrome_trace(events=[], memory=True, health=True)
    assert {"memory", "health"} <= set(trace["metadata"])
    json.dumps(trace, allow_nan=False)
    led = tmx.profiling.from_fn(lambda x: (x * 2).sum(), torch.ones(8))
    trace = export.merge_chrome_trace(events=[], spans=[], attribution=led)
    strip = [e for e in trace["traceEvents"] if e.get("pid") == 90]
    assert strip[0]["args"]["name"] == "op attribution (per step)"
    assert [e["name"] for e in strip[1:]] == \
        [g["op"] for g in led["by_op"] if g["est_s"] > 0]
    assert trace["metadata"]["attribution"]["totals"] == led["totals"]
    json.dumps(trace, allow_nan=False)


def test_timeline_and_slo_burn():
    """The windowed queries and the burn rate over recorded frames, on a
    fake clock."""
    reg = metrics.registry()
    req = reg.counter("mx_serving_requests_total", "admitted inference "
                      "requests", labelnames=("model", "variant"))
    rej = reg.counter("mx_serving_rejected_total", "fast-rejected "
                      "requests at admission", labelnames=("model",
                                                           "reason"))
    tl = telemetry.timeline.Timeline(window=8)
    tl.tick(now=0.0)
    req.labels(model="m", variant="fp32").inc(100)
    rej.labels(model="m", reason="slo").inc(10)
    tl.tick(now=10.0)
    assert tl.rate("mx_serving_requests_total", model="m",
                   variant="fp32") == 10.0
    tracker = telemetry.slo.SLOTracker(
        objectives=[o for o in telemetry.slo.DEFAULT_OBJECTIVES
                    if o["kind"] == "ratio"], timeline=tl,
        fast_s=5.0, slow_s=10.0)
    # 10 % rejected against a 5 % budget: burning at twice the budget
    assert tracker.burn(now=10.0) == pytest.approx(2.0)


def test_server_metrics_snapshot_directive_and_pull(tmp_path):
    """The server side of pull_server_metrics (the directive writes this
    process's snapshot) and the worker side against a stand-in
    connection that runs the directive as the server's poll loop does."""
    from mxnet_tpu_torch.kvstore import dist
    metrics.registry().counter("tt_server_total").inc(11)
    p = tmp_path / "server_metrics.json"
    dist._apply_profiler_directive(pickle.dumps(
        {"cmd": "metrics_snapshot", "path": str(p)}))
    snap = export.from_json(p.read_text())
    assert snap["metrics"]["tt_server_total"]["series"][0]["value"] == 11

    class FakeConn:
        def send_profiler_command(self, directive):
            dist._apply_profiler_directive(pickle.dumps(directive))

    class FakeKV:
        _conn = FakeConn()

    got = export.pull_server_metrics(FakeKV(), str(tmp_path / "pulled.json"),
                                     timeout=5.0)
    assert got["metrics"]["tt_server_total"]["series"][0]["value"] == 11

    class DeafConn:
        def send_profiler_command(self, directive):
            pass

    with pytest.raises(MXNetError, match="did not appear"):
        export.pull_server_metrics(DeafConn(), str(tmp_path / "n.json"),
                                   timeout=0.2, poll=0.05)


def test_recovery_summary_reads_registry_counters():
    from mxnet_tpu_torch import profiler
    before = profiler.recovery_summary()
    profiler.note_recovery({"op": "push", "req_id": 1,
                            "outcome": "recovered", "attempts": 3,
                            "reconnects": 2, "backoff_wait_ms": 12.5})
    profiler.note_worker_resume({"step": 4, "path": "x"})
    profiler.note_checkpoint_rejected({"path": "y", "step": 3})
    after = profiler.recovery_summary()
    assert after["incidents"] == before["incidents"] + 3
    assert after["recovered"] == before["recovered"] + 1
    assert after["attempts"] == before["attempts"] + 3
    assert after["reconnects"] == before["reconnects"] + 2
    assert after["backoff_wait_ms"] == pytest.approx(
        before["backoff_wait_ms"] + 12.5)
    assert after["worker_resumes"] == before["worker_resumes"] + 1
    assert after["checkpoints_rejected"] == \
        before["checkpoints_rejected"] + 1
    assert after["last"]["path"] == "y"


def test_periodic_flusher_writes_snapshots(tmp_path):
    p = tmp_path / "flush.json"
    metrics.registry().counter("tt_flush_total").inc()
    done = threading.Event()
    telemetry.start_flusher(period=0.05, path=str(p), verbose=False)
    try:
        deadline = time.monotonic() + 5.0
        while not p.exists() and time.monotonic() < deadline:
            done.wait(0.02)
        assert "tt_flush_total" in export.from_json(p.read_text())["metrics"]
    finally:
        telemetry.stop_flusher()


def test_telemetry_dump_tool_reads_the_ports_dumps(tmp_path):
    c = metrics.registry().counter("tt_cli_total")
    c.inc(2)
    a, b = tmp_path / "a.json", tmp_path / "b.json"
    export.dump(str(a))
    c.inc(3)
    export.dump(str(b))
    runs = {args: subprocess.run(
        [sys.executable, TELEMETRY_DUMP, *args], cwd=REPO,
        capture_output=True, text=True, timeout=60)
        for args in ((str(b),), ("--diff", str(a), str(b)),
                     ("--prom", str(b)))}
    for args, out in runs.items():
        assert out.returncode == 0, (args, out.stderr)
        assert "tt_cli_total" in out.stdout
    assert "+3" in runs[("--diff", str(a), str(b))].stdout
    assert "# TYPE tt_cli_total counter" in runs[("--prom", str(b))].stdout


# -- compile attribution and device memory -----------------------------------
def test_kernel_builds_are_charged_to_the_op_in_scope():
    """A kernel build (``ops/_build.py``) counts under the op whose
    dispatch triggered it, an executor scope, or ``_unattributed``."""
    from mxnet_tpu_torch.ops.registry import OpDef

    def fn(x):
        telemetry.note_compile(0.5)
        return x
    OpDef("tt_building_op", fn)(torch.zeros(1))
    with telemetry.compile_scope("executor_forward"):
        telemetry.note_compile(0.25)
    telemetry.note_compile(0.25)
    fam = metrics.registry().find("mx_jit_compiles_total")
    got = {s.labels["op"]: s.value for s in fam.series() if s.value}
    assert got == {"tt_building_op": 1, "executor_forward": 1,
                   "_unattributed": 1}
    assert metrics.registry().value("mx_jit_compile_seconds_total") == 1.0


def test_device_memory_collector_reports_nothing_on_the_cpu():
    """No allocator statistics on the CPU: no card's series; the CPU's
    ``mx_device_mem_*`` series are the census's backfill, as in the JAX
    package (a tagged tensor's bytes under ``cpu:0``)."""
    from mxnet_tpu_torch.profiling import memory
    assert not torch.cuda.is_available()
    t = memory.tag_role(torch.ones(16, 16), "parameter")
    snap = export.snapshot()["metrics"]
    for name in ("mx_device_mem_peak_bytes", "mx_device_mem_bytes_in_use"):
        devices = {s["labels"]["device"] for s in snap[name]["series"]}
        assert devices and all(d.startswith("cpu:") for d in devices)
    assert telemetry._devices_with_stats[0] == frozenset()
    used = {s["labels"]["device"]: s["value"]
            for s in snap["mx_device_mem_bytes_in_use"]["series"]}
    assert used["cpu:0"] >= t.numel() * 4


# -- the flows against the JAX package ----------------------------------------
EVENTS = ("mx_op_dispatches_total", "mx_io_data_wait_seconds",
          "mx_kvstore_push_bytes_total", "mx_kvstore_pull_bytes_total",
          "mx_kvstore_push_seconds", "mx_kvstore_pull_seconds",
          "mx_steps_total", "mx_step_time_seconds", "mx_span_seconds")


@pytest.fixture(scope="module")
def flows():
    """Each package's snapshot after the Trainer flow and after
    ``Module.fit`` (each from an empty registry)."""
    out = {}
    for mx in (jmx, tmx):
        for name, flow in (("trainer", oh.trainer_flow),
                           ("module", oh.module_fit)):
            oh.reset(mx)
            flow(mx)
            out[mx.__name__, name] = mx.telemetry.snapshot()
    return out


@pytest.mark.parametrize("flow", ["trainer", "module"])
def test_flow_family_schema_equals_the_jax_packages(flows, flow):
    mine, theirs = oh.family_schemas(flows["mxnet_tpu_torch", flow],
                                     flows["mxnet_tpu", flow])
    assert mine == theirs
    assert "mx_steps_total" in mine and "mx_span_seconds" in mine


@pytest.mark.parametrize("flow", ["trainer", "module"])
def test_flow_event_counters_equal_the_jax_packages(flows, flow):
    mine = oh.event_counts(flows["mxnet_tpu_torch", flow], EVENTS)
    theirs = oh.event_counts(flows["mxnet_tpu", flow], EVENTS)
    assert mine == theirs
    source = "trainer" if flow == "trainer" else "module_fit"
    assert mine["mx_steps_total", (("source", source),)] >= 2


def test_step_breakdown_is_host_time():
    oh.trainer_flow(tmx)
    bd = step.last_breakdown()
    assert bd["source"] == "trainer"
    assert bd["step_time"] > 0 and bd["data_time"] >= 0
    assert bd["comm_time"] > 0 and bd["compile_time"] == 0


def test_failed_kvstore_call_records_no_bytes():
    with tmx.cpu():
        kv = tmx.kv.create("local")
        with pytest.raises(MXNetError):
            kv.push("never_initialized", tmx.nd.ones((4,)))
    fam = export.snapshot()["metrics"].get(
        "mx_kvstore_push_bytes_total", {"series": []})
    assert not any(s["labels"].get("key") == "never_initialized"
                   for s in fam["series"])


def test_disabled_planes_record_nothing():
    """With telemetry and tracing off, and the census off too
    (``MXTPU_MEMORY_CENSUS=0``: the census is a pull collector with its
    own gate, as in the JAX package), nothing is recorded; with the
    census on, its families are the only ones that report."""
    from mxnet_tpu_torch.profiling import memory
    metrics.set_enabled(False)
    tmx.tracing.set_sample(0.0)
    memory.set_census_enabled(False)
    try:
        oh.trainer_flow(tmx)
        oh.module_fit(tmx, epochs=1)
        snap = export.snapshot()["metrics"]
    finally:
        memory.set_census_enabled(True)
    for name, fam in snap.items():
        assert sum(s.get("value", s.get("count", 0))
                   for s in fam["series"]) == 0, name
    assert tmx.tracing.spans_snapshot() == []
    assert step.step_boundary() is None
    oh.trainer_flow(tmx)
    census = ("mx_memory_live_bytes", "mx_memory_live_arrays",
              "mx_device_mem_bytes_in_use", "mx_device_mem_peak_bytes")
    for name, fam in export.snapshot()["metrics"].items():
        if name not in census:
            assert sum(s.get("value", s.get("count", 0))
                       for s in fam["series"]) == 0, name


def test_planes_add_no_host_reads():
    """The flows' counted item / tolist / cpu / synchronize calls are the
    same with the planes on (telemetry, sample 1) and off
    (MXTPU_TELEMETRY=0, sample 0)."""
    counts = {}
    for on in (True, False):
        oh.reset(tmx)
        metrics.set_enabled(on)
        tmx.tracing.set_sample(1.0 if on else 0.0)
        with oh.SyncCounter() as sc:
            oh.trainer_flow(tmx)
            oh.module_fit(tmx, epochs=1)
        counts[on] = sc.count
    assert counts[True] == counts[False]
