"""The port's tracing plane (``mxnet_tpu_torch.tracing``) against the JAX
package's (tests/test_tracing.py): span nesting, propagation across
threads, sampling, the span trees of the same flows (a gluon Trainer
step, the executor, ``Module.fit``, ``Module.fit`` over a dp 2 mesh and
``Gateway.generate`` on a tiny decoder), which equal the JAX package's
in names, cats, parent links and attributes other than times; the
kvstore wire (a traced push's ``server_recv`` child on the port's
transport, in process, through ``tools/trace_merge.py``); the exports
(trace files, the chrome merge, ``tools/telemetry_dump.py --trace``);
and the flight recorder (its watchdog dumps on a stall, under a 30 s
SIGALRM deadline and with no fixed sleep; its SIGTERM handler chains to
and restores the one it replaced, the JAX package's included).
"""
import torch_test_env  # noqa: F401  (first: one torch thread a process)

import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time

import jax
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import _native, tracing
from mxnet_tpu_torch.kvstore import dist
from mxnet_tpu_torch.tracing import export as texp
from mxnet_tpu_torch.tracing import flight

import observability_harness as oh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRACE_MERGE = os.path.join(REPO, "tools", "trace_merge.py")
TELEMETRY_DUMP = os.path.join(REPO, "tools", "telemetry_dump.py")
DEADLINE_S = 30



@pytest.fixture(autouse=True)
def _trace_isolation():
    oh.reset_both()
    yield
    flight.disarm()
    oh.reset_both()


@pytest.fixture
def deadline():
    """A SIGALRM deadline for tests that wait on threads or processes."""
    def expire(signum, frame):
        raise TimeoutError(f"test over its {DEADLINE_S} s deadline")
    prev = signal.signal(signal.SIGALRM, expire)
    signal.alarm(DEADLINE_S)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, prev)


# -- span core --------------------------------------------------------------
def test_span_nesting_and_parenting():
    with tracing.span("outer", cat="step", step=3) as o:
        assert o.trace_id != 0 and o.span_id != 0
        assert tracing.current() is o
        with tracing.span("inner", cat="io") as i:
            assert i.trace_id == o.trace_id
            assert i.parent_id == o.span_id
    assert tracing.current() is None
    spans = {s["name"]: s for s in tracing.spans_snapshot()}
    assert spans["inner"]["parent"] == spans["outer"]["span"]
    assert spans["outer"]["parent"] is None
    assert spans["outer"]["attrs"]["step"] == 3
    assert spans["outer"]["start_ns"] <= spans["inner"]["start_ns"]
    assert (spans["inner"]["start_ns"] + spans["inner"]["dur_ns"]
            <= spans["outer"]["start_ns"] + spans["outer"]["dur_ns"])


def test_span_parenting_across_threads():
    got = {}

    def worker(ctx):
        with tracing.span_at(ctx, "child_on_thread") as c:
            got["trace"], got["parent"] = c.trace_id, c.parent_id

    with tracing.span("root") as r:
        t = threading.Thread(target=worker, args=(tracing.context(),))
        t.start()
        t.join()
    assert got == {"trace": r.trace_id, "parent": r.span_id}
    by_name = {s["name"]: s for s in tracing.spans_snapshot()}
    assert by_name["child_on_thread"]["tid"] != by_name["root"]["tid"]


def test_traced_decorator_and_error_attr():
    @tracing.traced(name="boom", cat="compute")
    def boom():
        raise ValueError("x")

    with pytest.raises(ValueError):
        boom()
    (s,) = [s for s in tracing.spans_snapshot() if s["name"] == "boom"]
    assert s["attrs"]["error"] == "ValueError"


def test_sampling_zero_records_nothing():
    tracing.set_sample(0.0)
    assert not tracing.enabled()
    with tracing.span("invisible") as s:
        assert s.trace_id == 0 and s.span_id == 0
        assert tracing.current() is None
    assert tracing.record_span("also_invisible", 1, 0, 0, 1) == 0
    assert tracing.new_context() == (0, 0)
    assert tracing.spans_snapshot() == []


def test_sampling_decision_inherited_by_children(monkeypatch):
    tracing.set_sample(0.5)
    monkeypatch.setattr(tracing._rng, "random", lambda: 0.99)   # lose
    with tracing.span("root") as r:
        assert r.trace_id == 0
        with tracing.span("child") as c:
            assert c is tracing.NOOP
    assert tracing.spans_snapshot() == []
    monkeypatch.setattr(tracing._rng, "random", lambda: 0.0)    # win
    with tracing.span("root2") as r2:
        with tracing.span("child2") as c2:
            assert c2.trace_id == r2.trace_id != 0
    assert {"root2", "child2"} <= {s["name"]
                                   for s in tracing.spans_snapshot()}


def test_span_durations_feed_telemetry_histogram():
    with tracing.span("seam_span", cat="comm"):
        pass
    with tracing.span("user_span_no_cat"):
        pass
    fam = tmx.telemetry.registry().find("mx_span_seconds")
    series = {s.labels["name"]: s for s in fam.series()}
    assert series["seam_span"].count >= 1
    assert "user_span_no_cat" not in series


# -- the flows' span trees against the JAX package ----------------------------
def _tree(mx, flow):
    oh.reset(mx)
    flow(mx)
    spans = mx.tracing.spans_snapshot()
    return oh.span_tree(spans), spans


@pytest.mark.parametrize("flow", [oh.trainer_flow, oh.executor_flow,
                                  oh.module_fit],
                         ids=["trainer", "executor", "module_fit"])
def test_flow_span_tree_equals_the_jax_packages(flow):
    mine, spans = _tree(tmx, flow)
    theirs, _ = _tree(jmx, flow)
    assert mine == theirs
    assert mine, "the flow recorded no span"
    assert len({s["tid"] for s in spans}) == 1


def test_dp_mesh_module_span_tree_equals_the_jax_packages():
    """``Module.fit`` over two contexts: the port's dp mesh (a thread a
    position) records the JAX package's tree (its mesh is one program),
    with no orphan roots."""
    def flow(mx):
        ctxs = [mx.cpu(0), mx.cpu(1)] if mx is tmx \
            else [mx.tpu(0), mx.tpu(1)]
        oh.module_fit(mx, contexts=ctxs, epochs=1)
    mine, spans = _tree(tmx, flow)
    theirs, _ = _tree(jmx, flow)
    assert mine == theirs
    # every root is one of the loop's own seams: nothing a position
    # thread recorded lost its parent
    assert {s["name"] for s in oh.roots(spans)} == {
        "data_next", "executor_forward", "executor_backward"}


def test_spans_in_mesh_positions_are_children_of_the_caller():
    """A span opened inside a shard_map'd function (on a position's own
    thread) is a child of the caller's span, never an orphan root."""
    from mxnet_tpu_torch import parallel as par
    mesh = par.create_mesh({"dp": 2}, devices=["cpu", "cpu"])
    try:
        def body(x):
            with tracing.span("in_position", cat="compute"):
                return x * 2

        with tmx.cpu():
            f = par.shard_map(body, mesh, in_specs=(par.PartitionSpec("dp"),),
                              out_specs=par.PartitionSpec("dp"))
            with tracing.span("caller", cat="step") as caller:
                f(torch.arange(4, dtype=torch.float32))
    finally:
        mesh.close()
    spans = tracing.spans_snapshot()
    inner = [s for s in spans if s["name"] == "in_position"]
    assert len(inner) == 2
    assert {s["parent"] for s in inner} == {caller.span_id}
    assert {s["trace"] for s in inner} == {caller.trace_id}
    assert len({s["tid"] for s in inner}) == 2
    assert [s["name"] for s in oh.roots(spans)] == ["caller"]


VOCAB = 50
CFG = dict(vocab_size=VOCAB, d_model=32, num_layers=2, num_heads=4,
           max_prompt_tokens=12)
PROMPTS = ([5, 9, 13], [7, 1, 2, 3, 4, 8, 11])


def _generate_spans(mx):
    """Each prompt through ``Gateway.generate`` (one at a time, so the
    queue causes are deterministic) under a client span."""
    if mx is jmx:
        from mxnet_tpu.serving import Gateway
        from mxnet_tpu.serving.generate import GenerativeDecoder
        jmx.random.seed(0)
        dec = GenerativeDecoder(**CFG)
        dec.block.hybridize()
        _generate_spans.tree = jax.tree_util.tree_map(
            np.asarray, dec.param_tree())
        gw = Gateway()
    else:
        from mxnet_tpu_torch.serving import Gateway
        from mxnet_tpu_torch.serving.generate import (GenerativeDecoder,
                                                      params_from_jax)
        dec = GenerativeDecoder(**CFG, device="cpu")
        dec.load_state_dict(params_from_jax(_generate_spans.tree))
        gw = Gateway(device="cpu")
    try:
        gw.register_generator("lm", dec, block_tokens=4, max_blocks=64,
                              max_new_tokens=6, max_decode_batch=4)
        oh.reset(mx)
        tokens = []
        for p in PROMPTS:
            with mx.tracing.span("client", cat="app"):
                tokens.append(gw.generate("lm", p, max_new_tokens=6))
        out = mx.tracing.spans_snapshot()
    finally:
        gw.close()
    return tokens, out


def test_generate_span_tree_equals_the_jax_packages():
    theirs_tokens, theirs = _generate_spans(jmx)
    mine_tokens, mine = _generate_spans(tmx)
    assert [list(t) for t in mine_tokens] == \
        [list(t) for t in theirs_tokens]

    def tree(spans):
        # the lanes record on their own thread: order each request's
        # subtree by its client span
        return sorted(oh.span_tree(spans), key=repr)
    assert tree(mine) == tree(theirs)
    names = [s["name"] for s in mine]
    assert names.count("serving.generate") == len(PROMPTS)
    assert names.count("generate.prefill") == len(PROMPTS)
    assert names.count("generate.token") == \
        sum(len(t) for t in mine_tokens)
    by_id = {s["span"]: s for s in mine}
    for s in mine:
        if s["name"] == "serving.generate":
            assert by_id[s["parent"]]["name"] == "client"
    reg = tmx.telemetry.registry()
    assert {phase: reg.value("mx_serving_generate_tokens_total",
                             model="lm", phase=phase)
            for phase in ("prefill", "decode")} == {
        "prefill": sum(len(p) for p in PROMPTS),
        "decode": sum(len(t) for t in mine_tokens) - len(PROMPTS)}


# -- the kvstore wire -----------------------------------------------------------
def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_kvstore_wire_propagation_through_trace_merge(tmp_path, deadline):
    """Two ranked worker connections against the port's transport in
    process: each traced push has a ``server_recv:push`` child with its
    trace id, nested after tools/trace_merge.py's clock alignment; the
    server's updater parents ``server_update`` to the push that
    completed the round."""
    from mxnet_tpu_torch.tracing import wire
    lib = _native.load_comm()
    lib.mxtpu_server_shutdown()
    port = _free_port()
    updates = []

    def updater(key, recved, stored, n):
        ctx = wire.server_parent_ctx(lib)
        with tracing.span_at(ctx, "server_update", cat="comm", key=key,
                             role="server"):
            updates.append(ctx)

    _native.set_server_updater(updater)
    assert lib.mxtpu_server_start(port, 2) == 0
    wire.install_server_sink(lib)
    conns = []
    try:
        conns = [dist.WorkerConnection("127.0.0.1", port)
                 for _ in range(2)]
        assert sorted(c.rank for c in conns) == [0, 1]
        conns[0].set_sync_mode(True)
        conns[0].init(0, np.zeros(8, np.float32))
        for c in conns:
            c.trace_clock_sync(2)

        def work(c):
            for step_n in range(2):
                with tracing.span("step", cat="step", step=step_n,
                                  rank=c.rank):
                    c.push(0, np.full(8, 1.0 + c.rank, np.float32))
                    c.pull(0, (8,))

        ts = [threading.Thread(target=work, args=(c,)) for c in conns]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
    finally:
        for c in conns:
            c.close()
        lib.mxtpu_server_shutdown()

    spans = tracing.drain()
    server = [s for s in spans if (s["attrs"] or {}).get("role") == "server"]
    workers = {}
    for s in spans:
        rank = (s["attrs"] or {}).get("rank")
        if s not in server and rank is not None:
            workers.setdefault(int(rank), []).append(s)
    assert set(workers) == {0, 1} and server
    assert updates and all(ctx[0] for ctx in updates)
    paths = []
    for r, ws in sorted(workers.items()):
        p = str(tmp_path / f"trace.worker{r}.json")
        texp.write_trace(p, spans=ws, meta={"role": "worker", "rank": r})
        paths.append(p)
    p = str(tmp_path / "trace.server0.json")
    texp.write_trace(p, spans=server, meta={"role": "server", "rank": 0})
    paths.append(p)
    merged_path = str(tmp_path / "merged.json")
    proc = subprocess.run(
        [sys.executable, TRACE_MERGE, *paths, "-o", merged_path,
         "--report"], capture_output=True, text=True, timeout=60)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    # one host, one CLOCK_MONOTONIC: each server receive starts inside
    # the worker push that sent it (its end is stamped after the reply
    # went out, so it may close after the worker's span)
    raw = {s["span"]: s for ws in workers.values() for s in ws
           if s["name"] == "kv.push"}
    recv = [s for s in server if s["name"] == "server_recv:push"]
    assert sorted(s["parent"] for s in recv) == sorted(raw)
    for r in recv:
        push = raw[r["parent"]]
        assert r["trace"] == push["trace"]
        assert push["start_ns"] <= r["start_ns"] <= \
            push["start_ns"] + push["dur_ns"]
    # the merged document keeps the links (its clock alignment is the
    # tool's, tested with the JAX package)
    events = [e for e in json.load(open(merged_path))["traceEvents"]
              if e.get("ph") == "X"]
    pushes = {e["args"]["span"]: e for e in events if e["name"] == "kv.push"}
    kids = [e for e in events if e["name"] == "server_recv:push"
            and e["args"].get("parent") in pushes]
    assert len(pushes) == len(kids) == 4
    assert all(k["args"]["trace"] == pushes[k["args"]["parent"]]["args"][
        "trace"] for k in kids)
    upd = [e for e in events if e["name"] == "server_update"]
    assert len(upd) == 2
    assert all(e["args"]["parent"] in pushes for e in upd)


# -- exports --------------------------------------------------------------------
def test_write_trace_roundtrip_and_dump_tool(tmp_path):
    with tracing.span("step", cat="step", step=0):
        with tracing.span("kvstore_push", cat="comm"):
            pass
    p = str(tmp_path / "t.json")
    doc = texp.write_trace(p, spans=tracing.drain(),
                           meta={"role": "worker", "rank": 0})
    assert doc["version"] == 1 and doc["meta"]["role"] == "worker"
    assert [s["name"] for s in texp.load_trace(p)["spans"]] == \
        [s["name"] for s in doc["spans"]]
    proc = subprocess.run([sys.executable, TELEMETRY_DUMP, "--trace", p],
                          capture_output=True, text=True, timeout=60)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "kvstore_push" in proc.stdout and "self=" in proc.stdout


def test_chrome_merge_includes_spans_and_profiler_events():
    from mxnet_tpu_torch import profiler
    profiler.set_state("run")
    try:
        with profiler.timed_region("clockpair_prof"):
            pass
        with tracing.span("clockpair_span", cat="compute"):
            pass
    finally:
        profiler.set_state("stop")
    trace = tmx.telemetry.export.merge_chrome_trace()
    ts = {e["name"]: e["ts"] for e in trace["traceEvents"]
          if e.get("name") in ("clockpair_prof", "clockpair_span")}
    assert set(ts) == {"clockpair_prof", "clockpair_span"}
    assert abs(ts["clockpair_span"] - ts["clockpair_prof"]) < 1_000_000
    with profiler._lock:
        profiler._events.clear()


# -- the flight recorder ----------------------------------------------------
def test_flight_watchdog_dumps_on_a_stall(tmp_path, deadline):
    dump_path = str(tmp_path / "flight.json")
    opened, release = threading.Event(), threading.Event()

    def stuck_worker():
        with tracing.span("wedged_call", cat="comm", stage="dial"):
            opened.set()
            release.wait()

    t = threading.Thread(target=stuck_worker, daemon=True)
    t.start()
    opened.wait()
    fired = threading.Event()
    w = flight.arm(0.3, path=dump_path, on_fire=lambda doc: fired.set())
    try:
        fired.wait()
        doc = json.load(open(dump_path))
        assert "hang: no span activity" in doc["reason"]
        in_flight = [sp for th in doc["threads"] for sp in th["in_flight"]]
        (sp,) = [s for s in in_flight if s["name"] == "wedged_call"]
        assert sp["attrs"]["stage"] == "dial" and sp["open_ms"] >= 300
        assert any("stuck_worker" in v for v in doc["stacks"].values())
        assert w.fired == 1
        # activity re-arms it: the next stall dumps again
        refired = threading.Event()
        w.on_fire = lambda doc: refired.set()
        with tracing.span("progress"):
            pass
        refired.wait()
        assert w.fired == 2
    finally:
        release.set()
        flight.disarm()
        t.join()


def test_watchdog_refuses_when_tracing_disabled(capsys):
    tracing.set_sample(0.0)
    assert flight.arm(0.05) is None
    assert "NOT armed" in capsys.readouterr().err


def test_flight_dump_with_rings_lock_held(capsys):
    with tracing.span("held"):
        assert tracing._rings_lock.acquire(timeout=1)
        try:
            doc = flight.dump("signal-under-lock", path=None)
        finally:
            tracing._rings_lock.release()
    assert doc["reason"] == "signal-under-lock"
    assert any(s["name"] == "held"
               for t in doc["threads"] for s in t["in_flight"])
    assert "MXTPU FLIGHT RECORDER (signal-under-lock)" in \
        capsys.readouterr().err


def test_flight_sigterm_chains_and_restores_the_jax_recorder(capsys):
    """Both packages' recorders installed in one process, in either
    order: a SIGTERM runs both dumps, then the handler the test found.
    Uninstalling the port's restores the handler under it when the
    port's is on top; under the JAX package's, the port's stays in the
    chain (installed) and the signal still reaches the test's handler."""
    from mxnet_tpu.tracing import flight as jflight
    found = signal.getsignal(signal.SIGTERM)
    found_hook = sys.excepthook
    got = []

    def reset_jax():
        jflight._installed[0] = False
        jflight._prev_sigterm[0] = None

    try:
        for port_on_top in (True, False):
            signal.signal(signal.SIGTERM, lambda s, f: got.append(s))
            first, second = (jflight, flight) if port_on_top \
                else (flight, jflight)
            first.install(excepthook=False, watchdog=False)
            second.install(excepthook=False, watchdog=False)
            assert signal.getsignal(signal.SIGTERM) is second._on_sigterm
            os.kill(os.getpid(), signal.SIGTERM)
            assert got == [signal.SIGTERM]
            err = capsys.readouterr().err
            assert err.count("MXTPU FLIGHT RECORDER (SIGTERM)") == 2
            flight.uninstall()
            if port_on_top:
                assert signal.getsignal(signal.SIGTERM) is \
                    jflight._on_sigterm
                assert not flight._installed[0]
            else:
                assert signal.getsignal(signal.SIGTERM) is \
                    jflight._on_sigterm
                assert flight._installed[0]     # still chained
                os.kill(os.getpid(), signal.SIGTERM)
                assert got == [signal.SIGTERM] * 2
                capsys.readouterr()
                # once the JAX recorder is off the top, it restores
                signal.signal(signal.SIGTERM, flight._on_sigterm)
                flight.uninstall()
                assert not flight._installed[0]
            got.clear()
            reset_jax()
    finally:
        flight.uninstall()
        signal.signal(signal.SIGTERM, found)
        reset_jax()
        sys.excepthook = found_hook
