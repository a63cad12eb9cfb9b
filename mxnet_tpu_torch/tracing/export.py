"""Trace-file export and load, and the chrome-trace conversion (the port
of ``mxnet_tpu/tracing/export.py``, in the same file format, so
``tools/trace_merge.py`` reads the port's files unchanged).

One process writes one trace file; ``tools/trace_merge.py`` stitches the
per-rank files of a distributed job into one Perfetto timeline with
clock alignment and a straggler report.

File format (versioned, plain JSON)::

    {"version": 1,
     "clock": "monotonic_ns",           # absolute CLOCK_MONOTONIC
     "meta": {"pid": ..., "role": "worker", "rank": 0,
              "epoch_ns": <process epoch for profiler-relative ts>},
     "spans": [{"name", "cat", "trace", "span", "parent",
                "start_ns", "dur_ns", "tid", "thread", "attrs"}, ...]}

The wire format this pairs with (``_native/comm.cc``): every kvstore
request header carries ``u64 trace_id | u64 span_id`` after the fixed
fields; 0 means untraced.
"""
from __future__ import annotations

import json
import os
import time

from ..base import MXNetError
from . import clock

TRACE_VERSION = 1


def default_path():
    """MXTPU_TRACE_FILE, or trace.<role><rank>.json inside a launcher job
    (its processes share a cwd), else trace.json."""
    path = os.environ.get("MXTPU_TRACE_FILE")
    if path:
        return path
    role = os.environ.get("DMLC_ROLE")
    if role is None:
        return "trace.json"
    idx = os.environ.get("DMLC_SERVER_ID" if role == "server"
                         else "DMLC_WORKER_ID", "0")
    return "trace.%s%s.json" % (role, idx)


def _proc_meta():
    meta = {"pid": os.getpid(), "epoch_ns": clock.EPOCH_NS}
    role = os.environ.get("DMLC_ROLE")
    if role is not None:
        meta["role"] = role
        meta["rank"] = int(os.environ.get(
            "DMLC_SERVER_ID" if role == "server" else "DMLC_WORKER_ID",
            "0"))
    return meta


def trace_doc(spans=None, meta=None):
    from . import spans_snapshot
    doc = {"version": TRACE_VERSION, "clock": "monotonic_ns",
           "meta": _proc_meta(),
           "spans": spans if spans is not None else spans_snapshot()}
    if meta:
        doc["meta"].update(meta)
    return doc


def write_trace(path=None, spans=None, meta=None):
    """Write the process's recorded spans to ``path`` (atomically:
    tmp + rename). Returns the document."""
    path = path or default_path()
    doc = trace_doc(spans, meta)
    tmp = "%s.tmp.%d" % (path, os.getpid())
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(doc, f)
    os.replace(tmp, path)
    return doc


def load_trace(path):
    with open(path, "r", encoding="utf-8") as f:
        doc = json.load(f)
    if not isinstance(doc, dict) or "spans" not in doc:
        raise MXNetError("%s is not a trace file (no 'spans' key)" % path)
    if doc.get("version", 0) > TRACE_VERSION:
        raise MXNetError(
            "trace file %s is version %s, this build reads <= %d"
            % (path, doc.get("version"), TRACE_VERSION))
    return doc


_pull_nonce = [0]


def pull_server_trace(kv, path, timeout=10.0, poll=0.05):
    """Fetch a kvstore server process's trace file through the profiler
    directive channel (``{"cmd": "trace_dump"}``; the path must be
    visible to both processes). Returns the loaded trace document."""
    conn = getattr(kv, "_conn", None) or kv
    send = getattr(conn, "send_profiler_command", None)
    if send is None:
        raise MXNetError(
            "pull_server_trace needs a connected dist kvstore "
            "(create mx.kv.create('dist_sync') first)")
    _pull_nonce[0] += 1
    nonce_path = "%s.req%d.%d" % (path, os.getpid(), _pull_nonce[0])
    send({"cmd": "trace_dump", "path": nonce_path})
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        try:
            doc = load_trace(nonce_path)
        except (OSError, ValueError, MXNetError):
            time.sleep(poll)
            continue
        os.replace(nonce_path, path)
        return doc
    raise MXNetError(
        "server trace dump did not appear at %s within %.1fs (server "
        "down, tracing disabled there, or path not shared?)"
        % (nonce_path, timeout))


def attribution_events(attrib_doc, pid=90, tid=0):
    """Cost-attribution rows (a ``profiling`` ledger or attribution
    document) as a chrome-trace flame strip: one 'X' event an op, end
    to end in rank order on a pid of its own, sized by measured
    (preferred) or roofline-estimated seconds a step. Not a timeline: a
    proportional ranking beside the real spans in the same Perfetto
    view."""
    events = [{"name": "process_name", "ph": "M", "pid": pid, "tid": tid,
               "args": {"name": "op attribution (per step)"}}]
    cursor = 0.0
    for g in attrib_doc.get("by_op", []):
        dur_us = (g.get("measured_s") or g.get("est_s") or 0.0) * 1e6
        if dur_us <= 0:
            continue
        args = {"flops": g.get("flops", 0), "bytes": g.get("bytes", 0),
                "bound": g.get("bound", "?")}
        if g.get("rule"):
            args["rule"] = g["rule"]
        if g.get("mfu") is not None:
            args["mfu"] = g.get("mfu")
        events.append({
            "name": g.get("op") or "?", "cat": "attribution", "ph": "X",
            "ts": cursor, "dur": dur_us, "pid": pid, "tid": tid,
            "args": args})
        cursor += dur_us
    return events


def memory_counter_events(census_doc, pid=91, ts=0.0):
    """A live-tensor census (``profiling.memory.live_census`` document)
    rendered as Perfetto counter tracks: one stacked 'C' counter of live
    bytes by role, plus one counter a device with its total. ``ts``
    places the sample on the shared clock (callers pass the profiler's
    now)."""
    events = [{"name": "process_name", "ph": "M", "pid": pid, "tid": 0,
               "args": {"name": "HBM live bytes (census)"}}]
    by_role = census_doc.get("by_role", {})
    if by_role:
        events.append({
            "name": "mx_memory_live_bytes", "ph": "C", "ts": ts,
            "pid": pid,
            "args": {role: r.get("bytes", 0)
                     for role, r in sorted(by_role.items())}})
    for dev, d in sorted(census_doc.get("by_device", {}).items()):
        events.append({
            "name": "mx_memory_live_bytes[%s]" % dev, "ph": "C",
            "ts": ts, "pid": pid,
            "args": {"bytes": d.get("total_bytes", 0)}})
    return events


def health_counter_events(health_doc, pid=92, ts=0.0):
    """A model-health summary (``profiling.health.snapshot_doc``
    document) rendered as Perfetto counter tracks beside the memory
    track: loss and loss EWMA, the global gradient norm and the
    cumulative nonfinite count (stacked by seam) on the shared clock."""
    def _finite(v):
        # a NaN / Inf loss is what an unhealthy run carries, and bare
        # NaN literals make Perfetto reject the whole trace: drop the
        # sample, keep the nonfinite-count track as the signal (tracing/
        # imports without telemetry, so this guard is its own)
        return isinstance(v, (int, float)) and not isinstance(v, bool) \
            and v == v and v not in (float("inf"), float("-inf"))

    events = [{"name": "process_name", "ph": "M", "pid": pid, "tid": 0,
               "args": {"name": "model health (sentry/loss/norms)"}}]
    loss = health_doc.get("loss", {})
    args = {}
    if _finite(loss.get("last")):
        args["loss"] = loss["last"]
    if _finite(loss.get("ewma")):
        args["ewma"] = loss["ewma"]
    if args:
        events.append({"name": "mx_health_loss", "ph": "C", "ts": ts,
                       "pid": pid, "args": args})
    norms = health_doc.get("norms", {})
    if _finite(norms.get("grad_norm")):
        events.append({"name": "mx_health_grad_norm", "ph": "C",
                       "ts": ts, "pid": pid,
                       "args": {"l2": norms["grad_norm"]}})
    sentry = health_doc.get("sentry", {})
    by_source = sentry.get("by_source") or {}
    events.append({
        "name": "mx_health_nonfinite_total", "ph": "C", "ts": ts,
        "pid": pid,
        "args": ({src: n for src, n in sorted(by_source.items())}
                 if by_source
                 else {"total": sentry.get("nonfinite_total", 0)})})
    return events


def chrome_events(spans, pid=0, offset_ns=0, base_ns=None):
    """Span dicts -> chrome-trace 'X' events. ``offset_ns`` is added to
    every timestamp (clock alignment); ``base_ns`` is the zero point
    (the process epoch by default, so profiler events and spans share
    one axis)."""
    if base_ns is None:
        base_ns = clock.EPOCH_NS
    out = []
    for s in spans:
        args = {"trace": "%016x" % (s.get("trace") or 0),
                "span": "%016x" % (s.get("span") or 0)}
        if s.get("parent"):
            args["parent"] = "%016x" % s["parent"]
        if s.get("attrs"):
            args.update(s["attrs"])
        out.append({
            "name": s["name"], "cat": s.get("cat") or "span", "ph": "X",
            "ts": (s["start_ns"] + offset_ns - base_ns) / 1e3,
            "dur": s["dur_ns"] / 1e3,
            "pid": pid, "tid": s.get("tid", 0) % 100000,
            "args": args,
        })
    return out
