"""Snapshot export: JSON, Prometheus text, the chrome-trace merge, and
the cross-process pull of a kvstore server's metrics through the
profiler directive channel (the port of
``mxnet_tpu/telemetry/export.py``, in the same formats, so
``tools/telemetry_dump.py`` reads the port's dumps unchanged).

Files are written tmp + rename, so a reader polling the path (the
worker side of :func:`pull_server_metrics`, a scraper) never sees a
torn document.
"""
from __future__ import annotations

import json
import os
import time

from ..base import MXNetError
from . import metrics as _metrics


def snapshot():
    """Point-in-time dict of the process registry (drains lazy device
    scalars: the read point, which may wait for the card)."""
    return _metrics.registry().snapshot()


def to_json(snap=None, indent=None):
    return json.dumps(snap if snap is not None else snapshot(),
                      indent=indent, sort_keys=True)


def from_json(text):
    snap = json.loads(text)
    if not isinstance(snap, dict) or "metrics" not in snap:
        raise MXNetError("not a telemetry snapshot (no 'metrics' key)")
    return snap


def _prom_labels(labels):
    if not labels:
        return ""
    parts = []
    for k in sorted(labels):
        v = str(labels[k]).replace("\\", "\\\\").replace('"', '\\"') \
            .replace("\n", "\\n")
        parts.append('%s="%s"' % (k, v))
    return "{%s}" % ",".join(parts)


def _prom_num(v):
    if isinstance(v, float) and v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(v) if not isinstance(v, str) else v


def to_prometheus(snap=None):
    """Prometheus text exposition (0.0.4) of a snapshot."""
    snap = snap if snap is not None else snapshot()
    lines = []
    for name, fam in sorted(snap["metrics"].items()):
        if fam.get("help"):
            lines.append("# HELP %s %s"
                         % (name, fam["help"].replace("\n", " ")))
        lines.append("# TYPE %s %s" % (name, fam["type"]))
        for s in fam["series"]:
            labels = s.get("labels", {})
            if fam["type"] == "histogram":
                for le, c in s["buckets"]:
                    ll = dict(labels)
                    ll["le"] = le if isinstance(le, str) else repr(
                        float(le))
                    lines.append("%s_bucket%s %d"
                                 % (name, _prom_labels(ll), c))
                lines.append("%s_sum%s %s"
                             % (name, _prom_labels(labels),
                                _prom_num(s["sum"])))
                lines.append("%s_count%s %d"
                             % (name, _prom_labels(labels), s["count"]))
            else:
                lines.append("%s%s %s" % (name, _prom_labels(labels),
                                          _prom_num(s["value"])))
    return "\n".join(lines) + "\n"


_pull_nonce = 0


def _atomic_text(path, text):
    tmp = "%s.tmp.%d" % (path, os.getpid())
    with open(tmp, "w", encoding="utf-8") as f:
        f.write(text)
    os.replace(tmp, path)


def dump(path, fmt="json", snap=None):
    """Write the current snapshot to ``path`` ('json' or 'prom'),
    atomically (tmp+rename). Returns the snapshot dict."""
    snap = snap if snap is not None else snapshot()
    if fmt == "json":
        _atomic_text(path, to_json(snap, indent=1))
    elif fmt == "prom":
        _atomic_text(path, to_prometheus(snap))
    else:
        raise MXNetError("telemetry dump fmt must be 'json' or 'prom', "
                         "got %r" % (fmt,))
    return snap


def _json_safe(v):
    """Replace nonfinite floats with their repr so json.dumps emits
    valid JSON ("nan"/"inf" strings) instead of bare literals."""
    if isinstance(v, float) and (
            v != v or v in (float("inf"), float("-inf"))):
        return repr(v)
    if isinstance(v, dict):
        return {k: _json_safe(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_json_safe(x) for x in v]
    return v


def merge_chrome_trace(snap=None, events=None, spans=None,
                       attribution=None, memory=None, health=None,
                       timeline=None):
    """One chrome://tracing document carrying every observability layer:
    the profiler's trace events, the tracing spans, the metric snapshot
    (counters and gauges as 'C' samples on the same clock, the whole
    snapshot under metadata) and, with ``timeline`` (a ``timeline/v1``
    document, or ``True`` for the process timeline now), each recorded
    frame as historical samples on the same counter tracks. Every layer
    shares ``tracing.clock``'s epoch, so all land on one Perfetto time
    axis. ``spans`` defaults to the process's recorded spans; pass [] to
    omit them. ``memory`` (a ``live_census`` document, or ``True`` for
    the process's census now) adds the census counter track, ``health``
    (a ``health.snapshot_doc`` document, or ``True``) the model-health
    tracks, and ``attribution`` (a ``profiling`` ledger or attribution
    document) its ranked per-op rows as a flame strip on a pid of its
    own, with the document's totals under metadata."""
    snap = snap if snap is not None else snapshot()
    from .. import profiler
    from .. import tracing as _tracing
    if events is None:
        with profiler._lock:
            events = list(profiler._events)
    if spans is None:
        spans = _tracing.spans_snapshot()
    ts = profiler._now_us()
    merged = list(events)
    merged.extend(_tracing.export.chrome_events(spans))
    for name, fam in sorted(snap["metrics"].items()):
        if fam["type"] == "histogram":
            continue
        for s in fam["series"]:
            v = s["value"]
            if v != v or v in (float("inf"), float("-inf")):
                # a bare NaN literal would make Perfetto reject the
                # whole trace
                continue
            ev_name = name + _prom_labels(s.get("labels", {}))
            merged.append({"name": ev_name, "ph": "C", "ts": ts,
                           "pid": 0, "args": {name: v}})
    metadata = {"telemetry": snap}
    if attribution is not None:
        merged.extend(_tracing.export.attribution_events(attribution))
        metadata["attribution"] = {
            k: attribution.get(k)
            for k in ("kind", "module", "totals", "reconciliation",
                      "mfu", "peak_tflops", "peak_hbm_gbs")
            if k in attribution}
    if memory is not None:
        if memory is True:
            from ..profiling import memory as _mem
            memory = _mem.live_census(top=10)
        merged.extend(_tracing.export.memory_counter_events(
            memory, ts=ts))
        metadata["memory"] = {
            k: memory.get(k)
            for k in ("kind", "total_bytes", "arrays", "by_role",
                      "by_device") if k in memory}
    if health is not None:
        if health is True:
            from ..profiling import health as _health
            health = _health.snapshot_doc()
        merged.extend(_tracing.export.health_counter_events(
            health, ts=ts))
        metadata["health"] = {
            k: health.get(k)
            for k in ("kind", "sentry", "loss", "norms")
            if k in health}
    if timeline is not None:
        if timeline is True:
            from . import timeline as _tl
            timeline = _tl.process_timeline().to_doc()
        for frame in timeline.get("frames", []):
            fts = frame.get("ts_ns")
            fts = ts if fts is None else fts / 1e3
            for name, fam in sorted(frame.get("metrics",
                                              {}).items()):
                if fam["type"] == "histogram":
                    continue
                for s in fam["series"]:
                    v = s["value"]
                    if v != v or v in (float("inf"), float("-inf")):
                        continue
                    ev_name = name + _prom_labels(
                        s.get("labels", {}))
                    merged.append({"name": ev_name, "ph": "C",
                                   "ts": fts, "pid": 0,
                                   "args": {name: v}})
        metadata["timeline"] = {
            k: timeline.get(k)
            for k in ("kind", "version", "window", "ticks_total")
            if k in timeline}
        metadata["timeline"]["frames"] = len(
            timeline.get("frames", []))
    # nonfinite floats anywhere in the document (a NaN span attr) would
    # serialize as bare NaN / Infinity literals: stringify them
    return {"traceEvents": _json_safe(merged),
            "displayTimeUnit": "ms",
            "metadata": _json_safe(metadata)}


def dump_chrome_trace(path, snap=None, events=None, attribution=None,
                      memory=None, health=None, timeline=None):
    trace = merge_chrome_trace(snap, events, attribution=attribution,
                               memory=memory, health=health,
                               timeline=timeline)
    _atomic_text(path, json.dumps(trace))
    return trace


def pull_server_metrics(kv, path, timeout=10.0, poll=0.05):
    """Fetch a kvstore server process's metric snapshot through the
    profiler directive channel (ref: kvstore.h:43-49 server commands).

    The worker sends ``{"cmd": "metrics_snapshot", "path": ...}``; the
    server's poll loop (kvstore/dist.py _apply_profiler_directive)
    writes its registry snapshot to ``path`` atomically, and this side
    polls the file into a dict. ``path`` must be visible to both
    processes (same host or a shared filesystem)."""
    conn = getattr(kv, "_conn", None) or kv
    send = getattr(conn, "send_profiler_command", None)
    if send is None:
        raise MXNetError(
            "pull_server_metrics needs a connected dist kvstore "
            "(create mx.kv.create('dist_sync') first)")
    # per-request nonce path: a slow server answering a PREVIOUS pull
    # must never have its late write mistaken for this request's answer
    global _pull_nonce
    _pull_nonce += 1
    nonce_path = "%s.req%d.%d" % (path, os.getpid(), _pull_nonce)
    send({"cmd": "metrics_snapshot", "path": nonce_path})
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        try:
            with open(nonce_path, "r", encoding="utf-8") as f:
                snap = from_json(f.read())
        except (OSError, ValueError, MXNetError):
            time.sleep(poll)
            continue
        # keep the artifact under the caller's name; drop the nonce file
        os.replace(nonce_path, path)
        return snap
    raise MXNetError(
        "server metrics snapshot did not appear at %s within %.1fs "
        "(server down, or path not shared between processes?)"
        % (nonce_path, timeout))


def diff(a, b):
    """Structured delta between two snapshots (before/after a perf
    change): {name: {series_key: {"before", "after", "delta"}}}.
    Counters/gauges diff values; histograms diff count and sum."""
    out = {}
    names = sorted(set(a.get("metrics", {})) | set(b.get("metrics", {})))
    for name in names:
        fa = a.get("metrics", {}).get(name, {"series": []})
        fb = b.get("metrics", {}).get(name, {"series": []})

        def by_labels(fam):
            return {json.dumps(s.get("labels", {}), sort_keys=True): s
                    for s in fam["series"]}

        sa, sb = by_labels(fa), by_labels(fb)
        entry = {}
        for key in sorted(set(sa) | set(sb)):
            va, vb = sa.get(key), sb.get(key)

            def scalar(s):
                if s is None:
                    return 0.0
                return s["sum"] if "sum" in s else s["value"]

            entry[key] = {"before": scalar(va), "after": scalar(vb),
                          "delta": scalar(vb) - scalar(va)}
            if (va and "count" in va) or (vb and "count" in vb):
                ca = va["count"] if va else 0
                cb = vb["count"] if vb else 0
                entry[key]["count_delta"] = cb - ca
        if entry:
            out[name] = entry
    return out
