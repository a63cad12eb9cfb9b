"""Profiler with chrome://tracing output (the port of
``mxnet_tpu/profiler.py``; ref: src/profiler/profiler.h:87,256,304
Profiler / ProfileStat, python/mxnet/profiler.py).

The instrumented seams are the eager dispatch layer
(``ndarray.invoke``: one ``operator`` event an op while the profiler
runs), the graph executor (``executor_forward`` / ``executor_backward``),
the kvstore server's update and any user code through the
Task / Event / Counter / Frame objects, written into one
``traceEvents`` JSON that chrome://tracing and Perfetto load. A region
times the host: kernels are queued asynchronously, so an event spans
their launch, not their run on the card, except where the executor
waits for its outputs while the profiler runs.

The device capture keeps the JAX package's names: with
``set_config(xla_trace_dir=d)``, ``set_state("run")`` starts a
``torch.profiler`` capture (the CPU, and the card when there is one) with
the op scopes of ``profiling/optrace.py`` on, and ``set_state("stop")``
writes its Kineto trace into ``d`` (``last_xplane_dir()``);
:func:`op_attribution` joins that capture onto a cost ledger, as
``profiling.analyze_dir`` does.

Env: ``MXNET_PROFILER_AUTOSTART=1`` starts profiling at import
(ref: docs/faq/env_var.md).
"""
from __future__ import annotations

import json
import os
import threading
import time

from .base import MXNetError
from .telemetry import metrics as _tm
from .tracing import clock as _clock

_lock = threading.Lock()
_events = []          # chrome trace event dicts
_counters = {}
_state = "stop"
_config = {
    "filename": "profile.json",
    "profile_all": False,
    "profile_symbolic": True,
    "profile_imperative": True,
    "profile_memory": False,
    "profile_api": False,
    "aggregate_stats": False,
    "xla_trace_dir": None,
}


def _now_us():
    # one clock for every timeline: tracing spans and these chrome-trace
    # events share tracing.clock's process epoch, so a merged Perfetto
    # document never interleaves two time axes
    return _clock.rel_us(_clock.now_ns())


# dist kvstore whose servers remote profiler commands reach; installed
# automatically when a dist KVStore connects (ref: profiler.py
# set_kvstore_handle + kvstore.h:380 SendCommandToServers)
_kv_conn = None


def set_kvstore_handle(kv):
    """Register the dist kvstore that profile_process='server' calls
    route through (ref: python/mxnet/profiler.py set_kvstore_handle)."""
    global _kv_conn
    _kv_conn = getattr(kv, "_conn", kv)


def _send_server(directive):
    if _kv_conn is None:
        raise MXNetError(
            "profile_process='server' needs a connected dist kvstore "
            "(create mx.kv.create('dist_sync') first, ref: "
            "kvstore.h:387's warning for the same misuse)")
    _kv_conn.send_profiler_command(directive)


def set_config(profile_process="worker", **kwargs):
    if profile_process == "server":
        _send_server({"cmd": "set_config", "kwargs": kwargs})
        return
    unknown = set(kwargs) - set(_config)
    if unknown:
        raise MXNetError(f"unknown profiler config keys {sorted(unknown)}")
    _config.update(kwargs)


def set_state(state="stop", profile_process="worker"):
    """'run' starts collection, 'stop' ends it (ref: profiler.py
    set_state; MXSetProcessProfilerState)."""
    global _state
    if profile_process == "server":
        _send_server({"cmd": "set_state", "state": state})
        return
    if state not in ("run", "stop"):
        raise MXNetError("profiler state must be 'run' or 'stop'")
    if state == "run" and _state != "run" and _config["xla_trace_dir"]:
        _start_capture()
    if state == "stop" and _state == "run" and _capture[0] is not None:
        _stop_capture()
    _state = state


_capture = [None]       # (torch.profiler.profile, optrace.capturing)
_last_xplane_dir = [None]


def _start_capture():
    import torch
    from .profiling import optrace
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    scopes = optrace.capturing()
    scopes.__enter__()
    prof = torch.profiler.profile(activities=acts)
    try:
        prof.__enter__()
    except BaseException:
        scopes.__exit__(None, None, None)
        raise
    _capture[0] = (prof, scopes)


def _stop_capture():
    prof, scopes = _capture[0]
    _capture[0] = None
    try:
        prof.__exit__(None, None, None)
    finally:
        scopes.__exit__(None, None, None)
    d = _config["xla_trace_dir"]
    os.makedirs(d, exist_ok=True)
    prof.export_chrome_trace(os.path.join(
        d, "mxtpu_%d_%d.pt.trace.json" % (os.getpid(),
                                          int(time.time() * 1e6))))
    # the capture is on disk: last_xplane_dir() / op_attribution() read
    # it without the caller passing the directory again
    _last_xplane_dir[0] = d


def last_xplane_dir():
    """The directory of the most recent completed ``xla_trace_dir``
    capture (``set_config`` + ``set_state('run')`` then ``'stop'``), or
    None."""
    return _last_xplane_dir[0]


def op_attribution(compiled=None, hlo_text=None, profile_dir=None,
                   **kwargs):
    """Measured per-op attribution of the last (or given) capture,
    joined onto a cost ledger of ``compiled`` (a ledger document, an op
    trace, or a program traced once: see ``profiling.analyze_dir``) or
    of ``hlo_text``."""
    from . import profiling
    profile_dir = profile_dir or last_xplane_dir()
    if profile_dir is None:
        raise MXNetError(
            "no capture recorded: run with set_config(xla_trace_dir=...) "
            "+ set_state('run'/'stop'), or pass profile_dir=")
    return profiling.analyze_dir(profile_dir, compiled=compiled,
                                 hlo_text=hlo_text, **kwargs)


def state():
    return _state


def is_running():
    return _state == "run"


def pause(profile_process="worker"):
    if profile_process == "server":
        _send_server({"cmd": "pause"})
        return
    set_state("stop")


def resume(profile_process="worker"):
    if profile_process == "server":
        _send_server({"cmd": "resume"})
        return
    set_state("run")


def record_event(name, cat, start_us, dur_us, args=None, tid=None):
    """Append one complete ('X') chrome trace event."""
    if _state != "run":
        return
    ev = {"name": name, "cat": cat, "ph": "X",
          "ts": start_us, "dur": dur_us, "pid": 0,
          "tid": tid if tid is not None else threading.get_ident() % 1000}
    if args:
        ev["args"] = args
    with _lock:
        _events.append(ev)


class _timed:
    """Context manager timing a region into the trace."""

    def __init__(self, name, cat):
        self.name = name
        self.cat = cat

    def __enter__(self):
        self.start = _now_us()
        return self

    def __exit__(self, *exc):
        record_event(self.name, self.cat, self.start,
                     _now_us() - self.start)
        return False


def timed_operator(name):
    return _timed(name, "operator")


def timed_region(name, cat="region"):
    return _timed(name, cat)


def dump(finished=True, profile_process="worker"):
    """Write the chrome-trace JSON to the configured filename."""
    if profile_process == "server":
        _send_server({"cmd": "dump"})
        return
    with _lock:
        events = list(_events)
        if finished:
            _events.clear()
    with open(_config["filename"], "w") as f:
        json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, f)


def dumps(reset=False, format="table"):
    """Aggregate stats string (ref: MXAggregateProfileStatsPrint)."""
    with _lock:
        events = list(_events)
        if reset:
            _events.clear()
    agg = {}
    for ev in events:
        if ev.get("ph") != "X":
            continue  # counters/markers carry no duration
        name = ev["name"]
        st = agg.setdefault(name, [0, 0.0, float("inf"), 0.0])
        st[0] += 1
        st[1] += ev["dur"]
        st[2] = min(st[2], ev["dur"])
        st[3] = max(st[3], ev["dur"])
    lines = [f"{'Name':<40}{'Count':>8}{'Total(us)':>14}"
             f"{'Min(us)':>12}{'Max(us)':>12}{'Avg(us)':>12}"]
    for name, (cnt, tot, mn, mx) in sorted(
            agg.items(), key=lambda kv: -kv[1][1]):
        lines.append(f"{name:<40}{cnt:>8}{tot:>14.1f}{mn:>12.1f}"
                     f"{mx:>12.1f}{tot / cnt:>12.1f}")
    return "\n".join(lines)


# -- kvstore recovery telemetry -------------------------------------------
# The dist transport reports every recovery incident (reconnect storms,
# budget exhaustions) here, whatever the run / stop state: "why did this
# distributed run degrade" must be answerable when nobody armed the
# profiler. While the profiler runs, each incident also lands in the
# chrome trace (category "kvstore_recovery") beside the op timeline.
# The counters live on the metrics registry (mx_recovery_* families, in
# every snapshot and Prometheus export); this module keeps the bounded
# incident list for recovery_incidents() and recovery_summary()'s
# "last".
_recovery_incidents = []
_RECOVERY_KEEP = 256

_recovery_met = _tm.lazy_metrics(lambda reg: {
    "incidents": reg.counter(
        "mx_recovery_incidents_total",
        "kvstore/checkpoint recovery incidents by outcome "
        "(recovered/exhausted/worker_resume/checkpoint_rejected)",
        labelnames=("outcome",)),
    "attempts": reg.counter(
        "mx_recovery_attempts_total",
        "resend attempts across all recovery incidents").labels(),
    "reconnects": reg.counter(
        "mx_recovery_reconnects_total",
        "successful transport reconnects during recovery").labels(),
    "backoff_ms": reg.counter(
        "mx_recovery_backoff_wait_ms_total",
        "milliseconds slept in recovery backoff").labels(),
})


def note_recovery(args):
    """Record one recovery incident dict (op, req_id, outcome,
    attempts, backoff_wait_ms, ...) from the kvstore transport.
    Unconditional (not gated on MXTPU_TELEMETRY): recovery telemetry is
    the 'why did this run degrade' record and must survive a disabled
    hot-path collection."""
    with _lock:
        _recovery_incidents.append(dict(args))
        del _recovery_incidents[:-_RECOVERY_KEEP]
    m = _recovery_met()
    m["incidents"].labels(outcome=str(args.get("outcome", "?"))).inc()
    m["attempts"].inc(int(args.get("attempts", 0)))
    m["reconnects"].inc(int(args.get("reconnects", 0)))
    m["backoff_ms"].inc(float(args.get("backoff_wait_ms", 0.0)))
    record_event("kvstore_recovery:%s" % args.get("outcome", "?"),
                 "kvstore_recovery", _now_us(), 0, args=dict(args))


def note_worker_resume(args):
    """Record one worker auto-resume (a checkpoint manager's resume):
    step, checkpoint path, restart count."""
    note_recovery(dict(args, outcome="worker_resume"))


def note_checkpoint_rejected(args):
    """Record one torn/corrupt checkpoint skipped at resume time
    (CRC/manifest validation failed)."""
    note_recovery(dict(args, outcome="checkpoint_rejected"))


def recovery_incidents():
    with _lock:
        return [dict(a) for a in _recovery_incidents]


def recovery_summary():
    """Aggregate recovery telemetry: the structured 'why it degraded'
    record. The counts come from the registry's mx_recovery_* families
    (unbounded, exported everywhere); only "last" reads the retained
    incidents."""
    with _lock:
        last = dict(_recovery_incidents[-1]) if _recovery_incidents \
            else None
    m = _recovery_met()
    by_outcome = {s.labels["outcome"]: s.value
                  for s in m["incidents"].series()}
    if not any(by_outcome.values()):
        # counters zeroed (registry().reset(), e.g. the before/after
        # perf-diff workflow) while the bounded incident list survives:
        # report a consistent all-zero summary; raw history stays
        # available via recovery_incidents()
        last = None
    return {
        "incidents": int(round(sum(by_outcome.values()))),
        "recovered": int(round(by_outcome.get("recovered", 0))),
        "exhausted": int(round(by_outcome.get("exhausted", 0))),
        "attempts": int(round(m["attempts"].value)),
        "reconnects": int(round(m["reconnects"].value)),
        "backoff_wait_ms": round(m["backoff_ms"].value, 3),
        "worker_resumes": int(round(by_outcome.get("worker_resume", 0))),
        "checkpoints_rejected": int(round(
            by_outcome.get("checkpoint_rejected", 0))),
        "last": last,
    }


# -- user-defined instrumentation objects (ref: profiler.h:556-837) -------
class Domain:
    def __init__(self, name):
        self.name = name


class Task:
    def __init__(self, domain, name):
        self.name = name
        self.domain = domain
        self._start = None

    def start(self):
        self._start = _now_us()

    def stop(self):
        if self._start is not None:
            record_event(self.name, f"task:{self.domain.name}",
                         self._start, _now_us() - self._start)
            self._start = None


class Event(Task):
    pass


class Frame(Task):
    pass


class Counter:
    """User-visible profiler counter (ref: profiler.h:752 Counter).

    Thread-safe: increment / decrement are read-modify-writes that
    several threads may run on one counter. The per-counter lock is
    taken before the module ``_lock``; nothing takes them in the
    reverse order."""

    def __init__(self, domain, name, value=0):
        self.name = name
        self.domain = domain
        self._value = value
        self._vlock = threading.Lock()

    def set_value(self, value):
        with self._vlock:
            self._value = value
        if _state == "run":
            with _lock:
                _events.append({"name": self.name, "ph": "C",
                                "ts": _now_us(), "pid": 0,
                                "args": {self.name: value}})

    def increment(self, delta=1):
        with self._vlock:
            self._value += delta
            value = self._value
        if _state == "run":
            with _lock:
                _events.append({"name": self.name, "ph": "C",
                                "ts": _now_us(), "pid": 0,
                                "args": {self.name: value}})

    def decrement(self, delta=1):
        self.increment(-delta)

    @property
    def value(self):
        with self._vlock:
            return self._value


def marker(name, scope="process"):
    if _state == "run":
        with _lock:
            _events.append({"name": name, "ph": "i", "ts": _now_us(),
                            "pid": 0, "s": scope[0]})


# instant-marker alias used by the reference API
mark = marker

if os.environ.get("MXNET_PROFILER_AUTOSTART") == "1":
    set_state("run")
