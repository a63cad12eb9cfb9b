"""Causal tracing: spans with context propagation (the port of
``mxnet_tpu/tracing/__init__.py``; ``telemetry/`` answers "how much",
``profiler.py`` "when").

A :func:`span` is a named, monotonic-clocked interval with a parent
link, carried by a ``contextvars.ContextVar`` so nesting follows the
code across the framework's seams: ``DataIter.__next__``, the executor's
forward and backward, the Trainer step, the kvstore and its wire
protocol (a worker push / pull span's ``(trace_id, span_id)`` rides the
request header of ``_native/comm.cc``, and the server records child
spans for recv and update).

A new thread does not inherit context variables. The port runs a mesh's
positions on threads of their own (``parallel/mesh.py``): ``run_shards``
runs each position's work in a copy of the caller's context
(``contextvars.copy_context()``), so a span opened there is a child of
the caller's, never an orphan root. The serving lanes record their
spans explicitly (:func:`record_span`) from the request's context,
captured by the gateway on the caller's thread.

Closed spans land in bounded per-thread ring buffers; nothing is
written unless asked:

- ``tracing.export.write_trace(path)`` — one trace file per process,
  stitched across ranks by ``tools/trace_merge.py``;
- ``tracing.flight`` — the hang flight recorder: the same rings plus
  each thread's open spans, dumped with thread stacks on SIGTERM, an
  unhandled exception or a watchdog timeout
  (``MXTPU_HANG_TIMEOUT_SEC``);
- ``telemetry`` — spans with a ``cat`` feed the ``mx_span_seconds``
  histogram family.

Knobs: ``MXTPU_TRACE_SAMPLE`` (0..1 trace-level sampling, default 1;
0 disables recording), ``MXTPU_TRACE_RING`` (closed spans kept a
thread, default 2048), ``MXTPU_TRACE_FILE`` (default export path).
Nothing here touches torch or the card.
"""
from __future__ import annotations

import contextvars
import os
import random as _random_mod
import threading

from ..base import get_env
from . import clock

__all__ = ["span", "span_at", "traced", "record_span", "current",
           "context", "new_context", "enabled", "set_sample", "drain",
           "spans_snapshot", "reset", "clock", "flight", "export",
           "rings"]

_SAMPLE = [get_env("MXTPU_TRACE_SAMPLE", 1.0, float)]
_RING_CAP = max(int(get_env("MXTPU_TRACE_RING", 2048, int)), 16)

# span / trace ids draw from a private rng: the global `random` module is
# user-visible state and tracing must not perturb it
_rng = _random_mod.Random()

# current span, per OS thread (each thread starts with a fresh Context)
_ctx = contextvars.ContextVar("mxtpu_trace_span", default=None)

# watchdog heartbeat: monotonic ns of the last span open/close anywhere
# in the process (a wedged process stops advancing this)
_last_activity = [clock.now_ns()]


def _touch():
    _last_activity[0] = clock.now_ns()


def last_activity_ns():
    return _last_activity[0]


def enabled():
    """Whether spans record (MXTPU_TRACE_SAMPLE > 0)."""
    return _SAMPLE[0] > 0.0


def set_sample(p):
    """Set the trace sampling probability at runtime (0 disables)."""
    _SAMPLE[0] = float(p)


def _new_id():
    return _rng.getrandbits(63) | 1   # nonzero: 0 means "untraced" on the wire


# -- per-thread rings --------------------------------------------------------
class _ThreadRing:
    """One thread's closed-span ring + open-span stack. Mutated only by
    its owner thread; readers (flight recorder, export) take the module
    lock and copy — a torn read of a plain list append is benign."""

    __slots__ = ("thread_name", "ident", "closed", "open", "alive")

    def __init__(self, thread):
        self.thread_name = thread.name
        self.ident = thread.ident
        self.closed = []          # bounded FIFO of span dicts
        self.open = []            # in-flight Span objects, LIFO
        self.alive = True


_rings_lock = threading.Lock()
_rings = []                       # every thread ring ever registered
_tls = threading.local()


def _ring():
    r = getattr(_tls, "ring", None)
    if r is None:
        r = _ThreadRing(threading.current_thread())
        _tls.ring = r
        with _rings_lock:
            # bound dead-ring retention: threads come and go (prefetch
            # workers, server connection threads); refresh liveness HERE
            # — registration is the only hook guaranteed to run under
            # thread churn (rings() only runs when a dump/export asks) —
            # then keep the most recent few dead rings for post-mortem
            alive_ids = {t.ident for t in threading.enumerate()}
            for x in _rings:
                x.alive = x.ident in alive_ids
            dead = [x for x in _rings if not x.alive and not x.open]
            for x in dead[:-16]:
                _rings.remove(x)
            _rings.append(r)
    return r


def rings():
    """[(thread_name, ident, closed_spans_copy, open_spans_copy)] for
    every registered thread (flight recorder / export substrate)."""
    # timed acquire, then a lock-free fallback: the flight recorder
    # calls this from a SIGTERM handler, which may have interrupted a
    # frame on THIS thread that already holds the (non-reentrant) lock
    # — blocking would deadlock the dying process and starve the
    # chained handler (e.g. the kvstore server's snapshot on SIGTERM).
    # list(_rings) without the lock is a GIL-atomic copy; worst case a
    # torn view, which a dump tolerates by design.
    got = _rings_lock.acquire(timeout=0.5)
    try:
        rs = list(_rings)
    finally:
        if got:
            _rings_lock.release()
    alive = {t.ident for t in threading.enumerate()}
    out = []
    for r in rs:
        r.alive = r.ident in alive
        out.append((r.thread_name, r.ident, list(r.closed), list(r.open)))
    return out


# -- spans -------------------------------------------------------------------
class Span:
    """One in-flight interval. Use via ``with span(...)``; reading
    ``trace_id``/``span_id`` while open is how the kvstore worker puts
    the context on the wire."""

    __slots__ = ("name", "cat", "attrs", "trace_id", "span_id",
                 "parent_id", "start_ns", "_token", "_ring_ref")

    def __init__(self, name, cat, attrs, trace_id, parent_id):
        self.name = name
        self.cat = cat
        self.attrs = attrs
        self.trace_id = trace_id
        self.span_id = _new_id()
        self.parent_id = parent_id
        self.start_ns = 0
        self._token = None
        self._ring_ref = None

    def set_attr(self, key, value):
        self.attrs[key] = value

    def __enter__(self):
        self.start_ns = clock.now_ns()
        self._token = _ctx.set(self)
        r = self._ring_ref = _ring()
        r.open.append(self)
        _touch()
        return self

    def __exit__(self, exc_type, exc, tb):
        end_ns = clock.now_ns()
        _ctx.reset(self._token)
        r = self._ring_ref
        if r.open and r.open[-1] is self:
            r.open.pop()
        else:                      # out-of-order close (rare)
            try:
                r.open.remove(self)
            except ValueError:
                pass
        if exc_type is not None and exc_type is not StopIteration:
            self.attrs["error"] = exc_type.__name__
        rec = {"name": self.name, "cat": self.cat,
               "trace": self.trace_id, "span": self.span_id,
               "parent": self.parent_id,
               "start_ns": self.start_ns, "dur_ns": end_ns - self.start_ns,
               "tid": r.ident, "thread": r.thread_name,
               "attrs": self.attrs}
        r.closed.append(rec)
        if len(r.closed) > _RING_CAP:
            del r.closed[:-_RING_CAP]
        _touch()
        if self.cat is not None:
            _observe_span(self.name, (end_ns - self.start_ns) / 1e9)
        return False


class _NoopSpan:
    """Returned when tracing is disabled/unsampled: zero ids (untraced
    on the wire), records nothing."""

    __slots__ = ()
    trace_id = 0
    span_id = 0
    parent_id = 0
    name = cat = None
    attrs = {}

    def set_attr(self, key, value):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NOOP = _NoopSpan()


class _UnsampledCtx:
    """Entered when a ROOT span loses the sampling roll: it occupies
    the contextvar with ``trace_id`` 0 so every descendant inherits the
    unsampled decision (returns NOOP) instead of re-rolling into an
    orphan parentless trace."""

    __slots__ = ("_token",)
    trace_id = 0
    span_id = 0
    parent_id = 0
    name = cat = None
    attrs = {}

    def set_attr(self, key, value):
        pass

    def __enter__(self):
        self._token = _ctx.set(self)
        _touch()
        return self

    def __exit__(self, *exc):
        _ctx.reset(self._token)
        _touch()
        return False


def span(name, cat=None, **attrs):
    """Open a traced interval::

        with tracing.span("load_batch", cat="io", step=7):
            ...

    Parent is the innermost open span on this thread (contextvar); a
    span with no parent starts a new trace and takes the sampling
    decision (``MXTPU_TRACE_SAMPLE``) for everything beneath it — an
    unsampled root still enters the context so its descendants inherit
    the decision rather than re-rolling.
    ``cat`` marks framework seams ("io", "comm", "compute", "engine",
    "checkpoint", "step") — spans with a cat feed ``mx_span_seconds``.
    """
    if _SAMPLE[0] <= 0.0:
        return NOOP
    parent = _ctx.get()
    if parent is not None:
        if parent.trace_id == 0:     # inside an unsampled trace
            return NOOP
        return Span(name, cat, attrs, parent.trace_id, parent.span_id)
    s = _SAMPLE[0]
    if s < 1.0 and _rng.random() >= s:
        return _UnsampledCtx()
    return Span(name, cat, attrs, _new_id(), None)


def span_at(ctx, name, cat=None, **attrs):
    """Open a span parented to a context captured on ANOTHER thread
    (``ctx`` is :func:`context`'s ``(trace_id, span_id)`` tuple) — the
    async edge: capture at push time, reopen on the worker thread."""
    if _SAMPLE[0] <= 0.0:
        return NOOP
    if not ctx or not ctx[0]:
        return span(name, cat=cat, **attrs)
    return Span(name, cat, attrs, ctx[0], ctx[1])


def current():
    """The innermost open Span on this thread, or None."""
    return _ctx.get()


def context():
    """``(trace_id, span_id)`` of the current span — the wire/cross-
    thread propagation token. ``(0, 0)`` when untraced."""
    cur = _ctx.get()
    if cur is None:
        return (0, 0)
    return (cur.trace_id, cur.span_id)


def new_context():
    """Mint a fresh ``(trace_id, 0)`` context for a root that will be
    recorded externally via :func:`record_span` — e.g. a serving
    request entering the gateway with no enclosing span still needs a
    trace id to carry through queue → batch → execute → reply.
    ``(0, 0)`` when tracing is disabled — and the fractional
    MXTPU_TRACE_SAMPLE roll applies exactly as it does to a root
    :func:`span` (record_span records unconditionally for a nonzero
    trace id, so skipping the dice here would trace 100%% of serving
    requests at a 1%% sampling setting)."""
    s = _SAMPLE[0]
    if s <= 0.0:
        return (0, 0)
    if s < 1.0 and _rng.random() >= s:
        return (0, 0)
    return (_new_id(), 0)


def traced(fn=None, name=None, cat=None):
    """Decorator form: ``@traced`` / ``@traced(name=..., cat=...)``."""
    import functools

    def deco(f):
        label = name or f.__qualname__

        @functools.wraps(f)
        def wrapper(*args, **kwargs):
            with span(label, cat=cat):
                return f(*args, **kwargs)
        return wrapper
    return deco(fn) if fn is not None else deco


def record_span(name, trace_id, parent_id, start_ns, end_ns, cat=None,
                attrs=None):
    """Append an already-finished span (remote/native side, e.g. the
    kvstore server's recv intervals reported by the C++ trace sink).
    Returns the new span id."""
    if _SAMPLE[0] <= 0.0:
        return 0
    r = _ring()
    sid = _new_id()
    r.closed.append({"name": name, "cat": cat,
                     "trace": int(trace_id), "span": sid,
                     "parent": int(parent_id) or None,
                     "start_ns": int(start_ns),
                     "dur_ns": int(end_ns) - int(start_ns),
                     "tid": r.ident, "thread": r.thread_name,
                     "attrs": dict(attrs or {})})
    if len(r.closed) > _RING_CAP:
        del r.closed[:-_RING_CAP]
    _touch()
    return sid


# -- ring readout ------------------------------------------------------------
def spans_snapshot():
    """Copy of every closed span across all thread rings (oldest first
    per thread), non-destructive."""
    out = []
    for _, _, closed, _ in rings():
        out.extend(closed)
    out.sort(key=lambda s: s["start_ns"])
    return out


def drain():
    """Like :func:`spans_snapshot` but clears the rings (export path)."""
    with _rings_lock:
        rs = list(_rings)
    out = []
    for r in rs:
        closed, r.closed = r.closed, []
        out.extend(closed)
    out.sort(key=lambda s: s["start_ns"])
    return out


def reset():
    """Drop all recorded spans (test isolation). Open spans survive —
    they belong to live frames."""
    with _rings_lock:
        rs = list(_rings)
    for r in rs:
        r.closed = []


# -- telemetry feed ----------------------------------------------------------
# per-name series cache: one lock and observe a span close. Imported
# lazily: telemetry.export imports tracing for the chrome-trace merge
_span_series = {}


def _observe_span(name, seconds):
    from ..telemetry import metrics as _tm
    if not _tm.enabled():
        return
    s = _span_series.get(name)
    if s is None:
        fam = _tm.registry().histogram(
            "mx_span_seconds",
            "duration of framework-seam trace spans, by span name",
            labelnames=("name",))
        s = _span_series[name] = fam.labels(name=name)
    s.observe(seconds)


from . import flight  # noqa: E402  (imports tracing core above)
from . import export  # noqa: E402
