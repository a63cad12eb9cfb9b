"""Metrics core: Counter / Gauge / Histogram families and the
process-global registry (the port of ``mxnet_tpu/telemetry/metrics.py``;
``profiler.py`` is the trace-event half).

Design constraints, in order:

1. **Hot-path cheap.** One ``inc()`` is a lock acquire and a float add.
   Anything per op beyond that (label lookup, device reads) is the
   caller's to avoid: hot call sites cache a series (``labels()``).
2. **No host syncs where values are recorded.** A value that lives on
   the card goes through ``inc_lazy`` / ``set_lazy`` / ``observe_lazy``.
   On the JAX package's device a buffer read of an old scalar is a
   ready-buffer read; on CUDA ``float()`` of a tensor waits for all the
   work queued on its stream, not just that value. So a CUDA scalar is
   copied, when it is recorded, into pinned host memory with
   ``non_blocking=True`` behind a recorded event; the bounded window
   (``_PENDING_WINDOW`` values a series) folds an old entry only once its
   event has completed (``Event.query()``, which never waits), and every
   other entry waits for the read (``value`` / ``snapshot()``), which
   synchronizes, as in the JAX package.
3. **Thread-safe.** Lane threads, io producer threads and the kvstore
   server's connection threads record into the same registry; every
   mutation happens under the family lock.

``MXTPU_TELEMETRY=0`` disables collection: instrumented call sites check
:func:`enabled` first, so a disabled process pays one list read a seam.
"""
from __future__ import annotations

import bisect
import threading
import time

from ..base import get_env

# latency histograms default to seconds; they span dispatch overhead
# (~us) through a cold kernel build (~minutes)
DEFAULT_BUCKETS = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025,
    0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0)

# device scalars buffered per series before the oldest may be folded
_PENDING_WINDOW = 64

_enabled = [get_env("MXTPU_TELEMETRY", True, bool)]


def enabled():
    """Whether instrumented hot paths record (MXTPU_TELEMETRY)."""
    return _enabled[0]


def set_enabled(on):
    """Flip collection at runtime (the env var sets the default)."""
    _enabled[0] = bool(on)


def _label_key(labelnames, labelvalues):
    return tuple(str(labelvalues[n]) for n in labelnames)


class _Pending:
    """A CUDA scalar on its way to the host: a non-blocking copy into
    pinned memory behind an event recorded on the value's stream."""

    __slots__ = ("host", "event")

    def __init__(self, t):
        import torch
        self.host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        self.host.copy_(t.detach(), non_blocking=True)
        self.event = torch.cuda.Event()
        self.event.record()

    def ready(self):
        return self.event.query()

    def __float__(self):
        self.event.synchronize()   # the read point: may wait
        return float(self.host)


def _lazy_entry(v):
    """What a lazy record buffers: a CUDA tensor becomes a pinned copy in
    flight; host values and CPU tensors are kept as they are."""
    if getattr(v, "is_cuda", False):
        return _Pending(v)
    return v


def _ready(x):
    """Whether a buffered entry's value has reached the host (entries
    that ride a pending copy answer through their ``ready()``)."""
    ready = getattr(x, "ready", None)
    return ready() if ready is not None else True


class _Series:
    """One labeled child of a family. All mutation under the family
    lock (``_lock`` is shared with the parent). Series objects are
    stable for the registry's lifetime — ``reset()`` zeroes them in
    place — so hot call sites may cache one and skip the ``labels()``
    resolution per record."""

    __slots__ = ("_lock", "labels", "_value", "_pending")

    def __init__(self, lock, labels):
        self._lock = lock
        self.labels = labels
        self._value = 0.0
        self._pending = []

    def _zero(self):
        with self._lock:
            self._value = 0.0
            self._pending = []

    def _push_lazy(self, v):
        """Buffer ``v``; past the window, hand back the oldest entries
        whose copies have landed (never one still in flight)."""
        self._pending.append(_lazy_entry(v))
        if len(self._pending) <= _PENDING_WINDOW:
            return ()
        excess = len(self._pending) - _PENDING_WINDOW
        old = []
        while excess and _ready(self._pending[0]):
            old.append(self._pending.pop(0))
            excess -= 1
        return old


class CounterSeries(_Series):
    def inc(self, v=1.0):
        with self._lock:
            self._value += v

    def inc_lazy(self, v):
        """Accumulate a (possibly still in-flight) device scalar; folded
        to the host at read time, never a sync here."""
        with self._lock:
            old = self._push_lazy(v)
        for x in old:
            self.inc(float(x))

    def _drain(self):
        with self._lock:
            pending, self._pending = self._pending, []
        for x in pending:
            self.inc(float(x))

    @property
    def value(self):
        self._drain()
        with self._lock:
            return self._value


class GaugeSeries(_Series):
    # every direct write clears any pending lazy value: last write wins,
    # and a buffered device scalar always predates a later set()/inc()

    def set(self, v):
        with self._lock:
            self._value = float(v)
            self._pending = []

    def inc(self, v=1.0):
        with self._lock:
            self._value += v
            self._pending = []

    def dec(self, v=1.0):
        with self._lock:
            self._value -= v
            self._pending = []

    def set_max(self, v):
        """High-water update: keep the max of current and ``v``."""
        with self._lock:
            if v > self._value:
                self._value = float(v)

    def set_lazy(self, v):
        # gauge semantics: only the newest pending value can matter, so
        # one slot suffices
        with self._lock:
            self._pending = [_lazy_entry(v)]

    def _drain(self):
        with self._lock:
            pending, self._pending = self._pending, []
        if pending:
            self.set(float(pending[-1]))

    @property
    def value(self):
        self._drain()
        with self._lock:
            return self._value


class HistogramSeries(_Series):
    __slots__ = ("buckets", "_counts", "_sum", "_count")

    def __init__(self, lock, labels, buckets):
        super().__init__(lock, labels)
        self.buckets = buckets
        self._counts = [0] * len(buckets)   # non-cumulative per bucket
        self._sum = 0.0
        self._count = 0

    def _zero(self):
        with self._lock:
            self._counts = [0] * len(self.buckets)
            self._sum = 0.0
            self._count = 0
            self._pending = []

    def observe(self, v):
        with self._lock:
            self._sum += v
            self._count += 1
            i = bisect.bisect_left(self.buckets, v)
            if i < len(self._counts):   # beyond the last edge: +Inf
                self._counts[i] += 1    # only (implicit in _count)

    def observe_lazy(self, v):
        with self._lock:
            old = self._push_lazy(v)
        for x in old:
            self.observe(float(x))

    def _drain(self):
        with self._lock:
            pending, self._pending = self._pending, []
        for x in pending:
            self.observe(float(x))

    @property
    def count(self):
        self._drain()
        with self._lock:
            return self._count

    @property
    def sum(self):
        self._drain()
        with self._lock:
            return self._sum

    def cumulative_buckets(self):
        """[(le, cumulative_count), ...] ending with ('+Inf', count) —
        the Prometheus wire shape."""
        return self.stats()[2]

    def stats(self):
        """(count, sum, cumulative_buckets) read under one lock hold:
        an observe() between three separate reads would export a
        self-contradictory series (+Inf bucket > count)."""
        self._drain()
        with self._lock:
            out, cum = [], 0
            for le, n in zip(self.buckets, self._counts):
                cum += n
                out.append((le, cum))
            out.append(("+Inf", self._count))
            return self._count, self._sum, out


class _Family:
    """A named metric with a fixed label schema; children per label
    combination. ``labels()`` with no arguments (or calling the value
    methods directly on the family) addresses the unlabeled series."""

    kind = "untyped"
    _series_cls = _Series

    def __init__(self, name, help="", labelnames=()):
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._lock = threading.Lock()
        self._children = {}
        self._default_cache = None

    def _new_series(self, labels):
        return self._series_cls(self._lock, labels)

    def labels(self, **labelvalues):
        if set(labelvalues) != set(self.labelnames):
            raise ValueError(
                "metric %s takes labels %r, got %r"
                % (self.name, self.labelnames, tuple(labelvalues)))
        key = _label_key(self.labelnames, labelvalues)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._new_series(
                    dict(zip(self.labelnames, key)))
                self._children[key] = child
        return child

    @property
    def _default(self):
        child = self._default_cache
        if child is None:
            if self.labelnames:
                raise ValueError(
                    "metric %s is labeled (%r) — address a series via "
                    ".labels(...)" % (self.name, self.labelnames))
            child = self._default_cache = self.labels()
        return child

    def series(self):
        with self._lock:
            return list(self._children.values())

    def reset(self):
        """Zero every series in place: series objects stay valid, so
        hot-path caches of them survive a registry reset."""
        for child in self.series():
            child._zero()


class Counter(_Family):
    kind = "counter"
    _series_cls = CounterSeries

    def inc(self, v=1.0):
        self._default.inc(v)

    def inc_lazy(self, v):
        self._default.inc_lazy(v)

    @property
    def value(self):
        return self._default.value


class Gauge(_Family):
    kind = "gauge"
    _series_cls = GaugeSeries

    def set(self, v):
        self._default.set(v)

    def inc(self, v=1.0):
        self._default.inc(v)

    def dec(self, v=1.0):
        self._default.dec(v)

    def set_max(self, v):
        self._default.set_max(v)

    def set_lazy(self, v):
        self._default.set_lazy(v)

    @property
    def value(self):
        return self._default.value


class Histogram(_Family):
    kind = "histogram"
    _series_cls = HistogramSeries

    def __init__(self, name, help="", labelnames=(), buckets=None):
        super().__init__(name, help, labelnames)
        b = tuple(sorted(buckets if buckets is not None
                         else DEFAULT_BUCKETS))
        if not b:
            raise ValueError("histogram %s needs at least one bucket"
                             % name)
        self.buckets = b

    def _new_series(self, labels):
        return HistogramSeries(self._lock, labels, self.buckets)

    def observe(self, v):
        self._default.observe(v)

    def observe_lazy(self, v):
        self._default.observe_lazy(v)


class MetricRegistry:
    """Process-global family store and snapshot point.

    ``counter`` / ``gauge`` / ``histogram`` are get-or-create: the first
    caller fixes the schema; a later caller with another kind, label set
    or bucket set gets a ValueError instead of a silently split series.
    Collectors registered with :meth:`register_collector` run at
    snapshot time (device memory, anything pull-based)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._families = {}
        self._collectors = []

    def _get_or_create(self, cls, name, help, labelnames, **kw):
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = cls(name, help=help, labelnames=labelnames, **kw)
                self._families[name] = fam
                return fam
        if not isinstance(fam, cls):
            raise ValueError(
                "metric %s already registered as %s, requested %s"
                % (name, fam.kind, cls.kind))
        if tuple(labelnames) != fam.labelnames:
            raise ValueError(
                "metric %s already registered with labels %r, "
                "requested %r" % (name, fam.labelnames,
                                  tuple(labelnames)))
        buckets = kw.get("buckets")
        if buckets is not None and tuple(sorted(buckets)) != fam.buckets:
            raise ValueError(
                "metric %s already registered with buckets %r, "
                "requested %r — observations would land in edges the "
                "caller never asked for" % (name, fam.buckets,
                                            tuple(sorted(buckets))))
        return fam

    def counter(self, name, help="", labelnames=()):
        return self._get_or_create(Counter, name, help, labelnames)

    def gauge(self, name, help="", labelnames=()):
        return self._get_or_create(Gauge, name, help, labelnames)

    def histogram(self, name, help="", labelnames=(), buckets=None):
        return self._get_or_create(Histogram, name, help, labelnames,
                                   buckets=buckets)

    def find(self, name):
        with self._lock:
            return self._families.get(name)

    def value(self, name, default=0.0, **labelvalues):
        """Current value of a counter / gauge series, ``default`` when
        the metric or series does not exist yet."""
        fam = self.find(name)
        if fam is None:
            return default
        try:
            key = _label_key(fam.labelnames, labelvalues)
        except KeyError:
            return default
        with fam._lock:
            child = fam._children.get(key)
        return child.value if child is not None else default

    def register_collector(self, fn):
        """``fn(registry)`` runs at every snapshot (pull-based gauges)."""
        with self._lock:
            if fn not in self._collectors:
                self._collectors.append(fn)
        return fn

    def unregister_collector(self, fn):
        with self._lock:
            if fn in self._collectors:
                self._collectors.remove(fn)

    def families(self):
        with self._lock:
            return dict(self._families)

    def snapshot(self):
        """Point-in-time dict of every family (the drain point: lazy
        device scalars are folded here)."""
        with self._lock:
            collectors = list(self._collectors)
        for fn in collectors:
            try:
                fn(self)
            except Exception:  # noqa: BLE001 — a broken collector must
                pass           # never take down the snapshot path
        out = {"version": 1, "ts": time.time(), "metrics": {}}
        for name, fam in sorted(self.families().items()):
            series = []
            for s in fam.series():
                if isinstance(s, HistogramSeries):
                    count, total, buckets = s.stats()
                    series.append({
                        "labels": s.labels,
                        "count": count,
                        "sum": total,
                        "buckets": [[le, c] for le, c in buckets],
                    })
                else:
                    series.append({"labels": s.labels,
                                   "value": s.value})
            out["metrics"][name] = {"type": fam.kind, "help": fam.help,
                                    "series": series}
        return out

    def reset(self):
        """Zero every family (registrations and collectors survive)."""
        for fam in self.families().values():
            fam.reset()


_registry = MetricRegistry()


def registry():
    """The process-global registry every subsystem records into."""
    return _registry


def lazy_metrics(build):
    """Memoized metric-bundle factory for instrumented modules::

        _met = lazy_metrics(lambda reg: {"x": reg.counter("x").labels()})

    ``build(registry())`` runs on first use (family creation must not
    tax module import). Cache series (``.labels()``) for unlabeled
    hot-path metrics: ``reset()`` zeroes them in place, so the cache
    stays valid for the process. A racing double build is benign: the
    registry get-or-creates the same families and ``labels()`` returns
    the same children."""
    box = []

    def get():
        if not box:
            box.append(build(registry()))
        return box[0]
    return get
