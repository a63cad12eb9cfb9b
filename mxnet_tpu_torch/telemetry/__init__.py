"""Runtime telemetry: the metrics half of the observability planes (the
port of ``mxnet_tpu/telemetry/__init__.py``).

``profiler.py`` answers *when* (chrome-trace events on a timeline); this
package answers *how much* (thread-safe Counter / Gauge / Histogram
families in a process-global registry), with exports that tie the two
together::

    import mxnet_tpu_torch as mx
    mx.telemetry.snapshot()                  # dict of every metric
    mx.telemetry.export.dump("telemetry.json")
    mx.telemetry.export.to_prometheus()      # scrape format
    mx.telemetry.export.dump_chrome_trace("merged.json")  # + profiler
    mx.telemetry.step.last_breakdown()       # step/data/comm/compile

Instrumented seams, each gated on ``MXTPU_TELEMETRY`` (on by default)
and none waiting for the card: op dispatch (``ops/registry.py``), kernel
builds (``ops/_build.py``, under :class:`compile_scope`), io data-wait
(``io/io.py``), kvstore push / pull bytes and latency worker- and
server-side (``kvstore/``), serving (``serving/``), and the per-step
breakdown (``gluon/trainer.py``, ``module/base_module.py``). Env knobs:
``MXTPU_TELEMETRY``, ``MXTPU_TELEMETRY_FLUSH_SEC``,
``MXTPU_TELEMETRY_FILE``, ``MXTPU_TELEMETRY_VERBOSE``,
``MXTPU_TIMELINE_SEC``.

**Compiles.** The JAX package counts XLA builds from jax's monitoring
bus. The port has no JIT: its ``mx_jit_compiles_total{op}`` and
``mx_jit_compile_seconds_total`` count the lazy ``nvcc`` builds of its
kernels (``ops/_build.py``), each charged to the op in scope when the
build ran (``_unattributed`` outside any), and the build's seconds go
into the step breakdown's compile_time. Nothing in the port traces, so
``mx_jit_traces_total`` stays 0.

**Device memory.** At each snapshot, ``torch.cuda.memory_stats`` of every
visible card, once CUDA is initialized, feeds ``mx_device_mem_peak_bytes``
and ``mx_device_mem_bytes_in_use``, labelled ``gpu:<i>`` as the JAX
collector labels a GPU. The live-tensor census
(``profiling.memory.live_census``) feeds ``mx_memory_live_bytes``
(by device and role) and ``mx_memory_live_arrays`` (by role) at each
snapshot, and backfills ``mx_device_mem_*`` for the devices with no
allocator statistics (the CPU and its mesh positions) from the census
bytes, as the JAX collector does.
"""
from __future__ import annotations

import os
import sys
import threading

from ..base import get_env
from . import metrics
from . import step
from . import export
from . import timeline
from . import slo
from .metrics import enabled, registry

__all__ = ["metrics", "step", "export", "timeline", "slo", "enabled",
           "set_enabled", "registry", "snapshot", "compile_scope"]


def set_enabled(on):
    """Flip hot-path collection at runtime. Enabling also honours
    MXTPU_TELEMETRY_FLUSH_SEC if the process started disabled."""
    metrics.set_enabled(on)
    if on and _flusher[0] is None and \
            get_env("MXTPU_TELEMETRY_FLUSH_SEC", 0.0, float) > 0:
        start_flusher()


def snapshot():
    return export.snapshot()


# -- compile attribution ----------------------------------------------------
# the op a kernel build is charged to rides this thread-local, set by
# ops/registry.OpDef.__call__ and the executor through compile_scope()
_current_op = threading.local()


class compile_scope:
    """Attribute kernel builds triggered inside the block to ``name``."""

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        self.prev = getattr(_current_op, "name", None)
        _current_op.name = self.name
        return self

    def __exit__(self, *exc):
        _current_op.name = self.prev
        return False


_met = metrics.lazy_metrics(lambda reg: {
    "compiles": reg.counter(
        "mx_jit_compiles_total",
        "kernel library builds (nvcc), attributed to the op/executor "
        "that triggered them", labelnames=("op",)),
    "compile_s": reg.counter(
        "mx_jit_compile_seconds_total",
        "wall-clock spent building kernel libraries").labels(),
    "traces": reg.counter(
        "mx_jit_traces_total",
        "graph traces (the port traces nothing: stays 0)").labels(),
    "trace_s": reg.counter(
        "mx_jit_trace_seconds_total",
        "wall-clock spent tracing graphs (stays 0)").labels(),
})


def note_compile(seconds):
    """Count one kernel build of ``seconds``, charged to the op in scope
    (``ops/_build.py`` calls this for every library it compiled)."""
    if not enabled():
        return
    op = getattr(_current_op, "name", None) or "_unattributed"
    m = _met()
    m["compiles"].labels(op=op).inc()
    m["compile_s"].inc(seconds)
    step.add_compile(seconds)


# -- device memory ----------------------------------------------------------
# devices whose allocator reported stats in the last collection; the
# census collector backfills the others. One list slot rebound at once:
# a flusher's snapshot may run beside a user's
_devices_with_stats = [frozenset()]


def _device_memory_collector(reg):
    """Snapshot-time pull of each visible card's allocator stats (host
    counters of the caching allocator: no sync). Never initializes CUDA:
    a process that has not touched the card reports nothing."""
    if "torch" not in sys.modules:
        return
    import torch
    if not torch.cuda.is_available() or not torch.cuda.is_initialized():
        _devices_with_stats[0] = frozenset()
        return
    peak = reg.gauge("mx_device_mem_peak_bytes",
                     "allocator high-water mark per device",
                     labelnames=("device",))
    used = reg.gauge("mx_device_mem_bytes_in_use",
                     "allocator bytes currently live per device",
                     labelnames=("device",))
    found = set()
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        if not stats:
            continue
        dev = "gpu:%d" % i
        found.add(dev)
        peak.labels(device=dev).set_max(
            stats.get("allocated_bytes.all.peak", 0))
        used.labels(device=dev).set(
            stats.get("allocated_bytes.all.current", 0))
    _devices_with_stats[0] = frozenset(found)


# -- live-tensor census -----------------------------------------------------
def _memory_census_collector(reg):
    """Snapshot-time census: live bytes by device and role from
    ``profiling.memory.live_census`` (sizes and allocator counters only:
    no sync). Devices with no allocator stats (the CPU, its mesh
    positions) get their ``mx_device_mem_*`` gauges backfilled from the
    census."""
    from ..profiling import memory as _mem
    stats_devs = _devices_with_stats[0]
    # zero the census-fed series first, before the gate: a role or
    # device that emptied since the last snapshot (or a gate turned off)
    # reads 0, not its stale value; find() so a disabled process never
    # creates the families
    for name in ("mx_memory_live_bytes", "mx_memory_live_arrays"):
        fam = reg.find(name)
        if fam is not None:
            for s in fam.series():
                s.set(0)
    fam = reg.find("mx_device_mem_bytes_in_use")
    if fam is not None:
        for s in fam.series():
            if s.labels.get("device") not in stats_devs:
                s.set(0)
    if not _mem.census_enabled():
        return
    doc = _mem.live_census()
    live = reg.gauge("mx_memory_live_bytes",
                     "live device-array bytes per device and census "
                     "role", labelnames=("device", "role"))
    cnt = reg.gauge("mx_memory_live_arrays",
                    "live device arrays per census role",
                    labelnames=("role",))
    for role, r in doc["by_role"].items():
        cnt.labels(role=role).set(r["arrays"])
    peak = reg.gauge("mx_device_mem_peak_bytes",
                     "allocator high-water mark per device",
                     labelnames=("device",))
    used = reg.gauge("mx_device_mem_bytes_in_use",
                     "allocator bytes currently live per device",
                     labelnames=("device",))
    for dev, d in doc["by_device"].items():
        for role, nb in d["by_role"].items():
            live.labels(device=dev, role=role).set(nb)
        if dev not in stats_devs:
            used.labels(device=dev).set(d["total_bytes"])
            peak.labels(device=dev).set_max(d["total_bytes"])


# -- periodic flush ---------------------------------------------------------
class _Flusher(threading.Thread):
    def __init__(self, period, path, verbose):
        super().__init__(name="mxtpu-telemetry-flush", daemon=True)
        self.period = period
        self.path = path
        self.verbose = verbose
        self._stop = threading.Event()

    def run(self):
        while not self._stop.wait(self.period):
            try:
                snap = export.dump(self.path)
                if self.verbose:
                    n = sum(len(f["series"])
                            for f in snap["metrics"].values())
                    print("[telemetry] flushed %d series to %s"
                          % (n, self.path), file=sys.stderr, flush=True)
            except Exception as e:  # noqa: BLE001 — a full disk must not
                if self.verbose:     # kill the training process
                    print("[telemetry] flush failed: %r" % (e,),
                          file=sys.stderr, flush=True)

    def stop(self):
        self._stop.set()


_flusher = [None]


def _default_flush_path():
    """Per process: in a launcher job every role shares the cwd, so the
    role and rank land in the file name."""
    path = get_env("MXTPU_TELEMETRY_FILE", None)
    if path is not None:
        return path
    role = os.environ.get("DMLC_ROLE")
    if role is None:
        return "telemetry.json"
    idx = os.environ.get("DMLC_SERVER_ID" if role == "server"
                         else "DMLC_WORKER_ID", "0")
    return "telemetry.%s%s.json" % (role, idx)


def start_flusher(period=None, path=None, verbose=None):
    """Start (or restart) the periodic snapshot writer; the arguments
    default to the MXTPU_TELEMETRY_* env vars."""
    stop_flusher()
    if period is None:
        period = get_env("MXTPU_TELEMETRY_FLUSH_SEC", 0.0, float)
    if period <= 0:
        return None
    if path is None:
        path = _default_flush_path()
    if verbose is None:
        verbose = get_env("MXTPU_TELEMETRY_VERBOSE", False, bool)
    fl = _Flusher(period, path, verbose)
    fl.start()
    _flusher[0] = fl
    return fl


def stop_flusher():
    fl, _flusher[0] = _flusher[0], None
    if fl is not None:
        fl.stop()


# pull-only and always registered, so a late set_enabled(True) still
# reports memory
registry().register_collector(_device_memory_collector)
registry().register_collector(_memory_census_collector)
if enabled():
    if get_env("MXTPU_TELEMETRY_FLUSH_SEC", 0.0, float) > 0:
        start_flusher()
    if get_env("MXTPU_TIMELINE_SEC", 0.0, float) > 0:
        timeline.start_ticker()
