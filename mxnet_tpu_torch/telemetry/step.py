"""Per-step training breakdown: step_time / data_time / comm_time /
compile_time (the port of ``mxnet_tpu/telemetry/step.py``).

The seams the framework owns feed it, so training loops need no change:

- ``DataIter.__next__`` calls :func:`add_data_wait` (time spent
  assembling or waiting for the host batch);
- the kvstore calls :func:`add_comm` around push and pull;
- a lazy kernel build (``ops/_build.py``) calls :func:`add_compile`;
- ``gluon.Trainer.step`` and ``BaseModule.fit`` call
  :func:`step_boundary` once per optimizer step.

``step_boundary`` charges everything accumulated since the previous
boundary to the finished step. Every quantity is host wall-clock: none
of this waits for the card (no ``.item()``, ``.cpu()`` or
``torch.cuda.synchronize()``). With kernels queued asynchronously the
breakdown reports what the host spent, which is the pipeline-health
signal: a step dominated by data_time is input-bound, by comm_time
transport-bound, by compile_time still building kernels. The card's
own kernel time comes from ``torch.profiler`` or CUDA events, not
from here.
"""
from __future__ import annotations

import threading
import time

from . import metrics as _metrics


class _StepState:
    def __init__(self):
        self.lock = threading.Lock()
        self.last_boundary = None
        self.data_s = 0.0
        self.comm_s = 0.0
        self.compile_s = 0.0
        self.last = {}


_state = _StepState()
# callables run at every boundary, telemetry on or off (the op trace's
# scope counts start over there: ``profiling/optrace.py``)
_on_boundary = []

# unlabeled entries cache the series (reset-safe, one lock and add a
# record); only the per-source step counter stays a family
_met = _metrics.lazy_metrics(lambda reg: {
    "steps": reg.counter(
        "mx_steps_total", "optimizer steps observed",
        labelnames=("source",)),
    "step_hist": reg.histogram(
        "mx_step_time_seconds",
        "host wall-clock between step boundaries").labels(),
    "step_sum": reg.counter(
        "mx_step_time_seconds_total",
        "total host wall-clock across steps").labels(),
    "data_sum": reg.counter(
        "mx_step_data_seconds_total",
        "host time waiting on / assembling input batches").labels(),
    "comm_sum": reg.counter(
        "mx_step_comm_seconds_total",
        "host time in kvstore push/pull + collectives").labels(),
    "compile_sum": reg.counter(
        "mx_step_compile_seconds_total",
        "host time in XLA trace/compile charged to steps").labels(),
    "last_step": reg.gauge(
        "mx_last_step_time_seconds",
        "most recent step wall-clock").labels(),
})


def add_data_wait(seconds):
    with _state.lock:
        _state.data_s += seconds


def add_comm(seconds):
    with _state.lock:
        _state.comm_s += seconds


def add_compile(seconds):
    with _state.lock:
        _state.compile_s += seconds


def step_boundary(source="trainer"):
    """Close the current step: charge the accumulated data / comm /
    compile time to it and emit the breakdown. Returns the breakdown
    dict (None for the very first boundary, which only opens the
    interval)."""
    for fn in _on_boundary:
        fn()
    if not _metrics.enabled():
        return None
    now = time.perf_counter()
    with _state.lock:
        data_s, _state.data_s = _state.data_s, 0.0
        comm_s, _state.comm_s = _state.comm_s, 0.0
        compile_s, _state.compile_s = _state.compile_s, 0.0
        prev, _state.last_boundary = _state.last_boundary, now
    m = _met()
    # mx_steps_total counts every optimizer step (N); the duration
    # counters below cover only the N-1 completed intervals: derive the
    # mean step time from the histogram's sum / count
    m["steps"].labels(source=source).inc()
    if prev is None:
        # first boundary: no interval to charge to. The data / comm /
        # compile accrued before it (warmup, first batch) is discarded,
        # so all four *_seconds_total counters cover the same intervals
        return None
    step_s = now - prev
    m["data_sum"].inc(data_s)
    m["comm_sum"].inc(comm_s)
    m["compile_sum"].inc(compile_s)
    m["step_hist"].observe(step_s)
    m["step_sum"].inc(step_s)
    m["last_step"].set(step_s)
    breakdown = {"source": source, "step_time": step_s,
                 "data_time": data_s, "comm_time": comm_s,
                 "compile_time": compile_s}
    with _state.lock:
        _state.last = breakdown
    return breakdown


def last_breakdown():
    """The most recently completed step's breakdown dict ({} before the
    second boundary)."""
    with _state.lock:
        return dict(_state.last)


def reset():
    """Drop the interval state (metrics reset through the registry)."""
    with _state.lock:
        _state.last_boundary = None
        _state.data_s = _state.comm_s = _state.compile_s = 0.0
        _state.last = {}
