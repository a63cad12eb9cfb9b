"""One monotonic clock for every timeline the process emits (the port of
``mxnet_tpu/tracing/clock.py``).

The profiler's chrome-trace events, the tracing spans and the native
transport's server-side timestamps live on one time axis, so a merged
Perfetto document never interleaves two epochs.

``EPOCH_NS`` is captured once per process, at the first import of this
module; everything that renders a relative timestamp subtracts it.
Absolute values are ``time.monotonic_ns()``: on Linux that is
CLOCK_MONOTONIC, the clock C++'s ``steady_clock`` reads in
``_native/comm.cc``, so worker-Python, server-Python and server-C++
timestamps on one host compare directly. Across hosts, alignment is
``tools/trace_merge.py``'s job.
"""
from __future__ import annotations

import time

# process-wide monotonic epoch: captured once, shared by profiler.py
# (chrome-trace ts) and tracing (span export); never reassigned
EPOCH_NS = time.monotonic_ns()


def now_ns():
    """Current CLOCK_MONOTONIC time in nanoseconds (absolute)."""
    return time.monotonic_ns()


def rel_us(ns):
    """Absolute monotonic ns -> microseconds since the process epoch
    (the chrome-trace ``ts`` unit)."""
    return (ns - EPOCH_NS) / 1e3
