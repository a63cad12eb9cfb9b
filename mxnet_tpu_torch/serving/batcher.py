"""Request queues and shape-bucket coalescing for one-shot serving (the
port of ``mxnet_tpu/serving/batcher.py``), and the serving error types.

The lane loop of a model (``serving/gateway.py``) calls
:meth:`ModelQueue.take_batch`, which blocks for the first pending
request and then coalesces same-variant requests into one batch of at
most ``max_rows`` rows, waiting at most until the FIRST request's
``submit + max_wait`` before dispatching a partial batch: latency at
batch 1 is bounded by ``max_wait`` plus one execution.

A batch never mixes variants (one executable serves one dtype); with
several variants pending, the one whose head request is oldest goes
first, so no variant starves.
"""
from __future__ import annotations

import threading
import time
from collections import deque

import numpy as np

from ..base import MXNetError


class ServingError(MXNetError):
    """Serving-layer failure (bad input, closed gateway, timeout)."""


class RejectedError(ServingError):
    """Fast-reject at admission (the 429 analogue): the request never
    entered the queue. ``reason`` is one of ``queue_full`` / ``slo`` /
    ``kv_cache_full`` / ``no_replica`` / ``closed``."""

    def __init__(self, reason, msg):
        super().__init__(msg)
        self.reason = reason


def now_ns():
    """The serving clock: monotonic nanoseconds."""
    return time.monotonic_ns()


class Request:
    """One in-flight inference request and its reply future.

    ``data`` is a numpy array of shape ``(rows,) + feature_shape``; the
    batcher stacks requests along axis 0 and splits the outputs back.
    Timestamps (monotonic ns, ``tracing.clock``'s clock) accumulate as the
    request moves through the pipeline: ``submit_ns`` orders the queue
    and starts the max_wait hold, ``dequeue_ns`` / ``exec_start_ns`` /
    ``exec_end_ns`` bound its batch's assembly and execution (the end
    when the outputs reached the host). At reply the gateway records the
    request -> queue -> batch -> execute -> reply span chain under
    ``trace_ctx`` from them; ``hold_ns`` (the batch's coalescing hold)
    and ``requeue_ns`` (time lost on failed replicas) are attributes of
    the queue span.
    """

    __slots__ = ("model", "variant", "data", "rows", "trace_ctx",
                 "submit_ns", "dequeue_ns", "exec_start_ns",
                 "exec_end_ns", "attempts", "hold_ns", "requeue_ns",
                 "_event", "_result", "_error")

    def __init__(self, model, variant, data, trace_ctx=(0, 0)):
        self.model = model
        self.variant = variant
        self.data = data
        self.rows = int(data.shape[0])
        self.trace_ctx = trace_ctx
        self.submit_ns = now_ns()
        self.dequeue_ns = 0
        self.exec_start_ns = 0
        # executions tried: a request that failed on every replica is
        # the poison pill, failed instead of redistributed again
        self.attempts = 0
        self.exec_end_ns = 0
        self.hold_ns = 0
        self.requeue_ns = 0
        self._event = threading.Event()
        self._result = None
        self._error = None

    def done(self):
        return self._event.is_set()

    def result(self, timeout=None):
        """Block for the reply: a list of numpy outputs, each of shape
        ``(rows,) + output_feature``. Raises the serving-side error if
        the request failed."""
        if not self._event.wait(timeout):
            raise ServingError(
                f"serving: request on {self.model!r} timed out after "
                f"{timeout}s (still queued or executing)")
        if self._error is not None:
            raise self._error
        return self._result

    def _set_result(self, outs):
        self._result = outs
        self._event.set()

    def _set_error(self, err):
        self._error = err
        self._event.set()


class ModelQueue:
    """Pending requests for one model, by variant. Producers are client
    threads (``Gateway.submit``), the consumer is the model's lane
    thread; ``requeue`` puts a batch back at the FRONT in its order."""

    def __init__(self, max_rows, max_wait_s):
        self.max_rows = int(max_rows)
        self.max_wait_s = float(max_wait_s)
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._by_variant = {}
        self._rows = 0
        self.closed = False

    def depth(self):
        with self._lock:
            return sum(len(d) for d in self._by_variant.values())

    def pending_rows(self):
        with self._lock:
            return self._rows

    def put(self, req):
        with self._cond:
            if self.closed:
                raise RejectedError(
                    "closed", f"serving: model {req.model!r} is closed")
            self._by_variant.setdefault(req.variant, deque()).append(req)
            self._rows += req.rows
            # notify_all: a lane holding another variant's partial batch
            # must not swallow the only wakeup
            self._cond.notify_all()

    def requeue(self, reqs):
        """Back at the front, original order preserved."""
        now = now_ns()
        with self._cond:
            for req in reversed(reqs):
                # the failed attempt's dequeue -> now is lost time; the
                # retry stamps dequeue_ns again when its batch runs
                if req.dequeue_ns:
                    req.requeue_ns += max(now - req.dequeue_ns, 0)
                    req.dequeue_ns = 0
                self._by_variant.setdefault(
                    req.variant, deque()).appendleft(req)
                self._rows += req.rows
            self._cond.notify_all()

    def close(self):
        with self._cond:
            self.closed = True
            self._cond.notify_all()

    def drain(self):
        """Remove and return every pending request (shutdown: the
        caller fails them instead of leaving clients hanging)."""
        with self._cond:
            out = []
            for d in self._by_variant.values():
                out.extend(d)
                d.clear()
            self._rows = 0
            return out

    def _scoop(self, dq, batch, rows):
        """Move as many head requests as still fit into ``batch``
        (under the lock)."""
        while dq and rows + dq[0].rows <= self.max_rows:
            r = dq.popleft()
            batch.append(r)
            rows += r.rows
            self._rows -= r.rows
        return rows

    def wake(self):
        """Wake every lane blocked in :meth:`take_batch`, so a lane whose
        ``stop`` turned true leaves now instead of at the next request."""
        with self._cond:
            self._cond.notify_all()

    def take_batch(self, stop=None):
        """Block until work arrives, then coalesce one same-variant
        batch: ``(variant, [requests])``, or None once the queue closed
        empty or, waiting, the lane's ``stop()`` is true (a retired or
        superseded lane leaves without taking work)."""
        with self._cond:
            while True:
                pending = [(v, d) for v, d in self._by_variant.items()
                           if d]
                if pending:
                    break
                if self.closed or (stop is not None and stop()):
                    return None
                self._cond.wait()
            # the oldest head request goes first: no variant starves
            variant, dq = min(pending, key=lambda vd: vd[1][0].submit_ns)
            first = dq.popleft()
            self._rows -= first.rows
            batch = [first]
            rows = self._scoop(dq, batch, first.rows)
            deadline_ns = first.submit_ns + int(self.max_wait_s * 1e9)
            hold_ns = 0
            while rows < self.max_rows and not self.closed:
                now = now_ns()
                remaining = (deadline_ns - now) / 1e9
                if remaining <= 0:
                    break
                self._cond.wait(remaining)
                hold_ns += now_ns() - now
                rows = self._scoop(dq, batch, rows)
            # the coalescing hold, stamped on every member of the batch
            for r in batch:
                r.hold_ns = hold_ns
            return variant, batch


def pad_batch(reqs, bucket, feature_shape, dtype):
    """Stack request rows into one ``(bucket,) + feature_shape`` array,
    zero-padding the tail. Returns ``(padded, rows)``."""
    rows = sum(r.rows for r in reqs)
    out = np.zeros((bucket,) + tuple(feature_shape), dtype)
    off = 0
    for r in reqs:
        out[off:off + r.rows] = r.data
        off += r.rows
    return out, rows
