"""Monitor — per-op output statistics during training (the port of
``mxnet_tpu/monitor.py``; ref: python/mxnet/monitor.py Monitor).

Taps every operator output through the executor's monitor callback
(``Executor.set_monitor_callback``: the executor hands each node's
outputs to the callback as its graph walk produces them, the reference's
ExecuteMonCallback, graph_executor.cc:1294) and aggregates a statistic
per tensor every ``interval`` batches.

``stat_helper`` and the default ``stat_func`` never read the card: the
statistic is queued as a tensor, still in flight. The one transfer to
the host happens at ``toc()``: the interval's queued statistics are
flattened into one tensor a (device, dtype) and copied once, so an armed
Monitor adds no sync to ``Executor.forward`` or ``Module.fit``'s step;
``toc`` waits for the card.
"""
from __future__ import annotations

import logging
import re

import numpy as np
import torch

from .ndarray import NDArray
from .ops.registry import bf16_to_numpy


class Monitor:
    def __init__(self, interval, stat_func=None, pattern=".*", sort=False,
                 monitor_all=False):
        if stat_func is None:
            def stat_func(x):  # noqa: ANN001
                return x.abs().mean()  # the reference's default |x|.mean()
        self.stat_func = stat_func
        self.interval = interval
        self.queue = []
        self.step = 0
        self.activated = False
        self.re_prog = re.compile(pattern)
        self.sort = sort
        self.monitor_all = monitor_all
        self.logger = logging.getLogger(__name__)

    def install(self, exe, monitor_all=None):
        """Attach to an executor (ref: monitor.py install)."""
        if monitor_all is None:
            monitor_all = self.monitor_all
        exe.set_monitor_callback(self.stat_helper, monitor_all)

    def stat_helper(self, name, arr):
        """Per-tensor tap: compute the statistic and queue it as a tensor
        (never read here)."""
        if not self.activated or not self.re_prog.match(name):
            return
        arr = arr if isinstance(arr, NDArray) else NDArray(arr)
        self.queue.append((self.step, name, self.stat_func(arr)))

    def tic(self):
        """Start collecting for this batch if the interval has elapsed."""
        if self.step % self.interval == 0:
            self.queue = []
            self.activated = True
        self.step += 1

    def toc(self):
        """Finish the batch; returns [(step, tensor_name, stat_str)]. The
        read point: the interval's statistics reach the host in one copy
        a (device, dtype)."""
        if not self.activated:
            return []
        self.activated = False
        if self.sort:
            self.queue.sort(key=lambda x: x[1])
        queue, self.queue = self.queue, []
        host = _to_host([s._data if isinstance(s, NDArray)
                         else torch.as_tensor(s) for _, _, s in queue])
        return [(step, name, str(val.ravel()))
                for (step, name, _), val in zip(queue, host)]

    def toc_print(self):
        for step, name, stat in self.toc():
            self.logger.info("Batch: %7d %30s %s", step, name, stat)


def _to_host(tensors):
    """numpy copies of ``tensors``, one transfer a (device, dtype)."""
    groups = {}
    for i, t in enumerate(tensors):
        groups.setdefault((t.device, t.dtype), []).append(i)
    out = [None] * len(tensors)
    for idx in groups.values():
        parts = [tensors[i].detach() for i in idx]
        flat = torch.cat([p.reshape(-1) for p in parts]).cpu()
        off = 0
        for i, p in zip(idx, parts):
            n = p.numel()
            v = flat[off:off + n].reshape(p.shape)
            out[i] = bf16_to_numpy(v) if v.dtype == torch.bfloat16 \
                else v.numpy()
            off += n
    return out
