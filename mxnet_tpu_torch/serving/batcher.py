"""Serving error types (the subset of ``mxnet_tpu/serving/batcher.py``
the generative path raises; the one-shot batcher is a later slice)."""
from __future__ import annotations

from ..base import MXNetError


class ServingError(MXNetError):
    """Serving-layer failure (bad input, closed gateway, timeout)."""


class RejectedError(ServingError):
    """Fast-reject at admission (the 429 analogue): the request never
    entered the queue. ``reason`` is one of ``queue_full`` /
    ``kv_cache_full`` / ``closed``."""

    def __init__(self, reason, msg):
        super().__init__(msg)
        self.reason = reason
