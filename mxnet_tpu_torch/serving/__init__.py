"""Serving front of the port: one-shot models (``Gateway.register`` /
``infer``, fp32 / bf16 / int8 variants; fp32 / bf16 over tp mesh slices)
and generative decode (``Gateway.generate``)."""
from __future__ import annotations

from .batcher import RejectedError, Request, ServingError, pad_batch
from .gateway import Gateway
from .sharded import DIVERGENCE_BOUND, ShardedVariantSet
from .variants import VariantSet, default_buckets, pick_bucket

__all__ = ["Gateway", "RejectedError", "Request", "ServingError",
           "VariantSet", "ShardedVariantSet", "DIVERGENCE_BOUND",
           "default_buckets", "pad_batch", "pick_bucket"]
