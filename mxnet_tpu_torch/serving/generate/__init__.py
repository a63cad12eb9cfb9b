"""Token-granular generative decode on the serving gateway (counterpart
of ``mxnet_tpu/serving/generate``):

- :mod:`.kvcache` — the paged block pool and per-request block tables;
- :mod:`.model` — the decoder LM, its prefill/decode steps (flash and
  paged attention kernels) and the unpaged greedy oracle;
- :mod:`.scheduler` — iteration-level continuous batching with
  ``kv_cache_full`` fast-reject.

Entry points: ``Gateway.register_generator`` / ``Gateway.generate``.
"""
from __future__ import annotations

from .kvcache import PAD_BLOCK, BlockPool, BlockTable
from .model import (DecodeSteps, GenerativeDecoder, params_from_jax,
                    reference_generate)
from .scheduler import GenLane, GenModel, GenRequest

__all__ = ["PAD_BLOCK", "BlockPool", "BlockTable", "DecodeSteps",
           "GenerativeDecoder", "GenLane", "GenModel", "GenRequest",
           "params_from_jax", "reference_generate"]
