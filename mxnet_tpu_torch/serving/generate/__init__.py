"""Token-granular generative decode on the serving gateway (counterpart
of ``mxnet_tpu/serving/generate``):

- :mod:`.kvcache` — the paged block pool and per-request block tables;
- :mod:`.model` — the decoder LM (a gluon block, trainable), its
  prefill/decode steps (flash and paged attention kernels) and the
  unpaged greedy oracle;
- :mod:`.scheduler` — iteration-level continuous batching over one or
  more lanes, with ``kv_cache_full`` fast-reject and decode failover;
- :mod:`.migrate` — KV-block migration between two lanes' pools.

Entry points: ``Gateway.register_generator`` / ``Gateway.generate``.
"""
from __future__ import annotations

from .kvcache import PAD_BLOCK, BlockPool, BlockTable
from .migrate import KVMigrator, MigrationError
from .model import (DecodeSteps, DecoderLayer, DecoderLM,
                    GenerativeDecoder, params_from_jax, reference_generate)
from .scheduler import GenLane, GenModel, GenRequest

__all__ = ["PAD_BLOCK", "BlockPool", "BlockTable", "DecodeSteps",
           "DecoderLM", "DecoderLayer", "GenerativeDecoder", "GenLane",
           "GenModel", "GenRequest", "KVMigrator", "MigrationError",
           "params_from_jax",
           "reference_generate"]
