"""Parallel layouts of the port (counterpart of ``mxnet_tpu/parallel``):
an in-process device mesh whose :func:`shard_map` runs one thread per
position, named collectives over its axes, the layout table, and the
tensor-, sequence-, pipeline- and expert-parallel functions written
against them, the sharded training steps (ZeRO 1-3) of
``train_step.py``, and ``collectives_summary`` of what a program issued."""
from __future__ import annotations

from .collectives import (allgather, allreduce, alltoall, axis_index,
                          axis_size, ppermute_next, reduce_scatter)
from .layout import (SpecLayout, collective_shardings, collectives_summary,
                     dryrun_report, zero_shard_leaf)
from .mesh import (Mesh, NamedSharding, PartitionSpec, Sharded,
                   auto_mesh_shape, create_mesh, free_pool, mesh_sharding,
                   replica_devices, replica_slices, run_shards, shard_batch,
                   shard_map, should_warn_degraded)
from .moe import moe_dispatch, moe_ffn
from .pipeline import pipeline_apply, stack_stage_params
from .ring_attention import ring_attention, ring_attention_sharded
from .train_step import (make_sharded_train_step, make_zero_train_step,
                         sgd_update)
from .tensor_parallel import (column_parallel_dense, row_parallel_dense,
                              tp_mlp, tp_mlp_param_specs,
                              tp_qkv_param_specs)
from .ulysses import ulysses_attention

__all__ = [
    "create_mesh", "auto_mesh_shape", "mesh_sharding", "shard_batch",
    "shard_map", "replica_devices", "replica_slices", "free_pool",
    "should_warn_degraded", "run_shards", "Mesh", "NamedSharding", "PartitionSpec",
    "Sharded",
    "SpecLayout", "collective_shardings", "collectives_summary",
    "dryrun_report",
    "zero_shard_leaf",
    "allreduce", "allgather", "alltoall", "axis_index", "axis_size",
    "ppermute_next", "reduce_scatter",
    "ring_attention", "ring_attention_sharded", "ulysses_attention",
    "column_parallel_dense", "row_parallel_dense", "tp_mlp",
    "tp_mlp_param_specs", "tp_qkv_param_specs",
    "pipeline_apply", "stack_stage_params", "moe_dispatch", "moe_ffn",
    "make_sharded_train_step", "make_zero_train_step", "sgd_update",
]
