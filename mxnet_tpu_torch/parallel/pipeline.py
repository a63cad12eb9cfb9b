"""Pipeline parallelism (counterpart of ``mxnet_tpu/parallel/pipeline.py``):
a GPipe-style microbatch schedule over a ``pp`` mesh axis, activations
passed from stage to stage by :func:`~.collectives.ppermute_next`.
"""
from __future__ import annotations

import torch

from .collectives import allreduce, axis_index, axis_size, ppermute_next
from .mesh import _map_leaves


def pipeline_apply(fn, stage_params, x, axis_name="pp",
                   squeeze_stage_axis=True):
    """Run a pipelined stack of stages over microbatches; call inside
    :func:`~.mesh.shard_map` over ``axis_name``, each shard holding its
    own stage's parameters.

    ``fn(params, x_mb) -> y_mb`` is one stage and keeps the shape;
    ``stage_params`` is this shard's block of a stack made by
    :func:`stack_stage_params` (leading axis of size 1, squeezed unless
    ``squeeze_stage_axis`` is False); ``x`` is [n_micro, mb, ...],
    replicated. Returns the last stage's [n_micro, mb, ...] outputs on
    every shard (every stage runs every step, as in the JAX schedule;
    the other stages' outputs are masked out and the last stage's
    broadcast by an allreduce)."""
    if squeeze_stage_axis:
        stage_params = _map_leaves(lambda a: a[0], stage_params)
    n_stage = axis_size(axis_name)
    stage = axis_index(axis_name)
    n_micro = x.shape[0]
    is_first, is_last = stage == 0, stage == n_stage - 1
    state = torch.zeros_like(x[0])
    outs = torch.zeros_like(x)
    for t in range(n_micro + n_stage - 1):
        # stage 0 ingests microbatch t; every other stage the activation
        # the stage before sent last step
        y = fn(stage_params, x[min(t, n_micro - 1)] if is_first else state)
        # the last stage emits microbatch t - (n_stage - 1)
        out_idx = t - (n_stage - 1)
        if is_last and out_idx >= 0:
            outs[out_idx] = y
        state = ppermute_next(y, axis_name)
    return allreduce(outs if is_last else torch.zeros_like(outs), axis_name)


def stack_stage_params(per_stage_params):
    """Stack a list of per-stage pytrees along a new leading axis, to be
    split over ``pp`` with ``PartitionSpec('pp', ...)``."""
    return _map_leaves(lambda *xs: torch.stack(xs), *per_stage_params)
