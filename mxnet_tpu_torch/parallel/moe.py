"""Expert parallelism (counterpart of ``mxnet_tpu/parallel/moe.py``):
GShard-style top-1 routed mixture of experts with a fixed capacity,
experts sharded over an ``ep`` mesh axis and tokens moved by a pair of
all-to-alls.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..base import MXNetError
from .collectives import alltoall, axis_size
from .tensor_parallel import gelu


def _one_hot(idx, n, dtype):
    """``jax.nn.one_hot``: rows of indices outside [0, n) are zeros."""
    valid = (idx >= 0) & (idx < n)
    return F.one_hot(idx.clamp(0, n - 1), n).to(dtype) \
        * valid[..., None].to(dtype)


def moe_dispatch(x, router_logits, expert_fn, axis_name="ep",
                 capacity_factor=2.0):
    """Top-1 routed MoE layer body; call inside :func:`~.mesh.shard_map`
    over ``axis_name``.

    x: [tokens_local, d_model]; router_logits: [tokens_local,
    n_experts_total]; ``expert_fn`` maps this shard's
    [n_local_experts, capacity_total, d] to the same shape. Each expert
    takes at most ``capacity_factor * tokens / experts`` tokens of a
    shard; tokens past it are dropped (zeros out; the caller's residual
    carries them). Returns [tokens_local, d_model]."""
    t, _ = x.shape
    e = router_logits.shape[-1]
    size = axis_size(axis_name)
    if e % size:
        raise MXNetError(f"moe: {e} experts do not divide the ep axis "
                         f"of {size}")
    cap = int(max(1, capacity_factor * t / e))

    gates = torch.softmax(router_logits, dim=-1)              # [T, E]
    expert_idx = torch.argmax(gates, dim=-1)                  # [T]
    gate_val = gates.gather(1, expert_idx[:, None])[:, 0]

    onehot = _one_hot(expert_idx, e, x.dtype)                 # [T, E]
    pos = torch.cumsum(onehot, dim=0) * onehot - 1.0          # slot
    keep = (pos < cap) & (onehot > 0)                         # capacity
    pos_oh = _one_hot(pos.to(torch.int64), cap, x.dtype)      # [T, E, C]
    dispatch = keep[..., None].to(x.dtype) * pos_oh
    combine = dispatch * gate_val[:, None, None]

    expert_in = torch.einsum("tec,td->ecd", dispatch, x)      # [E, C, D]
    # each shard keeps its E / size experts, with every peer's capacity
    # slices for them: [E / size, C * size, D]
    expert_in = alltoall(expert_in, axis_name, split_axis=0, concat_axis=1)
    expert_out = expert_fn(expert_in)
    expert_out = alltoall(expert_out, axis_name, split_axis=1,
                          concat_axis=0)                      # [E, C, D]
    return torch.einsum("tec,ecd->td", combine, expert_out)


def moe_ffn(x, router_w, w1, w2, axis_name="ep", capacity_factor=2.0,
            act=gelu):
    """Expert-parallel FFN: router + two-layer experts. w1:
    [n_local_experts, d_model, d_hidden]; w2: [n_local_experts,
    d_hidden, d_model]; router_w: [d_model, n_experts_total]."""
    def experts(xs):  # [E_local, C_total, D]
        h = act(torch.einsum("ecd,edh->ech", xs, w1))
        return torch.einsum("ech,ehd->ecd", h, w2)

    return moe_dispatch(x, x @ router_w, experts, axis_name=axis_name,
                        capacity_factor=capacity_factor)
