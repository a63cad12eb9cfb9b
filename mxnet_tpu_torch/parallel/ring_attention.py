"""Ring attention (counterpart of ``mxnet_tpu/parallel/ring_attention.py``):
exact attention over sequences sharded across a mesh axis, K/V blocks
rotating around the ring while each step folds one block into an
online-softmax accumulator.

The JAX package computes this outside any Pallas kernel (``einsum``,
``exp`` and ``where`` under ``lax.scan``), so the port does too: plain
torch ops, in the inputs' type, as the JAX function computes in
``q.dtype``.
"""
from __future__ import annotations

import functools

import torch

from .collectives import axis_index, axis_size, ppermute_next
from .mesh import PartitionSpec as P, shard_map

NEG_INF = -1e30


def _online_block(s, v, m_prev, l_prev, o_prev):
    """Fold one score block into the (m, l, o) online-softmax state."""
    m_new = torch.maximum(m_prev, s.amax(dim=-1))
    p = torch.exp(s - m_new[..., None])
    alpha = torch.exp(m_prev - m_new)
    l_new = alpha * l_prev + p.sum(dim=-1)
    o_new = alpha[..., None] * o_prev + torch.matmul(p, v)
    return m_new, l_new, o_new


def ring_attention(q, k, v, axis_name, causal=False, scale=None):
    """Exact attention with the sequence dim sharded on ``axis_name``;
    call inside :func:`~.mesh.shard_map` over it.

    q, k, v: [batch, heads, seq_local, head_dim] local shards;
    ``causal`` masks in *global* sequence positions."""
    b, h, t, d = q.shape
    size = axis_size(axis_name)
    idx = axis_index(axis_name)
    if scale is None:
        scale = d ** -0.5
    q = q * scale
    q_pos = idx * t + torch.arange(t, device=q.device)
    m = torch.full((b, h, t), NEG_INF, dtype=q.dtype, device=q.device)
    l = torch.zeros((b, h, t), dtype=q.dtype, device=q.device)
    o = torch.zeros_like(q)
    k_blk, v_blk = k, v
    for s in range(size):
        # after s rotations this shard holds the block of rank
        # (idx - s) mod size
        src = (idx - s) % size
        scores = torch.matmul(q, k_blk.transpose(-1, -2))
        if causal:
            k_pos = src * t + torch.arange(t, device=q.device)
            mask = q_pos[:, None] >= k_pos[None, :]
            scores = torch.where(mask, scores,
                                 torch.full((), NEG_INF, dtype=q.dtype,
                                            device=q.device))
        m, l, o = _online_block(scores, v_blk, m, l, o)
        if s + 1 < size:
            # the JAX scan also rotates after the last block; nothing
            # reads that rotation
            k_blk = ppermute_next(k_blk, axis_name)
            v_blk = ppermute_next(v_blk, axis_name)
    return o / torch.clamp(l, min=1e-20)[..., None]


def ring_attention_sharded(q, k, v, mesh, axis="sp", causal=False,
                           scale=None):
    """:func:`ring_attention` under :func:`~.mesh.shard_map` over
    ``axis``, inputs [batch, heads, seq, head_dim] with seq sharded."""
    spec = P(None, None, axis, None)
    fn = functools.partial(ring_attention, axis_name=axis, causal=causal,
                           scale=scale)
    return shard_map(fn, mesh=mesh, in_specs=(spec, spec, spec),
                     out_specs=spec, check_vma=False)(q, k, v)
