"""Ulysses (DeepSpeed-style) sequence parallelism (counterpart of
``mxnet_tpu/parallel/ulysses.py``): an all-to-all swaps the sharded
axis from sequence to heads, each head group attends over the full
sequence, and a second all-to-all swaps back. One collective round
each way instead of the ring's one a shard, but heads % sp must be 0.

The attention between the two all-to-alls is
:func:`~mxnet_tpu_torch.ops.attention.flash_attention`, as the JAX
package calls its Pallas ``flash_attention`` there: on a CUDA tensor
the port's K3 kernel (``csrc/flash_attention.cu``), on the CPU its plain
version.
"""
from __future__ import annotations

from ..ops.attention import flash_attention
from .collectives import alltoall


def ulysses_attention(q, k, v, axis_name, causal=False, scale=None):
    """Sequence-parallel attention via two all-to-alls; call inside
    :func:`~.mesh.shard_map` over ``axis_name``.

    q, k, v: [batch, seq_local, heads, head_dim], heads divisible by
    the axis size. Returns [batch, seq_local, heads, head_dim]."""
    if scale is None:
        scale = q.shape[-1] ** -0.5

    def seq2head(x):
        # [B, Tl, H, D] -> [B, T, H / size, D]
        return alltoall(x, axis_name, split_axis=2, concat_axis=1)

    qg, kg, vg = seq2head(q), seq2head(k), seq2head(v)
    og = flash_attention(qg.transpose(1, 2), kg.transpose(1, 2),
                         vg.transpose(1, 2), causal=causal, scale=scale)
    # [B, T, H / size, D] -> [B, Tl, H, D]
    return alltoall(og.transpose(1, 2), axis_name, split_axis=1,
                    concat_axis=2)
