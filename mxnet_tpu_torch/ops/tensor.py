"""The subset of ``mxnet_tpu/ops/tensor.py`` the port reaches."""
from __future__ import annotations

import torch.nn.functional as F

from .registry import register


def embedding(data, weight):
    """Row lookup that clips indices to ``[0, vocab - 1]`` as the
    reference does; a bare ``F.embedding`` would raise on them."""
    idx = data.long().clamp(0, weight.shape[0] - 1)
    return F.embedding(idx, weight)


@register("Flatten", aliases=("flatten",))
def flatten(data):
    return data.reshape(data.shape[0], -1)


@register("Embedding")
def embedding_op(data, weight, input_dim=0, output_dim=0, dtype="float32",
                 sparse_grad=False):
    return embedding(data, weight)


@register("transpose")
def transpose(data, axes=()):
    axes = tuple(int(a) for a in axes) or tuple(range(data.ndim))[::-1]
    return data.permute(axes)
