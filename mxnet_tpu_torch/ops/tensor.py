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
