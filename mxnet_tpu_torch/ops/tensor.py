"""The subset of ``mxnet_tpu/ops/tensor.py`` the decoder reaches."""
from __future__ import annotations

import torch.nn.functional as F


def embedding(data, weight):
    """Row lookup that clips indices to ``[0, vocab - 1]`` as the
    reference does; a bare ``F.embedding`` would raise on them."""
    idx = data.long().clamp(0, weight.shape[0] - 1)
    return F.embedding(idx, weight)
