"""The subset of ``mxnet_tpu/ops/nn.py`` the decoder reaches, as plain
torch ops (the JAX package leaves them to XLA; the port leaves them to
cuBLAS and PyTorch's elementwise kernels)."""
from __future__ import annotations

import torch

from ..base import MXNetError


def fully_connected(data, weight, bias=None, no_bias=False, flatten=True):
    """``x @ W.T + b`` with the reference's (num_hidden, in_units)
    weight layout."""
    x = data.reshape(data.shape[0], -1) if flatten else data
    out = torch.matmul(x, weight.t())
    if not no_bias and bias is not None:
        out = out + bias
    return out


def layer_norm(data, gamma, beta, axis=-1, eps=1e-5):
    """Normalise over ``axis`` with the biased variance, as the
    reference's LayerNorm does."""
    mean = data.mean(dim=axis, keepdim=True)
    var = (data - mean).square().mean(dim=axis, keepdim=True)
    ax = axis % data.ndim
    bshape = tuple(data.shape[ax] if i == ax else 1
                   for i in range(data.ndim))
    return (data - mean) * torch.rsqrt(var + eps) * gamma.reshape(bshape) \
        + beta.reshape(bshape)


def activation(data, act_type="relu"):
    if act_type == "relu":
        return torch.relu(data)
    raise MXNetError(f"act_type {act_type!r} unsupported")
