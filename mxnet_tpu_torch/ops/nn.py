"""Neural-network ops of ``mxnet_tpu/ops/nn.py`` the port has reached,
as plain torch ops: the JAX package leaves them to XLA, the port to
cuBLAS, cuDNN and PyTorch's elementwise kernels. Layouts follow the
JAX package (NCHW data, OIHW weights, (num_hidden, in_units) FC
weights). The symbolic executor runs BatchNorm in inference mode only;
training arrives with the training slice."""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..base import MXNetError
from .registry import register


@register("FullyConnected")
def fully_connected(data, weight, bias=None, num_hidden=0, no_bias=False,
                    flatten=True):
    """``x @ W.T + b`` with the reference's (num_hidden, in_units)
    weight layout."""
    x = data.reshape(data.shape[0], -1) if flatten else data
    out = torch.matmul(x, weight.t())
    if not no_bias and bias is not None:
        out = out + bias
    return out


def _spatial(vals, nd, fill):
    vals = tuple(int(v) for v in vals)
    return vals or (fill,) * nd


@register("Convolution")
def convolution(data, weight, bias=None, kernel=(), stride=(), dilate=(),
                pad=(), num_filter=0, num_group=1, no_bias=False,
                layout=None, workspace=1024, cudnn_tune=None,
                cudnn_off=False):
    nd = len(kernel)
    if nd not in (1, 2, 3) or (layout or "NC") not in ("NCW", "NCHW",
                                                      "NCDHW", "NC"):
        raise MXNetError(f"Convolution: {nd}-d kernel with layout "
                         f"{layout!r} unsupported (channel-first only)")
    conv = (F.conv1d, F.conv2d, F.conv3d)[nd - 1]
    b = None if no_bias else bias
    return conv(data, weight, b, stride=_spatial(stride, nd, 1),
                padding=_spatial(pad, nd, 0),
                dilation=_spatial(dilate, nd, 1), groups=int(num_group))


def _pool_pads(shape, kernel, stride, pad, convention):
    """(low, high) padding per spatial dim; ``full`` pads the high side
    so the last partial window counts (ceil mode), as the JAX op does."""
    pads = []
    for size, k, s, p in zip(shape, kernel, stride, pad):
        extra = 0
        if convention == "full":
            span = size + 2 * p
            extra = (s - (span - k) % s) % s if span > k else 0
        pads.append((p, p + extra))
    return pads


@register("Pooling")
def pooling(data, kernel=(), pool_type="max", stride=(), pad=(),
            global_pool=False, pooling_convention="valid", cudnn_off=False,
            p_value=2, count_include_pad=True, layout=None):
    """2-d max / avg / sum pooling over NCHW. An average is the window
    sum times the f32 reciprocal of the window size, as XLA lowers the
    JAX op's division by a constant (bitwise on integer-valued input)."""
    if data.ndim != 4 or (layout or "NCHW") != "NCHW":
        raise MXNetError("Pooling: only 2-d NCHW pooling is ported")
    if global_pool:
        kernel, stride, pad = data.shape[2:], (1, 1), (0, 0)
    kernel = tuple(int(k) for k in kernel)
    stride = _spatial(stride, 2, 1)
    pad = _spatial(pad, 2, 0)
    pads = _pool_pads(data.shape[2:], kernel, stride, pad,
                      pooling_convention)
    flat = (pads[1][0], pads[1][1], pads[0][0], pads[0][1])
    if pool_type == "max":
        x = F.pad(data, flat, value=float("-inf"))
        return F.max_pool2d(x, kernel, stride)
    if pool_type not in ("avg", "sum"):
        raise MXNetError(f"pool_type {pool_type!r} unsupported")
    summed = F.avg_pool2d(F.pad(data, flat), kernel, stride,
                          divisor_override=1)
    if pool_type == "sum":
        return summed
    if count_include_pad:
        inv = np.float32(1) / np.float32(int(np.prod(kernel)))
        return summed * float(inv)
    counts = F.avg_pool2d(F.pad(torch.ones_like(data), flat), kernel,
                          stride, divisor_override=1)
    return summed / counts


@register("Activation")
def activation(data, act_type="relu"):
    if act_type == "relu":
        return torch.relu(data)
    if act_type == "sigmoid":
        return torch.sigmoid(data)
    if act_type == "tanh":
        return torch.tanh(data)
    if act_type == "softrelu":
        return torch.log1p(torch.exp(-data.abs())) + torch.relu(data)
    if act_type == "softsign":
        return data / (1 + data.abs())
    raise MXNetError(f"act_type {act_type!r} unsupported")


@register("BatchNorm")
def batch_norm(data, gamma, beta, moving_mean, moving_var, eps=1e-3,
               momentum=0.9, fix_gamma=True, use_global_stats=False,
               output_mean_var=False, axis=1, cudnn_off=False,
               training=False):
    """Inference BatchNorm over the moving statistics, in the JAX op's
    arithmetic: ``(x - mean) * (rsqrt(var + eps) * g) + beta``."""
    if training and not use_global_stats:
        raise MXNetError("BatchNorm: training mode arrives with the "
                         "training slice of the port")
    axis = int(axis) % data.ndim
    bshape = tuple(data.shape[axis] if i == axis else 1
                   for i in range(data.ndim))
    g = torch.ones_like(gamma) if fix_gamma else gamma
    inv = torch.rsqrt(moving_var + eps)
    out = (data - moving_mean.reshape(bshape)) * (inv * g).reshape(bshape) \
        + beta.reshape(bshape)
    out = out.to(data.dtype)
    if output_mean_var:
        return out, moving_mean, moving_var
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
