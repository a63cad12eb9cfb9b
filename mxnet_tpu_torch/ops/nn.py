"""Neural-network ops of ``mxnet_tpu/ops/nn.py`` the port has reached,
as plain torch ops: the JAX package leaves them to XLA, the port to
cuBLAS, cuDNN and PyTorch's elementwise kernels. Layouts follow the
JAX package (NCHW data, OIHW weights, (num_hidden, in_units) FC
weights). Gradients are autograd's, except SoftmaxOutput's, which is
the reference's loss-layer rule (a ``torch.autograd.Function``)."""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..base import MXNetError, attr_bool
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


def batch_moments(data, axis=1):
    """Batch mean and biased variance (``jnp.var``'s) over every axis
    but ``axis``."""
    axis = int(axis) % data.ndim
    dims = tuple(i for i in range(data.ndim) if i != axis)
    var, mean = torch.var_mean(data, dim=dims, correction=0)
    return mean, var


@register("BatchNorm")
def batch_norm(data, gamma, beta, moving_mean, moving_var, eps=1e-3,
               momentum=0.9, fix_gamma=True, use_global_stats=False,
               output_mean_var=False, axis=1, cudnn_off=False,
               training=False):
    """Inference: BatchNorm over the moving statistics, in the JAX op's
    arithmetic, ``(x - mean) * (rsqrt(var + eps) * g) + beta``.
    Training: over the batch mean and biased variance, through cuDNN's
    batch norm (its backward differentiates through the batch
    statistics, as ``jax.vjp`` of the JAX op does). The op keeps no
    running statistics: the executor updates the moving ones
    (``executor.py``), from :func:`batch_moments`."""
    axis = int(axis) % data.ndim
    g = torch.ones_like(gamma) if attr_bool(fix_gamma, True) else gamma
    if attr_bool(training) and not attr_bool(use_global_stats):
        x = data.movedim(axis, 1)
        out = F.batch_norm(x, None, None, g, beta, training=True,
                           eps=float(eps)).movedim(1, axis)
        if attr_bool(output_mean_var):
            return (out,) + batch_moments(data, axis)
        return out
    bshape = tuple(data.shape[axis] if i == axis else 1
                   for i in range(data.ndim))
    inv = torch.rsqrt(moving_var + eps)
    out = (data - moving_mean.reshape(bshape)) * (inv * g).reshape(bshape) \
        + beta.reshape(bshape)
    out = out.to(data.dtype)
    if output_mean_var:
        return out, moving_mean, moving_var
    return out


def softmax_output_grad(out, label, axis=-1, grad_scale=1.0,
                        ignore_label=-1.0, use_ignore=False,
                        normalization="null", smooth_alpha=0.0):
    """The reference's SoftmaxOutput gradient wrt its data,
    ``(softmax - onehot(label)) * scale``, whatever the head gradient
    (src/operator/softmax_output-inl.h; the JAX op's ``f_bwd``)."""
    axis = axis % out.ndim
    nclass = out.shape[axis]
    classes = torch.arange(nclass, device=out.device).reshape(
        [nclass if i == axis else 1 for i in range(out.ndim)])
    # a label outside [0, nclass) (ignore_label -1) has an all-zero row,
    # as jax.nn.one_hot gives it
    onehot = (label.to(torch.int32).unsqueeze(axis) == classes).to(out.dtype)
    if smooth_alpha:
        onehot = onehot * (1 - smooth_alpha) \
            + smooth_alpha / (nclass - 1) * (1 - onehot)
    grad = out - onehot
    if use_ignore:
        keep = (label != ignore_label).to(out.dtype)
        grad = grad * keep.unsqueeze(axis)
    if normalization == "batch":
        return grad * (grad_scale / out.shape[0])
    if normalization == "valid" and use_ignore:
        nvalid = torch.clamp_min((label != ignore_label).sum(), 1)
        scale = torch.tensor(grad_scale, dtype=torch.float32,
                             device=out.device) / nvalid.to(torch.float32)
        return grad * scale
    return grad * grad_scale


class _SoftmaxOutput(torch.autograd.Function):
    """Softmax forward, the loss layer's gradient backward; the label
    gets none (the JAX op returns zeros for it)."""

    @staticmethod
    def forward(ctx, data, label, axis, cfg):
        out = torch.softmax(data, dim=axis)
        ctx.save_for_backward(out, label)
        ctx.axis, ctx.cfg = axis, cfg
        return out

    @staticmethod
    def backward(ctx, head_grad):
        out, label = ctx.saved_tensors
        grad = softmax_output_grad(out, label, ctx.axis, *ctx.cfg)
        return grad, None, None, None


@register("SoftmaxOutput", aliases=("Softmax",))
def softmax_output(data, label, grad_scale=1.0, ignore_label=-1.0,
                   use_ignore=False, multi_output=False, preserve_shape=False,
                   normalization="null", out_grad=False, smooth_alpha=0.0):
    """Softmax over the last axis (axis 1 with ``multi_output``); its
    gradient is :func:`softmax_output_grad`."""
    multi = attr_bool(multi_output)
    if not multi and label.ndim == data.ndim and label.shape[-1] == 1:
        label = label.reshape(label.shape[:-1])  # (N, 1) labels, as CSVIter
    cfg = (float(grad_scale), float(ignore_label), attr_bool(use_ignore),
           str(normalization), float(smooth_alpha))
    return _SoftmaxOutput.apply(data, label, 1 if multi else -1, cfg)


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
