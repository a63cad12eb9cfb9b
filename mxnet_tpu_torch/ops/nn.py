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


_CHANNEL_FIRST = {"NCW": 1, "NCHW": 2, "NCDHW": 3}
_CHANNEL_LAST = {"NWC": 1, "NHWC": 2, "NDHWC": 3}


def _channel_last(layout, nd, op):
    """Whether ``layout`` puts the channels last, for an ``nd``-d
    spatial op; an unknown layout or one of another rank raises. The
    JAX package tells XLA where C lives; the port moves the channel
    axis around torch's channel-first op, which on the card is a view
    that cuDNN reads as its channels-last memory format (no copy)."""
    if layout is None or _CHANNEL_FIRST.get(layout) == nd:
        return False
    if _CHANNEL_LAST.get(layout) == nd:
        return True
    raise MXNetError(f"{op}: unsupported layout {layout!r} for a {nd}-d "
                     "kernel")


@register("Convolution")
def convolution(data, weight, bias=None, kernel=(), stride=(), dilate=(),
                pad=(), num_filter=0, num_group=1, no_bias=False,
                layout=None, workspace=1024, cudnn_tune=None,
                cudnn_off=False):
    """N-d convolution with OIHW weights in any layout: a channel-last
    ``layout`` (NWC, NHWC, NDHWC) keeps the weights OIHW and moves only
    the data's channel axis, as the JAX op does."""
    nd = len(kernel)
    if nd not in (1, 2, 3):
        raise MXNetError(f"Convolution: {nd}-d kernel unsupported")
    last = _channel_last(layout, nd, "Convolution")
    conv = (F.conv1d, F.conv2d, F.conv3d)[nd - 1]
    b = None if no_bias else bias
    x = data.movedim(-1, 1) if last else data
    out = conv(x, weight, b, stride=_spatial(stride, nd, 1),
               padding=_spatial(pad, nd, 0),
               dilation=_spatial(dilate, nd, 1), groups=int(num_group))
    return out.movedim(1, -1) if last else out


@register("_contrib_s2d_stem_conv")
def s2d_stem_conv(data, weight, stride=2, pad=3, block=2, layout="NCHW"):
    """The KxK stride-s stem convolution computed in space-to-depth
    form: the image is cut into ``block`` x ``block`` tiles stacked on
    the channel axis, and the SAME OIHW weight (front-padded to a
    multiple of the block) is rearranged into the equivalent
    (K/b)x(K/b) stride-s/b convolution over C*b*b channels. Checkpoints
    therefore interchange with the standard stem (the JAX op's
    contract, ``mxnet_tpu/ops/nn.py`` ``s2d_stem_conv``)."""
    o, c, kh, _ = weight.shape
    b, s, p = int(block), int(stride), int(pad)
    if s % b != 0:
        raise MXNetError("s2d stem: block must divide stride")
    front = (-kh) % b
    if (p + front) % b != 0:
        # the blocked window start b*(t*sp - pl) must equal the
        # reference's t*s - (p + front); flooring pl would shift pixels
        raise MXNetError(f"s2d stem: pad {p} with kernel {kh} is not "
                         f"block-{b} alignable")
    kp = (kh + front) // b
    # (O, C, kh', py, kw', px) -> (O, py, px, C, kh', kw') -> OIHW'
    wp = F.pad(weight, (front, 0, front, 0)).reshape(
        o, c, kp, b, kp, b).permute(0, 3, 5, 1, 2, 4).reshape(
            o, c * b * b, kp, kp)
    last = _channel_last(layout, 2, "s2d stem")
    if last:
        n, h, w, _ = data.shape
        xp = data.reshape(n, h // b, b, w // b, b, c).permute(
            0, 1, 3, 2, 4, 5).reshape(n, h // b, w // b, b * b * c)
        xp = xp.movedim(-1, 1)
    else:
        n, _, h, w = data.shape
        xp = data.reshape(n, c, h // b, b, w // b, b).permute(
            0, 3, 5, 1, 2, 4).reshape(n, c * b * b, h // b, w // b)
    sp, pl = s // b, (p + front) // b

    def right(size):
        # per-axis right pad: it cancels across axes only if stride == b
        out_sz = (size + 2 * p - kh) // s + 1
        return (out_sz - 1) * sp + kp - size // b - pl

    out = F.conv2d(F.pad(xp, (pl, right(w), pl, right(h))), wp, stride=sp)
    return out.movedim(1, -1) if last else out


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
    """2-d max / avg / sum pooling over NCHW, or NHWC when ``layout``
    says so (the channel axis moved around torch's op, as in
    :func:`convolution`). An average is the window sum times the f32
    reciprocal of the window size, as XLA lowers the JAX op's division
    by a constant (bitwise on integer-valued input)."""
    if data.ndim != 4:
        raise MXNetError("Pooling: only 2-d pooling is ported")
    last = _channel_last(layout, 2, "Pooling")
    if last:
        data = data.movedim(-1, 1)
    if global_pool:
        kernel, stride, pad = data.shape[2:], (1, 1), (0, 0)
    kernel = tuple(int(k) for k in kernel)
    stride = _spatial(stride, 2, 1)
    pad = _spatial(pad, 2, 0)
    pads = _pool_pads(data.shape[2:], kernel, stride, pad,
                      pooling_convention)
    flat = (pads[1][0], pads[1][1], pads[0][0], pads[0][1])
    if pool_type == "max":
        out = F.max_pool2d(F.pad(data, flat, value=float("-inf")), kernel,
                           stride)
    elif pool_type in ("avg", "sum"):
        out = F.avg_pool2d(F.pad(data, flat), kernel, stride,
                           divisor_override=1)
        if pool_type == "avg" and count_include_pad:
            inv = np.float32(1) / np.float32(int(np.prod(kernel)))
            out = out * float(inv)
        elif pool_type == "avg":
            out = out / F.avg_pool2d(F.pad(torch.ones_like(data), flat),
                                     kernel, stride, divisor_override=1)
    else:
        raise MXNetError(f"pool_type {pool_type!r} unsupported")
    return out.movedim(1, -1) if last else out


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


@register("LeakyReLU")
def leaky_relu(data, gamma=None, act_type="leaky", slope=0.25,
               lower_bound=0.125, upper_bound=0.334):
    if act_type == "leaky":
        return torch.where(data >= 0, data, slope * data)
    if act_type == "prelu":
        g = gamma.reshape((1, -1) + (1,) * (data.ndim - 2)) \
            if data.ndim > 2 else gamma
        return torch.where(data >= 0, data, g * data)
    if act_type == "elu":
        return torch.where(data >= 0, data, slope * torch.expm1(data))
    if act_type == "selu":
        alpha, scale = 1.6732632423543772, 1.0507009873554805
        return scale * torch.where(data >= 0, data,
                                   alpha * torch.expm1(data))
    if act_type == "gelu":
        return F.gelu(data)
    if act_type == "rrelu":
        # eval-mode rrelu: the mean slope
        return torch.where(data >= 0, data,
                           (lower_bound + upper_bound) / 2 * data)
    raise MXNetError(f"LeakyReLU act_type {act_type!r} unsupported")


@register("softmax")
def softmax(data, axis=-1, temperature=None, length=None):
    if length is not None:
        raise MXNetError("softmax: the length input is not ported")
    x = data / temperature if temperature else data
    return torch.softmax(x, dim=int(axis))


@register("log_softmax")
def log_softmax(data, axis=-1, temperature=None):
    x = data / temperature if temperature else data
    return torch.log_softmax(x, dim=int(axis))


@register("Dropout")
def dropout(data, p=0.5, mode="training", axes=(), training=False,
            cudnn_off=False, generator=None):
    """Inverted dropout: in training (or ``mode="always"``) each element
    (each slice along ``axes``) is kept with probability ``1 - p`` and
    scaled by ``1 / (1 - p)``. The mask is drawn from ``generator``, a
    ``torch.Generator`` on the data's device, which the caller owns
    (the gluon layer keeps one): the port has no global stream of
    random draws. The dispatch layers always pass ``training``; its
    default only serves shape inference."""
    if (not attr_bool(training) and mode != "always") or p <= 0:
        return data
    if generator is None:
        raise MXNetError("Dropout in training needs a torch.Generator "
                         "(generator=...) on the data's device")
    axes = tuple(int(a) % data.ndim for a in axes)
    shape = tuple(1 if i in axes else s for i, s in enumerate(data.shape))
    keep = 1.0 - float(p)
    mask = torch.rand(shape, generator=generator, device=data.device) < keep
    return data * (mask.to(data.dtype) / keep)


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


@register("LayerNorm")
def layer_norm_op(data, gamma, beta, axis=-1, eps=1e-5,
                  output_mean_var=False):
    out = layer_norm(data, gamma, beta, int(axis), float(eps))
    if attr_bool(output_mean_var):
        var, mean = torch.var_mean(data, dim=int(axis), correction=0)
        return out, mean, var
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
