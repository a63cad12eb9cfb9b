"""INT8 quantization ops: the port of ``mxnet_tpu/ops/quantized.py``.

int8 products accumulate exactly in int32 (``torch._int_mm`` over an
unfolded input; the JAX package asks XLA for
``preferred_element_type=int32``). Scale bookkeeping follows
requantize-inl.h as the JAX ops spell it.

Range scalars and f32 rounding. The ops are held bitwise to the JAX
package, whose graphs XLA compiles. So every scale rounds to f32 where
XLA rounds it, and XLA's compiler folds scalars:

- an expression of constants is evaluated once, in f32 with true
  division;
- ``x / c`` with ``x`` known only at run time becomes ``x * f32(1/c)``;
- a product ``(k * x) / c`` with a constant ``k`` folds the constants
  first: ``x * f32(k * f32(1/c))``;
- ``a * b + c * d`` contracts to ``fma(a, b, c * d)``.

Ranges known before the run (calibrated attrs, and whatever follows from
them) therefore travel between ops as host ``numpy.float32`` scalars,
the port's constants; ranges computed on the device (weight ranges, and
everything when an op is called on its own) are 0-d tensors. The
helpers below apply the rules above to either kind, and no torch
division by a Python number is ever taken (CUDA turns it into a
reciprocal multiply, the CPU does not).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..base import MXNetError
from .nn import pooling
from .registry import register

INT8_RANGE = 127.0
INT32_RANGE = float(2 ** 31 - 1)

_F32 = np.float32


def is_static(v):
    return not isinstance(v, torch.Tensor)


def as_f32(v):
    return _F32(v)


def _like(v, ref):
    """``v`` as a 0-d f32 tensor on ``ref``'s device."""
    if isinstance(v, torch.Tensor):
        return v
    return torch.full((), float(_F32(v)), dtype=torch.float32,
                      device=ref.device)


def range_absmax(mn, mx):
    """max(|mn|, |mx|) of a (min, max) range pair."""
    if is_static(mn) and is_static(mx):
        return np.maximum(np.abs(_F32(mn)), np.abs(_F32(mx)))
    mn, mx = _like(mn, mx), _like(mx, mn)
    return torch.maximum(mn.abs(), mx.abs())


def fmax(x, c):
    """max(x, c) for a Python constant c."""
    if is_static(x):
        return np.maximum(_F32(x), _F32(c))
    return torch.clamp_min(x, float(_F32(c)))


def _recip(c):
    return float(_F32(1) / _F32(c))


def div_const(x, c):
    """x / c for a Python constant c."""
    if is_static(x):
        return _F32(x) / _F32(c)
    return x * _recip(c)


def rdiv_const(c, y):
    """c / y for a Python constant c (true division)."""
    if is_static(y):
        return _F32(c) / _F32(y)
    return torch.div(torch.full_like(y, float(_F32(c))), y)


def div(x, y):
    """x / y of two range scalars."""
    if is_static(y):
        return div_const(x, y)
    return torch.div(_like(x, y), y)


def mul_const(x, c):
    if is_static(x):
        return _F32(x) * _F32(c)
    return x * float(_F32(c))


def prod_div(a, b, c):
    """a * b / c for a Python constant c, constants folded first."""
    if is_static(a) and is_static(b):
        return (_F32(a) * _F32(b)) / _F32(c)
    if is_static(a):
        a, b = b, a
    if is_static(b):
        return a * float(_F32(b) * _F32(_recip(c)))
    return (a * b) * _recip(c)


def _product_ranges(min_data, max_data, min_weight, max_weight):
    """(real value of one int8*int8 step, int32 output range)."""
    step = prod_div(range_absmax(min_data, max_data),
                    range_absmax(min_weight, max_weight),
                    INT8_RANGE * INT8_RANGE)
    return step, mul_const(step, INT32_RANGE)


def _int32_bias(bias, step, min_bias, max_bias):
    """The int8 bias re-expressed in int32 accumulator steps."""
    bias_scale = div(step, fmax(div_const(range_absmax(min_bias, max_bias),
                                          INT8_RANGE), 1e-30))
    b = bias.to(torch.float32)
    d = fmax(bias_scale, 1e-30)
    b = b * _recip(d) if is_static(d) else b / d
    return torch.round(b).to(torch.int32)


def int8_matmul(a, w):
    """Exact int32 product ``a @ w.T`` of int8 matrices a (M, K) and
    w (N, K). On the card ``torch._int_mm`` takes M > 16, K and N
    multiples of 8, and (cuBLASLt's int8 kernels) both operands with K
    contiguous: zero rows and columns pad them and are cut off after."""
    m, k = a.shape
    n = w.shape[0]
    pk, pn, pm = -k % 8, -n % 8, max(0, 17 - m)
    if pk or pm:
        a = F.pad(a, (0, pk, 0, pm))
    if pk or pn:
        w = F.pad(w, (0, pk, 0, pn))
    out = torch._int_mm(a.contiguous(), w.contiguous().t())
    if pm or pn:
        out = out[:m, :n].contiguous()
    return out


def _conv_cols(data, kernel, stride, dilate, pad):
    """(B*OH*OW, C*KH*KW) int8 patches of NCHW int8 data, and (OH, OW).
    A 1x1 unpadded kernel needs only a strided view; otherwise the
    patches unfold in fp16, which holds every int8 value exactly
    (F.unfold takes no int8)."""
    b, c, h, w = data.shape
    oh = (h + 2 * pad[0] - dilate[0] * (kernel[0] - 1) - 1) // stride[0] + 1
    ow = (w + 2 * pad[1] - dilate[1] * (kernel[1] - 1) - 1) // stride[1] + 1
    if kernel == (1, 1) and pad == (0, 0):
        x = data[:, :, ::stride[0], ::stride[1]]
        return x.permute(0, 2, 3, 1).reshape(b * oh * ow, c), (oh, ow)
    cols = F.unfold(data.to(torch.float16), kernel, dilation=dilate,
                    padding=pad, stride=stride)
    cols = cols.transpose(1, 2).reshape(b * oh * ow, -1)
    return cols.to(torch.int8), (oh, ow)


def int8_conv2d(data, weight, stride, dilate, pad, groups):
    """Exact int32 2-d convolution of NCHW int8 data with OIHW int8
    weights. The result is NCHW in shape and channels-last in memory
    (the product's natural order)."""
    b = data.shape[0]
    o = weight.shape[0]
    kernel = tuple(weight.shape[2:])
    cg, og = data.shape[1] // groups, o // groups
    outs = []
    for g in range(groups):
        cols, (oh, ow) = _conv_cols(data[:, g * cg:(g + 1) * cg], kernel,
                                    stride, dilate, pad)
        wg = weight[g * og:(g + 1) * og].reshape(og, -1)
        outs.append(int8_matmul(cols, wg))
    acc = outs[0] if groups == 1 else torch.cat(outs, dim=1)
    return acc.view(b, oh, ow, o).permute(0, 3, 1, 2)


def _unpack(args, no_bias):
    if no_bias:
        data, weight, min_data, max_data, min_weight, max_weight = args
        return (data, weight, None, min_data, max_data, min_weight,
                max_weight, None, None)
    return args


@register("_contrib_quantize_v2", num_outputs=3)
def quantize_v2(data, out_type="int8", min_calib_range=None,
                max_calib_range=None):
    if min_calib_range is not None:
        amax = range_absmax(min_calib_range, max_calib_range)
        scale = rdiv_const(INT8_RANGE, amax) if amax > 0 else _F32(1)
        x = data * float(scale)
    else:
        amax = range_absmax(data.min().to(torch.float32),
                            data.max().to(torch.float32))
        scale = torch.where(amax > 0, rdiv_const(INT8_RANGE, amax),
                            torch.ones_like(amax))
        x = data * scale
    q = torch.clamp(torch.round(x), -INT8_RANGE, INT8_RANGE)
    return q.to(torch.int8), -amax, amax


@register("_contrib_dequantize")
def dequantize(data, min_range, max_range, out_type="float32"):
    step = div_const(range_absmax(min_range, max_range), INT8_RANGE)
    step = float(step) if is_static(step) else step
    return data.to(torch.float32) * step


@register("_contrib_requantize", num_outputs=3)
def requantize(data, min_range, max_range, min_calib_range=None,
               max_calib_range=None):
    """int32 accumulators -> int8 (ref: requantize-inl.h)."""
    in_scale = div_const(range_absmax(min_range, max_range), INT32_RANGE)
    s_in = float(in_scale) if is_static(in_scale) else in_scale
    if min_calib_range is not None:
        out_max = range_absmax(min_calib_range, max_calib_range)
    else:
        out_max = data.abs().max().to(torch.float32) * s_in
    out_scale = rdiv_const(INT8_RANGE, fmax(out_max, 1e-30))
    s_out = float(out_scale) if is_static(out_scale) else out_scale
    q = torch.clamp(torch.round(data.to(torch.float32) * s_in * s_out),
                    -INT8_RANGE, INT8_RANGE)
    return q.to(torch.int8), -out_max, out_max


@register("_contrib_quantized_fully_connected", num_outputs=3)
def quantized_fully_connected(*args, num_hidden=0, no_bias=False,
                              flatten=True):
    """Inputs: (data, weight[, bias], min/max pairs per input)."""
    (data, weight, bias, min_data, max_data, min_weight, max_weight,
     min_bias, max_bias) = _unpack(args, no_bias)
    if not flatten and data.ndim != 2:
        raise MXNetError("quantized FullyConnected: flatten=False takes "
                         "2-d data only")
    x = data.reshape(data.shape[0], -1)
    acc = int8_matmul(x.to(torch.int8), weight.to(torch.int8))
    step, out_range = _product_ranges(min_data, max_data, min_weight,
                                      max_weight)
    if not no_bias and bias is not None:
        acc = acc + _int32_bias(bias, step, min_bias, max_bias)
    return acc, -out_range, out_range


@register("_contrib_quantized_conv", num_outputs=3)
def quantized_conv(*args, kernel=(), stride=(), dilate=(), pad=(),
                   num_filter=0, num_group=1, no_bias=False, layout="NCHW",
                   workspace=1024, cudnn_tune=None, cudnn_off=False):
    """Inputs follow the reference arity: (data, weight[, bias],
    min/max pairs per input). 2-d NCHW only."""
    (data, weight, bias, min_data, max_data, min_weight, max_weight,
     min_bias, max_bias) = _unpack(args, no_bias)
    if len(kernel) != 2 or (layout or "NCHW") != "NCHW":
        raise MXNetError("quantized Convolution: only 2-d NCHW is ported")
    stride = tuple(stride) or (1, 1)
    dilate = tuple(dilate) or (1, 1)
    pad = tuple(pad) or (0, 0)
    acc = int8_conv2d(data.to(torch.int8), weight.to(torch.int8), stride,
                      dilate, pad, int(num_group))
    step, out_range = _product_ranges(min_data, max_data, min_weight,
                                      max_weight)
    if not no_bias and bias is not None:
        acc = acc + _int32_bias(bias, step, min_bias,
                                max_bias).reshape(1, -1, 1, 1)
    return acc, -out_range, out_range


@register("_contrib_quantized_pooling", num_outputs=3)
def quantized_pooling(data, min_data, max_data, kernel=(), pool_type="max",
                      stride=(), pad=(), global_pool=False,
                      pooling_convention="valid", cudnn_off=False,
                      p_value=2, count_include_pad=True):
    out = pooling(data.to(torch.float32), kernel=kernel, pool_type=pool_type,
                  stride=stride, pad=pad, global_pool=global_pool,
                  pooling_convention=pooling_convention,
                  count_include_pad=count_include_pad)
    if not data.dtype.is_floating_point:
        # round and clip, not truncate: the reference's rounded int8 mean
        info = torch.iinfo(data.dtype)
        out = torch.clamp(torch.round(out), info.min, info.max)
    return out.to(data.dtype), min_data, max_data


@register("_contrib_quantized_flatten", num_outputs=3)
def quantized_flatten(data, min_data, max_data):
    return data.reshape(data.shape[0], -1), min_data, max_data


@register("_contrib_quantized_act", num_outputs=3)
def quantized_act(data, min_data, max_data, act_type="relu"):
    """int8 relu passthrough: with zero point 0, relu(dequant(q)) ==
    dequant(max(q, 0)) exactly. Like the JAX op it applies relu
    whatever ``act_type`` says (the quantization pass emits it for relu
    only)."""
    return torch.clamp_min(data, 0), fmax(min_data, 0.0), fmax(max_data, 0.0)


def _scaled(x, s):
    """x * s in f64, exact for int8 x and an f32 scale."""
    s = float(s) if is_static(s) else s.to(torch.float64)
    return x.to(torch.float64) * s


@register("_contrib_quantized_elemwise_add", num_outputs=3)
def quantized_elemwise_add(lhs, rhs, lhs_min, lhs_max, rhs_min, rhs_max,
                           min_calib_range=None, max_calib_range=None):
    """int8 residual add: rescale both operands and requantize to the
    output range. ``lhs * ls + rhs * rs`` is the single-rounding
    ``fma(lhs, ls, f32(rhs * rs))`` XLA contracts it to, computed in
    f64: lhs * ls is exact there, and the sum rounds once more only
    when the two scales differ by more than 2^20."""
    ls = div_const(range_absmax(lhs_min, lhs_max), INT8_RANGE)
    rs = div_const(range_absmax(rhs_min, rhs_max), INT8_RANGE)
    r = rhs.to(torch.float32) * (float(rs) if is_static(rs) else rs)
    f = (_scaled(lhs, ls) + r.to(torch.float64)).to(torch.float32)
    if min_calib_range is not None:
        omax = range_absmax(min_calib_range, max_calib_range)
    else:
        omax = f.abs().max()
    scale = rdiv_const(INT8_RANGE, fmax(omax, 1e-30))
    x = f * (float(scale) if is_static(scale) else scale)
    q = torch.clamp(torch.round(x), -INT8_RANGE, INT8_RANGE)
    return q.to(torch.int8), -omax, omax
