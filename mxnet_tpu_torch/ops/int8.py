"""INT8 convolution epilogue: the port's counterpart of
``int8_conv_epilogue`` and ``quantized_conv_epilogue`` in
``mxnet_tpu/ops/pallas_kernels.py`` (the requantize(+relu) tail of the
fused ``_sg_xla_quant_conv`` node).

- :func:`int8_conv_epilogue_plain` restates ``_int8_epilogue_reference``
  in PyTorch: the oracle the kernel is held against and the CPU path;
- ``csrc/int8_epilogue.cu`` is the hand-written kernel for sm_90a (its
  header states its bound and design), built by :mod:`._build`;
- :func:`int8_conv_epilogue` sends CPU tensors to the plain version and
  CUDA tensors to the kernel, adding one to its ``launches`` count per
  launch. It raises on any input the kernel does not take.

The kernel takes any size: the JAX dispatch's fall-back for sizes that
do not tile into rows of 128 comes from the TPU's VMEM blocks and has
no counterpart here. Meta tensors (shape inference) take the plain
version too: they carry no data.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..base import MXNetError
from ..profiling import optrace as _optrace
from . import _build
from .quantized import (INT8_RANGE, INT32_RANGE, as_f32, div_const,
                        fmax, range_absmax, rdiv_const)

# a recorder or capture active (profiling/optrace.py): the wrappers price
# their call as one row
_ot_active = _optrace.ACTIVE

_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
         ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


def reset_launches():
    int8_conv_epilogue.launches = 0


def int8_conv_epilogue_plain(acc, in_scale, out_scale, relu=False):
    """``clip(rint(f32(acc) * in_scale * out_scale), -127, 127)`` as
    int8, then the int8 relu: the two products round one at a time in
    the reference's order, and ``torch.round`` rounds half to even as
    ``jnp.rint`` does."""
    x = acc.to(torch.float32) * _operand(in_scale) * _operand(out_scale)
    q = torch.clamp(torch.round(x), -INT8_RANGE, INT8_RANGE).to(torch.int8)
    if relu:
        q = torch.clamp_min(q, 0)
    return q


def _operand(s):
    """A scale as a torch operand: 0-d tensors as they are, host scalars
    as the Python float of their f32 value (exact)."""
    return s if isinstance(s, torch.Tensor) else float(as_f32(s))


@functools.lru_cache(maxsize=4096)
def _device_scalar(value, device):
    return torch.full((), value, dtype=torch.float32, device=device)


def _scale_on(s, dev, name):
    if isinstance(s, torch.Tensor):
        if s.device != dev or s.dtype != torch.float32 or s.numel() != 1:
            raise MXNetError(f"{name}: scales must be float32 scalars on "
                             f"{dev}, got {s.dtype} {tuple(s.shape)} on "
                             f"{s.device}")
        return s.reshape(()).contiguous()
    return _device_scalar(float(as_f32(s)), dev)


def epilogue_count(acc, in_scale=None, out_scale=None, relu=False):
    """(flops, bytes) of one epilogue call, for the op trace: the two
    f32 products an element; 4 bytes read and 1 written an element
    (``csrc/int8_epilogue.cu``'s header)."""
    return 2 * acc.numel(), 5 * acc.numel()


def int8_conv_epilogue(acc, in_scale, out_scale, relu=False):
    """Elementwise requantize(+relu) of int32 accumulators to int8.

    acc: int32 of any shape. in_scale / out_scale: f32 scalars (host
    values or 0-d tensors; in_scale = one int32 step in real units,
    out_scale = 127 / the output range). CPU (and meta) tensors take
    :func:`int8_conv_epilogue_plain`; CUDA tensors launch the kernel of
    ``csrc/int8_epilogue.cu``, which takes a contiguous accumulator
    (or one contiguous in channels-last order) and writes the output
    in the same memory order."""
    if _ot_active[0] and _optrace.pricing():
        return _optrace.priced_call(
            "int8_conv_epilogue", epilogue_count, int8_conv_epilogue,
            (acc, in_scale, out_scale, relu))
    name = "int8_conv_epilogue"
    dev = acc.device
    if dev.type in ("cpu", "meta"):
        return int8_conv_epilogue_plain(acc, in_scale, out_scale, relu)
    if dev.type != "cuda":
        raise MXNetError(f"{name}: unsupported device {dev}")
    if acc.dtype != torch.int32:
        raise MXNetError(f"{name}: accumulators must be int32, got "
                         f"{acc.dtype}")
    dense = acc.is_contiguous() or (
        acc.ndim == 4 and acc.is_contiguous(memory_format=torch.channels_last))
    if not dense or acc.data_ptr() % 16:
        raise MXNetError(f"{name}: accumulators must be contiguous (or "
                         "channels-last contiguous) and 16-byte aligned")
    s_in = _scale_on(in_scale, dev, name)
    s_out = _scale_on(out_scale, dev, name)
    out = torch.empty_like(acc, dtype=torch.int8)
    fn = getattr(_build.load("int8_epilogue"), "mxt_int8_epilogue")
    if fn.argtypes is None:
        fn.argtypes = _ARGS
        fn.restype = ctypes.c_int
    err = fn(acc.data_ptr(), out.data_ptr(), acc.numel(), s_in.data_ptr(),
             s_out.data_ptr(), int(bool(relu)), dev.index,
             torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise MXNetError(f"{name}: CUDA launch failed with error {err}")
    int8_conv_epilogue.launches += 1
    return out


int8_conv_epilogue.launches = 0


def quantized_conv_epilogue(acc, min_range, max_range, min_calib_range=None,
                            max_calib_range=None, relu=False):
    """The requantize(+int8 relu) tail of ``_sg_xla_quant_conv`` with its
    range bookkeeping, returning ``(int8, min, max)`` exactly like
    ``ops/quantized.requantize`` (+ ``quantized_act``). Scales round to
    f32 where the JAX package rounds them (see ``ops/quantized.py``);
    the elementwise body goes through :func:`int8_conv_epilogue`."""
    in_scale = div_const(range_absmax(min_range, max_range), INT32_RANGE)
    if min_calib_range is not None:
        out_max = np.float32(max(abs(float(min_calib_range)),
                                 abs(float(max_calib_range))))
    else:
        out_max = acc.abs().max().to(torch.float32) * _operand(in_scale)
    out_scale = rdiv_const(INT8_RANGE, fmax(out_max, 1e-30))
    q = int8_conv_epilogue(acc, in_scale, out_scale, relu=relu)
    omin, omax = -out_max, out_max
    if relu:
        omin, omax = fmax(omin, 0.0), fmax(omax, 0.0)
    return q, omin, omax
