"""Fused optimizer updates (K2): the port's counterpart of
``fused_sgd_mom`` / ``fused_adam`` and their Pallas bodies
``_sgd_mom_kernel`` / ``_adam_kernel`` in
``mxnet_tpu/ops/pallas_kernels.py``.

- :func:`sgd_mom_plain` / :func:`adam_plain` restate the update ops in
  PyTorch: the oracle each kernel is held against and the CPU path;
- ``csrc/fused_opt.cu`` holds the two hand-written kernels for sm_90a
  (its header states their bound and design), built by :mod:`._build`;
- :func:`fused_sgd_mom` / :func:`fused_adam` send CPU tensors to the
  plain version and CUDA tensors to the kernel, adding one to their
  ``launches`` count per launch. They raise on any input the kernel
  does not take.

The JAX package's update ops are jitted XLA programs, and XLA rewrites
their jnp formulas: constant hyperparameters fold (``lr * rescale``
becomes one f32 factor when nothing clips between them; a product of
Python floats such as ``lr * wd`` rounds to f32 once), a multiply by a
factor of exactly 1 disappears, and the first remaining product of each
sum or difference contracts with it into one fused multiply-add. The
plain versions reproduce that program bitwise (held against it on the
CPU); :func:`fma32` is an f32 fused multiply-add computed in f64 and
rounded once, and the square root too is taken in f64 and rounded once
(PyTorch's vectorised f32 ``sqrt`` on the CPU is not correctly rounded
in one element of about seven). The kernels use the same operations as
explicit round-to-nearest intrinsics, so they equal the plain versions
bitwise.

Both wrappers may write their results into ``out`` tensors that alias
the inputs (the weight over the weight, a state over itself): the
kernel reads each element before it writes it, so the update runs in
place, one read and one write per array. The JAX ops are pure; the
registered ops of ``ops/optimizer_ops.py`` stay pure too and the in-place
form is the ``mx.nd`` call surface's.

The kernels take any size: the JAX dispatch's fall-back for sizes that
do not tile into rows of 128 comes from the TPU's VMEM blocks and has no
counterpart here.
"""
from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from ..base import MXNetError
from ..profiling import optrace as _optrace
from . import _build

# a recorder or capture active (profiling/optrace.py): the wrappers price
# their call as one row
_ot_active = _optrace.ACTIVE

_SGD_MOM_ARGS = ([ctypes.c_void_p] * 5 + [ctypes.c_int64]
                 + [ctypes.c_float] * 5 + [ctypes.c_int, ctypes.c_int,
                                           ctypes.c_void_p])
_ADAM_ARGS = ([ctypes.c_void_p] * 7 + [ctypes.c_int64]
              + [ctypes.c_float] * 8 + [ctypes.c_int, ctypes.c_float,
                                        ctypes.c_int, ctypes.c_void_p])


def reset_launches():
    fused_sgd_mom.launches = 0
    fused_adam.launches = 0


def f32(x):
    """A hyperparameter rounded to f32, as a Python float (exact)."""
    return float(np.float32(x))


def fma32(a, b, c):
    """``a * b + c`` on f32 tensors (``b`` may be an f32-exact Python
    float) rounded to f32 once, like ``fmaf``. The product is exact in
    f64; the sum is rounded to odd in f64 (Knuth's two-sum gives its
    error), so the final rounding to f32 is the only one that counts."""
    s = a.double() * b
    c = c.double()
    t = s + c
    bv = t - s
    err = (s - (t - bv)) + (c - bv)
    bump = (err != 0) & ((t.view(torch.int64) & 1) == 0) & torch.isfinite(t)
    toward = torch.copysign(torch.full_like(t, math.inf), err)
    return torch.where(bump, torch.nextafter(t, toward), t).float()


def sqrt32(t):
    """``sqrt`` of an f32 tensor rounded once: in f64 on the CPU, whose
    vectorised f32 root is not always correctly rounded; ``sqrtf`` on
    the card is."""
    if t.device.type == "cpu" and t.dtype == torch.float32:
        return torch.sqrt(t.double()).float()
    return torch.sqrt(t)


def _sgd_mom_hyper(lr, momentum, wd, rescale_grad, clip_gradient):
    """(mu, lr_wd, lr_g, rescale, clip, mu_is_one) as the XLA program
    holds them: see the module docstring."""
    clip = f32(clip_gradient)
    lr_g = f32(lr) if clip >= 0 else f32(np.float32(lr)
                                         * np.float32(rescale_grad))
    mu = f32(momentum)
    return (mu, f32(lr * wd), lr_g, f32(rescale_grad), clip, mu == 1.0)


def _adam_hyper(lr, beta1, beta2, epsilon, wd, rescale_grad,
                clip_gradient):
    """(lr, b1, 1-b1, b2, 1-b2, eps, wd, rescale, rescale_is_one, clip),
    each rounded to f32 where the XLA program rounds it."""
    rescale = f32(rescale_grad)
    return (f32(lr), f32(beta1), f32(1.0 - beta1), f32(beta2),
            f32(1.0 - beta2), f32(epsilon), f32(wd), rescale,
            rescale == 1.0, f32(clip_gradient))


def sgd_mom_plain(weight, grad, mom, lr=0.01, momentum=0.0, wd=0.0,
                  rescale_grad=1.0, clip_gradient=-1.0):
    """``mom' = mu*mom - lr*wd*w - lr*clip(rescale*g)``, ``w' = w + mom'``
    in the XLA program's operations; returns ``(w', mom')``."""
    mu, lr_wd, lr_g, rescale, clip, mu_is_one = _sgd_mom_hyper(
        lr, momentum, wd, rescale_grad, clip_gradient)
    g = grad
    if clip >= 0:
        g = torch.clamp(grad * rescale, -clip, clip)
    if mu_is_one:
        inner = fma32(-weight, lr_wd, mom)
    else:
        inner = fma32(mom, mu, -(weight * lr_wd))
    new_mom = fma32(-g, lr_g, inner)
    return weight + new_mom, new_mom


def adam_plain(weight, grad, mean, var, lr=0.01, beta1=0.9, beta2=0.999,
               epsilon=1e-8, wd=0.0, rescale_grad=1.0, clip_gradient=-1.0):
    """``g = clip(rescale*grad + wd*w)``, ``m' = b1*m + (1-b1)*g``,
    ``v' = b2*v + (1-b2)*g*g``, ``w' = w - lr*m'/(sqrt(v') + eps)`` in the
    XLA program's operations; returns ``(w', m', v')``."""
    (lr, b1, c1, b2, c2, eps, wd, rescale, rescale_is_one,
     clip) = _adam_hyper(lr, beta1, beta2, epsilon, wd, rescale_grad,
                         clip_gradient)
    if rescale_is_one:
        g = fma32(weight, wd, grad)
    else:
        g = fma32(grad, rescale, weight * wd)
    if clip >= 0:
        g = torch.clamp(g, -clip, clip)
    new_mean = fma32(mean, b1, g * c1)
    new_var = fma32(var, b2, (g * g) * c2)
    # torch.sqrt of an f32 CPU tensor is not always correctly rounded
    # (vectorised); the f64 root rounded once to f32 is
    root = torch.sqrt(new_var.double()).float()
    new_w = weight - (new_mean * lr) / (root + eps)
    return new_w, new_mean, new_var


def _check(name, tensors, dev):
    shape = tensors[0].shape
    for t in tensors:
        if t.device != dev or t.dtype != torch.float32 \
                or t.shape != shape or not t.is_contiguous():
            raise MXNetError(
                f"{name}: every array must be a contiguous float32 tensor "
                f"of shape {tuple(shape)} on {dev}, got {t.dtype} "
                f"{tuple(t.shape)} on {t.device}")


def _plain_into(res, out):
    if out is None:
        return res
    with torch.no_grad():
        for dst, r in zip(out, res):
            dst.copy_(r)
    return tuple(out)


def _kernel(symbol, argtypes):
    fn = getattr(_build.load("fused_opt"), symbol)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def sgd_mom_count(weight, *args, **kwargs):
    """(flops, bytes) of one ``sgd_mom`` call, for the op trace: 7 flops
    an element (the rescale, three products, three sums) and 20 bytes
    (w, g, mom read; w', mom' written: ``csrc/fused_opt.cu``)."""
    return 7 * weight.numel(), 20 * weight.numel()


def adam_count(weight, *args, **kwargs):
    """(flops, bytes) of one ``adam`` call: 15 flops an element and 28
    bytes (w, g, m, v read; w', m', v' written)."""
    return 15 * weight.numel(), 28 * weight.numel()


def fused_sgd_mom(weight, grad, mom, lr=0.01, momentum=0.0, wd=0.0,
                  rescale_grad=1.0, clip_gradient=-1.0, out=None):
    """``sgd_mom_update`` as one pass over weight, grad and momentum;
    returns ``(w', mom')``, written into ``out = (w_dst, mom_dst)`` when
    given (they may be ``weight`` and ``mom`` themselves). CPU (and meta)
    tensors take :func:`sgd_mom_plain`; CUDA tensors launch the
    ``sgd_mom`` kernel of ``csrc/fused_opt.cu``."""
    if _ot_active[0] and _optrace.pricing():
        return _optrace.priced_call(
            "fused_sgd_mom", sgd_mom_count, fused_sgd_mom,
            (weight, grad, mom, lr, momentum, wd, rescale_grad,
             clip_gradient, out))
    name = "fused_sgd_mom"
    dev = weight.device
    if dev.type in ("cpu", "meta"):
        return _plain_into(sgd_mom_plain(
            weight, grad, mom, lr=lr, momentum=momentum, wd=wd,
            rescale_grad=rescale_grad, clip_gradient=clip_gradient), out)
    if dev.type != "cuda":
        raise MXNetError(f"{name}: unsupported device {dev}")
    if out is None:
        out = (torch.empty_like(weight), torch.empty_like(mom))
    _check(name, (weight, grad, mom, *out), dev)
    mu, lr_wd, lr_g, rescale, clip, mu_is_one = _sgd_mom_hyper(
        lr, momentum, wd, rescale_grad, clip_gradient)
    err = _kernel("mxt_sgd_mom", _SGD_MOM_ARGS)(
        weight.data_ptr(), grad.data_ptr(), mom.data_ptr(),
        out[0].data_ptr(), out[1].data_ptr(), weight.numel(), mu, lr_wd,
        lr_g, rescale, clip, int(mu_is_one), dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise MXNetError(f"{name}: CUDA launch failed with error {err}")
    fused_sgd_mom.launches += 1
    return tuple(out)


def fused_adam(weight, grad, mean, var, lr=0.01, beta1=0.9, beta2=0.999,
               epsilon=1e-8, wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
               out=None):
    """``adam_update`` as one pass over weight, grad, mean and var;
    returns ``(w', m', v')``, written into ``out`` when given (it may
    alias the inputs). CPU (and meta) tensors take :func:`adam_plain`;
    CUDA tensors launch the ``adam`` kernel of ``csrc/fused_opt.cu``."""
    if _ot_active[0] and _optrace.pricing():
        return _optrace.priced_call(
            "fused_adam", adam_count, fused_adam,
            (weight, grad, mean, var, lr, beta1, beta2, epsilon, wd,
             rescale_grad, clip_gradient, out))
    name = "fused_adam"
    dev = weight.device
    if dev.type in ("cpu", "meta"):
        return _plain_into(adam_plain(
            weight, grad, mean, var, lr=lr, beta1=beta1, beta2=beta2,
            epsilon=epsilon, wd=wd, rescale_grad=rescale_grad,
            clip_gradient=clip_gradient), out)
    if dev.type != "cuda":
        raise MXNetError(f"{name}: unsupported device {dev}")
    if out is None:
        out = tuple(torch.empty_like(t) for t in (weight, mean, var))
    _check(name, (weight, grad, mean, var, *out), dev)
    (lr, b1, c1, b2, c2, eps, wd, rescale, rescale_is_one,
     clip) = _adam_hyper(lr, beta1, beta2, epsilon, wd, rescale_grad,
                         clip_gradient)
    err = _kernel("mxt_adam", _ADAM_ARGS)(
        weight.data_ptr(), grad.data_ptr(), mean.data_ptr(),
        var.data_ptr(), out[0].data_ptr(), out[1].data_ptr(),
        out[2].data_ptr(), weight.numel(), lr, b1, c1, b2, c2, eps, wd,
        rescale, int(rescale_is_one), clip, dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise MXNetError(f"{name}: CUDA launch failed with error {err}")
    fused_adam.launches += 1
    return tuple(out)


fused_sgd_mom.launches = 0
fused_adam.launches = 0
