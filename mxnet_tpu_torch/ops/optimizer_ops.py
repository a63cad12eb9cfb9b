"""Optimizer update ops (the port of ``mxnet_tpu/ops/optimizer_ops.py``):
the reference exposes each optimizer's update rule as a standalone op,
so a training loop can apply updates without an Optimizer object.
This module holds the dense ones; ``_sparse_adagrad_update`` and
``_contrib_group_adagrad_update`` wait for sparse NDArray.

Pure, as in the JAX package: an op returns ``(out_weight,
*updated_states)`` and changes no input. ``mx.nd.sgd_mom_update`` /
``mx.nd.adam_update`` restore the reference's in-place call surface
(``ndarray/__init__.py``). ``sgd_mom_update`` and ``adam_update`` are K2
(``ops/fused_opt.py``): the plain version on a CPU tensor, the
hand-written kernel on a CUDA tensor. The other update ops have no
kernel in the JAX package either (its Pallas dispatch covers only those
two) and stay plain torch.

Names, attrs and defaults are the JAX package's; ``clip_gradient < 0``
disables clipping. Each op computes what the JAX op's jitted XLA program
computes, bitwise (the folds and contractions are described in
``ops/fused_opt.py``); the JAX op's order of operations differs from
the ``optimizer.SGD`` class's (``optimizer/optimizer.py``).
"""
from __future__ import annotations

import numpy as np
import torch

from .fused_opt import (f32, fma32, fused_adam, fused_sgd_mom,
                        sgd_mom_plain, sqrt32)
from .registry import register


def _clip(g, clip):
    return torch.clamp(g, -clip, clip) if clip >= 0 else g


def _rsqrt(t):
    """``1 / sqrt(t)`` rounded once. XLA on the CPU computes it with the
    processor's approximate reciprocal root and a refinement step, off
    in the last place in about 0.1-2% of elements, so the ops that
    divide by a root (the RMSProp pair) agree with the JAX ones to 2 ulp
    of each output's largest value, not bitwise."""
    return torch.rsqrt(t.double()).float() if t.device.type == "cpu" \
        else torch.rsqrt(t)


def _recip(x):
    """The f32 reciprocal of a Python float, as XLA folds a division by
    a constant into a multiply by it."""
    return float(np.float32(1.0) / np.float32(x))


def _decayed(weight, decay, step, lr):
    """``decay * w - lr * step`` as XLA computes it: the decay multiply
    drops out at exactly 1, else contracts with the weight."""
    if decay == 1.0:
        return fma32(-step, lr, weight)
    return fma32(weight, decay, -(step * lr))


@register("sgd_update")
def sgd_update(weight, grad, lr=0.01, wd=0.0, rescale_grad=1.0,
               clip_gradient=-1.0, lazy_update=True):
    """out = (1 - lr*wd)*w - lr*clip(rescale*g)."""
    clip = f32(clip_gradient)
    g, lr_g = grad, f32(f32(lr) * f32(rescale_grad))
    if clip >= 0:
        g, lr_g = torch.clamp(grad * f32(rescale_grad), -clip, clip), f32(lr)
    return _decayed(weight, f32(1.0 - lr * wd), g, lr_g)


@register("sgd_mom_update", num_outputs=2)
def sgd_mom_update(weight, grad, mom, lr=0.01, momentum=0.0, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0, lazy_update=True):
    """mom' = mu*mom - lr*wd*w - lr*clip(rescale*g); out = w + mom'."""
    return fused_sgd_mom(weight, grad, mom, lr=lr, momentum=momentum,
                         wd=wd, rescale_grad=rescale_grad,
                         clip_gradient=clip_gradient)


@register("adam_update", num_outputs=3)
def adam_update(weight, grad, mean, var, lr=0.01, beta1=0.9, beta2=0.999,
                epsilon=1e-8, wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
                lazy_update=True):
    """No in-kernel bias correction: the caller folds it into lr, as the
    reference's Python optimizer does."""
    return fused_adam(weight, grad, mean, var, lr=lr, beta1=beta1,
                      beta2=beta2, epsilon=epsilon, wd=wd,
                      rescale_grad=rescale_grad,
                      clip_gradient=clip_gradient)


@register("mp_sgd_update", num_outputs=2)
def mp_sgd_update(weight, grad, weight32, lr=0.01, wd=0.0, rescale_grad=1.0,
                  clip_gradient=-1.0, lazy_update=True):
    """Multi-precision SGD: ``sgd_update`` on the fp32 master copy; the
    low-precision weight is a cast of it. Returns ``(out, weight32')``."""
    w32 = sgd_update(weight32, grad.float(), lr=lr, wd=wd,
                     rescale_grad=rescale_grad, clip_gradient=clip_gradient)
    return w32.to(weight.dtype), w32


@register("mp_sgd_mom_update", num_outputs=3)
def mp_sgd_mom_update(weight, grad, mom, weight32, lr=0.01, momentum=0.0,
                      wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
                      lazy_update=True):
    """``sgd_mom_update`` on the fp32 master copy (its plain version: the
    JAX op never reaches the fused kernel here either). Returns
    ``(out, mom', weight32')``."""
    w32, new_mom = sgd_mom_plain(weight32, grad.float(), mom, lr=lr,
                                 momentum=momentum, wd=wd,
                                 rescale_grad=rescale_grad,
                                 clip_gradient=clip_gradient)
    return w32.to(weight.dtype), new_mom, w32


@register("signsgd_update")
def signsgd_update(weight, grad, lr=0.01, wd=0.0, rescale_grad=1.0,
                   clip_gradient=-1.0):
    """out = (1 - lr*wd)*w - lr*sign(g); clip has no effect (ref:
    SignSGDKernel)."""
    return _decayed(weight, f32(1.0 - lr * wd), torch.sign(grad), f32(lr))


@register("signum_update", num_outputs=2)
def signum_update(weight, grad, mom, lr=0.01, momentum=0.0, wd=0.0,
                  rescale_grad=1.0, clip_gradient=-1.0, wd_lh=0.0):
    """mom' = mu*mom - (1-mu)*wd*w - (1-mu)*clip(rescale*g);
    out = (1 - lr*wd_lh)*w + lr*sign(mom') (ref: SignumKernel)."""
    clip = f32(clip_gradient)
    c = f32(1.0 - momentum)
    g, c_g = grad, f32(c * f32(rescale_grad))
    if clip >= 0:
        g, c_g = _clip(grad * f32(rescale_grad), clip), c
    inner = fma32(mom, f32(momentum), -(weight * f32((1.0 - momentum) * wd)))
    new_mom = fma32(-g, c_g, inner)
    step = torch.sign(new_mom)
    decay = f32(1.0 - lr * wd_lh)
    if decay == 1.0:
        out = fma32(step, f32(lr), weight)
    else:
        out = fma32(weight, decay, step * f32(lr))
    return out, new_mom


def _rescaled_plus_wd(weight, grad, rescale_grad, wd, clip):
    """clip(rescale*grad + wd*w) as XLA computes it."""
    rescale = f32(rescale_grad)
    if rescale == 1.0:
        g = fma32(weight, f32(wd), grad)
    else:
        g = fma32(grad, rescale, weight * f32(wd))
    return _clip(g, f32(clip))


@register("ftml_update", num_outputs=4)
def ftml_update(weight, grad, d, v, z, lr=0.01, beta1=0.6, beta2=0.999,
                epsilon=1e-8, t=1, wd=0.0, rescale_grad=1.0,
                clip_grad=-1.0):
    """Returns ``(out, d', v', z')`` (ref: FTMLKernel). XLA divides by
    ``1 - beta2**t`` as a multiply by its f32 reciprocal and fuses
    ``d' - beta1*d`` before ``d'`` is rounded."""
    g = _rescaled_plus_wd(weight, grad, rescale_grad, wd, clip_grad)
    b1 = f32(beta1)
    v_new = fma32(v, f32(beta2), (g * g) * f32(1.0 - beta2))
    root = sqrt32(v_new * _recip(1.0 - beta2 ** t)) + f32(epsilon)
    scale = f32((1.0 - beta1 ** t) / lr)
    d_t = root * scale
    sigma = fma32(root, scale, -(d * b1))
    z_new = fma32(-sigma, weight, fma32(z, b1, g * f32(1.0 - beta1)))
    return -z_new / d_t, d_t, v_new, z_new


@register("ftrl_update", num_outputs=3)
def ftrl_update(weight, grad, z, n, lr=0.1, lamda1=0.01, beta=1.0, wd=0.0,
                rescale_grad=1.0, clip_gradient=-1.0):
    """Returns ``(out, z', n')`` (ref: FtrlUpdate). XLA divides by ``lr``
    as a multiply by its f32 reciprocal."""
    clip, rescale = f32(clip_gradient), f32(rescale_grad)
    if clip >= 0:
        g = _clip(grad * rescale, clip)
        acc = z + g
    else:
        g = grad * rescale if rescale != 1.0 else grad
        acc = fma32(grad, rescale, z)
    n_new = fma32(g, g, n)
    root = sqrt32(n_new)
    inv_lr = _recip(lr)
    z_new = fma32(-((root - sqrt32(n)) * weight), inv_lr, acc)
    l1 = f32(lamda1)
    num = fma32(torch.sign(z_new), l1, -z_new)
    den = fma32(root + f32(beta), inv_lr, torch.full_like(root, f32(wd)))
    out = torch.where(torch.abs(z_new) > l1, num / den,
                      torch.zeros_like(num))
    return out, z_new, n_new


@register("rmsprop_update", num_outputs=2)
def rmsprop_update(weight, grad, n, lr=0.01, gamma1=0.95, epsilon=1e-8,
                   wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
                   clip_weights=-1.0):
    """Tieleman & Hinton non-centered RMSProp; returns ``(out, n')``.
    XLA turns ``/ sqrt(x)`` into ``* rsqrt(x)``; see :func:`_rsqrt`."""
    g = _rescaled_plus_wd(weight, grad, rescale_grad, wd, clip_gradient)
    n_new = fma32(n, f32(gamma1), (g * g) * f32(1.0 - gamma1))
    out = fma32(-(g * f32(lr)), _rsqrt(n_new + f32(epsilon)), weight)
    if clip_weights >= 0:
        out = torch.clamp(out, -f32(clip_weights), f32(clip_weights))
    return out, n_new


@register("rmspropalex_update", num_outputs=4)
def rmspropalex_update(weight, grad, n, g, delta, lr=0.01, gamma1=0.95,
                       gamma2=0.9, epsilon=1e-8, wd=0.0, rescale_grad=1.0,
                       clip_gradient=-1.0, clip_weights=-1.0):
    """Graves 2013 centered RMSProp with momentum; returns
    ``(out, n', g', delta')``. ``/ sqrt(x)`` as in :func:`rmsprop_update`."""
    gr = _rescaled_plus_wd(weight, grad, rescale_grad, wd, clip_gradient)
    c, y = f32(1.0 - gamma1), f32(gamma1)
    n_new = fma32(n, y, (gr * gr) * c)
    if f32(rescale_grad) == 1.0 and f32(clip_gradient) < 0:
        # the LLVM contraction picks the other product when the
        # gradient's own multiply-add feeds it directly
        g_new = fma32(gr, c, g * y)
    else:
        g_new = fma32(g, y, gr * c)
    root = _rsqrt(fma32(-g_new, g_new, n_new) + f32(epsilon))
    delta_new = fma32(delta, f32(gamma2), -((gr * f32(lr)) * root))
    out = weight + delta_new
    if clip_weights >= 0:
        out = torch.clamp(out, -f32(clip_weights), f32(clip_weights))
    return out, n_new, g_new, delta_new
