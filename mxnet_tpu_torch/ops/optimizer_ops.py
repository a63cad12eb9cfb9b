"""Optimizer update ops (the port of ``mxnet_tpu/ops/optimizer_ops.py``):
the reference exposes each optimizer's update rule as a standalone op,
so a training loop can apply updates without an Optimizer object.

Pure, as in the JAX package: an op returns ``(out_weight,
*updated_states)`` and changes no input. ``mx.nd.sgd_mom_update`` /
``mx.nd.adam_update`` restore the reference's in-place call surface
(``ndarray/__init__.py``). ``sgd_mom_update`` and ``adam_update`` are K2
(``ops/fused_opt.py``): the plain version on a CPU tensor, the
hand-written kernel on a CUDA tensor. ``sgd_update`` has no kernel in
the JAX package either and stays plain torch.

Names, attrs and defaults are the JAX package's; ``clip_gradient < 0``
disables clipping. Each op computes what the JAX op's jitted XLA program
computes, bitwise (the folds and contractions are described in
``ops/fused_opt.py``); the JAX op's order of operations differs from
the ``optimizer.SGD`` class's, and the class is not ported here.
"""
from __future__ import annotations

import torch

from .fused_opt import f32, fma32, fused_adam, fused_sgd_mom
from .registry import register


@register("sgd_update")
def sgd_update(weight, grad, lr=0.01, wd=0.0, rescale_grad=1.0,
               clip_gradient=-1.0, lazy_update=True):
    """out = (1 - lr*wd)*w - lr*clip(rescale*g)."""
    clip = f32(clip_gradient)
    g, lr_g = grad, f32(f32(lr) * f32(rescale_grad))
    if clip >= 0:
        g, lr_g = torch.clamp(grad * f32(rescale_grad), -clip, clip), f32(lr)
    decay = f32(1.0 - lr * wd)
    if decay == 1.0:
        return fma32(-g, lr_g, weight)
    return fma32(weight, decay, -(g * lr_g))


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
