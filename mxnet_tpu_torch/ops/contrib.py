"""The contrib ops the port reaches (the counterpart of
``mxnet_tpu/ops/contrib.py``): ``_contrib_flash_attention``."""
from __future__ import annotations

from .attention import flash_attention as _flash_attention
from .registry import register


@register("_contrib_flash_attention", aliases=("flash_attention",))
def contrib_flash_attention(q, k, v, causal=False, scale=None):
    """Blockwise attention softmax(scale * Q K^T [causal]) V over
    (B, H, T, D) or (BH, T, D), differentiable under ``autograd.record``
    (:func:`~mxnet_tpu_torch.ops.attention.flash_attention`). On a CUDA
    device it always launches the hand-written kernels: below
    ``FLASH_MIN_SEQ`` tokens the JAX package dispatches to its dense
    path instead, which computes the same function."""
    return _flash_attention(q, k, v, causal=bool(causal), scale=scale)
