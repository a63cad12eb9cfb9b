"""mxnet_tpu_torch: the PyTorch + CUDA port of ``mxnet_tpu`` for NVIDIA
Hopper (H100), grown slice by slice beside the JAX package, which stays
the reference.

This package imports torch and numpy, never ``jax`` or ``mxnet_tpu``.
Its entry points run on ``cuda:0`` unless the caller passes
``device="cpu"``; on a host without CUDA they raise instead. Ported so
far: generative serving (``serving.Gateway.generate``) with the
hand-written flash (prefill) and paged (decode) attention kernels in
``csrc/``.
"""
from __future__ import annotations

from .base import MXNetError, get_env
from .context import cpu, gpu, resolve_device

__all__ = ["MXNetError", "cpu", "get_env", "gpu", "resolve_device"]
