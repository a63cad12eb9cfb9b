"""Device contexts as ``torch.device`` values.

``cpu()`` / ``gpu(i)`` keep the MXNet spelling; :func:`resolve_device`
is the one rule every entry point (``Gateway``, ``GenerativeDecoder``,
``BlockPool``) applies to its ``device`` argument: no argument means
the first CUDA card, and a host without one raises instead of
quietly running on the CPU. The CPU is taken only when asked for.
"""
from __future__ import annotations

import torch

from .base import MXNetError


def cpu(device_id=0):
    # torch has one CPU device; the id is accepted for MXNet parity
    return torch.device("cpu")


def gpu(device_id=0):
    return torch.device("cuda", int(device_id))


def resolve_device(device=None):
    """``None`` -> ``cuda:0``; a string or ``torch.device`` as given.
    A CUDA device on a host without CUDA raises :class:`MXNetError`."""
    dev = gpu(0) if device is None else torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise MXNetError(
                f"device {dev} requested but CUDA is not available; pass "
                "device='cpu' to run on the CPU")
        if dev.index is None:
            dev = gpu(torch.cuda.current_device())
        if dev.index >= torch.cuda.device_count():
            raise MXNetError(
                f"device {dev} requested but only "
                f"{torch.cuda.device_count()} CUDA device(s) exist")
    elif dev.type != "cpu":
        raise MXNetError(f"unsupported device {dev} (cpu or cuda)")
    return dev
