"""Placement helpers of the port (counterpart of ``mxnet_tpu/parallel``):
only :mod:`.mesh`'s replica placement so far."""
from __future__ import annotations

from .mesh import replica_devices, should_warn_degraded

__all__ = ["replica_devices", "should_warn_degraded"]
