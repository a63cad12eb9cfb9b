"""Replica placement over ``torch.device``s (counterpart of
``mxnet_tpu/parallel/mesh.py`` ``replica_devices`` and
``should_warn_degraded``; its meshes, slices and sharding helpers are
not ported).

Serving lanes degrade gracefully when there are fewer devices than
lanes: the lanes wrap around the devices given, so the same
registration serves a host of several cards and a single card, and the
``degraded`` flag says when lanes share one.
"""
from __future__ import annotations

import threading

import torch

from ..base import MXNetError
from ..context import resolve_device


def replica_devices(n, devices=None, exclude=()):
    """Devices for ``n`` replica lanes: ``(devices_list, degraded)``.

    ``devices`` defaults to every visible CUDA device (``cuda:0`` ...),
    and raises on a host without CUDA. Lanes wrap around the devices
    left after ``exclude`` (devices committed elsewhere); when nothing
    is left they wrap onto the full list with ``degraded`` forced True.
    ``degraded`` is True when lanes share a device."""
    if devices is None:
        devices = [resolve_device(torch.device("cuda", i))
                   for i in range(max(torch.cuda.device_count(), 1))]
    devs = [resolve_device(d) for d in devices]
    if not devs:
        raise MXNetError("replica_devices: no devices")
    excluded = {str(d) for d in exclude}
    pool = [d for d in devs if str(d) not in excluded]
    if not pool:
        return [devs[i % len(devs)] for i in range(n)], True
    return [pool[i % len(pool)] for i in range(n)], n > len(pool)


# degraded wraps already warned, keyed (ask, devices): a scale storm
# re-enters the placement on every event, and the same unchanged wrap
# warns once
_DEGRADE_WARNED = set()
_DEGRADE_LOCK = threading.Lock()


def should_warn_degraded(n, devices):
    """True exactly once per (ask, devices) combination."""
    key = (int(n), tuple(str(d) for d in devices))
    with _DEGRADE_LOCK:
        if key in _DEGRADE_WARNED:
            return False
        _DEGRADE_WARNED.add(key)
        return True


def _reset_degrade_warnings():
    """Test hook: forget which (ask, devices) wraps already warned."""
    with _DEGRADE_LOCK:
        _DEGRADE_WARNED.clear()
