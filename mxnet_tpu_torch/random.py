"""Seeded generators (counterpart of ``mxnet_tpu/random.py``'s ``seed``).

The JAX package keeps a global key chain; the port passes an explicit
``torch.Generator`` to whatever draws, so two models built in one
process never share a stream. Generators live on the CPU: parameters
are drawn there and then moved, so a seed gives the same weights on
every device.
"""
from __future__ import annotations

import torch


def generator(seed):
    """A CPU ``torch.Generator`` seeded with ``seed``."""
    g = torch.Generator(device="cpu")
    g.manual_seed(int(seed))
    return g
