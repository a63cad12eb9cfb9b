"""The subset of ``mxnet_tpu/initializer.py`` the gluon defaults use.

A parameter is initialised by the suffix of its name, as the reference
does (``Initializer.__call__``): ``*weight`` draws from the
initializer, ``*bias`` and ``*beta`` are 0, ``*gamma`` is 1. Gluon's
default initializer is ``Uniform(0.07)`` (``gluon/parameter.py``).
"""
from __future__ import annotations

import torch


class Initializer:
    def __call__(self, name, tensor, generator):
        """Fill ``tensor`` in place; draws come from ``generator``."""
        name = name.lower()
        with torch.no_grad():
            if name.endswith("bias") or name.endswith("beta"):
                tensor.zero_()
            elif name.endswith("gamma"):
                tensor.fill_(1.0)
            else:
                self._init_weight(tensor, generator)

    def _init_weight(self, tensor, generator):
        raise NotImplementedError


class Uniform(Initializer):
    def __init__(self, scale=0.07):
        self.scale = float(scale)

    def _init_weight(self, tensor, generator):
        draw = torch.rand(tensor.shape, generator=generator,
                          dtype=torch.float64)
        tensor.copy_((draw * 2.0 - 1.0) * self.scale)
