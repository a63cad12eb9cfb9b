"""Weight initializers (the port of ``mxnet_tpu/initializer.py``).

An initializer fills a parameter by the suffix of its name, as the
reference does (``Initializer.__call__``): ``*weight`` draws from the
initializer, ``*bias`` and ``*beta`` are 0, ``*gamma`` is 1, running
and moving means 0 and variances 1. Where the JAX package draws from
numpy's global stream, the port draws from the ``torch.Generator`` the
caller passes, so two models built in one process never share a stream;
draws are made in float64 on the CPU and cast, so a seed gives the same
weights on every device. Gluon's default initializer is ``Uniform(0.07)``.

``create`` takes an initializer, a callable, a registered name
("zeros", "ones", "uniform", "normal", "xavier", "msraprelu", ...) or
the reference's ``dumps()`` JSON form.
"""
from __future__ import annotations

import json
import math
import re

import numpy as np
import torch

from .base import MXNetError

_REGISTRY = {}


def register(cls, name=None):
    _REGISTRY[(name or cls.__name__).lower()] = cls
    return cls


class Initializer:
    """Base: ``init(name, tensor, generator)`` fills ``tensor`` in place
    by the suffix of ``name``."""

    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def __call__(self, name, tensor, generator=None):
        name = str(name).lower()
        with torch.no_grad():
            if name.endswith("weight"):
                self._init_weight(tensor, generator)
            elif name.endswith("bias") or name.endswith("beta"):
                tensor.zero_()
            elif name.endswith("gamma"):
                tensor.fill_(1.0)
            elif name.endswith(("running_mean", "moving_mean",
                                "moving_inv_var", "moving_avg")):
                tensor.zero_()
            elif name.endswith(("running_var", "moving_var")):
                tensor.fill_(1.0)
            else:
                self._init_default(tensor, generator)

    def _init_weight(self, tensor, generator):
        raise NotImplementedError

    def _init_default(self, tensor, generator):
        self._init_weight(tensor, generator)

    def __repr__(self):
        return f"{self.__class__.__name__}({self._kwargs})"

    def dumps(self):
        return json.dumps([self.__class__.__name__.lower(), self._kwargs])


def _fill(tensor, value):
    tensor.copy_(value.to(tensor.dtype) if isinstance(value, torch.Tensor)
                 else torch.as_tensor(value, dtype=tensor.dtype))


def _uniform(shape, scale, generator):
    draw = torch.rand(shape, generator=generator, dtype=torch.float64)
    return (draw * 2.0 - 1.0) * scale


def _normal(shape, sigma, generator):
    return torch.randn(shape, generator=generator,
                       dtype=torch.float64) * sigma


class Zero(Initializer):
    def _init_weight(self, tensor, generator):
        tensor.zero_()


class One(Initializer):
    def _init_weight(self, tensor, generator):
        tensor.fill_(1.0)


class Constant(Initializer):
    def __init__(self, value=0.0):
        super().__init__(value=value)
        self.value = value

    def _init_weight(self, tensor, generator):
        _fill(tensor, np.broadcast_to(np.asarray(self.value, np.float64),
                                      tuple(tensor.shape)).copy())


class Uniform(Initializer):
    """U(-scale, scale)."""

    def __init__(self, scale=0.07):
        super().__init__(scale=scale)
        self.scale = float(scale)

    def _init_weight(self, tensor, generator):
        _fill(tensor, _uniform(tensor.shape, self.scale, generator))


class Normal(Initializer):
    """N(0, sigma^2)."""

    def __init__(self, sigma=0.01):
        super().__init__(sigma=sigma)
        self.sigma = float(sigma)

    def _init_weight(self, tensor, generator):
        _fill(tensor, _normal(tensor.shape, self.sigma, generator))


class Xavier(Initializer):
    """Uniform or Gaussian with variance ``magnitude / factor``, factor
    the fan in, the fan out or their mean (spatial dims count in both)."""

    def __init__(self, rnd_type="uniform", factor_type="avg", magnitude=3):
        super().__init__(rnd_type=rnd_type, factor_type=factor_type,
                         magnitude=magnitude)
        if rnd_type not in ("uniform", "gaussian"):
            raise ValueError(f"rnd_type must be 'uniform' or 'gaussian', "
                             f"got {rnd_type!r}")
        if factor_type not in ("avg", "in", "out"):
            raise ValueError(f"factor_type must be 'avg', 'in' or 'out', "
                             f"got {factor_type!r}")
        self.rnd_type = rnd_type
        self.factor_type = factor_type
        self.magnitude = float(magnitude)

    def _init_weight(self, tensor, generator):
        shape = tuple(tensor.shape)
        if len(shape) < 2:
            raise ValueError(f"Xavier cannot initialize shape {shape}: "
                             "needs at least 2 dims")
        hw = float(np.prod(shape[2:])) if len(shape) > 2 else 1.0
        fan_in, fan_out = shape[1] * hw, shape[0] * hw
        factor = {"avg": (fan_in + fan_out) / 2.0, "in": fan_in,
                  "out": fan_out}[self.factor_type]
        scale = math.sqrt(self.magnitude / factor)
        if self.rnd_type == "uniform":
            _fill(tensor, _uniform(shape, scale, generator))
        else:
            _fill(tensor, _normal(shape, scale, generator))


class MSRAPrelu(Xavier):
    """He initialization for PReLU slopes (Gaussian Xavier with
    magnitude 2 / (1 + slope^2))."""

    def __init__(self, factor_type="avg", slope=0.25):
        super().__init__("gaussian", factor_type, 2.0 / (1 + slope ** 2))
        self._kwargs = {"factor_type": factor_type, "slope": slope}


class Mixed:
    """The first initializer whose pattern matches the name."""

    def __init__(self, patterns, initializers):
        self.map = [(re.compile(p), create(i))
                    for p, i in zip(patterns, initializers)]

    def __call__(self, name, tensor, generator=None):
        for pat, init in self.map:
            if pat.match(str(name)):
                init(name, tensor, generator)
                return
        raise ValueError(f"parameter {name} did not match any pattern")


class Load:
    """Values from a dict of arrays (numpy, NDArray or tensors) by
    name, else ``default_init``."""

    def __init__(self, param, default_init=None, verbose=False):
        self.param = param
        self.default_init = default_init

    def __call__(self, name, tensor, generator=None):
        if name in self.param:
            src = self.param[name]
            src = src.asnumpy() if hasattr(src, "asnumpy") else src
            src = torch.as_tensor(np.asarray(src))
            if tuple(src.shape) != tuple(tensor.shape):
                raise MXNetError(f"Load: {name} has shape "
                                 f"{tuple(src.shape)}, parameter "
                                 f"{tuple(tensor.shape)}")
            with torch.no_grad():
                tensor.copy_(src.to(tensor.dtype))
        elif self.default_init is not None:
            create(self.default_init)(name, tensor, generator)
        else:
            raise ValueError(f"cannot init {name}: not found and no "
                             "default")


for _cls in (Zero, One, Constant, Uniform, Normal, Xavier, MSRAPrelu,
             Mixed, Load):
    register(_cls)
register(Zero, "zeros")
register(One, "ones")


def create(name, **kwargs):
    """An initializer from an instance, a callable, a registered name or
    the reference's ``dumps()`` JSON (``'["xavier", {...}]'``)."""
    if isinstance(name, Initializer) or callable(name):
        return name
    if isinstance(name, str) and name.startswith("["):
        parsed = json.loads(name)
        return create(parsed[0], **(parsed[1] if len(parsed) > 1 else {}))
    key = str(name).lower()
    if key not in _REGISTRY:
        raise MXNetError(f"unknown initializer {name!r} (registered: "
                         f"{sorted(_REGISTRY)})")
    return _REGISTRY[key](**kwargs)
