"""The elementwise families of ``mxnet_tpu/ops/elemwise.py`` the port
has reached: the residual add of the vision models, the arithmetic
behind NDArray's operators and the sigmoid of gluon's Swish (MXNet op
names preserved)."""
from __future__ import annotations

import torch

from .registry import register_op

_BINARY = {"add": torch.add, "sub": torch.sub, "mul": torch.mul,
           "div": torch.div}

for _name, _fn in _BINARY.items():
    register_op("broadcast_" + _name,
                (lambda f: lambda lhs, rhs: f(lhs, rhs))(_fn))
    register_op("elemwise_" + _name,
                (lambda f: lambda lhs, rhs: f(lhs, rhs))(_fn),
                aliases=("_" + _name,))

_SCALAR = {
    "_plus_scalar": lambda x, s: x + s,
    "_minus_scalar": lambda x, s: x - s,
    "_rminus_scalar": lambda x, s: s - x,
    "_mul_scalar": lambda x, s: x * s,
    "_div_scalar": lambda x, s: x / s,
    "_rdiv_scalar": lambda x, s: torch.div(torch.full_like(x, s), x),
}

for _name, _fn in _SCALAR.items():
    register_op(_name, (lambda f: lambda data, scalar=1.0: f(data, scalar))(
        _fn))

_UNARY = {"negative": torch.neg, "abs": torch.abs, "sigmoid": torch.sigmoid}

for _name, _fn in _UNARY.items():
    register_op(_name, (lambda f: lambda data: f(data))(_fn))
