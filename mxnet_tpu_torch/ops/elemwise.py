"""The elementwise families of ``mxnet_tpu/ops/elemwise.py`` the port
has reached: the residual add of the vision models, the arithmetic,
powers, remainders and comparisons behind NDArray's operators, and the
unary math, clipping and gradient stop that gluon's losses and the
optimizers call (MXNet op names preserved).

Where the JAX op is ``jnp.maximum`` / ``jnp.minimum`` (``relu``,
``clip``, the ``maximum`` family) the port takes ``torch.maximum`` /
``torch.minimum`` too: both split the gradient evenly on a tie, where
``torch.relu`` and ``torch.clamp`` would give it all to one side.
Comparisons return the left operand's dtype, as the reference's do."""
from __future__ import annotations

import torch

from .registry import register, register_op


def _const(x, value):
    """``value`` as a 0-d tensor of ``x``'s dtype on its device."""
    return torch.tensor(value, dtype=x.dtype, device=x.device)


def _div_scalar(x, s):
    """``x / s`` as the JAX package's jitted op computes it: XLA rewrites
    a division by a constant into a product with the constant's
    reciprocal, rounded to ``x``'s type (CUDA's division by a host
    scalar does the same)."""
    if not x.is_floating_point():
        return x / s
    return x * torch.reciprocal(torch.tensor(s, dtype=x.dtype))


_CMP = {"equal": torch.eq, "not_equal": torch.ne, "greater": torch.gt,
        "greater_equal": torch.ge, "lesser": torch.lt,
        "lesser_equal": torch.le}

_BINARY = {"add": torch.add, "sub": torch.sub, "mul": torch.mul,
           "div": torch.div, "mod": torch.remainder, "power": torch.pow,
           "maximum": torch.maximum, "minimum": torch.minimum}
_BINARY.update({n: (lambda f: lambda a, b: f(a, b).to(a.dtype))(f)
                for n, f in _CMP.items()})

for _name, _fn in _BINARY.items():
    register_op("broadcast_" + _name,
                (lambda f: lambda lhs, rhs: f(lhs, rhs))(_fn))
    if _name in ("add", "sub", "mul", "div"):
        register_op("elemwise_" + _name,
                    (lambda f: lambda lhs, rhs: f(lhs, rhs))(_fn),
                    aliases=("_" + _name,))
for _name in ("maximum", "minimum", "power", "equal"):
    register_op("_" + _name,
                (lambda f: lambda lhs, rhs: f(lhs, rhs))(_BINARY[_name]))

_SCALAR = {
    "_plus_scalar": lambda x, s: x + s,
    "_minus_scalar": lambda x, s: x - s,
    "_rminus_scalar": lambda x, s: s - x,
    "_mul_scalar": lambda x, s: x * s,
    "_div_scalar": lambda x, s: _div_scalar(x, s),
    "_rdiv_scalar": lambda x, s: torch.div(torch.full_like(x, s), x),
    "_mod_scalar": lambda x, s: torch.remainder(x, s),
    "_rmod_scalar": lambda x, s: torch.remainder(torch.full_like(x, s), x),
    "_power_scalar": lambda x, s: torch.pow(x, s),
    "_rpower_scalar": lambda x, s: torch.pow(s, x),
    "_maximum_scalar": lambda x, s: torch.maximum(x, _const(x, s)),
    "_minimum_scalar": lambda x, s: torch.minimum(x, _const(x, s)),
}
_SCALAR.update({f"_{n}_scalar": (lambda f: lambda x, s: f(x, s).to(x.dtype))(f)
                for n, f in _CMP.items()})

for _name, _fn in _SCALAR.items():
    register_op(_name, (lambda f: lambda data, scalar=1.0: f(data, scalar))(
        _fn))

_UNARY = {"negative": torch.neg, "abs": torch.abs, "sigmoid": torch.sigmoid,
          "sign": torch.sign, "square": torch.square, "sqrt": torch.sqrt,
          "rsqrt": torch.rsqrt, "exp": torch.exp, "log": torch.log,
          "log1p": torch.log1p, "expm1": torch.expm1, "tanh": torch.tanh,
          "reciprocal": torch.reciprocal,
          "relu": lambda x: torch.maximum(x, _const(x, 0)),
          "zeros_like": torch.zeros_like, "ones_like": torch.ones_like}

for _name, _fn in _UNARY.items():
    register_op(_name, (lambda f: lambda data: f(data))(_fn))


@register("clip")
def clip(data, a_min=0.0, a_max=1.0):
    return torch.minimum(torch.maximum(data, _const(data, a_min)),
                         _const(data, a_max))


@register("BlockGrad", aliases=("stop_gradient",))
def block_grad(data):
    return data.detach()
