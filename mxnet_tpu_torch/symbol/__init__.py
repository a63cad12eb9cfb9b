"""mx.sym: the symbolic graph API over the op registry (the port of
``mxnet_tpu/symbol``). ``mx.sym.<Op>`` is generated from the registry on
first use; a parameter input left out is created as a variable named
``{node name}_{input}`` (conv0_weight, bn0_moving_mean...), as the
reference's symbol composition does, so simple_bind can allocate it."""
from __future__ import annotations

from ..base import attr_bool
from ..ops import registry as _reg
from .symbol import (Group, Symbol, Variable, _apply, _gen_name,
                     is_aux_name, load, load_json, var)

__all__ = ["Group", "Symbol", "Variable", "is_aux_name", "load",
           "load_json", "var"]


def _make_sym_func(op):
    def sym_func(*args, name=None, **kwargs):
        inputs, scalars = [], []
        for a in args:
            if isinstance(a, Symbol):
                if scalars:
                    raise TypeError(f"{op.name}: Symbol input after a "
                                    "scalar positional parameter")
                inputs.append(a)
            elif a is not None:
                scalars.append(a)
        if scalars:
            _reg.bind_positional_attrs(op, scalars, kwargs)
        name = name or _gen_name(op.name.lower().lstrip("_"))
        for pname in op.arg_names[len(inputs):]:
            v = kwargs.pop(pname, None)
            if v is not None:
                inputs.append(v)
            elif pname == "bias":
                if not attr_bool(kwargs.get("no_bias",
                                            op.attr_defaults.get("no_bias"))):
                    inputs.append(var(f"{name}_{pname}"))
            elif pname not in op.attr_defaults:
                inputs.append(var(f"{name}_{pname}"))
        attrs = {k: v for k, v in kwargs.items() if v is not None}
        return _apply(op.name, inputs, attrs, name=name)

    sym_func.__name__ = op.name
    sym_func.__doc__ = (op.fn.__doc__ or "") + f"\n\n(op: {op.name}, " \
        "symbolic)"
    return sym_func


def __getattr__(name):
    op = _reg.find(name)
    if op is None:
        raise AttributeError(f"module {__name__!r} has no attribute "
                             f"{name!r}")
    fn = globals()[name] = _make_sym_func(op)
    return fn
