"""mx.nd: the imperative NDArray API (the port of
``mxnet_tpu/ndarray``). ``mx.nd.<op>`` is generated from the op
registry, as the reference generates it from its C registry."""
from __future__ import annotations

import numpy as np

from ..ops import registry as _reg
from .ndarray import NDArray, array, invoke
from .utils import load, load_frombuffer, save, save_reference

__all__ = ["NDArray", "array", "empty", "full", "invoke", "load",
           "load_frombuffer", "ones", "save", "save_reference", "zeros"]


def _make_op_func(op):
    def op_func(*args, out=None, name=None, **kwargs):
        inputs, scalars = [], []
        for a in args:
            if isinstance(a, (NDArray, np.ndarray)):
                if scalars:
                    raise TypeError(f"{op.name}: array argument after "
                                    f"scalar parameter {scalars[-1]!r}")
                inputs.append(a)
            elif a is not None:
                scalars.append(a)
        if scalars:
            _reg.bind_positional_attrs(op, scalars, kwargs)
        for pname in op.arg_names[len(inputs):]:
            if pname in kwargs:
                inputs.append(kwargs.pop(pname))
        return invoke(op, inputs, kwargs, out=out)

    op_func.__name__ = op.name
    op_func.__doc__ = (op.fn.__doc__ or "") + f"\n\n(op: {op.name})"
    return op_func


def __getattr__(name):
    # generated on first use, so ops registered after this module was
    # imported (the fused subgraph ops) appear too
    op = _reg.find(name)
    if op is None:
        raise AttributeError(f"module {__name__!r} has no attribute "
                             f"{name!r}")
    fn = globals()[name] = _make_op_func(op)
    return fn


def zeros(shape, ctx=None, dtype=None, **kwargs):
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    return array(np.zeros(shape, dtype or "float32"), ctx=ctx)


def ones(shape, ctx=None, dtype=None, **kwargs):
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    return array(np.ones(shape, dtype or "float32"), ctx=ctx)


def full(shape, val, ctx=None, dtype=None):
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    return array(np.full(shape, val, dtype or "float32"), ctx=ctx)


def empty(shape, ctx=None, dtype=None):
    return zeros(shape, ctx=ctx, dtype=dtype)
