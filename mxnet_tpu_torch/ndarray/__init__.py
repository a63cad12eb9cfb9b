"""mx.nd: the imperative NDArray API (the port of
``mxnet_tpu/ndarray``). ``mx.nd.<op>`` is generated from the op
registry, as the reference generates it from its C registry.

The update ops the reference runs in place (``sgd_mom_update``,
``adam_update``: ``TMutateInputs`` in its optimizer_op.cc) keep that
call surface here, as the JAX package's ``_make_inplace_update`` does:
the new states land in the state NDArrays and the new weight in
``out=``. The JAX package rebinds those arrays to fresh results; the
port writes into their tensors, through K2 on the card, which reads and
writes each array once with ``out`` over the weight itself. The writes
run under ``torch.no_grad()``, so a weight autograd has seen stays
legal to update.
"""
from __future__ import annotations

import numpy as np
import torch

from ..base import MXNetError
from ..ops import fused_opt as _fused_opt
from ..ops import registry as _reg
from ..profiling import optrace as _optrace
from .ndarray import NDArray, _canon_attr, array, as_tensor, invoke
from .utils import load, load_frombuffer, save, save_reference

__all__ = ["NDArray", "array", "empty", "full", "invoke", "load",
           "load_frombuffer", "ones", "save", "save_reference", "zeros"]


def _split_args(op, args, kwargs):
    """(array inputs, attrs) of an ``mx.nd.<op>(...)`` call: arrays
    positionally or by name, attrs by keyword or positionally after
    the arrays."""
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
    return inputs, kwargs


def _make_op_func(op):
    def op_func(*args, out=None, name=None, **kwargs):
        inputs, attrs = _split_args(op, args, kwargs)
        return invoke(op, inputs, attrs, out=out)

    op_func.__name__ = op.name
    op_func.__doc__ = (op.fn.__doc__ or "") + f"\n\n(op: {op.name})"
    return op_func


# in-place update ops: name -> (index of the first state input, the K2
# wrapper that writes into given output tensors)
_IN_PLACE_UPDATES = {"sgd_mom_update": (2, _fused_opt.fused_sgd_mom),
                     "adam_update": (2, _fused_opt.fused_adam)}


def _make_inplace_update(op, state_start, fused):
    def update(*args, out=None, name=None, **kwargs):
        inputs, attrs = _split_args(op, args, kwargs)
        if len(inputs) != len(op.arg_names):
            raise MXNetError(f"{op.name}: expected arrays "
                             f"{list(op.arg_names)}, got {len(inputs)}")
        attrs = {k: _canon_attr(v) for k, v in attrs.items()
                 if v is not None and k != "lazy_update"}
        tensors = [as_tensor(a) for a in inputs]
        weight = out._data if out is not None \
            else torch.empty_like(tensors[0])
        # only NDArray states can reflect the update, as in the JAX package
        dsts = [weight] + [s._data if isinstance(s, NDArray)
                           else torch.empty_like(t)
                           for s, t in zip(inputs[state_start:],
                                           tensors[state_start:])]
        with torch.no_grad():
            if _optrace.ACTIVE[0]:     # an op trace or capture: its scope
                _optrace.scoped(op.name, fused, tensors,
                                dict(attrs, out=dsts))
            else:
                fused(*tensors, out=dsts, **attrs)
        return out if out is not None else NDArray(weight)

    update.__name__ = op.name
    update.__doc__ = (op.fn.__doc__ or "") + (
        f"\n\n(op: {op.name}; states and ``out`` updated in place)")
    return update


def __getattr__(name):
    # generated on first use, so ops registered after this module was
    # imported (the fused subgraph ops) appear too
    op = _reg.find(name)
    if op is None:
        raise AttributeError(f"module {__name__!r} has no attribute "
                             f"{name!r}")
    if op.name in _IN_PLACE_UPDATES:
        fn = _make_inplace_update(op, *_IN_PLACE_UPDATES[op.name])
    else:
        fn = _make_op_func(op)
    globals()[name] = fn
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
