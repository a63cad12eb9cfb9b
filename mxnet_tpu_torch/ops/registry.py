"""Operator registry: the port's counterpart of ``mxnet_tpu/ops/registry.py``.

An op is a plain function over torch tensors plus keyword attrs,
registered under its MXNet name, so symbol JSON written by either
package resolves here. Shape and dtype inference run the same function
on ``meta`` tensors (no data, no device work), the counterpart of the
JAX package's ``jax.eval_shape``. ``mx.nd.*`` and ``mx.sym.*`` are
generated from this registry.

Range scalars that the graph knows at bind time (calibrated
quantization ranges) may flow between ops as host ``numpy.float32``
values instead of tensors; see ``ops/quantized.py``.
"""
from __future__ import annotations

import inspect

import numpy as np
import torch

from ..base import MXNetError

_OPS = {}

# positional params with a None default that are arrays, not attrs
_ARRAYISH = {"bias", "gamma", "weight"}


class OpDef:
    """A registered operator.

    Parameters
    ----------
    name : canonical MXNet-compatible op name (e.g. "FullyConnected").
    fn : function (*tensors, **attrs) -> tensor | tuple of outputs.
    num_outputs : outputs of a node of this op.
    """

    def __init__(self, name, fn, aliases=(), num_outputs=1):
        self.name = name
        self.fn = fn
        self.aliases = tuple(aliases)
        self.num_outputs = num_outputs
        params = list(inspect.signature(fn).parameters.values())
        self.arg_names = tuple(
            p.name for p in params
            if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)
            and (p.default is p.empty
                 or (p.default is None and p.name in _ARRAYISH)))
        self.has_varargs = any(p.kind == p.VAR_POSITIONAL for p in params)
        self._kwarg_names = tuple(
            p.name for p in params
            if p.kind in (p.KEYWORD_ONLY, p.POSITIONAL_OR_KEYWORD)
            and p.default is not p.empty
            and not (p.default is None and p.name in _ARRAYISH))
        self.attr_defaults = {
            p.name: p.default for p in params
            if p.kind in (p.KEYWORD_ONLY, p.POSITIONAL_OR_KEYWORD)
            and p.default is not p.empty}

    def __repr__(self):
        return f"<Op {self.name}>"

    def __call__(self, *arrays, **attrs):
        return self.fn(*arrays, **attrs)


def register_op(name, fn, aliases=(), num_outputs=1):
    """Register a function as a framework op (plain-function form)."""
    op = OpDef(name, fn, aliases=aliases, num_outputs=num_outputs)
    for key in (name,) + tuple(aliases):
        if key in _OPS:
            raise MXNetError(f"op {key} registered twice")
        _OPS[key] = op
    return op


def register(name=None, aliases=(), num_outputs=1):
    """Decorator form of :func:`register_op`."""

    def deco(fn):
        register_op(name or fn.__name__, fn, aliases=aliases,
                    num_outputs=num_outputs)
        return fn

    return deco


def get(name):
    try:
        return _OPS[name]
    except KeyError:
        raise MXNetError(f"operator {name!r} is not registered") from None


def find(name):
    return _OPS.get(name)


def bind_positional_attrs(op, scalars, attrs, err_cls=TypeError):
    """Bind positional non-array call arguments to the op's declared
    attr names in signature order (x.clip(0, 1), nd.one_hot(idx, 3)).
    Mutates ``attrs``; a name given both positionally and by keyword
    raises. Integer positionals onto a sole 'axes' slot (and onto
    'axis' on overflow) pack into a tuple, as x.transpose(2, 0, 1)."""
    names = op._kwarg_names
    ints = all(isinstance(s, (int, np.integer))
               and not isinstance(s, bool) for s in scalars)
    if ints and len(names) >= 1 and names[0] not in attrs and (
            (names[0] == "axes" and scalars)
            or (names[0] == "axis" and len(scalars) > len(names))):
        scalars = [tuple(int(s) for s in scalars)]
    if len(scalars) > len(names):
        raise err_cls(
            "%s: %d positional parameter(s) but only %d declared: %r"
            % (op.name, len(scalars), len(names), list(names)))
    for n, v in zip(names, scalars):
        if n in attrs:
            raise err_cls(
                "%s got multiple values for parameter %r" % (op.name, n))
        if v is not None:
            attrs[n] = v


def torch_dtype(dtype):
    """numpy dtype (or its name, "bfloat16" included) -> torch dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    if str(dtype) == "bfloat16":
        return torch.bfloat16
    return torch.from_numpy(np.empty(0, np.dtype(dtype))).dtype


def dtype_name(dtype):
    """The name of a numpy or torch dtype (or of a name): "float32",
    "bfloat16", "int8"..."""
    return str(torch_dtype(dtype)).rsplit(".", 1)[-1]


def numpy_dtype(dtype):
    """torch dtype -> numpy dtype. numpy has no bfloat16 of its own:
    ``ml_dtypes``' one (the JAX package's) is imported when first
    asked for, and its absence raises."""
    if dtype == torch.bfloat16:
        return np.dtype(_ml_dtypes().bfloat16)
    return torch.empty(0, dtype=dtype).numpy().dtype


def _ml_dtypes():
    try:
        import ml_dtypes
    except ImportError:
        raise MXNetError(
            "bfloat16 as a numpy array needs the ml_dtypes package, which "
            "is not installed; read the values through torch or cast the "
            "array to float32 first") from None
    return ml_dtypes


def bf16_to_numpy(t):
    """A bfloat16 CPU tensor as a numpy array of ``ml_dtypes.bfloat16``
    (the same bits)."""
    return t.view(torch.int16).numpy().view(_ml_dtypes().bfloat16)


def bf16_from_numpy(a):
    """A numpy array of ``ml_dtypes.bfloat16`` as a bfloat16 tensor (the
    same bits; needs no ml_dtypes)."""
    a = np.ascontiguousarray(a).reshape(a.shape)  # keeps a 0-d shape
    return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)


def infer_output(op_name, in_specs, attrs):
    """[(shape, numpy dtype name)] of each output for inputs given as
    (shape, dtype name) specs or host scalars, by running the op on
    ``meta`` tensors (the FInferShape/FInferType analogue)."""
    op = get(op_name)
    ins = [v if not isinstance(v, tuple) else
           torch.empty(v[0], dtype=torch_dtype(v[1]), device="meta")
           for v in in_specs]
    with torch.inference_mode():
        out = op.fn(*ins, **attrs)
    outs = out if isinstance(out, (tuple, list)) else [out]
    return [(tuple(o.shape), numpy_dtype(o.dtype).name)
            if isinstance(o, torch.Tensor)
            else ((), np.asarray(o).dtype.name) for o in outs]
