"""Block / HybridBlock / SymbolBlock (the port of
``mxnet_tpu/gluon/block.py``).

Gluon keeps its own module system: a :class:`Block` owns a
:class:`~.parameter.ParameterDict` under a name prefix, children and
hooks; a :class:`HybridBlock` writes its computation once as
``hybrid_forward(F, x, **params)`` over either namespace, ``F = nd`` on
NDArrays or ``F = sym`` on Symbols, which is how ``export`` traces it.

Parameter names come from per-thread counters, as in the reference and
the JAX package (``resnetv10_stage1_conv0_weight``), so a ``.params``
file written by either package loads in the other and ``export`` writes
the same graph.

``hybridize()`` runs the same eager forward, under
``torch.inference_mode()`` when neither training nor recording (the
JAX package jits it there); under ``autograd.record()``, in either
mode, it runs with autograd on, so the tape sees it. A predict-mode
output that later enters a recorded op is copied out of inference mode
at the ``nd`` dispatch (``ndarray.invoke``). ``optimize_for`` waits.
"""
from __future__ import annotations

import contextlib
import re
import threading
from collections import OrderedDict

import torch

from .. import autograd
from .. import ndarray as nd_mod
from ..base import MXNetError
from ..ndarray.ndarray import NDArray
from ..ops.registry import torch_dtype
from .parameter import DeferredInitializationError, Parameter, ParameterDict

_naming = threading.local()
# per-thread forward state: ``trace`` runs hybridized children as plain
# forwards inside a hybridized call or a trace; ``meta`` makes parameters
# meta tensors (shape-only forward of infer_shapes)
_fwd = threading.local()


def _get(name, default=None):
    return getattr(_fwd, name, default)


@contextlib.contextmanager
def _forward_state(**kwargs):
    prev = {k: _get(k) for k in kwargs}
    for k, v in kwargs.items():
        setattr(_fwd, k, v)
    try:
        yield
    finally:
        for k, v in prev.items():
            setattr(_fwd, k, v)


class _BlockScope:
    """Hierarchical name scope (ref: block.py _BlockScope)."""

    _current = threading.local()

    def __init__(self, block):
        self._block = block
        self._counter = {}
        self._old_scope = None

    @staticmethod
    def create(prefix, params, hint):
        current = getattr(_BlockScope._current, "value", None)
        if current is None:
            if prefix is None:
                if not hasattr(_naming, "counter"):
                    _naming.counter = {}
                count = _naming.counter.get(hint, 0)
                _naming.counter[hint] = count + 1
                prefix = f"{hint}{count}_"
            if params is None:
                params = ParameterDict(prefix)
            else:
                params = ParameterDict(params.prefix, shared=params)
            return prefix, params
        if prefix is None:
            count = current._counter.get(hint, 0)
            current._counter[hint] = count + 1
            prefix = f"{hint}{count}_"
        if params is None:
            parent = current._block.params
            params = ParameterDict(parent.prefix + prefix,
                                   shared=parent._shared)
        else:
            params = ParameterDict(params.prefix, shared=params)
        return current._block.prefix + prefix, params

    def __enter__(self):
        if self._block._empty_prefix:
            return self
        self._old_scope = getattr(_BlockScope._current, "value", None)
        _BlockScope._current.value = self
        return self

    def __exit__(self, *exc):
        if self._block._empty_prefix:
            return False
        _BlockScope._current.value = self._old_scope
        return False


def defer_aux_update(param, new_value):
    """A BatchNorm running-statistic update from a training forward:
    written into the parameter, outside any recorded graph (the JAX
    package collects these as jit outputs apart from the gradients; the
    port runs eagerly and writes them directly). A symbolic trace
    records none: the executor updates moving statistics itself."""
    if not isinstance(new_value, NDArray) or _get("meta"):
        return
    if param._data is None:
        param.set_data(new_value)
    else:
        param._data._data = new_value._data.detach()


class Block:
    """Base building block (ref: gluon/block.py Block)."""

    def __init__(self, prefix=None, params=None):
        self._empty_prefix = prefix == ""
        self._prefix, self._params = _BlockScope.create(
            prefix, params, self._alias())
        self._name = self._prefix[:-1] if self._prefix.endswith("_") \
            else self._prefix
        self._scope = _BlockScope(self)
        self._children = OrderedDict()
        self._reg_params = {}
        self._forward_hooks = []
        self._forward_pre_hooks = []

    def _alias(self):
        return self.__class__.__name__.lower()

    @property
    def prefix(self):
        return self._prefix

    @property
    def name(self):
        return self._name

    @property
    def params(self):
        return self._params

    def name_scope(self):
        return self._scope

    def __repr__(self):
        s = f"{self.__class__.__name__}(\n"
        for key, child in self._children.items():
            s += f"  ({key}): {child!r}\n"
        return s + ")"

    def __setattr__(self, name, value):
        if isinstance(value, Block):
            existing = self.__dict__.get("_children")
            if existing is not None:
                existing[name] = value
        elif isinstance(value, Parameter):
            reg = self.__dict__.get("_reg_params")
            if reg is not None:
                reg[name] = value
        super().__setattr__(name, value)

    def register_child(self, block, name=None):
        self._children[name or str(len(self._children))] = block

    def register_forward_hook(self, hook):
        self._forward_hooks.append(hook)

    def register_forward_pre_hook(self, hook):
        self._forward_pre_hooks.append(hook)

    def collect_params(self, select=None):
        """Every parameter of the block and its children, by full name;
        ``select`` is a regex the names must match."""
        ret = ParameterDict(self._params.prefix)
        if not select:
            ret.update(self._params)
        else:
            pattern = re.compile(select)
            ret.update({k: v for k, v in self._params.items()
                        if pattern.match(k)})
        for child in self._children.values():
            ret.update(child.collect_params(select=select))
        return ret

    def _collect_params_with_prefix(self, prefix=""):
        if prefix:
            prefix += "."
        ret = {prefix + k: v for k, v in self._reg_params.items()}
        for name, child in self._children.items():
            ret.update(child._collect_params_with_prefix(prefix + name))
        return ret

    def initialize(self, init=None, ctx=None, verbose=False,
                   force_reinit=False, generator=None):
        """Initialize every parameter on ``ctx`` (``cuda:0`` when None;
        raises without CUDA unless the CPU is asked for), drawing from
        ``generator`` (else one seeded with 0)."""
        self.collect_params().initialize(init, ctx, verbose, force_reinit,
                                         generator=generator)

    def save_parameters(self, filename, deduplicate=False):
        """Save by structural name (``features.0.weight``), as the
        reference's ``save_parameters`` does."""
        params = self._collect_params_with_prefix()
        nd_mod.save(filename, {k: v.data() for k, v in params.items()
                               if v._data is not None})

    def load_parameters(self, filename, ctx=None, allow_missing=False,
                        ignore_extra=False, cast_dtype=False,
                        dtype_source="current"):
        """Load a file of ``save_parameters`` (structural names) or of
        ``collect_params().save`` (full names) onto ``ctx`` (``cuda:0``
        when None; raises without CUDA unless the CPU is asked for)."""
        loaded = nd_mod.load(filename, ctx=ctx)
        params = self._collect_params_with_prefix()
        if not any("." in k for k in loaded) and any("." in k
                                                     for k in params):
            by_name = {p.name: p for p in params.values()}
            for k, v in loaded.items():
                if k in by_name:
                    by_name[k]._load_init(v, ctx)
                elif not ignore_extra:
                    raise MXNetError(f"unknown parameter {k} in {filename}")
            if not allow_missing:
                missing = set(by_name) - set(loaded)
                if missing:
                    raise MXNetError(
                        f"parameters {sorted(missing)} missing in {filename}")
            return
        for k, p in params.items():
            if k in loaded:
                p._load_init(loaded[k], ctx)
            elif not allow_missing:
                raise MXNetError(f"parameter {k} missing in {filename}")
        if not ignore_extra:
            extra = set(loaded) - set(params)
            if extra:
                raise MXNetError(f"extra parameters in {filename}: "
                                 f"{sorted(extra)}")

    save_params = save_parameters
    load_params = load_parameters

    def apply(self, fn):
        for child in self._children.values():
            child.apply(fn)
        fn(self)
        return self

    def cast(self, dtype):
        for child in self._children.values():
            child.cast(dtype)
        for p in self._reg_params.values():
            p.cast(dtype)

    def hybridize(self, active=True, **kwargs):
        for child in self._children.values():
            child.hybridize(active, **kwargs)

    def zero_grad(self):
        self.collect_params().zero_grad()

    def __call__(self, *args):
        for hook in self._forward_pre_hooks:
            hook(self, args)
        out = self.forward(*args)
        for hook in self._forward_hooks:
            hook(self, args, out)
        return out

    def forward(self, *args):
        raise NotImplementedError


class HybridBlock(Block):
    """A block whose ``hybrid_forward`` runs on NDArrays or Symbols
    (ref: gluon/block.py HybridBlock)."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._active = False

    def hybridize(self, active=True, static_alloc=False, static_shape=False,
                  **kwargs):
        self._active = active
        super().hybridize(active, static_alloc=static_alloc,
                          static_shape=static_shape)

    def infer_shape(self, *args):
        """Resolve deferred parameter shapes from the inputs; built-in
        layers override it."""
        raise MXNetError(
            f"{self.__class__.__name__} has deferred-shape parameters but "
            "does not implement infer_shape; give explicit in_units/"
            "in_channels or implement infer_shape")

    def _param_value(self, p):
        value = p.data()
        if _get("meta"):
            value = NDArray(torch.empty(value.shape, dtype=value._data.dtype,
                                        device="meta"))
        return value

    def _collect_param_values(self, *args):
        try:
            return {n: self._param_value(p)
                    for n, p in self._reg_params.items()}
        except DeferredInitializationError:
            self.infer_shape(*args)
            for p in self._reg_params.values():
                p._finish_deferred_init()
            return {n: self._param_value(p)
                    for n, p in self._reg_params.items()}

    def forward(self, x, *args):
        from ..symbol.symbol import Symbol
        if isinstance(x, Symbol):
            # symbolic trace (export): parameters become variables by
            # their full names
            from .. import symbol as sym_mod
            for p in self._reg_params.values():
                if p._shape_incomplete():
                    raise MXNetError(
                        f"{self.name}: cannot trace symbolically while "
                        f"parameter {p.name} has unresolved shape "
                        f"{p.shape}; run the block once on data first")
            params = {n: p.var() for n, p in self._reg_params.items()}
            return self.hybrid_forward(sym_mod, x, *args, **params)
        if self._active and not _get("trace"):
            mode = contextlib.nullcontext() if autograd.is_training() \
                or autograd.is_recording() else torch.inference_mode()
            with _forward_state(trace=True), mode:
                return self.forward(x, *args)
        params = self._collect_param_values(x, *args)
        return self.hybrid_forward(nd_mod, x, *args, **params)

    def hybrid_forward(self, F, x, *args, **kwargs):
        raise NotImplementedError

    def export(self, path, epoch=0):
        """Write ``path-symbol.json`` and ``path-####.params`` (``arg:`` /
        ``aux:`` keys): the checkpoint ``model.load_checkpoint``, the
        ``Predictor`` and ``Gateway.register_checkpoint`` read. The block
        must have run once, so that every shape is known."""
        from ..symbol.trace import trace_block
        out, params = trace_block(self)
        out.save(f"{path}-symbol.json")
        aux_names = set(out.list_auxiliary_states())
        payload = {}
        for name, p in params.items():
            kind = "aux" if name in aux_names else "arg"
            payload[f"{kind}:{name}"] = p.data()
        nd_mod.save(f"{path}-{epoch:04d}.params", payload)
        return f"{path}-symbol.json", f"{path}-{epoch:04d}.params"


def infer_shapes(block, *input_shapes, dtype="float32"):
    """Resolve a block's deferred parameter shapes with one forward on
    ``meta`` tensors: each layer's shape inference fires and deferred
    initializers draw real parameters, but no op runs on a device (the
    JAX package's ``jax.eval_shape`` pass). The block's parameters must
    have been initialized (``initialize``)."""
    datas = [NDArray(torch.empty(tuple(s), dtype=torch_dtype(dtype),
                                 device="meta")) for s in input_shapes]
    with _forward_state(trace=True, meta=True):
        block.forward(*datas)


class SymbolBlock(HybridBlock):
    """A block over a Symbol graph (ref: gluon/block.py SymbolBlock)."""

    def __init__(self, outputs, inputs, params=None):
        super().__init__(prefix="", params=params)
        from ..symbol.symbol import Symbol
        self._inputs = inputs if isinstance(inputs, (list, tuple)) \
            else [inputs]
        self._out_sym = outputs if isinstance(outputs, Symbol) \
            else outputs[0]
        input_names = {s.name for s in self._inputs}
        for name in self._out_sym.list_inputs():
            if name not in input_names:
                self._reg_params[name] = self.params.get(
                    name, allow_deferred_init=True)

    @staticmethod
    def imports(symbol_file, input_names, param_file=None, ctx=None):
        """A SymbolBlock from an exported graph and, optionally, its
        parameters (``arg:`` / ``aux:`` keys or bare names) loaded onto
        ``ctx`` (``cuda:0`` when None; raises without CUDA unless the
        CPU is asked for)."""
        from .. import symbol as sym_mod
        out = sym_mod.load(symbol_file)
        names = input_names if isinstance(input_names, (list, tuple)) \
            else [input_names]
        blk = SymbolBlock(out, [sym_mod.var(n) for n in names])
        if param_file:
            loaded = {k.split(":", 1)[-1]: v
                      for k, v in nd_mod.load(param_file, ctx=ctx).items()}
            for name, p in blk._reg_params.items():
                if name in loaded:
                    p.set_data(loaded[name])
        return blk

    def forward(self, *args):
        bindings = {s.name: a for s, a in zip(self._inputs, args)}
        for name, p in self._reg_params.items():
            if p._data is not None:
                bindings[name] = self._param_value(p)
        return self._out_sym.eval_dict(bindings)

    def hybrid_forward(self, F, *args, **kwargs):
        raise NotImplementedError
