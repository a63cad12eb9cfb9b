"""Parameter / ParameterDict (the port of ``mxnet_tpu/gluon/parameter.py``).

A :class:`Parameter` owns one NDArray on one device plus its
initializer and deferred-shape state: a layer built without its input
size (``Dense(10)``, ``Conv2D(64, 3)``) declares a 0 in the shape, and
the first forward fills it in (``shape_inferred``) and then draws the
values. Values are drawn on the CPU from an explicit
``torch.Generator`` (``initialize(generator=...)``, else one seeded
with 0, so an initialization repeats) and moved to the parameter's
device: ``cuda:0`` unless the caller asks for the CPU.

A parameter whose ``grad_req`` is not ``"null"`` gets a gradient buffer
when its values are drawn or set (``NDArray.attach_grad``): its tensor
is then a leaf that requires grad, which ``autograd.backward`` writes
``grad()`` for. ``set_data``, ``cast`` and ``reset_ctx`` make a new leaf
and keep the gradient buffer, as the JAX package keeps it.
"""
from __future__ import annotations

from collections import OrderedDict

import numpy as np
import torch

from .. import initializer as init_mod
from ..base import MXNetError
from ..context import resolve_device
from ..ndarray.ndarray import NDArray, as_tensor
from ..ops.registry import dtype_name, torch_dtype
from ..profiling import memory as _mem
from ..random import generator as seeded_generator


class DeferredInitializationError(MXNetError):
    """Raised when a parameter's data is requested before its shape is
    known."""


def _one_ctx(ctx):
    """The one device of ``ctx`` (a context, a device name or a list of
    one): the port keeps one copy of each parameter."""
    if isinstance(ctx, (list, tuple)):
        if len(ctx) != 1:
            raise MXNetError(f"a parameter lives on one device; got {ctx} "
                             "(replication across cards is not ported)")
        ctx = ctx[0]
    return resolve_device(ctx)


class Parameter:
    """One named array with its initializer (ref: gluon/parameter.py)."""

    def __init__(self, name, grad_req="write", shape=None, dtype="float32",
                 lr_mult=1.0, wd_mult=1.0, init=None,
                 allow_deferred_init=False, differentiable=True,
                 stype="default", grad_stype="default"):
        self.name = name
        self._grad_req = grad_req if differentiable else "null"
        self.shape = tuple(shape) if shape is not None else None
        self.dtype = dtype_name(dtype)
        self.lr_mult = lr_mult
        self.wd_mult = wd_mult
        self.init = init
        self.allow_deferred_init = allow_deferred_init
        self.stype = stype
        self.grad_stype = grad_stype
        self._data = None
        self._deferred_init = None
        self._device = None

    def __repr__(self):
        return f"Parameter {self.name} (shape={self.shape}, dtype={self.dtype})"

    @property
    def grad_req(self):
        return self._grad_req

    @grad_req.setter
    def grad_req(self, req):
        if req not in ("null", "write", "add"):
            raise MXNetError(f"grad_req must be null, write or add, got "
                             f"{req!r}")
        self._grad_req = req
        if self._data is None:
            return
        if req == "null":
            self._data.grad = None
            self._data._grad_req = "null"
            self._data._data = self._data._data.detach()
            _mem.tag_role(self._data, "parameter")
        elif self._data.grad is None:
            self._data.attach_grad(req)
        else:
            self._data._grad_req = req

    def _rebind(self, t):
        """Make ``t`` the parameter's tensor: a fresh leaf that requires
        grad when a gradient is attached; the gradient buffer stays."""
        from .. import autograd
        t = t.detach()
        self._data._data = autograd._leaf(t) if self._data.grad is not None \
            else t
        _mem.tag_role(self._data, "parameter")

    def _shape_incomplete(self):
        return self.shape is None or any(d == 0 for d in self.shape)

    # -- initialization ----------------------------------------------------
    def initialize(self, init=None, ctx=None, default_init=None,
                   force_reinit=False, generator=None):
        """Draw the values on ``ctx`` (``cuda:0`` when None; raises
        without CUDA unless the CPU is asked for). With the shape still
        incomplete and deferred init allowed, the draw waits for the
        first forward."""
        if self._data is not None and not force_reinit:
            return
        self._device = _one_ctx(ctx)
        default_init = default_init or init_mod.Uniform()
        generator = generator or seeded_generator(0)
        if self._shape_incomplete():
            if self.allow_deferred_init:
                self._deferred_init = (init, default_init, generator)
                return
            raise MXNetError(
                f"cannot initialize {self.name}: shape {self.shape} "
                "incomplete and deferred init not allowed")
        self._finish_init(init, default_init, generator)

    def _finish_init(self, init, default_init, generator):
        # a deferred init may finish inside a hybridized inference
        # forward: the parameter is still made a normal tensor
        with torch.inference_mode(False):
            value = torch.zeros(self.shape, dtype=torch_dtype(self.dtype))
            init_mod.create(init or self.init or default_init)(
                self.name, value, generator)
            self._data = NDArray(value.to(self._device))
            if self._grad_req != "null":
                self._data.attach_grad(self._grad_req)
        # the census role (a weak side-table write; profiling/memory.py)
        _mem.tag_role(self._data, "parameter")
        self._deferred_init = None

    def _finish_deferred_init(self):
        if self._deferred_init is None:
            return
        if self._shape_incomplete():
            raise DeferredInitializationError(
                f"parameter {self.name} shape still unknown")
        self._finish_init(*self._deferred_init)

    def shape_inferred(self, shape):
        """Fill in the input-dependent dims (0s) once a layer knows
        them, and finish a deferred initialization."""
        shape = tuple(int(s) for s in shape)
        if self.shape is not None:
            if len(self.shape) != len(shape) or any(
                    o != 0 and o != n for o, n in zip(self.shape, shape)):
                raise MXNetError(
                    f"{self.name}: inferred shape {shape} incompatible "
                    f"with declared {self.shape}")
        self.shape = shape
        if self._deferred_init is not None:
            self._finish_deferred_init()

    # -- access ------------------------------------------------------------
    def data(self, ctx=None):
        if self._data is None:
            if self._deferred_init is not None:
                raise DeferredInitializationError(
                    f"parameter {self.name} not fully initialized yet "
                    "(deferred shape)")
            raise MXNetError(
                f"parameter {self.name} has not been initialized; call "
                ".initialize() first")
        return self._data

    def list_data(self):
        return [self.data()]

    def grad(self, ctx=None):
        if self._data is None or self._data.grad is None:
            raise MXNetError(
                f"parameter {self.name} has no gradient (grad_req="
                f"{self._grad_req!r} or not initialized)")
        return self._data.grad

    def list_grad(self):
        return [self.grad()]

    def zero_grad(self):
        if self._data is not None and self._data.grad is not None:
            g = self._data.grad
            g._data = torch.zeros_like(g._data)

    def list_ctx(self):
        return [self.data().context]

    def set_data(self, data):
        """Replace the values (shape must match a known shape; the dtype
        is the data's, as in the JAX package). The values land on the
        parameter's device when it has one, else they stay where
        ``data`` lives."""
        t = as_tensor(data)
        if not self._shape_incomplete() and \
                tuple(t.shape) != tuple(self.shape):
            raise MXNetError(f"set_data: shape {tuple(t.shape)} != "
                             f"parameter shape {self.shape}")
        if self._data is not None:
            t = t.to(self._data._data.device)
        elif self._device is not None:
            t = t.to(self._device)
        self.shape = tuple(t.shape)
        self.dtype = dtype_name(t.dtype)
        with torch.no_grad():
            t = t.clone()
        if self._data is None:
            self._data = NDArray(t)
            if self._grad_req != "null":
                self._data.attach_grad(self._grad_req)
        else:
            self._rebind(t)
        _mem.tag_role(self._data, "parameter")
        self._device = self._data._data.device
        self._deferred_init = None

    def _load_init(self, data, ctx=None):
        if ctx is not None:
            self._device = _one_ctx(ctx)
        self.set_data(data)

    def cast(self, dtype):
        """Cast the values (running statistics too, as in the JAX
        package); the gradient buffer keeps its dtype until the next
        backward writes one."""
        self.dtype = dtype_name(dtype)
        if self._data is not None:
            self._rebind(self._data._data.detach().to(torch_dtype(dtype)))

    def var(self):
        from ..symbol import var
        return var(self.name, shape=self.shape, dtype=self.dtype)

    def reset_ctx(self, ctx):
        self._device = _one_ctx(ctx)
        if self._data is not None:
            self._rebind(self._data._data.detach().to(self._device))
            if self._data.grad is not None:
                g = self._data.grad
                g._data = g._data.to(self._device)


class Constant(Parameter):
    """A parameter that holds a fixed value (ref: gluon/parameter.py
    Constant)."""

    def __init__(self, name, value):
        value = np.asarray(value.asnumpy() if hasattr(value, "asnumpy")
                           else value)
        self.value = value
        super().__init__(name, grad_req="null", shape=value.shape,
                         dtype=value.dtype,
                         init=init_mod.Load({name: value}))


class ParameterDict:
    """Name -> :class:`Parameter` under a prefix, optionally sharing the
    parameters of another dict."""

    def __init__(self, prefix="", shared=None):
        self._prefix = prefix
        self._params = OrderedDict()
        self._shared = shared

    @property
    def prefix(self):
        return self._prefix

    def __repr__(self):
        items = "\n".join(f"  {v}" for v in self._params.values())
        return f"ParameterDict(prefix={self._prefix!r}\n{items}\n)"

    def __getitem__(self, key):
        return self._params[key]

    def __contains__(self, key):
        return key in self._params

    def __iter__(self):
        return iter(self._params)

    def __len__(self):
        return len(self._params)

    def items(self):
        return self._params.items()

    def keys(self):
        return self._params.keys()

    def values(self):
        return self._params.values()

    def get(self, name, **kwargs):
        """``prefix + name``, created (or taken from the shared dict) if
        absent; an existing one must agree with a requested shape and
        dtype."""
        name = self._prefix + name
        if name in self._params:
            param = self._params[name]
            want = kwargs.get("shape")
            if want is not None and param.shape is not None and (
                    len(want) != len(param.shape) or any(
                        w != 0 and p != 0 and w != p
                        for w, p in zip(want, param.shape))):
                raise MXNetError(
                    f"cannot share parameter {name}: requested shape "
                    f"{tuple(want)} != existing {param.shape}")
            want_dtype = kwargs.get("dtype")
            if want_dtype is not None and \
                    dtype_name(want_dtype) != param.dtype:
                raise MXNetError(
                    f"cannot share parameter {name}: requested dtype "
                    f"{want_dtype} != existing {param.dtype}")
            return param
        if self._shared is not None and name in self._shared:
            self._params[name] = self._shared[name]
            return self._params[name]
        param = Parameter(name, **kwargs)
        self._params[name] = param
        return param

    def get_constant(self, name, value=None):
        name = self._prefix + name
        if name not in self._params:
            self._params[name] = Constant(name, value)
        return self._params[name]

    def update(self, other):
        for k, v in other.items():
            self._params[k] = v

    def initialize(self, init=None, ctx=None, verbose=False,
                   force_reinit=False, generator=None):
        """Initialize every parameter on ``ctx``; ``init`` is the default
        for parameters without their own. One generator (``generator``,
        else one seeded with 0) draws them all, in order."""
        generator = generator or seeded_generator(0)
        for p in self._params.values():
            p.initialize(init=None, ctx=ctx,
                         default_init=init or init_mod.Uniform(),
                         force_reinit=force_reinit, generator=generator)

    def zero_grad(self):
        for p in self._params.values():
            p.zero_grad()

    def setattr(self, name, value):
        for p in self._params.values():
            setattr(p, name, value)

    def reset_ctx(self, ctx):
        for p in self._params.values():
            p.reset_ctx(ctx)

    def save(self, fname, strip_prefix=""):
        from ..ndarray import save as nd_save
        payload = {}
        for name, p in self._params.items():
            if strip_prefix and name.startswith(strip_prefix):
                name = name[len(strip_prefix):]
            payload[name] = p.data()
        nd_save(fname, payload)

    def load(self, fname, ctx=None, allow_missing=False,
             ignore_extra=False, restore_prefix=""):
        from ..ndarray import load as nd_load
        loaded = {restore_prefix + k: v
                  for k, v in nd_load(fname, ctx=ctx).items()}
        for name, p in self._params.items():
            if name in loaded:
                p._load_init(loaded[name], ctx)
            elif not allow_missing:
                raise MXNetError(f"parameter {name} missing in file {fname}")
        if not ignore_extra:
            extra = set(loaded) - set(self._params)
            if extra:
                raise MXNetError(f"file {fname} has extra parameters "
                                 f"{sorted(extra)}")
