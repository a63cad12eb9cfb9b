"""NDArray on a torch tensor (the port of ``mxnet_tpu/ndarray/ndarray.py``).

The reference's NDArray holds a storage chunk plus an engine variable
and pushes every op to its threaded engine; here it holds a
``torch.Tensor``, whose CUDA work is already asynchronous on the current
stream. ``wait_to_read`` is a stream synchronisation (deferred CUDA
errors surface there) and ``asnumpy()`` the explicit copy to the host.
Ops dispatch through the registry under ``torch.no_grad()``: ``mx.nd``
records nothing (the port has no ``autograd.record`` yet), and its
results stay ordinary tensors that a training forward of the executor
may take as inputs, which inference-mode tensors could not be.
"""
from __future__ import annotations

import numbers

import numpy as np
import torch

from ..base import MXNetError
from ..context import Context, resolve_device
from ..ops import registry as _reg

__all__ = ["NDArray", "array", "invoke"]


def _canon_attr(v):
    """lists -> tuples, numpy scalars -> Python, MXNet string tuples
    '(1, 1)' -> tuples."""
    if isinstance(v, list):
        return tuple(_canon_attr(x) for x in v)
    if isinstance(v, np.generic):
        return v.item()
    if isinstance(v, str) and v.startswith("(") and v.endswith(")"):
        try:
            return tuple(int(x) for x in v[1:-1].split(",") if x.strip())
        except ValueError:
            return v
    return v


def as_tensor(value, device=None):
    """Tensor of an NDArray, a tensor, a numpy array or a host scalar;
    on ``device`` when one is given."""
    if isinstance(value, NDArray):
        value = value._data
    if not isinstance(value, torch.Tensor):
        value = torch.from_numpy(np.array(value))
    return value if device is None else value.to(device)


class NDArray:
    """n-dimensional array on a device."""

    __slots__ = ("_data", "__weakref__")

    def __init__(self, data, ctx=None):
        data = as_tensor(data)
        if ctx is not None:
            data = data.to(resolve_device(ctx))
        self._data = data

    # -- basic properties --------------------------------------------------
    @property
    def shape(self):
        return tuple(self._data.shape)

    @property
    def dtype(self):
        return _reg.numpy_dtype(self._data.dtype)

    @property
    def size(self):
        return int(self._data.numel())

    @property
    def ndim(self):
        return self._data.ndim

    @property
    def context(self):
        return Context(self._data.device)

    ctx = context

    # -- sync / conversion -------------------------------------------------
    def asnumpy(self):
        return self._data.detach().cpu().numpy()

    def asscalar(self):
        if self.size != 1:
            raise MXNetError("The current array is not a scalar")
        return self.asnumpy().reshape(-1)[0]

    def item(self):
        return self.asscalar()

    def wait_to_read(self):
        if self._data.is_cuda:
            torch.cuda.current_stream(self._data.device).synchronize()

    wait_to_write = wait_to_read

    def as_in_context(self, ctx):
        dev = resolve_device(ctx)
        if dev == self._data.device:
            return self
        return NDArray(self._data.to(dev))

    as_in_ctx = as_in_context

    def copyto(self, other):
        """Copy into ``other`` (an NDArray: its device, its buffer
        rebound) or onto a context (a new NDArray)."""
        if isinstance(other, NDArray):
            other._data = self._data.to(other._data.device, copy=True)
            return other
        return NDArray(self._data.to(resolve_device(other), copy=True))

    def copy(self):
        return NDArray(self._data.clone())

    def astype(self, dtype, copy=True):
        return NDArray(self._data.to(_reg.torch_dtype(dtype)))

    def reshape(self, *shape, **kwargs):
        if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
            shape = tuple(shape[0])
        return NDArray(self._data.reshape(kwargs.get("shape", shape)))

    # -- python protocol ---------------------------------------------------
    def __repr__(self):
        return (f"\n{self.asnumpy()!r}\n<NDArray "
                f"{'x'.join(map(str, self.shape))} @{self.context}>")

    def __len__(self):
        if not self.shape:
            raise TypeError("len() of unsized object")
        return self.shape[0]

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    def __bool__(self):
        if self.size == 1:
            return bool(self.asscalar())
        raise MXNetError("ambiguous truth value of multi-element NDArray")

    def __float__(self):
        return float(self.asscalar())

    def __int__(self):
        return int(self.asscalar())

    def __hash__(self):
        return id(self)

    def __getitem__(self, key):
        if isinstance(key, NDArray):
            key = key._data
        return NDArray(self._data[key])

    # -- arithmetic --------------------------------------------------------
    def _binary(self, other, op, scalar_op, rev=False):
        if isinstance(other, NDArray):
            a, b = (other, self) if rev else (self, other)
            return invoke(op, [a, b], {})
        if isinstance(other, numbers.Number):
            return invoke(scalar_op, [self], {"scalar": float(other)})
        return NotImplemented

    def __add__(self, o):
        return self._binary(o, "broadcast_add", "_plus_scalar")

    __radd__ = __add__

    def __sub__(self, o):
        return self._binary(o, "broadcast_sub", "_minus_scalar")

    def __rsub__(self, o):
        return self._binary(o, "broadcast_sub", "_rminus_scalar", rev=True)

    def __mul__(self, o):
        return self._binary(o, "broadcast_mul", "_mul_scalar")

    __rmul__ = __mul__

    def __truediv__(self, o):
        return self._binary(o, "broadcast_div", "_div_scalar")

    def __rtruediv__(self, o):
        return self._binary(o, "broadcast_div", "_rdiv_scalar", rev=True)

    def __neg__(self):
        return invoke("negative", [self], {})

    def __abs__(self):
        return invoke("abs", [self], {})

    def _inplace(self, res):
        self._data = res._data
        return self

    def __iadd__(self, o):
        return self._inplace(self + o)

    def __isub__(self, o):
        return self._inplace(self - o)

    def __imul__(self, o):
        return self._inplace(self * o)

    def __itruediv__(self, o):
        return self._inplace(self / o)


def invoke(op_name, inputs, attrs, out=None):
    """Imperative op dispatch (MXImperativeInvoke analogue): unwraps
    NDArrays, passes the autograd training flag to ops that take one,
    runs the registered function, wraps the outputs. A range
    output the op computed on the host becomes a 0-d tensor on the
    inputs' device."""
    op = _reg.get(op_name) if isinstance(op_name, str) else op_name
    attrs = {k: _canon_attr(v) for k, v in attrs.items() if v is not None}
    attrs.pop("num_args", None)
    if "training" in op._kwarg_names and "training" not in attrs:
        from .. import autograd
        attrs["training"] = autograd.is_training()
    tensors = [as_tensor(i) for i in inputs if i is not None]
    device = tensors[0].device if tensors else resolve_device(None)
    with torch.no_grad():
        raw = op(*tensors, **attrs)
    multi = isinstance(raw, (tuple, list))
    outs = [NDArray(as_tensor(r, device)) for r in (raw if multi else [raw])]
    if out is not None:
        targets = out if isinstance(out, (tuple, list)) else [out]
        for t, o in zip(targets, outs):
            t._data = o._data
        return out
    return tuple(outs) if multi else outs[0]


def array(source_array, ctx=None, dtype=None):
    """An NDArray from any array-like, on ``ctx`` (the current context
    when None: ``cuda:0`` outside a ``with mx.cpu():`` scope).
    float64 numpy input becomes float32 and int64 int32 unless a dtype
    is given; Python lists default to float32, like the reference."""
    if isinstance(source_array, NDArray):
        data = source_array.asnumpy()
    elif isinstance(source_array, torch.Tensor):
        data = source_array.detach().cpu().numpy()
    else:
        data = source_array
    if isinstance(data, np.ndarray):
        if dtype is not None:
            data = data.astype(dtype)
        elif data.dtype == np.float64:
            data = data.astype(np.float32)
        elif data.dtype == np.int64:
            data = data.astype(np.int32)
    else:
        data = np.asarray(data, dtype=dtype or np.float32)
    return NDArray(torch.from_numpy(np.array(data)),
                   ctx=ctx if ctx is not None else resolve_device(None))
