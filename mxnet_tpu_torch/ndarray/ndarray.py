"""NDArray on a torch tensor (the port of ``mxnet_tpu/ndarray/ndarray.py``).

The reference's NDArray holds a storage chunk plus an engine variable
and pushes every op to its threaded engine; here it holds a
``torch.Tensor``, whose CUDA work is already asynchronous on the current
stream. ``wait_to_read`` is a stream synchronisation (deferred CUDA
errors surface there) and ``asnumpy()`` the explicit copy to the host.

Ops dispatch through the registry with torch's gradients enabled exactly
while ``autograd.record()`` is on, so torch records what the JAX
package's tape records and nothing else. An array with a gradient
attached (``attach_grad``) holds a leaf tensor that requires grad;
outside ``record`` its ops build no graph. An inference-mode tensor (a
hybridized block's predict-mode output) that enters a recorded op is
copied first: autograd cannot save inference tensors for backward.
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
        value = np.array(value)
        value = _reg.bf16_from_numpy(value) \
            if value.dtype.name == "bfloat16" else torch.from_numpy(value)
    return value if device is None else value.to(device)


class NDArray:
    """n-dimensional array on a device."""

    __slots__ = ("_data", "grad", "_grad_req", "_gen", "__weakref__")

    def __init__(self, data, ctx=None):
        data = as_tensor(data)
        if ctx is not None:
            data = data.to(resolve_device(ctx))
        self._data = data
        self.grad = None
        self._grad_req = "null"
        self._gen = None    # tape generation of a recorded output

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

    @property
    def stype(self):
        return "default"

    # -- sync / conversion -------------------------------------------------
    def asnumpy(self):
        """A host copy (never a view of the array: updates write into
        arrays in place)."""
        t = self._data.detach()
        t = t.clone() if t.device.type == "cpu" else t.cpu()
        return _reg.bf16_to_numpy(t) if t.dtype == torch.bfloat16 \
            else t.numpy()

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
        return NDArray(self._data.detach().to(dev))

    as_in_ctx = as_in_context

    def copyto(self, other):
        """Copy into ``other`` (an NDArray: its device, its buffer
        rebound) or onto a context (a new NDArray)."""
        if isinstance(other, NDArray):
            other._data = self._data.detach().to(other._data.device,
                                                 copy=True)
            return other
        return NDArray(self._data.detach().to(resolve_device(other),
                                              copy=True))

    def copy(self):
        return NDArray(self._data.detach().clone())

    def astype(self, dtype, copy=True):
        return invoke("Cast", [self], {"dtype": _reg.dtype_name(dtype)})

    def reshape(self, *shape, **kwargs):
        if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
            shape = tuple(shape[0])
        shape = kwargs.get("shape", shape)
        return invoke("Reshape", [self], {
            "shape": tuple(shape), "reverse": kwargs.get("reverse", False)})

    def reshape_like(self, other):
        return invoke("Reshape", [self], {"shape": other.shape})

    @property
    def T(self):
        return invoke("transpose", [self], {})

    def detach(self):
        return NDArray(self._data.detach())

    # -- autograd ----------------------------------------------------------
    def attach_grad(self, grad_req="write", stype=None):
        """Attach a zero gradient buffer: the array becomes a variable
        (a leaf that requires grad) whose gradient ``backward`` writes
        by ``grad_req``."""
        from .. import autograd
        if stype not in (None, "default"):
            raise MXNetError(f"attach_grad: stype {stype!r} waits for "
                             "sparse NDArray")
        with torch.no_grad():
            self.grad = NDArray(torch.zeros_like(self._data))
        self._grad_req = grad_req
        autograd._mark(self)

    def backward(self, out_grad=None, retain_graph=False, train_mode=True):
        from .. import autograd
        autograd.backward([self], [out_grad] if out_grad is not None
                          else None, retain_graph=retain_graph,
                          train_mode=train_mode)

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

    def __index__(self):
        return int(self.asscalar())

    def __hash__(self):
        return id(self)

    def __getstate__(self):
        return {"data": self.asnumpy(), "grad_req": self._grad_req}

    def __setstate__(self, state):
        """Unpickled onto the current context (``cuda:0`` outside a
        ``with mx.cpu():`` scope)."""
        self._data = torch.from_numpy(np.array(state["data"])).to(
            resolve_device(None))
        self.grad = None
        self._grad_req = state.get("grad_req", "null")
        self._gen = None

    # -- indexing ----------------------------------------------------------
    @staticmethod
    def _key(key):
        def one(k):
            if isinstance(k, NDArray):
                k = k._data
            if isinstance(k, torch.Tensor) and k.is_floating_point():
                k = k.long()
            return k
        return tuple(one(k) for k in key) if isinstance(key, tuple) \
            else one(key)

    def __getitem__(self, key):
        """Indexing; recorded (differentiable) under ``record``."""
        from .. import autograd
        key = self._key(key)
        if autograd.is_recording() and self._data.requires_grad:
            return autograd.stamp(NDArray(self._data[key]))
        with torch.no_grad():
            return NDArray(self._data[key])

    def __setitem__(self, key, value):
        """Assignment into the array. Under ``record``, on an array in
        the graph, it is recorded as a functional update (the JAX
        package's ``_slice_assign``): the array rebinds to a new tensor.
        Otherwise it writes in place, outside the graph."""
        from .. import autograd
        key = self._key(key)
        if isinstance(value, NDArray):
            value = value._data
        elif not isinstance(value, (numbers.Number, torch.Tensor)):
            value = torch.as_tensor(np.asarray(value))
        if isinstance(value, torch.Tensor):
            value = value.to(self._data.device, self._data.dtype)
        if autograd.is_recording() and (
                self._data.requires_grad or (isinstance(value, torch.Tensor)
                                             and value.requires_grad)):
            out = self._data.clone()
            out[key] = value
            self._data = out
            autograd.stamp(self)
            return
        with torch.no_grad():
            if self._data.is_inference():
                with torch.inference_mode():
                    self._data[key] = value
            else:
                self._data[key] = value

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

    def __mod__(self, o):
        return self._binary(o, "broadcast_mod", "_mod_scalar")

    def __rmod__(self, o):
        return self._binary(o, "broadcast_mod", "_rmod_scalar", rev=True)

    def __pow__(self, o):
        return self._binary(o, "broadcast_power", "_power_scalar")

    def __rpow__(self, o):
        return self._binary(o, "broadcast_power", "_rpower_scalar",
                            rev=True)

    def __neg__(self):
        return invoke("negative", [self], {})

    def __abs__(self):
        return invoke("abs", [self], {})

    def __matmul__(self, o):
        return invoke("dot", [self, o], {})

    def __eq__(self, o):
        return self._binary(o, "broadcast_equal", "_equal_scalar")

    def __ne__(self, o):
        return self._binary(o, "broadcast_not_equal", "_not_equal_scalar")

    def __gt__(self, o):
        return self._binary(o, "broadcast_greater", "_greater_scalar")

    def __ge__(self, o):
        return self._binary(o, "broadcast_greater_equal",
                            "_greater_equal_scalar")

    def __lt__(self, o):
        return self._binary(o, "broadcast_lesser", "_lesser_scalar")

    def __le__(self, o):
        return self._binary(o, "broadcast_lesser_equal",
                            "_lesser_equal_scalar")

    def _inplace(self, res):
        """``x op= y``: under ``record`` the array rebinds to the recorded
        result, as in the JAX package. Outside it, a variable keeps its
        leaf and the result is written into it (the reference's in-place
        update of a weight, ``w -= lr * w.grad``)."""
        from .. import autograd
        t = self._data
        if not autograd.is_recording() and t.requires_grad and t.is_leaf \
                and res._data.shape == t.shape:
            with torch.no_grad():
                t.copy_(res._data)
            return self
        self._data = res._data
        self._gen = res._gen
        return self

    def __iadd__(self, o):
        return self._inplace(self + o)

    def __isub__(self, o):
        return self._inplace(self - o)

    def __imul__(self, o):
        return self._inplace(self * o)

    def __itruediv__(self, o):
        return self._inplace(self / o)


def _make_method(opname):
    def method(self, *args, **kwargs):
        op = _reg.get(opname)
        attrs = dict(kwargs)
        extra, scalars = [], []
        for a in args:
            if isinstance(a, NDArray):
                extra.append(a)
            else:
                scalars.append(a)
        if scalars:
            # x.sum(0), x.clip(0, 1), x.transpose(1, 0): positional
            # non-array arguments bind to the op's attrs in order
            _reg.bind_positional_attrs(op, scalars, attrs,
                                       err_cls=MXNetError)
        return invoke(op, [self] + extra, attrs)

    method.__name__ = opname
    return method


for _m in ("abs", "sign", "square", "sqrt", "rsqrt", "exp", "log", "log1p",
           "tanh", "sigmoid", "relu", "sum", "mean", "prod", "max", "min",
           "norm", "flatten", "transpose", "expand_dims", "clip", "pick",
           "zeros_like", "ones_like", "softmax", "log_softmax", "dot"):
    setattr(NDArray, _m, _make_method(_m))


def invoke(op_name, inputs, attrs, out=None):
    """Imperative op dispatch (MXImperativeInvoke analogue): unwraps
    NDArrays, passes the autograd training flag to ops that take one,
    runs the registered function with gradients enabled exactly while
    recording, wraps the outputs. A range output the op computed on the
    host becomes a 0-d tensor on the inputs' device."""
    from .. import autograd
    op = _reg.get(op_name) if isinstance(op_name, str) else op_name
    attrs = {k: _canon_attr(v) for k, v in attrs.items() if v is not None}
    attrs.pop("num_args", None)
    if "training" in op._kwarg_names and "training" not in attrs:
        attrs["training"] = autograd.is_training()
    recording = autograd.is_recording()
    tensors = [as_tensor(i) for i in inputs if i is not None]
    if recording:
        # autograd refuses to save an inference tensor for backward
        tensors = [t.clone() if t.is_inference() else t for t in tensors]
    device = tensors[0].device if tensors else resolve_device(None)
    with torch.set_grad_enabled(recording):
        raw = op(*tensors, **attrs)
    multi = isinstance(raw, (tuple, list))
    outs = [NDArray(as_tensor(r, device)) for r in (raw if multi else [raw])]
    if recording:
        for o in outs:
            autograd.stamp(o)
    if out is not None:
        targets = out if isinstance(out, (tuple, list)) else [out]
        for t, o in zip(targets, outs):
            t._data = o._data
            t._gen = o._gen
        return out
    return tuple(outs) if multi else outs[0]


def array(source_array, ctx=None, dtype=None):
    """An NDArray from any array-like, on ``ctx`` (the current context
    when None: ``cuda:0`` outside a ``with mx.cpu():`` scope).
    float64 numpy input becomes float32 and int64 int32 unless a dtype
    is given; Python lists default to float32, like the reference."""
    if isinstance(source_array, (NDArray, torch.Tensor)):
        t = as_tensor(source_array).detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()      # exact; the bfloat16 branch below rounds back
            dtype = "bfloat16" if dtype is None else dtype
        data = t.numpy()
    else:
        data = source_array
    if dtype is not None and _reg.torch_dtype(dtype) == torch.bfloat16:
        # numpy has bfloat16 only through ml_dtypes: torch rounds (RNE)
        data = as_tensor(data if _is_bf16(data)
                         else np.asarray(data, np.float32))
        return NDArray(data.to(torch.bfloat16),
                       ctx=ctx if ctx is not None else resolve_device(None))
    if isinstance(data, np.ndarray):
        if dtype is not None:
            data = data.astype(dtype)
        elif data.dtype == np.float64:
            data = data.astype(np.float32)
        elif data.dtype == np.int64:
            data = data.astype(np.int32)
    else:
        data = np.asarray(data, dtype=dtype or np.float32)
    return NDArray(as_tensor(data),
                   ctx=ctx if ctx is not None else resolve_device(None))


def _is_bf16(data):
    return isinstance(data, np.ndarray) and data.dtype.name == "bfloat16"
