"""The port's program representation: the torch ops one call
dispatches, in order, each priced the way :mod:`.hlo` prices its HLO
counterpart.

The JAX package prices the optimized HLO of a compiled program. The
port has no compiler: its program is the sequence of aten ops a call
dispatches eagerly. :func:`record` runs a callable once under a
``TorchDispatchMode`` and keeps, for each op, its name, the bytes of its
operands and outputs, their storages (for liveness), the framework op
scopes it ran under, and its FLOPs:

- products (``mm``, ``addmm``, ``bmm``, ``baddbmm``, ``_int_mm``,
  ``convolution``, ``convolution_backward``) at 2 x multiply-adds,
- elementwise ops at one flop an output element, reductions (and the
  normalizations and pools) at one an input element,
- data movement (copies, concatenations, gathers, fills) at 0,
- views: no row (they move nothing).

Bytes are each op's own operands plus outputs: eager torch has no
fusion, so a step's bytes exceed the JAX ledger's fused bytes.

**The hand kernels** (K1-K4, loaded through ctypes) are invisible to the
dispatcher, and on the CPU their plain versions split into many aten
ops. Each wrapper goes through :func:`priced_call` when :func:`pricing`
says so: while a recorder is active the call is one row with the
function's own count (each source's header), and none of the ops inside
it is priced, on either device. A
differentiable kernel's backward is one row too, whether autograd runs
the plain version's graph (CPU) or the kernel's ``autograd.Function``.

**Scopes.** A framework op scope (``<op>#<k>``: the k-th call of that op
since the step began; ``<op>#<k>.bwd`` for its gradient) exists while a
recorder or a capture is active: the registry's eager dispatch and every
executor node open one (:func:`scoped`), and the autograd nodes created
inside it carry it into the backward on whichever thread autograd runs
them (a node pre-hook pushes it, a node hook pops it). Under a capture
each scope is also a ``record_function`` range named ``mx.<scope>`` (a
hand kernel's region ``mx:<kernel>``), which :mod:`.xplane` reads. With
neither active the hot path pays one list read.
"""
from __future__ import annotations

import functools
import math
import threading

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ..telemetry import step as _tstep

#: recorders plus captures active; the seams read ``ACTIVE[0]``
ACTIVE = [0]
_CAPTURE = [0]
_RECORDER = [None]
_lock = threading.Lock()
_calls = {}           # op name -> calls since the step began
_tls = threading.local()

# (inference mode dispatches composite ops, conv2d and matmul among
# them, to the recorder before they decompose)
_PRODUCTS = {"mm", "addmm", "bmm", "baddbmm", "_int_mm", "mv", "addmv",
             "dot", "matmul", "linear", "convolution", "conv1d", "conv2d",
             "conv3d", "conv_transpose1d", "conv_transpose2d",
             "conv_transpose3d", "convolution_backward"}
_REDUCTIONS = {
    "sum", "mean", "amax", "amin", "max", "min", "prod", "var", "std",
    "var_mean", "std_mean", "norm", "linalg_vector_norm", "logsumexp",
    "argmax", "argmin", "all", "any", "cumsum", "cumprod", "count_nonzero",
    "topk", "sort", "_log_softmax", "_softmax", "_log_softmax_backward_data",
    "_softmax_backward_data", "nll_loss_forward", "nll_loss_backward",
    "native_layer_norm", "native_layer_norm_backward", "native_batch_norm",
    "_native_batch_norm_legit", "_native_batch_norm_legit_no_training",
    "native_batch_norm_backward", "cudnn_batch_norm",
    "cudnn_batch_norm_backward", "max_pool2d_with_indices",
    "max_pool2d_with_indices_backward", "avg_pool2d", "avg_pool2d_backward",
    "_adaptive_avg_pool2d", "_adaptive_avg_pool2d_backward",
    "embedding_dense_backward", "max_pool1d", "max_pool2d", "max_pool3d",
    "adaptive_avg_pool2d", "adaptive_max_pool2d", "layer_norm",
    "batch_norm", "group_norm", "instance_norm", "softmax", "log_softmax",
    "cross_entropy_loss", "nll_loss", "nll_loss_nd"}
_MOVEMENT = {
    "copy_", "_to_copy", "clone", "cat", "stack", "index_select", "index",
    "gather", "embedding", "constant_pad_nd", "select_scatter",
    "slice_scatter", "as_strided_scatter", "repeat", "empty", "empty_like",
    "empty_strided", "zeros", "zeros_like", "ones", "ones_like", "full",
    "full_like", "new_zeros", "new_ones", "new_empty", "new_full",
    "new_empty_strided", "zero_", "fill_", "fill", "scalar_tensor",
    "arange", "lift_fresh", "lift_fresh_copy", "_pin_memory", "flip",
    "roll", "_local_scalar_dense", "set_", "resize_", "index_put_",
    "index_put", "scatter", "scatter_", "_foreach_copy_", "_unsafe_view",
    "pad", "reshape", "flatten", "contiguous", "to", "type_as",
    "one_hot"}


def _boundary():
    if ACTIVE[0]:
        step_reset()


_tstep._on_boundary.append(_boundary)


def step_reset():
    """Start the scope instance counts over (``<op>#0`` again): at every
    step boundary while a recorder or capture is active."""
    with _lock:
        _calls.clear()


def _stack():
    s = getattr(_tls, "stack", None)
    if s is None:
        s = _tls.stack = []
    return s


def _suppress():
    return getattr(_tls, "suppress", 0)


def current_scope():
    """The innermost scope instance on this thread, or None."""
    s = getattr(_tls, "stack", None)
    return s[-1] if s else None


def _instance(name):
    with _lock:
        k = _calls.get(name, 0)
        _calls[name] = k + 1
    return f"{name}#{k}"


def _rf_enter(name):
    return torch.ops.profiler._record_function_enter_new(name, None)


def _rf_exit(handle):
    torch.ops.profiler._record_function_exit._RecordFunction(handle)


def _tensors(x):
    """The tensors of a (nested) tuple / list / dict of values."""
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)


def _grad_fns(out):
    return [t.grad_fn for t in _tensors(out) if t.grad_fn is not None]


def _tag_backward(out, lo, tag):
    """Tag the autograd nodes this thread created since sequence number
    ``lo`` that ``out`` reaches: each runs its backward under ``tag``'s
    scope. A node an inner scope tagged keeps that tag. ``tag``'s
    ``emit`` (a backward kernel row) goes to the first output's node."""
    hi = torch._C._autograd._get_sequence_nr()
    if hi <= lo:
        return
    roots = _grad_fns(out)
    todo = list(roots)
    # id -> node: holding each visited node's Python object keeps its id
    # from being reused by the next node's
    seen = {}
    emit = tag.get("emit")
    while todo:
        n = todo.pop()
        if n is None or id(n) in seen:
            continue
        seen[id(n)] = n
        try:
            s = n._sequence_nr()
        except (AttributeError, RuntimeError):
            continue
        if not lo <= s < hi:
            continue
        todo.extend(f for f, _ in n.next_functions)
        md = n.metadata
        if "mx_scope" in md:
            continue
        mine = dict(tag, emit=emit if roots and n is roots[0] else None)
        md["mx_scope"] = mine
        n.register_prehook(functools.partial(_bwd_enter, mine))
        n.register_hook(functools.partial(_bwd_exit, mine))


def _bwd_enter(tag, grad_outputs):
    st = _stack()
    st.append(tag["scope"])
    handles = []
    if _CAPTURE[0]:
        if tag["scope"] is not None:
            handles.append(_rf_enter("mx." + tag["scope"]))
        if tag.get("kernel"):
            handles.append(_rf_enter("mx:" + tag["kernel"]))
    if tag.get("kernel"):
        _tls.suppress = _suppress() + 1
    emit = tag.get("emit")
    rec = _RECORDER[0]
    if emit is not None and rec is not None:
        rec.kernel_row(tag["kernel"], emit["flops"], emit["bytes"],
                       list(emit["ins"]) + list(_tensors(grad_outputs)),
                       (), backward=True)
        _tls.region_row = len(rec.entries) - 1
    hs = getattr(_tls, "rf", None)
    if hs is None:
        hs = _tls.rf = []
    hs.append(handles)


def _bwd_exit(tag, grad_inputs, grad_outputs):
    st = _stack()
    if st:
        st.pop()
    if tag.get("kernel"):
        _tls.suppress = max(_suppress() - 1, 0)
    hs = getattr(_tls, "rf", None)
    for h in reversed(hs.pop() if hs else ()):
        _rf_exit(h)


def scoped(name, fn, args, kwargs):
    """``fn(*args, **kwargs)`` in the framework op scope ``name`` (the
    module docstring's ``<op>#<k>``); the autograd nodes the call creates
    run their backward under ``<op>#<k>.bwd``."""
    inst = _instance(name)
    st = _stack()
    st.append(inst)
    rf = _rf_enter("mx." + inst) if _CAPTURE[0] else None
    lo = torch._C._autograd._get_sequence_nr()
    try:
        out = fn(*args, **kwargs)
    finally:
        st.pop()
        if rf is not None:
            _rf_exit(rf)
    if torch.is_grad_enabled():
        _tag_backward(out, lo, {"scope": inst + ".bwd"})
    return out


def pricing():
    """Whether a hand kernel's wrapper prices this call: a recorder or
    capture is active and no priced call encloses this one. Each wrapper
    reads ``ACTIVE[0]`` before it calls this, so with nothing active a
    launch pays one list read."""
    return bool(ACTIVE[0]) and not _suppress()


def priced_call(kernel, cost, fn, args, backward=None):
    """``fn(*args)`` (a hand kernel's wrapper, re-entered) as one row
    ``kernel`` with ``cost(*args)`` -> (flops, bytes) and no row for what
    runs inside it; ``backward`` = (name, cost) prices its gradient the
    same way, from the forward's arguments."""
    return _priced_call(kernel, cost, backward, fn, args, {})


def _priced_call(kernel, cost, backward, fn, args, kwargs):
    rec = _RECORDER[0]
    flops, nbytes = cost(*args, **kwargs) if rec is not None else (0, 0)
    handle = _rf_enter("mx:" + kernel) if _CAPTURE[0] else None
    lo = torch._C._autograd._get_sequence_nr()
    if rec is not None:
        _tls.region_row = len(rec.entries)
    _tls.suppress = _suppress() + 1
    try:
        out = fn(*args, **kwargs)
    finally:
        _tls.suppress -= 1
        if handle is not None:
            _rf_exit(handle)
    ins = list(_tensors((args, kwargs)))
    if rec is not None:
        rec.kernel_row(kernel, flops, nbytes, ins, list(_tensors(out)))
    if backward is not None and torch.is_grad_enabled():
        emit = None
        if rec is not None:
            bf, bb = backward[1](*args, **kwargs)
            emit = {"flops": bf, "bytes": bb,
                    "ins": ins + list(_tensors(out))}
        sc = current_scope()
        _tag_backward(out, lo, {
            "scope": None if sc is None else sc + ".bwd",
            "kernel": backward[0], "emit": emit})
    return out


# ---------------------------------------------------------------------------
# the recorder
# ---------------------------------------------------------------------------

def _nbytes(t):
    return t.numel() * t.element_size()


def _key(t):
    try:
        st = t.untyped_storage()
        return st._cdata, st.nbytes()
    except (RuntimeError, NotImplementedError, TypeError):
        return None, 0


def _elems(ts):
    return sum(t.numel() for t in ts)


def op_flops(name, func_tags, args, ins, outs):
    """FLOPs of one aten op (see the module docstring)."""
    if name in _PRODUCTS:
        return _product_flops(name, args, outs)
    if name.startswith("_foreach_"):
        if "copy" in name or "zero" in name:
            return 0
        return _elems(ins) if "norm" in name else _elems(
            _tensors(args[0]) if args else ())
    if name in _MOVEMENT:
        return 0
    if name in _REDUCTIONS:
        return _elems(ins)
    if torch.Tag.pointwise in func_tags:
        return _elems(outs) or _elems(ins[:1])
    return _elems(outs)


def _product_flops(name, args, outs):
    """2 x multiply-adds of a product; an addmm-style bias add at one
    flop an output element."""
    out = outs[0].numel() if outs else 0
    if name in ("mm", "_int_mm", "bmm", "matmul", "mv", "dot"):
        a = args[0]
        return 2 * max(out, 1) * a.shape[-1]
    if name in ("addmm", "baddbmm", "addmv"):
        return 2 * out * args[1].shape[-1] + out
    if name == "linear":
        bias = len(args) > 2 and args[2] is not None
        return 2 * out * args[0].shape[-1] + (out if bias else 0)
    if name == "convolution_backward":
        gy, x, w = args[0], args[1], args[2]
        mask = args[10] if len(args) > 10 else (True, True, True)
        ksp = math.prod(w.shape[2:])
        transposed = bool(args[7]) if len(args) > 7 else False
        macs = (x.numel() if transposed else gy.numel()) * w.shape[1] * ksp
        return 2 * macs * (int(bool(mask[0])) + int(bool(mask[1]))) + (
            gy.numel() if mask[2] else 0)
    # the convolutions: 2 x output elements x (input channels / groups)
    # x kernel size; a transposed one's MACs run over its input
    x, w = args[0], args[1]
    ksp = math.prod(w.shape[2:])
    transposed = name.startswith("conv_transpose") or (
        name == "convolution" and len(args) > 6 and bool(args[6]))
    return 2 * (x.numel() if transposed else out) * w.shape[1] * ksp


class Trace:
    """One call's recorded program: ``entries`` (each a dict with
    ``name`` (the aten op or hand kernel), ``kernel`` (bool),
    ``scopes`` (the scope stack), ``flops``, ``bytes``, ``ins`` /
    ``outs`` (buffer indices)), ``buffers`` (each ``bytes``, ``def``,
    ``last``, ``arg``, ``out``), and ``device`` ("cuda" when any op ran
    on a card)."""

    def __init__(self, module="optrace"):
        self.module = module
        self.entries = []
        self.buffers = []
        self.device = "cpu"
        self._live = {}
        self._pending = {}

    def _new(self, key, nbytes, idx, arg=False):
        self.buffers.append({"bytes": nbytes, "def": idx, "last": idx,
                             "arg": arg, "out": False})
        b = len(self.buffers) - 1
        if key is not None:
            self._live[key] = b
        return b

    def _use(self, t, idx):
        key, nbytes = _key(t)
        b = self._live.get(key)
        if b is None:
            p = self._pending.pop(key, None)
            b = self._new(key, nbytes, 0, arg=True) if p is None \
                else self._new(key, p[1], p[0])
        if idx > self.buffers[b]["last"]:
            self.buffers[b]["last"] = idx
        return b

    def _define(self, t, idx, in_keys):
        key, nbytes = _key(t)
        if key in in_keys:      # written in place
            return self._live.get(key)
        p = self._pending.pop(key, None)
        return self._new(key, nbytes, idx if p is None else p[0])

    def _note_device(self, ts):
        if self.device != "cuda" and any(t.is_cuda for t in ts):
            self.device = "cuda"

    def op(self, func, args, kwargs, out):
        """One dispatched aten op."""
        ins = list(_tensors((args, kwargs)))
        outs = list(_tensors(out))
        if not ins and not outs:
            return      # a scalar query (promote_types, ...)
        self._note_device(ins or outs)
        if _suppress():
            # inside a priced kernel: no row; its outputs are born at the
            # kernel's row if anything outside the kernel reads them
            row = getattr(_tls, "region_row", len(self.entries))
            in_keys = set()
            for t in ins:
                key, _ = _key(t)
                in_keys.add(key)
                b = self._live.get(key)
                if b is not None and row > self.buffers[b]["last"]:
                    self.buffers[b]["last"] = row
            for t in outs:
                key, nbytes = _key(t)
                if key not in in_keys and key not in self._live:
                    self._pending[key] = (row, nbytes)
            return
        name = func.overloadpacket.__name__
        in_keys = {_key(t)[0] for t in ins}
        mutable = func._schema.is_mutable
        if func.is_view or (outs and not mutable and all(
                _key(t)[0] in in_keys for t in outs)):
            return      # a view: no data moves
        idx = len(self.entries)
        nbytes = sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in outs)
        if out is None and mutable and args:
            nbytes += sum(_nbytes(t) for t in _tensors(args[0]))
        self.entries.append({
            "name": name, "kernel": False,
            "scopes": tuple(_stack()),
            "flops": int(op_flops(name, func.tags, args, ins, outs)),
            "bytes": int(nbytes),
            "ins": [self._use(t, idx) for t in ins],
            "outs": [self._define(t, idx, in_keys) for t in outs]})

    def kernel_row(self, kernel, flops, nbytes, ins, outs, backward=False):
        """One hand-kernel call (or its backward) as one row."""
        self._note_device(list(ins) + list(outs))
        idx = len(self.entries)
        in_keys = {_key(t)[0] for t in ins}
        self.entries.append({
            "name": kernel, "kernel": True, "scopes": tuple(_stack()),
            "flops": int(flops), "bytes": int(nbytes),
            "ins": [self._use(t, idx) for t in ins],
            "outs": [self._define(t, idx, in_keys) for t in outs]})
        if backward:
            self.entries[-1]["backward"] = True

    def finish(self, out):
        """Mark the call's outputs live to the end."""
        end = max(len(self.entries) - 1, 0)
        for t in _tensors(out):
            key, _ = _key(t)
            b = self._live.get(key)
            if b is None:
                p = self._pending.pop(key, None)
                if p is None:
                    continue
                b = self._new(key, p[1], p[0])
            self.buffers[b]["out"] = True
            self.buffers[b]["last"] = end
        self._live = self._pending = None


class _Mode(TorchDispatchMode):
    def __init__(self, trace):
        super().__init__()
        self.trace = trace

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.trace.op(func, args, kwargs, out)
        return out


def record(fn, *args, module=None, **kwargs):
    """Run ``fn(*args, **kwargs)`` once and return ``(trace, result)``:
    the :class:`Trace` of the ops it dispatched (backward included, on
    any thread autograd ran it), with scopes on."""
    trace = Trace(module or getattr(fn, "__name__", "optrace"))
    with _lock:
        if _RECORDER[0] is not None:
            raise RuntimeError("an op trace is already recording")
        _RECORDER[0] = trace
        ACTIVE[0] += 1
    step_reset()
    try:
        with _Mode(trace):
            out = fn(*args, **kwargs)
    finally:
        with _lock:
            _RECORDER[0] = None
            ACTIVE[0] -= 1
    trace.finish(out)
    return trace, out


class capturing:
    """Scopes on, as ``record_function`` ranges, for a torch.profiler
    capture (:mod:`.capture`, ``profiler.set_config(xla_trace_dir=)``)."""

    def __enter__(self):
        with _lock:
            ACTIVE[0] += 1
            _CAPTURE[0] += 1
        step_reset()
        return self

    def __exit__(self, *exc):
        with _lock:
            ACTIVE[0] -= 1
            _CAPTURE[0] -= 1
        return False
