"""Imperative autograd (the port of ``mxnet_tpu/autograd.py``) on
``torch.autograd``.

The JAX package records a tape of (op, attrs, inputs, outputs) while
``record()`` is on and, at ``backward``, replays the reachable part as
one function under ``jax.vjp``. Here torch records the same graph as the
ops run: ``nd`` dispatch runs each op with gradients enabled exactly
while recording (``ndarray.invoke``), and an array with a gradient
attached holds a leaf tensor that requires grad. ``backward`` and
``grad`` take ``torch.autograd.grad`` of the heads with respect to the
marked leaves and write the result by each array's ``grad_req``:
``"write"`` replaces ``.grad``, ``"add"`` accumulates into it, ``"null"``
leaves it alone. ``.grad`` of the torch tensors is never used: torch
would always accumulate.

Freeing follows the JAX tape, not torch: a ``backward`` (or ``grad``)
without ``retain_graph`` clears the JAX package's whole tape, so any
head recorded before it can no longer be differentiated. Each recorded
output carries the tape generation it was made in; a backward without
``retain_graph`` starts a new generation, and a head of an older one
raises :class:`MXNetError`, as in the JAX package.
"""
from __future__ import annotations

import threading
import weakref

import torch

from .base import MXNetError

_state = threading.local()
# arrays with a gradient attached, by id: their leaves are what
# backward differentiates against
_marked = {}


def _st():
    if not hasattr(_state, "recording"):
        _state.recording = False
        _state.train_mode = False
        _state.generation = 0
    return _state


def is_recording():
    return _st().recording


def is_training():
    return _st().train_mode


def set_recording(is_record):
    """Set the recording flag; returns the previous value."""
    st = _st()
    prev = st.recording
    st.recording = bool(is_record)
    return prev


def set_training(train_mode):
    """Set the training-mode flag; returns the previous value."""
    st = _st()
    prev = st.train_mode
    st.train_mode = bool(train_mode)
    return prev


class _RecordingStateScope:
    """Scope that sets either flag (None leaves it alone) and restores
    both on exit."""

    def __init__(self, is_record, train_mode):
        self._is_record = is_record
        self._train_mode = train_mode
        self._prev = None
        self._prev_train = None

    def __enter__(self):
        if self._is_record is not None:
            self._prev = set_recording(self._is_record)
        if self._train_mode is not None:
            self._prev_train = set_training(self._train_mode)
        return self

    def __exit__(self, *exc):
        if self._is_record is not None:
            set_recording(self._prev)
        if self._train_mode is not None:
            set_training(self._prev_train)
        return False


def record(train_mode=True):
    """Scope: operations are recorded (training mode by default)."""
    return _RecordingStateScope(True, train_mode)


def pause(train_mode=False):
    """Scope: recording off (predict mode by default)."""
    return _RecordingStateScope(False, train_mode)


def train_mode():
    return _RecordingStateScope(None, True)


def predict_mode():
    return _RecordingStateScope(None, False)


# -- marking -----------------------------------------------------------------
def _leaf(t):
    """``t`` as a fresh leaf that requires grad (floating point only),
    sharing its storage; an inference tensor is copied out first."""
    if t.is_inference():
        with torch.inference_mode(False):
            t = t.clone()
    t = t.detach()
    return t.requires_grad_(True) if t.is_floating_point() else t


def _mark(nd):
    """Make ``nd`` a variable: its tensor a leaf that requires grad."""
    nd._data = _leaf(nd._data)
    key = id(nd)
    _marked[key] = weakref.ref(nd, lambda _, k=key: _marked.pop(k, None))


def stamp(nd):
    """Note that ``nd`` was recorded in the current tape generation (an
    output that requires grad); returns ``nd``."""
    if nd._data.requires_grad:
        nd._gen = _st().generation
    return nd


def mark_variables(variables, gradients=None, grad_reqs="write"):
    """Mark arrays as variables with the given gradient buffers and
    ``grad_req`` (ref: autograd.py mark_variables)."""
    if gradients is None:
        gradients = [None] * len(variables)
    if isinstance(grad_reqs, str):
        grad_reqs = [grad_reqs] * len(variables)
    for v, g, req in zip(variables, gradients, grad_reqs):
        v.grad = g
        v._grad_req = req
        _mark(v)


# -- backward ----------------------------------------------------------------
def _heads(heads):
    gen = _st().generation
    out = []
    for h in heads:
        t = h._data
        if not t.requires_grad:
            raise MXNetError(
                "cannot differentiate: output is not part of a recorded "
                "computational graph (did you forget autograd.record()?)")
        if t.grad_fn is not None and h._gen is not None and h._gen != gen:
            raise MXNetError(
                "cannot differentiate: the computational graph has already "
                "been freed (backward was called before); pass "
                "retain_graph=True to keep it")
        out.append(t)
    return out


def _head_grads(heads, tensors, head_grads):
    if head_grads is None:
        head_grads = [None] * len(heads)
    return [torch.ones_like(t) if g is None else
            g._data.to(t.device) for t, g in zip(tensors, head_grads)]


def _release(retain_graph):
    if not retain_graph:
        _st().generation += 1


def backward(heads, head_grads=None, retain_graph=False, train_mode=True):
    """Gradients of ``heads`` with respect to every marked array in their
    graph, into each array's ``.grad`` by its ``grad_req`` (ref:
    MXAutogradBackwardEx)."""
    from .ndarray.ndarray import NDArray

    tensors = _heads(heads)
    grads_out = _head_grads(heads, tensors, head_grads)
    variables = []
    for ref in list(_marked.values()):
        nd = ref()
        if nd is not None and nd._grad_req != "null" \
                and nd._data.requires_grad and nd._data.is_leaf:
            variables.append(nd)
    grads = [None] * len(variables)
    if variables:
        grads = torch.autograd.grad(
            tensors, [v._data for v in variables], grad_outputs=grads_out,
            retain_graph=retain_graph, allow_unused=True)
    _release(retain_graph)
    found = False
    with torch.no_grad():
        for nd, g in zip(variables, grads):
            if g is None:
                continue
            found = True
            if nd._grad_req == "add" and nd.grad is not None:
                nd.grad._data = nd.grad._data + g
            elif nd.grad is None:
                nd.grad = NDArray(g)
            else:
                nd.grad._data = g
    if not found:
        raise MXNetError("no variables with grad attached found in the graph")


def grad(heads, variables, head_grads=None, retain_graph=None,
         create_graph=False, train_mode=True):
    """Gradients of ``heads`` with respect to ``variables``, returned as
    new arrays (ref: autograd.py grad); with ``create_graph`` they are
    recorded, for a second order."""
    from .ndarray.ndarray import NDArray

    if retain_graph is None:
        retain_graph = create_graph
    tensors = _heads(heads)
    grads_out = _head_grads(heads, tensors, head_grads)
    for v in variables:
        if not v._data.requires_grad:
            raise MXNetError("one of the requested variables does not "
                             "contribute to the heads")
    grads = torch.autograd.grad(
        tensors, [v._data for v in variables], grad_outputs=grads_out,
        retain_graph=retain_graph, create_graph=create_graph,
        allow_unused=True)
    _release(retain_graph)
    if any(g is None for g in grads):
        raise MXNetError("one of the requested variables does not "
                         "contribute to the heads")
    return [stamp(NDArray(g)) for g in grads]


def get_symbol(x):
    raise MXNetError("get_symbol is not supported; use HybridBlock.export")


class _Bridge(torch.autograd.Function):
    """A user :class:`Function` as a torch autograd node. As in the JAX
    package, the backward runs the user's ``forward`` again on the saved
    inputs first, so ``saved_tensors`` are this call's even when the
    object was called again since."""

    @staticmethod
    def forward(ctx, func, *datas):
        from .ndarray.ndarray import NDArray

        ctx.func = func
        ctx.save_for_backward(*datas)
        with pause():
            outs = func.forward(*[NDArray(d) for d in datas])
        ctx.multi = isinstance(outs, (tuple, list))
        outs = list(outs) if ctx.multi else [outs]
        return tuple(o._data for o in outs)

    @staticmethod
    def backward(ctx, *gs):
        from .ndarray.ndarray import NDArray

        datas = ctx.saved_tensors
        with pause():
            ctx.func.forward(*[NDArray(d) for d in datas])
            grads = ctx.func.backward(*[NDArray(g) for g in gs])
        grads = list(grads) if isinstance(grads, (tuple, list)) else [grads]
        return (None,) + tuple(g._data for g in grads)


class Function:
    """Custom differentiable function (ref: autograd.py Function):
    subclass it and implement ``forward(self, *inputs)`` and
    ``backward(self, *output_grads)`` on NDArrays."""

    def __init__(self):
        self._saved = ()

    def save_for_backward(self, *arrays):
        self._saved = arrays

    @property
    def saved_tensors(self):
        return self._saved

    def __call__(self, *inputs):
        from .ndarray.ndarray import NDArray, as_tensor

        recording = is_recording()
        datas = [as_tensor(i) for i in inputs]
        if recording:
            datas = [d.clone() if d.is_inference() else d for d in datas]
        with torch.set_grad_enabled(recording):
            raw = _Bridge.apply(self, *datas)
        outs = [stamp(NDArray(r)) for r in raw]
        return outs if len(outs) > 1 else outs[0]
