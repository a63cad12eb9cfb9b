"""Graph executor (the port of ``mxnet_tpu/executor.py``): a Symbol bound
to arrays on one device, run op by op in topological order.

The JAX package lowers the whole graph into one XLA program; XLA then
folds every scalar it can compute before the run. The port keeps that
folding where it changes numbers: range scalars that follow from
constants (calibrated quantization ranges) stay host ``numpy.float32``
values between ops (see ``ops/quantized.py``) and become tensors only
where they leave the graph.

Inference (``forward(is_train=False)``) runs under
``torch.inference_mode()``. Training (``forward(is_train=True)``) runs
the same walk with autograd recording, from fresh leaves that alias the
arguments whose ``grad_req`` is not ``"null"``; BatchNorm normalises
over the batch and the executor folds the batch statistics into the
moving ones, as the JAX executor's ``_bn_train`` does. ``backward``
takes ``torch.autograd.grad`` of the recorded outputs (the JAX executor
takes ``jax.vjp`` of the same function). The recorded graph is kept
until the next ``forward``, so a second ``backward`` after one forward
gives what the JAX executor gives by recomputing from its saved state:
``"add"`` accumulates again, ``"write"`` writes the same gradient.
"""
from __future__ import annotations

import collections
import contextlib

import torch

from .base import MXNetError, attr_bool
from .context import resolve_device
from .ndarray.ndarray import NDArray, as_tensor
from .ops import registry as _reg
from .ops.nn import batch_moments
from .symbol.symbol import op_attrs


def _bn_train(node, ins, attrs, aux_updates):
    """Training-mode BatchNorm; the moving statistics of its variable
    inputs become ``momentum * moving + (1 - momentum) * batch`` (the
    biased batch variance), collected in ``aux_updates``."""
    want_stats = attr_bool(attrs.get("output_mean_var"))
    res = _reg.get(node.op).fn(*ins, **{**attrs, "training": True,
                                        "output_mean_var": want_stats})
    momentum = float(attrs.get("momentum", 0.9))
    with torch.no_grad():
        stats = (res[1:] if want_stats
                 else batch_moments(ins[0], attrs.get("axis", 1)))
        for (child, _), moving, batch in zip(node.inputs[3:5], ins[3:5],
                                             stats):
            if child.op is None:
                aux_updates[child.name] = (momentum * moving
                                           + (1 - momentum) * batch)
    return res


def _run(symbol, values, training):
    """(outputs, moving-statistic updates) of ``symbol`` with variable
    values by name (tensors)."""
    order = symbol._topo()
    # an intermediate is dropped after its last consumer, so a forward
    # holds only the live activations (and, training, what autograd
    # saved), as a planned graph would
    uses = collections.Counter((id(c), k) for node in order
                               for c, k in node.inputs)
    uses.update((id(n), k) for n, k in symbol._outputs)
    env = {}  # keyed by node identity: names may collide
    aux_updates = {}
    mode = contextlib.nullcontext() if training else torch.inference_mode()
    with mode:
        for node in order:
            if node.op is None:
                try:
                    env[(id(node), 0)] = values[node.name]
                except KeyError:
                    raise MXNetError(f"no value bound for variable "
                                     f"{node.name}") from None
                continue
            ins = [env[(id(c), k)] for c, k in node.inputs]
            attrs = op_attrs(node)
            opdef = _reg.get(node.op)
            if "training" in opdef._kwarg_names and "training" not in attrs:
                attrs["training"] = training
            if training and node.op == "BatchNorm" \
                    and not attr_bool(attrs.get("use_global_stats")):
                out = _bn_train(node, ins, attrs, aux_updates)
            else:
                out = opdef.fn(*ins, **attrs)
            del ins
            for c, k in node.inputs:
                uses[(id(c), k)] -= 1
                if not uses[(id(c), k)]:
                    del env[(id(c), k)]
            outs = out if isinstance(out, (tuple, list)) else [out]
            for k, o in enumerate(outs):
                if uses[(id(node), k)]:
                    env[(id(node), k)] = o
    return [env[(id(n), k)] for n, k in symbol._outputs], aux_updates


def run_graph(symbol, values):
    """Evaluate ``symbol`` for inference with variable values by name
    (tensors); returns its outputs (tensors, or host scalars for ranges
    the graph fixes before the run)."""
    return _run(symbol, values, training=False)[0]


class Executor:
    """Bound computation (ref: python/mxnet/executor.py Executor)."""

    def __init__(self, symbol, ctx=None, args=None, args_grad=None,
                 grad_req="write", aux_states=None):
        self._symbol = symbol
        self._device = resolve_device(ctx)
        self.arg_names = symbol.list_arguments()
        self.aux_names = symbol.list_auxiliary_states()
        self.output_names = symbol.list_outputs()
        dup = {n for n in self.arg_names if self.arg_names.count(n) > 1}
        if dup:
            raise MXNetError(
                f"duplicate argument names in graph: {sorted(dup)}; give "
                "each variable a unique name")
        self.arg_dict = self._canon(args, self.arg_names, "args")
        self.aux_dict = self._canon(aux_states, self.aux_names,
                                    "aux_states", allow_missing=True)
        if isinstance(grad_req, str):
            self._grad_req = {n: grad_req for n in self.arg_names}
        else:
            self._grad_req = {n: grad_req.get(n, "null")
                              for n in self.arg_names}
        bad = set(self._grad_req.values()) - {"null", "write", "add"}
        if bad:
            raise MXNetError(f"grad_req must be null, write or add, got "
                             f"{sorted(bad)}")
        if args_grad is not None:
            self.grad_dict = self._canon(args_grad, self.arg_names,
                                         "args_grad", allow_missing=True)
        else:
            self.grad_dict = {
                n: NDArray(torch.zeros_like(self.arg_dict[n]._data))
                for n in self.arg_names if self._grad_req[n] != "null"}
        self.outputs = []
        # (outputs with graph, leaves) of the last training forward,
        # until the next forward
        self._recorded = None

    def _canon(self, arrays, names, what, allow_missing=False):
        arrays = arrays or {}
        if isinstance(arrays, (list, tuple)):
            if len(arrays) != len(names):
                raise MXNetError(f"{what}: expected {len(names)} arrays, "
                                 f"got {len(arrays)}")
            arrays = dict(zip(names, arrays))
        out = {}
        for n in names:
            if n not in arrays:
                if allow_missing:
                    continue
                raise MXNetError(f"{what}: missing array for {n}")
            out[n] = NDArray(as_tensor(arrays[n], self._device).detach())
        return out

    def forward(self, is_train=False, **kwargs):
        """Run the graph; ``kwargs`` rebind arguments by name first.
        ``is_train=True`` records it for :meth:`backward` and updates the
        BatchNorm moving statistics in ``aux_dict``."""
        for n, v in kwargs.items():
            if n not in self.arg_dict:
                raise MXNetError(f"unknown argument {n}")
            self.arg_dict[n]._data = as_tensor(v, self._device)
        self._recorded = None
        values = {n: a._data for n, a in self.arg_dict.items()}
        values.update({n: a._data for n, a in self.aux_dict.items()})
        if not is_train:
            self.outputs = [NDArray(as_tensor(o, self._device))
                            for o in run_graph(self._symbol, values)]
            return self.outputs
        leaves = {}
        for n, req in self._grad_req.items():
            t = values[n]
            if req == "null" or not t.is_floating_point():
                continue
            if t.is_inference():    # an inference forward's output
                t = t.clone()
            leaves[n] = values[n] = t.detach().requires_grad_(True)
        outs, aux_updates = _run(self._symbol, values, training=True)
        for n, v in aux_updates.items():
            self.aux_dict[n]._data = v
        self._recorded = (outs, leaves)
        self.outputs = [NDArray(as_tensor(o, self._device).detach())
                        for o in outs]
        return self.outputs

    def backward(self, out_grads=None):
        """Gradients of the recorded forward wrt every argument whose
        ``grad_req`` is not ``"null"``, into ``grad_dict``: ``"write"``
        replaces, ``"add"`` accumulates. ``out_grads`` are the head
        gradients (ones when None; SoftmaxOutput ignores its own)."""
        if self._recorded is None:
            raise MXNetError("backward called before forward(is_train=True)")
        outs, leaves = self._recorded
        if out_grads is None:
            heads = [torch.ones_like(o) if isinstance(o, torch.Tensor)
                     else None for o in outs]
        else:
            if isinstance(out_grads, NDArray):
                out_grads = [out_grads]
            heads = [as_tensor(g, self._device) for g in out_grads]
        pairs = [(o, h) for o, h in zip(outs, heads)
                 if isinstance(o, torch.Tensor) and o.requires_grad]
        names = list(leaves)
        grads = [None] * len(names)
        if pairs and names:
            grads = torch.autograd.grad(
                [o for o, _ in pairs], [leaves[n] for n in names],
                grad_outputs=[h for _, h in pairs], allow_unused=True,
                retain_graph=True)
        del outs, pairs
        for n, g in zip(names, grads):
            g = torch.zeros_like(leaves[n]) if g is None else g.contiguous()
            dst = self.grad_dict.get(n)
            if dst is None:
                self.grad_dict[n] = NDArray(g)
            elif self._grad_req[n] == "add":
                dst._data = dst._data + g
            else:
                dst._data = g

    @property
    def grad_arrays(self):
        return [self.grad_dict.get(n) for n in self.arg_names]

    @property
    def arg_arrays(self):
        return [self.arg_dict[n] for n in self.arg_names]

    @property
    def aux_arrays(self):
        return [self.aux_dict[n] for n in self.aux_names]

    def copy_params_from(self, arg_params, aux_params=None,
                         allow_extra_params=False):
        """Rebind arguments / auxiliary states to copies of the given
        arrays on this executor's device (their dtype is kept, as the JAX
        executor keeps it). Copies: training updates the bound arrays in
        place, and the caller's arrays stay as they were, as the JAX
        package's immutable ones do."""
        for params, target, what in ((arg_params, self.arg_dict, "arg"),
                                     (aux_params or {}, self.aux_dict,
                                      "aux")):
            for n, v in params.items():
                if n in target:
                    target[n]._data = as_tensor(v).detach().to(
                        self._device, copy=True)
                elif not allow_extra_params:
                    raise MXNetError(f"unknown {what} {n}")
