"""Graph executor (the port of ``mxnet_tpu/executor.py``): a Symbol bound
to arrays on one device, run op by op in topological order under
``torch.inference_mode()``.

The JAX package lowers the whole graph into one XLA program; XLA then
folds every scalar it can compute before the run. The port keeps that
folding where it changes numbers: range scalars that follow from
constants (calibrated quantization ranges) stay host ``numpy.float32``
values between ops (see ``ops/quantized.py``) and become tensors only
where they leave the graph. This executor runs inference only:
``backward`` and training-mode BatchNorm arrive with the training slice.
"""
from __future__ import annotations

import collections

import torch

from .base import MXNetError
from .context import resolve_device
from .ndarray.ndarray import NDArray, as_tensor
from .ops import registry as _reg
from .symbol.symbol import op_attrs


def run_graph(symbol, values):
    """Evaluate ``symbol`` with variable values by name (tensors);
    returns its outputs (tensors, or host scalars for ranges the graph
    fixes before the run)."""
    order = symbol._topo()
    # an intermediate is dropped after its last consumer, so a forward
    # holds only the live activations, as a planned graph would
    uses = collections.Counter((id(c), k) for node in order
                               for c, k in node.inputs)
    uses.update((id(n), k) for n, k in symbol._outputs)
    env = {}  # keyed by node identity: names may collide
    with torch.inference_mode():
        for node in order:
            if node.op is None:
                try:
                    env[(id(node), 0)] = values[node.name]
                except KeyError:
                    raise MXNetError(f"no value bound for variable "
                                     f"{node.name}") from None
                continue
            out = _reg.get(node.op).fn(
                *[env[(id(c), k)] for c, k in node.inputs], **op_attrs(node))
            for c, k in node.inputs:
                uses[(id(c), k)] -= 1
                if not uses[(id(c), k)]:
                    del env[(id(c), k)]
            outs = out if isinstance(out, (tuple, list)) else [out]
            for k, o in enumerate(outs):
                if uses[(id(node), k)]:
                    env[(id(node), k)] = o
    return [env[(id(n), k)] for n, k in symbol._outputs]


class Executor:
    """Bound computation (ref: python/mxnet/executor.py Executor)."""

    def __init__(self, symbol, ctx=None, args=None, grad_req="null",
                 aux_states=None):
        self._symbol = symbol
        self._device = resolve_device(ctx)
        self._grad_req = grad_req
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
        self.outputs = []

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
            out[n] = NDArray(as_tensor(arrays[n], self._device))
        return out

    def forward(self, is_train=False, **kwargs):
        """Run the graph; ``kwargs`` rebind arguments by name first."""
        if is_train:
            raise MXNetError("Executor.forward(is_train=True): training "
                             "arrives with the training slice of the port")
        for n, v in kwargs.items():
            if n not in self.arg_dict:
                raise MXNetError(f"unknown argument {n}")
            self.arg_dict[n]._data = as_tensor(v, self._device)
        values = {n: a._data for n, a in self.arg_dict.items()}
        values.update({n: a._data for n, a in self.aux_dict.items()})
        self.outputs = [NDArray(as_tensor(o, self._device))
                        for o in run_graph(self._symbol, values)]
        return self.outputs

    def backward(self, out_grads=None):
        raise MXNetError("Executor.backward arrives with the training slice "
                         "of the port")

    def copy_params_from(self, arg_params, aux_params=None,
                         allow_extra_params=False):
        """Rebind arguments / auxiliary states to the given arrays,
        moved to this executor's device (their dtype is kept, as the JAX
        executor keeps it)."""
        for params, target, what in ((arg_params, self.arg_dict, "arg"),
                                     (aux_params or {}, self.aux_dict,
                                      "aux")):
            for n, v in params.items():
                if n in target:
                    target[n]._data = as_tensor(v, self._device)
                elif not allow_extra_params:
                    raise MXNetError(f"unknown {what} {n}")
