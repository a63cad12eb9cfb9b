"""Deployment-only inference (the port of ``mxnet_tpu/predictor.py``):
a minimal object over a checkpoint that forwards with no training
machinery, the counterpart of the reference's MXPred* C API::

    pred = Predictor.from_checkpoint("model", 3, {"data": (1, 3, 224, 224)})
    out = pred.forward(data=batch)          # numpy in, list of numpy out

The MXPred ABI bridge (``_CPredictor``) waits for the port of the
native library.
"""
from __future__ import annotations

import threading

import numpy as np
import torch

from .base import MXNetError
from .context import Context, cpu, gpu, resolve_device
from .ndarray.ndarray import as_tensor
from .ops.registry import torch_dtype


def compile_symbol_forward(symbol, bindings, device=None, cast=None):
    """The one symbol-to-executable lowering both deployment layers use
    (``Predictor`` and the serving ``VariantSet``): put ``bindings``
    (parameters and auxiliary states by name; NDArrays, tensors or
    array-likes) on ``device`` (``cuda:0`` when None; raises without
    CUDA unless the CPU is asked for) as a tuple sorted by name, and
    return ``(fn, param_vals)`` where ``fn(param_vals, inputs)`` runs
    the graph on that device for ``inputs`` (name -> array) and returns
    a tuple of tensors. The JAX package jits ``fn``; the port runs it op
    by op under ``torch.inference_mode()`` (``executor.run_graph``).

    ``cast`` (``"bfloat16"``) builds a reduced-precision variant: float
    parameters are cast here, float inputs at the graph edge, and float
    outputs back to float32, so replies stay float32.
    """
    from .executor import run_graph

    device = resolve_device(device)
    names = sorted(bindings)
    cast_dt = torch_dtype(cast) if cast is not None else None

    def edge(t):
        if cast_dt is not None and t.is_floating_point():
            return t.to(cast_dt)
        return t

    vals = tuple(edge(as_tensor(bindings[n], device)) for n in names)

    def fwd(param_vals, inputs):
        values = dict(zip(names, param_vals))
        for k, v in inputs.items():
            if not isinstance(v, torch.Tensor):
                v = torch.from_numpy(np.ascontiguousarray(v))
            values[k] = edge(v.to(device))
        outs = []
        for o in run_graph(symbol, values):
            o = as_tensor(o, device)
            if cast_dt is not None and o.is_floating_point():
                o = o.float()
            outs.append(o)
        return tuple(outs)

    return fwd, vals


def _device_of(dev_type, dev_id, device):
    """MXPredCreate's (dev_type, dev_id), or a device given directly."""
    if device is not None:
        return resolve_device(device)
    if dev_type in (None, "gpu", "cuda"):
        return resolve_device(gpu(dev_id))
    if dev_type == "cpu":
        return resolve_device(cpu())
    raise MXNetError(f"Predictor: unknown dev_type {dev_type!r} "
                     "(cpu or gpu)")


class Predictor:
    """MXPredCreate / SetInput / Forward / GetOutput in one object, on
    one device: ``cuda:dev_id`` by default, the CPU with
    ``dev_type="cpu"`` or ``device="cpu"``."""

    def __init__(self, symbol, arg_params, aux_params, input_shapes,
                 dev_type=None, dev_id=0, device=None):
        self._device = _device_of(dev_type, dev_id, device)
        self._symbol = symbol
        self._shapes = {k: tuple(v) for k, v in input_shapes.items()}
        known = set(symbol.list_inputs())
        missing = [n for n in self._shapes if n not in known]
        if missing:
            raise MXNetError(f"Predictor: inputs {missing} not in graph")
        self._bindings = dict(arg_params)
        self._bindings.update(aux_params)
        self._fn = None
        self._param_vals = None
        # the gateway's lane threads may race the first forward
        self._lock = threading.Lock()

    @classmethod
    def from_checkpoint(cls, prefix, epoch, input_shapes, **kwargs):
        """``prefix-symbol.json`` + ``prefix-####.params`` (MXPredCreate's
        file contract), loaded onto the predictor's device."""
        from .model import load_checkpoint
        device = _device_of(kwargs.get("dev_type"), kwargs.get("dev_id", 0),
                            kwargs.get("device"))
        symbol, arg_params, aux_params = load_checkpoint(
            prefix, epoch, ctx=Context(device))
        return cls(symbol, arg_params, aux_params, input_shapes, **kwargs)

    def _build(self):
        fn, vals = compile_symbol_forward(self._symbol, self._bindings,
                                          self._device)
        # the values are published before the function: forward's
        # unlocked fast path reads _fn first
        self._param_vals = vals
        self._fn = fn

    def forward(self, **inputs):
        """One forward: numpy (or NDArray) inputs at the declared
        shapes, a list of numpy outputs (their copy to the host is the
        sync)."""
        fn = self._fn
        if fn is None:
            with self._lock:
                if self._fn is None:
                    self._build()
                fn = self._fn
        feed = {}
        for k, v in inputs.items():
            if k not in self._shapes:
                raise MXNetError(f"Predictor: unknown input {k!r}")
            t = as_tensor(v)
            if tuple(t.shape) != self._shapes[k]:
                raise MXNetError(
                    f"Predictor: input {k} shape {tuple(t.shape)} != "
                    f"declared {self._shapes[k]} (reshape first, as "
                    "MXPredReshape does)")
            feed[k] = t
        outs = fn(self._param_vals, feed)
        return [o.cpu().numpy() for o in outs]

    def reshape(self, new_input_shapes):
        """New input shapes (MXPredReshape); the graph runs at any
        shape, so nothing is rebuilt."""
        with self._lock:
            self._shapes.update({k: tuple(v)
                                 for k, v in new_input_shapes.items()})
        return self

    def output_shapes(self):
        """Output shapes at the declared input shapes, without running a
        forward (MXPredGetOutputShape is legal straight after create):
        shape inference runs the ops on ``meta`` tensors."""
        known = {k: tuple(as_tensor(v).shape)
                 for k, v in self._bindings.items()}
        known.update(self._shapes)
        _, out_shapes, _ = self._symbol.infer_shape(**known)
        return [tuple(s) for s in out_shapes]
