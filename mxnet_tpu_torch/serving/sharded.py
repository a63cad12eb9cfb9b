"""One-shot serving over a mesh slice (counterpart of
``mxnet_tpu/serving/sharded.py``): a replica lane that is ``tp``
devices, not one.

A :class:`ShardedVariantSet` holds a model's parameters sharded at rest
over a one-axis ``tp`` mesh of the slice, each under the
:class:`~mxnet_tpu_torch.parallel.layout.SpecLayout` table's spec for
its role (the table training resolves through): each position keeps
its block of every parameter, so its bytes are what
:meth:`~ShardedVariantSet.placement_report` states. A padded batch runs
once at every position, on its shard thread
(``parallel.mesh.run_shards``): the graph walk (``executor.run_graph``)
gathers each parameter a spec shards from the slice's positions when
the op that reads it is reached, and drops it after that op's last
use, so no position ever holds the whole model; every position computes
the whole forward, so the outputs are replicated, and position 0's are
the reply. The JAX package runs one GSPMD program instead, whose
row-parallel layers reassociate a reduction; the port's slice computes
the one-device forward's arithmetic, which is within
:data:`DIVERGENCE_BOUND` of it (bitwise, in fact).

Deviation from the JAX package: a slice may name one device more than
once (``Gateway(devices=["cuda:0", "cuda:0"])``: one card holds every
position), as the generator's slices may (``parallel/mesh.py``); the
gateway flags such a lane ``degraded``. Every other refusal stays: a
slice of fewer than 2 devices, and variants other than ``fp32`` /
``bf16`` (the quantized graph has no sharded lowering).
"""
from __future__ import annotations

import copy
import json

import numpy as np
import torch

from ..base import MXNetError, get_env
from ..ndarray.ndarray import NDArray, as_tensor
from ..ops.registry import torch_dtype
from ..parallel.collectives import allgather
from ..parallel.layout import SpecLayout, dryrun_report
from ..parallel.mesh import (NamedSharding, _spec_axes, create_mesh,
                             run_shards)

#: the fp32 divergence ceiling of a tp-sharded forward against the
#: one-device reference (the JAX package's bound)
DIVERGENCE_BOUND = 5e-5

SHARDED_VARIANTS = ("fp32", "bf16")


class _OnUse(dict):
    """A position's variable values for the graph walk: each parameter
    a spec shards is gathered over the slice when the walk reads it (and
    held only as long as the walk holds it, to that op's last use)."""

    def __init__(self, values, specs, mesh):
        super().__init__(values)
        self._specs = specs
        self._mesh = mesh

    def __getitem__(self, name):
        x = super().__getitem__(name)
        spec = self._specs.get(name)
        if spec is None:
            return x
        for dim, axes in enumerate(_spec_axes(spec, self._mesh, x.ndim)):
            if axes:
                x = allgather(x, axes, axis=dim)
        return x


def compile_symbol_forward_sharded(symbol, bindings, mesh, layout,
                                   cast=None):
    """The sharded twin of ``predictor.compile_symbol_forward``: lay
    ``bindings`` out over ``mesh`` by the layout table (``Sharded``
    values) and return ``(fn, param_vals)``, where ``fn(param_vals,
    inputs)`` runs the symbol at every position, gathering each sharded
    parameter on use, and returns position 0's outputs (replicated).
    ``cast`` (``"bfloat16"``) casts the float parameters once, float
    inputs at the graph edge and float outputs back to float32."""
    from ..executor import run_graph

    names = sorted(bindings)
    cast_dt = torch_dtype(cast) if cast is not None else None
    dev0 = mesh.devices.flat[0]

    def edge(t):
        if cast_dt is not None and t.is_floating_point():
            return t.to(cast_dt)
        return t

    vals = []
    for n in names:
        v = edge(as_tensor(bindings[n], dev0))
        vals.append(NamedSharding(
            mesh, layout.spec_for(n, shape=tuple(v.shape), mesh=mesh)
        ).shard(v))
    vals = tuple(vals)
    specs = {n: v.spec for n, v in zip(names, vals)
             if any(_spec_axes(v.spec, mesh, len(v.shape)))}

    def position(params, inputs, device):
        values = _OnUse(zip(names, params), specs, mesh)
        for k, v in inputs.items():
            values[k] = edge(v.to(device))
        outs = []
        for o in run_graph(symbol, values):
            o = as_tensor(o, device)
            if cast_dt is not None and o.is_floating_point():
                o = o.float()
            outs.append(o)
        return tuple(outs)

    def fwd(param_vals, inputs):
        inputs = {k: v if isinstance(v, torch.Tensor)
                  else torch.from_numpy(np.ascontiguousarray(v))
                  for k, v in inputs.items()}
        args = [([p.local(c) for p in param_vals], inputs,
                 mesh.device_at(c)) for c in mesh.positions()]
        return run_shards(mesh, position, args)[0]

    return fwd, vals


class ShardedVariantSet:
    """One mesh-slice lane's forwards, duck-typing
    :class:`~.variants.VariantSet` (``run`` / ``warmup`` / ``replica``
    and the attributes the gateway's Replica reads), so the scheduler,
    health probe, drain and scale work on a sliced lane unchanged.

    ``devices`` is the slice (``tp`` devices; the module docstring's
    rule on repeats); ``layout`` defaults to ``SpecLayout.default()``.
    Variants: ``fp32`` and ``bf16`` (parameters cast once, float32
    replies); ``int8`` is refused."""

    def __init__(self, symbol, arg_params, aux_params, input_name,
                 feature_shape, devices, variants=("fp32",),
                 layout=None, input_dtype="float32", tp_axis="tp"):
        devices = tuple(devices)
        if len(devices) < 2:
            raise MXNetError(
                f"serving: a sharded lane needs a slice of >= 2 devices, "
                f"got {len(devices)} (use VariantSet for single-device "
                "lanes)")
        for v in variants:
            if v not in SHARDED_VARIANTS:
                raise MXNetError(
                    f"serving: sharded lanes serve {SHARDED_VARIANTS}, not "
                    f"{v!r} (int8 has no sharded lowering yet)")
        self.input_name = input_name
        self.feature_shape = tuple(int(s) for s in feature_shape)
        self.input_dtype = np.dtype(input_dtype)
        self.mesh = create_mesh({tp_axis: len(devices)}, devices=devices)
        self.devices = tuple(self.mesh.devices.flat)
        self.device = self.devices     # what stats() and logs show
        self.tp = len(devices)
        self.tp_axis = tp_axis
        self.degraded = len({str(d) for d in self.devices}) < self.tp
        self.variants = tuple(variants)
        self.num_outputs = len(symbol.list_outputs())
        self.int8_lowering = None      # the VariantSet contract's slot
        self.layout = layout if layout is not None else SpecLayout.default()
        bindings = dict(arg_params)
        bindings.update(aux_params)
        bindings = {n: v._data if isinstance(v, NDArray) else v
                    for n, v in bindings.items()}
        self._binding_names = tuple(sorted(bindings))
        self._fns = {
            v: compile_symbol_forward_sharded(
                symbol, bindings, self.mesh, self.layout,
                cast="bfloat16" if v == "bf16" else None)
            for v in self.variants}
        self._maybe_report()

    def _maybe_report(self):
        """``MXTPU_LAYOUT_REPORT``: write this lane's placement report
        there (atomically)."""
        path = get_env("MXTPU_LAYOUT_REPORT", "", str)
        if not path:
            return
        from ..checkpoint import atomic_write
        with atomic_write(path, mode="w", manifest=False) as f:
            f.write(json.dumps(self.placement_report(), indent=1) + "\n")

    def placement_report(self):
        """Every binding's role, spec and per-device bytes over the
        slice (the layout plane's report)."""
        _, pvals = self._fns[self.variants[0]]
        return dryrun_report(
            self.layout, dict(zip(self._binding_names, pvals)), self.mesh,
            extra={"kind": "serving_slice", "tp": self.tp})

    def position_bytes(self, variant=None):
        """The bytes of each position's parameter blocks, as stored."""
        _, pvals = self._fns[variant or self.variants[0]]
        return [sum(p.local(c).untyped_storage().nbytes() for p in pvals)
                for c in self.mesh.positions()]

    def replica(self):
        """Another set over the same parameters and forwards (replicas
        of one model on one slice share them)."""
        twin = copy.copy(self)
        twin._fns = dict(self._fns)
        return twin

    # -- dispatch (the VariantSet contract) ----------------------------------
    def run(self, variant, batch):
        """Execute one padded batch over the slice: numpy in, a list of
        numpy out (position 0's replicated outputs)."""
        fn, pvals = self._fns[variant]
        outs = fn(pvals, {self.input_name: np.ascontiguousarray(batch)})
        return [o.cpu().numpy() for o in outs]

    def warmup(self, buckets):
        """Run every (variant, bucket) once; returns the count."""
        n = 0
        for variant in self.variants:
            for b in buckets:
                self.run(variant, np.zeros((b,) + self.feature_shape,
                                           self.input_dtype))
                n += 1
        return n

    def close(self):
        """Stop the slice's shard threads."""
        self.mesh.close()
