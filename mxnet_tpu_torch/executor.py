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

**Over a dp mesh** (``mesh=``, ``arg_specs=``: the JAX executor's
GSPMD program, spelled out). Inputs whose spec splits them (``P("dp")``)
are cut across the mesh positions, everything else is replicated, and
each position walks the graph on its block, on its shard thread
(``parallel.mesh.run_shards``). Arrays live whole on the mesh's first
device; an input given as a ``Sharded`` laid out as its spec asks is
used in place. What reaches across the batch is combined across the
positions, so the step means what the one-device step means:

- training BatchNorm normalises over the whole batch: each position's
  mean and biased variance are all-gathered and merged (Chan's merge of
  equal counts), through autograd, so the backward is the whole
  batch's too; the moving statistics are updated once from the merged
  ones;
- SoftmaxOutput's ``normalization="batch"`` / ``"valid"`` divide by the
  whole batch's count (``"valid"``'s is all-reduced).

Outputs are concatenated to the global batch on the first device (every
output must be batch-major). ``backward`` takes one
``torch.autograd.grad`` over every position's recorded outputs (the
positions' graphs meet in the BatchNorm merges, so no collective runs
inside the backward), sums the replicated arguments' gradients in rank
order on the first device and concatenates the split ones.

**Health and memory.** Each forward and backward hands its outputs (its
gradients) to the model-health sentry (``profiling.health.check``: a
nonfinite count on the device, folded at a later step boundary); a trip
replays the forward through the per-node tap to name the first op whose
output is nonfinite. The gradient buffers carry the ``gradient`` census
role, and an allocation failure inside a forward or backward leaves the
OOM postmortem (``profiling.memory``) before it propagates.
"""
from __future__ import annotations

import collections
import contextlib
import functools

import torch

import numpy as np

from . import telemetry as _telemetry
from . import tracing as _tracing
from .base import MXNetError, attr_bool
from .context import resolve_device
from .ndarray.ndarray import NDArray, as_tensor
from .ops import registry as _reg
from .ops.nn import batch_moments
from .parallel.collectives import allgather, allreduce, axis_size
from .parallel.mesh import (PartitionSpec as P, Sharded, _assemble, _local,
                            entry_axes, run_shards)
from .profiling import health as _health
from .profiling import memory as _mem
from .profiling import optrace as _optrace
from .symbol.symbol import op_attrs

_ot_active = _optrace.ACTIVE


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


def _bn_train_dp(node, ins, attrs, aux_updates, axes):
    """Training BatchNorm over the whole batch of a dp mesh: the
    positions' batch moments all-gathered (in rank order, through
    autograd) and merged; the moving statistics as :func:`_bn_train`
    updates them, from the merged ones."""
    data, gamma, beta = ins[:3]
    axis = int(attrs.get("axis", 1)) % data.ndim
    eps = float(attrs.get("eps", 1e-3))
    g = torch.ones_like(gamma) if attr_bool(attrs.get("fix_gamma"), True) \
        else gamma
    parts = allgather(torch.stack(batch_moments(data, axis)), axes, axis=0,
                      tiled=False)
    # equal counts a position: the mean of the means, and the mean of
    # the variances plus the means' spread
    mean = parts[:, 0].mean(0)
    var = parts[:, 1].mean(0) + ((parts[:, 0] - mean) ** 2).mean(0)
    bshape = tuple(data.shape[axis] if i == axis else 1
                   for i in range(data.ndim))
    out = (data - mean.reshape(bshape)) \
        * (torch.rsqrt(var + eps) * g).reshape(bshape) + beta.reshape(bshape)
    momentum = float(attrs.get("momentum", 0.9))
    with torch.no_grad():
        for (child, _), moving, batch in zip(node.inputs[3:5], ins[3:5],
                                             (mean, var)):
            if child.op is None:
                aux_updates[child.name] = (momentum * moving
                                           + (1 - momentum) * batch)
    if attr_bool(attrs.get("output_mean_var")):
        return out, mean, var
    return out


def _softmax_dp_attrs(ins, attrs, axes):
    """SoftmaxOutput's attributes at one position of a dp mesh: a
    ``"batch"`` / ``"valid"`` normalization becomes the whole batch's
    count folded into ``grad_scale``."""
    norm = str(attrs.get("normalization", "null"))
    scale = float(attrs.get("grad_scale", 1.0))
    if norm == "batch":
        scale = scale / (ins[0].shape[0] * axis_size(axes))
    elif norm == "valid" and attr_bool(attrs.get("use_ignore")):
        ignore = float(attrs.get("ignore_label", -1.0))
        valid = allreduce((ins[1] != ignore).sum(), axes)
        scale = float(np.float32(scale) / np.float32(max(int(valid), 1)))
    else:
        return attrs
    return {**attrs, "normalization": "null", "grad_scale": scale}


def _softmax_dp(fn, axes, *ins, **attrs):
    """``fn`` (SoftmaxOutput / Softmax) at one position of a dp mesh."""
    return fn(*ins, **_softmax_dp_attrs(ins, attrs, axes))


def _tap_names(node):
    """The monitor's names of a node's outputs (the JAX executor's
    internals naming)."""
    return [node.name + ("_output" if k == 0 else f"_output{k}")
            for k in range(node.num_outputs())]


def _run(symbol, values, training, dp_axes=None, tap=None):
    """(outputs, moving-statistic updates) of ``symbol`` with variable
    values by name (tensors); ``dp_axes`` names the mesh axes the batch
    is split over when this is one position of a dp mesh. ``tap(name,
    value)`` sees every node's outputs as the walk produces them, in the
    order of ``symbol.get_internals()`` (variables included)."""
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
                if tap is not None:
                    tap(_tap_names(node)[0], values[node.name])
                continue
            ins = [env[(id(c), k)] for c, k in node.inputs]
            attrs = op_attrs(node)
            opdef = _reg.get(node.op)
            if "training" in opdef._kwarg_names and "training" not in attrs:
                attrs["training"] = training
            if training and node.op == "BatchNorm" \
                    and not attr_bool(attrs.get("use_global_stats")):
                bn = _bn_train_dp if dp_axes else _bn_train
                args = (node, ins, attrs, aux_updates) + (
                    (dp_axes,) if dp_axes else ())
                out = _optrace.scoped("BatchNorm", bn, args, {}) \
                    if _ot_active[0] else bn(*args)
            else:
                fn = opdef.fn
                if dp_axes and training and node.op in ("SoftmaxOutput",
                                                        "Softmax"):
                    fn = functools.partial(_softmax_dp, fn, dp_axes)
                # an op trace or capture: the node's op scope
                out = _optrace.scoped(node.op, fn, ins, attrs) \
                    if _ot_active[0] else fn(*ins, **attrs)
            del ins
            for c, k in node.inputs:
                uses[(id(c), k)] -= 1
                if not uses[(id(c), k)]:
                    del env[(id(c), k)]
            outs = out if isinstance(out, (tuple, list)) else [out]
            for k, o in enumerate(outs):
                if uses[(id(node), k)]:
                    env[(id(node), k)] = o
            if tap is not None:
                for name, o in zip(_tap_names(node), outs):
                    tap(name, o)
    return [env[(id(n), k)] for n, k in symbol._outputs], aux_updates


class _Profiled:
    """A profiler region whose end waits for ``device``'s work."""

    def __init__(self, region, device):
        self._region = region
        self._device = device

    def __enter__(self):
        self._region.__enter__()
        return self

    def __exit__(self, *exc):
        if self._device.type == "cuda":
            torch.cuda.synchronize(self._device)
        return self._region.__exit__(*exc)


def run_graph(symbol, values):
    """Evaluate ``symbol`` for inference with variable values by name
    (tensors); returns its outputs (tensors, or host scalars for ranges
    the graph fixes before the run)."""
    return _run(symbol, values, training=False)[0]


class Executor:
    """Bound computation (ref: python/mxnet/executor.py Executor)."""

    def __init__(self, symbol, ctx=None, args=None, args_grad=None,
                 grad_req="write", aux_states=None, mesh=None,
                 arg_specs=None):
        self._symbol = symbol
        # over a mesh, the arrays live on its first device
        self._mesh = mesh
        self._arg_specs = dict(arg_specs or {})
        self._device = resolve_device(ctx if mesh is None
                                      else mesh.devices.flat[0])
        # inputs given as Sharded values, used in place (dp mesh only)
        self._sharded = {}
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
                n: _mem.tag_role(
                    NDArray(torch.zeros_like(self.arg_dict[n]._data)),
                    "gradient")
                for n in self.arg_names if self._grad_req[n] != "null"}
        self.outputs = []
        # (outputs with graph, leaves) of the last training forward,
        # until the next forward
        self._recorded = None
        # the last training forward's inputs, for a backward trip's replay
        self._replay = None
        self._monitor = None
        self._monitor_all = False

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
            if isinstance(v, Sharded):
                if self._mesh is not None:
                    self._sharded[n] = v
                    continue
                v = v.full()
            self._sharded.pop(n, None)
            self.arg_dict[n]._data = as_tensor(v, self._device)
        self._recorded = None
        tap = self._tap()
        # monitor_all also taps the graph's inputs, as they were before
        # this forward updated the moving statistics
        inputs = [] if tap is None or not self._monitor_all else [
            (n + "_input", self._sharded[n].full() if n in self._sharded
             else a._data) for n, a in self.arg_dict.items()] + [
            (n + "_input", a._data) for n, a in self.aux_dict.items()]
        with self._maybe_profile("executor_forward"), \
                _tracing.span("executor_forward", cat="compute"), \
                _telemetry.compile_scope("executor_forward"):
            try:
                if self._mesh is not None:
                    arg_vals, aux_vals = self._forward_dp(is_train, tap)
                else:
                    arg_vals, aux_vals = self._forward(is_train, tap)
            except Exception as e:
                # an allocation failure leaves the memory postmortem
                # first; anything else propagates untouched
                _mem.maybe_oom_postmortem(e, source="executor_forward")
                raise
        for name, value in inputs:
            tap(name, value)
        self._replay = (arg_vals, aux_vals) if is_train else None
        if _health.enabled():
            # one nonfinite count over the outputs, folded at a later
            # step boundary; only a trip runs the replay, over these
            # inputs, that names the first nonfinite op
            _health.check(
                "executor_forward", self.outputs,
                localize=lambda: _health.localize_first_nonfinite(
                    self, arg_vals, aux_vals, training=bool(is_train)))
        return self.outputs

    def _split_values(self, values):
        """(argument values, auxiliary values) of a forward's inputs."""
        return ({n: values[n] for n in self.arg_names if n in values},
                {n: values[n] for n in self.aux_names if n in values})

    def _internals(self, arg_vals, aux_vals, training):
        """(names, values) of every node output of a replayed forward
        over the given inputs, in ``get_internals()`` order (the
        monitor's tap; a dp mesh's inputs assembled whole): what the
        health localizer searches."""
        values = {n: v.full() if isinstance(v, Sharded) else v
                  for n, v in {**arg_vals, **aux_vals}.items()}
        names, vals = [], []

        def tap(name, value):
            names.append(name)
            vals.append(value)
        with torch.no_grad():
            _run(self._symbol, values, bool(training), tap=tap)
        return names, vals

    def _forward(self, is_train, tap):
        values = {n: a._data for n, a in self.arg_dict.items()}
        values.update({n: a._data for n, a in self.aux_dict.items()})
        if not is_train:
            self.outputs = [NDArray(as_tensor(o, self._device))
                            for o in _run(self._symbol, values, False,
                                          tap=tap)[0]]
            return self._split_values(values)
        leaves = {}
        for n, req in self._grad_req.items():
            t = values[n]
            if req == "null" or not t.is_floating_point():
                continue
            if t.is_inference():    # an inference forward's output
                t = t.clone()
            leaves[n] = values[n] = t.detach().requires_grad_(True)
        outs, aux_updates = _run(self._symbol, values, training=True,
                                 tap=tap)
        for n, v in aux_updates.items():
            self.aux_dict[n]._data = v
        self._recorded = (outs, leaves)
        self.outputs = [NDArray(as_tensor(o, self._device).detach())
                        for o in outs]
        return self._split_values(values)

    # -- observability --------------------------------------------------
    def set_monitor_callback(self, callback, monitor_all=False):
        """``callback(name, NDArray)`` sees every node's outputs of each
        forward (``<node>_output``, ``<node>_output<k>``; with
        ``monitor_all`` the arguments and auxiliary states too, as
        ``<name>_input``), as the JAX executor's internals pass names
        them. ``None`` removes it."""
        self._monitor = callback
        self._monitor_all = monitor_all

    def _tap(self):
        """The monitor tap of this forward, or None: a ``Monitor`` that is
        not collecting this batch (``activated`` false) is skipped; a
        plain callback always collects."""
        if self._monitor is None:
            return None
        owner = getattr(self._monitor, "__self__", None)
        if owner is not None and not getattr(owner, "activated", True):
            return None
        cb = self._monitor
        device = self._device

        def tap(name, value):
            cb(name, NDArray(as_tensor(value, device).detach()))
        return tap

    def _maybe_profile(self, name):
        """A profiler region that waits for the card at its end while the
        profiler runs (the region then times the work, not its launch),
        else a no-op."""
        from . import profiler
        if not profiler.is_running():
            return contextlib.nullcontext()
        return _Profiled(profiler.timed_region(name, "executor"),
                         self._device)

    # -- over a dp mesh -------------------------------------------------
    def _spec(self, name):
        return self._arg_specs.get(name, P())

    def _dp_axes(self):
        """The mesh axes the arguments' specs split the batch over."""
        return tuple(dict.fromkeys(a for spec in self._arg_specs.values()
                                   for e in spec for a in entry_axes(e)))

    def _dp_ranks(self):
        """The positions of one dp group (every other axis at 0)."""
        axes = self._dp_axes()
        return [i for i, c in enumerate(self._mesh.positions())
                if all(c[a] == 0 for a in c if a not in axes)]

    def _forward_dp(self, is_train, tap=None):
        mesh = self._mesh
        values = {n: self._sharded.get(n, a._data)
                  for n, a in self.arg_dict.items()}
        aux0 = {n: a._data for n, a in self.aux_dict.items()}
        for n, v in values.items():
            spec = self._spec(n)
            if spec and entry_axes(spec[0]) and v.shape:
                ways = np.prod([mesh.shape[a] for a in entry_axes(spec[0])])
                if v.shape[0] % ways:
                    raise MXNetError(
                        f"batch axis of '{n}' has size {v.shape[0]}, not "
                        f"divisible by the {ways} devices in the context "
                        "list; pad the iterator (last_batch_handle='pad') "
                        "or pick a divisible batch size")
        trained = [n for n, req in self._grad_req.items()
                   if req != "null" and is_train
                   and values[n].dtype.is_floating_point]
        axes = self._dp_axes()

        def position(local):
            leaves = {}
            for n in trained:
                t = local[n]
                if t.is_inference():    # an inference forward's output
                    t = t.clone()
                leaves[n] = local[n] = t.detach().requires_grad_(True)
            taps = [] if tap is not None else None
            outs, aux_updates = _run(
                self._symbol, local, bool(is_train), dp_axes=axes,
                tap=None if taps is None else
                (lambda name, v: taps.append((name, v))))
            return outs, aux_updates, leaves, taps

        args = []
        for c in mesh.positions():
            local = {n: _local(v, self._spec(n), mesh, c)
                     for n, v in values.items()}
            local.update({n: _local(a._data, P(), mesh, c)
                          for n, a in self.aux_dict.items()})
            args.append((local,))
        results = run_shards(mesh, position, args)
        del args
        for n, v in results[0][1].items():
            self.aux_dict[n]._data = v
        out_spec = P(axes or None)
        outputs = []
        for k in range(len(results[0][0])):
            parts = [r[0][k] for r in results]
            if not isinstance(parts[0], torch.Tensor):
                outputs.append(NDArray(as_tensor(parts[0], self._device)))
                continue
            if parts[0].ndim == 0:
                raise MXNetError(
                    f"output {self.output_names[k]} is a scalar: over a dp "
                    "mesh every output must be batch-major")
            outputs.append(NDArray(_assemble(out_spec, mesh,
                                             [p.detach() for p in parts])))
        self.outputs = outputs
        if is_train:
            self._recorded = ([r[0] for r in results],
                              [r[2] for r in results])
        if tap is not None:
            # the whole batch's value of each internal, as the JAX
            # executor's global arrays: what depends on a split input is
            # joined along the batch, the rest is every position's alike
            split = self._split_nodes()
            for j, (name, first) in enumerate(results[0][3]):
                parts = [r[3][j][1] for r in results]
                if split[name] and isinstance(first, torch.Tensor) \
                        and first.ndim:
                    value = _assemble(out_spec, mesh,
                                      [p.detach() for p in parts])
                else:
                    value = first
                tap(name, value)
        return self._split_values({**values, **aux0})

    def _split_nodes(self):
        """{tap name: whether the value depends on an input the specs
        split over the batch}."""
        split, out = {}, {}
        for node in self._symbol._topo():
            if node.op is None:
                spec = self._spec(node.name)
                hit = bool(spec) and bool(entry_axes(spec[0]))
            else:
                hit = any(split[id(c)] for c, _ in node.inputs)
            split[id(node)] = hit
            for name in _tap_names(node):
                out[name] = hit
        return out

    def _backward_dp(self, out_grads):
        mesh = self._mesh
        outs_pp, leaves_pp = self._recorded
        positions = mesh.positions()
        out_spec = P(self._dp_axes() or None)
        if out_grads is not None and isinstance(out_grads, (NDArray, Sharded)):
            out_grads = [out_grads]
        outs, heads = [], []
        for i, c in enumerate(positions):
            for k, o in enumerate(outs_pp[i]):
                if not isinstance(o, torch.Tensor) or not o.requires_grad:
                    continue
                if out_grads is None:
                    h = torch.ones_like(o)
                else:
                    g = out_grads[k]
                    g = g if isinstance(g, Sharded) else as_tensor(g)
                    h = _local(g, out_spec, mesh, c)
                outs.append(o)
                heads.append(h)
        names = list(leaves_pp[0])
        flat = [leaves_pp[i][n] for i in range(len(positions)) for n in names]
        grads = [None] * len(flat)
        if outs and flat:
            grads = torch.autograd.grad(outs, flat, grad_outputs=heads,
                                        allow_unused=True, retain_graph=True)
        del outs, heads
        ranks = self._dp_ranks()
        out = {}
        for j, n in enumerate(names):
            parts = [grads[i * len(names) + j] for i in range(len(positions))]
            parts = [torch.zeros_like(leaves_pp[i][n]) if g is None else g
                     for i, g in enumerate(parts)]
            spec = self._spec(n)
            if any(entry_axes(e) for e in spec):
                out[n] = _assemble(spec, mesh, parts)
            else:
                # the replicated argument's gradient summed in rank order
                acc = parts[ranks[0]].to(self._device)
                for i in ranks[1:]:
                    acc = acc + parts[i].to(self._device)
                out[n] = acc
        return out

    def backward(self, out_grads=None):
        """Gradients of the recorded forward wrt every argument whose
        ``grad_req`` is not ``"null"``, into ``grad_dict``: ``"write"``
        replaces, ``"add"`` accumulates. ``out_grads`` are the head
        gradients (ones when None; SoftmaxOutput ignores its own)."""
        if self._recorded is None:
            raise MXNetError("backward called before forward(is_train=True)")
        with self._maybe_profile("executor_backward"), \
                _tracing.span("executor_backward", cat="compute"), \
                _telemetry.compile_scope("executor_backward"):
            try:
                grads = self._backward_dp(out_grads) \
                    if self._mesh is not None else self._backward(out_grads)
            except Exception as e:
                _mem.maybe_oom_postmortem(e, source="executor_backward")
                raise
            self._store_grads(grads)
        if _health.enabled():
            # backward sentry: a NaN born in the backward (finite in
            # every forward internal) trips here; the replay then finds
            # no first op and the postmortem names the seam
            arg_vals, aux_vals = self._replay
            _health.check(
                "executor_backward", grads,
                localize=lambda: _health.localize_first_nonfinite(
                    self, arg_vals, aux_vals, training=True))

    def _backward(self, out_grads):
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
        return {n: torch.zeros_like(leaves[n]) if g is None else g
                for n, g in zip(names, grads)}

    def _store_grads(self, grads):
        for n, g in grads.items():
            g = g.contiguous()
            dst = self.grad_dict.get(n)
            if dst is None:
                dst = self.grad_dict[n] = NDArray(g)
            elif self._grad_req[n] == "add":
                dst._data = dst._data + g
            else:
                dst._data = g
            # a fresh tensor each backward: re-stamp the census role
            _mem.tag_role(dst, "gradient")

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
