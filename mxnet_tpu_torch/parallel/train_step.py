"""Sharded training steps over the in-process mesh (counterpart of
``mxnet_tpu/parallel/train_step.py``).

The JAX package compiles ``loss_fn`` into one SPMD program: GSPMD
splits the batch over ``dp``, differentiates the global loss and inserts
the gradient all-reduce. The port runs eagerly, so it spells that
program out. Each mesh position, on its shard thread
(:func:`~.mesh.run_shards`):

1. gathers the parameters a spec shards (ZeRO stage 3's ``dp`` slices,
   a tensor-parallel split) into whole leaves: gather on use, at the
   start of the step; they are dropped when the step ends;
2. runs ``loss_fn`` on its batch shard and takes ``torch.autograd.grad``;
3. combines the shards' losses and gradients over the batch's mesh axes
   with the rank-order collectives (:mod:`.collectives`): an
   ``allreduce``, or a ``reduce_scatter`` where the gradient's layout
   shards the leaf over those axes, then divides by the number of
   shards. A gradient is laid out as its parameter is at rest (GSPMD's
   default: ZeRO stage 3 reduce-scatters), unless ``grad_specs`` says
   otherwise (stage 2);
4. updates its own block of each leaf (its slice where the optimizer
   state is sharded) with :func:`sgd_update`, and all-gathers the
   parameters that live whole at rest from the updated slices.

**The loss contract.** GSPMD differentiates ``loss_fn`` over the global
batch; the port evaluates it per shard. ``shard_map`` splits the batch
evenly, so the mean of the shard losses (and of their gradients) is the
shard-size-weighted mean, which equals the global loss (and gradient)
exactly when ``loss_fn`` is a mean over the batch's leading axis. Every
caller in both packages uses such a loss; a loss that reaches across
the batch otherwise (a sum, batch statistics) is not what GSPMD would
compute.

Parameters, optimizer state and the batch are :class:`~.mesh.Sharded`
values (each position's block on its device); the step returns new ones
with the JAX package's specs, and a loss on the mesh's first device.
``step.last_collectives`` counts the collectives of the last call by
kind: the replicated step all-reduces, stage 1 also all-gathers the
updated slices, stage 2 reduce-scatters the gradients instead of
all-reducing them, stage 3 all-gathers the parameters on use,
reduce-scatters the gradients and gathers nothing after the update.

Each step hands its loss to the model-health sentry and loss EWMA
(``profiling.health``: a device count, folded at the step's health
boundary a few steps later), tags the parameters and optimizer state it
returns with their census roles (``profiling.memory``: per mesh
position), and leaves the OOM postmortem when an allocation fails.
"""
from __future__ import annotations

import math

import torch

from ..profiling import health as _health
from ..profiling import memory as _mem
from .collectives import allgather, allreduce, reduce_scatter
from .layout import SpecLayout, zero_shard_leaf  # noqa: F401 (re-export)
from .mesh import (NamedSharding, PartitionSpec as P, Sharded, _local,
                   _map_leaves, _map_specs, _spec_axes, current_shard,
                   entry_axes, run_shards)


def sgd_update(params, grads, lr, momentum=None, state=None):
    """Plain or momentum SGD over a pytree (dict / list / tuple) of
    tensors: ``p - lr * g``, or ``m = momentum * m + g`` then
    ``p - lr * m``; returns ``(params, state)``."""
    if momentum is None:
        return _map_leaves(lambda p, g: p - lr * g, params, grads), None
    if state is None:
        state = _map_leaves(torch.zeros_like, params)
    state = _map_leaves(lambda m, g: momentum * m + g, state, grads)
    return _map_leaves(lambda p, m: p - lr * m, params, state), state


def _spec_tree(specs, like):
    """A spec for every leaf of ``like`` from the prefix ``specs``."""
    return _map_specs(lambda s, _: s if s is not None else P(), specs, like)


def _spec_leaves(specs):
    if specs is None or isinstance(specs, P):
        return [specs or P()]
    values = specs.values() if isinstance(specs, dict) else specs
    return [s for v in values for s in _spec_leaves(v)]


def _local_shape(shape, spec, mesh):
    return tuple(s // math.prod(mesh.shape[a] for a in axes)
                 for s, axes in zip(shape, _spec_axes(spec, mesh,
                                                      len(shape))))


def _gather(x, spec, mesh):
    """The whole leaf from this position's block under ``spec``."""
    for dim, axes in enumerate(_spec_axes(spec, mesh, x.ndim)):
        if axes:
            x = allgather(x, axes, axis=dim)
    return x


def _relayout(x, src, dst, mesh):
    """This position's block under ``dst`` from its block under ``src``:
    gathered over ``src``'s axes where the two differ, then sliced."""
    if _spec_axes(src, mesh, x.ndim) == _spec_axes(dst, mesh, x.ndim):
        return x
    return _local(_gather(x, src, mesh), dst, mesh, current_shard().coords)


def _scatter_dim(spec, axes, mesh, ndim):
    """The dim ``spec`` shards over exactly ``axes``, else None."""
    for dim, got in enumerate(_spec_axes(spec, mesh, ndim)):
        if got == axes:
            return dim
    return None


def make_sharded_train_step(loss_fn, mesh, param_example, batch_example,
                            param_specs=None, batch_specs=P("dp"),
                            lr=0.01, momentum=None, donate=True,
                            state_specs=None, grad_specs=None):
    """``loss_fn(params, batch) -> scalar`` (a mean over the batch's
    leading axis, the module docstring's contract) as a sharded SGD
    step over ``mesh``.

    Parameters are replicated by default, or laid out by ``param_specs``
    (a spec pytree prefix: tensor-parallel splits, ZeRO stage 3) and
    gathered on use; the batch is split by ``batch_specs``;
    ``state_specs`` lays the momentum out apart from the parameters
    (ZeRO stage 1); ``grad_specs`` reduce-scatters the combined
    gradients where they shard a leaf over the batch's axes (ZeRO stage
    2). Returns ``(step, params0, opt0)``: ``step(params, opt_state,
    batch) -> (params, opt_state, loss)`` and the placed initial state
    (None without momentum). With ``donate``, a step on CUDA devices
    drops the shards of the parameters and state it was given, as JAX
    donation deletes them; the JAX package turns donation off on the
    CPU, and so does the port."""
    p_specs = _spec_tree(param_specs, param_example)
    g_specs = None if grad_specs is None \
        else _spec_tree(grad_specs, param_example)
    if momentum is None:
        if state_specs is not None:
            raise ValueError("state_specs requires a stateful optimizer "
                             "(momentum is None)")
        o_specs = None
    else:
        o_specs = p_specs if state_specs is None \
            else _spec_tree(state_specs, param_example)
    data_axes = tuple(dict.fromkeys(
        a for s in _spec_leaves(batch_specs) for e in s
        for a in entry_axes(e)))
    n_shards = math.prod(mesh.shape[a] for a in data_axes)
    donate = donate and any(d.type == "cuda" for d in mesh.devices.flat)

    def place(spec, x):
        return NamedSharding(mesh, spec).shard(
            torch.as_tensor(x).detach().clone())

    def zeros(spec, p):
        shape = _local_shape(tuple(p.shape), spec, mesh)
        return Sharded.from_locals(mesh, spec, [
            torch.zeros(shape, dtype=p.dtype, device=mesh.device_at(c))
            for c in mesh.positions()])

    params0 = _map_specs(place, p_specs, param_example)
    opt0 = None if o_specs is None else _map_specs(zeros, o_specs, params0)
    u_specs = o_specs if o_specs is not None else p_specs

    def combine(g, u_spec, g_spec):
        """The summed gradient's block under the update's layout."""
        dim = _scatter_dim(g_spec, data_axes, mesh, g.ndim) \
            if data_axes else None
        if dim is None:
            if data_axes:
                g = allreduce(g, data_axes)
            return _relayout(g / n_shards, P(), u_spec, mesh)
        g = reduce_scatter(g, data_axes, axis=dim) / n_shards
        src = P(*([None] * dim + [data_axes]))
        return _relayout(g, src, u_spec, mesh)

    def body(params, state, batch):
        whole = _map_specs(lambda s, x: _gather(x, s, mesh), p_specs, params)
        leaves = _map_leaves(lambda x: x.detach().requires_grad_(True),
                             whole)
        flat = []
        _map_leaves(flat.append, leaves)
        with torch.enable_grad():
            loss = loss_fn(leaves, batch)
            grads = torch.autograd.grad(loss, flat)
        loss = loss.detach()
        if data_axes:
            loss = allreduce(loss, data_axes)
        loss = loss / n_shards
        it = iter(grads)
        grads = _map_leaves(lambda _: next(it), leaves)
        g_tree = g_specs if g_specs is not None else p_specs
        g_u = _map_specs(lambda u, g, gs: combine(g, u, gs), u_specs,
                         grads, g_tree)
        p_u = _map_specs(lambda u, x: _local(x.detach(), u, mesh,
                                             current_shard().coords),
                         u_specs, whole)
        del whole, leaves, flat, grads
        p_u, state = sgd_update(p_u, g_u, lr, momentum, state)
        params = _map_specs(lambda u, ps, x: _relayout(x, u, ps, mesh),
                            u_specs, p_specs, p_u)
        return params, state, loss

    def step(params, opt_state, batch):
        args = [(_map_specs(lambda s, x, c=c: _local(x, s, mesh, c),
                            p_specs, params),
                 None if o_specs is None else _map_specs(
                     lambda s, x, c=c: _local(x, s, mesh, c), o_specs,
                     opt_state),
                 _map_specs(lambda s, x, c=c: _local(
                     torch.as_tensor(x) if not isinstance(x, Sharded)
                     else x, s, mesh, c), batch_specs, batch))
                for c in mesh.positions()]
        try:
            results = run_shards(mesh, body, args)
        except Exception as e:
            # the seam where a sharded step's OOM lands: the memory
            # postmortem (per-position census) before it propagates
            _mem.maybe_oom_postmortem(e, source="sharded_train_step")
            raise
        step.last_collectives = dict(mesh.last_collectives)
        step.last_collective_log = mesh.last_collective_log
        del args
        if donate:
            for tree in (params, opt_state):
                _map_leaves(lambda x: x.delete() if isinstance(x, Sharded)
                            else None, tree)
        new_p = _map_specs(lambda s, *parts: Sharded.from_locals(
            mesh, s, parts), p_specs, *[r[0] for r in results])
        new_s = None if o_specs is None else _map_specs(
            lambda s, *parts: Sharded.from_locals(mesh, s, parts), o_specs,
            *[r[1] for r in results])
        loss = results[0][2]
        if _mem.census_enabled():
            # fresh values every step: re-stamp their census roles
            _mem.tag_tree(new_p, "parameter")
            _mem.tag_tree(new_s, "optimizer_state")
        if _health.enabled():
            # the loss is already combined over the batch's axes: one
            # count covers every position; folded at the boundary
            _health.check_scalar("sharded_train_step", loss)
            _health.observe_loss(loss)
            _health.step_boundary("sharded_train_step")
        return new_p, new_s, loss

    step.last_collectives = {}
    step.last_collective_log = {}
    _mem.tag_tree(params0, "parameter")
    _mem.tag_tree(opt0, "optimizer_state")
    return step, params0, opt0


def make_zero_train_step(loss_fn, mesh, param_example, batch_example,
                         batch_specs=P("dp"), lr=0.01, momentum=0.9,
                         dp_axis="dp", donate=True, stage=1):
    """ZeRO over the data-parallel axis (Rajbhandari et al. 2020):
    the leaves :func:`~.layout.zero_shard_leaf` admits are sharded over
    ``dp_axis`` by ``SpecLayout(data_axis=dp_axis).zero_specs``.

    - ``stage=1``: the momentum held as ``dp`` slices; the gradient
      all-reduced whole, each position updating its slice, the
      parameters all-gathered from the slices;
    - ``stage=2``: the gradient reduce-scattered, so each position keeps
      only its slice of it;
    - ``stage=3``: the parameters held as ``dp`` slices at rest and
      gathered on use inside the step, the gradient reduce-scattered;
      the update stays on the slices.

    The stages change the layout, not the arithmetic: their parameters
    and losses are the replicated step's bits."""
    if momentum is None:
        raise ValueError("ZeRO shards optimizer state; momentum must not "
                         "be None (stateless SGD has nothing to shard — "
                         "use make_sharded_train_step)")
    if stage not in (1, 2, 3):
        raise ValueError(f"ZeRO stage must be 1, 2, or 3, got {stage}")
    dp = mesh.shape[dp_axis]
    sharded = SpecLayout(data_axis=dp_axis).zero_specs(
        param_example, dp, axis=dp_axis)
    return make_sharded_train_step(
        loss_fn, mesh, param_example, batch_example,
        batch_specs=batch_specs, lr=lr, momentum=momentum, donate=donate,
        param_specs=sharded if stage >= 3 else None,
        state_specs=None if stage >= 3 else sharded,
        grad_specs=sharded if stage == 2 else None)
