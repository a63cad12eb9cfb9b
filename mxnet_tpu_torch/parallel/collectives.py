"""Named collectives for :func:`~.mesh.shard_map` bodies (counterpart of
``mxnet_tpu/parallel/collectives.py``: ``lax.psum``, ``all_gather``,
``psum_scatter``, ``all_to_all`` and ``ppermute`` over a mesh axis).

Each call meets the other shards of its group (the positions that
differ only along the named axes) at a rendezvous
(:func:`~.mesh.rendezvous`); ranks are row-major over the named axes,
as in JAX. Reductions are taken in rank order on rank 0's device, so a
run repeats its bits; every rank receives a tensor of its own (copied
to its device, even where ranks share one), never an alias of another
rank's.
"""
from __future__ import annotations

import torch

from .mesh import group_axes, rendezvous


def axis_size(axis_name):
    """Number of shards along ``axis_name`` (a name or a tuple)."""
    sh, axes = group_axes(axis_name)
    n = 1
    for a in axes:
        n *= sh.run.mesh.shape[a]
    return n


def axis_index(axis_name):
    """This shard's index along ``axis_name`` (row-major over a tuple),
    a Python int."""
    sh, axes = group_axes(axis_name)
    idx = 0
    for a in axes:
        idx = idx * sh.run.mesh.shape[a] + sh.coords[a]
    return idx


def _own(x, device, first):
    """Rank 0 keeps the combined tensor; every other rank a copy on its
    device."""
    return x if first else x.to(device, copy=True)


def _reduce(vals, fn):
    dev0 = vals[0].device
    acc = vals[0]
    for x in vals[1:]:
        acc = fn(acc, x.to(dev0))
    return acc


_OPS = {"sum": torch.add, "mean": torch.add, "max": torch.maximum,
        "min": torch.minimum}


def allreduce(x, axis_name, op="sum"):
    """``x`` reduced over ``axis_name`` with ``op`` (sum, mean, max or
    min), on every rank."""
    if op not in _OPS:
        raise ValueError(f"unknown allreduce op {op!r}")

    def combine(vals, devs):
        acc = _reduce(vals, _OPS[op])
        if op == "mean":
            acc = acc / len(vals)
        return [_own(acc, d, r == 0) for r, d in enumerate(devs)]
    return rendezvous(axis_name, x, combine, "allreduce")


def allgather(x, axis_name, axis=0, tiled=True):
    """The ranks' ``x`` concatenated (``tiled``) or stacked along
    ``axis`` in rank order, on every rank."""
    def combine(vals, devs):
        dev0 = vals[0].device
        parts = [v.to(dev0) for v in vals]
        full = torch.cat(parts, axis) if tiled else torch.stack(parts, axis)
        return [_own(full, d, r == 0) for r, d in enumerate(devs)]
    return rendezvous(axis_name, x, combine, "allgather")


def _split(x, axis, n):
    if x.shape[axis] % n:
        raise ValueError(f"dim {axis} of {tuple(x.shape)} does not split "
                         f"into {n}")
    c = x.shape[axis] // n
    return [x.narrow(axis, i * c, c) for i in range(n)]


def reduce_scatter(x, axis_name, axis=0):
    """The ranks' ``x`` summed (rank order), then split along ``axis``:
    rank r gets block r."""
    def combine(vals, devs):
        parts = _split(_reduce(vals, torch.add), axis, len(vals))
        return [p.to(d, copy=True) for p, d in zip(parts, devs)]
    return rendezvous(axis_name, x, combine, "reduce_scatter")


def alltoall(x, axis_name, split_axis, concat_axis):
    """Each rank splits ``x`` into one block per rank along
    ``split_axis``; rank r gets every rank's block r, concatenated along
    ``concat_axis`` in rank order."""
    def combine(vals, devs):
        blocks = [_split(v, split_axis, len(vals)) for v in vals]
        return [torch.cat([b[r].to(d) for b in blocks], concat_axis)
                for r, d in enumerate(devs)]
    return rendezvous(axis_name, x, combine, "alltoall")


def ppermute_next(x, axis_name, offset=1):
    """Rotate ``x`` to the next rank along ``axis_name`` (the ring
    step): rank i sends to rank (i + offset) mod size."""
    def combine(vals, devs):
        n = len(vals)
        return [vals[(r - offset) % n].to(d, copy=True)
                for r, d in enumerate(devs)]
    return rendezvous(axis_name, x, combine, "ppermute")

