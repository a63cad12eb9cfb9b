"""Tensor (model) parallelism: Megatron-style column / row parallel
dense layers as :func:`~.mesh.shard_map`-level functions (counterpart of
``mxnet_tpu/parallel/tensor_parallel.py``).

Operands are in math convention ``(in, out)``, as the JAX functions
take them; the parameter specs come from the layout table's roles
(``mlp-in`` / ``attention-qkv`` column-parallel, ``mlp-out`` /
``attention-out`` row-parallel), transposed from its ``(out, in)``
weight convention.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .collectives import allreduce
from .mesh import PartitionSpec as P


def gelu(x):
    """``jax.nn.gelu``'s default, the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def column_parallel_dense(x, w, b=None):
    """y = x @ w with ``w`` sharded on its output (column) dim: no
    communication, the output stays feature-sharded. x: [..., Din]
    replicated; w: [Din, Dout_local]."""
    y = torch.matmul(x, w)
    if b is not None:
        y = y + b
    return y


def row_parallel_dense(x, w, b=None, axis_name="tp"):
    """y = allreduce_tp(x @ w) with ``w`` sharded on its input (row)
    dim. x: [..., Din_local] feature-sharded; w: [Din_local, Dout]. The
    bias is added once, after the allreduce."""
    y = allreduce(torch.matmul(x, w), axis_name)
    if b is not None:
        y = y + b
    return y


def tp_mlp(x, w1, b1, w2, b2, axis_name="tp", act=gelu):
    """Two-layer MLP with the hidden dim sharded over ``axis_name``:
    column-parallel up-projection, nonlinearity, row-parallel
    down-projection with a single allreduce."""
    h = act(column_parallel_dense(x, w1, b1))
    return row_parallel_dense(h, w2, b2, axis_name=axis_name)


def _tp_only(spec, axis_name):
    """A table spec projected onto the lone tp axis a shard_map mesh
    carries (fsdp / data entries drop; multi-axis dims keep tp)."""
    out = []
    for entry in tuple(spec):
        axes = (entry,) if isinstance(entry, str) else tuple(entry or ())
        out.append(axis_name if axis_name in axes else None)
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def _math_spec(spec, axis_name):
    """An (out, in) table entry as the spec of an (in, out) operand."""
    e = _tp_only(spec, axis_name)
    e = e + (None,) * (2 - len(e))
    out = [e[1], e[0]]
    while out and out[-1] is None:
        out.pop()
    return P(*out)


def tp_mlp_param_specs(axis_name="tp", layout=None):
    """The (w1, b1, w2, b2) PartitionSpecs of :func:`tp_mlp`, read from
    the layout table (``mlp-in`` column-parallel, ``mlp-out``
    row-parallel); the column-parallel bias shards with the features it
    adds to."""
    from .layout import SpecLayout
    layout = layout or SpecLayout(tp_axis=axis_name)
    col = _tp_only(layout.spec_for("mlp_in_weight"), axis_name)
    return (_math_spec(layout.spec_for("mlp_in_weight"), axis_name),
            P(col[0] if col else None),
            _math_spec(layout.spec_for("mlp_out_weight"), axis_name),
            P(*_tp_only(layout.spec_for("bias"), axis_name)))


def tp_qkv_param_specs(axis_name="tp", layout=None):
    """(w_qkv, w_out) PartitionSpecs of a Megatron attention block in
    math convention (in, out), read from the table (``attention-qkv``
    column-parallel, ``attention-out`` row-parallel)."""
    from .layout import SpecLayout
    layout = layout or SpecLayout(tp_axis=axis_name)
    return (_math_spec(layout.spec_for("qkv_weight"), axis_name),
            _math_spec(layout.spec_for("out_proj_weight"), axis_name))
