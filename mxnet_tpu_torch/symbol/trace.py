"""Trace a gluon HybridBlock into a Symbol graph: the export seam (the
port of ``mxnet_tpu/symbol/trace.py``)."""
from __future__ import annotations

from .symbol import Group, var


def trace_block(block, inputs=None, input_names=("data",)):
    """Run the block on Symbol placeholders; returns ``(out_sym,
    params)``, the parameters by full name. The block must have run on
    data once (or been through ``infer_shapes``), so that every
    parameter shape is known; parameters appear as variables named by
    their full prefixed names, as ``save`` / ``load_parameters`` use."""
    from ..gluon.block import _forward_state

    if inputs is None:
        inputs = [var(n) for n in input_names]
    elif not isinstance(inputs, (list, tuple)):
        inputs = [inputs]
    with _forward_state(trace=True):
        out = block(*inputs)
    if isinstance(out, (list, tuple)):
        out = Group(list(out))
    return out, dict(block.collect_params())
