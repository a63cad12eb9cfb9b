"""Legacy multi-device execution helpers (the port of
``mxnet_tpu/executor_manager.py``; ref: python/mxnet/executor_manager.py,
the pre-Module data-parallel machinery): ``_split_input_slice`` remains
a public helper old training scripts import."""
from __future__ import annotations

from .base import MXNetError


def _split_input_slice(batch_size, work_load_list):
    """Slice a batch across devices proportionally to work loads
    (ref: executor_manager.py:33 _split_input_slice)."""
    total = sum(work_load_list)
    if total <= 0:
        raise MXNetError("Invalid workload")
    slices = []
    start = 0
    for i, load in enumerate(work_load_list):
        if i == len(work_load_list) - 1:
            end = batch_size
        else:
            end = start + int(round(batch_size * load / total))
        if end > batch_size or end <= start:
            raise MXNetError(
                "Too many slices: some splits are empty for batch "
                "size %d" % batch_size)
        slices.append(slice(start, end))
        start = end
    return slices


def _check_arguments(symbol):
    """Reject duplicate argument/aux names (ref: executor_manager.py
    _check_arguments)."""
    names = symbol.list_arguments()
    if len(set(names)) != len(names):
        dup = sorted(n for n in set(names) if names.count(n) > 1)
        raise MXNetError(f"Find duplicated argument name {dup}")
    aux = symbol.list_auxiliary_states()
    if len(set(aux)) != len(aux):
        dup = sorted(n for n in set(aux) if aux.count(n) > 1)
        raise MXNetError(f"Find duplicated auxiliary name {dup}")
