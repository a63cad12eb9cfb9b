"""Gluon utilities (the port of ``mxnet_tpu/gluon/utils.py``), plus
:func:`params_from_jax` and :func:`updater_states_from_jax`, which carry
weights and optimizer states from the JAX package.
``download`` is left out: the port fetches nothing."""
from __future__ import annotations

import warnings

import numpy as np
import torch

from ..base import MXNetError
from ..context import dp_mesh, resolve_device
from ..ndarray.ndarray import NDArray, array


def split_data(data, num_slice, batch_axis=0, even_split=True):
    """``num_slice`` slices of ``data`` along ``batch_axis``; the last
    takes the remainder unless ``even_split`` demands equal slices."""
    size = data.shape[batch_axis]
    if even_split and size % num_slice != 0:
        raise MXNetError(
            f"cannot evenly split batch of {size} into {num_slice} slices")
    step = size // num_slice
    t = data._data if isinstance(data, NDArray) else torch.as_tensor(data)
    slices = []
    for i in range(num_slice):
        end = (i + 1) * step if i < num_slice - 1 else size
        slices.append(NDArray(t.narrow(batch_axis, i * step, end - i * step)))
    return slices


def split_and_load(data, ctx_list, batch_axis=0, even_split=True):
    """Lay the batch out across the contexts (the JAX package's rule).

    Where the contexts form a dp mesh (``context.dp_mesh``: no context
    repeated) and the batch divides over it, a one-element list: the
    whole batch, so the usual ``for x in split_and_load(...)`` loop runs
    one forward and one backward over it, the one program the JAX
    package runs over its mesh. The port's gluon Parameter lives on one
    device, so the mesh's positions must resolve to one torch device
    (``cpu(i)`` all do): positions on distinct devices (several cards)
    raise. Otherwise (a repeated context, or a batch that does not
    divide and ``even_split`` is False) one slice per context, each
    moved there, as the reference slices; one context gets the whole
    batch."""
    if not isinstance(data, NDArray):
        data = array(data, ctx=ctx_list[0])
    if len(ctx_list) == 1:
        return [data.as_in_context(ctx_list[0])]
    uneven = data.shape[batch_axis] % len(ctx_list) != 0
    if even_split and uneven:
        raise MXNetError(
            f"cannot evenly split batch of {data.shape[batch_axis]} "
            f"across {len(ctx_list)} devices")
    mesh = None if uneven else dp_mesh(ctx_list)
    if mesh is None:
        slices = split_data(data, len(ctx_list), batch_axis, even_split)
        return [s.as_in_context(ctx) for s, ctx in zip(slices, ctx_list)]
    devices = {str(d) for d in mesh.devices.flat}
    if len(devices) > 1:
        raise MXNetError(
            f"split_and_load over a dp mesh of {sorted(devices)}: gluon "
            "over several cards is not ported (ROADMAP queue 1 item 5); a "
            "gluon Parameter lives on one device, so the positions of the "
            "mesh must share one (train over several cards with Module or "
            "parallel.make_sharded_train_step)")
    return [data.as_in_context(mesh.devices.flat[0])]


def clip_global_norm(arrays, max_norm, check_isfinite=True):
    """Rescale ``arrays`` in place so their joint L2 norm is at most
    ``max_norm``; returns the norm before clipping. As in the JAX
    package, each array's sum of squares is an f32 ``nd`` reduction read
    back to the host, and the scaling goes through ``nd`` too (recorded
    when called under ``autograd.record()``)."""
    total = 0.0
    for a in arrays:
        total += float((a * a).sum().asscalar())
    total = float(np.sqrt(total))
    if check_isfinite and not np.isfinite(total):
        warnings.warn("nan or inf found in gradients")
    scale = max_norm / (total + 1e-8)
    if scale < 1.0:
        for a in arrays:
            a *= scale
    return total


def params_from_jax(net, arrays, ctx=None):
    """Set the parameters of the port's block ``net`` from the JAX
    package's, given as ``{full name: numpy array}`` (what the JAX
    block's ``collect_params()`` gives through ``asnumpy()``), on
    ``ctx`` (``cuda:0`` when None). Every parameter of ``net`` must be
    in ``arrays`` and no name may be left over; shapes must agree.
    Returns ``net``."""
    device = resolve_device(ctx)
    params = net.collect_params()
    missing = sorted(set(params.keys()) - set(arrays))
    extra = sorted(set(arrays) - set(params.keys()))
    if missing or extra:
        raise MXNetError(f"params_from_jax: names differ; missing "
                         f"{missing[:5]}, extra {extra[:5]}")
    for name, p in params.items():
        value = torch.from_numpy(np.array(arrays[name]))
        if not p._shape_incomplete() and tuple(value.shape) != p.shape:
            raise MXNetError(f"params_from_jax: {name} has shape "
                             f"{tuple(value.shape)}, the port's {p.shape}")
        p._data, p._device = None, device
        p.set_data(value)
    return net


def _state_np(state):
    if state is None:
        return None
    if isinstance(state, tuple):
        return tuple(_state_np(s) for s in state)
    value = np.asarray(state.asnumpy())
    if value.dtype.kind == "V" or str(value.dtype) == "bfloat16":
        value = value.astype(np.float32)   # numpy has no bf16 of its own
    return value


def updater_states_from_jax(jax_updater):
    """The states of the JAX package's ``optimizer.Updater`` as numpy
    trees, by index, for the port's ``Updater.states`` (it puts each on
    its weight's device at the first update of the index). bf16 states
    come over as fp32; fp32 master copies stay fp32. The optimizer's
    update counts travel separately (``_index_update_count``,
    ``num_update``)."""
    return {k: _state_np(v) for k, v in jax_updater.states.items()}
