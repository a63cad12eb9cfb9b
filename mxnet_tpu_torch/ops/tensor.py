"""The subset of ``mxnet_tpu/ops/tensor.py`` the port reaches: shape
ops (``Reshape`` with MXNet's special codes, ``transpose``, ``Cast``,
``slice_axis``), the reductions with ``axis`` / ``keepdims`` /
``exclude``, ``norm``, ``dot``, the indexing ops gluon's losses and
metrics call (``pick``, ``where``, ``Embedding``), and the joins and
flips of the data pipeline and the detectors (``stack``, ``Concat``,
``flip``)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..base import MXNetError
from .registry import register, torch_dtype


def embedding(data, weight):
    """Row lookup that clips indices to ``[0, vocab - 1]`` as the
    reference does; a bare ``F.embedding`` would raise on them."""
    idx = data.long().clamp(0, weight.shape[0] - 1)
    return F.embedding(idx, weight)


@register("Flatten", aliases=("flatten",))
def flatten(data):
    return data.reshape(data.shape[0], -1)


@register("Embedding")
def embedding_op(data, weight, input_dim=0, output_dim=0, dtype="float32",
                 sparse_grad=False):
    return embedding(data, weight)


@register("transpose")
def transpose(data, axes=()):
    axes = tuple(int(a) for a in axes) or tuple(range(data.ndim))[::-1]
    return data.permute(axes)


def infer_reshape(data_shape, target):
    """MXNet reshape special codes (ref: matrix_op-inl.h
    InferReshapeShape): 0 copies a dim, -1 infers one, -2 copies the
    rest, -3 merges two dims, -4 splits one into the next two codes."""
    out, src, target = [], list(data_shape), list(target)
    i = k = 0
    while k < len(target):
        t = target[k]
        if t == 0:
            out.append(src[i])
            i += 1
        elif t == -1:
            out.append(-1)
            i += 1
        elif t == -2:
            out.extend(src[i:])
            i = len(src)
        elif t == -3:
            out.append(src[i] * src[i + 1])
            i += 2
        elif t == -4:
            d1, d2 = target[k + 1], target[k + 2]
            cur = src[i]
            i += 1
            if d1 == -1 and d2 == -1:
                raise MXNetError("reshape -4: both split dims are -1")
            if d1 == -1:
                d1 = cur // d2
            if d2 == -1:
                d2 = cur // d1
            out.extend([d1, d2])
            k += 2
        else:
            out.append(t)
            i += 1
        k += 1
    if out.count(-1) > 1:
        raise MXNetError("reshape: more than one -1 dim")
    if -1 in out:
        known, total = 1, 1
        for d in out:
            if d != -1:
                known *= d
        for d in data_shape:
            total *= d
        out[out.index(-1)] = total // max(known, 1)
    return tuple(out)


@register("Reshape", aliases=("reshape",))
def reshape(data, shape=(), reverse=False):
    tgt = tuple(int(s) for s in shape)
    if reverse:
        return data.reshape(infer_reshape(data.shape[::-1], tgt[::-1])[::-1])
    return data.reshape(infer_reshape(data.shape, tgt))


@register("slice_axis")
def slice_axis(data, axis=0, begin=0, end=None):
    """``data[..., begin:end, ...]`` along ``axis`` (a view; its
    gradient scatters into zeros of the input's shape)."""
    sl = [slice(None)] * data.ndim
    sl[int(axis)] = slice(begin, end)
    return data[tuple(sl)]


@register("flip", aliases=("reverse",))
def flip(data, axis=0):
    ax = axis if isinstance(axis, (tuple, list)) else (axis,)
    return torch.flip(data, tuple(int(a) for a in ax))


@register("Concat", aliases=("concat",))
def concat(*args, dim=1, num_args=None):
    return torch.cat(args, dim=int(dim))


@register("stack")
def stack(*args, axis=0, num_args=None):
    return torch.stack(args, dim=int(axis))


@register("reshape_like")
def reshape_like(lhs, rhs):
    return lhs.reshape(rhs.shape)


@register("Cast", aliases=("cast",))
def cast(data, dtype="float32"):
    return data.to(torch_dtype(dtype), copy=True)


@register("expand_dims")
def expand_dims(data, axis=0):
    return data.unsqueeze(int(axis))


def reduce_axes(axis, ndim, exclude=False):
    """The axes a reduction takes: all for None or (), else ``axis``
    (negative allowed); with ``exclude``, every axis but those."""
    if axis is None or axis == ():
        ax = tuple(range(ndim))
    elif isinstance(axis, int):
        ax = (axis % ndim,)
    else:
        ax = tuple(int(a) % ndim for a in axis)
    if exclude:
        ax = tuple(i for i in range(ndim) if i not in ax)
    return ax


def _make_reduce(fn, name):
    def red(data, axis=None, keepdims=False, exclude=False):
        ax = reduce_axes(axis, data.ndim, exclude)
        if not ax:      # jnp reduces over no axis: the identity
            return data
        return fn(data, dim=ax, keepdim=bool(keepdims))

    red.__name__ = name
    return red


def _prod(data, dim, keepdim):
    for d in sorted(dim, reverse=True):
        data = torch.prod(data, dim=d, keepdim=keepdim)
    return data


for _n, _f in (("sum", torch.sum), ("mean", torch.mean), ("prod", _prod),
               ("max", torch.amax), ("min", torch.amin)):
    register(_n, aliases=("sum_axis",) if _n == "sum" else ())(
        _make_reduce(_f, _n))


@register("norm")
def norm(data, ord=2, axis=None, keepdims=False):
    dim = None if axis is None else (
        tuple(axis) if isinstance(axis, (tuple, list)) else (int(axis),))
    if dim is None:
        dim = tuple(range(data.ndim))
    if int(ord) == 1:
        return torch.sum(torch.abs(data), dim=dim, keepdim=bool(keepdims))
    return torch.sqrt(torch.sum(torch.square(data), dim=dim,
                                keepdim=bool(keepdims)))


def _rev(x):
    return x.permute(tuple(range(x.ndim))[::-1])


@register("dot")
def dot(lhs, rhs, transpose_a=False, transpose_b=False):
    """MXNet dot: the last axis of ``lhs`` against the first of ``rhs``
    (``.T`` reverses every axis, as ``jnp``'s does)."""
    a = _rev(lhs) if transpose_a else lhs
    b = _rev(rhs) if transpose_b else rhs
    if a.ndim == 1 and b.ndim == 1:
        return torch.dot(a, b)
    return torch.tensordot(a, b, dims=1)


@register("pick")
def pick(data, index, axis=-1, keepdims=False, mode="clip"):
    """``data`` at ``index`` along ``axis`` (indices clipped, or wrapped
    with ``mode="wrap"``)."""
    axis = int(axis) % data.ndim
    idx = index.long()
    if mode == "wrap":
        idx = torch.remainder(idx, data.shape[axis])
    else:
        idx = idx.clamp(0, data.shape[axis] - 1)
    out = torch.gather(data, axis, idx.unsqueeze(axis))
    return out if keepdims else out.squeeze(axis)


@register("where")
def where(condition, x, y):
    return torch.where(condition != 0, x, y)
