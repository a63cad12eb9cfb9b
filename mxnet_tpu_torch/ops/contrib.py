"""The contrib ops the port reaches (the counterpart of
``mxnet_tpu/ops/contrib.py``): ``_contrib_flash_attention``, and the
box ops of the detectors, ``box_iou`` and ``box_nms``.

``box_nms`` keeps the JAX package's static shapes: the output has the
input's shape, rows sorted by score (a stable sort, as ``jnp.argsort``),
and a suppressed or invalid row gets score -1. Its greedy pass is
batched over the images and solved as a fixed point rather than one
candidate at a time: ``keep[i]`` is ``valid[i]`` unless an earlier kept
row overlaps it, a triangular system with one solution, which Jacobi
sweeps reach in at most n sweeps (each sweep fixes at least the next
row). A sweep is a handful of tensor ops over all images, and the host
reads one flag a sweep to stop, never one a candidate."""
from __future__ import annotations

import torch

from .attention import flash_attention as _flash_attention
from .registry import register


@register("_contrib_flash_attention", aliases=("flash_attention",))
def contrib_flash_attention(q, k, v, causal=False, scale=None):
    """Blockwise attention softmax(scale * Q K^T [causal]) V over
    (B, H, T, D) or (BH, T, D), differentiable under ``autograd.record``
    (:func:`~mxnet_tpu_torch.ops.attention.flash_attention`), in the
    inputs' type (float32, or bfloat16 for a cast block: the bf16
    kernels, output and gradients bf16). On a CUDA
    device it always launches the hand-written kernels: below
    ``FLASH_MIN_SEQ`` tokens the JAX package dispatches to its dense
    path instead, which computes the same function."""
    return _flash_attention(q, k, v, causal=bool(causal), scale=scale)


def box_iou_corner(b1, b2):
    """IoU between (..., N, 4) and (..., M, 4) corner boxes."""
    tl = torch.maximum(b1[..., :, None, :2], b2[..., None, :, :2])
    br = torch.minimum(b1[..., :, None, 2:4], b2[..., None, :, 2:4])
    wh = torch.clamp(br - tl, min=0)
    inter = wh[..., 0] * wh[..., 1]
    a1 = torch.clamp(b1[..., 2] - b1[..., 0], min=0) \
        * torch.clamp(b1[..., 3] - b1[..., 1], min=0)
    a2 = torch.clamp(b2[..., 2] - b2[..., 0], min=0) \
        * torch.clamp(b2[..., 3] - b2[..., 1], min=0)
    return inter / torch.clamp(a1[..., :, None] + a2[..., None, :] - inter,
                               min=1e-12)


def _center_to_corner(b):
    xy, wh = b[..., :2], b[..., 2:4] / 2
    return torch.cat([xy - wh, xy + wh], dim=-1)


@register("_contrib_box_iou", aliases=("box_iou",))
def box_iou(lhs, rhs, format="corner"):
    if format == "center":
        lhs, rhs = _center_to_corner(lhs), _center_to_corner(rhs)
    return box_iou_corner(lhs, rhs)


def greedy_keep(sup, valid):
    """The greedy NMS pass over rows in score order, for every image at
    once: ``sup`` (B, n, n) says row j suppresses row i (i > j only),
    ``valid`` (B, n) which rows take part. Row i is kept when valid and
    no earlier kept row suppresses it."""
    keep = valid
    for _ in range(valid.shape[-1]):
        hit = (sup & keep[:, :, None]).any(dim=1)
        new = valid & ~hit
        if torch.equal(new, keep):
            break
        keep = new
    return keep


@register("_contrib_box_nms", aliases=("box_nms", "_contrib_nms"))
def box_nms(data, overlap_thresh=0.5, valid_thresh=0.0, topk=-1,
            coord_start=2, score_index=1, id_index=-1, background_id=-1,
            force_suppress=False, in_format="corner", out_format="corner"):
    """Static-shape NMS: output has the input's shape; suppressed boxes
    get score -1 (the reference's convention for pruned entries)."""
    shape = data.shape
    flat = data.reshape((-1,) + tuple(shape[-2:]))
    scores = flat[..., score_index]
    valid = scores > valid_thresh
    if id_index >= 0 and background_id >= 0:
        valid = valid & (flat[..., id_index] != background_id)
    key = torch.where(valid, scores, torch.full_like(scores, -float("inf")))
    order = torch.argsort(-key, dim=-1, stable=True)
    out = torch.gather(flat, 1, order[:, :, None].expand_as(flat))
    if out.device.type == "meta":
        return out.reshape(shape)
    n = out.shape[1]
    sscores = out[..., score_index]
    svalid = torch.gather(valid, 1, order)
    if topk > 0:
        # reference semantics: only the topk highest-scoring candidates
        # take part in suppression at all (bounding_box-inl.h)
        svalid = svalid & (torch.arange(n, device=out.device) < topk)
    boxes = out[..., coord_start:coord_start + 4]
    if in_format == "center":
        boxes = _center_to_corner(boxes)
    iou = box_iou_corner(boxes, boxes)
    if not force_suppress and id_index >= 0:
        ids = out[..., id_index]
        iou = torch.where(ids[:, :, None] == ids[:, None, :], iou,
                          torch.zeros_like(iou))
    later = torch.ones(n, n, dtype=torch.bool, device=out.device).triu(1)
    keep = greedy_keep((iou > overlap_thresh) & later, svalid)
    out = out.clone()
    out[..., score_index] = torch.where(keep, sscores,
                                        torch.full_like(sscores, -1.0))
    return out.reshape(shape)
