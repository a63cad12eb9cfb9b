"""The MultiBox family of SSD (the port of the first half of
``mxnet_tpu/ops/detection.py``; ref: src/operator/contrib/
multibox_prior.cc, multibox_target.cc, multibox_detection.cc).

Everything keeps the JAX package's static shapes and is batched over
the images where the JAX package maps one image with ``jax.vmap``:

- ``MultiBoxTarget``'s greedy bipartite matching runs its M rounds of a
  global argmax (the first maximum on a tie, as ``jnp.argmax``) over
  every image at once, with no host read; hard negatives are ranked by
  a stable sort, as ``jnp.argsort``;
- ``MultiBoxDetection`` decodes the boxes and hands them to
  ``box_nms`` (``ops/contrib.py``).

The rest of the JAX module (``Proposal``, ``PSROIPooling``,
``DeformableConvolution``, ``GridGenerator``, ``BilinearSampler``,
``SpatialTransformer``) is not ported yet."""
from __future__ import annotations

import torch

from .contrib import box_nms
from .registry import register

_F32 = torch.float32


@register("_contrib_MultiBoxPrior", aliases=("MultiBoxPrior",))
def multibox_prior(data, sizes=(1.0,), ratios=(1.0,), clip=False,
                   steps=(-1.0, -1.0), offsets=(0.5, 0.5)):
    """Anchor boxes per feature-map pixel, (1, H * W * A, 4) corners
    (ref: contrib/multibox_prior.cc MultiBoxPriorForward)."""
    H, W = data.shape[2], data.shape[3]
    dev = data.device
    sizes = tuple(float(s) for s in sizes)
    ratios = tuple(float(r) for r in ratios)
    step_y = steps[0] if steps[0] > 0 else 1.0 / H
    step_x = steps[1] if steps[1] > 0 else 1.0 / W
    cy = (torch.arange(H, dtype=_F32, device=dev) + offsets[0]) * step_y
    cx = (torch.arange(W, dtype=_F32, device=dev) + offsets[1]) * step_x
    whs = [(s * H / W / 2.0, s / 2.0) for s in sizes]   # ratio 1
    for r in ratios[1:]:                   # sizes[0], the other ratios
        sr = r ** 0.5
        whs.append((sizes[0] * H / W * sr / 2.0, sizes[0] / sr / 2.0))
    wh = torch.tensor(whs, dtype=_F32, device=dev)  # (A, 2) half (w, h)
    x = cx[None, :, None].expand(H, W, 1)
    y = cy[:, None, None].expand(H, W, 1)
    out = torch.stack([x - wh[:, 0], y - wh[:, 1], x + wh[:, 0],
                       y + wh[:, 1]], -1).reshape(1, -1, 4)
    if clip:
        out = torch.clamp(out, 0.0, 1.0)
    return out


def _iou_matrix(anchors, gt):
    """anchors (N, 4), gt (B, M, 4) corner boxes -> (B, N, M) IoU."""
    tl = torch.maximum(anchors[None, :, None, :2], gt[:, None, :, :2])
    br = torch.minimum(anchors[None, :, None, 2:4], gt[:, None, :, 2:4])
    wh = torch.clamp(br - tl, min=0)
    inter = wh[..., 0] * wh[..., 1]
    a = ((anchors[:, 2] - anchors[:, 0])
         * (anchors[:, 3] - anchors[:, 1]))[None, :, None]
    b = ((gt[..., 2] - gt[..., 0]) * (gt[..., 3] - gt[..., 1]))[:, None, :]
    union = a + b - inter
    return torch.where(union > 0, inter / union, torch.zeros_like(union))


def _set_at(t, idx, value):
    """``t[b, idx[b]] = value[b]`` for every row b."""
    t.scatter_(1, idx[:, None], value[:, None].to(t.dtype))


def _match(iou):
    """Stage 1 of MultiBoxTarget: M rounds of the best still-unmatched
    (anchor, gt) pair of each image. Returns (match (B, N) int64 gt index
    or -1, anchors still unmatched (B, N))."""
    B, N, M = iou.shape
    match = torch.full((B, N), -1, dtype=torch.int64, device=iou.device)
    amask = torch.ones((B, N), dtype=torch.bool, device=iou.device)
    gmask = torch.ones((B, M), dtype=torch.bool, device=iou.device)
    neg = torch.full_like(iou, -1.0)
    for _ in range(M):
        m = torch.where(amask[:, :, None] & gmask[:, None, :], iou, neg)
        flat = m.reshape(B, -1)
        best = torch.argmax(flat, dim=1)
        ok = torch.gather(flat, 1, best[:, None])[:, 0] > 1e-6
        bi, bk = best // M, best % M
        _set_at(match, bi, torch.where(ok, bk, match.gather(1, bi[:, None])
                                       [:, 0]))
        _set_at(amask, bi, amask.gather(1, bi[:, None])[:, 0] & ~ok)
        _set_at(gmask, bk, gmask.gather(1, bk[:, None])[:, 0] & ~ok)
    return match, amask


def _corner_center(b):
    """(x, y, w, h) of corner boxes (..., 4) (widths as given)."""
    return ((b[..., 0] + b[..., 2]) / 2, (b[..., 1] + b[..., 3]) / 2,
            b[..., 2] - b[..., 0], b[..., 3] - b[..., 1])


@register("_contrib_MultiBoxTarget", aliases=("MultiBoxTarget",),
          num_outputs=3)
def multibox_target(anchors, labels, cls_preds, overlap_threshold=0.5,
                    ignore_label=-1.0, negative_mining_ratio=-1.0,
                    negative_mining_thresh=0.5,
                    minimum_negative_samples=0,
                    variances=(0.1, 0.1, 0.2, 0.2)):
    """Assign anchors to ground truths
    (ref: contrib/multibox_target.cc MultiBoxTargetForward).

    anchors (1, N, 4); labels (B, M, 5) rows [cls, x1, y1, x2, y2] with
    cls=-1 padding; cls_preds (B, num_classes, N).
    Returns loc_target (B, N*4), loc_mask (B, N*4), cls_target (B, N).
    """
    anc = anchors.reshape(-1, 4)
    N = anc.shape[0]
    B, M = labels.shape[0], labels.shape[1]
    vx, vy, vw, vh = (float(v) for v in variances)
    valid_gt = labels[:, :, 0] >= 0
    iou = _iou_matrix(anc, labels[:, :, 1:5])
    iou = torch.where(valid_gt[:, None, :], iou, torch.full_like(iou, -1.0))
    match, amask = _match(iou)

    # stage 2: remaining anchors match their best gt above threshold
    best_gt = torch.argmax(iou, dim=2)
    best_iou = torch.amax(iou, dim=2)
    thr_ok = amask & (best_iou > overlap_threshold) \
        & (overlap_threshold > 0)
    match = torch.where(thr_ok, best_gt, match)

    pos = match >= 0
    mg = torch.clamp(match, 0, M - 1)
    gt = torch.gather(labels, 1, mg[:, :, None].expand(B, N, 5))

    # location targets in variance-normalized center form
    ax, ay, aw, ah = _corner_center(anc)
    gx = (gt[..., 1] + gt[..., 3]) / 2
    gy = (gt[..., 2] + gt[..., 4]) / 2
    gw = torch.clamp(gt[..., 3] - gt[..., 1], min=1e-12)
    gh = torch.clamp(gt[..., 4] - gt[..., 2], min=1e-12)
    aw = torch.clamp(aw, min=1e-12)
    ah = torch.clamp(ah, min=1e-12)
    tx = (gx - ax) / aw / vx
    ty = (gy - ay) / ah / vy
    tw = torch.log(gw / aw) / vw
    th = torch.log(gh / ah) / vh
    loc_t = torch.stack([tx, ty, tw, th], -1) * pos[:, :, None].to(_F32)
    loc_m = pos[:, :, None].expand(B, N, 4).to(_F32)

    cls_t = torch.where(pos, gt[..., 0].to(torch.int32) + 1,
                        torch.zeros_like(match, dtype=torch.int32))
    if negative_mining_ratio > 0:
        # hard negative mining: keep the highest-scoring negatives (max
        # non-background prob), the rest become ignore_label
        neg_ok = ~pos & (best_iou < negative_mining_thresh)
        max_p = torch.amax(cls_preds[:, 1:], dim=1)  # skip background
        key = torch.where(neg_ok, max_p,
                          torch.full_like(max_p, -float("inf")))
        order = torch.argsort(-key, dim=1, stable=True)
        rank = torch.empty_like(order).scatter_(
            1, order, torch.arange(N, device=order.device).expand(B, N))
        n_pos = pos.to(torch.int32).sum(dim=1)
        n_neg = torch.minimum(
            torch.clamp((n_pos * negative_mining_ratio).to(torch.int32),
                        min=int(minimum_negative_samples)),
            N - n_pos)
        keep_neg = neg_ok & (rank < n_neg[:, None])
        cls_t = torch.where(
            pos, cls_t,
            torch.where(keep_neg, torch.zeros_like(cls_t),
                        torch.full_like(cls_t, int(ignore_label))))
    return loc_t.reshape(B, -1), loc_m.reshape(B, -1), cls_t.to(_F32)


def decode_detections(cls_prob, loc_pred, anchors, clip=True,
                      threshold=0.01, background_id=0,
                      variances=(0.1, 0.1, 0.2, 0.2)):
    """MultiBoxDetection before its NMS: (B, N, 6) rows [cls_id, score,
    x1, y1, x2, y2] of each anchor's best non-background class, its
    score and its decoded box; cls_id and score -1 below ``threshold``."""
    anc = anchors.reshape(-1, 4)
    N = anc.shape[0]
    B, C = cls_prob.shape[0], cls_prob.shape[1]
    vx, vy, vw, vh = (float(v) for v in variances)
    ax, ay, aw, ah = _corner_center(anc)
    p = loc_pred.reshape(B, N, 4)
    ox = p[..., 0] * vx * aw + ax
    oy = p[..., 1] * vy * ah + ay
    ow = torch.exp(p[..., 2] * vw) * aw / 2
    oh = torch.exp(p[..., 3] * vh) * ah / 2
    boxes = torch.stack([ox - ow, oy - oh, ox + ow, oy + oh], -1)
    if clip:
        boxes = torch.clamp(boxes, 0.0, 1.0)
    masked = cls_prob
    if 0 <= background_id < C:
        masked = cls_prob.clone()
        masked[:, background_id] = -float("inf")
    cls = torch.argmax(masked, dim=1)
    score = torch.amax(masked, dim=1)
    # class ids shift down past background (reference convention)
    out_id = torch.where(cls > background_id, cls - 1, cls).to(_F32)
    keep = score > threshold
    out_id = torch.where(keep, out_id, torch.full_like(out_id, -1.0))
    score = torch.where(keep, score, torch.full_like(score, -1.0))
    return torch.cat([out_id[..., None], score[..., None], boxes], -1)


@register("_contrib_MultiBoxDetection", aliases=("MultiBoxDetection",))
def multibox_detection(cls_prob, loc_pred, anchors, clip=True,
                       threshold=0.01, background_id=0,
                       nms_threshold=0.5, force_suppress=False,
                       variances=(0.1, 0.1, 0.2, 0.2), nms_topk=-1):
    """Decode predictions into detections + NMS
    (ref: contrib/multibox_detection.cc). Output (B, N, 6) rows
    [cls_id, score, x1, y1, x2, y2]; pruned entries have cls_id=-1."""
    dets = decode_detections(cls_prob, loc_pred, anchors, clip=clip,
                             threshold=threshold,
                             background_id=background_id,
                             variances=variances)
    out = box_nms(dets, overlap_thresh=nms_threshold, valid_thresh=0.0,
                  topk=nms_topk, coord_start=2, score_index=1, id_index=0,
                  background_id=-1, force_suppress=force_suppress)
    # reference marks suppressed rows by cls_id = -1
    # (multibox_detection-inl.h NMS loop)
    out = out.clone()
    out[..., 0] = torch.where(out[..., 1] < 0,
                              torch.full_like(out[..., 0], -1.0),
                              out[..., 0])
    return out
