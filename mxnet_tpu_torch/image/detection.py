"""Detection-aware augmenters and ImageDetIter (ref:
python/mxnet/image/detection.py and src/io/image_det_aug_default.cc;
the port of ``mxnet_tpu/image/detection.py``): augmentations keep the
bounding boxes consistent with the pixels.

Labels are (N, 5+) rows [cls, x1, y1, x2, y2] with coordinates
normalized to [0, 1]; padding rows have cls = -1. The random choices
draw from Python's ``random`` module, as the JAX package's do.
"""
from __future__ import annotations

import random

import numpy as np

from ..base import MXNetError
from ..io.io import DataBatch, DataDesc
from ..ndarray import array
from .image import (Augmenter, CastAug, ForceResizeAug, ImageIter,
                    color_normalize)


class DetAugmenter(Augmenter):
    """Augmenter over (src, label) pairs."""

    def __call__(self, src, label):
        raise NotImplementedError


class DetBorderAug(DetAugmenter):
    """Pad to square with a fill value, rescaling boxes
    (ref: detection.py DetBorderAug)."""

    def __init__(self, fill=127):
        super().__init__(fill=fill)
        self.fill = fill

    def __call__(self, src, label):
        h, w = src.shape[:2]
        s = max(h, w)
        out = np.full((s, s, src.shape[2]), self.fill, src.dtype)
        dy, dx = (s - h) // 2, (s - w) // 2
        out[dy:dy + h, dx:dx + w] = src
        lab = label.copy()
        valid = lab[:, 0] >= 0
        lab[valid, 1] = (lab[valid, 1] * w + dx) / s
        lab[valid, 3] = (lab[valid, 3] * w + dx) / s
        lab[valid, 2] = (lab[valid, 2] * h + dy) / s
        lab[valid, 4] = (lab[valid, 4] * h + dy) / s
        return out, lab


class DetHorizontalFlipAug(DetAugmenter):
    def __init__(self, p=0.5):
        super().__init__(p=p)
        self.p = p

    def __call__(self, src, label):
        if random.random() < self.p:
            src = src[:, ::-1]
            lab = label.copy()
            valid = lab[:, 0] >= 0
            x1 = lab[valid, 1].copy()
            lab[valid, 1] = 1.0 - lab[valid, 3]
            lab[valid, 3] = 1.0 - x1
            return src, lab
        return src, label


class DetRandomCropAug(DetAugmenter):
    """Random crop keeping sufficient object overlap
    (ref: detection.py DetRandomCropAug min_object_covered)."""

    def __init__(self, min_object_covered=0.3, min_crop_scale=0.3,
                 max_attempts=20):
        super().__init__(min_object_covered=min_object_covered)
        self.min_object_covered = min_object_covered
        self.min_crop_scale = min_crop_scale
        self.max_attempts = max_attempts

    def __call__(self, src, label):
        h, w = src.shape[:2]
        valid = label[:, 0] >= 0
        for _ in range(self.max_attempts):
            scale = random.uniform(self.min_crop_scale, 1.0)
            cw, ch = int(w * scale), int(h * scale)
            x0 = random.randint(0, w - cw)
            y0 = random.randint(0, h - ch)
            cx1, cy1 = x0 / w, y0 / h
            cx2, cy2 = (x0 + cw) / w, (y0 + ch) / h
            lab = label.copy()
            keep = valid.copy()
            for i in np.where(valid)[0]:
                bx1, by1, bx2, by2 = label[i, 1:5]
                ix1, iy1 = max(bx1, cx1), max(by1, cy1)
                ix2, iy2 = min(bx2, cx2), min(by2, cy2)
                inter = max(ix2 - ix1, 0) * max(iy2 - iy1, 0)
                area = max((bx2 - bx1) * (by2 - by1), 1e-12)
                if inter / area < self.min_object_covered:
                    keep[i] = False
                    continue
                lab[i, 1] = (max(bx1, cx1) - cx1) / (cx2 - cx1)
                lab[i, 3] = (min(bx2, cx2) - cx1) / (cx2 - cx1)
                lab[i, 2] = (max(by1, cy1) - cy1) / (cy2 - cy1)
                lab[i, 4] = (min(by2, cy2) - cy1) / (cy2 - cy1)
            if keep.any() or not valid.any():
                lab[~keep] = -1
                return src[y0:y0 + ch, x0:x0 + cw], lab
        return src, label


def CreateDetAugmenter(data_shape, resize=0, rand_crop=0,
                       rand_mirror=False, mean=None, std=None,
                       rand_pad=0, fill_value=127,
                       min_object_covered=0.3, inter_method=2):
    """Detection augmenter list (ref: detection.py CreateDetAugmenter)."""
    auglist = []
    if rand_pad > 0:
        auglist.append(_WithProb(DetBorderAug(fill_value), rand_pad))
    if rand_crop > 0:
        auglist.append(_WithProb(
            DetRandomCropAug(min_object_covered), rand_crop))
    if rand_mirror:
        auglist.append(DetHorizontalFlipAug(0.5))
    auglist.append(_ImgOnly(ForceResizeAug(
        (data_shape[2], data_shape[1]), inter_method)))
    auglist.append(_ImgOnly(CastAug()))
    if mean is True:
        mean = np.array([123.68, 116.28, 103.53])
    if std is True:
        std = np.array([58.395, 57.12, 57.375])
    if mean is not None:
        class _Norm(DetAugmenter):
            def __call__(self, src, label):
                return color_normalize(src, mean, std), label
        auglist.append(_Norm())
    return auglist


class _ImgOnly(DetAugmenter):
    def __init__(self, aug):
        super().__init__()
        self.aug = aug

    def __call__(self, src, label):
        return self.aug(src), label


class _WithProb(DetAugmenter):
    def __init__(self, aug, p):
        super().__init__()
        self.aug = aug
        self.p = p

    def __call__(self, src, label):
        if random.random() < self.p:
            return self.aug(src, label)
        return src, label


class ImageDetIter(ImageIter):
    """Detection iterator: labels are (max_objects, 5) box matrices
    (ref: detection.py ImageDetIter). Batches are made on the current
    context."""

    def __init__(self, batch_size, data_shape, path_imgrec=None,
                 path_imglist=None, path_root="", shuffle=False,
                 aug_list=None, imglist=None, max_objects=8, **kwargs):
        self.max_objects = max_objects
        if aug_list is None:
            aug_list = CreateDetAugmenter(data_shape, **kwargs)
        super().__init__(batch_size, data_shape, label_width=1,
                         path_imgrec=path_imgrec,
                         path_imglist=path_imglist, path_root=path_root,
                         shuffle=shuffle, aug_list=aug_list,
                         imglist=imglist)

    @property
    def provide_label(self):
        return [DataDesc("label",
                         (self.batch_size, self.max_objects, 5))]

    def _pad_label(self, label):
        flat = np.asarray(label, np.float32).reshape(-1)
        if flat.size % 5:
            raise MXNetError(
                f"detection label length {flat.size} not divisible by 5 "
                "(rows are [cls, x1, y1, x2, y2])")
        rows = flat.reshape(-1, 5)[:self.max_objects]
        out = np.full((self.max_objects, 5), -1.0, np.float32)
        out[:rows.shape[0]] = rows
        return out

    def next(self):
        imgs, labels = [], []
        pad = 0
        while len(imgs) < self.batch_size:
            try:
                label, img = self.next_sample()
            except StopIteration:
                if not imgs:
                    raise
                pad = self._pad_tail(imgs, labels, self.batch_size)
                break
            lab = self._pad_label(label)
            if img.ndim == 2:
                img = img[:, :, None].repeat(3, axis=2)
            for aug in self.auglist:
                img, lab = aug(img, lab)
            imgs.append(np.asarray(img, np.float32).transpose(2, 0, 1))
            labels.append(lab)
        return DataBatch(data=[array(np.stack(imgs))],
                         label=[array(np.stack(labels))], pad=pad)
