"""Image loading and the augmenter zoo (the port of
``mxnet_tpu/image/image.py``; ref: python/mxnet/image/image.py, the
HSL / rotate / shear parameters from src/io/image_aug_default.cc).

All pixel work is numpy / PIL on the host (HWC, RGB), the JAX package's
arithmetic op for op, so both packages give the same bits. Functions
given an NDArray return one (a torch tensor inside): ``imdecode`` /
``imread`` on the current context (``cuda:0`` outside a ``with
mx.cpu():`` scope), the others on their input's context; given a numpy
array they return numpy. Each augmenter is a callable ``aug(src) ->
src`` over an HWC float32 numpy array, composable with SequentialAug /
RandomOrderAug; ``ImageIter`` decodes and augments on the host and
puts each batch on the current context once.
"""
from __future__ import annotations

import os
import random

import numpy as np

from ..base import MXNetError
from ..io.io import DataBatch, DataDesc, DataIter
from ..ndarray import NDArray, array


def _decode_np(buf, flag=1, to_rgb=True):
    """``imdecode``'s HWC uint8 numpy array: JPEGs through the native
    libjpeg decoder (RGB) where the host has it, other formats and
    hosts through PIL."""
    import io as _io

    a = None
    if flag:
        from .._native import decode_jpeg
        a = decode_jpeg(bytes(buf))
    if a is None:
        from PIL import Image
        img = Image.open(_io.BytesIO(bytes(buf)))
        img = img.convert("RGB" if flag else "L")
        a = np.asarray(img)
    if not flag:
        a = a[:, :, None]
    if flag and not to_rgb:
        a = a[:, :, ::-1]
    return a.astype(np.uint8)


def imdecode(buf, flag=1, to_rgb=True):
    """Decode an encoded image buffer into an HWC uint8 NDArray on the
    current context (ref: image.imdecode)."""
    return array(_decode_np(buf, flag, to_rgb))


def _read_np(filename, flag=1, to_rgb=True):
    with open(filename, "rb") as f:
        return _decode_np(f.read(), flag, to_rgb)


def imread(filename, flag=1, to_rgb=True):
    """Read an image file into an HWC uint8 NDArray (ref: image.imread)."""
    return array(_read_np(filename, flag, to_rgb))


def _host(src):
    return src.asnumpy() if isinstance(src, NDArray) else np.asarray(src)


def _like(out, src):
    """``out`` as ``src`` came: an NDArray on its context, or numpy."""
    if isinstance(src, NDArray):
        return array(out, ctx=src.context, dtype=out.dtype)
    return out


def imresize(src, w, h, interp=1):
    """Resize HWC image to (h, w) (ref: image.imresize)."""
    from PIL import Image
    a = _host(src)
    mode = {0: Image.NEAREST, 1: Image.BILINEAR, 2: Image.BICUBIC,
            3: Image.NEAREST, 4: Image.LANCZOS}.get(interp, Image.BILINEAR)
    img = Image.fromarray(a.astype(np.uint8).squeeze()
                          if a.shape[-1] == 1 else a.astype(np.uint8))
    out = np.asarray(img.resize((w, h), mode), dtype=a.dtype)
    if out.ndim == 2:
        out = out[:, :, None]
    return _like(out, src)


def scale_down(src_size, size):
    """Scale (w, h) down to fit within src_size (ref: image.scale_down)."""
    w, h = size
    sw, sh = src_size
    if sh < h:
        w, h = w * sh // h, sh
    if sw < w:
        w, h = sw, h * sw // w
    return w, h


def fixed_crop(src, x0, y0, w, h, size=None, interp=1):
    out = _host(src)[y0:y0 + h, x0:x0 + w]
    if size is not None and (w, h) != size:
        out = np.asarray(imresize(out, size[0], size[1], interp))
    return _like(out, src)


def random_crop(src, size, interp=1):
    a = _host(src)
    ih, iw = a.shape[:2]
    w, h = scale_down((iw, ih), size)
    x0 = random.randint(0, iw - w)
    y0 = random.randint(0, ih - h)
    out = fixed_crop(a, x0, y0, w, h, size, interp)
    return _like(out, src), (x0, y0, w, h)


def center_crop(src, size, interp=1):
    a = _host(src)
    ih, iw = a.shape[:2]
    w, h = scale_down((iw, ih), size)
    x0 = (iw - w) // 2
    y0 = (ih - h) // 2
    out = fixed_crop(a, x0, y0, w, h, size, interp)
    return _like(out, src), (x0, y0, w, h)


def color_normalize(src, mean, std=None):
    a = _host(src).astype(np.float32)
    if mean is not None:
        a = a - np.asarray(mean, np.float32)
    if std is not None:
        a = a / np.asarray(std, np.float32)
    return _like(a, src)


# ---------------------------------------------------------------------------
# augmenters — callables over HWC float32 numpy arrays
# ---------------------------------------------------------------------------

class Augmenter:
    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def dumps(self):
        import json
        return json.dumps([self.__class__.__name__.lower(), self._kwargs])

    def __call__(self, src):
        raise NotImplementedError


class SequentialAug(Augmenter):
    def __init__(self, ts):
        super().__init__()
        self.ts = ts

    def __call__(self, src):
        for t in self.ts:
            src = t(src)
        return src


class RandomOrderAug(Augmenter):
    def __init__(self, ts):
        super().__init__()
        self.ts = ts

    def __call__(self, src):
        ts = list(self.ts)
        random.shuffle(ts)
        for t in ts:
            src = t(src)
        return src


class ResizeAug(Augmenter):
    """Shorter side -> size (ref: image.ResizeAug)."""

    def __init__(self, size, interp=1):
        super().__init__(size=size)
        self.size = size
        self.interp = interp

    def __call__(self, src):
        h, w = src.shape[:2]
        if h > w:
            nw, nh = self.size, int(h * self.size / w)
        else:
            nw, nh = int(w * self.size / h), self.size
        return np.asarray(imresize(src, nw, nh, self.interp))


class ForceResizeAug(Augmenter):
    def __init__(self, size, interp=1):
        super().__init__(size=size)
        self.size = size  # (w, h)
        self.interp = interp

    def __call__(self, src):
        return np.asarray(imresize(src, self.size[0], self.size[1],
                                   self.interp))


class RandomCropAug(Augmenter):
    def __init__(self, size, interp=1):
        super().__init__(size=size)
        self.size = size
        self.interp = interp

    def __call__(self, src):
        out, _ = random_crop(src, self.size, self.interp)
        return np.asarray(out)


class CenterCropAug(Augmenter):
    def __init__(self, size, interp=1):
        super().__init__(size=size)
        self.size = size
        self.interp = interp

    def __call__(self, src):
        out, _ = center_crop(src, self.size, self.interp)
        return np.asarray(out)


class RandomSizedCropAug(Augmenter):
    """Random area+aspect crop then resize (Inception-style,
    ref: image.RandomSizedCropAug)."""

    def __init__(self, size, area, ratio, interp=1):
        super().__init__(size=size, area=area, ratio=ratio)
        self.size = size
        self.area = area if isinstance(area, tuple) else (area, 1.0)
        self.ratio = ratio
        self.interp = interp

    def __call__(self, src):
        h, w = src.shape[:2]
        src_area = h * w
        for _ in range(10):
            target_area = random.uniform(*self.area) * src_area
            log_ratio = (np.log(self.ratio[0]), np.log(self.ratio[1]))
            ar = np.exp(random.uniform(*log_ratio))
            nw = int(round(np.sqrt(target_area * ar)))
            nh = int(round(np.sqrt(target_area / ar)))
            if nw <= w and nh <= h:
                x0 = random.randint(0, w - nw)
                y0 = random.randint(0, h - nh)
                return np.asarray(fixed_crop(src, x0, y0, nw, nh,
                                             self.size, self.interp))
        return np.asarray(
            CenterCropAug(self.size, self.interp)(src))


class HorizontalFlipAug(Augmenter):
    def __init__(self, p=0.5):
        super().__init__(p=p)
        self.p = p

    def __call__(self, src):
        if random.random() < self.p:
            return src[:, ::-1]
        return src


class CastAug(Augmenter):
    def __init__(self, typ="float32"):
        super().__init__(type=typ)
        self.typ = typ

    def __call__(self, src):
        return np.asarray(src, dtype=self.typ)


class BrightnessJitterAug(Augmenter):
    def __init__(self, brightness):
        super().__init__(brightness=brightness)
        self.brightness = brightness

    def __call__(self, src):
        alpha = 1.0 + random.uniform(-self.brightness, self.brightness)
        return src * alpha


class ContrastJitterAug(Augmenter):
    _coef = np.array([[[0.299, 0.587, 0.114]]], np.float32)

    def __init__(self, contrast):
        super().__init__(contrast=contrast)
        self.contrast = contrast

    def __call__(self, src):
        alpha = 1.0 + random.uniform(-self.contrast, self.contrast)
        gray = (src * self._coef).sum()
        gray = (3.0 * (1.0 - alpha) / src.size) * gray
        return src * alpha + gray


class SaturationJitterAug(Augmenter):
    _coef = np.array([[[0.299, 0.587, 0.114]]], np.float32)

    def __init__(self, saturation):
        super().__init__(saturation=saturation)
        self.saturation = saturation

    def __call__(self, src):
        alpha = 1.0 + random.uniform(-self.saturation, self.saturation)
        gray = (src * self._coef).sum(axis=2, keepdims=True)
        return src * alpha + gray * (1.0 - alpha)


class HueJitterAug(Augmenter):
    """Hue rotation via the YIQ transform (ref: image.HueJitterAug)."""

    def __init__(self, hue):
        super().__init__(hue=hue)
        self.hue = hue
        self.tyiq = np.array([[0.299, 0.587, 0.114],
                              [0.596, -0.274, -0.321],
                              [0.211, -0.523, 0.311]], np.float32)
        self.ityiq = np.array([[1.0, 0.956, 0.621],
                               [1.0, -0.272, -0.647],
                               [1.0, -1.107, 1.705]], np.float32)

    def __call__(self, src):
        alpha = random.uniform(-self.hue, self.hue)
        u = np.cos(alpha * np.pi)
        w = np.sin(alpha * np.pi)
        bt = np.array([[1.0, 0.0, 0.0],
                       [0.0, u, -w],
                       [0.0, w, u]], np.float32)
        t = self.ityiq @ bt @ self.tyiq
        return np.dot(src, t.T)


class ColorJitterAug(RandomOrderAug):
    def __init__(self, brightness, contrast, saturation):
        ts = []
        if brightness > 0:
            ts.append(BrightnessJitterAug(brightness))
        if contrast > 0:
            ts.append(ContrastJitterAug(contrast))
        if saturation > 0:
            ts.append(SaturationJitterAug(saturation))
        super().__init__(ts)


class LightingAug(Augmenter):
    """AlexNet-style PCA lighting noise (ref: image.LightingAug)."""

    def __init__(self, alphastd, eigval, eigvec):
        super().__init__(alphastd=alphastd)
        self.alphastd = alphastd
        self.eigval = np.asarray(eigval, np.float32)
        self.eigvec = np.asarray(eigvec, np.float32)

    def __call__(self, src):
        alpha = np.random.normal(0, self.alphastd, size=(3,))
        rgb = (self.eigvec * alpha * self.eigval).sum(axis=1)
        return src + rgb.astype(np.float32)


class RandomGrayAug(Augmenter):
    _coef = np.array([[[0.299, 0.587, 0.114]]], np.float32)

    def __init__(self, p=0.5):
        super().__init__(p=p)
        self.p = p

    def __call__(self, src):
        if random.random() < self.p:
            src = np.broadcast_to(
                (src * self._coef).sum(axis=2, keepdims=True),
                src.shape).copy()
        return src


class RandomRotateAug(Augmenter):
    """Random rotation within ±max_degrees
    (ref: image_aug_default.cc max_rotate_angle)."""

    def __init__(self, max_degrees, interp=1):
        super().__init__(max_degrees=max_degrees)
        self.max_degrees = max_degrees
        self.interp = interp

    def __call__(self, src):
        from PIL import Image
        deg = random.uniform(-self.max_degrees, self.max_degrees)
        img = Image.fromarray(np.clip(src, 0, 255).astype(np.uint8))
        return np.asarray(img.rotate(deg, Image.BILINEAR),
                          dtype=src.dtype)


class RandomShearAug(Augmenter):
    """Random horizontal shear (ref: image_aug_default.cc
    max_shear_ratio)."""

    def __init__(self, max_shear_ratio):
        super().__init__(max_shear_ratio=max_shear_ratio)
        self.max_shear_ratio = max_shear_ratio

    def __call__(self, src):
        from PIL import Image
        s = random.uniform(-self.max_shear_ratio, self.max_shear_ratio)
        img = Image.fromarray(np.clip(src, 0, 255).astype(np.uint8))
        out = img.transform(img.size, Image.AFFINE,
                            (1, s, -s * img.size[1] / 2, 0, 1, 0),
                            Image.BILINEAR)
        return np.asarray(out, dtype=src.dtype)


def CreateAugmenter(data_shape, resize=0, rand_crop=False,
                    rand_resize=False, rand_mirror=False, mean=None,
                    std=None, brightness=0, contrast=0, saturation=0,
                    hue=0, pca_noise=0, rand_gray=0, inter_method=2,
                    max_rotate_angle=0, max_shear_ratio=0):
    """Standard augmenter list (ref: image.CreateAugmenter)."""
    auglist = []
    if resize > 0:
        auglist.append(ResizeAug(resize, inter_method))
    crop_size = (data_shape[2], data_shape[1])
    if rand_resize:
        auglist.append(RandomSizedCropAug(crop_size, (0.08, 1.0),
                                          (3 / 4.0, 4 / 3.0),
                                          inter_method))
    elif rand_crop:
        auglist.append(RandomCropAug(crop_size, inter_method))
    else:
        auglist.append(CenterCropAug(crop_size, inter_method))
    if rand_mirror:
        auglist.append(HorizontalFlipAug(0.5))
    if max_rotate_angle > 0:
        auglist.append(RandomRotateAug(max_rotate_angle, inter_method))
    if max_shear_ratio > 0:
        auglist.append(RandomShearAug(max_shear_ratio))
    auglist.append(CastAug())
    if brightness or contrast or saturation:
        auglist.append(ColorJitterAug(brightness, contrast, saturation))
    if hue:
        auglist.append(HueJitterAug(hue))
    if pca_noise > 0:
        eigval = np.array([55.46, 4.794, 1.148])
        eigvec = np.array([[-0.5675, 0.7192, 0.4009],
                           [-0.5808, -0.0045, -0.8140],
                           [-0.5836, -0.6948, 0.4203]])
        auglist.append(LightingAug(pca_noise, eigval, eigvec))
    if rand_gray > 0:
        auglist.append(RandomGrayAug(rand_gray))
    if mean is True:
        mean = np.array([123.68, 116.28, 103.53])
    if std is True:
        std = np.array([58.395, 57.12, 57.375])
    if mean is not None or std is not None:
        class _Norm(Augmenter):
            def __call__(self, src):
                return color_normalize(src, mean, std)
        auglist.append(_Norm())
    return auglist


# ---------------------------------------------------------------------------
# ImageIter
# ---------------------------------------------------------------------------

class ImageIter(DataIter):
    """Image iterator over .rec files or .lst + image directory with
    the python augmenter list (ref: image.py ImageIter). Batches are
    made on the current context."""

    def __init__(self, batch_size, data_shape, label_width=1,
                 path_imgrec=None, path_imglist=None, path_root="",
                 shuffle=False, aug_list=None, imglist=None,
                 data_name="data", label_name="softmax_label", **kwargs):
        super().__init__(batch_size)
        if len(data_shape) != 3 or data_shape[0] not in (1, 3):
            raise MXNetError(f"data_shape {data_shape} must be CHW")
        self.data_shape = tuple(data_shape)
        # c=1 -> decode grayscale (imdecode flag=0), c=3 -> color RGB
        self._color_flag = 1 if data_shape[0] == 3 else 0
        self.label_width = label_width
        self.data_name = data_name
        self.label_name = label_name
        self.shuffle = shuffle
        self.auglist = (aug_list if aug_list is not None
                        else CreateAugmenter(data_shape, **kwargs))

        self._rec = None
        self.imglist = {}
        self.seq = []
        if path_imgrec:
            from ..recordio import MXIndexedRecordIO, MXRecordIO
            idx_path = os.path.splitext(path_imgrec)[0] + ".idx"
            if os.path.isfile(idx_path):
                self._rec = MXIndexedRecordIO(idx_path, path_imgrec, "r")
                self.seq = list(self._rec.keys)
            elif shuffle:
                raise MXNetError(
                    f"shuffle=True requires the index file {idx_path} "
                    "(pack with tools/im2rec.py)")
            else:
                self._rec = MXRecordIO(path_imgrec, "r")
                self.seq = None  # sequential only
        elif path_imglist or imglist is not None:
            if path_imglist:
                with open(path_imglist) as f:
                    for line in f:
                        parts = line.strip().split("\t")
                        if len(parts) < 3:
                            continue
                        key = int(parts[0])
                        self.imglist[key] = (
                            np.array([float(x) for x in parts[1:-1]],
                                     np.float32), parts[-1])
            else:
                for i, item in enumerate(imglist):
                    self.imglist[i] = (
                        np.asarray(item[0], np.float32).reshape(-1),
                        item[1])
            self.seq = list(self.imglist)
        else:
            raise MXNetError("one of path_imgrec/path_imglist/imglist "
                             "is required")
        self.path_root = path_root
        self.reset()

    @property
    def provide_data(self):
        return [DataDesc(self.data_name,
                         (self.batch_size,) + self.data_shape)]

    @property
    def provide_label(self):
        shape = ((self.batch_size,) if self.label_width == 1
                 else (self.batch_size, self.label_width))
        return [DataDesc(self.label_name, shape)]

    def reset(self):
        self.cur = 0
        if self.seq is not None and self.shuffle:
            random.shuffle(self.seq)
        if self._rec is not None and self.seq is None:
            self._rec.reset()

    def next_sample(self):
        from ..recordio import unpack
        if self._rec is not None:
            if self.seq is not None:
                if self.cur >= len(self.seq):
                    raise StopIteration
                raw = self._rec.read_idx(self.seq[self.cur])
                self.cur += 1
            else:
                raw = self._rec.read()
                if raw is None:
                    raise StopIteration
            header, payload = unpack(raw)
            # decode via imdecode so both the .rec and .lst paths yield
            # RGB (raw cv2 unpack_img would hand back BGR); npy payloads
            # (cv2/PIL-less packing) pass through as stored
            if payload[:6] == b"\x93NUMPY":
                import io as _io
                img = np.load(_io.BytesIO(payload)).astype(np.float32)
            else:
                img = _decode_np(payload, flag=self._color_flag) \
                    .astype(np.float32)
            label = header.label
            if np.isscalar(label):
                label = np.array([label], np.float32)
            return np.asarray(label, np.float32), img
        if self.cur >= len(self.seq):
            raise StopIteration
        label, fname = self.imglist[self.seq[self.cur]]
        self.cur += 1
        img = _read_np(os.path.join(self.path_root, fname),
                       flag=self._color_flag).astype(np.float32)
        return label, img

    @staticmethod
    def _pad_tail(imgs, labels, batch_size):
        """Fill a partial final batch by repeating the last sample and
        report the pad count (the reference's tail handling — consumers
        ignore the padded rows via DataBatch.pad)."""
        pad = batch_size - len(imgs)
        for _ in range(pad):
            imgs.append(imgs[-1])
            labels.append(labels[-1])
        return pad

    def next(self):
        c, h, w = self.data_shape
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
            if img.ndim == 2:
                img = img[:, :, None]
            if img.shape[2] != c:
                if c == 3 and img.shape[2] == 1:
                    img = img.repeat(3, axis=2)
                elif c == 1 and img.shape[2] == 3:
                    # ITU-R BT.601 luma, matching cv2/PIL grayscale
                    img = (img @ np.array([0.299, 0.587, 0.114],
                                          np.float32))[:, :, None]
            for aug in self.auglist:
                img = aug(img)
            if img.shape[:2] != (h, w):
                raise MXNetError(
                    f"augmented image {img.shape} does not match "
                    f"data_shape {self.data_shape}; add a crop/resize "
                    "augmenter")
            imgs.append(np.asarray(img, np.float32).transpose(2, 0, 1))
            labels.append(np.asarray(label, np.float32)
                          [:self.label_width])
        data = array(np.stack(imgs))
        lab = np.stack(labels)
        if self.label_width == 1:
            lab = lab[:, 0]
        return DataBatch(data=[data], label=[array(lab)], pad=pad)
