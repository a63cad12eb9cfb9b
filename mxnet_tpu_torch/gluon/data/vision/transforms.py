"""Vision transforms (ref: python/mxnet/gluon/data/vision/transforms.py;
the port of ``mxnet_tpu/gluon/data/vision/transforms.py``).

Inputs are HWC images (uint8 or float) as NDArrays; ``ToTensor`` gives
CHW float32 in [0, 1]. ``Compose``, ``Cast``, ``ToTensor`` and
``Normalize`` are HybridBlocks over ``F``. The random transforms draw
from numpy's global generator in the JAX package's order, so a run
seeded alike makes the same choices. ``Resize`` is bilinear with the
JAX package's antialiasing: its weight matrices are built as
``jax.image.resize`` builds them (a triangle kernel widened by the
downscale factor, each output's weights summing to one)."""
from __future__ import annotations

import numpy as np
import torch

from ....ndarray import NDArray, array
from ...block import Block, HybridBlock
from ...nn import HybridSequential


class Compose(HybridSequential):
    def __init__(self, transforms):
        super().__init__()
        for t in transforms:
            self.add(t)


class Cast(HybridBlock):
    def __init__(self, dtype="float32"):
        super().__init__()
        self._dtype = dtype

    def hybrid_forward(self, F, x):
        return F.Cast(x, dtype=self._dtype)


class ToTensor(HybridBlock):
    """HWC [0,255] -> CHW [0,1] float32."""

    def hybrid_forward(self, F, x):
        x = F.Cast(x, dtype="float32") / 255.0
        if x.ndim == 3:
            return F.transpose(x, axes=(2, 0, 1))
        return F.transpose(x, axes=(0, 3, 1, 2))


class Normalize(HybridBlock):
    def __init__(self, mean=0.0, std=1.0):
        super().__init__()
        self._mean = mean
        self._std = std

    def hybrid_forward(self, F, x):
        mean = np.asarray(self._mean, np.float32).reshape(-1, 1, 1)
        std = np.asarray(self._std, np.float32).reshape(-1, 1, 1)
        return (x - array(mean, ctx=x.context)) / array(std, ctx=x.context)


def _weight_mat(n_in, n_out, dev):
    """(n_in, n_out) linear-resize weights, ``jax.image.resize``'s
    ``compute_weight_mat`` with a triangle kernel and antialiasing."""
    f32 = torch.float32
    # Python floats, rounded to float32 where they meet the tensors, as
    # jax's weakly typed scalars are
    inv_scale = 1.0 / (n_out / n_in)
    kernel_scale = max(inv_scale, 1.0)
    sample = (torch.arange(n_out, dtype=f32, device=dev) + 0.5) \
        * inv_scale - 0.5
    x = torch.abs(sample[None, :] - torch.arange(n_in, dtype=f32,
                                                 device=dev)[:, None]) \
        / kernel_scale
    w = torch.clamp(1 - torch.abs(x), min=0)
    total = w.sum(dim=0, keepdim=True)
    tiny = 1000.0 * float(np.finfo(np.float32).eps)
    w = torch.where(torch.abs(total) > tiny,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def resize_linear(data, h, w):
    """An HWC or NHWC tensor resized to (h, w), in float32."""
    out = data.to(torch.float32)
    hd, wd = out.ndim - 3, out.ndim - 2
    for dim, n in ((hd, h), (wd, w)):
        if out.shape[dim] != n:
            wm = _weight_mat(out.shape[dim], n, out.device)
            out = torch.movedim(torch.tensordot(
                torch.movedim(out, dim, -1), wm, dims=1), -1, dim)
    return out


class Resize(Block):
    def __init__(self, size, keep_ratio=False, interpolation=1):
        super().__init__()
        self._size = size if isinstance(size, (tuple, list)) else (size, size)

    def forward(self, x):
        data = x._data if isinstance(x, NDArray) else torch.as_tensor(x)
        return NDArray(resize_linear(data, self._size[1], self._size[0]))


class CenterCrop(Block):
    def __init__(self, size, interpolation=1):
        super().__init__()
        self._size = size if isinstance(size, (tuple, list)) else (size, size)

    def forward(self, x):
        w, h = self._size
        H, W = x.shape[-3], x.shape[-2]
        y0 = max((H - h) // 2, 0)
        x0 = max((W - w) // 2, 0)
        return x[..., y0:y0 + h, x0:x0 + w, :]


class RandomResizedCrop(Block):
    def __init__(self, size, scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3),
                 interpolation=1):
        super().__init__()
        self._size = size if isinstance(size, (tuple, list)) else (size, size)
        self._scale = scale
        self._ratio = ratio

    def forward(self, x):
        H, W = x.shape[-3], x.shape[-2]
        area = H * W
        for _ in range(10):
            target_area = np.random.uniform(*self._scale) * area
            aspect = np.random.uniform(*self._ratio)
            w = int(round(np.sqrt(target_area * aspect)))
            h = int(round(np.sqrt(target_area / aspect)))
            if w <= W and h <= H:
                x0 = np.random.randint(0, W - w + 1)
                y0 = np.random.randint(0, H - h + 1)
                crop = x[..., y0:y0 + h, x0:x0 + w, :]
                return Resize(self._size)(crop)
        return Resize(self._size)(x)


class RandomFlipLeftRight(Block):
    def forward(self, x):
        if np.random.rand() < 0.5:
            from .... import ndarray as F
            return F.flip(x, axis=x.ndim - 2)
        return x


class RandomFlipTopBottom(Block):
    def forward(self, x):
        if np.random.rand() < 0.5:
            from .... import ndarray as F
            return F.flip(x, axis=x.ndim - 3)
        return x


class RandomBrightness(Block):
    def __init__(self, brightness):
        super().__init__()
        self._b = brightness

    def forward(self, x):
        alpha = 1.0 + np.random.uniform(-self._b, self._b)
        return x * alpha


class RandomContrast(Block):
    def __init__(self, contrast):
        super().__init__()
        self._c = contrast

    def forward(self, x):
        alpha = 1.0 + np.random.uniform(-self._c, self._c)
        gray = x.mean()
        return x * alpha + gray * (1 - alpha)


class RandomSaturation(Block):
    def __init__(self, saturation):
        super().__init__()
        self._s = saturation

    def forward(self, x):
        alpha = 1.0 + np.random.uniform(-self._s, self._s)
        coef = array(np.array([0.299, 0.587, 0.114], np.float32),
                     ctx=x.context)
        gray = (x * coef).sum(axis=-1, keepdims=True)
        return x * alpha + gray * (1 - alpha)


class RandomColorJitter(Block):
    def __init__(self, brightness=0, contrast=0, saturation=0, hue=0):
        super().__init__()
        self._ts = []
        if brightness:
            self._ts.append(RandomBrightness(brightness))
        if contrast:
            self._ts.append(RandomContrast(contrast))
        if saturation:
            self._ts.append(RandomSaturation(saturation))

    def forward(self, x):
        order = np.random.permutation(len(self._ts))
        for i in order:
            x = self._ts[i](x)
        return x
