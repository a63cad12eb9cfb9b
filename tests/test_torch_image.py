"""The port's mx.image (mxnet_tpu_torch.image) against the JAX package's
on the same files and seeds: imdecode / imread (JPEG through each
package's libjpeg decoder, PNG through PIL), imresize, the crops and
color_normalize bitwise, the deterministic augmenters bitwise, the
random ones with both sides seeded alike, and ImageIter over a .rec with
its .idx, a sequential .rec, a .lst and an imglist."""
import torch_test_env  # noqa: F401  (first: one torch thread a process)

import os
import random

import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as tmx
from mxnet_tpu import image as jimg
from mxnet_tpu_torch import image as timg


@pytest.fixture(scope="module")
def img_tree(tmp_path_factory):
    """12 seeded 48x64 images, PNG (lossless) and JPEG, a .lst over the
    PNGs and a .rec / .idx of the JPEGs."""
    from PIL import Image

    d = tmp_path_factory.mktemp("imgs")
    rng = np.random.default_rng(0)
    with open(d / "data.lst", "w") as lst:
        for i in range(12):
            arr = rng.integers(0, 255, (48, 64, 3), dtype=np.uint8)
            Image.fromarray(arr).save(d / f"im{i}.png")
            Image.fromarray(arr).save(d / f"im{i}.jpg", quality=90)
            lst.write(f"{i}\t{float(i % 3)}\tim{i}.png\n")
    rec = str(d / "data.rec")
    w = tmx.recordio.MXIndexedRecordIO(str(d / "data.idx"), rec, "w")
    for i in range(12):
        with open(d / f"im{i}.jpg", "rb") as f:
            w.write_idx(i, tmx.recordio.pack(
                tmx.recordio.IRHeader(0, float(i % 4), i, 0), f.read()))
    w.close()
    return d


def _np(x):
    return x.asnumpy() if hasattr(x, "asnumpy") else np.asarray(x)


def _same(a, b):
    a, b = _np(a), _np(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


def test_imdecode_and_imread_equal_jax(img_tree):
    """Both packages decode JPEGs with their libjpeg build here, PNGs
    with PIL; color and gray, RGB and BGR."""
    from mxnet_tpu import _native as jnative
    from mxnet_tpu_torch import _native as tnative
    assert tnative.load_imgdec() is not None
    assert jnative.load_imgdec() is not None
    with tmx.cpu():
        for name in ("im0.jpg", "im1.png"):
            path = str(img_tree / name)
            buf = open(path, "rb").read()
            for flag, to_rgb in ((1, True), (1, False), (0, True)):
                got = timg.imdecode(buf, flag, to_rgb)
                assert got.context == tmx.cpu() and got.dtype == np.uint8
                _same(got, jimg.imdecode(buf, flag, to_rgb))
            _same(timg.imread(path), jimg.imread(path))


def test_resize_crops_and_normalize_equal_jax(img_tree):
    with tmx.cpu():
        t = timg.imread(str(img_tree / "im2.jpg"))
    j = jimg.imread(str(img_tree / "im2.jpg"))
    for interp in (0, 1, 2, 4):
        got = timg.imresize(t, 40, 30, interp)
        assert got.context == tmx.cpu()
        _same(got, jimg.imresize(j, 40, 30, interp))
    _same(timg.fixed_crop(t, 3, 5, 20, 16, size=(10, 8)),
          jimg.fixed_crop(j, 3, 5, 20, 16, size=(10, 8)))
    got, box = timg.center_crop(t, (30, 20))
    want, jbox = jimg.center_crop(j, (30, 20))
    _same(got, want)
    assert box == jbox
    random.seed(4)
    got, box = timg.random_crop(t, (30, 20))
    random.seed(4)
    want, jbox = jimg.random_crop(j, (30, 20))
    _same(got, want)
    assert box == jbox
    mean, std = (123.68, 116.28, 103.53), (58.395, 57.12, 57.375)
    _same(timg.color_normalize(t, mean, std),
          jimg.color_normalize(j, mean, std))
    a = j.asnumpy().astype(np.float32)
    _same(timg.color_normalize(a, mean), jimg.color_normalize(a, mean))
    assert timg.scale_down((30, 20), (40, 40)) == \
        jimg.scale_down((30, 20), (40, 40))


EIG = ([55.46, 4.794, 1.148], [[-0.5675, 0.7192, 0.4009],
                               [-0.5808, -0.0045, -0.8140],
                               [-0.5836, -0.6948, 0.4203]])
AUGS = {
    "resize": lambda m: m.ResizeAug(36, 1),
    "force_resize": lambda m: m.ForceResizeAug((40, 30), 2),
    "center_crop": lambda m: m.CenterCropAug((32, 24)),
    "cast": lambda m: m.CastAug(),
    "random_crop": lambda m: m.RandomCropAug((32, 24)),
    "random_sized_crop": lambda m: m.RandomSizedCropAug(
        (32, 32), (0.3, 1.0), (0.75, 1.33)),
    "flip": lambda m: m.HorizontalFlipAug(0.5),
    "brightness": lambda m: m.BrightnessJitterAug(0.4),
    "contrast": lambda m: m.ContrastJitterAug(0.4),
    "saturation": lambda m: m.SaturationJitterAug(0.4),
    "hue": lambda m: m.HueJitterAug(0.3),
    "color_jitter": lambda m: m.ColorJitterAug(0.3, 0.3, 0.3),
    "lighting": lambda m: m.LightingAug(0.1, *EIG),
    "gray": lambda m: m.RandomGrayAug(0.5),
    "rotate": lambda m: m.RandomRotateAug(20),
    "shear": lambda m: m.RandomShearAug(0.2),
    "sequential": lambda m: m.SequentialAug(
        [m.CenterCropAug((40, 40)), m.HorizontalFlipAug(1.0)]),
    "create_augmenter": lambda m: m.SequentialAug(m.CreateAugmenter(
        (3, 32, 32), resize=40, rand_crop=True, rand_mirror=True,
        mean=True, std=True, brightness=0.2, contrast=0.2, saturation=0.2,
        hue=0.1, pca_noise=0.05, rand_gray=0.3, max_rotate_angle=10,
        max_shear_ratio=0.1)),
    "create_augmenter_std_only": lambda m: m.SequentialAug(
        m.CreateAugmenter((3, 32, 32), std=True)),
}


@pytest.mark.parametrize("name", sorted(AUGS))
def test_augmenter_equals_jax(img_tree, name):
    """Each augmenter on the same HWC float32 image; the random ones
    draw from Python's ``random`` and numpy's global stream, seeded
    alike before each side (three draws each)."""
    src = jimg.imread(str(img_tree / "im3.jpg")).asnumpy() \
        .astype(np.float32)
    taug, jaug = AUGS[name](timg), AUGS[name](jimg)
    assert taug.dumps() == jaug.dumps()
    for seed in range(3):
        out = []
        for aug in (taug, jaug):
            random.seed(seed)
            np.random.seed(seed)
            out.append(np.asarray(aug(src.copy())))
        _same(*out)


def _batches(it, n=None):
    out = []
    for b in it:
        out.append((b.data[0].asnumpy(), b.label[0].asnumpy(), b.pad))
        if n is not None and len(out) == n:
            break
    return out


def _same_batches(got, want):
    assert len(got) == len(want) > 0
    for (gd, gl, gp), (wd, wl, wp) in zip(got, want):
        assert gp == wp
        _same(gd, wd)
        _same(gl, wl)


@pytest.mark.parametrize("source", ["rec_idx", "rec_sequential", "lst",
                                    "imglist", "gray"])
def test_image_iter_equals_jax(img_tree, tmp_path, source):
    """ImageIter over each source, batch 5 of 12 (the tail padded), two
    epochs; the .rec with its index shuffles (Python's random, seeded
    alike), and every source runs a random crop and mirror."""
    from mxnet_tpu import _native as jnative
    from mxnet_tpu_torch import _native as tnative
    # JPEGs decode through libjpeg on both sides, PNGs through PIL
    assert tnative.load_imgdec() is not None
    assert jnative.load_imgdec() is not None
    d = str(img_tree)
    kw = dict(batch_size=5, data_shape=(3, 32, 32), rand_crop=True,
              rand_mirror=True, mean=True, std=True)
    if source == "rec_idx":
        kw.update(path_imgrec=os.path.join(d, "data.rec"), shuffle=True)
    elif source == "rec_sequential":
        rec = tmp_path / "seq.rec"
        rec.write_bytes(open(os.path.join(d, "data.rec"), "rb").read())
        kw.update(path_imgrec=str(rec))
    elif source in ("lst", "gray"):
        kw.update(path_imglist=os.path.join(d, "data.lst"), path_root=d)
        if source == "gray":
            kw.update(data_shape=(1, 32, 32), mean=None, std=None)
    else:
        kw.update(imglist=[([float(i), 1.0], f"im{i}.jpg")
                           for i in range(7)], path_root=d, label_width=2)
    out = []
    for pkg in (tmx, mx):
        random.seed(11)
        np.random.seed(11)
        with tmx.cpu():
            it = pkg.image.ImageIter(**kw)
            got = _batches(it)
            it.reset()
            got += _batches(it)
        out.append(got)
    _same_batches(*out)
    assert out[0][0][0].shape == (5,) + kw["data_shape"]
