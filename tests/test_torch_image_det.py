"""The port's detection augmenters and ``ImageDetIter``
(``mxnet_tpu_torch.image.detection``) against the JAX package's: the
cases of ``test_image.py``'s ``test_det_*`` and ``test_image_det_iter``,
each augmenter bitwise on the same image and labels under the same
``random.seed`` (the module draws from Python's ``random``, not numpy),
and whole epochs of ``ImageDetIter`` (rand_pad, rand_crop, rand_mirror,
mean / std, shuffle, padded tails) bitwise the JAX iterator's batches
over an imglist and over a .rec with vector labels."""
import torch_test_env  # noqa: F401  (first: one torch thread a process)

import random

import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as tmx
from mxnet_tpu import image as jimg
from mxnet_tpu_torch import image as timg

CPU = tmx.cpu()


@pytest.fixture(scope="module")
def img_tree(tmp_path_factory):
    """test_image.py's 12 seeded 48 x 64 PNGs, and a .rec / .idx of the
    same images with one or two boxes a record."""
    from PIL import Image
    d = tmp_path_factory.mktemp("detimgs")
    rng = np.random.default_rng(0)
    names = []
    w = tmx.recordio.MXIndexedRecordIO(str(d / "det.idx"),
                                       str(d / "det.rec"), "w")
    for i in range(12):
        arr = rng.integers(0, 255, (48, 64, 3), dtype=np.uint8)
        Image.fromarray(arr).save(d / f"im{i}.png")
        names.append(f"im{i}.png")
        boxes = [[i % 2, 0.1, 0.2, 0.6, 0.7]]
        if i % 3 == 0:
            boxes.append([1, 0.5, 0.05, 0.95, 0.5])
        with open(d / f"im{i}.png", "rb") as f:
            w.write_idx(i, tmx.recordio.pack(
                tmx.recordio.IRHeader(0, np.array(boxes, np.float32).ravel(),
                                      i, 0), f.read()))
    w.close()
    return d, names


def _np(x):
    return x.asnumpy() if hasattr(x, "asnumpy") else np.asarray(x)


def _same(a, b):
    a, b = _np(a), _np(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


def test_det_flip_keeps_boxes_consistent():
    src = np.zeros((20, 20, 3), np.float32)
    src[4:10, 2:8, 0] = 1.0
    label = np.array([[1, 0.1, 0.2, 0.4, 0.5],
                      [-1, -1, -1, -1, -1]], np.float32)
    out, lab = timg.DetHorizontalFlipAug(p=1.0)(src, label)
    np.testing.assert_allclose(lab[0, 1:5], [0.6, 0.2, 0.9, 0.5], rtol=1e-6)
    assert out[4, 19 - 2, 0] == 1.0
    np.testing.assert_array_equal(lab[1], label[1])
    jout, jlab = jimg.DetHorizontalFlipAug(p=1.0)(src, label)
    _same(out, jout)
    _same(lab, jlab)


def test_det_border_pad():
    src = np.zeros((20, 40, 3), np.float32)
    label = np.array([[0, 0.0, 0.0, 1.0, 1.0]], np.float32)
    out, lab = timg.DetBorderAug(fill=7)(src, label)
    assert out.shape == (40, 40, 3) and out[0, 0, 0] == 7
    np.testing.assert_allclose(lab[0, 1:5], [0.0, 0.25, 1.0, 0.75],
                               rtol=1e-6)
    jout, jlab = jimg.DetBorderAug(fill=7)(src, label)
    _same(out, jout)
    _same(lab, jlab)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_det_random_crop_and_prob_draw_as_jax(seed):
    src = np.random.default_rng(seed).random((30, 50, 3)).astype(np.float32)
    label = np.array([[0, 0.1, 0.1, 0.5, 0.6], [1, 0.4, 0.3, 0.9, 0.95],
                      [-1, -1, -1, -1, -1]], np.float32)
    for mk in (lambda m: m.DetRandomCropAug(0.5),
               lambda m: m.DetRandomCropAug(0.95, min_crop_scale=0.8),
               lambda m: m.detection._WithProb(m.DetBorderAug(3), 0.5),
               lambda m: m.DetHorizontalFlipAug(0.5)):
        random.seed(seed)
        want = mk(jimg)(src, label)
        after_jax = random.random()
        random.seed(seed)
        got = mk(timg)(src, label)
        assert random.random() == after_jax
        _same(got[0], want[0])
        _same(got[1], want[1])


def test_create_det_augmenter_matches_jax():
    kw = dict(rand_pad=0.5, rand_crop=0.5, rand_mirror=True, mean=True,
              std=True)
    got = timg.CreateDetAugmenter((3, 32, 32), **kw)
    want = jimg.CreateDetAugmenter((3, 32, 32), **kw)
    assert [type(a).__name__ for a in got] == \
        [type(a).__name__ for a in want]
    assert [type(a).__name__ for a in timg.CreateDetAugmenter(
        (3, 32, 32))] == ["_ImgOnly", "_ImgOnly"]


def test_image_det_iter(img_tree):
    d, names = img_tree
    imglist = [([float(i % 2), 0.1, 0.1, 0.6, 0.7], n)
               for i, n in enumerate(names[:6])]
    with CPU:
        it = timg.ImageDetIter(batch_size=2, data_shape=(3, 32, 32),
                               imglist=imglist, path_root=str(d),
                               rand_mirror=True, max_objects=4)
        batch = next(iter(it))
    assert it.provide_label[0].shape == (2, 4, 5)
    assert batch.data[0].shape == (2, 3, 32, 32)
    assert batch.data[0].context == CPU
    lab = batch.label[0].asnumpy()
    assert lab.shape == (2, 4, 5)
    assert (lab[:, 0, 0] >= 0).all() and (lab[:, 1:, 0] == -1).all()
    with pytest.raises(tmx.MXNetError, match="divisible by 5"):
        it._pad_label(np.zeros(7, np.float32))


CASES = {
    "imglist": dict(rand_mirror=True, rand_crop=1, shuffle=True),
    "rec": dict(rand_pad=0.5, rand_crop=0.5, rand_mirror=True, mean=True,
                std=True, shuffle=True, max_objects=3),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_image_det_iter_epochs_bitwise_jax(img_tree, case):
    d, names = img_tree
    kw = dict(CASES[case])
    if case == "rec":
        kw["path_imgrec"] = str(d / "det.rec")
    else:
        kw["imglist"] = [([float(i % 2), 0.1, 0.1, 0.6, 0.7,
                           1.0, 0.3, 0.4, 0.9, 0.8], n)
                         for i, n in enumerate(names)]
        kw["path_root"] = str(d)

    def epochs(pkg):
        random.seed(13)
        it = pkg.image.ImageDetIter(batch_size=5, data_shape=(3, 24, 32),
                                    **kw)
        out = []
        for _ in range(2):
            it.reset()
            out += [(b.data[0].asnumpy(), b.label[0].asnumpy(), b.pad)
                    for b in it]
        return out

    want = epochs(mx)
    with CPU:
        got = epochs(tmx)
    assert len(got) == len(want) == 6
    assert [b[2] for b in got] == [0, 0, 3] * 2
    for (gd, gl, _), (wd, wl, _) in zip(got, want):
        _same(gd, wd)
        _same(gl, wl)
