"""The port's gluon.data (``mxnet_tpu_torch.gluon.data``) against the JAX
package's on the same files and seeds, on the CPU.

- The cases of ``test_gluon_data.py``: datasets, lazy transforms,
  samplers (``RandomSampler``'s order the JAX package's under one
  ``np.random.seed``), the loader's ``last_batch`` policies, shuffle,
  workers and ``batchify_fn``, and the vision transforms (bitwise, but
  ``Resize`` and the transforms that take a mean: within 1e-6 of the
  values' scale, sums in another order), the MNIST / CIFAR readers on
  local files and ``ImageRecordDataset`` / ``RecordFileDataset`` items.
- The cases of ``test_dataloader_native.py``: the native plan's compile
  and refusals, the native path against the Python path, workers with
  flip, a custom batchify, images smaller than the crop.
- Whole epochs bitwise the JAX loader's on each path: the thread pool's
  Python path, the native plan (libjpeg), and ``thread_pool=False`` over
  the sharded decode workers (2 workers, under ``record_harness``'s
  deadline and segment names). Random flips draw from numpy's global
  generator in pool threads, in no fixed order, so the flipped runs
  compare at ``num_workers=0`` (the sharded workers draw from the seed).
- The context is per thread: pool threads build in the caller's
  ``with mx.cpu():``; more pool threads than cores on one record
  handle; the device feeder; ``sharding=`` raises.
"""
import torch_test_env  # noqa: F401  (first: one torch thread a process)

import gzip
import struct

import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as tmx
from mxnet_tpu.gluon.data import dataloader as jdl
from mxnet_tpu.gluon.data.vision import transforms as JT
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon.data import (ArrayDataset, BatchSampler,
                                        DataLoader, RandomSampler,
                                        SequentialSampler)
from mxnet_tpu_torch.gluon.data import dataloader as tdl
from mxnet_tpu_torch.gluon.data.vision import ImageRecordDataset
from mxnet_tpu_torch.gluon.data.vision import transforms as TT
import record_harness as rh

CPU = tmx.cpu()
N, H, W, CROP = 16, 40, 36, 32
MEAN, STD = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)


@pytest.fixture(scope="module")
def rec_path(tmp_path_factory):
    """test_dataloader_native.py's file: 16 seeded 40 x 36 JPEGs."""
    from mxnet_tpu.recordio import IRHeader, MXIndexedRecordIO, pack_img
    d = tmp_path_factory.mktemp("dlrec")
    path = str(d / "data.rec")
    rec = MXIndexedRecordIO(str(d / "data.idx"), path, "w")
    rng = np.random.default_rng(3)
    for i in range(N):
        img = rng.integers(0, 255, (H, W, 3), dtype=np.uint8)
        rec.write_idx(i, pack_img(IRHeader(0, float(i % 10), i, 0), img,
                                  quality=95))
    rec.close()
    return path


def _np(x):
    return x.asnumpy() if hasattr(x, "asnumpy") else np.asarray(x)


def _same(a, b):
    a, b = _np(a), _np(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


def _batches(loader):
    return [[_np(a) for a in (b if isinstance(b, (list, tuple)) else [b])]
            for b in loader]


def _same_batches(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            _same(a, b)


def _pipeline(T, normalize=True, flip=False, crop=CROP):
    steps = [T.RandomFlipLeftRight()] if flip else []
    steps += [T.CenterCrop(crop), T.ToTensor()]
    if normalize:
        steps.append(T.Normalize(MEAN, STD))
    return T.Compose(steps)


# -- test_gluon_data.py's cases ----------------------------------------------
def test_array_dataset_and_transforms_lazy():
    X = np.arange(20, dtype=np.float32).reshape(10, 2)
    y = np.arange(10, dtype=np.float32)
    ds = ArrayDataset(X, y)
    assert len(ds) == 10
    x0, y0 = ds[3]
    np.testing.assert_array_equal(x0, X[3])
    t = ds.transform_first(lambda x: x * 2)
    x1, y1 = t[3]
    np.testing.assert_array_equal(x1, X[3] * 2)
    assert float(y1) == 3.0
    eager = ds.transform(lambda a, b: (a + 1, b), lazy=False)
    assert type(eager).__name__ == "SimpleDataset"
    np.testing.assert_array_equal(eager[2][0], X[2] + 1)


def test_dataset_filter_take():
    ds = ArrayDataset(np.arange(10, dtype=np.float32))
    assert len(ds.take(4)) == 4 and len(ds.take(40)) == 10
    assert len(ds.filter(lambda x: float(x) % 2 == 0)) == 5


def test_samplers_match_jax():
    from mxnet_tpu.gluon import data as jdata
    assert list(SequentialSampler(5)) == [0, 1, 2, 3, 4]
    np.random.seed(11)
    want = list(jdata.RandomSampler(100))
    np.random.seed(11)
    got = list(RandomSampler(100))
    assert got == want and sorted(got) == list(range(100))
    for policy in ("keep", "discard", "rollover"):
        j = jdata.BatchSampler(jdata.SequentialSampler(7), 3, policy)
        t = BatchSampler(SequentialSampler(7), 3, policy)
        for _ in range(2):
            assert list(t) == list(j)
            assert len(t) == len(j)
    with pytest.raises(ValueError):
        list(BatchSampler(SequentialSampler(7), 3, "bogus"))


def test_dataloader_policies_and_shuffle_match_jax():
    X = np.arange(14, dtype=np.float32).reshape(7, 2)
    with CPU:
        keep = list(DataLoader(ArrayDataset(X), batch_size=3))
        disc = list(DataLoader(ArrayDataset(X), batch_size=3,
                               last_batch="discard"))
        assert [b.shape[0] for b in keep] == [3, 3, 1]
        assert [b.shape[0] for b in disc] == [3, 3]
        assert len(DataLoader(ArrayDataset(X), batch_size=3)) == 3
        np.random.seed(5)
        got = _batches(DataLoader(ArrayDataset(X), batch_size=3,
                                  shuffle=True))
    np.random.seed(5)
    want = _batches(mx.gluon.data.DataLoader(
        mx.gluon.data.ArrayDataset(X), batch_size=3, shuffle=True))
    _same_batches(got, want)
    with pytest.raises(ValueError):
        DataLoader(ArrayDataset(X), batch_size=3, shuffle=True,
                   sampler=SequentialSampler(7))
    with pytest.raises(ValueError):
        DataLoader(ArrayDataset(X))


def test_dataloader_num_workers_parity():
    X = np.arange(64, dtype=np.float32).reshape(16, 4)
    with CPU:
        seq = _batches(DataLoader(ArrayDataset(X), batch_size=4))
        par = _batches(DataLoader(ArrayDataset(X), batch_size=4,
                                  num_workers=3, prefetch=1))
    _same_batches(par, seq)
    _same_batches(seq, _batches(mx.gluon.data.DataLoader(
        mx.gluon.data.ArrayDataset(X), batch_size=4)))


def test_dataloader_batchify_fn():
    ds = ArrayDataset(np.arange(6, dtype=np.float32))
    loader = DataLoader(ds, batch_size=2,
                        batchify_fn=lambda batch: sum(float(x)
                                                      for x in batch))
    with CPU:
        assert list(loader) == [1.0, 5.0, 9.0]


def _image(seed=0, dtype=np.uint8, shape=(8, 8, 3)):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 255, shape).astype(dtype)


def test_vision_transforms_compose_bitwise():
    img = _image()
    want = JT.Compose([JT.ToTensor(), JT.Normalize(0.5, 0.25)])(
        mx.nd.array(img))
    with CPU:
        out = TT.Compose([TT.ToTensor(), TT.Normalize(0.5, 0.25)])(
            tmx.nd.array(img))
        assert out.shape == (3, 8, 8)
        _same(out, want)
        batch = tmx.nd.array(_image(shape=(2, 8, 8, 3)))
        _same(TT.ToTensor()(batch),
              JT.ToTensor()(mx.nd.array(_image(shape=(2, 8, 8, 3)))))
        _same(TT.Cast("float16")(tmx.nd.array(img)),
              JT.Cast("float16")(mx.nd.array(img)))
    v = out.asnumpy()
    assert v.min() >= -2.0 - 1e-6 and v.max() <= 2.0 + 1e-6


@pytest.mark.parametrize("size", [(8, 10), (6, 6), (20, 30), (12, 16)])
def test_vision_resize_and_crop_match_jax(size):
    img = _image(1, shape=(16, 12, 3))
    want = JT.Resize(size)(mx.nd.array(img)).asnumpy()
    with CPU:
        got = TT.Resize(size)(tmx.nd.array(img)).asnumpy()
        c = TT.CenterCrop(6)(tmx.nd.array(img))
    assert got.shape == want.shape == (size[1], size[0], 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * 255)
    _same(c, JT.CenterCrop(6)(mx.nd.array(img)))
    assert c.shape == (6, 6, 3)


@pytest.mark.parametrize("name,args,exact", [
    ("RandomFlipLeftRight", (), True), ("RandomFlipTopBottom", (), True),
    ("RandomBrightness", (0.5,), True), ("RandomSaturation", (0.5,), True),
    ("RandomContrast", (0.5,), False),
    ("RandomColorJitter", (0.3, 0.3, 0.3), False),
    ("RandomResizedCrop", ((8, 8),), False)])
def test_random_transforms_draw_as_jax(name, args, exact):
    img = _image(2, np.float32, (16, 12, 3))
    for seed in (3, 4):
        np.random.seed(seed)
        want = getattr(JT, name)(*args)(mx.nd.array(img)).asnumpy()
        after_jax = np.random.rand()
        np.random.seed(seed)
        with CPU:
            got = getattr(TT, name)(*args)(tmx.nd.array(img)).asnumpy()
        assert np.random.rand() == after_jax   # the same draws consumed
        if exact:
            _same(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=0,
                                       atol=1e-6 * np.abs(want).max())


def _write_idx(path, arr):
    header = struct.pack(">I", 0x0800 | arr.ndim) + struct.pack(
        ">" + "I" * arr.ndim, *arr.shape)
    with gzip.open(path + ".gz", "wb") as f:
        f.write(header + arr.astype(np.uint8).tobytes())


def test_vision_datasets_read_local_files_as_jax(tmp_path):
    from mxnet_tpu.gluon.data.vision import datasets as jds
    from mxnet_tpu_torch.gluon.data.vision import datasets as tds
    rng = np.random.default_rng(7)
    mnist = tmp_path / "mnist"
    mnist.mkdir()
    _write_idx(str(mnist / "t10k-images-idx3-ubyte"),
               rng.integers(0, 255, (5, 28, 28)))
    _write_idx(str(mnist / "t10k-labels-idx1-ubyte"),
               rng.integers(0, 10, (5,)))
    cifar = tmp_path / "cifar10"
    cifar.mkdir()
    rows = np.concatenate([rng.integers(0, 10, (4, 1)),
                           rng.integers(0, 255, (4, 3072))], 1)
    rows.astype(np.uint8).tofile(str(cifar / "test_batch.bin"))
    c100 = tmp_path / "cifar100"
    c100.mkdir()
    rows = np.concatenate([rng.integers(0, 20, (3, 2)),
                           rng.integers(0, 255, (3, 3072))], 1)
    rows.astype(np.uint8).tofile(str(c100 / "test.bin"))
    cases = [("MNIST", str(mnist), {}), ("FashionMNIST", str(mnist), {}),
             ("CIFAR10", str(cifar), {}),
             ("CIFAR100", str(c100), {"fine_label": True})]
    for name, root, kw in cases:
        j = getattr(jds, name)(root=root, train=False, **kw)
        with CPU:
            t = getattr(tds, name)(root=root, train=False, **kw)
        assert len(t) == len(j)
        for i in (0, len(j) - 1):
            _same(t[i][0], j[i][0])
            _same(t[i][1], j[i][1])
    with pytest.raises(MXNetError, match="no network egress"):
        tds.MNIST(root=str(tmp_path / "nowhere"))
    with pytest.raises(MXNetError, match="not found"):
        tds.CIFAR10(root=str(tmp_path / "nowhere"))


def test_record_datasets_items_equal_jax(rec_path):
    from mxnet_tpu.gluon.data import RecordFileDataset as JRF
    from mxnet_tpu.gluon.data.vision import ImageRecordDataset as JIR
    from mxnet_tpu_torch.gluon.data import RecordFileDataset
    raw, jraw = RecordFileDataset(rec_path), JRF(rec_path)
    assert len(raw) == len(jraw) == N
    assert raw[5] == jraw[5]
    for flag in (1, 0):
        j = JIR(rec_path, flag=flag)
        with CPU:
            t = ImageRecordDataset(rec_path, flag=flag)
            for i in (0, 7):
                _same(t[i][0], j[i][0])
                assert t[i][1] == j[i][1]
    with CPU:
        t = ImageRecordDataset(rec_path, transform=lambda x, y: (x, y + 1))
        assert t[3][1] == j[3][1] + 1
    assert t.raw_payload(2) == j.raw_payload(2)


def test_synthetic_vision_dataset_loader_e2e():
    ds = ArrayDataset(
        _image(1, shape=(20, 8, 8, 3)), np.arange(20, dtype=np.float32))
    ds = ds.transform_first(TT.ToTensor())
    seen = 0
    with CPU:
        for xb, yb in DataLoader(ds, batch_size=5, shuffle=True,
                                 num_workers=2):
            assert xb.shape == (5, 3, 8, 8)
            seen += xb.shape[0]
    assert seen == 20


# -- test_dataloader_native.py's cases ---------------------------------------
def test_plan_compiles_like_jax():
    for kw in ({}, {"normalize": False, "flip": True}):
        plan = tdl.compile_native_plan(_pipeline(TT, **kw))
        want = jdl.compile_native_plan(_pipeline(JT, **kw))
        assert plan.keys() == want.keys()
        for k in plan:
            np.testing.assert_array_equal(plan[k], want[k])
    plan = tdl.compile_native_plan(_pipeline(TT))
    assert (plan["th"], plan["tw"]) == (CROP, CROP) and not plan["flip"]
    np.testing.assert_allclose(plan["mean"], np.array(MEAN) * 255)


def test_plan_rejects_unsupported_pipelines():
    for steps in ([TT.ToTensor()], [TT.RandomResizedCrop(CROP), TT.ToTensor()],
                  [TT.CenterCrop(CROP), TT.ToTensor(),
                   TT.RandomBrightness(0.5)],
                  [TT.CenterCrop(CROP), TT.Normalize()]):
        assert tdl.compile_native_plan(TT.Compose(steps)) is None
    assert tdl.compile_native_plan("not a compose") is None


def test_loader_native_plan_and_its_refusals(rec_path):
    ds = ImageRecordDataset(rec_path).transform_first(_pipeline(TT))
    assert DataLoader(ds, batch_size=4)._native is not None
    assert DataLoader(ds, batch_size=4,
                      batchify_fn=lambda items: items)._native is None
    gray = ImageRecordDataset(rec_path, flag=0).transform_first(
        _pipeline(TT))
    assert DataLoader(gray, batch_size=4)._native is None


def test_native_matches_python_path_and_jax(rec_path):
    with CPU:
        native = _batches(DataLoader(ImageRecordDataset(rec_path)
                                     .transform_first(_pipeline(TT)),
                                     batch_size=4))
        python = _batches(DataLoader(ImageRecordDataset(rec_path)
                                     .transform_first(_pipeline(TT)),
                                     batch_size=4,
                                     batchify_fn=tdl.default_batchify_fn))
    assert native[0][0].shape == (4, 3, CROP, CROP)
    for (dn, ln), (dp, lp) in zip(native, python):
        np.testing.assert_allclose(dn, dp, rtol=1e-5, atol=1e-5)
        _same(ln, lp)
    want = _batches(mx.gluon.data.DataLoader(
        mx.gluon.data.vision.ImageRecordDataset(rec_path)
        .transform_first(_pipeline(JT)), batch_size=4))
    _same_batches(native, want)


def test_native_path_with_workers_and_flip(rec_path):
    """Each flipped sample is the unflipped one or its exact mirror (the
    crop margins are even, so crop-then-mirror is mirror-then-crop)."""
    with CPU:
        flipped = _batches(DataLoader(ImageRecordDataset(rec_path)
                                      .transform_first(_pipeline(TT,
                                                                 flip=True)),
                                      batch_size=8, num_workers=2))
        plain = _batches(DataLoader(ImageRecordDataset(rec_path)
                                    .transform_first(_pipeline(TT)),
                                    batch_size=8))
    seen = 0
    for (a, _), (r, _) in zip(flipped, plain):
        assert a.shape == (8, 3, CROP, CROP)
        for k in range(a.shape[0]):
            assert np.array_equal(a[k], r[k]) \
                or np.array_equal(a[k], r[k][:, :, ::-1]), f"sample {seen + k}"
        seen += a.shape[0]
    assert seen == N


def test_small_images_fall_back_to_python(rec_path):
    big = TT.Compose([TT.CenterCrop(H + 32), TT.ToTensor()])
    loader = DataLoader(ImageRecordDataset(rec_path).transform_first(big),
                        batch_size=4)
    assert loader._native is not None
    with CPU:
        data, label = next(iter(loader))
    assert data.shape == (4, 3, H, W) and label.shape == (4,)
    jdata, _ = next(iter(mx.gluon.data.DataLoader(
        mx.gluon.data.vision.ImageRecordDataset(rec_path).transform_first(
            JT.Compose([JT.CenterCrop(H + 32), JT.ToTensor()])),
        batch_size=4)))
    _same(data, jdata)


# -- whole epochs against the JAX loaders ------------------------------------
PATHS = {
    # name: (pipeline kwargs, loader kwargs, Python path)
    "thread": ({}, {"num_workers": 2}, True),
    "thread_flip": ({"flip": True}, {"shuffle": True}, True),
    "native": ({}, {"num_workers": 2, "shuffle": True}, False),
    "native_flip": ({"flip": True}, {}, False),
}


@pytest.mark.parametrize("path", sorted(PATHS))
def test_loader_epochs_bitwise_jax(rec_path, path):
    pipe, kw, python = PATHS[path]

    def run(pkg, T, dl):
        ds = pkg.gluon.data.vision.ImageRecordDataset(rec_path) \
            .transform_first(_pipeline(T, **pipe))
        extra = {"batchify_fn": dl.default_batchify_fn} if python else {}
        np.random.seed(21)
        loader = pkg.gluon.data.DataLoader(ds, batch_size=4, **kw, **extra)
        assert (loader._native is None) == python
        return [b for _ in range(2) for b in _batches(loader)]

    want = run(mx, JT, jdl)
    with CPU:
        got = run(tmx, TT, tdl)
    _same_batches(got, want)


def test_multiprocess_loader_bitwise_jax(rec_path):
    """``thread_pool=False``: the sharded decode workers, 2 of them, two
    epochs with flip and shuffle; the seed derived from numpy's global
    state consumes no draw."""
    def run(pkg, T):
        ds = pkg.gluon.data.vision.ImageRecordDataset(rec_path) \
            .transform_first(_pipeline(T, flip=True))
        np.random.seed(8)
        loader = pkg.gluon.data.DataLoader(ds, batch_size=4, shuffle=True,
                                           num_workers=2, thread_pool=False)
        assert loader._mp_config is not None
        after = np.random.rand()
        try:
            return [b for _ in range(2) for b in _batches(loader)], after
        finally:
            loader.close()

    with rh.own_segment_names(), rh.deadline(30):
        want, after_jax = run(mx, JT)
        with CPU:
            got, after = run(tmx, TT)
    assert after == after_jax
    _same_batches(got, want)
    # records that do not divide into workers x batch keep the threads
    ds = ImageRecordDataset(rec_path).transform_first(_pipeline(TT))
    assert DataLoader(ds, batch_size=3, num_workers=2,
                      thread_pool=False)._mp_config is None


# -- contexts and the device feeder ------------------------------------------
def test_pool_threads_build_in_the_callers_context(rec_path):
    """The context is per thread: a pool thread would take the card (and
    raise here) unless the loader enters the caller's context."""
    ds = ImageRecordDataset(rec_path).transform_first(_pipeline(TT))
    arrays = ArrayDataset(np.arange(12, dtype=np.float32))
    with CPU:
        for loader in (DataLoader(ds, batch_size=4, num_workers=2,
                                  batchify_fn=tdl.default_batchify_fn),
                       DataLoader(ds, batch_size=4, num_workers=2),
                       DataLoader(arrays, batch_size=4, num_workers=2)):
            batches = list(loader)
            assert len(batches) == len(loader)
            for b in batches:
                for a in (b if isinstance(b, list) else [b]):
                    assert a.context == CPU


def test_pool_of_more_threads_than_cores_keeps_records_apart(rec_path):
    """Many pool threads share one record handle (a seek and a read
    under the dataset's lock): with more threads than cores and a short
    switch interval, every batch is still its own record."""
    import sys
    from mxnet_tpu_torch.gluon.data import RecordFileDataset
    raw = RecordFileDataset(rec_path)
    order = np.random.default_rng(0).integers(0, N, 3000).tolist()
    want = [raw[i] for i in order]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with rh.deadline(30), CPU:
            got = list(DataLoader(raw, batch_size=1, num_workers=16,
                                  sampler=order,
                                  batchify_fn=lambda items: items[0]))
            labels = [float(y[0]) for _, y in DataLoader(
                ImageRecordDataset(rec_path), batch_size=1, num_workers=16)]
    finally:
        sys.setswitchinterval(interval)
    assert got == want
    assert labels == [float(i % 10) for i in range(N)]


def test_device_feeder_routes(rec_path):
    ds = ImageRecordDataset(rec_path).transform_first(_pipeline(TT))
    with CPU:
        plain = _batches(DataLoader(ds, batch_size=4, num_workers=2))
        fed = _batches(DataLoader(ds, batch_size=4, num_workers=2,
                                  prefetch_to_device=True))
        with pytest.warns(UserWarning, match="device feeder"):
            pinned = DataLoader(ds, batch_size=4, pin_memory=True)
        assert pinned._prefetch_device
        _same_batches(_batches(pinned), plain)
    _same_batches(fed, plain)
    # sharding= lays each batch out over a dp mesh: the same values
    mesh = tmx.parallel.create_mesh({"dp": 2}, devices=["cpu", "cpu"])
    with CPU:
        sharded = list(DataLoader(ds, batch_size=4, num_workers=2,
                                  sharding=tmx.parallel.NamedSharding(
                                      mesh, tmx.parallel.PartitionSpec("dp"))))
    assert all(isinstance(a, tmx.parallel.Sharded) and a.shards.size == 2
               for b in sharded for a in b)
    _same_batches(_batches(sharded), plain)
