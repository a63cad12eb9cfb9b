"""The port's data iterators (mxnet_tpu_torch.io) and offline MNIST
(mxnet_tpu_torch.test_utils) against the JAX package's on the same
files and seeds: ``get_mnist_ubyte`` writes the same bytes, and
``MNISTIter``, ``CSVIter``, ``LibSVMIter``, ``ResizeIter``,
``PrefetchingIter`` (to the host and, on the CPU, "to the device") and
``NDArrayIter``'s roll_over give the same batches, including after
``reset`` and across a ``state_dict`` resume."""
import torch_test_env  # noqa: F401  (first: one torch thread a process)

import os

import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as tmx

MNIST_FILES = ("train-images-idx3-ubyte", "train-labels-idx1-ubyte",
               "t10k-images-idx3-ubyte", "t10k-labels-idx1-ubyte")


def _take(it, n=None):
    """(data, label, pad) numpy of up to ``n`` batches."""
    out = []
    for b in it:
        out.append(([d.asnumpy() for d in b.data],
                    [lb.asnumpy() for lb in (b.label or [])], b.pad or 0))
        if n is not None and len(out) == n:
            break
    return out


def _same(got, want):
    assert len(got) == len(want)
    for (gd, gl, gp), (wd, wl, wp) in zip(got, want):
        assert gp == wp
        for a, b in zip(gd + gl, wd + wl):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def _both(make, n=None, resets=1):
    """The batches of ``make(pkg)`` in both packages (the port on the
    CPU), over ``1 + resets`` epochs."""
    want, got = [], []
    jit = make(mx)
    with tmx.cpu():
        tit = make(tmx)
        for epoch in range(1 + resets):
            if epoch:
                jit.reset()
                tit.reset()
            want += _take(jit, n)
            got += _take(tit, n)
    return got, want


@pytest.fixture(scope="module")
def mnist_dirs(tmp_path_factory):
    jdir = str(tmp_path_factory.mktemp("jax_mnist"))
    tdir = str(tmp_path_factory.mktemp("port_mnist"))
    mx.test_utils.get_mnist_ubyte(jdir)
    tmx.test_utils.get_mnist_ubyte(tdir)
    return jdir, tdir


def test_get_mnist_ubyte_writes_the_jax_packages_bytes(mnist_dirs):
    """Both packages write the same idx files, each into a directory of
    its own under the test's temporary path."""
    jdir, tdir = mnist_dirs
    for name in MNIST_FILES:
        with open(os.path.join(tdir, name), "rb") as f:
            got = f.read()
        with open(os.path.join(jdir, name), "rb") as f:
            assert f.read() == got, name


@pytest.mark.parametrize("case", ["shuffled", "flat"])
def test_mnist_iter_batches_equal_jax(mnist_dirs, case):
    """``MNISTIter`` over the port's files: a shuffled (seeded) NCHW
    epoch of 300 images and a flat, ordered one, then the next epoch
    after ``reset``, equal the JAX iterator's batches."""
    _, tdir = mnist_dirs

    def make(pkg):
        kw = dict(shuffle=True, seed=5) if case == "shuffled" \
            else dict(shuffle=False, flat=True)
        return pkg.io.MNISTIter(
            image=os.path.join(tdir, "t10k-images-idx3-ubyte"),
            label=os.path.join(tdir, "t10k-labels-idx1-ubyte"),
            batch_size=100, num_parts=6, part_index=1, **kw)

    got, want = _both(make, n=3)
    _same(got, want)
    assert got[0][0][0].shape == ((100, 1, 28, 28) if case == "shuffled"
                                  else (100, 784))


def test_get_mnist_iterator_equals_jax(mnist_dirs):
    _, tdir = mnist_dirs
    j = mx.test_utils.get_mnist_iterator(64, (1, 28, 28), data_dir=tdir)
    with tmx.cpu():
        t = tmx.test_utils.get_mnist_iterator(64, (1, 28, 28),
                                              data_dir=tdir)
        for ji, ti in zip(j, t):
            _same(_take(ti, 2), _take(ji, 2))


@pytest.mark.parametrize("round_batch", [True, False])
def test_csv_and_libsvm_iters_equal_jax(tmp_path, round_batch):
    """CSV data and labels, and LibSVM rows densified on the host: 11
    rows at batch 4 (the last batch padded or dropped), two epochs."""
    rng = np.random.default_rng(3)
    x = rng.random((11, 6)).astype(np.float32)
    y = rng.integers(0, 3, 11).astype(np.float32)
    data_csv, label_csv = tmp_path / "d.csv", tmp_path / "l.csv"
    np.savetxt(data_csv, x, delimiter=",")
    np.savetxt(label_csv, y, delimiter=",")
    svm = tmp_path / "d.libsvm"
    with open(svm, "w") as f:
        for row, lab in zip(x, y):
            nz = [f"{i}:{v:.6f}" for i, v in enumerate(row) if v > 0.5]
            f.write(f"{int(lab)} {' '.join(nz)}\n")

    def csv(pkg):
        return pkg.io.CSVIter(data_csv=str(data_csv), data_shape=(2, 3),
                              label_csv=str(label_csv), batch_size=4,
                              round_batch=round_batch)

    def libsvm(pkg):
        return pkg.io.LibSVMIter(data_libsvm=str(svm), data_shape=(6,),
                                 batch_size=4, round_batch=round_batch)

    for make in (csv, libsvm):
        got, want = _both(make)
        _same(got, want)
        assert len(got) == (6 if round_batch else 4)


def _ndarray_iter(pkg, **kw):
    x = np.arange(30, dtype=np.float32).reshape(10, 3)
    y = np.arange(10, dtype=np.float32)
    return pkg.io.NDArrayIter(x, y, batch_size=4, **kw)


def test_resize_and_roll_over_equal_jax():
    """``ResizeIter`` to 7 batches of a 3-batch iterator (it resets the
    inner one and goes on), and ``NDArrayIter`` roll_over (the tail
    leads the next epoch), shuffled with a seed."""
    got, want = _both(lambda pkg: pkg.io.ResizeIter(
        _ndarray_iter(pkg, shuffle=True, seed=1), 7))
    _same(got, want)
    assert len(got) == 14
    got, want = _both(lambda pkg: _ndarray_iter(
        pkg, shuffle=True, seed=2, last_batch_handle="roll_over"),
        resets=2)
    _same(got, want)


@pytest.mark.parametrize("to_device", [False, True])
def test_prefetching_iter_equals_jax_and_resumes(to_device):
    """Two shuffled iterators prefetched together (their batches
    concatenated) equal the JAX ``PrefetchingIter``'s, over two epochs;
    ``state_dict`` after two delivered batches, loaded into a fresh
    iterator, replays the rest of the epoch as the JAX one does. With
    ``prefetch_to_device`` the port builds on the host and moves each
    batch to the current context's device (here the CPU)."""
    def make(pkg):
        kw = {"prefetch_to_device": True} if pkg is tmx and to_device \
            else {}
        return pkg.io.PrefetchingIter(
            [_ndarray_iter(pkg, shuffle=True, seed=3),
             _ndarray_iter(pkg, shuffle=True, seed=4)], **kw)

    got, want = _both(make)
    _same(got, want)
    assert len(got) == 6 and len(got[0][0]) == 2
    jit = make(mx)
    _take(jit, 2)
    jstate = jit.state_dict()
    rest = _take(jit)
    with tmx.cpu():
        tit = make(tmx)
        _take(tit, 2)
        state = tit.state_dict()
        assert state["delivered"] == jstate["delivered"] == 2
        fresh = make(tmx)
        fresh.load_state_dict(state)
        _same(_take(fresh), rest)
        assert fresh.provide_data[0].shape == (4, 3)
