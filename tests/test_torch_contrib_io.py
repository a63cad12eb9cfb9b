"""``contrib.io.DataLoaderIter`` of the port against the JAX package's
and under the port's Module: the cases of
``test_contrib_autograd_io.py`` (the descriptors, ``Module.fit`` end to
end, ``reset`` re-iterating), the batches of two shuffled epochs bitwise
the JAX bridge's under one ``np.random.seed``, and LeNet trained one
epoch by ``Module.fit`` through the bridge the same bits as through an
``NDArrayIter`` over the same batches."""
import torch_test_env  # noqa: F401  (first: one torch thread a process)

import numpy as np
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as tmx
from mxnet_tpu.contrib.io import DataLoaderIter as JDataLoaderIter
from mxnet_tpu_torch.contrib.io import DataLoaderIter

CPU = tmx.cpu()


def _fc_data():
    X = np.random.default_rng(0).normal(0, 1, (48, 6)).astype(np.float32)
    w = np.array([1.0, -2.0, 0.5, 0, 0, 1.0], np.float32)
    return X, (X @ w > 0).astype(np.float32)


def test_dataloader_iter_bridge_with_module():
    X, y = _fc_data()
    with CPU:
        loader = tmx.gluon.data.DataLoader(
            tmx.gluon.data.ArrayDataset(X, y), batch_size=8)
        it = DataLoaderIter(loader)
        assert it.provide_data[0].shape == (8, 6)
        assert it.provide_label[0].shape == (8,)
        assert it.provide_label[0].name == "softmax_label"
        data = tmx.sym.Variable("data")
        fc = tmx.sym.FullyConnected(data, name="fc", num_hidden=2)
        out = tmx.sym.SoftmaxOutput(fc, name="softmax")
        mod = tmx.mod.Module(out, data_names=("data",),
                             label_names=("softmax_label",), context=CPU)
        mod.fit(it, num_epoch=6, optimizer="sgd",
                optimizer_params={"learning_rate": 0.5})
        it.reset()
        score = mod.score(it, "acc")
    acc = dict(score)["accuracy"] if isinstance(score, list) else score
    assert float(acc) > 0.8, acc


def test_dataloader_iter_reset_reiterates():
    with CPU:
        ds = tmx.gluon.data.ArrayDataset(np.arange(12, dtype=np.float32))
        it = DataLoaderIter(tmx.gluon.data.DataLoader(ds, batch_size=4),
                            data_name="x")
        n1 = sum(1 for _ in it)
        it.reset()
        n2 = sum(1 for _ in it)
    assert n1 == n2 == 3
    assert it.provide_data[0].name == "x" and it.provide_label == []


def test_dataloader_iter_batches_bitwise_jax():
    X, y = _fc_data()

    def epochs(pkg, bridge):
        np.random.seed(3)
        it = bridge(pkg.gluon.data.DataLoader(
            pkg.gluon.data.ArrayDataset(X, y), batch_size=8, shuffle=True))
        out = []
        for _ in range(2):
            it.reset()
            out += [(b.data[0].asnumpy(), b.label[0].asnumpy(), b.pad)
                    for b in it]
        return out

    want = epochs(mx, JDataLoaderIter)
    with CPU:
        got = epochs(tmx, DataLoaderIter)
    assert len(got) == len(want) == 12
    for (gd, gl, gp), (wd, wl, wp) in zip(got, want):
        np.testing.assert_array_equal(gd, wd)
        np.testing.assert_array_equal(gl, wl)
        assert gp == wp == 0


def _lenet():
    sym = tmx.sym
    data = sym.Variable("data")
    c1 = sym.Convolution(data, kernel=(5, 5), num_filter=8, name="conv1")
    p1 = sym.Pooling(sym.Activation(c1, act_type="tanh"), pool_type="max",
                     kernel=(2, 2), stride=(2, 2))
    c2 = sym.Convolution(p1, kernel=(5, 5), num_filter=16, name="conv2")
    p2 = sym.Pooling(sym.Activation(c2, act_type="tanh"), pool_type="max",
                     kernel=(2, 2), stride=(2, 2))
    f1 = sym.FullyConnected(sym.flatten(p2), num_hidden=32, name="fc1")
    f2 = sym.FullyConnected(sym.Activation(f1, act_type="tanh"),
                            num_hidden=10, name="fc2")
    return sym.SoftmaxOutput(f2, name="softmax")


def test_lenet_fit_through_the_bridge_equals_ndarray_iter():
    """The bridge hands Module.fit the loader's batches as they are: one
    epoch of LeNet from the same weights ends in the same bits as one
    fed by NDArrayIter over the same arrays."""
    rng = np.random.default_rng(5)
    X = rng.random((64, 1, 28, 28)).astype(np.float32)
    y = rng.integers(0, 10, 64).astype(np.float32)
    runs = []
    with CPU:
        for bridge in (True, False):
            if bridge:
                it = DataLoaderIter(tmx.gluon.data.DataLoader(
                    tmx.gluon.data.ArrayDataset(X, y), batch_size=16))
            else:
                it = tmx.io.NDArrayIter(X, y, batch_size=16)
            mod = tmx.mod.Module(_lenet(), context=CPU)
            torch.manual_seed(1)
            mod.fit(it, num_epoch=1, optimizer="sgd",
                    initializer=tmx.initializer.Xavier(magnitude=2),
                    optimizer_params={"learning_rate": 0.1})
            arg, _ = mod.get_params()
            runs.append({k: v.asnumpy() for k, v in arg.items()})
    assert runs[0].keys() == runs[1].keys()
    for k in runs[0]:
        np.testing.assert_array_equal(runs[0][k], runs[1][k])
