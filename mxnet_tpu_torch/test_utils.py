"""Dataset helpers for tests and examples (the port of
``mxnet_tpu/test_utils.py``'s MNIST helpers, ``:186-275``): the offline
synthetic MNIST, byte for byte the JAX package's, written in the idx
format ``MNISTIter`` reads. The rest of that module (array comparison
helpers, gradient checks) is not ported yet."""
from __future__ import annotations

import numpy as np


# ---------------------------------------------------------------------------
# dataset helpers — offline synthetic MNIST
# ---------------------------------------------------------------------------

def _synthetic_mnist(n, seed):
    """Deterministic MNIST-shaped dataset: each class is a fixed random
    28x28 prototype plus noise. The reference's get_mnist() downloads
    the real set; examples and tests train on this learnable stand-in,
    which needs no download."""
    rng = np.random.RandomState(42)  # prototypes shared by every split
    protos = (rng.rand(10, 28, 28) > 0.75).astype(np.float32)
    rs = np.random.RandomState(seed)
    labels = rs.randint(0, 10, n).astype(np.float32)
    imgs = protos[labels.astype(int)]
    noise = rs.rand(n, 28, 28).astype(np.float32)
    imgs = np.clip(imgs * 0.8 + noise * 0.2, 0, 1)
    return imgs.reshape(n, 1, 28, 28), labels


def get_mnist(n_train=8000, n_test=2000):
    """dict with train_data/train_label/test_data/test_label
    (same keys as the reference's test_utils.get_mnist)."""
    tr_x, tr_y = _synthetic_mnist(n_train, seed=1)
    te_x, te_y = _synthetic_mnist(n_test, seed=2)
    return {"train_data": tr_x, "train_label": tr_y,
            "test_data": te_x, "test_label": te_y}


def get_mnist_ubyte(data_dir="data"):
    """Write the synthetic MNIST in idx/ubyte format so MNISTIter and
    the reference's example scripts find the expected files
    (ref: test_utils.py get_mnist_ubyte)."""
    import os
    import struct

    os.makedirs(data_dir, exist_ok=True)
    paths = {
        "train-images-idx3-ubyte": None, "train-labels-idx1-ubyte": None,
        "t10k-images-idx3-ubyte": None, "t10k-labels-idx1-ubyte": None,
    }
    if all(os.path.exists(os.path.join(data_dir, p)) for p in paths):
        return {k: os.path.join(data_dir, k) for k in paths}
    mnist = get_mnist()

    def write_idx(path, arr, is_img):
        arr = (arr * 255).astype(np.uint8) if is_img \
            else arr.astype(np.uint8)
        with open(path, "wb") as f:
            if is_img:
                n = arr.shape[0]
                f.write(struct.pack(">iiii", 0x00000803, n, 28, 28))
                f.write(arr.reshape(n, 28, 28).tobytes())
            else:
                f.write(struct.pack(">ii", 0x00000801, arr.shape[0]))
                f.write(arr.tobytes())

    write_idx(os.path.join(data_dir, "train-images-idx3-ubyte"),
              mnist["train_data"], True)
    write_idx(os.path.join(data_dir, "train-labels-idx1-ubyte"),
              mnist["train_label"], False)
    write_idx(os.path.join(data_dir, "t10k-images-idx3-ubyte"),
              mnist["test_data"], True)
    write_idx(os.path.join(data_dir, "t10k-labels-idx1-ubyte"),
              mnist["test_label"], False)
    return {k: os.path.join(data_dir, k) for k in paths}


def get_mnist_iterator(batch_size, input_shape=(784,), num_parts=1,
                       part_index=0, data_dir="data"):
    """(train_iter, val_iter) over the idx files, flat or NCHW depending
    on input_shape (ref: test_utils.py get_mnist_iterator)."""
    import os

    from .io import MNISTIter

    get_mnist_ubyte(data_dir)
    flat = len(input_shape) == 1
    train = MNISTIter(
        image=os.path.join(data_dir, "train-images-idx3-ubyte"),
        label=os.path.join(data_dir, "train-labels-idx1-ubyte"),
        input_shape=input_shape, batch_size=batch_size,
        shuffle=True, flat=flat, num_parts=num_parts,
        part_index=part_index)
    val = MNISTIter(
        image=os.path.join(data_dir, "t10k-images-idx3-ubyte"),
        label=os.path.join(data_dir, "t10k-labels-idx1-ubyte"),
        input_shape=input_shape, batch_size=batch_size,
        shuffle=False, flat=flat)
    return train, val
