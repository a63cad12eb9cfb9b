"""Vision datasets (ref: python/mxnet/gluon/data/vision/datasets.py; the
port of ``mxnet_tpu/gluon/data/vision/datasets.py``).

The MNIST and CIFAR readers take local files only (the standard idx /
bin formats) and raise the JAX package's message when one is missing:
nothing is downloaded. Arrays are made on the current context."""
from __future__ import annotations

import gzip
import os
import struct
import threading

import numpy as np

from ....base import MXNetError
from ....ndarray import array
from ..dataset import Dataset


class _DownloadedDataset(Dataset):
    def __init__(self, root, train, transform):
        self._root = os.path.expanduser(root)
        self._train = train
        self._transform = transform
        self._data = None
        self._label = None
        self._get_data()

    def __getitem__(self, idx):
        if self._transform is not None:
            return self._transform(self._data[idx], self._label[idx])
        return self._data[idx], self._label[idx]

    def __len__(self):
        return len(self._label)

    def _get_data(self):
        raise NotImplementedError


class MNIST(_DownloadedDataset):
    """MNIST from local idx files (train-images-idx3-ubyte(.gz) etc.)."""

    def __init__(self, root="~/.mxnet/datasets/mnist", train=True,
                 transform=None):
        self._base = ("train" if train else "t10k")
        super().__init__(root, train, transform)

    def _read_idx(self, path):
        opener = gzip.open if path.endswith(".gz") else open
        with opener(path, "rb") as f:
            data = f.read()
        magic = struct.unpack(">I", data[:4])[0]
        ndim = magic & 0xFF
        dims = struct.unpack(">" + "I" * ndim, data[4:4 + 4 * ndim])
        arr = np.frombuffer(data, np.uint8, offset=4 + 4 * ndim)
        return arr.reshape(dims)

    def _find(self, name):
        for cand in (name, name + ".gz"):
            p = os.path.join(self._root, cand)
            if os.path.exists(p):
                return p
        raise MXNetError(
            f"MNIST file {name} not found under {self._root}; this "
            "environment has no network egress — place the idx files there "
            "or use a synthetic ArrayDataset")

    def _get_data(self):
        images = self._read_idx(self._find(f"{self._base}-images-idx3-ubyte"))
        labels = self._read_idx(self._find(f"{self._base}-labels-idx1-ubyte"))
        self._data = array(images.reshape(-1, 28, 28, 1).astype(np.float32))
        self._label = labels.astype(np.int32)


class FashionMNIST(MNIST):
    def __init__(self, root="~/.mxnet/datasets/fashion-mnist", train=True,
                 transform=None):
        super().__init__(root, train, transform)


class CIFAR10(_DownloadedDataset):
    def __init__(self, root="~/.mxnet/datasets/cifar10", train=True,
                 transform=None):
        super().__init__(root, train, transform)

    def _get_data(self):
        files = [f"data_batch_{i}.bin" for i in range(1, 6)] if self._train \
            else ["test_batch.bin"]
        datas, labels = [], []
        for fname in files:
            path = os.path.join(self._root, fname)
            if not os.path.exists(path):
                raise MXNetError(
                    f"CIFAR10 file {fname} not found under {self._root} "
                    "(no network egress in this environment)")
            raw = np.fromfile(path, np.uint8).reshape(-1, 3073)
            labels.append(raw[:, 0])
            datas.append(raw[:, 1:].reshape(-1, 3, 32, 32)
                         .transpose(0, 2, 3, 1))
        self._data = array(np.concatenate(datas).astype(np.float32))
        self._label = np.concatenate(labels).astype(np.int32)


class CIFAR100(CIFAR10):
    def __init__(self, root="~/.mxnet/datasets/cifar100", train=True,
                 fine_label=False, transform=None):
        self._fine_label = fine_label
        super().__init__(root, train, transform)

    def _get_data(self):
        fname = "train.bin" if self._train else "test.bin"
        path = os.path.join(self._root, fname)
        if not os.path.exists(path):
            raise MXNetError(f"CIFAR100 file {fname} not found under "
                             f"{self._root}")
        raw = np.fromfile(path, np.uint8).reshape(-1, 3074)
        self._label = raw[:, 1 if self._fine_label else 0].astype(np.int32)
        self._data = array(raw[:, 2:].reshape(-1, 3, 32, 32)
                           .transpose(0, 2, 3, 1).astype(np.float32))


class ImageRecordDataset(Dataset):
    """Images and labels packed in a RecordIO file (ref: datasets.py).
    Color items come out (H, W, 3) RGB whichever decoder ran."""

    def __init__(self, filename, flag=1, transform=None):
        from ....recordio import MXIndexedRecordIO
        idx_file = filename[:filename.rfind(".")] + ".idx"
        self._record = MXIndexedRecordIO(idx_file, filename, "r")
        self._flag = flag
        self._transform = transform
        # read_idx is a seek and a read on one shared handle; the
        # DataLoader's pool threads call it at once (the decode stays
        # parallel, only the file read serializes)
        self._read_lock = threading.Lock()

    def __len__(self):
        return len(self._record.keys)

    def _read(self, idx):
        from ....recordio import unpack
        with self._read_lock:
            record = self._record.read_idx(self._record.keys[idx])
        return unpack(record)

    def raw_payload(self, idx):
        """(undecoded payload bytes, label): what the DataLoader's native
        batch path hands to the libjpeg batch decoder."""
        header, payload = self._read(idx)
        return payload, header.label

    def __getitem__(self, idx):
        from ....recordio import cv2_present, decode_payload
        from ...._native import decode_jpeg
        header, payload = self._read(idx)
        img = decode_jpeg(payload) if self._flag != 0 else None
        if img is None:
            # cv2 or PIL on the payload; color items come out (H, W, 3)
            # RGB whichever decoder ran
            img = decode_payload(payload, iscolor=self._flag)
            if self._flag != 0:
                if img.ndim == 2:
                    img = img[:, :, None].repeat(3, axis=2)
                elif img.shape[2] == 3 and cv2_present() \
                        and payload[:6] != b"\x93NUMPY":
                    # cv2 decodes BGR (4-channel BGRA passes untouched)
                    img = np.ascontiguousarray(img[:, :, ::-1])
        if self._transform is not None:
            return self._transform(array(img), header.label)
        return array(img), header.label
