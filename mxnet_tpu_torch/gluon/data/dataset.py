"""Datasets (ref: python/mxnet/gluon/data/dataset.py)."""
from __future__ import annotations


class Dataset:
    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError

    def filter(self, fn):
        return SimpleDataset([s for s in self if fn(s)])

    def take(self, count):
        return SimpleDataset([self[i] for i in range(min(count, len(self)))])

    def transform(self, fn, lazy=True):
        return _LazyTransformDataset(self, fn) if lazy else \
            SimpleDataset([fn(*s) if isinstance(s, tuple) else fn(s)
                           for s in self])

    def transform_first(self, fn, lazy=True):
        def first(x, *args):
            return (fn(x),) + args if args else fn(x)
        # the DataLoader's native batch path unwraps this to see whether
        # the pipeline maps onto the libjpeg batch decoder
        first._transform_first = fn
        return self.transform(first, lazy)


class SimpleDataset(Dataset):
    def __init__(self, data):
        self._data = data

    def __len__(self):
        return len(self._data)

    def __getitem__(self, idx):
        return self._data[idx]


class _LazyTransformDataset(Dataset):
    def __init__(self, data, fn):
        self._data = data
        self._fn = fn

    def __len__(self):
        return len(self._data)

    def __getitem__(self, idx):
        item = self._data[idx]
        if isinstance(item, tuple):
            return self._fn(*item)
        return self._fn(item)


class ArrayDataset(Dataset):
    def __init__(self, *args):
        assert len(args) > 0
        self._length = len(args[0])
        self._data = []
        for a in args:
            assert len(a) == self._length, "all arrays must be same length"
            self._data.append(a)

    def __len__(self):
        return self._length

    def __getitem__(self, idx):
        if len(self._data) == 1:
            return self._data[0][idx]
        return tuple(d[idx] for d in self._data)


class RecordFileDataset(Dataset):
    """Dataset over an indexed RecordIO file: item ``i`` is the raw
    bytes of the ``i``-th record (ref: data/dataset.py)."""

    def __init__(self, filename):
        import threading

        from ...recordio import MXIndexedRecordIO
        idx_file = filename[:filename.rfind(".")] + ".idx"
        self._record = MXIndexedRecordIO(idx_file, filename, "r")
        # read_idx is a seek and a read on one handle; the DataLoader's
        # pool threads call it at once
        self._read_lock = threading.Lock()

    def __len__(self):
        return len(self._record.keys)

    def __getitem__(self, idx):
        with self._read_lock:
            return self._record.read_idx(self._record.keys[idx])
