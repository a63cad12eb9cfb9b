"""Data iterators (the subset of ``mxnet_tpu/io/io.py`` calibration
iterates): batches are assembled with numpy on the host and handed out
as NDArrays on the current context."""
from __future__ import annotations

import numpy as np

from ..base import MXNetError
from ..ndarray import NDArray, array


class DataDesc:
    """Named shape/dtype/layout of one input (ref: io.py DataDesc)."""

    def __init__(self, name, shape, dtype="float32", layout="NCHW"):
        self.name = name
        self.shape = tuple(shape)
        self.dtype = np.dtype(dtype)
        self.layout = layout

    def __repr__(self):
        return (f"DataDesc[{self.name},{self.shape},{self.dtype},"
                f"{self.layout}]")

    def __iter__(self):  # tuple-compat: name, shape
        return iter((self.name, self.shape))


class DataBatch:
    """One batch: data/label lists + pad/index bookkeeping."""

    def __init__(self, data, label=None, pad=None, index=None):
        self.data = data
        self.label = label
        self.pad = pad
        self.index = index

    def __repr__(self):
        shapes = [getattr(d, "shape", None) for d in (self.data or [])]
        return f"DataBatch: data shapes {shapes} pad {self.pad}"


class DataIter:
    """Iterator base (ref: io.py DataIter)."""

    def __init__(self, batch_size=0):
        self.batch_size = batch_size

    def __iter__(self):
        return self

    def reset(self):
        pass

    def next(self):
        if self.iter_next():
            return DataBatch(data=self.getdata(), label=self.getlabel(),
                             pad=self.getpad(), index=self.getindex())
        raise StopIteration

    __next__ = next

    def iter_next(self):
        raise NotImplementedError

    def getdata(self):
        raise NotImplementedError

    def getlabel(self):
        raise NotImplementedError

    def getindex(self):
        return None

    def getpad(self):
        raise NotImplementedError


def _init_data(data, allow_empty, default_name):
    """Canonicalize data/label into an ordered [(name, ndarray)] list."""
    if data is None:
        if not allow_empty:
            raise MXNetError("data must be provided")
        return []
    if isinstance(data, (np.ndarray, NDArray)):
        data = [data]
    if isinstance(data, (list, tuple)):
        if not allow_empty and len(data) == 0:
            raise MXNetError("empty data")
        if len(data) == 1:
            data = {default_name: data[0]}
        else:
            data = {f"_{i}_{default_name}": d for i, d in enumerate(data)}
    if not isinstance(data, dict):
        raise MXNetError(f"unsupported data type {type(data)}")
    return [(k, v.asnumpy() if isinstance(v, NDArray) else np.asarray(v))
            for k, v in data.items()]


class NDArrayIter(DataIter):
    """Iterate over in-memory arrays (ref: io.py NDArrayIter), in order
    or shuffled; ``last_batch_handle`` "pad" wraps the last batch
    around to the first samples, "discard" drops it."""

    def __init__(self, data, label=None, batch_size=1, shuffle=False,
                 last_batch_handle="pad", data_name="data",
                 label_name="softmax_label", seed=None):
        super().__init__(batch_size)
        if last_batch_handle not in ("pad", "discard"):
            raise MXNetError(f"last_batch_handle {last_batch_handle!r} "
                             "unsupported (pad or discard)")
        self.data = _init_data(data, allow_empty=False,
                               default_name=data_name)
        self.label = _init_data(label, allow_empty=True,
                                default_name=label_name)
        self.num_data = self.data[0][1].shape[0]
        self.shuffle = shuffle
        self.last_batch_handle = last_batch_handle
        self.idx = np.arange(self.num_data)
        self._rng = np.random.RandomState(seed) if seed is not None \
            else np.random
        self.reset()

    @property
    def provide_data(self):
        return [DataDesc(k, (self.batch_size,) + v.shape[1:], v.dtype)
                for k, v in self.data]

    @property
    def provide_label(self):
        return [DataDesc(k, (self.batch_size,) + v.shape[1:], v.dtype)
                for k, v in self.label]

    def reset(self):
        self.cursor = -self.batch_size
        if self.shuffle:
            self._rng.shuffle(self.idx)

    def iter_next(self):
        self.cursor += self.batch_size
        if self.last_batch_handle == "discard":
            return self.cursor + self.batch_size <= self.num_data
        return self.cursor < self.num_data

    def _take(self, arrays):
        end = self.cursor + self.batch_size
        sel = self.idx[self.cursor:end]
        if end > self.num_data:
            sel = np.concatenate([sel, self.idx[:end - self.num_data]])
        return [array(v[sel]) for _, v in arrays]

    def getdata(self):
        return self._take(self.data)

    def getlabel(self):
        return self._take(self.label)

    def getpad(self):
        end = self.cursor + self.batch_size
        if self.last_batch_handle == "pad" and end > self.num_data:
            return end - self.num_data
        return 0

    def getindex(self):
        return self.idx[self.cursor:self.cursor + self.batch_size]
