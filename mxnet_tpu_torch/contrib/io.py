"""Contrib IO bridges (ref: python/mxnet/contrib/io.py; the port of
``mxnet_tpu/contrib/io.py``): ``DataLoaderIter`` wraps a gluon
DataLoader in the DataIter interface, so Module code consumes gluon
data pipelines."""
from __future__ import annotations

from ..io.io import DataBatch, DataDesc, DataIter
from ..ndarray.ndarray import NDArray


class DataLoaderIter(DataIter):
    """Present a ``gluon.data.DataLoader`` as a ``DataIter`` (ref:
    contrib/io.py DataLoaderIter). The loader must yield fixed-size
    batches of (data,) or (data, label)."""

    def __init__(self, loader, data_name="data", label_name="softmax_label"):
        sampler = getattr(loader, "_batch_sampler", None)
        super().__init__(batch_size=getattr(sampler, "_batch_size", 0)
                         or getattr(loader, "_batch_size", 0))
        self._loader = loader
        self._iter = None
        self._data_name = data_name
        self._label_name = label_name
        self._first = None
        self._provide_data = None
        self._provide_label = None

    def _peek(self):
        # guard on the descriptor cache, NOT on _first: next() reads
        # provide_data after consuming _first, and priming again there
        # would restart the loader forever
        if self._provide_data is None:
            self._iter = iter(self._loader)
            self._first = next(self._iter)
            sample = self._first
            if isinstance(sample, (list, tuple)):
                data, label = sample[0], (sample[1] if len(sample) > 1
                                          else None)
            else:
                data, label = sample, None
            self.batch_size = data.shape[0]
            self._provide_data = [DataDesc(self._data_name, data.shape,
                                           data.dtype)]
            self._provide_label = ([DataDesc(self._label_name, label.shape,
                                             label.dtype)]
                                   if label is not None else [])
        return self._first

    @property
    def provide_data(self):
        self._peek()
        return self._provide_data

    @property
    def provide_label(self):
        self._peek()
        return self._provide_label

    def reset(self):
        self._iter = None
        self._first = None

    def next(self):
        self._peek()         # a no-op once the descriptors are cached
        if self._iter is None:
            self._iter = iter(self._loader)
        if self._first is not None:
            sample, self._first = self._first, None
        else:
            sample = next(self._iter)
        if isinstance(sample, (list, tuple)):
            data = [sample[0]]
            label = [sample[1]] if len(sample) > 1 else []
        else:
            data, label = [sample], []
        data = [d if isinstance(d, NDArray) else NDArray(d) for d in data]
        label = [lb if isinstance(lb, NDArray) else NDArray(lb)
                 for lb in label]
        return DataBatch(data=data, label=label, pad=0,
                         provide_data=self.provide_data,
                         provide_label=self.provide_label)
