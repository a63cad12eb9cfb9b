"""Data iterators (the port of ``mxnet_tpu/io/io.py``): batches are
assembled with numpy on the host and handed out as NDArrays on the
current context. ``NDArrayIter``, ``ResizeIter``, ``PrefetchingIter``,
the file iterators ``CSVIter``, ``MNISTIter`` and ``LibSVMIter``, and
``ImageRecordIter`` over RecordIO files give the JAX package's batches
for the same inputs and seed, and checkpoint their position
(``state_dict``) with its semantics. ``ImageRecordIter(num_workers=N)``
routes to the sharded decode pipeline of ``pipeline.py``.

Every ``__next__`` runs under a ``data_next`` span and feeds the
``mx_io_data_wait_seconds`` histogram and the step breakdown's
data_time, and tags the batch's arrays with the ``io_buffer`` census
role (``profiling.memory``). Not ported yet: the host dependency
engine's scheduling of the in-process ``ImageRecordIter`` (it runs the
producer thread that ``MXTPU_IO_HOST_ENGINE=0`` selects in the JAX
package).
"""
from __future__ import annotations

import queue
import struct
import threading
import time
import warnings

import numpy as np
import torch

from .. import tracing as _tracing
from ..base import MXNetError
from ..context import current_context
from ..ndarray import NDArray, array
from ..telemetry import metrics as _tm
from ..telemetry import step as _tm_step

_data_wait_hist = _tm.lazy_metrics(lambda reg: reg.histogram(
    "mx_io_data_wait_seconds",
    "host time per batch spent in DataIter.next (assembly or "
    "prefetch-queue wait)").labels())   # cached series


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

    @staticmethod
    def get_batch_axis(layout):
        if layout is None:
            return 0
        return layout.find("N")


class DataBatch:
    """One batch: data/label lists + pad/index bookkeeping."""

    def __init__(self, data, label=None, pad=None, index=None,
                 bucket_key=None, provide_data=None, provide_label=None):
        self.data = data
        self.label = label
        self.pad = pad
        self.index = index
        self.bucket_key = bucket_key
        self.provide_data = provide_data
        self.provide_label = provide_label

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

    def __next__(self):
        # the data-wait seam: every `for batch in it` loop passes here,
        # so one timer feeds both the io histogram and the step
        # breakdown's data_time, whatever iterator is underneath; the
        # span is the causal record of the same wait
        with _tracing.span("data_next", cat="io",
                           iter=type(self).__name__):
            if not _tm.enabled():
                return self._tag_batch(self.next())
            t0 = time.perf_counter()
            batch = self.next()   # StopIteration propagates untimed
            dt = time.perf_counter() - t0
            _data_wait_hist().observe(dt)
            _tm_step.add_data_wait(dt)
            return self._tag_batch(batch)

    @staticmethod
    def _tag_batch(batch):
        """Tag the batch's arrays with the ``io_buffer`` census role (a
        weak side-table write an array)."""
        from ..profiling import memory as _mem
        if _mem.census_enabled():
            for arrs in (getattr(batch, "data", None) or (),
                         getattr(batch, "label", None) or ()):
                for a in arrs:
                    _mem.tag_role(a, "io_buffer")
        return batch

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

    def state_dict(self):
        """Resumable position; iterators that support exact resume
        override this."""
        raise MXNetError(
            f"{type(self).__name__} does not support checkpoint resume "
            "(state_dict): wrap the data in NDArrayIter")

    def load_state_dict(self, state):
        raise MXNetError(
            f"{type(self).__name__} does not support checkpoint resume "
            "(load_state_dict)")


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
    or shuffled. ``last_batch_handle``: "pad" wraps the last batch
    around to the first samples, "discard" drops it, "roll_over" leads
    the next epoch with its samples. ``seed=None`` shuffles with numpy's
    global stream; a seed gives the iterator its own ``RandomState``,
    which ``state_dict`` captures."""

    def __init__(self, data, label=None, batch_size=1, shuffle=False,
                 last_batch_handle="pad", data_name="data",
                 label_name="softmax_label", seed=None):
        super().__init__(batch_size)
        if last_batch_handle not in ("pad", "discard", "roll_over"):
            raise MXNetError(f"last_batch_handle {last_batch_handle!r} "
                             "unsupported (pad, discard or roll_over)")
        self.data = _init_data(data, allow_empty=False,
                               default_name=data_name)
        self.label = _init_data(label, allow_empty=True,
                                default_name=label_name)
        self.num_data = self.data[0][1].shape[0]
        self.shuffle = shuffle
        self.last_batch_handle = last_batch_handle
        self.idx = np.arange(self.num_data)
        self._seed = seed
        self._shuffle_rng = (np.random.RandomState(seed)
                             if seed is not None else None)
        self._epochs = 0
        # roll_over: the samples of the trailing partial batch
        self._cache = np.array([], dtype=np.int64)
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
        self._epochs += 1
        if self.shuffle:
            (self._shuffle_rng if self._shuffle_rng is not None
             else np.random).shuffle(self.idx)
        if self.last_batch_handle == "roll_over" and len(self._cache):
            # cleared only when a batch is taken, so two resets in a row
            # keep the carried samples
            self._order = np.concatenate([self._cache, self.idx])
        else:
            self._order = self.idx

    def iter_next(self):
        self.cursor += self.batch_size
        if self.last_batch_handle == "discard":
            return self.cursor + self.batch_size <= self.num_data
        if self.last_batch_handle == "roll_over":
            n = len(self._order)
            if self.cursor + self.batch_size <= n:
                return True
            if self.cursor < n:
                self._cache = self._order[self.cursor:].copy()
            return False
        return self.cursor < self.num_data

    def _take(self, arrays):
        self._cache = np.array([], dtype=np.int64)
        end = self.cursor + self.batch_size
        sel = self._order[self.cursor:end]
        if end > len(self._order):     # pad by wrapping around
            sel = np.concatenate([sel, self._order[:end - len(self._order)]])
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
        end = min(self.cursor + self.batch_size, len(self._order))
        return self._order[self.cursor:end]

    def state_dict(self):
        """The exact position: epoch counter, cursor, this epoch's order,
        the roll_over cache and the iterator's own shuffle stream (when
        seeded), in the JAX package's layout."""
        return {
            "version": 1, "type": "NDArrayIter",
            "num_data": int(self.num_data),
            "batch_size": int(self.batch_size),
            "shuffle": bool(self.shuffle),
            "last_batch_handle": self.last_batch_handle,
            "epoch": int(self._epochs),
            "cursor": int(self.cursor),
            "seed": self._seed,
            "idx": self.idx.copy(),
            "order": self._order.copy(),
            "cache": self._cache.copy(),
            "rng": (self._shuffle_rng.get_state()
                    if self._shuffle_rng is not None else None),
        }

    def load_state_dict(self, state):
        if not isinstance(state, dict) or \
                state.get("type") != "NDArrayIter" or \
                state.get("version") != 1:
            raise MXNetError(
                "load_state_dict: not a version-1 NDArrayIter state")
        if int(state["num_data"]) != self.num_data:
            raise MXNetError(
                f"load_state_dict: iterator holds {self.num_data} samples "
                f"but the state was captured over {state['num_data']}")
        for attr in ("batch_size", "shuffle", "last_batch_handle"):
            if state.get(attr) != getattr(self, attr):
                raise MXNetError(
                    f"load_state_dict: iterator {attr}="
                    f"{getattr(self, attr)!r} but the state was captured "
                    f"with {attr}={state.get(attr)!r}")
        self._epochs = int(state["epoch"])
        self.cursor = int(state["cursor"])
        self.idx = np.asarray(state["idx"])
        self._order = np.asarray(state["order"])
        self._cache = np.asarray(state["cache"])
        if state.get("rng") is not None:
            if self._shuffle_rng is None:
                self._shuffle_rng = np.random.RandomState()
            self._shuffle_rng.set_state(state["rng"])
            self._seed = state.get("seed")


class ResizeIter(DataIter):
    """Clip or extend an iterator to ``size`` batches an epoch (ref:
    io.py ResizeIter): past the inner end it resets the inner iterator
    and goes on."""

    def __init__(self, data_iter, size, reset_internal=True):
        super().__init__(data_iter.batch_size)
        self.data_iter = data_iter
        self.size = size
        self.reset_internal = reset_internal
        self.cur = 0
        self.current_batch = None

    @property
    def provide_data(self):
        return self.data_iter.provide_data

    @property
    def provide_label(self):
        return self.data_iter.provide_label

    def reset(self):
        self.cur = 0
        if self.reset_internal:
            self.data_iter.reset()

    def iter_next(self):
        if self.cur == self.size:
            return False
        try:
            self.current_batch = self.data_iter.next()
        except StopIteration:
            self.data_iter.reset()
            self.current_batch = self.data_iter.next()
        self.cur += 1
        return True

    def next(self):
        if self.iter_next():
            return self.current_batch
        raise StopIteration

    def getdata(self):
        return self.current_batch.data

    def getlabel(self):
        return self.current_batch.label

    def getpad(self):
        return self.current_batch.pad

    def getindex(self):
        return self.current_batch.index


def _batch_arrays(batch):
    return [*(batch.data or []), *(batch.label or [])]


def _next_all(iters):
    """The next batch of every iterator, until the first is exhausted."""
    while True:
        try:
            batches = [it.next() for it in iters]
        except StopIteration:
            return
        yield batches


def _feed(arrays, device, stream):
    """``arrays`` (NDArrays) moved to ``device`` for the device feeder
    (``pipeline.DeviceFeeder``): on a CUDA device, host arrays are pinned
    (a copy, unless they already are) and copied on the side ``stream``,
    and the event returned marks their arrival (None when nothing was
    copied that way)."""
    if device.type != "cuda":
        for a in arrays:
            a._data = a._data.to(device)
        return None
    with torch.cuda.stream(stream):
        for a in arrays:
            if a._data.device != device:
                a._data = a._data.pin_memory().to(device, non_blocking=True)
        event = torch.cuda.Event()
        event.record(stream)
    return event


class PrefetchingIter(DataIter):
    """A background thread runs one or more iterators ahead of the
    consumer (ref: io.py PrefetchingIter), ``prefetch_depth`` batches
    deep; several iterators' batches are concatenated.

    The producer (a ``pipeline.DeviceFeeder``) starts at the first
    :meth:`next` or :meth:`reset`, so the reset ``Module.fit`` makes
    before its first batch reads nothing ahead of it, and builds batches
    in the context current when the iterator was made (or last reset).
    ``prefetch_to_device=True`` builds them on the host and moves each
    batch to that context's device: on a CUDA device from pinned host
    memory on a side stream, while the consumer computes; :meth:`next`
    makes the consumer's current stream wait for the copy and records
    the stream on the arrays, so the batch is safe to use and to free
    there. ``sharding=`` (a ``parallel.NamedSharding``) lays each
    batch's arrays out over its mesh in the producer, as
    ``pipeline.to_device`` does, so a dp Module or a sharded step takes
    them in place (the JAX package does so only with
    ``prefetch_to_device``; the port whenever a sharding is given).
    ``feeder.wait_seconds`` is the time :meth:`next` spent blocked.

    ``state_dict`` is (inner state at the epoch's start, batches
    delivered to the caller), as in the JAX package: the producer's
    look-ahead is not part of it, and resume replays the delivered
    batches."""

    def __init__(self, iters, rename_data=None, rename_label=None,
                 prefetch_depth=2, prefetch_to_device=False, sharding=None):
        if not isinstance(iters, (list, tuple)):
            iters = [iters]
        super().__init__(iters[0].batch_size)
        self.iters = iters
        self.rename_data = rename_data
        self.rename_label = rename_label
        self._depth = prefetch_depth
        self._to_device = prefetch_to_device
        self._sharding = sharding
        self.feeder = None
        self._ctx = current_context()
        self._inner_state0 = self._capture_inner()
        self._delivered = 0

    def _capture_inner(self):
        try:
            return [it.state_dict() for it in self.iters]
        except MXNetError:
            return None

    def _start(self):
        from .pipeline import DeviceFeeder
        with self._ctx:
            self.feeder = DeviceFeeder(_next_all(self.iters),
                                       depth=self._depth,
                                       sharding=self._sharding,
                                       to_device=self._to_device)

    @property
    def provide_data(self):
        if self.rename_data is None:
            return sum([i.provide_data for i in self.iters], [])
        return sum([[DataDesc(r.get(d.name, d.name), d.shape, d.dtype)
                     for d in i.provide_data]
                    for r, i in zip(self.rename_data, self.iters)], [])

    @property
    def provide_label(self):
        if self.rename_label is None:
            return sum([i.provide_label for i in self.iters], [])
        return sum([[DataDesc(r.get(d.name, d.name), d.shape, d.dtype)
                     for d in i.provide_label]
                    for r, i in zip(self.rename_label, self.iters)], [])

    def _stop_producer(self):
        if self.feeder is not None:
            self.feeder.close()

    def reset(self):
        self._stop_producer()
        for it in self.iters:
            it.reset()
        self._ctx = current_context()
        self._inner_state0 = self._capture_inner()
        self._delivered = 0
        self._start()

    def next(self):
        if self.feeder is None:
            self._start()
        batches = self.feeder.get()
        self._delivered += 1
        if len(batches) == 1:
            return batches[0]
        return DataBatch(data=sum([b.data for b in batches], []),
                         label=sum([(b.label or []) for b in batches], []),
                         pad=max(b.pad or 0 for b in batches))

    def iter_next(self):
        raise NotImplementedError("use next()")

    def state_dict(self):
        if self._inner_state0 is None:
            raise MXNetError(
                "PrefetchingIter cannot checkpoint: the wrapped iterator "
                f"{type(self.iters[0]).__name__} does not support "
                "state_dict")
        return {"version": 1, "type": "PrefetchingIter",
                "inner0": self._inner_state0,
                "delivered": int(self._delivered)}

    def load_state_dict(self, state):
        if not isinstance(state, dict) or \
                state.get("type") != "PrefetchingIter" or \
                state.get("version") != 1:
            raise MXNetError(
                "load_state_dict: not a version-1 PrefetchingIter state")
        self._stop_producer()
        delivered = int(state["delivered"])
        for it, st in zip(self.iters, state["inner0"]):
            it.load_state_dict(st)
        self._inner_state0 = state["inner0"]
        self._delivered = 0
        self._start()
        for _ in range(delivered):
            self.next()


class _WrapIter(DataIter):
    """Delegate to an inner iterator with a one-batch look-ahead, so both
    protocols work: ``for b in it`` and ``while it.iter_next(): b =
    it.next()``."""

    _inner = None

    def __init__(self, batch_size):
        super().__init__(batch_size)
        self._cache = None

    @property
    def provide_data(self):
        return self._inner.provide_data

    @property
    def provide_label(self):
        return self._inner.provide_label

    def reset(self):
        self._cache = None
        self._inner.reset()

    def iter_next(self):
        if self._cache is None:
            try:
                self._cache = self._inner.next()
            except StopIteration:
                return False
        return True

    def next(self):
        if self._cache is not None:
            b, self._cache = self._cache, None
            return b
        return self._inner.next()

    def state_dict(self):
        if self._cache is not None:
            raise MXNetError(
                f"cannot checkpoint {type(self).__name__} with an "
                "un-consumed look-ahead batch: capture state after next()")
        return {"version": 1, "type": type(self).__name__,
                "inner": self._inner.state_dict()}

    def load_state_dict(self, state):
        if not isinstance(state, dict) or \
                state.get("type") != type(self).__name__ or \
                state.get("version") != 1:
            raise MXNetError(f"load_state_dict: not a version-1 "
                             f"{type(self).__name__} state")
        self._cache = None
        self._inner.load_state_dict(state["inner"])


class CSVIter(_WrapIter):
    """CSV files (ref: src/io/iter_csv.cc)."""

    def __init__(self, data_csv, data_shape, label_csv=None,
                 label_shape=(1,), batch_size=1, round_batch=True,
                 dtype="float32"):
        super().__init__(batch_size)
        data = np.loadtxt(data_csv, delimiter=",", dtype=dtype, ndmin=2)
        data = data.reshape((-1,) + tuple(data_shape))
        if label_csv is not None:
            label = np.loadtxt(label_csv, delimiter=",", dtype=dtype,
                               ndmin=2).reshape((-1,) + tuple(label_shape))
        else:
            label = np.zeros((data.shape[0], 1), dtype=dtype)
        if tuple(label_shape) == (1,):
            label = label.reshape(-1)
        self._inner = NDArrayIter(
            {"data": data}, {"softmax_label": label}, batch_size=batch_size,
            last_batch_handle="pad" if round_batch else "discard")


class MNISTIter(_WrapIter):
    """MNIST idx files, plain or gzipped (ref: src/io/iter_mnist.cc):
    images scaled to [0, 1], NCHW or flat, shuffled with the iterator's
    own ``seed``, the last partial batch dropped."""

    def __init__(self, image, label, batch_size=128, shuffle=True,
                 flat=False, seed=0, silent=True, input_shape=None,
                 num_parts=1, part_index=0):
        super().__init__(batch_size)
        imgs = self._read_idx(image)
        lbls = self._read_idx(label)
        if num_parts > 1:
            imgs = imgs[part_index::num_parts]
            lbls = lbls[part_index::num_parts]
        imgs = imgs.astype(np.float32) / 255.0
        if flat:
            imgs = imgs.reshape(imgs.shape[0], -1)
        else:
            imgs = imgs.reshape(imgs.shape[0], 1, *imgs.shape[1:])
        if input_shape:
            imgs = imgs.reshape((imgs.shape[0],) + tuple(input_shape))
        self._inner = NDArrayIter(
            {"data": imgs}, {"softmax_label": lbls.astype(np.float32)},
            batch_size=batch_size, shuffle=shuffle,
            last_batch_handle="discard", seed=seed)

    @staticmethod
    def _read_idx(path):
        import gzip
        op = gzip.open if str(path).endswith(".gz") else open
        with op(path, "rb") as f:
            raw = f.read()
        magic, = struct.unpack(">i", raw[:4])
        ndim = magic & 0xFF
        dims = struct.unpack(">" + "i" * ndim, raw[4:4 + 4 * ndim])
        return np.frombuffer(raw, dtype=np.uint8,
                             offset=4 + 4 * ndim).reshape(dims)


class LibSVMIter(_WrapIter):
    """LibSVM text files (ref: src/io/iter_libsvm.cc), densified on the
    host as the JAX package does."""

    def __init__(self, data_libsvm, data_shape, label_shape=(1,),
                 batch_size=1, round_batch=True):
        super().__init__(batch_size)
        n_feat = int(np.prod(data_shape))
        rows, labels = [], []
        with open(data_libsvm) as f:
            for line in f:
                parts = line.strip().split()
                if not parts:
                    continue
                labels.append(float(parts[0]))
                row = np.zeros(n_feat, dtype=np.float32)
                for tok in parts[1:]:
                    i, v = tok.split(":")
                    row[int(i)] = float(v)
                rows.append(row)
        data = np.stack(rows).reshape((-1,) + tuple(data_shape))
        label = np.asarray(labels, np.float32).reshape(
            (-1,) + tuple(label_shape))
        if tuple(label_shape) == (1,):
            label = label.reshape(-1)
        self._inner = NDArrayIter(
            {"data": data}, {"softmax_label": label}, batch_size=batch_size,
            last_batch_handle="pad" if round_batch else "discard")


class ImageRecordIter(DataIter):
    """RecordIO-packed image iterator with augmentation (ref:
    src/io/iter_image_recordio_2.cc:50 ImageRecordIOParser2).

    The .rec file is indexed once (offsets only: records stream from
    disk, the file is never loaded into memory). ``num_workers > 0`` (or
    ``MXTPU_IO_WORKERS``) routes to :class:`pipeline.ShardedRecordPipeline`:
    N worker processes, each driving its own libjpeg pool into a
    shared-memory ring, with the same record format and augment
    semantics. Otherwise, and with ``resize=`` or records that do not
    divide into ``num_workers x batch_size``, a producer thread reads,
    decodes (the native libjpeg batch decoder where every payload is a
    JPEG, else per record through libjpeg, cv2 or PIL on a thread pool)
    and emits batches in order, ``prefetch_buffer`` ahead. Batches are
    made on the context current at construction or the last reset.

    The in-process iterator's random crops and mirrors are drawn per
    decode thread (seeded with ``seed`` + the thread's id), so they are
    not reproducible across processes; the sharded pipeline draws them
    per (worker, batch) and is.
    """

    _SENTINEL = object()

    def __new__(cls, path_imgrec=None, data_shape=None, batch_size=1,
                label_width=1, shuffle=False, rand_crop=False,
                rand_mirror=False, mean_r=0.0, mean_g=0.0, mean_b=0.0,
                std_r=1.0, std_g=1.0, std_b=1.0, resize=-1,
                round_batch=True, preprocess_threads=4, prefetch_buffer=2,
                seed=0, num_workers=None, **kwargs):
        from .pipeline import ShardedRecordPipeline, io_workers_default
        if num_workers is None:
            num_workers = io_workers_default()
        if num_workers and int(num_workers) > 0 and resize <= 0:
            from ..recordio import load_record_offsets
            offsets = load_record_offsets(path_imgrec)
            if len(offsets) % (int(num_workers) * batch_size) == 0:
                return ShardedRecordPipeline(
                    path_imgrec, data_shape, batch_size=batch_size,
                    num_workers=int(num_workers), label_width=label_width,
                    shuffle=shuffle, rand_crop=rand_crop,
                    rand_mirror=rand_mirror, mean=(mean_r, mean_g, mean_b),
                    std=(std_r, std_g, std_b), seed=seed,
                    streaming=bool(kwargs.get("streaming", False)),
                    readahead_mb=kwargs.get("readahead_mb"),
                    ring_batches=kwargs.get("ring_batches"),
                    timeout=kwargs.get("timeout", 120.0), offsets=offsets)
            warnings.warn(
                f"ImageRecordIter: {len(offsets)} records do not divide "
                f"into num_workers={num_workers} x batch_size="
                f"{batch_size}: the sharded pipeline would drop the "
                "remainder each epoch, so the in-process iterator runs "
                "(pad the .rec or change workers or batch to engage the "
                "pipeline)", stacklevel=2)
        return super().__new__(cls)

    def __init__(self, path_imgrec, data_shape, batch_size=1,
                 label_width=1, shuffle=False, rand_crop=False,
                 rand_mirror=False, mean_r=0.0, mean_g=0.0, mean_b=0.0,
                 std_r=1.0, std_g=1.0, std_b=1.0, resize=-1,
                 round_batch=True, preprocess_threads=4, prefetch_buffer=2,
                 seed=0, num_workers=None, **kwargs):
        super().__init__(batch_size)
        self.data_shape = tuple(data_shape)
        self.label_width = label_width
        self.rand_crop = rand_crop
        self.rand_mirror = rand_mirror
        self.mean = np.array([mean_r, mean_g, mean_b],
                             np.float32).reshape(3, 1, 1)
        self.std = np.array([std_r, std_g, std_b],
                            np.float32).reshape(3, 1, 1)
        self.resize = resize
        self.shuffle = shuffle
        self._nthreads = max(int(preprocess_threads), 1)
        self._nbuffer = max(int(prefetch_buffer), 1)
        self._epoch_rng = np.random.RandomState(seed)
        self._aug_seed = seed
        self._aug_local = threading.local()
        from ..recordio import load_record_offsets
        self._file = open(path_imgrec, "rb")
        self._io_lock = threading.Lock()
        self._offsets = load_record_offsets(path_imgrec)
        self._pool = None
        self._producer = None
        self._gen = 0
        # the native threaded libjpeg decoder (the reference's OMP
        # decode, iter_image_recordio_2.cc:445); None only on a host
        # without libjpeg
        self._native = None
        if self.data_shape[0] == 3:
            from .._native import load_imgdec
            self._native = load_imgdec()
        # checkpoint-resume bookkeeping: epochs begun, batches handed to
        # the caller this epoch, and the epoch RNG state captured before
        # the epoch's shuffle (so a resume regenerates the same order)
        self._epochs = 0
        self._consumed = 0
        self._rng_at_reset = self._epoch_rng.get_state()
        self.reset()

    def _read_at(self, off):
        from ..recordio import _LFLAG_MASK, _MAGIC
        with self._io_lock:
            self._file.seek(off)
            magic, lrec = struct.unpack("<II", self._file.read(8))
            if magic != _MAGIC:
                raise MXNetError(f"invalid RecordIO magic at {off}")
            return self._file.read(lrec & _LFLAG_MASK)

    @property
    def provide_data(self):
        return [DataDesc("data", (self.batch_size,) + self.data_shape)]

    @property
    def provide_label(self):
        shape = ((self.batch_size,) if self.label_width == 1
                 else (self.batch_size, self.label_width))
        return [DataDesc("softmax_label", shape)]

    def reset(self):
        self._gen += 1
        gen = self._gen
        if self._producer is not None:
            self._producer.join(timeout=5)
            self._producer = None
        self._peek = None
        self._rng_at_reset = self._epoch_rng.get_state()
        self._epochs += 1
        self._consumed = 0
        order = np.arange(len(self._offsets))
        if self.shuffle:
            self._epoch_rng.shuffle(order)
        self._queue = queue.Queue(self._nbuffer)
        self._producer = threading.Thread(
            target=self._produce, args=(gen, order, self._queue,
                                        current_context()),
            daemon=True)
        self._producer.start()

    def _produce(self, gen, order, q, ctx):
        """Stream raw records, decode a batch at a time, emit batches on
        ``ctx``; exits promptly when reset() bumps the generation."""
        try:
            n = (len(order) // self.batch_size) * self.batch_size
            for start in range(0, n, self.batch_size):
                if self._gen != gen:
                    return
                sel = order[start:start + self.batch_size]
                raws = [self._read_at(self._offsets[i]) for i in sel]
                imgs, labels = self._decode_batch(raws)
                if self.label_width == 1:
                    labels = labels[:, 0]
                with ctx:
                    batch = DataBatch(data=[array(imgs)],
                                      label=[array(labels)], pad=0)
                self._put(gen, q, batch)
        except Exception as e:  # noqa: BLE001 (raised in next())
            self._put(gen, q, e)
            return
        self._put(gen, q, self._SENTINEL)

    def _decode_batch(self, raws):
        """One batch of raw records -> (imgs NCHW f32, labels): the
        native libjpeg pool when possible, else the per-record path on
        a thread pool."""
        native = self._try_native_batch(raws)
        if native is not None:
            return native
        if self._pool is None and self._nthreads > 1:
            from multiprocessing.pool import ThreadPool
            self._pool = ThreadPool(self._nthreads)
        if self._pool is not None:
            results = self._pool.map(self._decode, raws)
        else:
            results = [self._decode(r) for r in raws]
        imgs = np.stack([r[0] for r in results])
        labels = np.stack([r[1][:self.label_width] for r in results])
        return imgs, labels

    def _put(self, gen, q, item):
        while self._gen == gen:
            try:
                q.put(item, timeout=0.1)
                return
            except queue.Full:
                continue

    def close(self):
        self._gen += 1  # stops the producer at its next put or check
        if self._producer is not None:
            self._producer.join(timeout=5)
            self._producer = None
        if self._pool is not None:
            self._pool.terminate()
            self._pool = None
        if self._file is not None and not self._file.closed:
            self._file.close()

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001 (interpreter shutdown)
            pass

    def _try_native_batch(self, raws):
        """Decode a whole batch through the C++ libjpeg pool; None when
        the host has no libjpeg, ``resize`` is set (the shorter-side
        resize runs in the per-record path) or a payload is no JPEG."""
        if self._native is None or self.resize > 0:
            return None
        from .. import _native
        from ..recordio import unpack
        c, h, w = self.data_shape
        n = len(raws)
        payloads, labels = [], []
        for raw in raws:
            header, payload = unpack(raw)
            if payload[:2] != b"\xff\xd8":
                return None
            payloads.append(payload)
            label = header.label
            if isinstance(label, (int, float)):
                label = np.array([label], np.float32)
            labels.append(np.asarray(label, np.float32)[:self.label_width])
        rng = self._rng()
        if self.rand_crop:
            uv = rng.rand(n, 2).astype(np.float32)
        else:
            uv = np.full((n, 2), -1.0, np.float32)
        mirror = ((rng.rand(n) < 0.5) if self.rand_mirror
                  else np.zeros(n)).astype(np.uint8)
        out = _native.decode_batch(payloads, h, w, uv, mirror,
                                   self.mean.ravel(), self.std.ravel(),
                                   nthreads=self._nthreads)
        return out, np.stack(labels)

    def decoders(self):
        """The decoders this iterator decodes JPEG payloads with: the
        native ``libjpeg`` where the host has it, else the per-record
        path's ``cv2`` (BGR, flipped to RGB) or ``pil``."""
        if self._native is not None:
            return ["libjpeg"]
        from ..recordio import cv2_present
        return ["cv2"] if cv2_present() else ["pil"]

    @staticmethod
    def _resize_shorter(img, size):
        """Resize so the shorter side equals ``size`` (the reference's
        resize= augmentation, image_aug_default.cc)."""
        from PIL import Image
        ih, iw = img.shape[:2]
        if ih < iw:
            nh, nw = size, max(int(round(iw * size / ih)), size)
        else:
            nh, nw = max(int(round(ih * size / iw)), size), size
        return np.asarray(Image.fromarray(img.astype(np.uint8))
                          .resize((nw, nh), Image.BILINEAR))

    def _rng(self):
        rng = getattr(self._aug_local, "rng", None)
        if rng is None:
            rng = np.random.RandomState(
                (self._aug_seed + threading.get_ident()) % (2 ** 31))
            self._aug_local.rng = rng
        return rng

    def _decode(self, raw):
        from .._native import decode_jpeg
        from ..recordio import cv2_present, unpack, unpack_img
        header, payload = unpack(raw)
        c, h, w = self.data_shape
        try:
            img = decode_jpeg(payload)        # native libjpeg, RGB HWC
            if img is None:
                _, img = unpack_img(raw)      # HWC uint8
                if img.ndim == 2:
                    img = img[:, :, None].repeat(3, axis=2)
                if cv2_present() and payload[:6] != b"\x93NUMPY":
                    # cv2 decodes BGR; the pipeline is RGB (npy payloads
                    # bypass cv2 inside unpack_img)
                    img = img[:, :, ::-1]
            if self.resize > 0:
                img = self._resize_shorter(img, self.resize)
            img = img.astype(np.float32).transpose(2, 0, 1)  # CHW
        except Exception:  # noqa: BLE001 (a raw float32 CHW payload)
            img = np.frombuffer(payload, np.float32)
            img = img.reshape(self.data_shape)
        rng = self._rng()
        _, ih, iw = img.shape
        if (ih, iw) != (h, w):
            if ih < h or iw < w:
                raise MXNetError(
                    f"image {ih}x{iw} smaller than data_shape {h}x{w}")
            if self.rand_crop:
                top = rng.randint(0, ih - h + 1)
                left = rng.randint(0, iw - w + 1)
            else:
                top, left = (ih - h) // 2, (iw - w) // 2
            img = img[:, top:top + h, left:left + w]
        if self.rand_mirror and rng.rand() < 0.5:
            img = img[:, :, ::-1]
        img = (img - self.mean) / self.std
        label = header.label
        if isinstance(label, (int, float)):
            label = np.array([label], np.float32)
        return img, np.asarray(label, np.float32)

    def _pull(self):
        item = self._queue.get()
        if item is self._SENTINEL:
            raise StopIteration
        if isinstance(item, Exception):
            raise item
        return item

    def next(self):
        peek = getattr(self, "_peek", None)
        if peek is not None:
            self._peek = None
        else:
            peek = self._pull()
        self._consumed += 1
        return peek

    def iter_next(self):
        if getattr(self, "_peek", None) is not None:
            return True
        try:
            self._peek = self._pull()
            return True
        except StopIteration:
            return False

    def state_dict(self):
        """Resumable position: the epoch counter, batches consumed this
        epoch and the pre-shuffle epoch RNG state, in the JAX package's
        layout. Capture it after next(), not between iter_next() and
        next(). Augment draws are per decode thread and not part of it:
        an exact resume holds without rand_crop / rand_mirror."""
        if getattr(self, "_peek", None) is not None:
            raise MXNetError(
                "cannot checkpoint ImageRecordIter with an un-consumed "
                "lookahead batch: capture state after next()")
        return {"version": 1, "type": "ImageRecordIter",
                "num_records": len(self._offsets),
                "batch_size": int(self.batch_size),
                "shuffle": bool(self.shuffle),
                "epoch": int(self._epochs),
                "consumed": int(self._consumed),
                "seed": self._aug_seed,
                "rng": self._rng_at_reset}

    def load_state_dict(self, state):
        """Rewind the epoch RNG to its pre-shuffle state, regenerate the
        epoch order, then replay the consumed batches through the
        decoder."""
        if not isinstance(state, dict) or \
                state.get("type") != "ImageRecordIter" or \
                state.get("version") != 1:
            raise MXNetError(
                "load_state_dict: not a version-1 ImageRecordIter state")
        if int(state["num_records"]) != len(self._offsets):
            raise MXNetError(
                f"load_state_dict: iterator holds {len(self._offsets)} "
                f"records but the state was captured over "
                f"{state['num_records']}: not the same .rec file")
        for attr in ("batch_size", "shuffle"):
            if state.get(attr) != getattr(self, attr):
                raise MXNetError(
                    f"load_state_dict: iterator {attr}="
                    f"{getattr(self, attr)!r} but the state was captured "
                    f"with {attr}={state.get(attr)!r}: construct the "
                    "iterator with the same configuration to resume")
        self._epoch_rng.set_state(state["rng"])
        self.reset()
        self._epochs = int(state["epoch"])
        for _ in range(int(state["consumed"])):
            self.next()
