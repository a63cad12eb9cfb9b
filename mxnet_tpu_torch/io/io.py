"""Data iterators (the port of ``mxnet_tpu/io/io.py``): batches are
assembled with numpy on the host and handed out as NDArrays on the
current context. ``NDArrayIter``, ``ResizeIter``, ``PrefetchingIter``
and the file iterators ``CSVIter``, ``MNISTIter`` and ``LibSVMIter``
give the JAX package's batches for the same inputs and seed, and
checkpoint their position (``state_dict``) with its semantics.

Not ported yet: ``ImageRecordIter`` (with the record pipeline) and the
JAX package's data-wait telemetry, tracing span and memory-census tag
around ``__next__``.
"""
from __future__ import annotations

import queue
import struct
import threading

import numpy as np
import torch

from ..base import MXNetError
from ..context import cpu, current_context, resolve_device
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
        return self.next()

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


def _feed(batch, device, stream):
    """``batch``'s arrays on ``device`` for :class:`PrefetchingIter`'s
    producer: on a CUDA device, host arrays are pinned and copied on the
    side ``stream``, and the event returned marks their arrival (None
    when nothing was copied that way)."""
    if device.type != "cuda":
        for a in _batch_arrays(batch):
            a._data = a._data.to(device)
        return None
    with torch.cuda.stream(stream):
        for a in _batch_arrays(batch):
            if a._data.device != device:
                a._data = a._data.pin_memory().to(device, non_blocking=True)
        event = torch.cuda.Event()
        event.record(stream)
    return event


class PrefetchingIter(DataIter):
    """A background thread runs one or more iterators ahead of the
    consumer (ref: io.py PrefetchingIter), ``prefetch_depth`` batches
    deep; several iterators' batches are concatenated.

    The producer builds batches in the context current when the iterator
    was made (or last reset). ``prefetch_to_device=True`` builds them on
    the host and moves each batch to that context's device: on a CUDA
    device from pinned host memory on a side stream, while the consumer
    computes; :meth:`next` makes the consumer's current stream wait for
    the copy and records the stream on the arrays, so the batch is safe
    to use and to free there.

    ``state_dict`` is (inner state at the epoch's start, batches
    delivered to the caller), as in the JAX package: the producer's
    look-ahead is not part of it, and resume replays the delivered
    batches."""

    def __init__(self, iters, rename_data=None, rename_label=None,
                 prefetch_depth=2, prefetch_to_device=False, sharding=None):
        if not isinstance(iters, (list, tuple)):
            iters = [iters]
        if sharding is not None:
            raise MXNetError("PrefetchingIter: sharding waits for the "
                             "parallel layouts (not ported yet)")
        super().__init__(iters[0].batch_size)
        self.iters = iters
        self.rename_data = rename_data
        self.rename_label = rename_label
        self._depth = prefetch_depth
        self._to_device = prefetch_to_device
        self._queue = None
        self._thread = None
        self._inner_state0 = self._capture_inner()
        self._delivered = 0
        self._start()

    def _capture_inner(self):
        try:
            return [it.state_dict() for it in self.iters]
        except MXNetError:
            return None

    def _start(self):
        q = queue.Queue(maxsize=self._depth)
        stop = threading.Event()
        self._queue, self._stop = q, stop
        ctx = current_context()
        device = resolve_device(ctx) if self._to_device else None
        stream = torch.cuda.Stream(device) \
            if device is not None and device.type == "cuda" else None
        self._device = device
        build = cpu() if self._to_device else ctx

        def producer():
            # its own queue and stop flag: a producer left from an
            # earlier epoch never feeds the new queue
            with build:
                while not stop.is_set():
                    try:
                        batches = [it.next() for it in self.iters]
                        events = [_feed(b, device, stream) for b in batches] \
                            if device is not None else []
                    except StopIteration:
                        q.put(None)
                        return
                    except Exception as e:  # noqa: BLE001 (raised at next())
                        q.put(e)
                        return
                    q.put((batches, [e for e in events if e is not None]))

        self._thread = threading.Thread(target=producer, daemon=True)
        self._thread.start()

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
        self._stop.set()
        # drain until the producer exits: it may be blocked on put()
        while self._thread.is_alive():
            try:
                while True:
                    self._queue.get_nowait()
            except queue.Empty:
                pass
            self._thread.join(timeout=0.2)

    def reset(self):
        self._stop_producer()
        for it in self.iters:
            it.reset()
        self._inner_state0 = self._capture_inner()
        self._delivered = 0
        self._start()

    def next(self):
        item = self._queue.get()
        if item is None:
            raise StopIteration
        if isinstance(item, Exception):
            raise item
        batches, events = item
        for event in events:
            cur = torch.cuda.current_stream(self._device)
            cur.wait_event(event)
            for b in batches:
                for a in _batch_arrays(b):
                    if a._data.is_cuda:
                        a._data.record_stream(cur)
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
