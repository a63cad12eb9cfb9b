"""DataLoader (ref: python/mxnet/gluon/data/dataloader.py; the port of
``mxnet_tpu/gluon/data/dataloader.py``).

Three ways to make a batch, as in the JAX package:

- the thread pool (``num_workers`` threads, the default): each worker
  thread reads, decodes and transforms its batch's items and stacks
  them. PIL, cv2, numpy and torch release the GIL in their loops;
- the native plan: where the dataset is an ``ImageRecordDataset`` under
  ``transform_first`` of the standard vision ``Compose`` ([flip?]
  CenterCrop, ToTensor, [Normalize?]), a batch's raw JPEG payloads go to
  the libjpeg batch decoder (``_native.decode_batch``), which decodes,
  crops, mirrors and normalizes into one NCHW float32 array. Where the
  host has no ``jpeglib.h`` the decoder is absent and the Python path
  runs: a host library the JAX package treats the same way, not a
  device fallback;
- ``thread_pool=False``: native-mappable datasets go to the sharded
  decode workers (``io.pipeline.ShardedRecordPipeline``), worker
  processes feeding a shared-memory ring.

Batches are made on the context current when iteration starts (``cuda:0``
outside a ``with mx.cpu():`` scope): the context is per thread, so the
loader enters the caller's in each worker task. On a host without CUDA,
iterating outside a CPU scope raises. ``prefetch_to_device=True`` (or
``pin_memory=True``) builds batches on the host and moves each to the
current context's device through the device feeder
(``io.pipeline.DeviceFeeder``): pinned host memory, a copy on a side
stream while the step runs.
"""
from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import numpy as np

from ...context import current_context, resolve_device
from ...ndarray import NDArray, array
from .sampler import BatchSampler, RandomSampler, SequentialSampler


def compile_native_plan(fn):
    """Map a transforms.Compose onto imgdec.cc's kernel if its steps are
    exactly [RandomFlipLeftRight?] [CenterCrop] [ToTensor] [Normalize?].
    Returns {"th","tw","flip","mean","std"} or None. The kernel works on
    raw 0..255 pixels, so ToTensor's /255 and Normalize fold into the
    affine: ((px/255) - m) / s == (px - 255m) / (255s)."""
    from .vision import transforms as T

    if not isinstance(fn, T.Compose):
        return None
    steps = list(fn._children.values())
    flip = False
    mean = np.zeros(3, np.float32)
    std = np.ones(3, np.float32)
    i = 0
    if i < len(steps) and isinstance(steps[i], T.RandomFlipLeftRight):
        flip = True
        i += 1
    if not (i < len(steps) and isinstance(steps[i], T.CenterCrop)):
        return None  # no fixed output size: variable shapes
    w, h = steps[i]._size
    i += 1
    if not (i < len(steps) and isinstance(steps[i], T.ToTensor)):
        return None
    i += 1
    if i < len(steps) and isinstance(steps[i], T.Normalize):
        mean = np.broadcast_to(np.asarray(steps[i]._mean, np.float32),
                               (3,)).copy()
        std = np.broadcast_to(np.asarray(steps[i]._std, np.float32),
                              (3,)).copy()
        i += 1
    if i != len(steps):
        return None  # unrecognized trailing transforms
    return {"th": int(h), "tw": int(w), "flip": flip,
            "mean": mean * 255.0, "std": std * 255.0}


def default_batchify_fn(data):
    if isinstance(data[0], NDArray):
        from ... import ndarray as F
        return F.stack(*data, axis=0)
    if isinstance(data[0], tuple):
        data = zip(*data)
        return [default_batchify_fn(list(i)) for i in data]
    return array(np.asarray(data))


class DataLoader:
    """Batches of a dataset (ref: gluon/data/dataloader.py DataLoader).

    ``num_workers`` with the default ``thread_pool=True`` loads batches
    in that many threads, ``prefetch`` batches ahead (2 x workers by
    default); ``thread_pool=False`` routes native-mappable datasets to
    the sharded decode worker processes (the module docstring), where
    the records divide into ``num_workers * batch_size`` and the order
    is the loader's own (no custom sampler); else it keeps the threads.

    ``prefetch_to_device=True`` double-buffers the device transfer: a
    feeder thread copies batch k+1 to the device while step k runs
    (default: the ``MXTPU_IO_PREFETCH_DEVICE`` knob). ``pin_memory=True``
    routes to the same feeder, which copies from pinned host memory.
    ``sharding=`` (a ``parallel.NamedSharding``) routes to the feeder
    too, which lays each batch's arrays out over its mesh
    (``io.pipeline.to_device``): the loader yields ``Sharded`` values."""

    def __init__(self, dataset, batch_size=None, shuffle=False, sampler=None,
                 last_batch=None, batch_sampler=None, batchify_fn=None,
                 num_workers=0, pin_memory=False, prefetch=None,
                 thread_pool=True, prefetch_to_device=None, sharding=None):
        from ...base import get_env
        self._dataset = dataset
        self._sharding = sharding
        custom_order = sampler is not None or batch_sampler is not None
        if batch_sampler is None:
            if batch_size is None:
                raise ValueError("batch_size required when no batch_sampler")
            if sampler is None:
                sampler = RandomSampler(len(dataset)) if shuffle \
                    else SequentialSampler(len(dataset))
            elif shuffle:
                raise ValueError("shuffle conflicts with explicit sampler")
            batch_sampler = BatchSampler(sampler, batch_size,
                                         last_batch or "keep")
        self._batch_sampler = batch_sampler
        self._batchify_fn = batchify_fn or default_batchify_fn
        self._num_workers = max(0, num_workers)
        self._prefetch = max(0, prefetch if prefetch is not None
                             else 2 * self._num_workers)
        self._native = None
        if batchify_fn is None:
            self._native = self._compile_native(dataset)
        if pin_memory and prefetch_to_device is None:
            import warnings
            warnings.warn(
                "DataLoader(pin_memory=True) routes to the device feeder "
                "(prefetch_to_device): batches are copied from pinned "
                "host memory onto the device ahead of the step, not "
                "handed out in pinned host memory", stacklevel=2)
            prefetch_to_device = True
        if prefetch_to_device is None:
            prefetch_to_device = get_env("MXTPU_IO_PREFETCH_DEVICE",
                                         False, bool)
        self._prefetch_device = bool(prefetch_to_device)
        self._mp_pipeline = None
        self._mp_config = None
        if not thread_pool and self._num_workers > 0 and not custom_order:
            self._mp_config = self._compile_multiprocess(
                dataset, batch_size, shuffle)

    def _compile_native(self, dataset):
        """(source dataset, plan) when the dataset chain is
        ImageRecordDataset -> transform_first(<native-mappable Compose>);
        None otherwise."""
        from .dataset import _LazyTransformDataset
        from .vision.datasets import ImageRecordDataset

        if not isinstance(dataset, _LazyTransformDataset):
            return None
        fn = getattr(dataset._fn, "_transform_first", None)
        src = dataset._data
        if fn is None or not isinstance(src, ImageRecordDataset):
            return None
        if src._flag == 0 or src._transform is not None:
            return None
        plan = compile_native_plan(fn)
        if plan is None:
            return None
        return src, plan

    def _compile_multiprocess(self, dataset, batch_size, shuffle):
        """The sharded pipeline's arguments when the dataset maps onto
        it exactly, else None (the thread pool serves). It needs the
        native plan, the loader's own sequential or random order (the
        pipeline shards its own), and records that divide into
        workers x batch, so that each is delivered once an epoch (the
        pipeline drops a remainder; ``last_batch="keep"`` would not)."""
        if self._native is None or batch_size is None:
            return None
        src, plan = self._native
        n = len(dataset)
        if n % (self._num_workers * batch_size) != 0:
            return None
        # a seed derived from, not drawn from, the global RNG state:
        # deterministic under np.random.seed like RandomSampler, and
        # making the loader consumes no draw
        seed = int(np.random.get_state()[1][0]) & 0x7FFFFFFF
        return {
            "path_imgrec": src._record.uri,
            "data_shape": (3, plan["th"], plan["tw"]),
            "batch_size": int(batch_size),
            "num_workers": self._num_workers,
            "shuffle": bool(shuffle),
            "rand_mirror": bool(plan["flip"]),
            "mean": plan["mean"], "std": plan["std"],
            "seed": seed,
        }

    def close(self):
        """Stop the worker processes and free their shared memory (also
        from ``__del__``; iterating again starts them anew)."""
        if self._mp_pipeline is not None:
            self._mp_pipeline.close()
            self._mp_pipeline = None

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001 (interpreter shutdown)
            pass

    def __len__(self):
        return len(self._batch_sampler)

    def _load_batch(self, indices):
        if self._native is not None:
            batch = self._load_batch_native(indices)
            if batch is not None:
                return batch
        return self._batchify_fn([self._dataset[i] for i in indices])

    def _load_batch_in(self, ctx, indices):
        """``_load_batch`` in a pool thread, under the context that was
        current where iteration started."""
        with ctx:
            return self._load_batch(indices)

    def _load_batch_native(self, indices):
        """Whole-batch decode and augment in the libjpeg pool; None
        hands the batch to the Python path (no libjpeg on the host, a
        non-JPEG record, an image the kernel refuses, such as one
        smaller than the crop)."""
        from ... import _native
        from ...base import MXNetError

        src, plan = self._native
        payloads, labels = [], []
        for i in indices:
            payload, label = src.raw_payload(i)
            if payload[:2] != b"\xff\xd8":
                return None
            payloads.append(payload)
            labels.append(np.atleast_1d(np.asarray(label, np.float32)))
        n = len(payloads)
        uv = np.full((n, 2), -1.0, np.float32)  # center crop
        mirror = ((np.random.rand(n) < 0.5) if plan["flip"]
                  else np.zeros(n)).astype(np.uint8)
        try:
            # with pool threads in flight, each call decodes its batch
            # on one thread: the parallelism is across batches
            out = _native.decode_batch(
                payloads, plan["th"], plan["tw"], uv, mirror,
                plan["mean"], plan["std"],
                nthreads=1 if self._num_workers else None)
        except MXNetError:
            # e.g. an image smaller than the crop: the Python CenterCrop
            # clamps instead
            return None
        if out is None:
            return None
        lab = np.stack(labels)
        if lab.shape[1] == 1:  # scalar labels batch as (n,), as the
            lab = lab[:, 0]    # per-item path's do
        return [array(out), array(lab)]

    def _iter_multiprocess(self):
        """One epoch off the sharded pipeline as [data, label] batches;
        the worker processes live on across epochs."""
        from ...io.pipeline import ShardedRecordPipeline
        if self._mp_pipeline is None:
            self._mp_pipeline = ShardedRecordPipeline(**self._mp_config)
        else:
            self._mp_pipeline.reset()
        for batch in self._mp_pipeline:
            yield [batch.data[0], batch.label[0]]

    def _iter_batches(self):
        ctx = current_context()
        resolve_device(ctx)   # no CUDA and no CPU scope: raise here
        if self._mp_config is not None:
            yield from self._iter_multiprocess()
            return
        if self._num_workers == 0:
            for indices in self._batch_sampler:
                yield self._load_batch(indices)
            return
        pool = ThreadPoolExecutor(max_workers=self._num_workers)
        futures = []
        try:
            it = iter(self._batch_sampler)
            try:
                for _ in range(self._prefetch or self._num_workers):
                    futures.append(pool.submit(self._load_batch_in, ctx,
                                               next(it)))
            except StopIteration:
                pass
            while futures:
                batch = futures.pop(0).result()
                try:
                    futures.append(pool.submit(self._load_batch_in, ctx,
                                               next(it)))
                except StopIteration:
                    pass
                yield batch
        finally:
            # a consumer that stops early leaves batches queued: drop
            # them, and wait only for those already running
            pool.shutdown(wait=True, cancel_futures=True)

    def __iter__(self):
        if not self._prefetch_device and self._sharding is None:
            yield from self._iter_batches()
            return
        # the feeder thread builds batches on the host and copies batch
        # k+1 to the device while the step consumes batch k; the time
        # the consumer waits is its wait_seconds (io/pipeline.py)
        from ...io.pipeline import DeviceFeeder
        source = self._iter_batches()
        feeder = DeviceFeeder(source, sharding=self._sharding,
                              to_device=self._prefetch_device)
        try:
            while True:
                try:
                    yield feeder.get()
                except StopIteration:
                    return
        finally:
            feeder.close()
            source.close()   # the feeder thread has let go of it
