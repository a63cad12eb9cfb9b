"""The record input pipeline (the port of ``mxnet_tpu/io/pipeline.py``):
multi-process sharded decode over a shared-memory batch ring, and the
device feeder that copies batch k+1 to the card while step k runs.

``ShardedRecordPipeline``  N decode worker processes, each owning a
    disjoint shard of the record index and its own libjpeg pool, write
    decoded and augmented batches into a per-worker shared-memory ring
    (``multiprocessing.shared_memory``) that the parent maps as numpy
    views. Workers are plain subprocesses running
    ``_pipeline_worker.py``: they import neither torch nor this package,
    inherit no CUDA context, and exit when the parent dies. A crashed
    worker is respawned with its shard resumed at the last batch the
    parent acknowledged; epoch permutations and augment draws derive
    from ``(seed, epoch)`` and ``(seed, worker, batch)``, so the respawn
    is bit-exact.

    The ring rule: a slot is copied out (by torch, the GIL released)
    into a fresh host tensor, pinned where CUDA is available, before it
    is acknowledged. Nothing handed to the caller aliases a slot, so a
    worker rewriting it can never change a batch, and a non-blocking
    copy to the card reads the pinned copy, never the slot.

``DeviceFeeder``  a feeder thread pulls batch k+1 from its source and
    moves it to the device: pinned host memory, a copy on a side CUDA
    stream, an event (``io.py`` ``_feed``). The consumer's stream waits
    on that event and the arrays are recorded on it, so a batch is safe
    to use and to free there. The time the consumer spends blocked in
    :meth:`DeviceFeeder.get` is counted (``wait_seconds``): the data
    wait of a training step.

Knobs: ``MXTPU_IO_WORKERS``, ``MXTPU_IO_RING_BATCHES``,
``MXTPU_IO_READAHEAD_MB``.
"""
from __future__ import annotations

import atexit
import json
import logging
import os
import queue
import resource
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import weakref

import numpy as np
import torch

from ..base import MXNetError, get_env
from ..context import cpu, current_context, resolve_device
from ..ndarray import NDArray
from ..parallel.mesh import Sharded
from . import _pipeline_worker as _pw
from .io import DataBatch, DataDesc, DataIter, _batch_arrays, _feed

_WORKER_SCRIPT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                              "_pipeline_worker.py")
_SHM_DIR = "/dev/shm"


def io_workers_default():
    """Worker-process count when the caller didn't choose: the
    ``MXTPU_IO_WORKERS`` knob (0 = stay in-process)."""
    return max(0, get_env("MXTPU_IO_WORKERS", 0, int))


def per_worker_pool_threads(num_workers):
    """Decode-pool threads per worker process: the host's cores split
    across worker processes (N workers x full-size pools would
    oversubscribe and thrash)."""
    total = get_env("MXNET_CPU_WORKER_NTHREADS", os.cpu_count() or 4, int)
    return max(1, total // max(1, num_workers))


def _imgdec_lib_path():
    """The port's libjpeg decoder, built if needed, for the workers to
    load by path; None only where the host has no libjpeg (the workers
    then decode with PIL). A failed build raises."""
    from .. import _native
    if _native.load_imgdec() is None:
        return None
    return str(_native.imgdec_library_path())


class _Worker:
    """Parent-side handle for one decode worker: its shm ring, spec
    file, process, and the acked counter that doubles as the respawn
    resume point."""

    def __init__(self, wid, shm, views, spec_path):
        self.wid = wid
        self.shm = shm
        self.views = views
        self.spec_path = spec_path
        self.proc = None
        self.acked = 0   # batches this worker produced AND the parent released


class ShardedRecordPipeline(DataIter):
    """Multi-process decode pipeline over a RecordIO file.

    Shards are batch-striped over the per-epoch permutation: epoch
    batch ``g`` covers ``perm[g*B:(g+1)*B]`` and belongs to worker
    ``g % num_workers``; together they cover every record when ``n %
    (num_workers * batch_size) == 0`` (a remainder is dropped), and
    round-robin delivery reproduces the batch order the in-process
    ``ImageRecordIter`` gives with the same seed, whatever the worker
    count. ``streaming=True`` gives each worker a contiguous byte range
    read by chunked readahead instead, shuffled within the readahead
    window.

    Batches are made on the current context (``cuda:0`` outside a
    ``with mx.cpu():`` scope), from host copies of the ring slots that
    are pinned where CUDA is available. ``timeout`` bounds every wait
    for a ring slot, in seconds.

    The parent's time in :meth:`next`, summed over the batches: blocked
    on a worker's slot (``wait_seconds``), allocating the host tensors
    (``alloc_seconds``) and copying the slot into them
    (``copy_seconds``); ``copy_faults`` sums the process's minor page
    faults during the copies.
    """

    def __init__(self, path_imgrec, data_shape, batch_size,
                 num_workers=None, label_width=1, shuffle=False,
                 rand_crop=False, rand_mirror=False, mean=None, std=None,
                 seed=0, ring_batches=None, streaming=False,
                 readahead_mb=None, nthreads=None,
                 offsets=None, timeout=120.0):
        super().__init__(batch_size)
        if num_workers is None:
            num_workers = io_workers_default() or 1
        if num_workers < 1:
            raise MXNetError("ShardedRecordPipeline needs num_workers >= 1")
        c, th, tw = tuple(data_shape)
        if c != 3:
            raise MXNetError("pipeline decodes RGB only (data_shape[0]=3)")
        self.data_shape = (c, th, tw)
        self.label_width = int(label_width)
        self.shuffle = bool(shuffle)
        self._seed = int(seed)
        self._path = path_imgrec
        self._streaming = bool(streaming)
        self._timeout = float(timeout)
        self._pin = torch.cuda.is_available()
        if offsets is None:
            from ..recordio import load_record_offsets
            offsets = load_record_offsets(path_imgrec)
        self._num_records = len(offsets)
        self._W = int(num_workers)
        # batches per worker per epoch (must match _pipeline_worker
        # _Shard exactly)
        if self._streaming:
            self._bw = (self._num_records // self._W) // batch_size
        else:
            self._bw = (self._num_records // batch_size) // self._W
        if self._bw < 1:
            raise MXNetError(
                f"{self._num_records} records cannot fill one "
                f"batch_size={batch_size} batch per worker with "
                f"{self._W} workers")
        self._epoch_batches = self._bw * self._W
        nslots = ring_batches if ring_batches is not None else \
            get_env("MXTPU_IO_RING_BATCHES", 3, int)
        self._nslots = max(2, int(nslots))
        self._layout = _pw.ring_layout(self._nslots, batch_size, th, tw,
                                       self.label_width)
        if nthreads is None:
            nthreads = per_worker_pool_threads(self._W)
        mean = np.zeros(3, np.float32) if mean is None else \
            np.broadcast_to(np.asarray(mean, np.float32).ravel(), (3,))
        std = np.ones(3, np.float32) if std is None else \
            np.broadcast_to(np.asarray(std, np.float32).ravel(), (3,))
        self._workers = []
        self._closed = False
        self._epoch = 0          # epochs completed before the current one
        self._cursor = 0         # batches delivered this epoch
        self.respawns = 0
        self.wait_seconds = self.alloc_seconds = self.copy_seconds = 0.0
        self.copy_faults = 0
        self._tmpdir = tempfile.mkdtemp(prefix="mxtorch_io_")
        # from here on close() owns the cleanup, also of a failed start
        self._atexit = None
        try:
            offsets_path = os.path.join(self._tmpdir, "offsets.npy")
            np.save(offsets_path, np.asarray(offsets, np.int64))
            self._spec_base = {
                "rec_path": os.path.abspath(path_imgrec),
                "offsets_path": offsets_path,
                "num_workers": self._W, "batch_size": int(batch_size),
                "ring_batches": self._nslots, "th": th, "tw": tw,
                "label_width": self.label_width,
                "shuffle": self.shuffle, "seed": self._seed,
                "rand_crop": bool(rand_crop),
                "rand_mirror": bool(rand_mirror),
                "mean": [float(x) for x in mean],
                "std": [float(x) for x in std],
                "imgdec_lib": _imgdec_lib_path(),
                "nthreads": int(nthreads),
                "streaming": self._streaming,
                "readahead_mb": float(
                    readahead_mb if readahead_mb is not None
                    else get_env("MXTPU_IO_READAHEAD_MB", 64, int)),
                "parent_pid": os.getpid(),
            }
            for w in range(self._W):
                self._workers.append(self._make_worker(w))
            for w in self._workers:
                self._spawn(w, start_batch=0)
        except BaseException:
            self.close()
            raise
        # LIFO atexit runs before the interpreter tears down threading
        # primitives; a weakref keeps the hook from pinning the iterator
        wr = weakref.ref(self)
        self._atexit = lambda: wr() and wr().close()
        atexit.register(self._atexit)

    # ------------------------------------------------------------ setup

    def _make_worker(self, wid):
        from multiprocessing import shared_memory
        size = self._layout["total"]
        shm = None
        try:
            shm = shared_memory.SharedMemory(create=True, size=size)
            # reserve the pages now: a ring larger than the room left in
            # /dev/shm would map, then kill its worker with SIGBUS at the
            # first write past that room
            fd = os.open(os.path.join(_SHM_DIR, shm.name), os.O_RDWR)
            try:
                os.posix_fallocate(fd, 0, size)
            finally:
                os.close(fd)
        except OSError as e:
            if shm is not None:
                shm.close()
                shm.unlink()
            st = os.statvfs(_SHM_DIR)
            c, th, tw = self.data_shape
            raise MXNetError(
                f"io pipeline: cannot create worker {wid}'s shared-memory "
                f"ring of {size} B ({self._nslots} slots x batch "
                f"{self.batch_size} x {c} x {th} x {tw} float32 + labels; "
                f"{self._W} workers) in {_SHM_DIR}, which has "
                f"{st.f_bavail * st.f_frsize} B free: lower ring_batches "
                f"(MXTPU_IO_RING_BATCHES), num_workers or the batch ({e})"
            ) from e
        views = _pw.map_views(shm.buf, self._layout)
        views["header"][:] = 0
        views["header"][_pw.H_MAGIC] = _pw.MAGIC
        views["meta"][:] = 0
        spec_path = os.path.join(self._tmpdir, f"worker{wid}.json")
        return _Worker(wid, shm, views, spec_path)

    def _spawn(self, worker, start_batch):
        spec = dict(self._spec_base)
        spec.update(worker_id=worker.wid, shm_name=worker.shm.name,
                    start_batch=int(start_batch))
        with open(worker.spec_path, "w") as f:
            json.dump(spec, f)
        h = worker.views["header"]
        h[_pw.H_STOP] = 0
        h[_pw.H_PRODUCED] = 0
        worker.views["meta"][:, _pw.M_STATE] = _pw.EMPTY
        worker.acked = int(start_batch)
        # a plain subprocess, not multiprocessing: no fork of a process
        # that may hold a CUDA context, no pickling, no inherited locks
        worker.proc = subprocess.Popen(
            [sys.executable, _WORKER_SCRIPT, worker.spec_path],
            stdin=subprocess.DEVNULL)

    # ---------------------------------------------------------- protocol

    @property
    def provide_data(self):
        return [DataDesc("data", (self.batch_size,) + self.data_shape)]

    @property
    def provide_label(self):
        shape = ((self.batch_size,) if self.label_width == 1
                 else (self.batch_size, self.label_width))
        return [DataDesc("softmax_label", shape)]

    def __len__(self):
        return self._epoch_batches

    def decoders(self):
        """Names of the decoders the workers have run (``libjpeg``,
        ``pil``, ``npy``), over every batch they decoded."""
        bits = 0
        for w in self._workers:
            if w.views is not None:
                bits |= int(w.views["header"][_pw.H_DECODERS])
        return sorted(name for bit, name in _pw.DECODER_NAMES.items()
                      if bits & bit)

    def reset(self):
        """Open the next epoch. Workers stream batches continuously, so
        a reset at the epoch boundary costs nothing; a reset mid-epoch
        realigns every worker to the next epoch's start by respawn."""
        if self._closed:
            raise MXNetError("pipeline is closed")
        if self._cursor == 0:
            return
        self._epoch += 1
        if self._cursor >= self._epoch_batches:
            self._cursor = 0
            return
        self._cursor = 0
        self._stop_workers(self._workers)
        for w in self._workers:
            self._spawn(w, start_batch=self._epoch * self._bw)

    def next(self):
        if self._cursor >= self._epoch_batches:
            raise StopIteration
        w = self._workers[self._cursor % self._W]
        gidx = self._epoch * self._bw + self._cursor // self._W
        t0 = time.perf_counter()
        slot = self._pull(w, gidx)
        srcs = [torch.from_numpy(w.views[k][slot]) for k in ("data", "label")]
        t1 = time.perf_counter()
        data, label = [torch.empty(t.shape, dtype=t.dtype,
                                   pin_memory=self._pin) for t in srcs]
        faults = resource.getrusage(resource.RUSAGE_SELF).ru_minflt
        t2 = time.perf_counter()
        data.copy_(srcs[0])       # by torch, the GIL released
        label.copy_(srcs[1])
        t3 = time.perf_counter()
        self.copy_faults += \
            resource.getrusage(resource.RUSAGE_SELF).ru_minflt - faults
        self.wait_seconds += t1 - t0
        self.alloc_seconds += t2 - t1
        self.copy_seconds += t3 - t2
        if self.label_width == 1:
            label = label[:, 0]
        # both copies are done: only now may the worker rewrite the slot
        self._release(w, slot, gidx)
        self._cursor += 1
        dev = resolve_device(None)
        arrays = [NDArray(t.to(dev, non_blocking=t.is_pinned()))
                  for t in (data, label)]
        return DataBatch(data=arrays[:1], label=arrays[1:], pad=0)

    def iter_next(self):
        return self._cursor < self._epoch_batches

    def _pull(self, worker, gidx):
        """Wait for worker's ring slot holding global batch ``gidx`` and
        return the slot; the caller releases it after copying it out.
        Crashed workers are respawned with the shard resumed at the last
        acked batch; a wait longer than the timeout raises."""
        slot = gidx % self._nslots
        meta, views = worker.views["meta"], worker.views
        deadline = time.perf_counter() + self._timeout
        burst = 0
        while True:
            state = int(meta[slot, _pw.M_STATE])
            if state == _pw.ERROR and int(meta[slot, _pw.M_GIDX]) == gidx:
                n = int(meta[slot, _pw.M_ERRLEN])
                msg = views["data"][slot].reshape(-1).view(np.uint8)[:n] \
                    .tobytes().decode(errors="replace")
                raise MXNetError(f"decode worker failed: {msg}")
            if state == _pw.READY and int(meta[slot, _pw.M_GIDX]) == gidx:
                return slot
            if worker.proc.poll() is not None:
                burst += 1
                if burst > 5:
                    raise MXNetError(
                        f"io pipeline worker {worker.wid} crashed "
                        f"{burst} times in a row without producing "
                        f"batch {gidx}: giving up (see worker stderr)")
                self._respawn(worker)
            if time.perf_counter() > deadline:
                h = worker.views["header"]
                hb = int(h[_pw.H_HEARTBEAT])
                hb_age = ((time.monotonic_ns() - hb) / 1e9 if hb
                          else float("inf"))
                raise MXNetError(
                    f"io pipeline stalled: worker {worker.wid} produced "
                    f"no batch {gidx} in {self._timeout:.0f}s (ring slot "
                    f"state={state}, worker produced "
                    f"{int(h[_pw.H_PRODUCED])} batches since spawn, "
                    f"last heartbeat {hb_age:.1f}s ago)")
            # the producer is another process writing shared memory:
            # there is no in-process primitive to block on, so this is
            # a deadline-bounded poll
            time.sleep(0.0005)

    def _release(self, worker, slot, gidx):
        worker.views["meta"][slot, _pw.M_STATE] = _pw.EMPTY
        worker.acked = gidx + 1

    def _respawn(self, worker):
        """A worker died (crash, OOM kill): restart its shard from the
        last acked batch. Slots are swept EMPTY first, so partially
        written batches past the ack point are decoded again."""
        if self._closed:
            raise MXNetError("pipeline is closed")
        rc = worker.proc.poll()
        self.respawns += 1
        logging.getLogger("mxnet_tpu_torch.io").warning(
            "io pipeline worker %d exited rc=%s: respawning at batch %d",
            worker.wid, rc, worker.acked)
        self._spawn(worker, start_batch=worker.acked)

    # ------------------------------------------------------- checkpoints

    def state_dict(self):
        """The exact position, (epoch, cursor), in the JAX package's
        layout. Permutations, augment draws and the shard layout derive
        from the constructor's seed, so a resume decodes nothing twice:
        the workers respawn at the target batch."""
        return {"version": 1, "type": "ShardedRecordPipeline",
                "num_records": self._num_records,
                "batch_size": int(self.batch_size),
                "num_workers": self._W,
                "shuffle": self.shuffle,
                "seed": self._seed,
                "streaming": self._streaming,
                "epoch": self._epoch,
                "cursor": self._cursor}

    def load_state_dict(self, state):
        if not isinstance(state, dict) or \
                state.get("type") != "ShardedRecordPipeline" or \
                state.get("version") != 1:
            raise MXNetError(
                "load_state_dict: not a version-1 ShardedRecordPipeline "
                "state")
        for attr, mine in (("num_records", self._num_records),
                           ("batch_size", self.batch_size),
                           ("num_workers", self._W),
                           ("shuffle", self.shuffle),
                           ("seed", self._seed),
                           ("streaming", self._streaming)):
            if state.get(attr) != mine:
                raise MXNetError(
                    f"load_state_dict: pipeline {attr}={mine!r} but the "
                    f"state was captured with {attr}={state.get(attr)!r}: "
                    "construct the pipeline with the same configuration "
                    "to resume")
        self._epoch = int(state["epoch"])
        self._cursor = int(state["cursor"])
        # with round-robin delivery, worker w has delivered
        # ceil((cursor - w) / W) batches of this epoch
        self._stop_workers(self._workers)
        for w in self._workers:
            done = (self._cursor - w.wid + self._W - 1) // self._W
            self._spawn(w, start_batch=self._epoch * self._bw + done)

    # ----------------------------------------------------------- teardown

    def _stop_workers(self, workers, timeout=5.0):
        """Stop ``workers``: all are signalled first, then each is
        waited for (and killed past ``timeout``)."""
        live = [w for w in workers if w.proc is not None]
        for w in live:
            w.views["header"][_pw.H_STOP] = 1
            w.proc.terminate()
        for w in live:
            try:
                w.proc.wait(timeout=timeout)
            except subprocess.TimeoutExpired:
                w.proc.kill()
                w.proc.wait(timeout=timeout)
            w.proc = None

    def close(self):
        """Stop the workers, unlink the shared memory, remove the spec
        files. Safe to call twice; runs from ``__del__`` and ``atexit``."""
        if self._closed:
            return
        self._closed = True
        try:
            self._stop_workers(self._workers)
        except Exception:  # noqa: BLE001 (best-effort teardown)
            pass
        for w in self._workers:
            # every batch handed out is a copy; unlink first (removing
            # the name never fails), then unmap unless a traceback still
            # holds a view (the map then goes with that last reference)
            w.views = None
            try:
                w.shm.unlink()
            except FileNotFoundError:
                pass
            try:
                w.shm.close()
            except BufferError:
                pass
        shutil.rmtree(self._tmpdir, ignore_errors=True)
        if self._atexit is not None:
            atexit.unregister(self._atexit)

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001 (interpreter shutdown)
            pass


# --------------------------------------------------------------- feeder

def _flat_arrays(item):
    """The NDArrays and Sharded values of a batch, a list of batches or
    of them, or one of them."""
    if isinstance(item, DataBatch):
        return _batch_arrays(item)
    if isinstance(item, (list, tuple)):
        return [a for x in item for a in _flat_arrays(x)]
    return [item] if isinstance(item, (NDArray, Sharded)) else []


def _map_batch(put, batch):
    """``put`` over the leaves of a DataBatch (in place, as the JAX
    package's ``to_device``) / list / tuple, or one leaf."""
    if isinstance(batch, DataBatch):
        batch.data = [put(d) for d in (batch.data or [])]
        batch.label = [put(lb) for lb in (batch.label or [])]
        return batch
    if isinstance(batch, (list, tuple)):
        return type(batch)(_map_batch(put, x) for x in batch)
    return put(batch)


def _shard_leaf(sharding):
    """A leaf's ``sharding.shard``: NDArrays and numpy / torch arrays
    become :class:`~..parallel.mesh.Sharded` values (each position's
    block on its device); anything else is kept."""
    def put(x):
        if isinstance(x, NDArray):
            return sharding.shard(x._data)
        if isinstance(x, (np.ndarray, torch.Tensor)):
            return sharding.shard(torch.as_tensor(x))
        return x
    return put


def to_device(batch, sharding=None):
    """Move one batch to the current context's device now: host numpy
    leaves become NDArrays there, NDArrays move there. With a
    ``sharding`` (``parallel.NamedSharding``), each leaf is laid out
    over its mesh instead, as ``shard_batch`` lays a batch out: a
    ``Sharded`` that a sharded step or a dp executor takes in place.
    Structure-preserving over DataBatch / list / tuple."""
    if sharding is not None:
        return _map_batch(_shard_leaf(sharding), batch)
    dev = resolve_device(None)

    def put(x):
        if isinstance(x, NDArray):
            x._data = x._data.to(dev)
            return x
        if isinstance(x, np.ndarray):
            return NDArray(torch.from_numpy(np.array(x)), ctx=dev)
        return x

    return _map_batch(put, batch)


class DeviceFeeder:
    """Double-buffered device prefetch over any batch source.

    A feeder thread pulls item k+1 from ``source`` (an iterator of
    DataBatches, or of lists of them or of NDArrays) while the consumer
    runs step k.
    With ``to_device`` (the default) the source builds on the host and
    the feeder moves each item to the current context's device (with a
    ``sharding``, the first device of its mesh): on a card from pinned
    host memory on a side stream, with an event; :meth:`get` makes the
    consumer's current stream wait on the event and records the arrays
    on it. Without ``to_device`` the source builds in the current
    context and nothing is moved. A ``sharding`` then lays each leaf
    out over its mesh (:func:`to_device`'s rule), on the side stream:
    the items hold ``Sharded`` values.
    ``depth`` items wait at most (2: one ready, one in flight).

    ``wait_seconds`` sums the time the consumer spent blocked in
    :meth:`get`, and ``items`` counts the items it got: the data wait a
    training loop saw.
    """

    _SENTINEL = object()

    def __init__(self, source, depth=2, sharding=None, to_device=True):
        self._source = source
        self._to_device = bool(to_device)
        self._sharding = sharding
        self._device = resolve_device(
            None if sharding is None else sharding.mesh.devices.flat[0]) \
            if self._to_device or sharding is not None else None
        self._stream = (torch.cuda.Stream(self._device)
                        if self._device is not None
                        and self._device.type == "cuda" else None)
        build = cpu() if self._to_device else current_context()
        self.wait_seconds = 0.0
        self.items = 0
        self._queue = queue.Queue(maxsize=max(1, int(depth)))
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, args=(build,),
                                        daemon=True)
        self._thread.start()

    def _run(self, build):
        with build:
            while not self._stop.is_set():
                try:
                    item = next(self._source)
                    event = (_feed_all(item, self._device, self._stream)
                             if self._to_device else None)
                    if self._sharding is not None:
                        item, event = _shard_all(item, self._sharding,
                                                 self._stream)
                    out = (item, event)
                except StopIteration:
                    out = self._SENTINEL
                except Exception as e:  # noqa: BLE001 (raised at get())
                    out = e
                while not self._stop.is_set():
                    try:
                        self._queue.put(out, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                if not isinstance(out, tuple):
                    return

    def get(self):
        """The next item, on the device and safe to use on the caller's
        current stream; StopIteration at the source's end."""
        t0 = time.perf_counter()
        out = self._queue.get()
        self.wait_seconds += time.perf_counter() - t0
        if out is self._SENTINEL:
            raise StopIteration
        if isinstance(out, Exception):
            raise out
        item, event = out
        if event is not None:
            cur = torch.cuda.current_stream(self._device)
            cur.wait_event(event)
            for t in _flat_tensors(item):
                if t.is_cuda:
                    t.record_stream(torch.cuda.current_stream(t.device))
        self.items += 1
        return item

    def __iter__(self):
        return self

    def __next__(self):
        return self.get()

    def close(self):
        """Stop the feeder thread: drain the queue until it exits, so
        the source is no longer read when this returns."""
        self._stop.set()
        while self._thread.is_alive():
            try:
                while True:
                    self._queue.get_nowait()
            except queue.Empty:
                pass
            self._thread.join(timeout=0.2)


def _feed_all(item, device, stream):
    """``_feed`` over the arrays of a batch, a list of batches or a list
    of NDArrays (a DataLoader's [data, label]): one event marks the
    arrival of all of them on the side stream."""
    return _feed(_flat_arrays(item), device, stream)


def _flat_tensors(item):
    """The tensors of an item's NDArrays and of its Sharded values'
    shards."""
    return [t for a in _flat_arrays(item)
            for t in (a.shards.flat if isinstance(a, Sharded) else [a._data])]


def _shard_all(item, sharding, stream):
    """The item's leaves laid out over ``sharding``'s mesh on the side
    ``stream`` (the current one when None), and the event that marks
    their arrival (None off CUDA). The side stream first waits for what
    the thread's own stream queued (a source that built its arrays on
    the card), and the arrays it reads are recorded on it, so their
    memory is not reused before it has read them."""
    if stream is None:
        return _map_batch(_shard_leaf(sharding), item), None
    stream.wait_stream(torch.cuda.current_stream(stream.device))
    for t in _flat_tensors(item):
        if t.is_cuda:
            t.record_stream(stream)
    with torch.cuda.stream(stream):
        item = _map_batch(_shard_leaf(sharding), item)
        event = torch.cuda.Event()
        event.record(stream)
    return item, event
