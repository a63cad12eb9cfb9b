"""KVStore, the distribution seam (the port of
``mxnet_tpu/kvstore/kvstore.py``; ref: include/mxnet/kvstore.h:59-442,
src/kvstore/kvstore_local.h).

The same string-typed factory as the reference: ``local`` / ``device``
aggregate gradients within one process, on the values' own device;
``dist_sync`` / ``dist_async`` go through the parameter server
(:mod:`.dist`, over ``_native/comm.cc``): a push sends float32 bytes, a
pull writes the server's value into the caller's tensor on its device;
``dist_device_sync`` launched without servers (``-s 0``) allreduces each
push over ``torch.distributed`` (:mod:`.collective`: NCCL on the card,
gloo on the CPU) and keeps the update replicated on every worker; with
servers it takes the parameter server like ``dist_sync``. A ``dist`` type
outside a launched job is a one-worker store with local semantics. The
public API (init / push / pull / set_optimizer / rank / num_workers) is
the seam the Trainer depends on. Values stay torch tensors on their
device; a pull writes into its targets in place, so a parameter keeps
its tensor. ``row_sparse_pull`` raises until sparse NDArray is ported.

Each push and pull runs under a ``kvstore_push`` / ``kvstore_pull`` span
and, with telemetry on, records its host seconds (also the step
breakdown's comm_time) and its payload bytes by key and rank, on success
only. A store connected to parameter servers registers itself with
``profiler.set_kvstore_handle``, so ``profile_process="server"`` calls
reach the servers.
"""
from __future__ import annotations

import os
import time

import torch

from .. import tracing as _tracing
from ..base import MXNetError
from ..context import resolve_device
from ..ndarray import NDArray
from ..optimizer import Updater
from ..telemetry import metrics as _tm
from ..telemetry import step as _tm_step

_met = _tm.lazy_metrics(lambda reg: {
    "push_bytes": reg.counter(
        "mx_kvstore_push_bytes_total",
        "payload bytes pushed, by key and worker rank",
        labelnames=("key", "rank")),
    "pull_bytes": reg.counter(
        "mx_kvstore_pull_bytes_total",
        "payload bytes pulled, by key and worker rank",
        labelnames=("key", "rank")),
    "push_s": reg.histogram(
        "mx_kvstore_push_seconds",
        "host wall-clock per push call (aggregate + transport)"
        ).labels(),   # cached series
    "pull_s": reg.histogram(
        "mx_kvstore_pull_seconds",
        "host wall-clock per pull call").labels(),
})


def _nbytes(v):
    """Payload bytes of a push / pull value from its metadata (no sync)."""
    if v is None:
        return 0
    if isinstance(v, (list, tuple)):
        return sum(_nbytes(x) for x in v)
    if isinstance(v, NDArray):
        v = v._data
    if isinstance(v, torch.Tensor):
        return v.numel() * v.element_size()
    n = getattr(v, "nbytes", None)
    try:
        return int(n)
    except (TypeError, ValueError):
        return 0


def _tensor(v):
    return (v._data if isinstance(v, NDArray) else torch.as_tensor(v)) \
        .detach()


def _assign(target, value):
    """Write ``value`` (a tensor, or numpy) into ``target``'s tensor in
    place, in the target's dtype and on its device."""
    if not isinstance(value, torch.Tensor):
        value = torch.from_numpy(value)
    with torch.no_grad():
        target._data.copy_(value.reshape(target._data.shape))


class KVStore:
    def __init__(self, kv_type="local", device=None):
        """``device``: the worker's device for the collective plane of
        ``dist_device_sync`` (resolved by ``resolve_device``: the current
        context when None); the other types keep their values' devices."""
        self.type = kv_type
        self._store = {}
        self._updater = None
        self._optimizer = None
        self._compression = None
        self._conn = None
        self._coll = None
        self._update_on_server = False
        self._str_key_indices = {}
        if not kv_type.startswith("dist"):
            return
        from . import dist
        serverless = os.environ.get("DMLC_NUM_SERVER") == "0"
        if kv_type in ("dist_device_sync", "dist_sync_device") and \
                serverless and os.environ.get("DMLC_PS_ROOT_URI"):
            # device sync without servers: each push is an allreduce
            # over the workers (launch with tools/launch.py -s 0); with
            # servers it takes the parameter server like dist_sync
            from .collective import CollectiveConn
            self._coll = CollectiveConn.get(resolve_device(device))
        elif dist.role() == "worker" and os.environ.get("DMLC_PS_ROOT_URI"):
            self._conn = dist.connect_workers()
            if self._conn.rank == 0:
                self._conn.set_sync_mode("async" not in kv_type)
            self._conn.barrier()   # the sync mode holds for every push
            # profiler calls with profile_process="server" go through it
            from .. import profiler
            profiler.set_kvstore_handle(self)

    # -- topology ----------------------------------------------------------
    @property
    def rank(self):
        if self._conn is not None:
            return self._conn.rank
        if self._coll is not None:
            return self._coll.rank
        return 0

    @property
    def num_workers(self):
        if self._conn is not None:
            return self._conn.num_workers
        if self._coll is not None:
            return self._coll.num_workers
        return 1

    # -- data plane --------------------------------------------------------
    def init(self, key, value):
        keys, values = self._normalize(key, value)
        if self._coll is not None:
            # rank 0's values seed everyone (kvstore_dist.h Init contract)
            for k, v in zip(keys, values):
                self._store[k] = NDArray(self._coll.broadcast(_tensor(v),
                                                              root=0))
            return
        for k, v in zip(keys, values):
            self._store[k] = NDArray(_tensor(v).clone())
            if self._conn is not None:
                # every rank numbers string keys in init order, so the
                # map agrees across workers and with the server
                idx = self._key_index(k)
                if self._conn.rank == 0:
                    # only rank 0 seeds the server, so every worker pulls
                    # the same initial weights (kvstore_dist.h Init)
                    self._conn.init(idx, v)
        if self._conn is not None:
            # no pull may race a key the server has not initialized
            self._conn.barrier()

    def _byte_series(self, which, k):
        """The (direction, key) byte-counter series, cached on the store
        (skips the labels() resolution a push / pull)."""
        cache = self.__dict__.setdefault("_tm_byte_series", {})
        s = cache.get((which, k))
        if s is None:
            s = cache[(which, k)] = _met()[which].labels(
                key=str(k), rank=str(self.rank))
        return s

    def push(self, key, value, priority=0):
        keys, values = self._normalize(key, value)
        # the span's attrs are static; the dist transport opens kv.push
        # children that ride the wire
        with _tracing.span("kvstore_push", cat="comm", nkeys=len(keys)):
            if not _tm.enabled():
                return self._push_impl(keys, values)
            t0 = time.perf_counter()
            # recorded on success only: a raising push moved no bytes
            ret = self._push_impl(keys, values)
            dt = time.perf_counter() - t0
            _met()["push_s"].observe(dt)
            _tm_step.add_comm(dt)
            for k, v in zip(keys, values):
                self._byte_series("push_bytes", k).inc(_nbytes(v))
            return ret

    def _push_impl(self, keys, values):
        for k, v in zip(keys, values):
            if isinstance(v, (list, tuple)):
                # a push of several devices' values: their sum
                # (CommCPU / CommDevice Reduce)
                agg = _tensor(v[0])
                for extra in v[1:]:
                    agg = agg + _tensor(extra).to(agg.device)
            else:
                agg = _tensor(v)
            if k not in self._store:
                raise MXNetError(f"key {k} not initialized in kvstore")
            if self._coll is not None:
                # one allreduce per push round: every worker gets the same
                # sum, so a local updater stays consistent everywhere
                summed = self._coll.allreduce(agg)
                if self._updater is not None:
                    self._updater(self._key_index(k), NDArray(summed),
                                  self._store[k])
                else:
                    self._store[k]._data = summed
            elif self._conn is not None:
                if self._compression is not None:
                    self._conn.push_compressed(
                        self._key_index(k),
                        self._compression.wire_payload(k, agg))
                else:
                    self._conn.push(self._key_index(k), agg)
            elif self._updater is not None:
                self._updater(self._key_index(k), NDArray(agg),
                              self._store[k])
            else:
                # no updater: the store holds the reduced push, which
                # pull then broadcasts (ref: kvstore_local.h PushImpl)
                self._store[k]._data = agg.clone()

    def pull(self, key, out=None, priority=0, ignore_sparse=True):
        keys, outs = self._normalize(key, out)
        with _tracing.span("kvstore_pull", cat="comm", nkeys=len(keys)):
            if not _tm.enabled():
                return self._pull_impl(keys, outs)
            t0 = time.perf_counter()
            ret = self._pull_impl(keys, outs)
            dt = time.perf_counter() - t0
            _met()["pull_s"].observe(dt)
            _tm_step.add_comm(dt)
            for k, o in zip(keys, outs):
                self._byte_series("pull_bytes", k).inc(_nbytes(o))
            return ret

    def _pull_impl(self, keys, outs):
        for k, o in zip(keys, outs):
            if k not in self._store:
                raise MXNetError(f"key {k} not initialized in kvstore")
            targets = o if isinstance(o, (list, tuple)) else [o]
            if self._conn is not None:
                val = self._conn.pull(self._key_index(k), targets[0].shape)
                # the wire is float32: each target keeps its own dtype
                val = torch.from_numpy(val)
            else:
                val = self._store[k]._data
            for t in targets:
                _assign(t, val)

    def row_sparse_pull(self, key, out=None, priority=0, row_ids=None):
        raise MXNetError("row_sparse_pull needs sparse NDArray, which is "
                         "not ported yet")

    # -- control plane -----------------------------------------------------
    def set_optimizer(self, optimizer):
        """One process: the updater runs here. Parameter server: the
        optimizer is pickled to the server (ref: python/mxnet/
        kvstore.py:450-495), pushes then carry gradients and pulls return
        the server's updated weights. Collective: every worker applies
        the same update to the same sum."""
        self._optimizer = optimizer
        if self._coll is not None:
            self._updater = Updater(optimizer)
            self._coll.barrier()
        elif self._conn is not None:
            if self._conn.rank == 0:
                self._conn.send_optimizer(optimizer)
            self._conn.barrier()
            self._update_on_server = True
            self._updater = None
        else:
            self._updater = Updater(optimizer)

    def set_gradient_compression(self, compression_params):
        from .gradient_compression import GradientCompression
        self._compression = GradientCompression(**dict(compression_params))

    @property
    def gradient_compression(self):
        return self._compression

    def save_optimizer_states(self, fname, dump_optimizer=False):
        if self._update_on_server:
            raise MXNetError(
                f"optimizer state lives on the kvstore server in {self.type} "
                "mode; checkpoint from the server process or use "
                "update_on_kvstore=False")
        if self._updater is None:
            raise MXNetError("no optimizer set")
        from ..checkpoint import atomic_write
        with atomic_write(fname) as f:
            f.write(self._updater.get_states(dump_optimizer))

    def load_optimizer_states(self, fname):
        if self._update_on_server:
            raise MXNetError(
                f"optimizer state lives on the kvstore server in {self.type} "
                "mode; restore it in the server process or use "
                "update_on_kvstore=False")
        if self._updater is None:
            raise MXNetError("no optimizer set")
        from ..checkpoint import verify
        verify(fname)
        with open(fname, "rb") as f:
            self._updater.set_states(f.read())

    def barrier(self):
        if self._conn is not None:
            self._conn.barrier()
        elif self._coll is not None:
            self._coll.barrier()
        else:
            # one process: wait for the store's device work
            for v in self._store.values():
                v.wait_to_read()

    _barrier = barrier

    def send_command_to_servers(self, head, body):
        if self._conn is not None:
            body = body.encode() if isinstance(body, str) else bytes(body)
            self._conn.command(int(head), body)

    def close(self):
        """Finalize: barrier every worker, rank 0 stops the server (the
        ps-lite Finalize); the collective group is left."""
        if self._coll is not None:
            self._coll.barrier()
            self._coll.close()
            self._coll = None
        if self._conn is not None:
            try:
                self._conn.barrier()
                if self._conn.rank == 0:
                    self._conn.stop_server()
            finally:
                self._conn.close()
                self._conn = None

    @staticmethod
    def _normalize(key, value):
        keys = key if isinstance(key, (list, tuple)) else [key]
        if value is None:
            values = [None] * len(keys)
        elif isinstance(value, (list, tuple)) and len(keys) > 1 and \
                len(value) == len(keys):
            values = list(value)
        else:
            values = [value]
        return keys, values

    def _key_index(self, k):
        """Integer keys (the Trainer's parameter indices) pass through,
        so the updater's per-index state and multipliers line up; string
        keys get a stable per-store number (kvstore_local.h's str <-> int
        map)."""
        if isinstance(k, int):
            return k
        if k not in self._str_key_indices:
            self._str_key_indices[k] = len(self._str_key_indices)
        return self._str_key_indices[k]


KNOWN = ("local", "device", "local_allreduce_cpu", "local_allreduce_device",
         "nccl", "dist_sync", "dist_async", "dist_device_sync",
         "dist_sync_device", "dist")


def create(name="local", device=None):
    """Factory (ref: src/kvstore/kvstore.cc:40-77): one of ``KNOWN``;
    ``device`` as :class:`KVStore` takes it."""
    if name not in KNOWN:
        raise MXNetError(f"unknown KVStore type {name!r}")
    return KVStore(name, device)
