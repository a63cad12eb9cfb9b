"""KV-block migration: move a live generation's cache between lanes
(counterpart of ``mxnet_tpu/serving/generate/migrate.py``).

When a :class:`~.scheduler.GenLane` dies, drains or is scaled in, the
requests it was decoding still hold everything needed to continue token
for token: the prompt, the accepted tokens and, while the source pool
still answers, the KV blocks themselves. :class:`KVMigrator` moves the
blocks:

- **salvage** (on the source lane's thread and stream, before its pool
  closes): :meth:`BlockPool.gather` copies the request's blocks of every
  layer into two tensors that own their bytes, so the source pool can
  close right after. On a CUDA device an event recorded after the gather
  travels with the salvage.
- **land** (on the destination lane's thread and stream): the
  destination stream waits on that event (the JAX package gets this
  order from ``device_put``), the salvage is copied to the destination
  pool's device (no copy on the same device), blocks are allocated,
  :meth:`BlockPool.scatter` writes the salvage into them in place and
  :meth:`BlockTable.adopt` records them in a new table. The salvage
  tensors are marked used on the destination stream (``record_stream``)
  so the caching allocator cannot hand their memory out before the copy
  has run. Block 0, the pad sink, is never allocated. No host sync.

When salvage or landing fails (pool closed, device gone, or a
``migrate_wedge`` / ``replay_storm`` fault plan), the scheduler falls
back to deterministic replay.
"""
from __future__ import annotations

import threading
import time

import torch

from ...base import MXNetError
from ...kvstore.fault import migrate_wedge_active
from ...profiling import memory as _mem
from .kvcache import BlockTable

# what ``est_s`` prices a migration's bytes at: the HBM3 peak of the
# NVIDIA H100 80GB HBM3 (SXM), 3.35 TB/s, the figure chip_smoke.py's
# bounds use (the card the port is measured on reports a 700 W power
# limit)
HBM_BYTES_PER_S = 3.35e12


class MigrationError(MXNetError):
    """A KV-block migration that could not complete (closed pool, dead
    device, wedged copy). Recoverable: the scheduler replays instead."""


class KVMigrator:
    """Block-table-aware KV handoff between two lanes' pools.

    One per :class:`~.scheduler.GenModel`; thread-safe. Keeps running
    totals (attempts, migrations, wedged, bytes moved, priced seconds)
    for ``stats()``, and numbers landing attempts so
    ``migrate_wedge@round=N`` wedges exactly the Nth one. ``fault_plan``
    None reads ``MXNET_KVSTORE_FAULT_PLAN`` at each landing."""

    def __init__(self, model_name, fault_plan=None):
        self.model_name = model_name
        self.fault_plan = fault_plan
        self._lock = threading.Lock()
        self.attempts = 0
        self.migrations = 0
        self.wedged = 0
        self.bytes_moved = 0
        self.est_s_total = 0.0

    # -- source side ---------------------------------------------------------
    def salvage(self, src_pool, block_ids):
        """Gather ``block_ids`` out of ``src_pool`` into tensors that own
        their bytes, on the current stream of the source device. Raises
        :class:`MigrationError` when the blocks are gone (closed pool,
        dead device): the caller replays instead."""
        ids = [int(b) for b in block_ids]
        if not ids:
            raise MigrationError(
                "generate: nothing to salvage (empty block table)")
        if src_pool.closed or src_pool.k is None:
            raise MigrationError(
                "generate: source pool already closed — KV blocks "
                "unsalvageable, falling back to replay")
        try:
            k, v = src_pool.gather(ids)
            # tensors that own their bytes: census role kv_cache
            _mem.tag_tree((k, v), "kv_cache")
            event = None
            if k.is_cuda:
                event = torch.cuda.Event()
                event.record(torch.cuda.current_stream(k.device))
        except Exception as e:  # noqa: BLE001 — a dead device surfaces
            # here as a runtime error; that IS the unsalvageable case
            raise MigrationError(
                f"generate: KV salvage failed ({e!r}) — falling back "
                "to replay") from e
        return {"k": k, "v": v, "event": event, "nblocks": len(ids),
                "bytes": len(ids) * src_pool.bytes_per_block}

    # -- destination side ----------------------------------------------------
    def land(self, salvage, dst_pool, table_width):
        """Copy ``salvage`` onto ``dst_pool``'s device, write it into
        freshly allocated blocks and return ``(table, handoff)``: the
        remapped block table and the priced handoff report. Runs on the
        destination lane's thread, between its decode steps; the caller
        holds a reservation covering the blocks."""
        with self._lock:
            self.attempts += 1
            attempt = self.attempts
        if migrate_wedge_active(attempt, plan=self.fault_plan):
            with self._lock:
                self.wedged += 1
            raise MigrationError(
                "generate: migration attempt %d wedged (fault plan "
                "migrate_wedge) — falling back to replay" % attempt)
        if dst_pool.closed or dst_pool.k is None:
            raise MigrationError(
                "generate: destination pool closed mid-recovery — "
                "falling back to replay")
        t0 = time.monotonic_ns()
        n = salvage["nblocks"]
        dev = dst_pool.device
        stream = None
        if dev.type == "cuda":
            stream = torch.cuda.current_stream(dev)
            if salvage["event"] is not None:
                stream.wait_event(salvage["event"])
        k_in = salvage["k"].to(dev, non_blocking=True)
        v_in = salvage["v"].to(dev, non_blocking=True)
        dst_ids = dst_pool.alloc(n)
        try:
            dst_pool.scatter(dst_ids, k_in, v_in)
        except Exception:
            dst_pool.free(dst_ids)
            raise
        if stream is not None:
            for t in (salvage["k"], salvage["v"], k_in, v_in):
                if t.is_cuda:
                    t.record_stream(stream)
        table = BlockTable(dst_pool, table_width).adopt(dst_ids)
        bytes_moved = int(salvage["bytes"])
        est_s = bytes_moved / HBM_BYTES_PER_S
        with self._lock:
            self.migrations += 1
            self.bytes_moved += bytes_moved
            self.est_s_total += est_s
        return table, {
            "attempt": attempt,
            "blocks": n,
            "bytes_moved": bytes_moved,
            "est_s": est_s,
            "priced_gbps": HBM_BYTES_PER_S / 1e9,
            "wall_ns": time.monotonic_ns() - t0,
        }

    def stats(self):
        with self._lock:
            return {
                "attempts": self.attempts,
                "migrations": self.migrations,
                "wedged": self.wedged,
                "bytes_moved": self.bytes_moved,
                "est_s_total": self.est_s_total,
            }
