"""Paged KV-cache block pool (counterpart of
``mxnet_tpu/serving/generate/kvcache.py``).

Each lane's cache is carved into fixed-size **token blocks** — one
five-dim tensor pair ``(layers, max_blocks, block_tokens, heads,
head_dim)`` — and every request gets a *block table* of pool indices
instead of contiguous storage. The decode kernel
(:func:`~mxnet_tpu_torch.ops.attention.paged_attention`) reads K/V
straight through the table, in place: the step writes a token's K/V
into the pool with an indexed store, so the pool is never copied.

The pool's last dimension is :func:`~mxnet_tpu_torch.ops.attention.
paged_head_dim` of the heads' size, the paged kernel's built size that
holds it (8, 16, 32, 64, 128 or 256), on every device: the decoder writes
columns ``[:head_dim]`` and the rest stay zero, since every write of a
reused block writes only those columns. The pool's bytes count the
padded size.

Block 0 is the **pad sink**: batch-padding rows and unused prefill tail
blocks point at it, so their writes land in storage no live request
reads. It is never allocated (``usable = max_blocks - 1``).

Admission reserves a request's worst-case block budget
(``blocks_for(prompt + max_new_tokens)``); allocation itself is
incremental (prefill takes the prompt's blocks, decode one more each
time a position crosses a block boundary).

A tensor-parallel lane's pool lies over a slice: ``device`` is a tuple of
``tp`` devices and the heads axis is sharded over it, the partitioning
the layout table gives the attention weights. Each shard holds one K and
one V tensor of ``(layers, max_blocks, block_tokens, heads / tp,
head_dim)`` — ``bytes_total / tp`` bytes — and ``k`` / ``v`` are then
the tuples of the shards' tensors. Block ids, the free list and the
reservations are the pool's, shared by its shards.

Decode failover moves a request's blocks between two lanes' pools:
:meth:`BlockPool.gather` copies them out of the source pool,
:meth:`BlockPool.scatter` writes them into blocks of the destination
pool in place and :meth:`BlockTable.adopt` records them in the
request's new table (:mod:`.migrate`).
"""
from __future__ import annotations

import threading

import numpy as np
import torch

from ...base import MXNetError
from ...context import resolve_device
from ...ops.attention import paged_head_dim
from ...parallel.mesh import create_mesh
from ...profiling import memory as _mem

PAD_BLOCK = 0


class BlockPool:
    """One lane's paged KV storage + free list + reservation ledger.
    Thread-safe: the lane scheduler allocates/frees, client threads
    reserve/unreserve at admission. ``device`` defaults to ``cuda:0``
    and raises without CUDA unless it is ``"cpu"``; a tuple of ``tp``
    devices shards the heads over them (``heads % tp`` must be 0), and
    ``mesh`` is then the slice's ``{"tp": tp}`` mesh."""

    def __init__(self, num_layers, num_heads, head_dim, block_tokens,
                 max_blocks, device=None, dtype=torch.float32):
        if max_blocks < 2:
            raise MXNetError(
                "generate: max_blocks must be >= 2 (block 0 is the "
                f"reserved pad sink), got {max_blocks}")
        if block_tokens < 1:
            raise MXNetError(
                f"generate: block_tokens must be >= 1, got {block_tokens}")
        self.num_layers = int(num_layers)
        self.num_heads = int(num_heads)
        self.head_dim = int(head_dim)
        # the allocated head size: the paged kernel's built size
        self.pool_head_dim = paged_head_dim(self.head_dim)
        self.block_tokens = int(block_tokens)
        self.max_blocks = int(max_blocks)
        sliced = isinstance(device, (list, tuple))
        self.devices = tuple(resolve_device(d) for d in
                             (device if sliced else (device,)))
        self.tp = len(self.devices)
        if self.num_heads % self.tp:
            raise MXNetError(
                f"generate: {self.num_heads} heads do not shard over a "
                f"tp={self.tp} slice (heads % tp must be 0)")
        self.device = self.devices[0]
        self.mesh = None
        self.dtype = dtype
        shape = (self.num_layers, self.max_blocks, self.block_tokens,
                 self.num_heads // self.tp, self.pool_head_dim)
        # two separate allocations a shard, K and V, as in the JAX pool
        self._itemsize = torch.empty((), dtype=dtype).element_size()
        ks = tuple(torch.zeros(shape, dtype=dtype, device=d)
                   for d in self.devices)
        vs = tuple(torch.zeros(shape, dtype=dtype, device=d)
                   for d in self.devices)
        if self.tp > 1:
            self.mesh = create_mesh({"tp": self.tp}, devices=self.devices)
            self.k, self.v = ks, vs
        else:
            self.k, self.v = ks[0], vs[0]
        # the census names the cache that dominates a generator's device
        # memory by its bytes (profiling/memory.py)
        _mem.tag_tree((ks, vs), "kv_cache")
        self._lock = threading.Lock()
        # LIFO free list: recently-freed blocks are re-issued first
        # (their pool pages are the warmest)
        self._free = list(range(self.max_blocks - 1, 0, -1))
        self._reserved = 0
        self.closed = False

    # -- sizes ---------------------------------------------------------------
    @property
    def usable_blocks(self):
        return self.max_blocks - 1

    def shards(self):
        """``[(k, v), ...]``: each shard's tensors (one pair unless the
        pool lies over a slice)."""
        if self.tp == 1:
            return [(self.k, self.v)]
        return list(zip(self.k, self.v))

    @property
    def bytes_total(self):
        """Device bytes of the pool (every shard's tensors); 0 once
        closed."""
        if self.closed:
            return 0
        return sum(k.nbytes + v.nbytes for k, v in self.shards())

    @property
    def bytes_per_block(self):
        return 2 * self.block_tokens * self.num_heads \
            * self.pool_head_dim * self.num_layers * self._itemsize

    def blocks_for(self, tokens):
        """Blocks covering ``tokens`` cache slots (ceil division)."""
        t = int(tokens)
        return max((t + self.block_tokens - 1) // self.block_tokens, 0)

    # -- admission reservation ----------------------------------------------
    def reserve(self, nblocks):
        """Commit ``nblocks`` of worst-case budget; False when the pool
        cannot cover it (the caller fast-rejects ``kv_cache_full``)."""
        n = int(nblocks)
        with self._lock:
            if self.closed or self._reserved + n > self.usable_blocks:
                return False
            self._reserved += n
            return True

    def unreserve(self, nblocks):
        with self._lock:
            self._reserved = max(self._reserved - int(nblocks), 0)

    # -- allocation ----------------------------------------------------------
    def alloc(self, n=1):
        """Pop ``n`` block ids. A reservation-covered request can never
        see an empty free list; hitting one is a ledger bug, not load."""
        with self._lock:
            if self.closed:
                raise MXNetError(
                    "generate: alloc on a closed block pool (accounting "
                    "bug)")
            if n > len(self._free):
                raise MXNetError(
                    "generate: block pool exhausted (%d asked, %d free) "
                    "despite reservation — accounting bug" %
                    (n, len(self._free)))
            return [self._free.pop() for _ in range(n)]

    def free(self, block_ids):
        with self._lock:
            for b in block_ids:
                b = int(b)
                if b != PAD_BLOCK:
                    self._free.append(b)

    # -- state ---------------------------------------------------------------
    def used_blocks(self):
        with self._lock:
            return self.usable_blocks - len(self._free)

    def reserved_blocks(self):
        with self._lock:
            return self._reserved

    def occupancy(self):
        """Bounded snapshot for stats()."""
        with self._lock:
            free = len(self._free)
            reserved = self._reserved
            closed = self.closed
        used = 0 if closed else self.usable_blocks - free
        return {
            "block_tokens": self.block_tokens,
            "usable_blocks": self.usable_blocks,
            "used_blocks": used,
            "free_blocks": free,
            "reserved_blocks": reserved,
            "used_frac": used / self.usable_blocks,
            "bytes_total": self.bytes_total,
            "bytes_per_block": self.bytes_per_block,
            "closed": closed,
        }

    # -- migration -----------------------------------------------------------
    def gather(self, block_ids):
        """Copies of blocks ``block_ids`` of every layer: ``(k, v)``,
        each ``(layers, len(block_ids), BT, H, D)``, tensors that own
        their bytes (the pool can close right after), on the current
        stream of the pool's (first) device; a sliced pool's shards are
        joined along the heads axis."""
        out = []
        for k, v in self.shards():
            idx = torch.as_tensor(np.asarray(block_ids, np.int64),
                                  device=k.device)
            out.append((k.index_select(1, idx).to(self.device),
                        v.index_select(1, idx).to(self.device)))
        if len(out) == 1:
            return out[0]
        return (torch.cat([k for k, _ in out], 3),
                torch.cat([v for _, v in out], 3))

    def scatter(self, block_ids, k, v):
        """Write ``k`` / ``v`` (as :meth:`gather` returns them, on this
        pool's first device) into blocks ``block_ids``, in place, on the
        current stream: the migration landing, which in the JAX package
        swaps in the arrays its scatter returned. A sliced pool's shards
        each take their heads."""
        hs = self.num_heads // self.tp
        for s, (ks, vs) in enumerate(self.shards()):
            idx = torch.as_tensor(np.asarray(block_ids, np.int64),
                                  device=ks.device)
            ks.index_copy_(1, idx, k[:, :, :, s * hs:(s + 1) * hs]
                           .to(ks.device))
            vs.index_copy_(1, idx, v[:, :, :, s * hs:(s + 1) * hs]
                           .to(vs.device))

    def close(self):
        """Release the pool's device tensors: the pool holds the only
        references to them (steps and tables hold the pool, never its
        tensors), so their bytes leave the device here. Idempotent; any
        later alloc/reserve is a ledger bug and raises or refuses."""
        with self._lock:
            if self.closed:
                return
            self.closed = True
            self.k = None
            self.v = None
            self._free = []
            self._reserved = 0
        if self.mesh is not None:
            self.mesh.close()


class BlockTable:
    """One request's view of the pool: ordered block ids + the fixed-
    width int32 row the decode step reads (padded with the pad sink)."""

    __slots__ = ("pool", "blocks", "row")

    def __init__(self, pool, width):
        self.pool = pool
        self.blocks = []
        self.row = np.zeros(int(width), np.int32)

    def extend(self, n):
        """Append ``n`` freshly-allocated blocks. Capacity is checked
        BEFORE allocating, so an overflow leaves no partial state —
        freeing mid-append would return already-tracked blocks to the
        pool twice and hand one block to two requests later."""
        if n <= 0:
            return self
        if len(self.blocks) + n > len(self.row):
            raise MXNetError(
                "generate: block table overflow (%d blocks, width %d) "
                "— admission should have rejected this request"
                % (len(self.blocks) + n, len(self.row)))
        for b in self.pool.alloc(n):
            self.row[len(self.blocks)] = b
            self.blocks.append(b)
        return self

    def adopt(self, block_ids):
        """Append blocks the caller already allocated from this pool —
        the migration landing: :class:`~.migrate.KVMigrator` allocs the
        destination blocks, writes the salvaged K/V into them, and the
        table only records ownership and the row mapping (pad-sink
        padding beyond the adopted prefix is untouched). Same overflow
        discipline as :meth:`extend`."""
        ids = [int(b) for b in block_ids]
        if any(b == PAD_BLOCK for b in ids):
            raise MXNetError(
                "generate: cannot adopt the pad sink into a block "
                "table — block 0 is storage no live request may own")
        if len(self.blocks) + len(ids) > len(self.row):
            raise MXNetError(
                "generate: block table overflow (%d blocks, width %d) "
                "— admission should have rejected this request"
                % (len(self.blocks) + len(ids), len(self.row)))
        for b in ids:
            self.row[len(self.blocks)] = b
            self.blocks.append(b)
        return self

    def ensure_position(self, pos):
        """Grow the table so cache position ``pos`` has a block."""
        need = pos // self.pool.block_tokens + 1 - len(self.blocks)
        if need > 0:
            self.extend(need)

    def release(self):
        self.pool.free(self.blocks)
        self.blocks = []
        self.row[:] = PAD_BLOCK
