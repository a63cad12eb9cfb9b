"""Paged KV-cache block pool (counterpart of
``mxnet_tpu/serving/generate/kvcache.py``).

Each lane's cache is carved into fixed-size **token blocks** — one
five-dim tensor pair ``(layers, max_blocks, block_tokens, heads,
head_dim)`` — and every request gets a *block table* of pool indices
instead of contiguous storage. The decode kernel
(:func:`~mxnet_tpu_torch.ops.attention.paged_attention`) reads K/V
straight through the table, in place: the step writes a token's K/V
into the pool with an indexed store, so the pool is never copied.

Block 0 is the **pad sink**: batch-padding rows and unused prefill tail
blocks point at it, so their writes land in storage no live request
reads. It is never allocated (``usable = max_blocks - 1``).

Admission reserves a request's worst-case block budget
(``blocks_for(prompt + max_new_tokens)``); allocation itself is
incremental (prefill takes the prompt's blocks, decode one more each
time a position crosses a block boundary).
"""
from __future__ import annotations

import threading

import numpy as np
import torch

from ...base import MXNetError
from ...context import resolve_device

PAD_BLOCK = 0


class BlockPool:
    """One lane's paged KV storage + free list + reservation ledger.
    Thread-safe: the lane scheduler allocates/frees, client threads
    reserve/unreserve at admission. ``device`` defaults to ``cuda:0``
    and raises without CUDA unless it is ``"cpu"``."""

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
        self.block_tokens = int(block_tokens)
        self.max_blocks = int(max_blocks)
        self.device = resolve_device(device)
        self.dtype = dtype
        shape = (self.num_layers, self.max_blocks, self.block_tokens,
                 self.num_heads, self.head_dim)
        # two separate allocations, K and V, as in the JAX pool
        self.k = torch.zeros(shape, dtype=dtype, device=self.device)
        self.v = torch.zeros(shape, dtype=dtype, device=self.device)
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

    @property
    def bytes_total(self):
        """Device bytes of the pool (both tensors); 0 once closed."""
        if self.closed:
            return 0
        return self.k.nbytes + self.v.nbytes

    @property
    def bytes_per_block(self):
        return 2 * self.block_tokens * self.num_heads * self.head_dim \
            * self.num_layers * self.k.element_size()

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

    def close(self):
        """Release the pool's device tensors. Idempotent; any later
        alloc/reserve is a ledger bug and raises or refuses."""
        with self._lock:
            if self.closed:
                return
            self.closed = True
            self.k = None
            self.v = None
            self._free = []
            self._reserved = 0


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

    def ensure_position(self, pos):
        """Grow the table so cache position ``pos`` has a block."""
        need = pos // self.pool.block_tokens + 1 - len(self.blocks)
        if need > 0:
            self.extend(need)

    def release(self):
        self.pool.free(self.blocks)
        self.blocks = []
        self.row[:] = PAD_BLOCK
