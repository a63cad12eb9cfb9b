"""Iteration-level continuous batching for generative decode
(counterpart of ``mxnet_tpu/serving/generate/scheduler.py``; Orca-style:
the batch is re-formed every *token*, not every request).

Each lane re-forms its in-flight batch every decode step:

- **join**: waiting requests prefill (one padded prompt each through
  the causal stack, K/V written into their pool blocks) and enter the
  running set *between* steps — the very next decode step carries them;
- **step**: one token for every running request — tokens/positions/
  block tables stacked to the smallest batch bucket, one ``decode``
  call, next greedy tokens back;
- **leave**: a request that hits EOS or its ``max_new_tokens`` budget
  retires immediately — its blocks return to the pool *that step*, its
  reply stream closes, and the batch shrinks without stalling anyone.

Admission reserves a request's worst-case block budget
(``blocks_for(prompt + max_new_tokens)``) at submit; when the pool
cannot cover it the request raises :class:`RejectedError` with reason
``kv_cache_full`` in the caller's thread, before anything queues.

The lane thread runs under ``torch.inference_mode()``: grad mode is
thread-local and a new thread starts with it on, so without this every
step would record autograd state. Decode failover, elastic scaling,
tensor-parallel slices, telemetry and tracing spans of the JAX
scheduler are not ported yet.
"""
from __future__ import annotations

import logging
import threading
import time
from collections import deque

import numpy as np
import torch

from ..batcher import ServingError
from ..variants import default_buckets, pick_bucket
from .kvcache import BlockPool, BlockTable
from .model import DecodeSteps

logger = logging.getLogger(__name__)


class GenRequest:
    """One generation request + its streaming reply.

    ``stream()`` yields token ids as the scheduler emits them;
    ``result(timeout)`` blocks for the full greedy completion. Either
    raises the serving-side error if the request failed."""

    __slots__ = ("model", "prompt", "max_new_tokens", "submit_ns",
                 "first_token_ns", "last_token_ns", "tokens", "table",
                 "next_pos", "reserved_blocks", "finish_reason", "_cv",
                 "_done", "_error")

    def __init__(self, model, prompt, max_new_tokens):
        self.model = model
        self.prompt = np.asarray(prompt, np.int32).ravel()
        self.max_new_tokens = int(max_new_tokens)
        self.submit_ns = time.monotonic_ns()
        self.first_token_ns = 0
        self.last_token_ns = 0
        self.tokens = []
        self.table = None
        self.next_pos = 0
        self.reserved_blocks = 0
        self.finish_reason = None
        self._cv = threading.Condition(threading.Lock())
        self._done = threading.Event()
        self._error = None

    def done(self):
        return self._done.is_set()

    def stream(self):
        """Iterate token ids as they are generated (the streaming
        reply). Replayable: every consumer streams from the first
        token, so a late (or second) reader sees the whole completion
        instead of hanging. Raises on serving-side failure."""
        i = 0
        while True:
            with self._cv:
                while i >= len(self.tokens) and not self._done.is_set():
                    self._cv.wait()
                if i >= len(self.tokens):
                    if self._error is not None:
                        raise self._error
                    return
                tok = self.tokens[i]
            yield tok
            i += 1

    def result(self, timeout=None):
        """Block for the full completion: list of generated token ids."""
        if not self._done.wait(timeout):
            raise ServingError(
                f"generate: request on {self.model!r} timed out after "
                f"{timeout}s (still queued or decoding)")
        if self._error is not None:
            raise self._error
        return list(self.tokens)

    def _push_token(self, tok):
        with self._cv:
            self.tokens.append(tok)
            self._cv.notify_all()

    def _finish(self, error=None):
        # error and done flip under the stream lock, so a consumer that
        # checked `_done` between the two writes cannot wait forever
        with self._cv:
            self._error = error
            self._done.set()
            self._cv.notify_all()


class GenLane:
    """One decode lane: decoder steps + block pool + the scheduler
    thread that re-forms its batch every step. ``prefill_ns`` /
    ``decode_ns`` sum the host wall time of the requests' ``prefills``
    and ``decode_steps``, each ending in the token read (a device
    sync); warmup calls are not in them."""

    def __init__(self, model, steps, pool):
        self._model = model
        self.steps = steps
        self.pool = pool
        self.waiting = deque()
        self.running = []
        self._thread = None
        self.prefills = 0
        self.prefill_ns = 0
        self.decode_steps = 0
        self.decode_ns = 0
        self.decode_rows = 0

    def start(self):
        self._thread = threading.Thread(
            target=self._loop, daemon=True,
            name=f"mxtpu-torch-generate-{self._model.name}")
        self._thread.start()

    def join(self, timeout=None):
        if self._thread is not None:
            self._thread.join(timeout)

    # -- scheduler loop ------------------------------------------------------
    def _loop(self):
        m = self._model
        with torch.inference_mode():
            while True:
                with m.cond:
                    while not m.closed:
                        admit = self._pop_admissions()
                        if admit or self.running:
                            break
                        m.cond.wait(0.1)
                    if m.closed:
                        break
                try:
                    for req in admit:
                        self._prefill(req)
                    if self.running:
                        self._step()
                except Exception as e:  # noqa: BLE001 — the lane survives
                    # a failed step: its requests fail with the cause,
                    # new work still runs
                    logger.exception("generate: step on %r failed", m.name)
                    err = ServingError(f"generate: step on {m.name!r} "
                                       f"failed: {e!r}")
                    err.__cause__ = e
                    self._fail_inflight(admit, err, waiting=False)
        self._fail_inflight([], ServingError(
            f"generate: model {m.name!r} shut down before the request "
            "completed"), waiting=True)

    def _pop_admissions(self):
        """Pop waiting requests into the batch up to max_decode_batch
        (caller holds m.cond; admission already reserved their blocks)."""
        m = self._model
        admit = []
        while self.waiting and \
                len(self.running) + len(admit) < m.max_decode_batch:
            admit.append(self.waiting.popleft())
        return admit

    def _fail_inflight(self, extra, err, waiting):
        m = self._model
        with m.cond:
            doomed = list(self.running) + list(extra)
            if waiting:
                doomed += list(self.waiting)
                self.waiting.clear()
            self.running = []
        seen = set()
        for req in doomed:
            # an admitted request can sit in both `running` and `extra`
            if id(req) in seen or req.done():
                continue
            seen.add(id(req))
            self._retire(req, error=err)

    # -- phases --------------------------------------------------------------
    def _prefill(self, req):
        """One request's padded prompt through the causal stack; emits
        the first greedy token and joins the running set."""
        m = self._model
        plen = len(req.prompt)
        tpad = pick_bucket(m.prompt_buckets, plen)
        req.table = BlockTable(self.pool, m.table_width)
        req.table.extend(self.pool.blocks_for(plen))
        tokens = np.zeros(tpad, np.int32)
        tokens[:plen] = req.prompt
        t0 = time.monotonic_ns()
        tok = int(self._host_tokens(self.steps.prefill(
            tokens, plen, req.table.row[:tpad // self.pool.block_tokens])))
        now = time.monotonic_ns()
        self.prefills += 1
        self.prefill_ns += now - t0
        req.next_pos = plen
        self._emit(req, tok, now)
        if req.finish_reason is None:
            self.running.append(req)
        else:
            self._retire(req)

    def _step(self):
        """One iteration-level decode step over the running batch."""
        m = self._model
        live = self.running
        bucket = pick_bucket(m.decode_buckets, len(live))
        tokens = np.zeros(bucket, np.int32)
        positions = np.zeros(bucket, np.int32)
        tables = np.zeros((bucket, m.table_width), np.int32)
        for i, req in enumerate(live):
            req.table.ensure_position(req.next_pos)
            tokens[i] = req.tokens[-1]
            positions[i] = req.next_pos
            tables[i] = req.table.row
        t0 = time.monotonic_ns()
        toks = self._host_tokens(
            self.steps.decode(tokens, positions, tables))
        now = time.monotonic_ns()
        self.decode_steps += 1
        self.decode_ns += now - t0
        self.decode_rows += len(live)
        finished = []
        for i, req in enumerate(live):
            req.next_pos += 1
            self._emit(req, int(toks[i]), now)
            if req.finish_reason is not None:
                finished.append(req)
        for req in finished:
            live.remove(req)
            self._retire(req)

    def _host_tokens(self, tok_dev):
        """The token reply transfer: generated ids must reach the host
        to be streamed to clients and to drive stopping and the next
        step's feed. The one device read (and sync) per step."""
        return tok_dev.cpu().numpy()

    def _emit(self, req, tok, now_ns):
        """Record + stream one generated token; marks the request
        finished when it hits EOS or its budget."""
        m = self._model
        if not req.tokens:
            req.first_token_ns = now_ns
        req.last_token_ns = now_ns
        req._push_token(tok)
        if m.eos_id is not None and tok == m.eos_id:
            req.finish_reason = "eos"
        elif len(req.tokens) >= req.max_new_tokens:
            req.finish_reason = "length"

    # -- retirement ----------------------------------------------------------
    def _retire(self, req, error=None):
        if req.table is not None:
            req.table.release()
            req.table = None
        if req.reserved_blocks:
            self.pool.unreserve(req.reserved_blocks)
            req.reserved_blocks = 0
        req._finish(error)

    def stats(self):
        return {"device": str(self.pool.device),
                "pool": self.pool.occupancy(),
                "prefills": self.prefills,
                "prefill_ns": self.prefill_ns,
                "decode_steps": self.decode_steps,
                "decode_ns": self.decode_ns,
                "decode_rows": self.decode_rows,
                # every step call, warmup included: one attention
                # launch per layer each
                "step_calls": {"prefill": self.steps.prefills,
                               "decode": self.steps.decodes}}


class GenModel:
    """One registered generator: decoder + one lane + admission state.
    Built by ``Gateway.register_generator``; requests enter through
    :meth:`try_admit` (via the gateway, which owns the error messages)."""

    def __init__(self, name, decoder, block_tokens, max_blocks,
                 max_new_tokens, max_decode_batch, max_queue, warmup=True):
        self.name = name
        self.decoder = decoder
        self.eos_id = decoder.eos_id
        self.block_tokens = int(block_tokens)
        self.max_blocks = int(max_blocks)
        self.max_new_tokens = int(max_new_tokens)
        self.max_decode_batch = int(max_decode_batch)
        self.max_queue = int(max_queue)
        self.closed = False
        self.cond = threading.Condition(threading.Lock())
        bt = self.block_tokens
        max_prompt_pad = _ceil_mul(decoder.max_prompt_tokens, bt)
        # prompt pads: the bucket ladder in units of blocks — <2x pad
        # waste, O(log n) distinct prefill shapes
        self.prompt_buckets = tuple(
            b * bt for b in default_buckets(max_prompt_pad // bt))
        self.decode_buckets = default_buckets(self.max_decode_batch)
        self.table_width = (max_prompt_pad + _ceil_mul(
            self.max_new_tokens, bt)) // bt
        if self.table_width > self.max_blocks - 1:
            raise ServingError(
                f"generate: model {name!r} needs up to {self.table_width} "
                f"blocks per request but the pool only has "
                f"{self.max_blocks - 1} usable (raise "
                "MXTPU_GEN_MAX_BLOCKS or lower max_prompt_tokens/"
                "max_new_tokens)")
        t0 = time.perf_counter()
        pool = BlockPool(decoder.num_layers, decoder.num_heads,
                         decoder.head_dim, bt, self.max_blocks,
                         device=decoder.device, dtype=decoder.dtype)
        steps = DecodeSteps(decoder, pool)
        self.lane = GenLane(self, steps, pool)
        if warmup:
            self._warmup(steps)
        self.warmup_seconds = time.perf_counter() - t0
        self.lane.start()

    def _warmup(self, steps):
        """Run every (prefill pad, decode bucket) shape once with
        pad-sink-only writes: the first request of each shape then pays
        no one-time library and allocator set-up."""
        bt = self.block_tokens
        for tpad in self.prompt_buckets:
            steps.prefill(np.zeros(tpad, np.int32), 1,
                          np.zeros(tpad // bt, np.int32))
        for b in self.decode_buckets:
            steps.decode(np.zeros(b, np.int32), np.zeros(b, np.int32),
                         np.zeros((b, self.table_width), np.int32))
        if steps.pool.device.type == "cuda":
            torch.cuda.synchronize(steps.pool.device)

    # -- admission -----------------------------------------------------------
    def try_admit(self, req):
        """None on success, else the rejection reason (pure
        bookkeeping — fast-reject in the caller's thread)."""
        lane = self.lane
        with self.cond:
            if self.closed:
                return "closed"
            if len(lane.waiting) >= self.max_queue:
                return "queue_full"
        need = lane.pool.blocks_for(len(req.prompt) + req.max_new_tokens)
        if not lane.pool.reserve(need):
            return "kv_cache_full"
        req.reserved_blocks = need
        with self.cond:
            if self.closed:
                lane.pool.unreserve(need)
                req.reserved_blocks = 0
                return "closed"
            lane.waiting.append(req)
            self.cond.notify_all()
        return None

    # -- lifecycle -----------------------------------------------------------
    def close(self):
        with self.cond:
            self.closed = True
            self.cond.notify_all()
        self.lane.join(timeout=30.0)
        self.lane.pool.close()

    def stats(self):
        with self.cond:
            waiting = len(self.lane.waiting)
            running = len(self.lane.running)
        return {
            "waiting": waiting,
            "running": running,
            "max_decode_batch": self.max_decode_batch,
            "max_new_tokens": self.max_new_tokens,
            "max_queue": self.max_queue,
            "prompt_buckets": list(self.prompt_buckets),
            "decode_buckets": list(self.decode_buckets),
            "table_width": self.table_width,
            "warmup_seconds": round(self.warmup_seconds, 3),
            "lanes": [self.lane.stats()],
        }


def _ceil_mul(n, m):
    return ((int(n) + m - 1) // m) * m
