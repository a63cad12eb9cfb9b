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
(``blocks_for(prompt + max_new_tokens)``) on the lane with the most
headroom at submit; when no pool can cover it the request raises
:class:`RejectedError` with reason ``kv_cache_full`` in the caller's
thread, before anything queues.

**Decode failover**: a lane that dies (:meth:`GenLane.kill`), fails a
step, or is scaled in evacuates its in-flight generations instead of
failing them — one code path for planned and unplanned loss. Each
evacuated request's KV blocks are salvaged through
:class:`~.migrate.KVMigrator` and landed on a surviving lane's pool
(``mode=migrate``); when the blocks are unsalvageable the survivor
deterministically replays prompt + accepted tokens (``mode=replay``: a
re-prefill, then a batch-1 re-decode that must reproduce every accepted
token). Either way the stream continues token for token, and the
replayable ``stream()`` iterator gives consumers one seamless sequence.
A per-request budget (``MXTPU_GEN_MAX_RECOVERIES``, backoff base
``MXTPU_GEN_RECOVERY_BACKOFF_MS``) degrades to a fast
``RejectedError(reason="lane_lost")`` when exhausted; re-admission
re-reserves blocks atomically on the target pool, so a full pool queues
the recovery rather than double-booking.

Every lane thread runs under ``torch.inference_mode()`` (grad mode is
thread-local, and a new thread starts with it on) and warms its shapes
itself before it serves. A lane on a CUDA device owns a CUDA stream: its
pool is allocated, its steps run and its warmup is waited for on that
stream, so lanes sharing one card overlap their kernels and a lane
scaled out while others serve waits for no one's work but its own.
A tensor-parallel generator (``tp >= 2``) gives every lane a mesh slice
of ``tp`` devices: its pool shards the heads over the slice and its
:class:`~.model.DecodeSteps` run one shard thread a device; the lane's
stream is its first device's.

The ``mx_serving_generate_*`` telemetry families count requests,
rejections, prefill / decode tokens and steps, recoveries, the running
batch, the queue depth and the block pools, and time to first token and
between tokens. When a request retires its lane records its spans under
the request's trace context: a ``serving.generate`` root, one
``generate.prefill`` (submit to first token), one ``generate.recover``
per rescue and one ``generate.token`` per generated token (its step's
launch to the token on the host). Everything recorded is host
bookkeeping: the one device read a step is the token reply.
"""
from __future__ import annotations

import logging
import threading
import time
from collections import deque

import numpy as np
import torch

from ...base import MXNetError, get_env
from ... import tracing
from ...context import resolve_device
from ...kvstore import fault as _fault
from ...telemetry import metrics as _tm
from ...tracing import clock
from ..batcher import RejectedError, ServingError
from ..variants import default_buckets, pick_bucket
from .kvcache import BlockPool, BlockTable
from .migrate import KVMigrator
from .model import DecodeSteps

logger = logging.getLogger(__name__)

_met = _tm.lazy_metrics(lambda reg: {
    "requests": reg.counter(
        "mx_serving_generate_requests_total",
        "admitted generation requests", labelnames=("model",)),
    "rejected": reg.counter(
        "mx_serving_generate_rejected_total",
        "fast-rejected generation requests",
        labelnames=("model", "reason")),
    "tokens": reg.counter(
        "mx_serving_generate_tokens_total",
        "tokens through the decode plane (prefill = prompt tokens "
        "consumed, decode = tokens generated)",
        labelnames=("model", "phase")),
    "steps": reg.counter(
        "mx_serving_generate_steps_total",
        "compiled step executions", labelnames=("model", "phase")),
    "inflight": reg.gauge(
        "mx_serving_generate_inflight",
        "requests in the running decode batch",
        labelnames=("model", "lane")),
    # the family the one-shot gateway writes too: a generator's queue
    # depth reads the same way as a one-shot model's
    "depth": reg.gauge(
        "mx_serving_queue_depth",
        "requests pending in the model queue", labelnames=("model",)),
    "batch_rows": reg.histogram(
        "mx_serving_generate_batch_rows",
        "running requests per decode step", labelnames=("model",),
        buckets=(1, 2, 4, 8, 16, 32, 64)),
    # phase = steady | recover: a failover stall reads as what it is,
    # not as steady-state degradation
    "ttft": reg.histogram(
        "mx_serving_generate_ttft_seconds",
        "submit -> first token (prefill + queue)",
        labelnames=("model", "phase")),
    "inter_token": reg.histogram(
        "mx_serving_generate_inter_token_seconds",
        "gap between consecutive streamed tokens of one request",
        labelnames=("model", "phase")),
    "recoveries": reg.counter(
        "mx_serving_gen_recoveries_total",
        "in-flight generations recovered onto a surviving lane "
        "(migrate = KV blocks salvaged, replay = deterministic "
        "re-decode of prompt + accepted tokens)",
        labelnames=("model", "mode")),
    "cache_blocks": reg.gauge(
        "mx_serving_generate_cache_blocks",
        "block-pool state per lane",
        labelnames=("model", "lane", "state")),
    "occupancy": reg.histogram(
        "mx_serving_generate_cache_occupancy",
        "used fraction of the block pool, sampled at every decode "
        "step", labelnames=("model",),
        buckets=(0.1, 0.25, 0.5, 0.75, 0.9, 1.0)),
})

# CUDA streams of finalized lanes, by device, handed to the next lane
# built there: cuBLAS keeps a workspace per stream, so a scale-in /
# scale-out cycle that reuses a stream adds none
_spare_streams = {}
_spare_lock = threading.Lock()


def _lane_stream(device):
    if device.type != "cuda":
        return None
    with _spare_lock:
        spare = _spare_streams.get(device)
        if spare:
            return spare.pop()
    return torch.cuda.Stream(device)


def _return_stream(device, stream):
    if stream is not None:
        with _spare_lock:
            _spare_streams.setdefault(device, []).append(stream)


class GenRequest:
    """One generation request + its streaming reply.

    ``stream()`` yields token ids as the scheduler emits them;
    ``result(timeout)`` blocks for the full greedy completion. Either
    raises the serving-side error if the request failed. ``recoveries``
    counts the lanes it survived; ``recover_spans`` holds one
    ``(start_ns, end_ns, attrs)`` per rescue (``attrs["mode"]`` is
    ``migrate`` or ``replay``). ``trace_ctx`` is the ``(trace_id,
    parent_span_id)`` its spans are recorded under (0: untraced);
    ``token_spans`` / ``step_meta`` hold each token's step interval and
    its (interleave ns, rows, bucket); ``admit_ns``, ``kv_wait_ns``,
    ``queue_cause``, ``prefill_exec_ns`` and ``prompt_pad`` are the
    prefill span's attributes."""

    __slots__ = ("model", "prompt", "max_new_tokens", "trace_ctx",
                 "submit_ns", "first_token_ns", "last_token_ns",
                 "tokens", "token_spans", "step_meta", "table",
                 "next_pos", "reserved_blocks", "finish_reason",
                 "recoveries", "recover_spans", "admit_ns",
                 "kv_wait_ns", "queue_cause", "prefill_exec_ns",
                 "prompt_pad", "_kv_wait_t0", "_recover_cause",
                 "_salvage", "_recover_t0", "_recovered", "_cv",
                 "_done", "_error")

    def __init__(self, model, prompt, max_new_tokens, trace_ctx=(0, 0)):
        self.model = model
        self.prompt = np.asarray(prompt, np.int32).ravel()
        self.max_new_tokens = int(max_new_tokens)
        self.trace_ctx = trace_ctx
        self.submit_ns = clock.now_ns()
        self.first_token_ns = 0
        self.last_token_ns = 0
        self.tokens = []
        self.token_spans = []
        self.step_meta = []       # (interleave_ns, rows, bucket) a token
        self.table = None
        self.next_pos = 0
        self.reserved_blocks = 0
        self.finish_reason = None
        self.recoveries = 0       # times this request survived a lane
        self.recover_spans = []   # (start_ns, end_ns, attrs) per rescue
        # when the request was first admitted, how long its admission
        # waited on KV budget, and what held its queue wait
        self.admit_ns = 0
        self.kv_wait_ns = 0
        self.queue_cause = None
        self.prefill_exec_ns = 0
        self.prompt_pad = 0
        self._kv_wait_t0 = 0
        self._recover_cause = None
        self._salvage = None      # KV blocks gathered off a dead lane
        self._recover_t0 = 0
        self._recovered = False   # next emit is the post-rescue token
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
    thread that re-forms its batch every step (on ``stream`` when the
    lane is on a CUDA device). ``device`` is the lane's device, or the
    tuple of its slice's devices for a tensor-parallel lane.
    ``prefill_ns`` / ``decode_ns`` sum the
    host wall time of the requests' ``prefills`` and ``decode_steps``,
    each ending in the token read (a sync of the lane's stream);
    ``replays`` and ``replay_decodes`` count the deterministic replays
    this lane ran and their batch-1 re-decode steps, ``migrations`` the
    KV-block landings. Warmup calls are in none of them."""

    def __init__(self, model, idx, device, steps, pool, stream=None):
        self._model = model
        self.idx = idx
        self.device = device
        self.steps = steps
        self.pool = pool
        self.stream = stream
        self.waiting = deque()
        self.running = []
        self._thread = None
        # a retiring lane takes no new admissions and EVACUATES its
        # waiting + running requests onto the surviving lanes (migrate /
        # replay), then exits so its pool can be released: planned
        # scale-in and a kill are one code path
        self.retiring = False
        self.cause = None        # why the lane went away
        self.finalized = False   # pool closed + lane removed (once)
        self.warmed = 0          # shapes its warmup ran
        self.prefills = 0
        self.prefill_ns = 0
        self.decode_steps = 0
        self.decode_ns = 0
        self.decode_rows = 0
        self.replays = 0
        self.replay_decodes = 0
        self.migrations = 0

    def start(self):
        """Start the lane thread. When its model warms, the thread first
        runs every prefill and decode shape once (:meth:`GenModel.
        _warmup`, counted in ``warmed``) and waits for it on the lane's
        stream, and the call returns when that is done (re-raising its
        failure): the warmup runs on the lane's own thread because cuBLAS
        keeps its handles and workspaces per thread — warmed on another
        thread, the first steps would pay for them."""
        ready = threading.Event()
        warm = {}
        self._thread = threading.Thread(
            target=self._loop, args=(ready, warm), daemon=True,
            name=f"mxtpu-torch-generate-{self._model.name}-l{self.idx}")
        self._thread.start()
        ready.wait()
        if "error" in warm:
            self.join()
            raise warm["error"]

    def join(self, timeout=None):
        if self._thread is not None:
            self._thread.join(timeout)

    def kill(self, cause=None):
        """Abrupt lane loss (the chaos seam): stop scheduling at the
        next step boundary and evacuate every in-flight generation onto
        the surviving lanes — blocks migrate while the pool still
        answers, replay covers the truly-gone case."""
        m = self._model
        with m.cond:
            if self.retiring:
                return
            self.cause = cause or f"lane {self.idx} killed"
            self.retiring = True
            m.cond.notify_all()

    # -- scheduler loop ------------------------------------------------------
    def _loop(self, ready, warm):
        m = self._model
        with torch.inference_mode(), torch.cuda.stream(self.stream):
            try:
                if m._warmup_lanes:
                    self.warmed = m._warmup(self.steps)
                if self.stream is not None:
                    # the lane's own stream, never the whole device:
                    # lanes already serving on the card keep going
                    self.stream.synchronize()
            except BaseException as e:  # noqa: BLE001 — re-raised by start
                warm["error"] = e
                return
            finally:
                ready.set()
            self._serve()

    def _serve(self):
        m = self._model
        while True:
            doomed = None
            admit = []
            with m.cond:
                while True:
                    if m.closed or self.retiring:
                        break
                    admit = self._pop_admissions()
                    if admit or self.running:
                        break
                    # idle, or the queue head is a recovery whose
                    # re-reservation cannot fit yet: wait for a submit
                    # or a retire freeing budget (bounded: the freeing
                    # unreserve may race this probe)
                    m.cond.wait(0.1)
                if m.closed:
                    break
                if self.retiring:
                    doomed = list(self.running) + list(self.waiting)
                    self.running = []
                    self.waiting.clear()
            if doomed is not None:
                # evacuate, then finalize (outside the cond lock): the
                # scale-in initiator may have given up on its join long
                # ago, and a pool nobody closes would stay on the device
                self._evacuate(doomed)
                return
            if admit:
                m._observe_depth()     # the waiting set just shrank
            try:
                t_adm = clock.now_ns()
                for req in admit:
                    self._start(req)
                # admission work (prefill, replay, landing) runs before
                # the next decode step: every running request's next
                # token waits behind it, stamped on its token span
                interleave_ns = clock.now_ns() - t_adm if admit else 0
                if self.running:
                    self._step(interleave_ns)
            except Exception as e:  # noqa: BLE001 — a failed step
                # evacuates ITS requests onto the surviving lanes
                # (possibly this one); the lane survives for new work
                logger.exception("generate: step on lane %d of %r failed",
                                 self.idx, m.name)
                self._recover_inflight(admit, e)
        self._fail_inflight([], ServingError(
            f"generate: model {m.name!r} shut down before the request "
            "completed"))

    def _pop_admissions(self):
        """Pop admittable waiting requests (caller holds m.cond). A
        recovery re-queued without a reservation re-reserves atomically
        HERE, on the pool it will decode on — a full pool leaves it
        queued (no double-booking), retried when a retire frees
        budget."""
        m = self._model
        admit = []
        now = clock.now_ns()
        while self.waiting and \
                len(self.running) + len(admit) < m.max_decode_batch:
            req = self.waiting[0]
            if req.reserved_blocks == 0:
                need = self.pool.blocks_for(
                    len(req.prompt) + req.max_new_tokens)
                if not self.pool.reserve(need):
                    # the head waits on cache budget: from here on its
                    # queue wait is KV pressure, not backlog
                    if not req._kv_wait_t0:
                        req._kv_wait_t0 = now
                    req.queue_cause = "kv_wait"
                    break
                req.reserved_blocks = need
            if req._kv_wait_t0:
                req.kv_wait_ns += max(now - req._kv_wait_t0, 0)
                req._kv_wait_t0 = 0
            if not req.admit_ns:      # the first admission counts: a
                req.admit_ns = now    # recovery's is the recovery's
            if req.queue_cause is None:
                req.queue_cause = "backlog" if (self.running or admit) \
                    else "none"
            self.waiting.popleft()
            admit.append(req)
        if self.waiting and \
                len(self.running) + len(admit) >= m.max_decode_batch:
            head = self.waiting[0]
            if head.queue_cause is None:
                head.queue_cause = "batch_full"
        return admit

    def _evacuate(self, doomed):
        """Retiring or killed lane: hand every admitted request to the
        surviving lanes (migrate preferred, replay as the fallback),
        then finalize."""
        m = self._model
        _met()["inflight"].labels(model=m.name, lane=str(self.idx)).set(0)
        m._observe_depth()
        m._recover_requests(
            self, doomed, self.cause or f"lane {self.idx} retired")
        m._finalize_retired_lane(self)

    def _recover_inflight(self, extra, err):
        """A failed prefill/step: route the affected requests through
        migrate/replay instead of failing them (budget-bounded — a
        persistently failing request degrades to ``lane_lost``)."""
        m = self._model
        with m.cond:
            doomed = list(self.running)
            self.running = []
        seen = set()
        uniq = []
        for req in doomed + [r for r in extra if not r.done()]:
            if id(req) not in seen:
                seen.add(id(req))
                uniq.append(req)
        _met()["inflight"].labels(model=m.name, lane=str(self.idx)).set(0)
        m._observe_depth()
        m._recover_requests(self, uniq, repr(err))

    def _fail_inflight(self, extra, err):
        m = self._model
        with m.cond:
            doomed = list(self.running) + list(self.waiting) + \
                [r for r in extra if not r.done()]
            self.running = []
            self.waiting.clear()
        # the gauges were last set with a live batch: a failed or closed
        # lane reads 0, not its last batch size
        _met()["inflight"].labels(model=m.name, lane=str(self.idx)).set(0)
        m._observe_depth()
        seen = set()
        for req in doomed:
            # an admitted request can sit in both `running` and `extra`
            if id(req) in seen or req.done():
                continue
            seen.add(id(req))
            self._retire(req, error=err)

    # -- phases --------------------------------------------------------------
    def _start(self, req):
        """Dispatch one admitted request: land a KV-block migration,
        deterministically replay a recovery, or fresh-prefill."""
        if req._salvage is not None and self._land_migration(req):
            return
        if req.tokens:
            self._replay(req)
        else:
            self._prefill(req)

    def _land_migration(self, req):
        """Write the request's salvaged KV blocks into THIS pool and
        rejoin it to the running batch — the migrate recovery mode.
        False when the landing fails (wedged/closed): the caller falls
        back to deterministic replay, which only needs the tokens."""
        m = self._model
        met = _met()
        salvage, req._salvage = req._salvage, None
        try:
            table, handoff = m.migrator.land(salvage, self.pool,
                                             m.table_width)
        except MXNetError:
            return False
        req.table = table
        # between steps the cache holds prompt + tokens[:-1]; the very
        # next decode step feeds tokens[-1] at next_pos — the invariant
        # the migrated table keeps byte for byte
        req.next_pos = len(req.prompt) + len(req.tokens) - 1
        now = clock.now_ns()
        req.recover_spans.append((
            req._recover_t0 or now, now,
            {"mode": "migrate", "lane": self.idx,
             "cause": req._recover_cause,
             "blocks": handoff["blocks"],
             "bytes_moved": handoff["bytes_moved"],
             "est_s": handoff["est_s"],
             "wall_ns": handoff["wall_ns"]}))
        req._recovered = True
        met["recoveries"].labels(model=m.name, mode="migrate").inc()
        self.migrations += 1
        self.running.append(req)
        met["inflight"].labels(model=m.name, lane=str(self.idx)).set(
            len(self.running))
        self._observe_pool()
        return True

    def _replay(self, req):
        """Deterministic replay on THIS lane: re-prefill the prompt,
        silently re-decode the already-accepted tokens at batch 1 (no
        re-emission — consumers see one seamless stream), rejoin the
        running batch. Greedy decode makes the continuation token for
        token the never-killed run's; a divergence raises."""
        m = self._model
        met = _met()
        t0 = clock.now_ns()
        accepted = list(req.tokens)
        plen = len(req.prompt)
        tpad = pick_bucket(m.prompt_buckets, plen)
        req.table = BlockTable(self.pool, m.table_width)
        req.table.extend(self.pool.blocks_for(plen))
        tokens = np.zeros(tpad, np.int32)
        tokens[:plen] = req.prompt
        first = int(self._host_tokens(self.steps.prefill(
            tokens, plen,
            req.table.row[:tpad // self.pool.block_tokens])))
        req.next_pos = plen
        if first != accepted[0]:
            raise MXNetError(
                "generate: replay diverged at the first token "
                f"({first} != accepted {accepted[0]}) — greedy decode "
                "must be deterministic")
        # batch-1 silent re-decode through the warmed bucket: feed each
        # accepted token at its original position, checking the
        # re-derived successor
        bucket = pick_bucket(m.decode_buckets, 1)
        for j in range(1, len(accepted)):
            req.table.ensure_position(req.next_pos)
            tkn = np.zeros(bucket, np.int32)
            pos = np.zeros(bucket, np.int32)
            tab = np.zeros((bucket, m.table_width), np.int32)
            tkn[0] = accepted[j - 1]
            pos[0] = req.next_pos
            tab[0] = req.table.row
            nxt = int(self._host_tokens(
                self.steps.decode(tkn, pos, tab))[0])
            self.replay_decodes += 1
            req.next_pos += 1
            if nxt != accepted[j]:
                raise MXNetError(
                    f"generate: replay diverged at token {j} "
                    f"({nxt} != accepted {accepted[j]}) — greedy "
                    "decode must be deterministic")
        met["tokens"].labels(model=m.name, phase="replay").inc(
            plen + max(len(accepted) - 1, 0))
        met["steps"].labels(model=m.name, phase="replay").inc(
            len(accepted))
        now = clock.now_ns()
        req.recover_spans.append((
            req._recover_t0 or now, now,
            {"mode": "replay", "lane": self.idx,
             "cause": req._recover_cause,
             "prompt_tokens": plen,
             "replayed_tokens": len(accepted),
             "wall_ns": now - t0}))
        req._recovered = True
        met["recoveries"].labels(model=m.name, mode="replay").inc()
        self.replays += 1
        self.running.append(req)
        met["inflight"].labels(model=m.name, lane=str(self.idx)).set(
            len(self.running))
        self._observe_pool()

    def _prefill(self, req):
        """One request's padded prompt through the causal stack; emits
        the first greedy token and joins the running set."""
        m = self._model
        met = _met()
        plen = len(req.prompt)
        tpad = pick_bucket(m.prompt_buckets, plen)
        req.table = BlockTable(self.pool, m.table_width)
        req.table.extend(self.pool.blocks_for(plen))
        tokens = np.zeros(tpad, np.int32)
        tokens[:plen] = req.prompt
        t0 = clock.now_ns()
        tok = int(self._host_tokens(self.steps.prefill(
            tokens, plen, req.table.row[:tpad // self.pool.block_tokens])))
        now = clock.now_ns()
        self.prefills += 1
        self.prefill_ns += now - t0
        req.prefill_exec_ns = now - t0
        req.prompt_pad = tpad
        req.next_pos = plen
        met["tokens"].labels(model=m.name, phase="prefill").inc(plen)
        met["steps"].labels(model=m.name, phase="prefill").inc()
        self._emit(req, tok, t0, now, rows=plen, bucket=tpad)
        if req.finish_reason is None:
            self.running.append(req)
            met["inflight"].labels(model=m.name, lane=str(self.idx)).set(
                len(self.running))
        else:
            self._retire(req)

    def _step(self, interleave_ns=0):
        """One iteration-level decode step over the running batch.
        ``interleave_ns`` is the admission work that held this step,
        stamped on every token it emits."""
        m = self._model
        met = _met()
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
        t0 = clock.now_ns()
        toks = self._host_tokens(
            self.steps.decode(tokens, positions, tables))
        now = clock.now_ns()
        self.decode_steps += 1
        self.decode_ns += now - t0
        self.decode_rows += len(live)
        met["steps"].labels(model=m.name, phase="decode").inc()
        met["tokens"].labels(model=m.name, phase="decode").inc(len(live))
        met["batch_rows"].labels(model=m.name).observe(len(live))
        self._observe_pool()
        finished = []
        for i, req in enumerate(live):
            req.next_pos += 1
            self._emit(req, int(toks[i]), t0, now,
                       interleave_ns=interleave_ns, rows=len(live),
                       bucket=bucket)
            if req.finish_reason is not None:
                finished.append(req)
        for req in finished:
            live.remove(req)
            self._retire(req)
        met["inflight"].labels(model=m.name, lane=str(self.idx)).set(
            len(live))

    def _host_tokens(self, tok_dev):
        """The token reply transfer: generated ids must reach the host
        to be streamed to clients and to drive stopping and the next
        step's feed. The one device read (a sync of the lane's stream)
        per step."""
        return tok_dev.cpu().numpy()

    def _emit(self, req, tok, step_start_ns, now_ns, interleave_ns=0,
              rows=1, bucket=1):
        """Record and stream one generated token; marks the request
        finished when it hits EOS or its budget. The step's interval and
        metadata (interleave stall, real rows, padded bucket) become the
        token's span at retirement."""
        m = self._model
        met = _met()
        phase = "recover" if req._recovered else "steady"
        req._recovered = False
        if not req.tokens:
            req.first_token_ns = now_ns
            met["ttft"].labels(model=m.name, phase=phase).observe(
                (now_ns - req.submit_ns) / 1e9)
        else:
            met["inter_token"].labels(model=m.name, phase=phase).observe(
                (now_ns - req.last_token_ns) / 1e9)
        req.last_token_ns = now_ns
        req.token_spans.append((step_start_ns, now_ns))
        req.step_meta.append((interleave_ns, rows, bucket))
        req._push_token(tok)
        if m.eos_id is not None and tok == m.eos_id:
            req.finish_reason = "eos"
        elif len(req.tokens) >= req.max_new_tokens:
            req.finish_reason = "length"

    # -- retirement ----------------------------------------------------------
    def _retire(self, req, error=None):
        m = self._model
        if req.table is not None:
            req.table.release()
            req.table = None
        if req.reserved_blocks:
            self.pool.unreserve(req.reserved_blocks)
            req.reserved_blocks = 0
        req._salvage = None
        # the freed reservation may be exactly what a queued recovery
        # on another lane is waiting to re-reserve
        with m.cond:
            m.cond.notify_all()
        self._observe_pool()
        self._record_spans(req, error)
        req._finish(error)

    def _observe_pool(self):
        m = self._model
        met = _met()
        occ = self.pool.occupancy()
        lane = str(self.idx)
        for state in ("used", "free", "reserved"):
            met["cache_blocks"].labels(
                model=m.name, lane=lane, state=state).set(
                occ["%s_blocks" % state])
        met["occupancy"].labels(model=m.name).observe(occ["used_frac"])

    def _record_spans(self, req, error):
        """The request's span tree under its trace context: the
        ``serving.generate`` root, ``generate.prefill`` (submit to first
        token), each ``generate.recover`` and one ``generate.token`` a
        token."""
        m = self._model
        trace_id, parent = req.trace_ctx
        if not trace_id:
            return
        end = req.last_token_ns or clock.now_ns()
        admit_wait = max(req.admit_ns - req.submit_ns, 0) \
            if req.admit_ns else 0
        root = tracing.record_span(
            "serving.generate", trace_id, parent, req.submit_ns, end,
            cat="serving",
            attrs={"model": m.name, "lane": self.idx,
                   "prompt_tokens": len(req.prompt),
                   "new_tokens": len(req.tokens),
                   "recoveries": req.recoveries,
                   "queue_cause": req.queue_cause or "none",
                   "finish": ("error" if error is not None
                              else req.finish_reason)})
        if req.first_token_ns:
            tracing.record_span(
                "generate.prefill", trace_id, root, req.submit_ns,
                req.first_token_ns, cat="serving",
                attrs={"prompt_tokens": len(req.prompt),
                       "pad_tokens": req.prompt_pad,
                       "queue_ns": admit_wait,
                       "kv_wait_ns": req.kv_wait_ns,
                       "exec_ns": req.prefill_exec_ns})
        for s, e, attrs in req.recover_spans:
            tracing.record_span("generate.recover", trace_id, root,
                                s, e, cat="serving", attrs=attrs)
        for j, (s, e) in enumerate(req.token_spans):
            attrs = {"index": j}
            if j < len(req.step_meta):
                inter, rows, bucket = req.step_meta[j]
                attrs.update(interleave_ns=inter, rows=rows,
                             bucket=bucket)
            tracing.record_span("generate.token", trace_id, root, s, e,
                                cat="serving", attrs=attrs)

    def stats(self):
        return {"idx": self.idx,
                "device": ([str(d) for d in self.device]
                           if isinstance(self.device, tuple)
                           else str(self.device)),
                "retiring": self.retiring,
                "pool": self.pool.occupancy(),
                "prefills": self.prefills,
                "prefill_ns": self.prefill_ns,
                "decode_steps": self.decode_steps,
                "decode_ns": self.decode_ns,
                "decode_rows": self.decode_rows,
                "replays": self.replays,
                "replay_decodes": self.replay_decodes,
                "migrations": self.migrations,
                # every step call, warmup and replays included: one
                # attention launch per layer each
                "step_calls": {"prefill": self.steps.prefills,
                               "decode": self.steps.decodes}}


class GenModel:
    """One registered generator: decoder + N lanes + admission state.
    Built by ``Gateway.register_generator`` with the lanes' ``devices``
    (the gateway's placement); requests enter through :meth:`try_admit`
    (via the gateway, which owns the error messages)."""

    def __init__(self, name, decoder, devices, block_tokens, max_blocks,
                 max_new_tokens, max_decode_batch, max_queue,
                 warmup=True, tp=None, layout=None):
        self.name = name
        self.decoder = decoder
        # tp >= 2: every entry of ``devices`` is a slice (a tuple of tp
        # devices); the lanes' pools shard their heads over it and their
        # steps place the weights by ``layout``'s role table
        self.tp = tp
        self.layout = layout
        self.eos_id = decoder.eos_id
        self.block_tokens = int(block_tokens)
        self.max_blocks = int(max_blocks)
        self.max_new_tokens = int(max_new_tokens)
        self.max_decode_batch = int(max_decode_batch)
        self.max_queue = int(max_queue)
        self.closed = False
        self.cond = threading.Condition(threading.Lock())
        # decode failover: how many lane losses one request survives
        # before degrading to a fast lane_lost reject, and the backoff
        # base between REPEAT recoveries of the same request (doubling,
        # capped at 40x base — the first rescue is always immediate)
        self.max_recoveries = max(
            int(get_env("MXTPU_GEN_MAX_RECOVERIES", 2, int)), 0)
        self.recovery_backoff_ms = max(
            float(get_env("MXTPU_GEN_RECOVERY_BACKOFF_MS", 50.0,
                          float)), 0.0)
        self.fault_plan = None   # None -> MXNET_KVSTORE_FAULT_PLAN
        self.migrator = KVMigrator(name)
        self.lane_lost_rejections = 0
        self._recovery_round = 0
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
        self.lanes = []
        self.executables = 0
        self.degraded = False
        self._warmup_lanes = bool(warmup)
        self._next_idx = 0
        t0 = time.perf_counter()
        try:
            for device in devices:
                self.lanes.append(self._start_lane(device))
        except BaseException:
            self.close()
            raise
        self.warmup_seconds = time.perf_counter() - t0

    def _start_lane(self, device):
        """One decode lane (pool + steps + scheduler thread), started
        and, when the model warms, warmed on its own thread —
        registration and scale-out share this. On a CUDA device the lane
        gets its own stream, and its pool, warmup and steps run on it. A
        slice (a tuple of devices) makes a tensor-parallel lane."""
        dec = self.decoder
        if isinstance(device, (list, tuple)) and len(device) == 1:
            device = device[0]           # a 1-device slice is a plain lane
        sliced = isinstance(device, (list, tuple))
        stream = _lane_stream(resolve_device(device[0] if sliced
                                             else device))
        with torch.cuda.stream(stream):
            pool = BlockPool(dec.num_layers, dec.num_heads, dec.head_dim,
                             self.block_tokens, self.max_blocks,
                             device=device, dtype=dec.dtype)
        try:
            steps = DecodeSteps(dec, pool, self.layout)
        except BaseException:
            pool.close()
            _return_stream(pool.device, stream)
            raise
        lane = GenLane(self, self._next_idx,
                       pool.devices if sliced else pool.device, steps, pool,
                       stream)
        self._next_idx += 1
        try:
            lane.start()
        except BaseException:
            pool.close()
            _return_stream(pool.device, stream)
            raise
        self.executables += lane.warmed
        return lane

    def _warmup(self, steps):
        """Run every (prefill pad, decode bucket) shape once with
        pad-sink-only writes: the first request of each shape then pays
        no one-time library and allocator set-up. Returns the number of
        shapes run."""
        bt = self.block_tokens
        for tpad in self.prompt_buckets:
            steps.prefill(np.zeros(tpad, np.int32), 1,
                          np.zeros(tpad // bt, np.int32))
        for b in self.decode_buckets:
            steps.decode(np.zeros(b, np.int32), np.zeros(b, np.int32),
                         np.zeros((b, self.table_width), np.int32))
        return len(self.prompt_buckets) + len(self.decode_buckets)

    # -- admission -----------------------------------------------------------
    def try_admit(self, req):
        """None on success, else the rejection reason (pure
        bookkeeping — fast-reject in the caller's thread). The request
        reserves its budget on the live lane with the most headroom."""
        if self.closed:
            return "closed"
        with self.cond:
            depth = sum(len(ln.waiting) for ln in self.lanes)
            # retiring lanes drain, they do not admit: their pools are
            # about to be released
            live = [ln for ln in self.lanes if not ln.retiring]
        if not live:
            return "closed"
        if depth >= self.max_queue:
            return "queue_full"
        need = live[0].pool.blocks_for(
            len(req.prompt) + req.max_new_tokens)
        # most-headroom lane first; reservation is atomic per pool, so a
        # racing submit simply falls through to the next lane
        for lane in sorted(live, key=lambda ln: ln.pool.reserved_blocks()):
            if lane.pool.reserve(need):
                req.reserved_blocks = need
                with self.cond:
                    if self.closed:
                        lane.pool.unreserve(need)
                        req.reserved_blocks = 0
                        return "closed"
                    if lane.retiring:
                        # scale-in landed between the reserve and the
                        # enqueue: hand the budget back, try the next
                        lane.pool.unreserve(need)
                        req.reserved_blocks = 0
                        continue
                    lane.waiting.append(req)
                    self.cond.notify_all()
                self._observe_depth()
                return None
        return "kv_cache_full"

    def _observe_depth(self):
        """Publish the waiting count on the shared queue-depth gauge
        (host ints under the cond lock)."""
        with self.cond:
            depth = sum(len(ln.waiting) for ln in self.lanes)
        _met()["depth"].labels(model=self.name).set(depth)

    # -- decode failover -----------------------------------------------------
    def _recover_requests(self, src_lane, reqs, cause):
        """Evacuate ``reqs`` off ``src_lane`` onto surviving lanes (on
        the source lane's thread and stream).

        Per request: enforce the recovery budget (exhaustion = fast
        ``lane_lost`` reject), salvage its KV blocks while the source
        pool still answers (unless a ``replay_storm`` fault forces the
        device-truly-gone case), detach it from the source pool, then
        re-admit on the lane with the most headroom — reserving
        atomically on the target, or queueing unreserved when every
        pool is full (the target's admission loop re-reserves the
        moment a retire frees budget; nothing double-books). Requests
        that never decoded a token just requeue: they lost no state, so
        they spend no budget."""
        reqs = [r for r in reqs if not r.done()]
        if not reqs:
            return
        with self.cond:
            self._recovery_round += 1
            rround = self._recovery_round
        storm = _fault.replay_storm_active(rround, plan=self.fault_plan)
        met = _met()
        for req in reqs:
            req._recover_cause = cause
            if self.closed:
                src_lane._retire(req, error=ServingError(
                    f"generate: model {self.name!r} shut down before "
                    "the request completed"))
                continue
            if req.tokens:
                req.recoveries += 1
                if req.recoveries > self.max_recoveries:
                    with self.cond:
                        self.lane_lost_rejections += 1
                    met["rejected"].labels(model=self.name,
                                           reason="lane_lost").inc()
                    src_lane._retire(req, error=RejectedError(
                        "lane_lost",
                        f"generate: request on {self.name!r} lost its "
                        f"lane {req.recoveries} time(s) ({cause}) and "
                        "exhausted its recovery budget (MXTPU_GEN_MAX_"
                        f"RECOVERIES={self.max_recoveries}); resubmit "
                        "to retry"))
                    continue
                if req.recoveries > 1:
                    # bounded backoff between REPEAT rescues of one
                    # request: a request ping-ponging across dying lanes
                    # must not busy-spin the recovery path (pacing, not
                    # polling: nothing signals "retry now")
                    time.sleep(min(
                        self.recovery_backoff_ms
                        * 2.0 ** (req.recoveries - 2),
                        self.recovery_backoff_ms * 40.0) / 1e3)
                req._recover_t0 = clock.now_ns()
                if req._salvage is None and not storm \
                        and req.table is not None and req.table.blocks:
                    try:
                        req._salvage = self.migrator.salvage(
                            src_lane.pool, req.table.blocks)
                    except MXNetError:
                        req._salvage = None   # replay covers it
            # detach from the source pool (the salvage, when taken, owns
            # its bytes — the pool can close right after)
            if req.table is not None:
                req.table.release()
                req.table = None
            if req.reserved_blocks:
                src_lane.pool.unreserve(req.reserved_blocks)
                req.reserved_blocks = 0
            req.next_pos = 0
            need = src_lane.pool.blocks_for(
                len(req.prompt) + req.max_new_tokens)
            while True:
                with self.cond:
                    live = [ln for ln in self.lanes
                            if not ln.retiring and not ln.finalized]
                if not live:
                    with self.cond:
                        self.lane_lost_rejections += 1
                    met["rejected"].labels(model=self.name,
                                           reason="lane_lost").inc()
                    src_lane._retire(req, error=RejectedError(
                        "lane_lost",
                        f"generate: model {self.name!r} has no "
                        f"surviving decode lanes to recover onto "
                        f"({cause})"))
                    break
                order = sorted(live,
                               key=lambda ln: ln.pool.reserved_blocks())
                target = None
                for ln in order:
                    if ln.pool.reserve(need):
                        req.reserved_blocks = need
                        target = ln
                        break
                if target is None:
                    # kv_cache_full during recovery: queue on the
                    # least-booked lane with NO reservation — its
                    # admission loop re-reserves atomically once a
                    # retire frees budget
                    target = order[0]
                with self.cond:
                    if not target.retiring:
                        target.waiting.append(req)
                        self.cond.notify_all()
                        break
                # the target started retiring between selection and
                # enqueue: hand the budget back and pick again
                if req.reserved_blocks:
                    target.pool.unreserve(req.reserved_blocks)
                    req.reserved_blocks = 0
        self._observe_depth()

    # -- lifecycle -----------------------------------------------------------
    def scale_to(self, n, devices, drain_timeout=30.0):
        """Resize to ``n`` decode lanes (``Gateway.scale``'s generator
        arm). ``devices`` is the full n-lane placement. Scale-out
        builds, warms and starts fresh lanes; scale-in retires the
        newest lanes evacuate-first: all stop admitting at once, and each
        hands its waiting + running requests to the surviving lanes
        through the migrate/replay path (no request waits out a drain)
        and releases its KV block pool — ``freed_bytes`` of device
        memory.
        Returns a report dict."""
        n = int(n)
        if n < 1:
            raise ServingError(
                f"generate: cannot scale {self.name!r} below 1 lane")
        with self.cond:
            active = [ln for ln in self.lanes if not ln.retiring]
        report = {"model": self.name, "from": len(active), "to": n,
                  "added": 0, "retired": 0, "freed_bytes": 0}
        if n > len(active):
            for device in devices[len(active):n]:
                # warmed before it joins: no request waits on a warmup
                lane = self._start_lane(device)
                with self.cond:
                    self.lanes.append(lane)
                    self.cond.notify_all()
                report["added"] += 1
        elif n < len(active):
            doomed = active[n:]
            sizes = [lane.pool.bytes_total for lane in doomed]
            # every doomed lane stops admitting at once, so the first
            # one's evacuees land on survivors, not on the next to go
            with self.cond:
                for lane in doomed:
                    lane.retiring = True
                self.cond.notify_all()
            for lane, size in zip(doomed, sizes):
                report["freed_bytes"] += self._retire_lane(
                    lane, timeout=drain_timeout, pending=size)
                report["retired"] += 1
        return report

    def _retire_lane(self, lane, timeout=30.0, pending=None):
        """Evacuate-then-retire one lane; returns the pool bytes
        released (``pending``, its pool's bytes before it started
        retiring, by default read now). A lane that cannot evacuate
        within ``timeout`` stays retiring (no new work) with its pool
        intact — closing storage under an in-flight copy would corrupt
        live requests — and finalizes ITSELF the moment it empties."""
        if pending is None:
            pending = lane.pool.bytes_total
        with self.cond:
            lane.retiring = True
            self.cond.notify_all()
        lane.join(timeout)
        if lane._thread is not None and lane._thread.is_alive():
            return 0   # still draining: the lane self-finalizes
        # the lane thread usually finalized itself on its way out; this
        # is the idempotent backstop (and the whole release for lanes
        # retired before ever starting)
        self._finalize_retired_lane(lane)
        return pending

    def _finalize_retired_lane(self, lane):
        """Close the retired lane's pool and drop it from the lane list,
        exactly once, whichever of the initiator's join and the lane
        thread's own exit gets here first."""
        with self.cond:
            if lane.finalized:
                return 0
            lane.finalized = True
        freed = lane.pool.bytes_total
        lane.pool.close()
        with self.cond:
            if lane in self.lanes:
                self.lanes.remove(lane)
        _return_stream(lane.pool.device, lane.stream)
        met = _met()
        ln = str(lane.idx)
        for state in ("used", "free", "reserved"):
            met["cache_blocks"].labels(
                model=self.name, lane=ln, state=state).set(0)
        met["inflight"].labels(model=self.name, lane=ln).set(0)
        return freed

    def close(self):
        with self.cond:
            self.closed = True
            self.cond.notify_all()
            lanes = list(self.lanes)
        for lane in lanes:
            lane.join(timeout=30.0)
        for lane in lanes:
            lane.pool.close()
            _return_stream(lane.pool.device, lane.stream)

    def stats(self):
        with self.cond:
            lanes = list(self.lanes)
            waiting = sum(len(ln.waiting) for ln in lanes)
            running = sum(len(ln.running) for ln in lanes)
        return {
            "waiting": waiting,
            "running": running,
            "max_decode_batch": self.max_decode_batch,
            "max_new_tokens": self.max_new_tokens,
            "max_queue": self.max_queue,
            "prompt_buckets": list(self.prompt_buckets),
            "decode_buckets": list(self.decode_buckets),
            "table_width": self.table_width,
            "executables": self.executables,
            "warmup_seconds": round(self.warmup_seconds, 3),
            "degraded": self.degraded,
            # >= 2: every lane is a tp mesh slice
            "tp": self.tp,
            "recovery": dict(
                self.migrator.stats(),
                max_recoveries=self.max_recoveries,
                lane_lost_rejections=self.lane_lost_rejections),
            "lanes": [ln.stats() for ln in lanes],
        }


def _ceil_mul(n, m):
    return ((int(n) + m - 1) // m) * m
