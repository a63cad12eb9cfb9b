"""The serving front (the port of ``mxnet_tpu/serving/gateway.py``):
one-shot models (``register`` / ``submit`` / ``infer``) and generative
decode (``register_generator`` / ``generate``) on one device.

A one-shot model gets a :class:`~.batcher.ModelQueue` fed by client
threads through :meth:`Gateway.submit` under admission control, and one
:class:`Replica` lane: a :class:`~.variants.VariantSet` with one
executable per (variant, bucket), warmed at registration, and a thread
that takes coalesced batches, pads them to a bucket, runs them under
``torch.inference_mode()`` on the gateway's device and replies with
host numpy arrays. Admission is fast-reject: a request that would pass
the queue-depth limit or the model's latency budget (``slo_ms``,
estimated from EWMA service rates) raises :class:`RejectedError` in the
caller's thread without entering the queue.

Several replicas, health probes and revival, ``scale`` and the
autoscaler, tensor-parallel slices, the cluster ledger, telemetry and
tracing wait for a later slice: ``register`` raises on ``replicas > 1``
and ``tp >= 2``.

Quickstart::

    gw = Gateway()                       # cuda:0; Gateway(device="cpu")
    gw.register_checkpoint("r50", "r50", 0, {"data": (3, 224, 224)},
                           variants=("fp32", "bf16", "int8"),
                           calib_data=calib, buckets=(1, 2, 4, 8, 16, 32))
    logits, = gw.infer("r50", images, variant="bf16")
    dec = GenerativeDecoder(vocab_size=32000, d_model=512, num_layers=8,
                            num_heads=8, max_prompt_tokens=512)
    gw.register_generator("lm", dec, block_tokens=16, max_blocks=4096,
                          max_new_tokens=256, max_decode_batch=32)
    tokens = gw.generate("lm", prompt_ids, max_new_tokens=128)
    gw.close()
"""
from __future__ import annotations

import logging
import threading

import numpy as np
import torch

from ..base import get_env
from ..context import resolve_device
from .batcher import (ModelQueue, RejectedError, Request, ServingError,
                      now_ns, pad_batch)
from .variants import VariantSet, default_buckets, pick_bucket

logger = logging.getLogger(__name__)

# EWMA weight of the service-rate estimates (recent batches dominate, so
# admission follows the current load within ~10 batches)
_EWMA = 0.2


class Replica:
    """The serving lane of a one-shot model: its VariantSet and the
    thread that takes coalesced batches for it."""

    def __init__(self, model, idx, device, variant_set):
        self._model = model
        self.idx = idx
        self.device = device
        self.variant_set = variant_set
        self.healthy = True
        self.last_error = None
        self._thread = None

    def start(self, warmup_buckets=()):
        """Start the lane thread; it first runs every (variant, bucket)
        of ``warmup_buckets`` once, and the call returns when that is
        done (re-raising its failure). The warmup runs on the lane's own
        thread because cuBLAS and cuDNN keep their handles and
        workspaces per thread: warmed on another thread, the first
        batches would pay for them."""
        ready = threading.Event()
        warm = {}
        self._thread = threading.Thread(
            target=self._loop, args=(warmup_buckets, ready, warm),
            daemon=True, name=f"mxtpu-serve-{self._model.name}-r{self.idx}")
        self._thread.start()
        ready.wait()
        if "error" in warm:
            self.join()
            raise warm["error"]
        return warm["executables"]

    def join(self, timeout=None):
        if self._thread is not None:
            self._thread.join(timeout)

    def _loop(self, warmup_buckets, ready, warm):
        m = self._model
        # torch state is per thread: inference mode is entered here, and
        # the device is the VariantSet's own, never a thread's default
        with torch.inference_mode():
            try:
                warm["executables"] = self.variant_set.warmup(
                    warmup_buckets)
            except BaseException as e:  # noqa: BLE001 — re-raised by start
                warm["error"] = e
                return
            finally:
                ready.set()
            while self.healthy and not m.queue.closed:
                item = m.queue.take_batch()
                if item is None:        # closed empty
                    break
                variant, batch = item
                try:
                    self._run_batch(variant, batch)
                except Exception as e:  # noqa: BLE001 — any failure
                    self._fail(batch, e)  # drains the lane

    def _run_batch(self, variant, batch):
        m = self._model
        rows = sum(r.rows for r in batch)
        bucket = pick_bucket(m.buckets, rows)
        padded, _ = pad_batch(batch, bucket, self.variant_set.feature_shape,
                              self.variant_set.input_dtype)
        t0 = now_ns()
        outs = self.variant_set.run(variant, padded)
        t1 = now_ns()
        m._count_batch(variant, rows, bucket)
        off = 0
        for r in batch:
            r.exec_end_ns = t1
            r._set_result([o[off:off + r.rows] for o in outs])
            off += r.rows
        m._observe_rate(rows, (t1 - t0) / 1e9)

    def _fail(self, batch, err):
        """One failed execution drains the lane; with no other lane its
        batch and everything queued fail with a clean error."""
        m = self._model
        self.healthy = False
        self.last_error = err
        logger.error("serving: lane %d of %r drained after: %r", self.idx,
                     m.name, err)
        for r in batch + m.queue.drain():
            r._set_error(ServingError(
                f"serving: no healthy replica left for {m.name!r} (last "
                f"error: {err!r})"))


class Model:
    """One registered one-shot model: configuration, queue, lane and
    service-rate estimates (the admission controller's inputs)."""

    def __init__(self, name, buckets, max_wait_s, max_queue, slo_s,
                 variants):
        self.name = name
        self.buckets = buckets
        self.max_queue = max_queue
        self.slo_s = slo_s
        self.variants = variants
        self.queue = ModelQueue(max_rows=buckets[-1], max_wait_s=max_wait_s)
        self.replicas = []
        self._rate_lock = threading.Lock()
        self._exec_s = None       # EWMA seconds per executed batch
        self._rows_per_s = None   # EWMA serviced rows per second
        self.warmup_seconds = 0.0
        self.executables = 0
        self.counts = {"requests": {}, "batches": {}, "rejected": {},
                       "rows": 0, "padding_rows": 0}

    def _count(self, key, label, n=1):
        with self._rate_lock:
            d = self.counts[key]
            d[label] = d.get(label, 0) + n

    def _count_batch(self, variant, rows, bucket):
        self._count("batches", variant)
        with self._rate_lock:
            self.counts["rows"] += rows
            self.counts["padding_rows"] += bucket - rows

    def _observe_rate(self, rows, exec_s):
        if exec_s <= 0:
            return
        with self._rate_lock:
            self._exec_s = exec_s if self._exec_s is None else \
                (1 - _EWMA) * self._exec_s + _EWMA * exec_s
            rate = rows / exec_s
            self._rows_per_s = rate if self._rows_per_s is None else \
                (1 - _EWMA) * self._rows_per_s + _EWMA * rate

    def estimate_latency_s(self, rows):
        """Predicted end-to-end latency of a new request: the queued rows
        drained at the observed rate, plus one execution. None before
        the first batch (no data: admit)."""
        with self._rate_lock:
            exec_s, rate = self._exec_s, self._rows_per_s
        if exec_s is None or not rate:
            return None
        healthy = sum(1 for r in self.replicas if r.healthy)
        if not healthy:
            return None
        return (self.queue.pending_rows() + rows) / (rate * healthy) \
            + exec_s


def _check_one_replica(replicas):
    """Resolve ``replicas`` (None reads ``MXTPU_SERVING_REPLICAS``, as
    the JAX package does) and refuse more than one: each model or
    generator is served by one lane until replicas are ported."""
    if replicas is None:
        replicas = int(get_env("MXTPU_SERVING_REPLICAS", 1, int))
    if replicas < 1:
        raise ServingError(
            f"serving: replicas must be >= 1, got {replicas}")
    if replicas > 1:
        raise ServingError(
            "serving: several replicas per model are not ported yet "
            "(one lane per model)")


class Gateway:
    """Serves registered models and generators on one device: ``cuda:0``
    unless ``device`` says otherwise; without CUDA it raises unless
    ``device`` is ``"cpu"``. See the module docstring."""

    def __init__(self, device=None):
        self.device = resolve_device(device)
        # greedy decode is held token for token against fp32 references:
        # cuBLAS float32 products stay full float32, never TF32
        torch.backends.cuda.matmul.allow_tf32 = False
        self._generators = {}          # name -> generate.GenModel
        self._models = {}              # name -> Model (None while built)
        self._gen_lock = threading.Lock()
        self._closed = False

    # -- one-shot models -----------------------------------------------------
    def register(self, name, symbol, arg_params, aux_params,
                 input_shapes, variants=("fp32",), calib_data=None,
                 calib_mode="naive", excluded_sym_names=None,
                 buckets=None, max_batch=None, max_wait_ms=None,
                 max_queue=None, slo_ms=None, replicas=None,
                 input_dtype="float32", int8_lowering="auto",
                 warmup=True, tp=None):
        """Register a model and build (and, with ``warmup``, run once)
        its executables on the gateway's device.

        ``input_shapes`` is ``{input_name: feature_shape}`` for the ONE
        data input, without the batch dim (requests are coalesced along
        it). ``max_batch`` defaults to the largest of ``buckets`` (or
        32). ``slo_ms`` of 0/None turns latency-budget rejection off;
        ``max_wait_ms`` / ``max_queue`` / ``replicas`` default from
        ``MXTPU_SERVING_MAX_WAIT_MS`` / ``MXTPU_SERVING_MAX_QUEUE`` /
        ``MXTPU_SERVING_REPLICAS``. One lane per model: ``replicas > 1``
        (given or read from the knob) and ``tp >= 2`` raise.
        """
        if self._closed:
            raise ServingError("serving: gateway is closed")
        if tp is not None and int(tp) >= 2:
            raise ServingError(
                "serving: tensor-parallel slices (tp >= 2) are not ported "
                "yet; serve on one device")
        _check_one_replica(replicas)
        if len(input_shapes) != 1:
            raise ServingError(
                "serving: exactly one data input per model (got "
                f"{sorted(input_shapes)}); bake constants into params")
        (input_name, feature_shape), = input_shapes.items()
        if buckets is None:
            buckets = default_buckets(max_batch or 32)
        else:
            buckets = tuple(sorted(set(int(b) for b in buckets)))
            if max_batch is not None and buckets[-1] != int(max_batch):
                raise ServingError(
                    f"serving: max_batch {max_batch} != largest bucket "
                    f"{buckets[-1]}")
        if max_wait_ms is None:
            max_wait_ms = get_env("MXTPU_SERVING_MAX_WAIT_MS", 5.0, float)
        if max_queue is None:
            max_queue = get_env("MXTPU_SERVING_MAX_QUEUE", 256, int)
        if slo_ms is None:
            slo_ms = get_env("MXTPU_SERVING_SLO_MS", 0.0, float)
        self._claim(name)
        try:
            model = Model(name, buckets, max_wait_s=max_wait_ms / 1e3,
                          max_queue=max_queue,
                          slo_s=(slo_ms / 1e3) if slo_ms else None,
                          variants=tuple(variants))
            t0 = now_ns()
            vs = VariantSet(symbol, arg_params, aux_params, input_name,
                            feature_shape, variants=variants,
                            device=self.device, calib_data=calib_data,
                            calib_mode=calib_mode,
                            excluded_sym_names=excluded_sym_names,
                            input_dtype=input_dtype,
                            int8_lowering=int8_lowering)
            rep = Replica(model, 0, self.device, vs)
            model.replicas.append(rep)
            model.executables = rep.start(buckets if warmup else ())
            model.warmup_seconds = (now_ns() - t0) / 1e9
        except BaseException:
            with self._gen_lock:
                del self._models[name]
            raise
        with self._gen_lock:
            self._models[name] = model
        logger.info(
            "serving: registered %r on %s — %d variant(s) x %d bucket(s), "
            "warmup %.1fs", name, self.device, len(model.variants),
            len(buckets), model.warmup_seconds)
        return model

    def register_checkpoint(self, name, prefix, epoch, input_shapes,
                            **kwargs):
        """Register from ``prefix-symbol.json`` + ``prefix-####.params``
        (the Predictor's file contract), loaded onto the gateway's
        device."""
        from ..context import Context
        from ..model import load_checkpoint
        symbol, arg_params, aux_params = load_checkpoint(
            prefix, epoch, ctx=Context(self.device))
        return self.register(name, symbol, arg_params, aux_params,
                             input_shapes, **kwargs)

    def _claim(self, name):
        """Reserve ``name`` before paying for compilation and warmup."""
        with self._gen_lock:
            if name in self._models or name in self._generators:
                raise ServingError(
                    f"serving: model {name!r} already registered")
            self._models[name] = None

    def _get_model(self, name):
        with self._gen_lock:
            m = self._models.get(name)
            known = sorted(n for n, v in self._models.items() if v)
        if m is None:
            raise ServingError(
                f"serving: unknown model {name!r} (registered: {known})")
        return m

    def submit(self, model, data, variant="fp32"):
        """Admit and enqueue one request; returns the
        :class:`~.batcher.Request` future. Raises :class:`RejectedError`
        (fast, in the caller's thread) when admission sheds it."""
        m = self._get_model(model)
        if variant not in m.variants:
            raise ServingError(
                f"serving: model {model!r} has no {variant!r} variant "
                f"(registered: {m.variants})")
        vs = m.replicas[0].variant_set
        arr = np.asarray(data)
        if arr.ndim == len(vs.feature_shape):    # one sample
            arr = arr[None]
        if tuple(arr.shape[1:]) != vs.feature_shape:
            raise ServingError(
                f"serving: input shape {tuple(arr.shape)} does not match "
                f"(rows,) + {vs.feature_shape}")
        if arr.shape[0] < 1 or arr.shape[0] > m.buckets[-1]:
            raise ServingError(
                f"serving: request rows {arr.shape[0]} outside "
                f"[1, {m.buckets[-1]}] (split large batches client-side)")
        arr = arr.astype(vs.input_dtype, copy=False)
        reason = self._admit(m, arr.shape[0])
        if reason is not None:
            m._count("rejected", reason)
            raise RejectedError(reason, self._reject_msg(m, reason))
        req = Request(model, variant, arr)
        try:
            m.queue.put(req)
        except RejectedError:
            m._count("rejected", "closed")
            raise
        m._count("requests", variant)
        if not any(r.healthy for r in m.replicas):
            # the lane died between admission and enqueue: its drain has
            # run, so nothing would ever serve this request
            for r in m.queue.drain():
                r._set_error(ServingError(
                    f"serving: no healthy replica left for {model!r}"))
        return req

    def _admit(self, m, rows):
        """None to admit, else the rejection reason: bookkeeping only,
        no device work, so overload is shed in microseconds."""
        if self._closed or m.queue.closed:
            return "closed"
        if not any(r.healthy for r in m.replicas):
            return "no_replica"
        if m.queue.depth() >= m.max_queue:
            return "queue_full"
        if m.slo_s:
            est = m.estimate_latency_s(rows)
            if est is not None and est > m.slo_s:
                return "slo"
        return None

    def _reject_msg(self, m, reason):
        if reason == "queue_full":
            return (f"serving: {m.name!r} queue at depth limit "
                    f"{m.max_queue} — shed (retry with backoff)")
        if reason == "slo":
            return (f"serving: {m.name!r} backlog would exceed the "
                    f"{m.slo_s * 1e3:.0f}ms latency budget — shed")
        if reason == "no_replica":
            return f"serving: {m.name!r} has no healthy replica"
        return f"serving: {m.name!r} is shutting down"

    def infer(self, model, data, variant="fp32", timeout=30.0):
        """Blocking request: numpy in, a list of numpy out."""
        return self.submit(model, data, variant=variant).result(timeout)

    def _shutdown_model(self, model):
        model.queue.close()
        for rep in model.replicas:
            rep.join(timeout=30.0)
        for req in model.queue.drain():
            req._set_error(ServingError(
                f"serving: model {model.name!r} shut down before the "
                "request executed"))

    def register_generator(self, name, decoder, block_tokens=None,
                           max_blocks=None, max_new_tokens=None,
                           max_decode_batch=8, max_queue=None,
                           replicas=None, warmup=True):
        """Register a decoder LM for token-granular generation.

        ``decoder`` is a :class:`~.generate.GenerativeDecoder` on this
        gateway's device. The lane gets a paged KV block pool of
        ``max_blocks`` x ``block_tokens``-token blocks and, with
        ``warmup``, runs every prefill and decode bucket once.
        ``max_new_tokens`` is the per-request generation cap (and the
        default for requests that don't pass one); the knob defaults
        come from ``MXTPU_GEN_BLOCK_TOKENS`` / ``MXTPU_GEN_MAX_BLOCKS``
        / ``MXTPU_GEN_MAX_NEW_TOKENS`` / ``MXTPU_SERVING_MAX_QUEUE``.
        One lane per generator: ``replicas > 1`` (given or read from
        ``MXTPU_SERVING_REPLICAS``) raises.
        """
        from .generate.scheduler import GenModel

        if self._closed:
            raise ServingError("serving: gateway is closed")
        _check_one_replica(replicas)
        if decoder.device != self.device:
            raise ServingError(
                f"serving: decoder on {decoder.device}, gateway on "
                f"{self.device}")
        if block_tokens is None:
            block_tokens = get_env("MXTPU_GEN_BLOCK_TOKENS", 16, int)
        if max_blocks is None:
            max_blocks = get_env("MXTPU_GEN_MAX_BLOCKS", 256, int)
        if max_new_tokens is None:
            max_new_tokens = get_env("MXTPU_GEN_MAX_NEW_TOKENS", 64, int)
        if max_queue is None:
            max_queue = get_env("MXTPU_SERVING_MAX_QUEUE", 256, int)
        with self._gen_lock:
            if name in self._generators or name in self._models:
                raise ServingError(
                    f"serving: generator {name!r} already registered")
            # claim the name before paying for the pool and warmup
            self._generators[name] = None
        try:
            gen = GenModel(name, decoder, block_tokens=block_tokens,
                           max_blocks=max_blocks,
                           max_new_tokens=max_new_tokens,
                           max_decode_batch=max_decode_batch,
                           max_queue=max_queue, warmup=warmup)
        except BaseException:
            with self._gen_lock:
                del self._generators[name]
            raise
        with self._gen_lock:
            self._generators[name] = gen
        logger.info(
            "serving: registered generator %r on %s — %d-token blocks x "
            "%d, warmup %.1fs", name, self.device, block_tokens, max_blocks,
            gen.warmup_seconds)
        return gen

    def unregister(self, name):
        """Stop a model or generator; its pending requests fail."""
        with self._gen_lock:
            gen = self._generators.pop(name, None)
            model = self._models.pop(name, None)
        if gen is not None:
            gen.close()
        if model is not None:
            self._shutdown_model(model)

    def _get_generator(self, name):
        with self._gen_lock:
            gen = self._generators.get(name)
            known = sorted(n for n, g in self._generators.items() if g)
        if gen is None:
            raise ServingError(
                f"serving: unknown generator {name!r} (registered: "
                f"{known})")
        return gen

    def submit_generate(self, model, prompt, max_new_tokens=None):
        """Admit one generation request; returns the streaming
        :class:`~.generate.GenRequest` future. Fast-rejects with
        :class:`RejectedError` (reason ``kv_cache_full`` when the
        block pool cannot cover the request's token budget)."""
        from .generate.scheduler import GenRequest

        gen = self._get_generator(model)
        if max_new_tokens is None:
            max_new_tokens = gen.max_new_tokens
        prompt = np.asarray(prompt, np.int32).ravel()
        if len(prompt) < 1 or len(prompt) > gen.decoder.max_prompt_tokens:
            raise ServingError(
                f"serving: prompt of {len(prompt)} tokens outside "
                f"[1, {gen.decoder.max_prompt_tokens}] for {model!r}")
        if max_new_tokens < 1 or max_new_tokens > gen.max_new_tokens:
            raise ServingError(
                f"serving: max_new_tokens {max_new_tokens} outside "
                f"[1, {gen.max_new_tokens}] for {model!r}")
        req = GenRequest(model, prompt, max_new_tokens)
        reason = "closed" if self._closed else gen.try_admit(req)
        if reason is not None:
            raise RejectedError(reason, self._gen_reject_msg(
                gen, reason, len(prompt), max_new_tokens))
        return req

    def _gen_reject_msg(self, gen, reason, plen, max_new):
        if reason == "kv_cache_full":
            need = gen.lane.pool.blocks_for(plen + max_new)
            return (f"serving: {gen.name!r} KV block pool cannot cover "
                    f"{plen}+{max_new} tokens ({need} blocks) — shed "
                    "(retry with backoff, or lower max_new_tokens)")
        if reason == "queue_full":
            return (f"serving: {gen.name!r} generation queue at depth "
                    f"limit {gen.max_queue} — shed")
        return f"serving: {gen.name!r} is shutting down"

    def generate(self, model, prompt, max_new_tokens=None,
                 stream=False, timeout=120.0):
        """Greedy generation: token-id prompt in, generated token ids
        out. ``stream=True`` returns the request itself — iterate
        ``req.stream()`` for tokens as they decode."""
        req = self.submit_generate(model, prompt,
                                   max_new_tokens=max_new_tokens)
        if stream:
            return req
        return req.result(timeout)

    def stats(self):
        """Bounded per-model snapshot: queue, buckets, service-rate
        estimates, lane state, executables and request / batch / reject
        counts; generators report their queue, batch, pool and steps."""
        with self._gen_lock:
            models = [m for m in self._models.values() if m is not None]
            gens = [g for g in self._generators.values() if g is not None]
        out = {}
        for m in models:
            with m._rate_lock:
                exec_s, rate = m._exec_s, m._rows_per_s
                counts = {k: (dict(v) if isinstance(v, dict) else v)
                          for k, v in m.counts.items()}
            out[m.name] = {
                "queue_depth": m.queue.depth(),
                "pending_rows": m.queue.pending_rows(),
                "buckets": list(m.buckets),
                "variants": list(m.variants),
                "max_queue": m.max_queue,
                "slo_ms": m.slo_s * 1e3 if m.slo_s else None,
                "max_wait_ms": m.queue.max_wait_s * 1e3,
                "replicas": [{"idx": r.idx, "device": str(r.device),
                              "healthy": r.healthy} for r in m.replicas],
                "int8_lowering": m.replicas[0].variant_set.int8_lowering,
                "ewma_exec_s": exec_s,
                "ewma_rows_per_s": rate,
                "executables": m.executables,
                "warmup_seconds": round(m.warmup_seconds, 3),
                **counts,
            }
        out.update({g.name: {"generator": True, **g.stats()} for g in gens})
        return out

    def close(self):
        """Drain and stop everything; pending requests fail cleanly."""
        if self._closed:
            return
        self._closed = True
        with self._gen_lock:
            names = sorted(n for n, g in list(self._generators.items())
                           + list(self._models.items()) if g)
        for name in names:
            self.unregister(name)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
