"""The serving front (the port of ``mxnet_tpu/serving/gateway.py``):
one-shot models (``register`` / ``submit`` / ``infer``) and generative
decode (``register_generator`` / ``generate``) over one or more devices.

A one-shot model gets a :class:`~.batcher.ModelQueue` fed by client
threads through :meth:`Gateway.submit` under admission control, and N
:class:`Replica` lanes: each a :class:`~.variants.VariantSet` with one
executable per (variant, bucket), warmed at registration, and a thread
that takes coalesced batches, pads them to a bucket, runs them under
``torch.inference_mode()`` on the replica's device and replies with host
numpy arrays. Admission is fast-reject: a request that would pass the
queue-depth limit or the model's latency budget (``slo_ms``, estimated
from EWMA service rates) raises :class:`RejectedError` in the caller's
thread without entering the queue.

Replicas are placed over the gateway's devices and wrap onto shared
devices when there are fewer devices than replicas (``degraded``, warned
once): on one card every lane shares it. A replica whose execution
fails drains itself and its batch redistributes to the healthy ones (a
request that failed on every replica fails instead); ``check_health``
probes every replica off the queue and revives the drained ones whose
probe passes, as a fresh lane thread. ``scale`` resizes a model or a
generator: a generator lane scaled in evacuates its in-flight
generations to the surviving lanes (``generate/scheduler.py``) and
releases its KV pool.

A generator registered with ``tp >= 2`` (or ``MXTPU_SERVING_TP``) serves
on tensor-parallel mesh slices: each lane holds ``tp`` devices, carved by
:func:`~mxnet_tpu_torch.parallel.mesh.replica_slices` from devices no
other slice holds, its pool sharded over the heads and its weights by the
layout table (``generate/model.py`` ``DecodeSteps``). Replicated
lanes keep off slice-held devices while others exist; any overlap, and a
slice that holds one device twice (``Gateway(devices=["cuda:0",
"cuda:0"])``: both shards on one card), is ``degraded``. A one-shot
model registered with ``tp >= 2`` serves on slices the same way, each
lane a :class:`~.sharded.ShardedVariantSet` (parameters sharded at rest
by the layout table, gathered on use, outputs replicated).

Every request carries a trace context (the caller's enclosing span, else
a fresh one under ``MXTPU_TRACE_SAMPLE``): at reply the gateway records
the ``serving.request`` -> ``serving.queue`` / ``serving.batch`` /
``serving.execute`` / ``serving.reply`` spans, and a generation's lane
records ``serving.generate`` with its ``generate.prefill``,
``generate.recover`` and ``generate.token`` spans
(``generate/scheduler.py``). The ``mx_serving_*`` telemetry families
count requests, rejections, batches, padding, replica health and
per-stage latency; ``profiling.tailpath`` joins the span trees into
per-request blame bins. The autoscaler, the cluster ledger and the
elastic plane's spans wait for a later slice (ROADMAP queue 1 item 6c).

Quickstart::

    gw = Gateway()          # [cuda:0]; Gateway(device="cpu"), or
                            # Gateway(devices=["cuda:0", "cuda:1"])
    gw.register_checkpoint("r50", "r50", 0, {"data": (3, 224, 224)},
                           variants=("fp32", "bf16", "int8"),
                           calib_data=calib, buckets=(1, 2, 4, 8, 16, 32))
    logits, = gw.infer("r50", images, variant="bf16")
    dec = GenerativeDecoder(vocab_size=32000, d_model=512, num_layers=8,
                            num_heads=8, max_prompt_tokens=512)
    gw.register_generator("lm", dec, block_tokens=16, max_blocks=4096,
                          max_new_tokens=256, max_decode_batch=32,
                          replicas=2)
    tokens = gw.generate("lm", prompt_ids, max_new_tokens=128)
    gw.close()
"""
from __future__ import annotations

import logging
import threading

import numpy as np
import torch

from .. import tracing
from ..base import get_env
from ..context import Context, resolve_device
from ..telemetry import metrics as _tm
from ..parallel.mesh import (replica_devices, replica_slices,
                             should_warn_degraded)
from .batcher import (ModelQueue, RejectedError, Request, ServingError,
                      now_ns, pad_batch)
from .sharded import SHARDED_VARIANTS, ShardedVariantSet
from .variants import VariantSet, default_buckets, pick_bucket

logger = logging.getLogger(__name__)

# EWMA weight of the service-rate estimates (recent batches dominate, so
# admission follows the current load within ~10 batches)
_EWMA = 0.2

_met = _tm.lazy_metrics(lambda reg: {
    "requests": reg.counter(
        "mx_serving_requests_total",
        "admitted inference requests", labelnames=("model", "variant")),
    "rejected": reg.counter(
        "mx_serving_rejected_total",
        "fast-rejected requests at admission",
        labelnames=("model", "reason")),
    "batches": reg.counter(
        "mx_serving_batches_total",
        "executed batches", labelnames=("model", "variant")),
    "pad_rows": reg.counter(
        "mx_serving_padding_rows_total",
        "zero rows added to fill shape buckets", labelnames=("model",)),
    "depth": reg.gauge(
        "mx_serving_queue_depth",
        "requests pending in the model queue", labelnames=("model",)),
    "healthy": reg.gauge(
        "mx_serving_replica_healthy",
        "1 = replica serving, 0 = drained",
        labelnames=("model", "replica")),
    "failures": reg.counter(
        "mx_serving_replica_failures_total",
        "replica executions that failed and drained the replica",
        labelnames=("model",)),
    "batch_rows": reg.histogram(
        "mx_serving_batch_rows",
        "coalesced rows per executed batch", labelnames=("model",),
        buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256)),
    "latency": reg.histogram(
        "mx_serving_latency_seconds",
        "per-stage + end-to-end request latency",
        labelnames=("model", "stage")),
})


class Replica:
    """One serving lane of a one-shot model: its VariantSet and the
    thread that takes coalesced batches for it. ``_gen`` is the lane's
    generation, bumped by every :meth:`start`: a thread serves only its
    own generation, so a revive can always start a fresh thread without
    racing a parked old one (which leaves at its next wakeup, handing
    back a batch it took)."""

    def __init__(self, model, idx, device, variant_set):
        self._model = model
        self.idx = idx
        self.device = device
        self.variant_set = variant_set
        self.healthy = True
        self.last_error = None
        self.batches = 0
        self.rows = 0
        self.failures = 0
        self._thread = None
        self._gen = 0

    def start(self, warmup_buckets=()):
        """Start a fresh lane thread; it first runs every (variant,
        bucket) of ``warmup_buckets`` once, and the call returns when
        that is done (re-raising its failure). The warmup runs on the
        lane's own thread because cuBLAS and cuDNN keep their handles and
        workspaces per thread: warmed on another thread, the first
        batches would pay for them."""
        self._gen += 1
        ready = threading.Event()
        warm = {}
        self._thread = threading.Thread(
            target=self._loop, args=(self._gen, warmup_buckets, ready, warm),
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

    def probe(self):
        """Health check: a smallest-bucket zeros batch through every
        variant, off the queue, on the caller's thread. Healthy = all
        succeed."""
        vs = self.variant_set
        b = self._model.buckets[0]
        try:
            with torch.inference_mode():
                for variant in vs.variants:
                    vs.run(variant, np.zeros((b,) + vs.feature_shape,
                                             vs.input_dtype))
        except Exception as e:  # noqa: BLE001 — any failure = unhealthy
            self.last_error = e
            return False
        return True

    def _loop(self, gen, warmup_buckets, ready, warm):
        m = self._model

        def stale():
            return not self.healthy or self._gen != gen

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
            while not stale() and not m.queue.closed:
                item = m.queue.take_batch(stop=stale)
                if item is None:        # closed empty, or stale
                    break
                variant, batch = item
                if stale():
                    self._hand_back(batch)
                    break
                try:
                    self._run_batch(variant, batch)
                except Exception as e:  # noqa: BLE001 — one bad execution
                    self._fail(batch, e)  # drains THIS replica
        _met()["depth"].labels(model=m.name).set(m.queue.depth())

    def _hand_back(self, batch):
        """Drained by a probe (or superseded by a revived generation)
        while blocked in take_batch: requeue instead of serving on a
        stale or bad lane — any live lane takes it, this replica's own
        fresh generation included. Fail directly only when nothing will
        ever serve it."""
        m = self._model
        err = self.last_error or ServingError("replica drained")
        if m.queue.closed:
            for r in batch:
                r._set_error(ServingError(
                    f"serving: model {m.name!r} shut down before the "
                    "request executed"))
            return
        m.queue.requeue(batch)
        if not any(r.healthy for r in m.replicas):
            for r in m.queue.drain():
                r._set_error(ServingError(
                    f"serving: no healthy replica left for {m.name!r} "
                    f"(last error: {err!r})"))

    def _run_batch(self, variant, batch):
        m = self._model
        met = _met()
        t_deq = now_ns()
        rows = sum(r.rows for r in batch)
        bucket = pick_bucket(m.buckets, rows)
        for r in batch:
            r.dequeue_ns = t_deq
            r.attempts += 1
        padded, _ = pad_batch(batch, bucket, self.variant_set.feature_shape,
                              self.variant_set.input_dtype)
        t0 = now_ns()
        outs = self.variant_set.run(variant, padded)
        t1 = now_ns()
        m._count_batch(variant, rows, bucket)
        met["depth"].labels(model=m.name).set(m.queue.depth())
        met["batches"].labels(model=m.name, variant=variant).inc()
        met["batch_rows"].labels(model=m.name).observe(rows)
        met["pad_rows"].labels(model=m.name).inc(bucket - rows)
        self.batches += 1
        self.rows += rows
        off = 0
        for r in batch:
            r.exec_start_ns, r.exec_end_ns = t0, t1
            r._set_result([o[off:off + r.rows] for o in outs])
            off += r.rows
            m._reply(r, bucket=bucket, batch_size=len(batch),
                     replica=self.idx, rows=rows)
        m._observe_rate(rows, (t1 - t0) / 1e9)

    def _fail(self, batch, err):
        """One failed execution drains THIS replica; its batch
        redistributes to the healthy ones."""
        m = self._model
        self.healthy = False
        self.last_error = err
        self.failures += 1
        with m._rate_lock:
            m.counts["failures"] += 1
        met = _met()
        met["failures"].labels(model=m.name).inc()
        met["healthy"].labels(model=m.name, replica=str(self.idx)).set(0)
        logger.error("serving: replica %d of %r drained after: %r — "
                     "redistributing %d request(s)", self.idx, m.name, err,
                     len(batch))
        self._redistribute(batch, err)

    def _redistribute(self, batch, err):
        m = self._model
        survivors = [r for r in m.replicas if r.healthy and r is not self]
        # a request that has failed on every replica is the poison pill,
        # not the victim — fail it instead of cycling forever
        retry = [r for r in batch if r.attempts <= len(m.replicas)]
        poison = [r for r in batch if r.attempts > len(m.replicas)]
        for r in poison:
            r._set_error(ServingError(
                f"serving: request failed on every replica of "
                f"{m.name!r}: {err!r}"))
        if survivors and retry:
            m.queue.requeue(retry)
        else:
            for r in retry:
                r._set_error(ServingError(
                    f"serving: no healthy replica left for {m.name!r} "
                    f"(last error: {err!r})"))
        # the last live lane — or the survivors died in the same window
        # (two replicas failing together each see the other alive):
        # drain-fail everything queued rather than strand it in a queue
        # no lane serves
        if not any(r.healthy for r in m.replicas):
            for r in m.queue.drain():
                r._set_error(ServingError(
                    f"serving: no healthy replica left for {m.name!r} "
                    f"(last error: {err!r})"))

    def stats(self):
        device = [str(d) for d in self.device] \
            if isinstance(self.device, tuple) else str(self.device)
        return {"idx": self.idx, "device": device,
                "healthy": self.healthy, "batches": self.batches,
                "rows": self.rows, "failures": self.failures,
                "last_error": (repr(self.last_error)
                               if self.last_error is not None else None)}


class Model:
    """One registered one-shot model: configuration, queue, replicas and
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
        self.degraded = False     # replicas wrap onto shared devices
        self.tp = None            # the slice width of tp lanes
        # Gateway.scale's seams: the factory that builds one more replica
        # lane on a device, and a monotonic lane id (a retired idx is
        # never reissued)
        self._replica_factory = None
        self._next_idx = 0
        self.counts = {"requests": {}, "batches": {}, "rejected": {},
                       "rows": 0, "padding_rows": 0, "failures": 0}

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

    def _reply(self, req, bucket, batch_size, replica, rows=None):
        """Per-stage latencies of a replied request, and its span chain
        under its trace context."""
        t_reply = now_ns()
        lat = _met()["latency"]
        name = self.name
        lat.labels(model=name, stage="queue").observe(
            (req.dequeue_ns - req.submit_ns) / 1e9)
        lat.labels(model=name, stage="batch").observe(
            (req.exec_start_ns - req.dequeue_ns) / 1e9)
        lat.labels(model=name, stage="execute").observe(
            (req.exec_end_ns - req.exec_start_ns) / 1e9)
        lat.labels(model=name, stage="e2e").observe(
            (t_reply - req.submit_ns) / 1e9)
        trace_id, parent = req.trace_ctx
        if not trace_id:
            return
        root = tracing.record_span(
            "serving.request", trace_id, parent, req.submit_ns, t_reply,
            cat="serving",
            attrs={"model": name, "variant": req.variant,
                   "rows": req.rows, "attempts": req.attempts})
        tracing.record_span("serving.queue", trace_id, root,
                            req.submit_ns, req.dequeue_ns,
                            cat="serving",
                            attrs={"hold_ns": req.hold_ns,
                                   "requeue_ns": req.requeue_ns})
        tracing.record_span("serving.batch", trace_id, root,
                            req.dequeue_ns, req.exec_start_ns,
                            cat="serving",
                            attrs={"bucket": bucket,
                                   "requests": batch_size})
        tracing.record_span("serving.execute", trace_id, root,
                            req.exec_start_ns, req.exec_end_ns,
                            cat="serving",
                            attrs={"bucket": bucket, "replica": replica,
                                   "variant": req.variant,
                                   "rows": (rows if rows is not None
                                            else req.rows)})
        tracing.record_span("serving.reply", trace_id, root,
                            req.exec_end_ns, t_reply, cat="serving")

    def estimate_latency_s(self, rows):
        """Predicted end-to-end latency of a new request: the queued rows
        drained at the observed rate (scaled by the healthy replicas),
        plus one execution. None before the first batch (no data:
        admit)."""
        with self._rate_lock:
            exec_s, rate = self._exec_s, self._rows_per_s
        if exec_s is None or not rate:
            return None
        healthy = sum(1 for r in self.replicas if r.healthy)
        if not healthy:
            return None
        return (self.queue.pending_rows() + rows) / (rate * healthy) \
            + exec_s


def _resolve_tp(tp):
    """``tp`` (None reads ``MXTPU_SERVING_TP``, as the JAX package
    does): None for a plain lane (unset, 0 or 1), else the slice
    width."""
    if tp is None:
        tp = int(get_env("MXTPU_SERVING_TP", 0, int)) or None
    if tp is None:
        return None
    tp = int(tp)
    if tp < 1:
        raise ServingError(f"serving: tp must be >= 1, got {tp}")
    return tp if tp >= 2 else None


def _trace_ctx():
    """The trace context a request carries: the caller's enclosing span,
    else a fresh root (sampled by ``MXTPU_TRACE_SAMPLE``; ``(0, 0)``
    untraced)."""
    ctx = tracing.context()
    return ctx if ctx[0] else tracing.new_context()


def _slices_share(slices):
    """True when a device appears twice across ``slices`` (within one or
    between two)."""
    flat = [str(d) for s in slices for d in s]
    return len(set(flat)) < len(flat)


def _resolve_replicas(replicas):
    """``replicas`` (None reads ``MXTPU_SERVING_REPLICAS``)."""
    if replicas is None:
        replicas = int(get_env("MXTPU_SERVING_REPLICAS", 1, int))
    replicas = int(replicas)
    if replicas < 1:
        raise ServingError(
            f"serving: replicas must be >= 1, got {replicas}")
    return replicas


class Gateway:
    """Serves registered models and generators on ``devices``: ``[cuda:0]``
    unless ``devices`` (a list) or ``device`` (one device, the spelling
    of earlier slices) say otherwise; without CUDA it raises unless the
    CPU is asked for. Replicas and decode lanes are placed over the
    devices by :func:`~mxnet_tpu_torch.parallel.mesh.replica_devices`,
    wrapping onto shared devices (``degraded``) when there are fewer
    devices than lanes. ``MXTPU_SERVING_HEALTH_SEC`` > 0 starts a thread
    that runs :meth:`check_health` at that period. See the module
    docstring."""

    def __init__(self, devices=None, device=None):
        if isinstance(devices, (str, torch.device, Context)):
            devices = [devices]
        if devices is not None and device is not None:
            raise ServingError(
                "serving: pass devices= (a list) or device=, not both")
        if devices is None:
            devices = [device]
        self._devices = [resolve_device(d) for d in devices]
        if not self._devices:
            raise ServingError("serving: devices is empty")
        self.device = self._devices[0]
        # greedy decode is held token for token against fp32 references:
        # cuBLAS float32 products stay full float32, never TF32
        torch.backends.cuda.matmul.allow_tf32 = False
        self._generators = {}          # name -> generate.GenModel
        self._models = {}              # name -> Model (None while built)
        self._gen_lock = threading.Lock()
        self._closed = False
        self._health_thread = None
        self._health_stop = threading.Event()
        period = get_env("MXTPU_SERVING_HEALTH_SEC", 0.0, float)
        if period > 0:
            self._health_thread = threading.Thread(
                target=self._health_loop, args=(period,), daemon=True,
                name="mxtpu-torch-serve-health")
            self._health_thread.start()

    # -- placement -----------------------------------------------------------
    def _sliced_devices(self):
        """Devices held by tensor-parallel lanes' slices (generators' and
        one-shot models')."""
        with self._gen_lock:
            gens = [g for g in self._generators.values() if g is not None]
            models = [m for m in self._models.values() if m is not None]
        held = [ln.device for g in gens for ln in g.lanes]
        held += [r.device for m in models for r in m.replicas]
        return [d for dev in held if isinstance(dev, tuple) for d in dev]

    def _pick_slices(self, n, tp):
        """Slices for ``n`` new tensor-parallel lanes of ``tp`` devices,
        carved from devices no other slice holds: ``(slices,
        degraded)``. Degraded (warned once per ask) when slices share a
        device."""
        try:
            slices, degraded = replica_slices(
                n, tp, devices=self._devices,
                exclude=self._sliced_devices())
        except ValueError as e:
            raise ServingError(f"serving: tp={tp}: {e}") from e
        flat = [d for sl in slices for d in sl]
        if degraded and should_warn_degraded(n * tp, flat):
            logger.warning(
                "serving: %d slice(s) x tp=%d requested but the free "
                "devices cannot hold them disjointly; degrading (slices "
                "share devices)", n, tp)
        return slices, degraded

    def _pick_devices(self, n, busy=()):
        """Devices for ``n`` new lanes, away from tensor-parallel slices
        and from ``busy`` (the devices existing lanes hold) while others
        exist: ``(devices, degraded)``. The degraded wrap is warned once
        per (ask, devices)."""
        picked, degraded = replica_devices(
            n, devices=self._devices,
            exclude=list(self._sliced_devices()) + list(busy))
        if degraded and should_warn_degraded(n, picked):
            logger.warning(
                "serving: %d replicas requested but only %d device(s); "
                "degrading (replicas share devices)", n,
                len(set(map(str, picked))))
        return picked, degraded

    def device_count(self):
        """Distinct devices available to replica placement."""
        return len(self._devices)

    # -- one-shot models -----------------------------------------------------
    def register(self, name, symbol, arg_params, aux_params,
                 input_shapes, variants=("fp32",), calib_data=None,
                 calib_mode="naive", excluded_sym_names=None,
                 buckets=None, max_batch=None, max_wait_ms=None,
                 max_queue=None, slo_ms=None, replicas=None,
                 input_dtype="float32", int8_lowering="auto",
                 warmup=True, tp=None):
        """Register a model and build (and, with ``warmup``, run once)
        its executables on each replica's device.

        ``input_shapes`` is ``{input_name: feature_shape}`` for the ONE
        data input, without the batch dim (requests are coalesced along
        it). ``max_batch`` defaults to the largest of ``buckets`` (or
        32). ``slo_ms`` of 0/None turns latency-budget rejection off;
        ``max_wait_ms`` / ``max_queue`` / ``replicas`` default from
        ``MXTPU_SERVING_MAX_WAIT_MS`` / ``MXTPU_SERVING_MAX_QUEUE`` /
        ``MXTPU_SERVING_REPLICAS``. ``replicas`` lanes share the queue;
        replicas on one device share one set of executables and weights
        (:meth:`VariantSet.replica`). ``tp >= 2`` (or
        ``MXTPU_SERVING_TP``) makes each lane a slice of ``tp`` devices
        (``_pick_slices``) served by a :class:`~.sharded.ShardedVariantSet`
        (``fp32`` / ``bf16`` only).
        """
        if self._closed:
            raise ServingError("serving: gateway is closed")
        tp = _resolve_tp(tp)
        if tp is not None:
            bad = [v for v in variants if v not in SHARDED_VARIANTS]
            if bad:
                raise ServingError(
                    f"serving: tp={tp} lanes serve {SHARDED_VARIANTS}, not "
                    f"{bad} (int8 has no sharded lowering)")
        replicas = _resolve_replicas(replicas)
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
        model = Model(name, buckets, max_wait_s=max_wait_ms / 1e3,
                      max_queue=max_queue,
                      slo_s=(slo_ms / 1e3) if slo_ms else None,
                      variants=tuple(variants))
        model.tp = tp
        self._claim(name)
        try:
            t0 = now_ns()

            def build_replica(m, idx, device):
                # the one place a serving lane is built: registration and
                # Gateway.scale share it, so a scaled-out replica is
                # built and warmed exactly like a registered one
                same = [r for r in m.replicas if r.device == device]
                if same:
                    vs = same[0].variant_set.replica()
                elif isinstance(device, tuple):
                    vs = ShardedVariantSet(
                        symbol, arg_params, aux_params, input_name,
                        feature_shape, devices=device, variants=variants,
                        input_dtype=input_dtype)
                else:
                    vs = VariantSet(
                        symbol, arg_params, aux_params, input_name,
                        feature_shape, variants=variants, device=device,
                        calib_data=calib_data, calib_mode=calib_mode,
                        excluded_sym_names=excluded_sym_names,
                        input_dtype=input_dtype,
                        int8_lowering=int8_lowering)
                rep = Replica(m, idx, device, vs)
                return rep, rep.start(buckets if warmup else ())

            model._replica_factory = build_replica
            if tp is not None:
                picked, model.degraded = self._pick_slices(replicas, tp)
            else:
                picked, model.degraded = self._pick_devices(replicas)
            for device in picked:
                rep, n_exec = build_replica(model, model._next_idx, device)
                model._next_idx += 1
                model.executables += n_exec
                model.replicas.append(rep)
            model.warmup_seconds = (now_ns() - t0) / 1e9
        except BaseException:
            model.queue.close()
            for rep in model.replicas:
                rep.join(timeout=30.0)
            with self._gen_lock:
                del self._models[name]
            raise
        with self._gen_lock:
            self._models[name] = model
        # gauges only once registration is committed: a build failing on
        # replica k must leave no healthy series for a model that never
        # existed
        for r in model.replicas:
            _met()["healthy"].labels(model=name, replica=str(r.idx)).set(1)
        logger.info(
            "serving: registered %r on %s — %d replica(s) x %d variant(s) "
            "x %d bucket(s), warmup %.1fs", name,
            sorted({str(r.device) for r in model.replicas}),
            len(model.replicas), len(model.variants), len(buckets),
            model.warmup_seconds)
        return model

    def register_checkpoint(self, name, prefix, epoch, input_shapes,
                            **kwargs):
        """Register from ``prefix-symbol.json`` + ``prefix-####.params``
        (the Predictor's file contract), loaded onto the gateway's first
        device."""
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

    def _all_models(self):
        with self._gen_lock:
            return [m for m in self._models.values() if m is not None]

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
        met = _met()
        reason = self._admit(m, arr.shape[0])
        if reason is not None:
            m._count("rejected", reason)
            met["rejected"].labels(model=model, reason=reason).inc()
            raise RejectedError(reason, self._reject_msg(m, reason))
        req = Request(model, variant, arr, _trace_ctx())
        try:
            m.queue.put(req)
        except RejectedError:
            m._count("rejected", "closed")
            met["rejected"].labels(model=model, reason="closed").inc()
            raise
        # counted once enqueued: a request that raced a close is not
        # both admitted and rejected
        m._count("requests", variant)
        met["requests"].labels(model=model, variant=variant).inc()
        if not any(r.healthy for r in m.replicas):
            # the last lane died between admission and enqueue: its
            # drain has run, so nothing would ever serve this request
            for r in m.queue.drain():
                r._set_error(ServingError(
                    f"serving: no healthy replica left for {model!r}"))
        met["depth"].labels(model=model).set(m.queue.depth())
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
            if isinstance(rep.variant_set, ShardedVariantSet):
                rep.variant_set.close()
        for req in model.queue.drain():
            req._set_error(ServingError(
                f"serving: model {model.name!r} shut down before the "
                "request executed"))

    # -- generative decode ---------------------------------------------------
    def register_generator(self, name, decoder, block_tokens=None,
                           max_blocks=None, max_new_tokens=None,
                           max_decode_batch=8, max_queue=None,
                           replicas=None, warmup=True, tp=None,
                           layout=None):
        """Register a decoder LM for token-granular generation.

        ``decoder`` is a :class:`~.generate.GenerativeDecoder` on one of
        this gateway's devices. Each of the ``replicas`` lanes gets a
        device (the one-shot placement), a paged KV block pool of
        ``max_blocks`` x ``block_tokens``-token blocks, a CUDA stream on
        a card and, with ``warmup``, runs every prefill and decode bucket
        once. Lanes on the decoder's device share its parameters.
        ``max_new_tokens`` is the per-request generation cap (and the
        default for requests that don't pass one); the knob defaults
        come from ``MXTPU_GEN_BLOCK_TOKENS`` / ``MXTPU_GEN_MAX_BLOCKS``
        / ``MXTPU_GEN_MAX_NEW_TOKENS`` / ``MXTPU_SERVING_MAX_QUEUE`` /
        ``MXTPU_SERVING_REPLICAS``.

        In-flight generations survive lane loss: a killed, failed or
        scaled-in lane's requests migrate their KV blocks to surviving
        lanes — or replay prompt + accepted tokens deterministically —
        and continue token for token, budgeted by
        ``MXTPU_GEN_MAX_RECOVERIES`` (exhaustion = a fast
        ``RejectedError(reason="lane_lost")`` on the stream).

        ``tp >= 2`` (``tp`` None reads ``MXTPU_SERVING_TP``) makes each
        lane a mesh slice of ``tp`` devices (:meth:`_pick_slices`): the
        pool shards its heads over the slice, ``decoder.num_heads % tp``
        must be 0, and the weights are split by ``layout`` (a
        :class:`~mxnet_tpu_torch.parallel.layout.SpecLayout`; default
        ``SpecLayout.default()``), copied when each lane is built.
        """
        from .generate.scheduler import GenModel

        if self._closed:
            raise ServingError("serving: gateway is closed")
        tp = _resolve_tp(tp)
        replicas = _resolve_replicas(replicas)
        if decoder.device not in self._devices:
            raise ServingError(
                f"serving: decoder on {decoder.device}, gateway on "
                f"{[str(d) for d in self._devices]}")
        if block_tokens is None:
            block_tokens = get_env("MXTPU_GEN_BLOCK_TOKENS", 16, int)
        if max_blocks is None:
            max_blocks = get_env("MXTPU_GEN_MAX_BLOCKS", 256, int)
        if max_new_tokens is None:
            max_new_tokens = get_env("MXTPU_GEN_MAX_NEW_TOKENS", 64, int)
        if max_queue is None:
            max_queue = get_env("MXTPU_SERVING_MAX_QUEUE", 256, int)
        self._claim(name)
        try:
            if tp is not None:
                devices, degraded = self._pick_slices(replicas, tp)
            else:
                devices, degraded = self._pick_devices(replicas)
            gen = GenModel(name, decoder, devices,
                           block_tokens=block_tokens,
                           max_blocks=max_blocks,
                           max_new_tokens=max_new_tokens,
                           max_decode_batch=max_decode_batch,
                           max_queue=max_queue, warmup=warmup, tp=tp,
                           layout=layout)
            gen.degraded = degraded
        except BaseException:
            with self._gen_lock:
                del self._models[name]
            raise
        with self._gen_lock:
            del self._models[name]
            self._generators[name] = gen
        logger.info(
            "serving: registered generator %r — %d lane(s) on %s, "
            "%d-token blocks x %d, warmup %.1fs", name, len(gen.lanes),
            sorted({str(d) for ln in gen.lanes for d in (
                ln.device if isinstance(ln.device, tuple) else [ln.device])}),
            block_tokens,
            max_blocks, gen.warmup_seconds)
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
            known = sorted(self._generators)
        if gen is None:
            raise ServingError(
                f"serving: unknown generator {name!r} (registered: "
                f"{known})")
        return gen

    def submit_generate(self, model, prompt, max_new_tokens=None):
        """Admit one generation request; returns the streaming
        :class:`~.generate.GenRequest` future. Fast-rejects with
        :class:`RejectedError` (reason ``kv_cache_full`` when no lane's
        block pool can cover the request's token budget)."""
        from .generate.scheduler import GenRequest, _met as _gen_met

        gen = self._get_generator(model)
        met = _gen_met()
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
        req = GenRequest(model, prompt, max_new_tokens, _trace_ctx())
        reason = "closed" if self._closed else gen.try_admit(req)
        if reason is not None:
            met["rejected"].labels(model=model, reason=reason).inc()
            raise RejectedError(reason, self._gen_reject_msg(
                gen, reason, len(prompt), max_new_tokens))
        met["requests"].labels(model=model).inc()
        return req

    def _gen_reject_msg(self, gen, reason, plen, max_new):
        if reason == "kv_cache_full":
            need = gen.lanes[0].pool.blocks_for(plen + max_new)
            return (f"serving: {gen.name!r} KV block pool cannot cover "
                    f"{plen}+{max_new} tokens ({need} blocks) — shed "
                    "(retry with backoff, or lower max_new_tokens)")
        if reason == "queue_full":
            return (f"serving: {gen.name!r} generation queue at depth "
                    f"limit {gen.max_queue} — shed")
        if reason == "lane_lost":
            # admission never gives this reason; the recovery path builds
            # its own message (scheduler._recover_requests) — kept so
            # every RejectedError reason renders
            return (f"serving: {gen.name!r} request lost its decode "
                    "lane and exhausted its recovery budget — resubmit")
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

    # -- health --------------------------------------------------------------
    def check_health(self, model=None, revive=True):
        """Probe every replica off the queue; drained replicas whose
        probe passes rejoin (a fresh lane thread) when ``revive``.
        Returns ``{model: [healthy, ...]}``."""
        models = [self._get_model(model)] if model is not None \
            else self._all_models()
        out = {}
        for m in models:
            states = []
            for rep in list(m.replicas):
                ok = rep.probe()
                if ok and not rep.healthy and revive and \
                        not m.queue.closed:
                    rep.healthy = True
                    # always a FRESH lane: the generation bump retires
                    # any parked old thread (it hands back its next batch
                    # and exits), so a revive neither races a thread that
                    # is mid-exit nor leaks one that is not
                    rep.start()
                    m.queue.wake()    # the superseded thread leaves now
                    logger.info("serving: replica %d of %r revived",
                                rep.idx, m.name)
                elif not ok and rep.healthy:
                    rep.healthy = False
                    logger.warning(
                        "serving: replica %d of %r failed its health "
                        "probe — drained", rep.idx, m.name)
                _met()["healthy"].labels(
                    model=m.name, replica=str(rep.idx)).set(
                        1 if rep.healthy else 0)
                states.append(rep.healthy)
            if not m.queue.closed and not any(states):
                # the probe drained the LAST lane: lanes that exit
                # between batches never touch the queue, so pending
                # requests drain-fail here
                for req in m.queue.drain():
                    req._set_error(ServingError(
                        f"serving: no healthy replica left for "
                        f"{m.name!r} (health probe drained the last "
                        "lane)"))
            out[m.name] = states
        return out

    def _health_loop(self, period):
        while not self._health_stop.wait(period):
            try:
                self.check_health()
            except Exception:  # noqa: BLE001 — health must not crash
                logger.exception("serving: health probe failed")

    def health(self):
        """``{model: [replica healthy flags]}`` without probing."""
        return {m.name: [r.healthy for r in m.replicas]
                for m in self._all_models()}

    # -- elasticity ----------------------------------------------------------
    def replica_count(self, name):
        """Current serving lanes of a model or generator (retiring
        generator lanes excluded — they take no new work)."""
        with self._gen_lock:
            gen = self._generators.get(name)
        if gen is not None:
            with gen.cond:
                return sum(1 for ln in gen.lanes if not ln.retiring)
        return len(self._get_model(name).replicas)

    def scale(self, name, replicas):
        """Resize a registered model (or generator) to ``replicas``
        serving lanes. Scale-out builds, warms and starts fresh lanes
        through the same factory registration used, placed away from the
        devices existing lanes hold while others exist. Scale-in drains
        before retiring: a retired one-shot replica stops taking new
        batches (a batch it already took is requeued to survivors, one
        it is executing completes), and a retiring generator lane
        evacuates its in-flight generations to the surviving lanes
        (KV-block migration, deterministic replay fallback) and releases
        its KV block pool. Returns a report dict."""
        if self._closed:
            raise ServingError("serving: gateway is closed")
        n = int(replicas)
        if n < 1:
            raise ServingError(
                f"serving: cannot scale {name!r} below 1 replica (asked "
                f"{n}); use unregister() to remove the model")
        with self._gen_lock:
            gen = self._generators.get(name)
        if gen is not None:
            # existing lanes keep their devices (or slices); only the NEW
            # lanes are placed
            with gen.cond:
                active = [ln.device for ln in gen.lanes
                          if not ln.retiring]
            extra = max(n - len(active), 0)
            if gen.tp is not None:
                new_devs, new_deg = self._pick_slices(extra, gen.tp) \
                    if extra else ([], False)
                picked = list(active) + new_devs
                degraded = new_deg or _slices_share(picked[:n])
            else:
                new_devs, new_deg = self._pick_devices(extra, busy=active) \
                    if extra else ([], False)
                picked = list(active) + new_devs
                degraded = new_deg or n > self.device_count()
            report = gen.scale_to(n, picked)
            gen.degraded = degraded
            report["degraded"] = gen.degraded
            return report
        m = self._get_model(name)
        cur = len(m.replicas)
        report = {"model": name, "from": cur, "to": n,
                  "added": 0, "retired": 0}
        if n == cur:
            return report
        if n > cur:
            existing = [r.device for r in m.replicas]
            if m.tp is not None:
                # only the new slices are carved, away from every held
                # slice (the model's own too)
                new_devs, new_deg = self._pick_slices(n - cur, m.tp)
                m.degraded = new_deg or _slices_share(existing + new_devs)
            else:
                new_devs, new_deg = self._pick_devices(n - cur,
                                                       busy=existing)
                m.degraded = new_deg or n > self.device_count()
            for device in new_devs:
                idx = m._next_idx
                m._next_idx += 1
                rep, n_exec = m._replica_factory(m, idx, device)
                m.executables += n_exec
                m.replicas.append(rep)
                _met()["healthy"].labels(model=name,
                                         replica=str(idx)).set(1)
                report["added"] += 1
        else:
            # retire drained/unhealthy lanes FIRST (retiring the only
            # healthy lane would wedge the model behind dead threads),
            # then the newest healthy ones
            doomed = sorted(m.replicas,
                            key=lambda r: (r.healthy, -r.idx))[:cur - n]
            for rep in doomed:
                self._retire_replica(m, rep)
                report["retired"] += 1
            m.degraded = _slices_share([r.device for r in m.replicas]) \
                if m.tp is not None else n > self.device_count()
        report["degraded"] = m.degraded
        return report

    def _retire_replica(self, m, rep):
        """Drain-before-retire: the lane stops at its next take_batch
        wakeup — a batch it already took is requeued to survivors, a
        batch it is executing completes and replies — and leaves the
        list at once, so admission, poison accounting and health all see
        the new width."""
        rep.healthy = False
        rep.last_error = ServingError(
            f"serving: replica {rep.idx} of {m.name!r} retired by "
            "scale-in")
        rep._gen += 1   # a lane that took a batch hands it back
        if rep in m.replicas:
            m.replicas.remove(rep)
        _met()["healthy"].labels(model=m.name, replica=str(rep.idx)).set(0)
        # a lane parked in take_batch leaves at this wakeup; one that is
        # executing a batch completes it first — retirement does not
        # block on it
        m.queue.wake()
        rep.join(timeout=0.5)

    def stats(self):
        """Bounded per-model snapshot: queue, buckets, service-rate
        estimates, per-replica state and counts, executables and request
        / batch / reject / failure counts; generators report their
        queue, lanes (each with its pool and step counts), recovery
        totals and placement."""
        with self._gen_lock:
            gens = [g for g in self._generators.values() if g is not None]
        out = {}
        for m in self._all_models():
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
                "replicas": [r.stats() for r in m.replicas],
                "degraded": m.degraded,
                "tp": m.tp,
                "int8_lowering": (m.replicas[0].variant_set.int8_lowering
                                  if m.replicas else None),
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
        self._health_stop.set()
        if self._health_thread is not None:
            self._health_thread.join(timeout=30.0)
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
