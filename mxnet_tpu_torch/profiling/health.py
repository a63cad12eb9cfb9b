"""Model-health plane: nonfinite sentry, gradient / update telemetry,
loss-anomaly detection, the first-NaN postmortem and drift fingerprints
(the port of ``mxnet_tpu/profiling/health.py``).

It answers "is the model still training correctly?" without making the
host wait for the card, in four layers:

1. **Nonfinite sentry** (:func:`check`): the framework seams (executor
   forward and backward, gluon ``Trainer.step``, the optimizer
   ``Updater``, the sharded train step) hand their output trees in; the
   sentry launches a nonfinite count over them (a device scalar, never
   read there) into this step's per-source bucket. :func:`step_boundary`
   banks the step's buckets and folds those at least ``_FOLD_LAG``
   boundaries old. On CUDA a ``float()`` of a tensor waits for all the
   work queued on its stream, not just that value, so a banked CUDA
   count is copied into pinned host memory behind a recorded event
   (``telemetry.metrics``' pending entries) and folds only once its
   event has completed: an old entry whose copy has not landed waits
   for a later boundary, and no boundary ever blocks. :func:`flush` is
   the read point that waits. Each entry keeps the step it was launched
   in, so a trip names the step the JAX package names; on the CPU every
   entry is ready and trips at the same boundary as there. A nonzero
   fold *trips* the sentry: the first-NaN postmortem is written and the
   policy (warn / raise) applies at the boundary.

2. **Training-health telemetry**: global gradient norm, per-group
   weight and gradient norms and update-to-weight ratios from the
   gluon Trainer's :class:`StepProbe`, whose launch count does not grow
   with the number of parameters (multi-tensor norms with f32
   accumulation, the gradients' and weights' nonfinite counts over one
   concatenation, the update taken in place in a scratch of the
   pre-update weights), handed to the ``mx_health_*`` gauges as
   pending values. The loss lands through :func:`observe_loss` and feeds
   an EWMA with z-score **spike** and flat-line **plateau** detection
   on the folded (host) values.

3. **First-NaN postmortem** (:func:`nan_postmortem`): when the sentry
   trips at an executor seam, :func:`localize_first_nonfinite` replays
   the executor's walk with the per-node tap behind
   ``set_monitor_callback`` and binary-searches the topologically
   ordered prefix for the first output holding a nonfinite (log2(n)
   one-byte reads, postmortem syncs). One atomic artifact lands at
   ``MXTPU_HEALTH_DUMP_PATH``: the offending op, its input statistics,
   the ranked per-group gradient-norm table, the RNG state and a
   flight-recorder snapshot.

4. **Drift fingerprints** (:func:`fingerprint_params`): a blake2b digest
   over a deterministically ordered flatten of a parameter tree, the
   JAX package's bytes for the same values (a read-time API).

Env: ``MXTPU_HEALTH`` (0 = every hook a no-op; 1 / warn = default;
raise = a trip raises :class:`NonfiniteError` at the boundary),
``MXTPU_HEALTH_DUMP_PATH``, ``MXTPU_HEALTH_NORMS`` (0 turns the norm
telemetry and its pre-update copy off; the sentry stays),
``MXTPU_HEALTH_ANOMALY_Z``. CLI: ``tools/health_report.py`` (table /
--diff / --postmortem) reads the documents this module writes.
"""
from __future__ import annotations

import contextlib
import hashlib
import json
import os
import sys
import threading
import time

import numpy as np
import torch

from ..telemetry import metrics as _tm
from .memory import _leaves

HEALTH_DOC_VERSION = 1
NAN_POSTMORTEM_VERSION = 1

# boundaries a banked count waits before it may fold
_FOLD_LAG = 4


class NonfiniteError(ArithmeticError):
    """Raised at a step boundary under MXTPU_HEALTH=raise when the
    sentry folded a nonzero nonfinite count. Carries the postmortem
    document (``.postmortem``) when one was written."""

    def __init__(self, msg, postmortem=None):
        super().__init__(msg)
        self.postmortem = postmortem


# -- gates ------------------------------------------------------------------
def _parse_policy(raw):
    raw = (raw or "1").strip().lower()
    if raw in ("0", "off", "false", "no"):
        return None
    if raw in ("raise", "fatal"):
        return "raise"
    return "warn"


_policy = [_parse_policy(os.environ.get("MXTPU_HEALTH"))]
_norms = [os.environ.get("MXTPU_HEALTH_NORMS", "1") not in (
    "0", "off", "false")]


def enabled():
    """MXTPU_HEALTH gate (default on), read once at import: the seams
    run every step."""
    return _policy[0] is not None


def policy():
    """'warn' | 'raise' | None (disabled)."""
    return _policy[0]


def set_enabled(on):
    """Flip the plane at runtime: a bool or a policy string
    ('warn' / 'raise' / '0')."""
    if isinstance(on, str):
        _policy[0] = _parse_policy(on)
    else:
        _policy[0] = "warn" if on else None


def norms_enabled():
    """MXTPU_HEALTH_NORMS gate for the per-group norm telemetry."""
    return enabled() and _norms[0]


def set_norms_enabled(on):
    _norms[0] = bool(on)


def anomaly_z():
    try:
        return float(os.environ.get("MXTPU_HEALTH_ANOMALY_Z", "6"))
    except ValueError:
        return 6.0


def dump_path():
    return os.environ.get("MXTPU_HEALTH_DUMP_PATH") or \
        "nan_postmortem.json"


# -- telemetry families -----------------------------------------------------
def _lazy_met():
    return _tm, _tm.lazy_metrics(lambda reg: {
        "nonfinite": reg.counter(
            "mx_health_nonfinite_total",
            "nonfinite (NaN/Inf) values folded by the sentry, by "
            "framework seam", labelnames=("source",)),
        "trips": reg.counter(
            "mx_health_trips_total",
            "sentry trips (first nonzero fold per burst)").labels(),
        "loss": reg.gauge(
            "mx_health_loss", "last folded training loss").labels(),
        "loss_ewma": reg.gauge(
            "mx_health_loss_ewma",
            "EWMA of the folded training loss").labels(),
        "anomalies": reg.counter(
            "mx_health_loss_anomalies_total",
            "loss anomalies detected (z-score spike / flat-line "
            "plateau)", labelnames=("kind",)),
        "grad_norm": reg.gauge(
            "mx_health_grad_norm",
            "global gradient L2 norm (lazy; folded at snapshot)"
            ).labels(),
        "group_weight": reg.gauge(
            "mx_health_weight_norm",
            "per-parameter-group weight L2 norm",
            labelnames=("group",)),
        "group_grad": reg.gauge(
            "mx_health_grad_norm_group",
            "per-parameter-group gradient L2 norm",
            labelnames=("group",)),
        "group_ratio": reg.gauge(
            "mx_health_update_ratio",
            "per-parameter-group update-to-weight norm ratio "
            "||dw||/||w||", labelnames=("group",)),
        "ratio_hist": reg.histogram(
            "mx_health_update_to_weight",
            "distribution of per-group update-to-weight ratios "
            "(dimensionless)",
            buckets=(1e-7, 1e-6, 1e-5, 1e-4, 1e-3, 1e-2, 1e-1, 1.0)),
    })


_met_box = []


def _met():
    """(telemetry.metrics module, built metric bundle), memoized."""
    if not _met_box:
        _met_box.append(_lazy_met())
    tm, lazy = _met_box[0]
    return tm, lazy()


# -- values on their way to the host ----------------------------------------
class _Item:
    """One element of a vector already on its way to the host (a pending
    entry of ``telemetry.metrics``): many scalars ride one copy."""

    __slots__ = ("box", "index")

    def __init__(self, box, index):
        self.box = box
        self.index = index

    def ready(self):
        return _tm._ready(self.box)

    def __float__(self):
        return float(_host(self.box)[self.index])


# what a banked value becomes: a CUDA tensor a pinned copy behind an
# event; host values and CPU tensors as they are
_pending = _tm._lazy_entry
_ready = _tm._ready


def _host(x):
    """The host value of a pending entry (waits for its copy when it has
    not landed: only read points call this on such an entry)."""
    if isinstance(x, _tm._Pending):
        if not x.ready():
            x.event.synchronize()
        return x.host
    return x


def _number(x):
    """The host number of a folded entry: a pending copy's landed value
    (waited for at read points only), else ``float()`` of a host value
    or, at a read point, of a device tensor."""
    return float(_host(x))


# -- sentry state -----------------------------------------------------------
class _HealthState:
    def __init__(self):
        self.lock = threading.Lock()
        self.step = 0                    # boundaries observed
        self.open = {}                   # {source: count} this step
        # ONE localizer slot per source, overwritten every check: the
        # closure pins its step's inputs for the replay, so one per
        # banked entry would keep superseded batches alive
        self.latest_loc = {}             # {source: localizer}
        self.pending = []                # [(step, {src: pending count})]
        self.loss_pending = []           # [(step, pending scalar)]
        self.nonfinite_total = 0
        self.raised_total = 0            # nonfinites already raised for
        self.by_source = {}
        self.first_trip = None
        self.last_postmortem = -10.0     # monotonic; burst coalescing
        # loss EWMA / anomaly detection (folded host values only)
        self.loss_last = None
        self.loss_ewma = None
        self.loss_var = 0.0
        self.loss_n = 0
        self.anomalies = []              # bounded record of events
        self.plateau_run = 0
        self.plateau_fired = False
        # last folded norm table {group: {...}} + global grad norm
        self.norm_groups = {}
        self.grad_norm = None
        self.norm_pending = []           # [(step, outs)] un-folded
        self.last_doc = None             # most recent postmortem doc


_state = _HealthState()

# loss EWMA decay and the anomaly warmup / plateau knobs
_EWMA_ALPHA = 0.05
_ANOMALY_WARMUP = 20
_PLATEAU_EPS = 1e-5
_PLATEAU_STEPS = 25


def _data(leaf):
    from ..parallel.mesh import Sharded
    data = getattr(leaf, "_data", leaf)
    if isinstance(data, Sharded):
        data = data.full()
    return data


def _bad(flat):
    """A bool tensor of the nonfinite entries of a flat tensor: its
    magnitude not <= its type's largest value (NaN compares false)."""
    dt = flat.dtype.to_real() if flat.is_complex() else flat.dtype
    return flat.abs().le(torch.finfo(dt).max).logical_not_()


def _nonfinite_count(tree):
    """A device scalar: the nonfinite values across the floating leaves
    of ``tree`` (launched, never read here), over one concatenation a
    device, so the launches do not grow with the number of leaves. None
    when the tree holds no floating leaf."""
    by_device, host = {}, None
    for leaf in _leaves(tree):
        data = _data(leaf)
        if isinstance(data, torch.Tensor):
            if data.is_floating_point() or data.is_complex():
                by_device.setdefault(data.device, []).append(
                    data.detach().reshape(-1))
            continue
        dt = getattr(data, "dtype", None)
        if dt is not None and np.issubdtype(dt, np.inexact):
            host = (host or 0) + int(np.size(data) - np.count_nonzero(
                np.isfinite(data)))
    total = None
    for ts in by_device.values():
        flat = ts[0] if len(ts) == 1 else torch.cat(ts)
        c = _bad(flat).sum()
        total = c if total is None else total + c.to(total.device)
    if host is not None:
        total = torch.tensor(host) if total is None else total + host
    return total


def _accumulate(source, scalar, localize=None):
    """Add a count to this step's bucket of ``source`` (a device add:
    one scalar a source a step)."""
    source = str(source)
    st = _state
    with st.lock:
        prev = st.open.get(source)
        st.open[source] = scalar if prev is None \
            else prev + scalar.to(prev.device)
        if localize is not None:
            st.latest_loc[source] = localize


def check(source, tree, localize=None):
    """Sentry seam: count the nonfinites of ``tree`` on its device and
    add them to this step's bucket of ``source``. ``localize`` is an
    optional zero-argument callable returning a first-op localization
    (the executor seams pass one over :func:`localize_first_nonfinite`),
    called only if the bucket folds nonzero. No-op when MXTPU_HEALTH=0."""
    if not enabled():
        return
    total = _nonfinite_count(tree)
    if total is None:
        return
    _accumulate(source, total, localize)


def check_scalar(source, value, localize=None):
    """Sentry seam for a single scalar (a sharded step's loss)."""
    check(source, [value], localize=localize)


def observe_loss(value):
    """Buffer a (possibly still computing) per-step training loss; folded
    _FOLD_LAG boundaries later into the EWMA and the anomaly detector.
    No-op when disabled."""
    if not enabled():
        return
    data = getattr(value, "_data", value)
    if isinstance(data, torch.Tensor):
        data = data.detach()
    entry = _pending(data)
    st = _state
    with st.lock:
        st.loss_pending.append((st.step, entry))


def _fold_entries(entries, boundary=None):
    """Fold banked step buckets to the host; nonzero counts trip.
    ``boundary`` names the boundary folding them (trainer / module_fit /
    sharded_train_step / flush), recorded on the trip."""
    for step, by_source in entries:
        for source, scalar in by_source.items():
            try:
                n = int(_number(scalar))
            except (TypeError, ValueError, OverflowError):
                continue
            if n <= 0:
                continue
            with _state.lock:
                localize = _state.latest_loc.get(source)
            _trip(step, source, n, localize, boundary=boundary)


def _trip(step, source, count, localize, boundary=None):
    st = _state
    tm, met = _met()
    with st.lock:
        st.nonfinite_total += count
        st.by_source[source] = st.by_source.get(source, 0) + count
        first = st.first_trip is None
        if first:
            st.first_trip = {"step": step, "source": source,
                             "count": count, "ts": time.time(),
                             "folded_by": boundary}
    if tm.enabled():
        met["nonfinite"].labels(source=source).inc(count)
    doc = None
    now = time.monotonic()
    with st.lock:
        burst = now - st.last_postmortem < 1.0
        if not burst:
            st.last_postmortem = now
    if tm.enabled() and not burst:
        # one trip event a burst, as the postmortem coalesces
        met["trips"].inc()
    if not burst:
        # one artifact a failure burst: a poisoned run trips every step
        doc = nan_postmortem(step=step, source=source, count=count,
                             localize=localize)
        with st.lock:
            st.last_doc = doc
    # the raise policy applies at step_boundary(), never here
    print("[mxtpu] health: nonfinite values detected: %d at seam %r "
          "(step %d)%s"
          % (count, source, step,
             " — postmortem at %s" % doc.get("path")
             if doc and doc.get("path") else ""),
          file=sys.stderr, flush=True)


def _fold_loss(step, value):
    try:
        x = float(_number(value))
    except (TypeError, ValueError, OverflowError):
        return
    st = _state
    tm, met = _met()
    kind = None
    with st.lock:
        st.loss_last = x
        st.loss_n += 1
        if x != x or x in (float("inf"), float("-inf")):
            pass  # nonfinite loss: the sentry seam owns that signal
        elif st.loss_ewma is None:
            st.loss_ewma = x
        else:
            dev = x - st.loss_ewma
            std = st.loss_var ** 0.5
            if st.loss_n > _ANOMALY_WARMUP:
                if std > 0 and abs(dev) / std > anomaly_z():
                    kind = "spike"
                elif abs(dev) <= _PLATEAU_EPS * max(abs(st.loss_ewma),
                                                   1e-12):
                    st.plateau_run += 1
                    if st.plateau_run >= _PLATEAU_STEPS and \
                            not st.plateau_fired:
                        kind = "plateau"
                        st.plateau_fired = True
                else:
                    st.plateau_run = 0
                    st.plateau_fired = False
            st.loss_ewma += _EWMA_ALPHA * dev
            st.loss_var = ((1 - _EWMA_ALPHA) *
                           (st.loss_var + _EWMA_ALPHA * dev * dev))
        if kind is not None:
            st.anomalies.append({"step": step, "kind": kind,
                                 "loss": x, "ewma": st.loss_ewma})
            del st.anomalies[:-32]
        ewma = st.loss_ewma
    if tm.enabled():
        met["loss"].set(x)
        if ewma is not None:
            met["loss_ewma"].set(ewma)
        if kind is not None:
            met["anomalies"].labels(kind=kind).inc()


# -- per-group norm telemetry ----------------------------------------------
_GROUP_SUFFIXES = ("_weight", "_bias", "_gamma", "_beta", "_mean",
                   "_var")


def group_of(name):
    """Parameter-group key: the parameter name with its trailing role
    suffix stripped (dense0_weight and dense0_bias share 'dense0')."""
    for suf in _GROUP_SUFFIXES:
        if name.endswith(suf):
            return name[:-len(suf)] or name
    return name


# per-thread flat scratch of pre-update weights, one a (device, dtype)
_scratch = threading.local()


def pre_update_copy(weights):
    """The pre-update values of ``weights`` (tensors or NDArrays) as views
    of a flat scratch, one ``torch._foreach_copy_`` a (device, dtype):
    the port's optimizers update in place, so the update-to-weight ratio
    needs the old values kept. The scratch is allocated once a (device,
    dtype) on each thread and reused (grown when a bigger model needs
    it)."""
    ts = [getattr(w, "_data", w).detach() for w in weights]
    store = getattr(_scratch, "bufs", None)
    if store is None:
        store = _scratch.bufs = {}
    groups = {}
    for i, t in enumerate(ts):
        groups.setdefault((t.device, t.dtype), []).append(i)
    out = [None] * len(ts)
    for (dev, dtype), idx in groups.items():
        need = sum(ts[i].numel() for i in idx)
        buf = store.get((dev, dtype))
        if buf is None or buf.numel() < need:
            buf = store[(dev, dtype)] = torch.empty(need, dtype=dtype,
                                                    device=dev)
        off = 0
        for i in idx:
            n = ts[i].numel()
            out[i] = buf[off:off + n].view(ts[i].shape)
            off += n
        torch._foreach_copy_([out[i] for i in idx], [ts[i] for i in idx])
    return out


_GROUP_INDEX = {}


def _group_index(group_idx, device):
    """The partition as an index tensor, built once a (partition,
    device)."""
    key = (group_idx, device)
    t = _GROUP_INDEX.get(key)
    if t is None:
        t = _GROUP_INDEX[key] = torch.tensor(group_idx, dtype=torch.long,
                                             device=device)
    return t


def _nonfinite_pair(gs, ws):
    """(gradient, weight) nonfinite counts, int64 on the first tensor's
    device, over one concatenation."""
    flat = torch.cat([t.reshape(-1) for t in gs]
                     + [t.reshape(-1) for t in ws])
    bad = _bad(flat)
    n = sum(t.numel() for t in gs)
    return torch.stack([bad[:n].sum(), bad[n:].sum()])


def probe_values(ws, gs, olds, group_idx, want_norms):
    """The probe's device values: ``(counts, norms)``; ``counts`` int64
    (gradient nonfinites, weight nonfinites); ``norms`` (only with
    ``want_norms``) f64 of the global gradient norm, then each group's
    (weight norm, gradient norm, update ratio) in group order. Launches
    do not grow with the number of tensors: multi-tensor f32 norms and
    flat reductions. ``olds`` (pre-update weights) are overwritten with
    the update."""
    dev = ws[0].device
    ws = [w.detach() for w in ws]
    gs = [g.detach() for g in gs]
    counts = _nonfinite_pair(gs, ws)
    if not want_norms:
        return counts, None
    torch._foreach_sub_(olds, ws)          # old - new: the update's norm
    n = len(ws)
    norms = torch._foreach_norm(ws + gs + olds, 2, dtype=torch.float32)
    sq = torch.stack(norms).view(3, n).square_()
    # a group's sum sees only its own tensors: a nonfinite norm stays in
    # its group, as in the JAX probe's per-group sums
    acc = torch.zeros(3, max(group_idx) + 1, dtype=torch.float32,
                      device=dev).index_add_(1, _group_index(group_idx, dev),
                                             sq)
    total = sq[1].sum().sqrt_().view(1)
    acc.sqrt_()
    ratio = acc[2] / acc[0].clamp_min(1e-12)
    table = torch.stack([acc[0], acc[1], ratio], 1).reshape(-1)
    return counts, torch.cat([total, table]).double()


class StepProbe:
    """Per-step probe over a trainer's (weight, gradient, pre-update
    weight) triples. ``add`` is a list append; ``commit`` computes the
    counts and norms (:func:`probe_values`), banks the counts into the
    ``trainer_grad`` / ``trainer_param`` buckets, hands the norms to the
    gauges and queues them for the lagged host fold, all riding one
    pending host copy."""

    __slots__ = ("_names", "_ws", "_gs", "_olds", "step", "_norms")

    def __init__(self, step, want_norms):
        self.step = step
        self._norms = want_norms
        self._names = []
        self._ws = []
        self._gs = []
        self._olds = []

    @property
    def wants_norms(self):
        """Whether the caller should hand pre-update weights to ``add``
        (:func:`pre_update_copy`); with MXTPU_HEALTH_NORMS=0 no copy is
        taken."""
        return self._norms

    def add(self, name, weight, grad, weight_before=None):
        self._names.append(str(name))
        self._ws.append(getattr(weight, "_data", weight))
        self._gs.append(getattr(grad, "_data", grad))
        self._olds.append(getattr(weight_before, "_data", weight_before))

    def commit(self):
        if not self._ws:
            return
        want = self._norms and all(o is not None for o in self._olds)
        groups = []           # first-occurrence order
        group_idx = []
        for n in self._names:
            grp = group_of(n)
            if grp not in groups:
                groups.append(grp)
            group_idx.append(groups.index(grp))
        counts, norms = probe_values(self._ws, self._gs, self._olds,
                                     tuple(group_idx), want)
        _accumulate("trainer_grad", counts[0])
        _accumulate("trainer_param", counts[1])
        if not want:
            return
        box = _pending(norms)
        named = {grp: {"weight_norm": _Item(box, 1 + 3 * gi),
                       "grad_norm": _Item(box, 2 + 3 * gi),
                       "update_ratio": _Item(box, 3 + 3 * gi)}
                 for gi, grp in enumerate(groups)}
        outs = {"grad_norm": _Item(box, 0), "groups": named, "box": box}
        tm, met = _met()
        if tm.enabled():
            met["grad_norm"].set_lazy(outs["grad_norm"])
            for grp, e in named.items():
                met["group_weight"].labels(group=grp).set_lazy(
                    e["weight_norm"])
                met["group_grad"].labels(group=grp).set_lazy(
                    e["grad_norm"])
                met["group_ratio"].labels(group=grp).set_lazy(
                    e["update_ratio"])
                met["ratio_hist"].observe_lazy(e["update_ratio"])
        with _state.lock:
            _state.norm_pending.append((self.step, outs))
            del _state.norm_pending[:-8]


def step_probe(step=None):
    """A :class:`StepProbe` for this step, or None when the plane is off.
    With MXTPU_HEALTH_NORMS=0 the probe still counts nonfinites."""
    if not enabled():
        return None
    return StepProbe(_state.step if step is None else step,
                     norms_enabled())


# optimizer Updater calls inside a probe-covered trainer loop skip their
# own per-call check: the probe already sees every (grad, weight) pair
_covered = threading.local()


def updater_is_covered():
    return getattr(_covered, "depth", 0) > 0


@contextlib.contextmanager
def updater_covered():
    _covered.depth = getattr(_covered, "depth", 0) + 1
    try:
        yield
    finally:
        _covered.depth -= 1


def _landed_prefix(entries, horizon, landed):
    """The leading entries older than ``horizon`` whose values have all
    reached the host (``landed(entry)``): an older entry still in flight
    holds back the ones after it, so folds keep their order."""
    n = 0
    for e in entries:
        if e[0] >= horizon or not landed(e):
            break
        n += 1
    return n


def _norm_landed(entry):
    return _ready(entry[1]["box"])


def _fold_norms(all_pending=True, horizon=None):
    """Fold queued norm tables into host floats. At a boundary only
    tables at least _FOLD_LAG steps old whose copies landed fold; read
    paths (flush / postmortem) fold everything and may wait."""
    st = _state
    with st.lock:
        if all_pending:
            ready, st.norm_pending = st.norm_pending, []
        else:
            n = _landed_prefix(st.norm_pending, horizon, _norm_landed)
            ready = st.norm_pending[:n]
            st.norm_pending = st.norm_pending[n:]
    if not ready:
        return
    _step, outs = ready[-1]     # gauge semantics: newest wins
    groups = {}
    for grp, entry in outs["groups"].items():
        row = {}
        for k, v in entry.items():
            try:
                row[k] = float(v)
            except (TypeError, ValueError, OverflowError):
                continue
        groups[grp] = row
    with st.lock:
        st.norm_groups = groups
        try:
            st.grad_norm = float(outs["grad_norm"])
        except (TypeError, ValueError, OverflowError, KeyError):
            pass


def _bucket_landed(entry):
    return all(_ready(v) for v in entry[1].values())


def _loss_landed(entry):
    return _ready(entry[1])


# -- boundaries / folding ---------------------------------------------------
def step_boundary(source="trainer", span=None):
    """Close one health step: bank this step's buckets (their CUDA counts
    start their copies to the host), fold every banked bucket at least
    _FOLD_LAG boundaries old whose copy has landed, and stamp the lagged
    health attrs on the caller's step ``span``. Trips (and the raise
    policy) surface here, never inside a seam."""
    if not enabled():
        return None
    st = _state
    with st.lock:
        if st.open:
            st.pending.append((st.step, {k: _pending(v)
                                         for k, v in st.open.items()}))
            st.open = {}
        st.step += 1
        horizon = st.step - _FOLD_LAG
        n = _landed_prefix(st.pending, horizon, _bucket_landed)
        ready = st.pending[:n]
        st.pending = st.pending[n:]
        n = _landed_prefix(st.loss_pending, horizon, _loss_landed)
        loss_ready = st.loss_pending[:n]
        st.loss_pending = st.loss_pending[n:]
        # span attrs are lagged host state (earlier folds); only finite
        # values land: a bare NaN in chrome-trace args makes Perfetto
        # reject the whole document
        if span is not None:
            span.set_attr("health_nonfinite", st.nonfinite_total)
            for key, v in (("loss_ewma", st.loss_ewma),
                           ("grad_norm", st.grad_norm)):
                if v is not None and v == v and \
                        v not in (float("inf"), float("-inf")):
                    span.set_attr(key, round(v, 6))
    for step, v in loss_ready:
        _fold_loss(step, v)
    _fold_norms(all_pending=False, horizon=horizon)
    _fold_entries(ready, boundary=source)
    if policy() == "raise":
        with st.lock:
            fresh = st.nonfinite_total > st.raised_total
            st.raised_total = st.nonfinite_total
            trip, doc = st.first_trip, st.last_doc
        # only newly folded nonfinites raise: a caller that caught the
        # error and kept training is not raised at every clean boundary
        if fresh:
            raise NonfiniteError(
                "nonfinite values detected (total %d, first at seam "
                "%r step %s)" % (st.nonfinite_total,
                                 (trip or {}).get("source"),
                                 (trip or {}).get("step")),
                postmortem=doc)
    return None


def flush():
    """Fold EVERYTHING pending (waits for the card): end-of-run verdicts,
    tests, artifact embedding. Returns :func:`snapshot_doc`."""
    st = _state
    with st.lock:
        if st.open:
            st.pending.append((st.step, st.open))
            st.open = {}
        ready, st.pending = st.pending, []
        loss_ready, st.loss_pending = st.loss_pending, []
    for step, v in loss_ready:
        _fold_loss(step, v)
    _fold_entries(ready, boundary="flush")
    _fold_norms()
    return snapshot_doc(fold=False)


def snapshot_doc(fold=True):
    """Point-in-time health summary document (``tools/health_report.py``
    renders it)."""
    if fold:
        return flush()
    st = _state
    with st.lock:
        verdict = ("disabled" if not enabled() else
                   "nonfinite" if st.nonfinite_total else "clean")
        doc = {
            "version": HEALTH_DOC_VERSION,
            "kind": "health_summary",
            "enabled": enabled(),
            "policy": policy(),
            "steps": st.step,
            "sentry": {
                "verdict": verdict,
                "nonfinite_total": st.nonfinite_total,
                "by_source": dict(st.by_source),
                "first_trip": (dict(st.first_trip)
                               if st.first_trip else None),
            },
            "loss": {
                "last": st.loss_last,
                "ewma": st.loss_ewma,
                "std": (st.loss_var ** 0.5
                        if st.loss_ewma is not None else None),
                "observed": st.loss_n,
                "anomalies_total": len(st.anomalies),
                "anomalies": list(st.anomalies[-8:]),
            },
            "norms": {
                "grad_norm": st.grad_norm,
                "by_group": {g: dict(v)
                             for g, v in st.norm_groups.items()},
            },
        }
    return doc


def reset():
    """Drop all sentry / loss / norm state (the telemetry families reset
    through the registry)."""
    global _state
    _state = _HealthState()


# -- first-NaN localization -------------------------------------------------
def localize_first_nonfinite(executor, arg_vals, aux_vals, key=None,
                             training=False):
    """Name the FIRST node output (topological order) holding a
    nonfinite.

    Replays the executor's walk once with the per-node tap (every
    internal, in ``get_internals()`` order, values left on the device),
    then binary-searches the prefix predicate "any nonfinite among
    internals[:k]": monotone in k, each probe one bool read (postmortem
    syncs), log2(n) of them. Returns a dict naming the op, with input /
    output statistics, or None when every internal is finite (a NaN born
    in the backward). ``key`` is accepted for the JAX package's
    signature; the port's graph draws no random key."""
    names, vals = executor._internals(arg_vals, aux_vals, bool(training))
    dev = executor._device
    flags = []
    for v in vals:
        if isinstance(v, torch.Tensor) and (v.is_floating_point()
                                            or v.is_complex()):
            flags.append(torch.isfinite(v).logical_not().any().to(dev))
        elif isinstance(v, torch.Tensor) or v is None:
            flags.append(torch.zeros((), dtype=torch.bool, device=dev))
        else:
            a = np.asarray(v)
            bad = bool(np.issubdtype(a.dtype, np.inexact)
                       and not np.isfinite(a).all())
            flags.append(torch.tensor(bad, device=dev))

    probes = [0]

    def prefix_bad(k):
        probes[0] += 1
        return bool(torch.stack(flags[:k]).any())  # postmortem sync

    n = len(vals)
    if n == 0 or not prefix_bad(n):
        return None
    lo, hi = 1, n          # invariant: prefix_bad(hi) is True
    while lo < hi:
        mid = (lo + hi) // 2
        if prefix_bad(mid):
            hi = mid
        else:
            lo = mid + 1
    idx = lo - 1
    tensor_name = names[idx]
    node, _out_k = executor._symbol.get_internals()._outputs[idx]

    def stats(arr):
        if isinstance(arr, torch.Tensor):
            t = arr.detach().cpu()
            if t.dtype == torch.bfloat16:
                t = t.float()
            a = t.numpy()
        else:
            a = np.asarray(arr)
        out = {"shape": list(a.shape), "dtype": str(a.dtype)}
        if np.issubdtype(a.dtype, np.inexact) and a.size:
            finite = a[np.isfinite(a)]
            out["nonfinite"] = int(a.size - finite.size)
            if finite.size:
                out["min"] = float(finite.min())
                out["max"] = float(finite.max())
                out["mean"] = float(finite.mean())
        return out

    by_name = dict(zip(names, vals))
    inputs = []
    for child, k in node.inputs:
        suffix = "_output" if k == 0 else "_output%d" % k
        val = by_name.get(child.name + suffix)
        if val is None:   # graph input (variable / aux)
            val = arg_vals.get(child.name, aux_vals.get(child.name))
        entry = {"name": child.name}
        if val is not None:
            entry.update(stats(val))
        inputs.append(entry)
    return {
        "index": idx,
        "tensor": tensor_name,
        "node": node.name,
        "op": node.op,
        "named_scope": "mx.%s" % node.op if node.op else node.name,
        "attrs": {k: v for k, v in (node.attrs or {}).items()
                  if not k.startswith("__")},
        "probes": probes[0],
        "internals": n,
        "output": stats(vals[idx]),
        "inputs": inputs,
    }


# -- postmortem -------------------------------------------------------------
# zero-argument providers of extra postmortem context, run (guarded) at
# artifact time: Module.fit registers the data iterator's state_dict
_context_providers = {}


def register_postmortem_context(name, provider):
    """Register ``provider()`` to contribute a section to every later NaN
    postmortem under key ``name``; None unregisters."""
    if provider is None:
        _context_providers.pop(str(name), None)
    else:
        _context_providers[str(name)] = provider


def _rng_section():
    """The RNG state at artifact time: torch's default generator (its
    seed as ``mx_key``, the state's digest) and numpy's Mersenne
    position."""
    state = torch.random.get_rng_state().numpy().tobytes()
    np_state = np.random.get_state()
    return {
        "mx_key": [int(torch.initial_seed())],
        "torch": {"state_bytes": len(state),
                  "blake2b": hashlib.blake2b(state,
                                             digest_size=16).hexdigest()},
        "numpy": {"algo": str(np_state[0]), "pos": int(np_state[2])},
    }


def nan_postmortem(step=None, source=None, count=None, error=None,
                   localize=None, path=None, extra=None):
    """Write the first-NaN artifact: seam and first offending op (when a
    localizer is given), folded health state (loss EWMA and anomalies,
    the ranked gradient-norm table), RNG state and a flight-recorder
    snapshot. Atomic write; every section guarded: a postmortem never
    raises over the failure it documents."""
    doc = {"version": NAN_POSTMORTEM_VERSION, "kind": "nan_postmortem",
           "ts": time.time()}
    if source:
        doc["source"] = str(source)[:120]
    if step is not None:
        doc["step"] = int(step)
    # written when the lagged fold trips, up to _FOLD_LAG boundaries (or
    # more, while a copy is in flight) after the failing step: the RNG /
    # iterator sections are live state at capture time
    doc["captured_at_step"] = _state.step
    doc["fold_lag"] = _FOLD_LAG
    if count is not None:
        doc["nonfinite_count"] = int(count)
    if error is not None:
        doc["error"] = str(error)[:800]
    if callable(localize):
        try:
            doc["first_op"] = localize()
        except Exception as e:  # noqa: BLE001 — a replay can fail too
            doc["first_op_error"] = repr(e)[:200]
    try:
        _fold_norms()
        summary = snapshot_doc(fold=False)
        doc["loss"] = summary["loss"]
        norms = summary["norms"]
        ranked = sorted(
            ((g, v) for g, v in norms["by_group"].items()
             if "grad_norm" in v),
            key=lambda kv: -kv[1]["grad_norm"])
        doc["grad_norms"] = {
            "global": norms["grad_norm"],
            "ranked": [{"group": g, **v} for g, v in ranked[:25]],
        }
        doc["sentry"] = summary["sentry"]
    except Exception as e:  # noqa: BLE001
        doc["health_state_error"] = repr(e)[:200]
    try:
        doc["rng"] = _rng_section()
    except Exception as e:  # noqa: BLE001
        doc["rng_error"] = repr(e)[:200]
    for name, provider in list(_context_providers.items()):
        try:
            doc[name] = provider()
        except Exception as e:  # noqa: BLE001 — context is best-effort
            doc[name + "_error"] = repr(e)[:200]
    if extra:
        doc.update(extra)
    try:
        from ..tracing import flight as _flight
        doc["flight"] = _flight.snapshot(max_spans=10)
    except Exception as e:  # noqa: BLE001
        doc["flight_error"] = repr(e)[:200]
    path = path or dump_path()
    try:
        tmp = "%s.tmp.%d" % (path, os.getpid())
        with open(tmp, "w", encoding="utf-8") as f:
            # NaN norms are this artifact's payload: they land as
            # "nan" / "inf" strings, so strict parsers read the file
            json.dump(_json_sanitize(doc), f)
        os.replace(tmp, path)
        doc["path"] = path
    except OSError as e:
        doc["write_error"] = repr(e)[:200]
        print("[mxtpu] NaN postmortem write failed: %r" % (e,),
              file=sys.stderr, flush=True)
    return doc


def _json_sanitize(v):
    """Nonfinite floats -> their repr ("nan" / "inf" strings), numpy
    arrays and scalars -> lists and numbers (an iterator's state_dict
    holds its order as an array), so the artifact stays RFC-valid JSON
    and its write never raises over them."""
    if isinstance(v, np.ndarray):
        v = v.tolist()
    elif isinstance(v, np.generic):
        v = v.item()
    if isinstance(v, float) and (
            v != v or v in (float("inf"), float("-inf"))):
        return repr(v)
    if isinstance(v, dict):
        return {k: _json_sanitize(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_json_sanitize(x) for x in v]
    return v


# -- drift fingerprints -----------------------------------------------------
def iter_named_leaves(tree):
    """Deterministically ordered ``[(path, leaf), ...]`` flatten of a
    dict / list / tuple tree (None leaves skipped, paths "/"-joined and
    sorted lexicographically): the walk fingerprints hash."""
    leaves = []

    def walk(node, path):
        if isinstance(node, dict):
            for k in sorted(node, key=str):
                walk(node[k], path + (str(k),))
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, path + (str(i),))
        elif node is None:
            return
        else:
            leaves.append(("/".join(path), node))

    walk(tree, ())
    leaves.sort(key=lambda kv: kv[0])
    return leaves


def _host_array(leaf):
    from ..ops import registry as _reg
    from ..parallel.mesh import Sharded
    data = getattr(leaf, "_data", leaf)
    if isinstance(data, Sharded):
        data = data.full()
    if isinstance(data, torch.Tensor):
        t = data.detach().cpu()
        return _reg.bf16_to_numpy(t) if t.dtype == torch.bfloat16 \
            else t.numpy()
    return np.asarray(data)


def fingerprint_params(tree, digest_size=16):
    """blake2b digest over a deterministically ordered flatten of a
    parameter tree (dict / list / tuple of NDArray, tensor or numpy
    leaves): each leaf contributes path, shape, dtype and raw bytes, so
    two trees fingerprint equal iff they hold the same bits under the
    same names, and equal to the JAX package's for the same values.
    Copies every leaf to the host: a checkpoint / verify-time API, never
    a per-step one."""
    leaves = iter_named_leaves(tree)
    h = hashlib.blake2b(digest_size=int(digest_size))
    for path, leaf in leaves:
        a = np.ascontiguousarray(_host_array(leaf))
        h.update(path.encode("utf-8"))
        h.update(str(a.shape).encode())
        h.update(str(a.dtype).encode())
        h.update(a.tobytes())
    return h.hexdigest()
