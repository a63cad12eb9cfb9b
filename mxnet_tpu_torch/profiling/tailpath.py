"""Per-request critical-path attribution: why was THIS request slow?
(the port of ``mxnet_tpu/profiling/tailpath.py``).

The serving schedulers (``GenLane`` and the one-shot ``ModelQueue`` /
replica path) stamp typed decision events into the span layer as
attributes: admission verdict and queue-wait cause, batch-formation
hold, bucket / padding share, the admission work that held each decode
step, KV reserve waits, replica requeues, recovery pauses. The joiner
here rebuilds each request's timeline from its span tree (the trees
``serving.generate.scheduler`` and ``serving.gateway`` record) and bins
every wall-clock nanosecond into a CLOSED blame taxonomy:

======================  =====================================================
``queue_wait``          admission backlog: submit to admitted, minus the
                        causes billed below
``kv_wait``             admission blocked on the KV block reserve
``batch_hold``          one-shot coalescing hold (the ``max_wait`` window)
``prefill_compute``     own prompt prefill (real-token share)
``prefill_interleave``  OTHER requests' admission work holding this
                        request's decode step
``decode_compute``      decode-step execution (real-row share)
``padding_tax``         bucket padding share of prefill / decode / execute
``sched_overhead``      host scheduler bookkeeping not otherwise blamed
``execute``             one-shot batch execution (real-row share)
``reply``               execution end to reply delivered
``requeue``             replica drain / requeue: time lost to a failed
                        attempt
``recovery``            decode failover (migrate / replay) after lane loss
``reclaim_pause``       a recovery caused by a reclaim / planned drain
``_unattributed``       residual, which the conservation check bounds
======================  =====================================================

Conservation: per request the bins sum to the measured end-to-end wall
(the root span's duration) within a tolerance; the windowed aggregator
keeps the last N completed requests, takes the slowest fraction, ranks
its blame bins, publishes the ``mx_tail_*`` families and builds a
versioned ``tail/v1`` document (``tools/tail_report.py`` renders and
diffs it). Everything here is span and dict arithmetic: no device
handle, no sync.

Knobs: ``MXTPU_TAIL_ENABLE`` (default on), ``MXTPU_TAIL_WINDOW``
(completed requests kept, default 512), ``MXTPU_TAIL_SLOW_FRAC``
(slow-cohort fraction, default 0.1), ``MXTPU_TAIL_ARTIFACT`` (the path
:func:`dump` writes when given none).
"""
from __future__ import annotations

import json
import os
import threading
import time
from collections import deque

from ..base import get_env
from ..telemetry import metrics as _tm

TAIL_KIND = "tail/v1"
TAIL_VERSION = 1

BINS = (
    "queue_wait", "kv_wait", "batch_hold",
    "prefill_compute", "prefill_interleave",
    "decode_compute", "padding_tax", "sched_overhead",
    "execute", "reply", "requeue",
    "recovery", "reclaim_pause",
    "_unattributed",
)

# span names whose trees the joiner understands
GENERATE_ROOT = "serving.generate"
ONESHOT_ROOT = "serving.request"

_met = _tm.lazy_metrics(lambda reg: {
    "e2e": reg.histogram(
        "mx_tail_e2e_seconds",
        "attributed request end-to-end wall (submit -> reply/last "
        "token)", labelnames=("kind",)),
    "blame": reg.gauge(
        "mx_tail_blame_seconds",
        "blamed wall-seconds per taxonomy bin at the last collect",
        labelnames=("bin", "cohort")),
    "requests": reg.gauge(
        "mx_tail_requests",
        "requests in the attribution window at the last collect",
        labelnames=("cohort",)),
    "conservation": reg.gauge(
        "mx_tail_conservation_fraction",
        "attributed / measured e2e at the last collect (1.0 = every "
        "nanosecond blamed)", labelnames=("cohort",)),
})


def enabled():
    """Whether the tail-attribution plane records (MXTPU_TAIL_ENABLE)."""
    return bool(get_env("MXTPU_TAIL_ENABLE", 1, int))


def _overlap_ns(a_start, a_end, b_start, b_end):
    return max(min(a_end, b_end) - max(a_start, b_start), 0)


def _num(v, default=0):
    return v if isinstance(v, (int, float)) else default


def _zero_bins():
    return {b: 0 for b in BINS}


def _bins_generate(root, children):
    """Blame bins (ns) for one generate request's span tree, or None
    when the tree is incomplete (ring eviction dropped spans — an
    incomplete tree cannot conserve, so it is skipped and counted)."""
    attrs = root.get("attrs") or {}
    new_tokens = int(_num(attrs.get("new_tokens")))
    prefill = None
    tokens = []
    recovers = []
    for s in children:
        n = s.get("name")
        if n == "generate.prefill":
            prefill = s
        elif n == "generate.token":
            tokens.append(s)
        elif n == "generate.recover":
            recovers.append(s)
    if prefill is None or len(tokens) != new_tokens or not tokens:
        return None
    tokens.sort(key=lambda s: _num((s.get("attrs") or {}).get("index")))
    bins = _zero_bins()
    e2e = _num(root.get("dur_ns"))

    # -- prefill phase: submit -> first token ---------------------------------
    pa = prefill.get("attrs") or {}
    p_dur = _num(prefill.get("dur_ns"))
    q = min(max(int(_num(pa.get("queue_ns"))), 0), p_dur)
    kv = min(max(int(_num(pa.get("kv_wait_ns"))), 0), q)
    bins["kv_wait"] += kv
    bins["queue_wait"] += q - kv
    ex = min(max(int(_num(pa.get("exec_ns"))), 0), p_dur - q)
    plen = max(int(_num(pa.get("prompt_tokens"), 1)), 1)
    tpad = max(int(_num(pa.get("pad_tokens"), plen)), plen)
    pad_frac = (tpad - plen) / tpad
    bins["prefill_compute"] += int(ex * (1.0 - pad_frac))
    bins["padding_tax"] += int(ex * pad_frac)
    bins["sched_overhead"] += max(p_dur - q - ex, 0)

    # -- decode phase: token i-1 emit -> token i emit -------------------------
    rec_iv = [(r["start_ns"], r["start_ns"] + _num(r.get("dur_ns")),
               str((r.get("attrs") or {}).get("cause") or ""))
              for r in recovers]
    prev_end = tokens[0]["start_ns"] + _num(tokens[0].get("dur_ns"))
    for tok in tokens[1:]:
        ta = tok.get("attrs") or {}
        t_start = tok["start_ns"]
        t_end = t_start + _num(tok.get("dur_ns"))
        interval = t_end - prev_end
        if interval <= 0:
            prev_end = max(prev_end, t_end)
            continue
        step = min(max(t_end - t_start, 0), interval)
        # recovery pauses overlapping this inter-token gap (the step
        # itself is never a recovery — clip so nothing double-bills)
        rec = rec_rcl = 0
        for r0, r1, cause in rec_iv:
            ov = _overlap_ns(prev_end, t_end, r0, r1)
            if "reclaim" in cause or "retire" in cause or \
                    "drain" in cause:
                rec_rcl += ov
            else:
                rec += ov
        spare = max(interval - step, 0)
        rec = min(rec, spare)
        rec_rcl = min(rec_rcl, spare - rec)
        # the interleave stamp can include the request's OWN admission
        # work (it was measured lane-wide); the clip to the actual gap
        # keeps attribution conservative
        inter = min(max(int(_num(ta.get("interleave_ns"))), 0),
                    spare - rec - rec_rcl)
        rows = max(int(_num(ta.get("rows"), 1)), 1)
        bucket = max(int(_num(ta.get("bucket"), rows)), rows)
        pad_frac = (bucket - rows) / bucket
        bins["decode_compute"] += int(step * (1.0 - pad_frac))
        bins["padding_tax"] += int(step * pad_frac)
        bins["recovery"] += rec
        bins["reclaim_pause"] += rec_rcl
        bins["prefill_interleave"] += inter
        bins["sched_overhead"] += max(
            interval - step - rec - rec_rcl - inter, 0)
        prev_end = t_end
    attributed = sum(bins.values())
    bins["_unattributed"] = max(e2e - attributed, 0)
    return bins, e2e


def _bins_oneshot(root, children):
    """Blame bins (ns) for one one-shot request's span tree."""
    by_name = {}
    for s in children:
        by_name.setdefault(s.get("name"), s)
    q_span = by_name.get("serving.queue")
    x_span = by_name.get("serving.execute")
    if q_span is None or x_span is None:
        return None
    bins = _zero_bins()
    e2e = _num(root.get("dur_ns"))
    qa = q_span.get("attrs") or {}
    q = _num(q_span.get("dur_ns"))
    hold = min(max(int(_num(qa.get("hold_ns"))), 0), q)
    requeue = min(max(int(_num(qa.get("requeue_ns"))), 0), q - hold)
    bins["batch_hold"] += hold
    bins["requeue"] += requeue
    bins["queue_wait"] += q - hold - requeue
    b_span = by_name.get("serving.batch")
    if b_span is not None:
        bins["sched_overhead"] += _num(b_span.get("dur_ns"))
    xa = x_span.get("attrs") or {}
    ex = _num(x_span.get("dur_ns"))
    rows = max(int(_num(xa.get("rows"), 1)), 1)
    bucket = max(int(_num(xa.get("bucket"), rows)), rows)
    pad_frac = (bucket - rows) / bucket
    bins["execute"] += int(ex * (1.0 - pad_frac))
    bins["padding_tax"] += int(ex * pad_frac)
    r_span = by_name.get("serving.reply")
    if r_span is not None:
        bins["reply"] += _num(r_span.get("dur_ns"))
    attributed = sum(bins.values())
    bins["_unattributed"] = max(e2e - attributed, 0)
    return bins, e2e


def attribute_request(root, children):
    """One request's attribution record from its root span + direct
    children, or None when the tree is incomplete. ``bins`` are ns and
    sum (with ``_unattributed``) to >= the measured e2e; conservation
    is judged by the aggregator/gate, not here."""
    name = root.get("name")
    if name == GENERATE_ROOT:
        out = _bins_generate(root, children)
        kind = "generate"
    elif name == ONESHOT_ROOT:
        out = _bins_oneshot(root, children)
        kind = "oneshot"
    else:
        return None
    if out is None:
        return None
    bins, e2e = out
    attrs = root.get("attrs") or {}
    return {
        "kind": kind,
        "model": attrs.get("model"),
        "trace": root.get("trace"),
        "start_ns": root.get("start_ns"),
        "e2e_ns": e2e,
        "bins": bins,
        "queue_cause": attrs.get("queue_cause"),
    }


def join_spans(spans, t0_ns=None, t1_ns=None):
    """Attribution records for every complete request tree in a
    ``tracing.spans_snapshot()`` list whose root STARTS inside
    [t0_ns, t1_ns) (None = unbounded). Returns ``(records,
    skipped_incomplete)`` — a root whose children were evicted from
    the ring cannot conserve and is counted instead of half-blamed."""
    roots = []
    kids = {}
    for s in spans:
        if s.get("name") in (GENERATE_ROOT, ONESHOT_ROOT):
            st = s.get("start_ns", 0)
            if t0_ns is not None and st < t0_ns:
                continue
            if t1_ns is not None and st >= t1_ns:
                continue
            roots.append(s)
        kids.setdefault((s.get("trace"), s.get("parent")), []).append(s)
    records = []
    skipped = 0
    for root in roots:
        children = kids.get((root.get("trace"), root.get("span")), [])
        rec = attribute_request(root, children)
        if rec is None:
            skipped += 1
        else:
            records.append(rec)
    return records, skipped


class TailAggregator:
    """Windowed slow-cohort attribution: keep the last ``window``
    completed requests, rank the slowest ``slow_frac`` cohort's blame
    bins, publish ``mx_tail_*`` gauges at :meth:`collect`."""

    def __init__(self, window=None, slow_frac=None):
        if window is None:
            window = get_env("MXTPU_TAIL_WINDOW", 512, int)
        if slow_frac is None:
            slow_frac = get_env("MXTPU_TAIL_SLOW_FRAC", 0.1, float)
        self.window = max(int(window), 8)
        self.slow_frac = min(max(float(slow_frac), 0.01), 1.0)
        self._lock = threading.Lock()
        self._records = deque(maxlen=self.window)
        self._skipped = 0
        self._stages = {}

    def add(self, rec, stage=None):
        """Record one completed request's attribution (sync-free:
        deque append + one histogram observe)."""
        with self._lock:
            self._records.append(rec)
            if stage:
                self._stages[stage] = self._stages.get(stage, 0) + 1
        _met()["e2e"].labels(kind=rec.get("kind") or "?").observe(
            rec.get("e2e_ns", 0) / 1e9)

    def ingest_spans(self, spans, stage=None, t0_ns=None, t1_ns=None):
        """Join a span snapshot and add every complete request tree;
        returns the number of records added."""
        records, skipped = join_spans(spans, t0_ns=t0_ns, t1_ns=t1_ns)
        with self._lock:
            self._skipped += skipped
        for rec in records:
            self.add(rec, stage=stage)
        return len(records)

    def collect(self, tolerance=0.10, provenance=None):
        """Build the versioned ``tail/v1`` artifact and publish the
        ``mx_tail_*`` gauges. Conservation (per cohort): attributed
        bins (minus the residual) over measured e2e — the gate
        recomputes the same quotient from the raw numbers."""
        with self._lock:
            records = list(self._records)
            skipped = self._skipped
            stages = dict(self._stages)
        records.sort(key=lambda r: -r.get("e2e_ns", 0))
        n = len(records)
        k = max(int(round(n * self.slow_frac)), 1) if n else 0
        slow = records[:k]

        def _cohort(rs):
            bins = {b: 0.0 for b in BINS}
            e2e = 0.0
            for r in rs:
                e2e += r.get("e2e_ns", 0) / 1e9
                for b, v in (r.get("bins") or {}).items():
                    if b in bins:
                        bins[b] += v / 1e9
            attributed = sum(v for b, v in bins.items()
                             if b != "_unattributed")
            return bins, e2e, attributed

        all_bins, all_e2e, all_attr = _cohort(records)
        slow_bins, slow_e2e, slow_attr = _cohort(slow)
        drivers = sorted(
            ({"bin": b, "blamed_s": round(v, 6),
              "share": round(v / slow_e2e, 4) if slow_e2e else 0.0}
             for b, v in slow_bins.items()
             if v > 0 and b != "_unattributed"),
            key=lambda d: -d["blamed_s"])
        unattr_frac = (slow_bins["_unattributed"] / slow_e2e) \
            if slow_e2e else 0.0
        conserved = bool(
            slow_e2e > 0
            and abs(slow_attr + slow_bins["_unattributed"] - slow_e2e)
            <= tolerance * slow_e2e
            and unattr_frac <= tolerance)
        doc = {
            "tool": "tailpath",
            "kind": TAIL_KIND,
            "version": TAIL_VERSION,
            "created": time.time(),
            "taxonomy": list(BINS),
            "window": {
                "requests": n,
                "capacity": self.window,
                "slow_frac": self.slow_frac,
                "slow_requests": k,
                "skipped_incomplete": skipped,
            },
            "stages": {s: {"requests": c}
                       for s, c in sorted(stages.items())},
            "bins": {b: round(v, 6) for b, v in all_bins.items()},
            "slow": {
                "requests": k,
                "e2e_s": round(slow_e2e, 6),
                "bins": {b: round(v, 6) for b, v in slow_bins.items()},
                "drivers": drivers,
            },
            "conservation": {
                "tolerance": tolerance,
                "e2e_s": round(all_e2e, 6),
                "attributed_s": round(all_attr, 6),
                "unattributed_s": round(all_bins["_unattributed"], 6),
                "slow_e2e_s": round(slow_e2e, 6),
                "slow_attributed_s": round(slow_attr, 6),
                "slow_unattributed_s":
                    round(slow_bins["_unattributed"], 6),
                "fraction": round(all_attr / all_e2e, 4)
                    if all_e2e else 0.0,
                "slow_fraction": round(slow_attr / slow_e2e, 4)
                    if slow_e2e else 0.0,
                "conserved": conserved,
            },
            "slowest": [
                {"e2e_ms": round(r.get("e2e_ns", 0) / 1e6, 3),
                 "kind": r.get("kind"),
                 "model": r.get("model"),
                 "queue_cause": r.get("queue_cause"),
                 "top_bin": max(
                     (b for b in BINS if b != "_unattributed"),
                     key=lambda b: (r.get("bins") or {}).get(b, 0)),
                 "bins_ms": {
                     b: round(v / 1e6, 3)
                     for b, v in sorted((r.get("bins") or {}).items())
                     if v > 0}}
                for r in slow[:8]],
        }
        if provenance is not None:
            doc["provenance"] = provenance
        met = _met()
        for cohort, (bins, e2e, attr) in (
                ("all", (all_bins, all_e2e, all_attr)),
                ("slow", (slow_bins, slow_e2e, slow_attr))):
            for b, v in bins.items():
                met["blame"].labels(bin=b, cohort=cohort).set(v)
            met["conservation"].labels(cohort=cohort).set(
                (attr / e2e) if e2e else 0.0)
        met["requests"].labels(cohort="all").set(n)
        met["requests"].labels(cohort="slow").set(k)
        return doc


def summary(doc, max_bytes=2048):
    """Bounded, provenance-marked embed for bench artifacts (the
    goodput-summary pattern): slow-cohort drivers + conservation
    verdict, guaranteed under ``max_bytes`` serialized."""
    if not isinstance(doc, dict) or doc.get("kind") != TAIL_KIND:
        return None
    cons = doc.get("conservation", {})
    slow = doc.get("slow", {})
    out = {
        "kind": "tail_summary",
        "source": "profiling.tailpath",
        "requests": doc.get("window", {}).get("requests"),
        "slow_requests": slow.get("requests"),
        "slow_e2e_s": slow.get("e2e_s"),
        "slow_fraction": cons.get("slow_fraction"),
        "conserved": cons.get("conserved"),
        "drivers": (slow.get("drivers") or [])[:5],
        "bins": {b: round(float(v), 4)
                 for b, v in sorted((slow.get("bins") or {}).items())},
    }
    # hard bound: drop detail until it fits (provenance keys survive)
    for victim in ("bins", "drivers"):
        if len(json.dumps(out)) <= max_bytes:
            break
        out.pop(victim, None)
    return out


def dump(path, doc):
    """Write the artifact atomically (tmp + rename). ``path=None``
    falls back to ``MXTPU_TAIL_ARTIFACT``; both unset is a no-op (the
    plane records, nobody asked for a file)."""
    if path is None:
        path = get_env("MXTPU_TAIL_ARTIFACT", None, str) or None
    if not path:
        return doc
    tmp = "%s.tmp.%d" % (path, os.getpid())
    with open(tmp, "w", encoding="utf-8") as f:
        f.write(json.dumps(doc, indent=1, sort_keys=True))
    os.replace(tmp, path)
    return doc
