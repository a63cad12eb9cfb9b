"""SLO objectives as multi-window burn rates on the timeline (the port of
``mxnet_tpu/telemetry/slo.py``).

An objective declares a budget (inter-token p99 under 100 ms, e2e p99
under 2.5 s, rejections under 5% of admissions); the tracker evaluates
how fast the error budget burns over a fast and a slow window (the
multi-window burn-rate alert: the fast window catches a fresh
regression quickly, the slow one keeps a transient blip from paging).
An objective's burn is ``min(fast, slow)`` — both windows must agree —
and the fleet burn (:func:`slo_burn`) is the max across objectives.
Burn rates are published as ``mx_slo_*`` families, so the timeline
records their history too.

Objectives come from :data:`DEFAULT_OBJECTIVES` or an ``MXTPU_SLO_FILE``
JSON override (a list of objective dicts, the defaults' keys). Kinds:

- ``latency``: histogram family, ``target_s`` and ``quantile`` q; the
  error fraction is the share of the window's observations above the
  target (bucket-delta CDF), the budget ``1 - q``;
- ``ratio``: error counter / total counter, the budget the allowed
  fraction.

Evaluation reads recorded timeline frames only; series aggregate
across a family by label subset (``{"stage": "e2e"}`` sums every
model's e2e series: bucket edges are uniform within a family, so
cumulative buckets add).
"""
from __future__ import annotations

import json

from ..base import get_env
from . import metrics as _metrics
from . import timeline as _timeline

DEFAULT_FAST_S = 60.0
DEFAULT_SLOW_S = 300.0

DEFAULT_OBJECTIVES = (
    {"name": "inter_token_p99", "kind": "latency",
     "metric": "mx_serving_generate_inter_token_seconds",
     "labels": {}, "target_s": 0.1, "quantile": 0.99},
    {"name": "e2e_p99", "kind": "latency",
     "metric": "mx_serving_latency_seconds",
     "labels": {"stage": "e2e"}, "target_s": 2.5, "quantile": 0.99},
    {"name": "rejection_rate", "kind": "ratio",
     "metric": "mx_serving_rejected_total", "labels": {},
     "total_metric": "mx_serving_requests_total", "total_labels": {},
     "budget": 0.05},
)


def load_objectives(path=None):
    """The declared objectives: ``MXTPU_SLO_FILE`` JSON (a list of
    objective dicts) when set, else :data:`DEFAULT_OBJECTIVES`. A
    malformed file raises — a silently-dropped SLO is worse than a
    failed start."""
    if path is None:
        path = get_env("MXTPU_SLO_FILE", None)
    if path is None:
        return [dict(o) for o in DEFAULT_OBJECTIVES]
    with open(path, "r", encoding="utf-8") as f:
        objs = json.load(f)
    if not isinstance(objs, list) or not objs:
        raise ValueError("MXTPU_SLO_FILE %s: expected a non-empty "
                         "list of objective dicts" % (path,))
    for o in objs:
        if "name" not in o or o.get("kind") not in \
                ("latency", "ratio"):
            raise ValueError("MXTPU_SLO_FILE %s: objective %r needs "
                             "a name and kind in {latency, ratio}"
                             % (path, o))
    return objs


# -- label-subset aggregation over one frame ---------------------------
def _matches(series_labels, want):
    return all(series_labels.get(k) == v for k, v in want.items())


def _agg_hist(frame, name, want):
    """Sum matching histogram series into one stats tuple. Bucket
    edges are uniform within a family (the registry enforces the
    schema), so cumulative buckets add component-wise."""
    fam = frame["metrics"].get(name)
    if fam is None:
        return None
    count, total, buckets = 0, 0.0, None
    for s in fam["series"]:
        if not _matches(s.get("labels", {}), want):
            continue
        count += s["count"]
        total += s["sum"]
        if buckets is None:
            buckets = [[le, c] for le, c in s["buckets"]]
        else:
            for i, (_, c) in enumerate(s["buckets"]):
                buckets[i][1] += c
    if buckets is None:
        return None
    return (count, total, [(le, c) for le, c in buckets])


def _agg_counter(frame, name, want):
    fam = frame["metrics"].get(name)
    if fam is None:
        return None
    vals = [s["value"] for s in fam["series"]
            if _matches(s.get("labels", {}), want)]
    if not vals:
        return None
    return float(sum(vals))


def _window_err_frac(obj, prev, cur):
    """Error fraction of one objective over one (prev, cur) frame
    pair; None when the window saw no relevant traffic."""
    want = obj.get("labels", {})
    if obj["kind"] == "latency":
        cs = _agg_hist(cur, obj["metric"], want)
        if cs is None:
            return None
        ps = _agg_hist(prev, obj["metric"], want)
        if ps is None:
            ps = (0, 0.0, [(le, 0) for le, _ in cs[2]])
        return _timeline.delta_over(ps, cs, float(obj["target_s"]))
    # ratio: err counter delta / total counter delta
    ce = _agg_counter(cur, obj["metric"], want)
    ct = _agg_counter(cur, obj["total_metric"],
                      obj.get("total_labels", {}))
    if ct is None:
        return None
    pe = _agg_counter(prev, obj["metric"], want) or 0.0
    pt = _agg_counter(prev, obj["total_metric"],
                      obj.get("total_labels", {})) or 0.0
    d_tot = ct - pt
    d_err = (ce or 0.0) - pe
    if d_tot <= 0:
        return None
    return max(d_err, 0.0) / d_tot


def _budget(obj):
    if obj["kind"] == "latency":
        return 1.0 - float(obj.get("quantile", 0.99))
    return float(obj["budget"])


_met = _metrics.lazy_metrics(lambda reg: {
    "burn": reg.gauge(
        "mx_slo_burn_rate",
        "error-budget burn rate per objective and window (1.0 = "
        "burning exactly at budget)",
        labelnames=("objective", "window")),
    "err": reg.gauge(
        "mx_slo_error_fraction",
        "windowed error fraction per objective (fast window)",
        labelnames=("objective",)),
    "evals": reg.counter(
        "mx_slo_evaluations_total",
        "SLO tracker evaluation passes").labels(),
})


class SLOTracker:
    """Evaluate declared objectives as fast/slow burn-rate pairs over
    a timeline. Stateless between calls beyond the gauge families it
    publishes; inject ``timeline`` for tests (fake clocks ride the
    timeline's own clock)."""

    def __init__(self, objectives=None, timeline=None,
                 fast_s=DEFAULT_FAST_S, slow_s=DEFAULT_SLOW_S):
        self.objectives = objectives if objectives is not None \
            else load_objectives()
        self._timeline = timeline
        self.fast_s = float(fast_s)
        self.slow_s = float(slow_s)

    @property
    def timeline(self):
        return self._timeline or _timeline.process_timeline()

    def evaluate(self, now=None):
        """One pass: per objective, err-fraction + burn for the fast
        and slow windows, published to the ``mx_slo_*`` gauges.
        Returns the list of result dicts (``burn`` = min(fast, slow),
        None when either window has no data)."""
        tl = self.timeline
        m = _met()
        out = []
        for obj in self.objectives:
            budget = _budget(obj)
            res = {"name": obj["name"], "kind": obj["kind"],
                   "budget": budget, "windows": {}}
            burns = []
            for wname, wsec in (("fast", self.fast_s),
                                ("slow", self.slow_s)):
                prev, cur = tl.bounds(window_s=wsec, now=now)
                frac = None if prev is None else \
                    _window_err_frac(obj, prev, cur)
                burn = None
                if frac is not None and budget > 0:
                    burn = frac / budget
                    m["burn"].labels(objective=obj["name"],
                                     window=wname).set(burn)
                    if wname == "fast":
                        m["err"].labels(objective=obj["name"]
                                        ).set(frac)
                res["windows"][wname] = {"err_frac": frac,
                                         "burn": burn,
                                         "window_s": wsec}
                burns.append(burn)
            res["burn"] = None if None in burns else min(burns)
            out.append(res)
        m["evals"].inc()
        return out

    def burn(self, now=None):
        """The fleet burn: max across objectives of each objective's
        min(fast, slow) burn. None when no objective has data in both
        windows — consumers MUST treat None as 'no signal', not 0."""
        burns = [r["burn"] for r in self.evaluate(now=now)
                 if r["burn"] is not None]
        return max(burns) if burns else None

    def to_doc(self, now=None):
        return {"kind": "slo/v1", "version": 1,
                "fast_s": self.fast_s, "slow_s": self.slow_s,
                "objectives": self.evaluate(now=now)}


_tracker = [None]


def tracker():
    """The shared per-process tracker over the process timeline."""
    if _tracker[0] is None:
        _tracker[0] = SLOTracker()
    return _tracker[0]


def slo_burn(now=None):
    """Fleet burn rate from the process tracker (None = no signal)."""
    return tracker().burn(now=now)
