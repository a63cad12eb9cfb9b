"""The cost ledger: per-op FLOPs, bytes and roofline, keyed back to
framework ops (the port of ``mxnet_tpu/profiling/ledger.py``, with its
document schema: ``version``, ``kind: "cost_ledger"``, ``totals``,
``rows``, ``by_op``, and per row ``bound`` and, for a fused cluster,
``rule``).

Two programs price into one schema:

- **HLO text** (:mod:`.hlo`, the JAX package's parser copied): each
  entry instruction a row, attributed through its ``op_name`` metadata
  exactly as the JAX package attributes it (``mx.<Name>`` scopes,
  ``jit(<registered fn>)``, else the leaf primitive);
- **the port's op trace** (:mod:`.optrace`): what one call of a port
  program dispatched. A row is a scope instance (``<op>#<k>``, its
  gradient ``<op>#<k>.bwd``) with the aten ops it ran summed, and
  ``hlo_op`` the costliest of them; a hand kernel's call is a row of
  its own (``<scope>/<kernel>``, ``hlo_op`` the kernel) with the
  function's own count; aten ops outside any scope sum into one row per
  aten op name, attributed to that name (the JAX ledger's leaf
  primitive). The row name is the join key :mod:`.capture` matches
  measured time on.

A fused cluster of the ``subgraph/`` fleet (``_sg_xla_*``) attributes to
its rule (``fusion_rule_map``). Every row gets a roofline class against
``MXTPU_PEAK_TFLOPS`` / ``MXTPU_PEAK_HBM_GBS``, whose defaults here are
an H100 SXM's: 989 TFLOP/s (bf16 dense) and 3350 GB/s; an fp32 program
without TF32 is priced at 67 (``peak_tflops=67``).
"""
from __future__ import annotations

import json
import os
import re

from . import hlo
from . import optrace

LEDGER_VERSION = 1

# H100 SXM: bf16 dense tensor-core rate and device-memory bandwidth
_DEF_PEAK_TFLOPS = 989.0
_DEF_PEAK_HBM_GBS = 3350.0

_JIT_SCOPE = re.compile(r"^jit\(([^)]*)\)$")


def _peaks(peak_tflops=None, peak_hbm_gbs=None):
    if peak_tflops is None:
        peak_tflops = float(os.environ.get("MXTPU_PEAK_TFLOPS",
                                           _DEF_PEAK_TFLOPS))
    if peak_hbm_gbs is None:
        peak_hbm_gbs = float(os.environ.get("MXTPU_PEAK_HBM_GBS",
                                            _DEF_PEAK_HBM_GBS))
    return peak_tflops, peak_hbm_gbs


def framework_fn_map():
    """{python fn name: canonical op name} over the port's op registry
    (an op's canonical name is the one it was registered under)."""
    from ..ops import registry as _reg
    return {op.fn.__name__: op.name
            for op in {id(o): o for o in _reg._OPS.values()}.values()}


def fusion_rule_map():
    """{fused op name: "backend/rule"} over the port's ``subgraph/``
    fleet (e.g. ``{"_sg_xla_conv": "XLA/conv_bn_add_relu"}``)."""
    from .. import subgraph  # noqa: F401 — registers the fleet
    from ..subgraph import partition as _part
    out = {}
    for backend, prop in _part._PROPERTIES.items():
        props = prop if isinstance(prop, (list, tuple)) else (prop,)
        for p in props:
            rule = getattr(p, "rule_name", None)
            out[p.op_name] = ("%s/%s" % (backend, rule) if rule
                             else backend)
    return out


def attribute_op_name(op_name_path, fn_map):
    """Framework op for a JAX metadata ``op_name`` path: the rightmost
    ``mx.<Name>`` scope or ``jit(<registered fn>)`` component, else the
    leaf primitive name."""
    if not op_name_path:
        return None
    parts = op_name_path.split("/")
    for part in reversed(parts):
        if part.startswith("mx."):
            return part[3:]
        m = _JIT_SCOPE.match(part)
        if m and m.group(1) in fn_map:
            return fn_map[m.group(1)]
    leaf = parts[-1]
    return leaf.split("[", 1)[0] or None


def scope_op(instance):
    """The framework op of a scope instance: ``"FullyConnected#3.bwd"``
    -> ``"FullyConnected"``."""
    if instance is None:
        return None
    if instance.endswith(".bwd"):
        instance = instance[:-4]
    return instance.rsplit("#", 1)[0]


def _bound(flops, nbytes, peak_fs, peak_bs, comms=False):
    t_flops = flops / peak_fs
    t_bytes = nbytes / peak_bs
    if comms:
        b = "comms"
    elif flops == 0 and nbytes == 0:
        b = "trivial"
    elif t_flops >= t_bytes:
        b = "compute"
    else:
        b = "hbm"
    return max(t_flops, t_bytes), b


def build_ledger(program, peak_tflops=None, peak_hbm_gbs=None,
                 fn_map=None, rule_map=None, module=None):
    """Price a program into a ledger document: ``program`` is optimized
    HLO text (priced as the JAX package prices it) or an
    :class:`~.optrace.Trace`."""
    if isinstance(program, optrace.Trace):
        return _trace_ledger(program, peak_tflops, peak_hbm_gbs, rule_map)
    peak_tflops, peak_hbm_gbs = _peaks(peak_tflops, peak_hbm_gbs)
    mod = module if module is not None else hlo.parse_module(program)
    if fn_map is None:
        fn_map = framework_fn_map()
    if rule_map is None:
        rule_map = fusion_rule_map()
    peak_fs = peak_tflops * 1e12
    peak_bs = peak_hbm_gbs * 1e9
    rows = []
    for instr in mod.entry_instructions:
        flops, nbytes = hlo.instr_cost(instr, mod)
        if instr.opcode in hlo.TRIVIAL_OPCODES:
            continue
        est_s, bound = _bound(flops, nbytes, peak_fs, peak_bs,
                              hlo.is_comms(instr))
        op = attribute_op_name(instr.op_name, fn_map)
        row = {"instr": instr.name, "hlo_op": instr.opcode, "op": op,
               "flops": flops, "bytes": nbytes, "est_s": est_s,
               "bound": bound}
        rule = rule_map.get(op)
        if rule:
            row["rule"] = rule
        rows.append(row)
    return _document(mod.name, rows, peak_tflops, peak_hbm_gbs)


def _document(module, rows, peak_tflops, peak_hbm_gbs):
    tot_f = tot_b = tot_t = 0
    for r in rows:      # in program order, as the JAX package sums
        tot_f += r["flops"]
        tot_b += r["bytes"]
        tot_t += r["est_s"]
    rows.sort(key=lambda r: -r["est_s"])
    return {
        "version": LEDGER_VERSION,
        "kind": "cost_ledger",
        "module": module,
        "peak_tflops": peak_tflops,
        "peak_hbm_gbs": peak_hbm_gbs,
        "totals": {"flops": tot_f, "bytes": tot_b, "est_s": tot_t,
                   "rows": len(rows)},
        "rows": rows,
        "by_op": group_by_op(rows, peak_tflops, peak_hbm_gbs),
    }


def _rule_of(scopes, rule_map):
    for s in reversed(scopes):
        rule = rule_map.get(scope_op(s))
        if rule:
            return rule
    return None


def trace_row_name(entry):
    """The ledger row (join key) an op-trace entry sums into."""
    scopes = entry["scopes"]
    sc = scopes[-1] if scopes else None
    if entry["kernel"]:
        return "%s/%s" % (sc, entry["name"]) if sc else entry["name"]
    return sc or entry["name"]


def _trace_ledger(trace, peak_tflops, peak_hbm_gbs, rule_map):
    peak_tflops, peak_hbm_gbs = _peaks(peak_tflops, peak_hbm_gbs)
    if rule_map is None:
        rule_map = fusion_rule_map()
    peak_fs = peak_tflops * 1e12
    peak_bs = peak_hbm_gbs * 1e9
    acc = {}
    for e in trace.entries:
        name = trace_row_name(e)
        a = acc.get(name)
        if a is None:
            scopes = e["scopes"]
            a = acc[name] = {
                "instr": name, "op": scope_op(scopes[-1]) if scopes
                else None, "flops": 0, "bytes": 0, "calls": 0,
                "_by": {}, "_rule": _rule_of(scopes, rule_map)}
        a["flops"] += e["flops"]
        a["bytes"] += e["bytes"]
        a["calls"] += 1
        est, _ = _bound(e["flops"], e["bytes"], peak_fs, peak_bs)
        a["_by"][e["name"]] = a["_by"].get(e["name"], 0.0) + est
    rows = []
    for a in acc.values():
        by, rule = a.pop("_by"), a.pop("_rule")
        a["hlo_op"] = max(by, key=lambda k: (by[k], k))
        a["est_s"], a["bound"] = _bound(a["flops"], a["bytes"], peak_fs,
                                        peak_bs)
        if rule:
            a["rule"] = rule
        rows.append(a)
    doc = _document(trace.module, rows, peak_tflops, peak_hbm_gbs)
    doc["program"] = "optrace"
    doc["device"] = trace.device
    doc["totals"]["ops"] = len(trace.entries)
    return doc


def group_by_op(rows, peak_tflops=None, peak_hbm_gbs=None):
    """Ledger rows re-aggregated on the framework-op attribution; the
    group's roofline bound is recomputed from its summed flops and
    bytes."""
    peak_tflops, peak_hbm_gbs = _peaks(peak_tflops, peak_hbm_gbs)
    agg = {}
    comms = set()
    for r in rows:
        key = r.get("op") or r["hlo_op"]
        a = agg.setdefault(key, {
            "op": key, "instrs": 0, "flops": 0, "bytes": 0,
            "est_s": 0.0})
        a["instrs"] += 1
        a["flops"] += r["flops"]
        a["bytes"] += r["bytes"]
        a["est_s"] += r["est_s"]
        if r.get("rule"):
            a["rule"] = r["rule"]
        if r["bound"] == "comms":
            comms.add(key)
    out = sorted(agg.values(), key=lambda a: -a["est_s"])
    for a in out:
        if a["op"] in comms:
            a["bound"] = "comms"
        elif a["flops"] == 0 and a["bytes"] == 0:
            a["bound"] = "trivial"
        else:
            a["bound"] = ("compute"
                          if a["flops"] / (peak_tflops * 1e12)
                          >= a["bytes"] / (peak_hbm_gbs * 1e9)
                          else "hbm")
    return out


def program(compiled, args=()):
    """A callable running one call of what the port compiles to: an
    ``Executor`` (its bound forward), a ``predictor.compile_symbol_forward``
    result ``(fn, param_vals)`` (on ``args``), or a block or any
    callable (on ``args``)."""
    from ..executor import Executor
    if isinstance(compiled, Executor):
        return lambda: compiled.forward(is_train=False)
    if isinstance(compiled, tuple) and len(compiled) == 2 \
            and callable(compiled[0]):
        fn, vals = compiled
        return lambda: fn(vals, *args)
    if callable(compiled):
        return lambda: compiled(*args)
    raise TypeError("cannot trace a %s: give an Executor, a hybridized "
                    "block, a compile_symbol_forward result or a callable"
                    % type(compiled).__name__)


def from_compiled(compiled, hlo_text=None, args=(), **kwargs):
    """Ledger of one call of a compiled program (see :func:`program`),
    traced once; ``hlo_text`` prices that text instead, and an
    :class:`~.optrace.Trace` prices as recorded. The JAX package folds in
    XLA's ``cost_analysis`` as ``flops_vs_xla``: the port has no such
    second count, so the key is absent (as in the JAX document when
    ``cost_analysis`` fails)."""
    if hlo_text is not None:
        return build_ledger(hlo_text, **kwargs)
    if isinstance(compiled, optrace.Trace):
        return build_ledger(compiled, **kwargs)
    trace, _ = optrace.record(program(compiled, args),
                              module=type(compiled).__name__)
    return build_ledger(trace, **kwargs)


def from_fn(fn, *args, **kwargs):
    """Run ``fn(*args)`` once under the op trace and price it."""
    trace, _ = optrace.record(fn, *args)
    return build_ledger(trace, **kwargs)


def mfu_estimate(doc, items_per_step=None, step_s=None):
    """Cost-model MFU numbers from a ledger document alone:
    ``mfu_at_roofline`` (flops_total / (est_s * peak)), with ``step_s``
    ``mfu_measured``, with ``items_per_step`` ``gflops_per_item``."""
    peak_fs = doc["peak_tflops"] * 1e12
    flops = doc["totals"]["flops"]
    est_s = doc["totals"]["est_s"]
    out = {"flops_total": flops,
           "gflops_total": round(flops / 1e9, 3),
           "est_step_s": round(est_s, 6),
           "mfu_at_roofline": round(flops / (est_s * peak_fs), 4)
           if est_s > 0 else 0.0}
    if items_per_step:
        out["gflops_per_item"] = round(flops / items_per_step / 1e9, 3)
    if step_s:
        out["mfu_measured"] = round(flops / (step_s * peak_fs), 4)
    return out


def summarize(doc, top=10):
    """Bounded summary for embedding in bench artifacts: the MFU
    estimate and the top-N by_op rows."""
    est = mfu_estimate(doc)
    rows = []
    tot_t = doc["totals"]["est_s"] or 1e-30
    for a in doc.get("by_op", [])[:top]:
        rows.append({
            "op": a["op"],
            "gflops": round(a["flops"] / 1e9, 3),
            "mb": round(a["bytes"] / 1e6, 3),
            "est_ms": round(a["est_s"] * 1e3, 4),
            "share": round(a["est_s"] / tot_t, 4),
            "bound": a.get("bound", "?"),
        })
    out = {"mfu_at_roofline": est["mfu_at_roofline"],
           "gflops_total": est["gflops_total"],
           "est_step_s": est["est_step_s"],
           "top": rows}
    if "flops_vs_xla" in doc:
        out["flops_vs_xla"] = doc["flops_vs_xla"]
    return out


def diff(before, after):
    """Ranked per-op delta between two ledger (or attribution)
    documents: the ``mfu_report --diff`` payload."""
    def index(doc):
        return {a["op"]: a for a in doc.get("by_op", [])}

    ia, ib = index(before), index(after)
    out = []
    for op in sorted(set(ia) | set(ib)):
        a = ia.get(op, {})
        b = ib.get(op, {})
        ta = a.get("measured_s", a.get("est_s", 0.0))
        tb = b.get("measured_s", b.get("est_s", 0.0))
        out.append({
            "op": op,
            "before_s": ta, "after_s": tb, "delta_s": tb - ta,
            "before_flops": a.get("flops", 0),
            "after_flops": b.get("flops", 0),
        })
    out.sort(key=lambda r: -abs(r["delta_s"]))
    return out


def load(path):
    with open(path, "r", encoding="utf-8") as f:
        doc = json.load(f)
    if not isinstance(doc, dict) or "rows" not in doc or \
            "totals" not in doc:
        raise ValueError("%s is not a ledger document" % path)
    return doc


def dump(doc, path):
    tmp = "%s.tmp.%d" % (path, os.getpid())
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(doc, f)
    os.replace(tmp, path)
    return doc
