"""Capture harness: measured per-op time joined onto the cost ledger (the
port of ``mxnet_tpu/profiling/capture.py``, with its ``mfu_attribution``
document: ``measured``, ``reconciliation``, ``reconciled``, ``mfu`` and
the explicit ``_unattributed`` row).

:func:`attribution_run`:

1. prices one call of the step (``ledger.from_fn``: the op trace; that
   call runs the step once), then a warm step;
2. ``telemetry.step.reset``, then N steps under ``torch.profiler`` with
   the op scopes on (:class:`~.optrace.capturing`), a ``step_boundary``
   per step and the card synchronized at each (as the JAX harness blocks
   on each step's outputs), each step between two CUDA events;
3. reads the exported Kineto trace (:mod:`.xplane`) and joins measured
   time onto the ledger rows: the join key is the row's scope instance
   (``<op>#<k>``, its backward ``<op>#<k>.bwd``, a hand kernel
   ``<op>#<k>/<kernel>``), counted from 0 again at every step;
4. reconciles: the device window per step (the union of the card's
   kernel, memcpy and memset events; on the CPU, of the step threads'
   CPU ops) against the telemetry step time, ``reconciled`` at >= 90%.

torch.profiler loses records on the H100 and misstates late durations,
so the document says what it saw against what ran: ``lost`` compares
each hand kernel's events in the trace with its wrapper's ``launches``
delta, and on a card ``reconciliation`` adds the CUDA-event step time
(``device_step_s``) and the window's share of it (``device_ratio``),
which can exceed 1 only if the profiler claims more device time than
the step took. :func:`join` of a ledger whose program ran on the card
with a capture that holds no kernel event raises (in
:func:`attribution_run`, :func:`analyze_dir` and
``profiler.op_attribution`` alike): there is no fallback.
"""
from __future__ import annotations

import os
import re
import tempfile
import time

import torch

from ..base import MXNetError
from . import ledger, optrace, xplane

ATTRIBUTION_VERSION = 1

# each hand kernel's wrapper: (module, function, the kernel names of one
# launch's counted kernel; the other passes of a launch are not counted)
_KERNELS = (
    ("attention", "flash_attention",
     re.compile(r"flash_attention(_bf16)?_kernel")),
    ("attention", "flash_attention_bwd", re.compile(r"dq_(f32|bf16)_kernel")),
    ("attention", "paged_attention",
     re.compile(r"paged_attention(_bf16)?_kernel")),
    ("int8", "int8_conv_epilogue", re.compile(r"int8_epilogue_kernel")),
    ("fused_opt", "fused_sgd_mom", re.compile(r"(^|[\s:])sgd_mom<")),
    ("fused_opt", "fused_adam", re.compile(r"(^|[\s:])adam<")),
)


def profile_dir_default():
    return os.environ.get("MXTPU_PROFILE_DIR") or os.path.join(
        tempfile.gettempdir(), "mxtpu_profile")


def _telemetry_step_total():
    """(sum_s, count) of completed telemetry step intervals; zeros when
    telemetry is off."""
    from .. import telemetry
    snap = telemetry.snapshot()["metrics"]
    fam = snap.get("mx_step_time_seconds", {"series": []})
    for s in fam["series"]:
        return float(s.get("sum", 0.0)), int(s.get("count", 0))
    return 0.0, 0


def kernel_launches():
    """{wrapper: launches so far} of the hand kernels (float32 and
    bfloat16 counts summed)."""
    import importlib
    out = {}
    for mod, fn, _ in _KERNELS:
        f = getattr(importlib.import_module("mxnet_tpu_torch.ops." + mod),
                    fn)
        out[fn] = getattr(f, "launches", 0) + getattr(f, "launches_bf16", 0)
    return out


def _sync(cuda):
    if cuda:
        torch.cuda.synchronize()


def attribution_run(step_fn, args=(), steps=3, profile_dir=None,
                    items_per_step=None, source="profiling", warmup=True):
    """Run ``step_fn(*args)`` ``steps`` times under capture and return
    the joined attribution document (see the module docstring). When the
    step returns a tuple whose prefix is shaped like ``args``, its
    outputs feed the next step."""
    from ..telemetry import step as _tstep

    if profile_dir is None:
        profile_dir = os.path.join(profile_dir_default(),
                                   "attrib_%d" % os.getpid())
    os.makedirs(profile_dir, exist_ok=True)
    trace, out = optrace.record(step_fn, *args)
    doc = ledger.build_ledger(trace)
    cuda = trace.device == "cuda"
    cur = _thread(tuple(args), out)
    if warmup:
        cur = _thread(cur, step_fn(*cur))
    _sync(cuda)
    _tstep.reset()
    base_sum, _ = _telemetry_step_total()
    launches0 = kernel_launches()
    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    marks = []
    wall0 = time.perf_counter()
    with optrace.capturing(), torch.profiler.profile(activities=acts) as prof:
        _tstep.step_boundary(source=source)  # opens the first interval
        for _ in range(steps):
            if cuda:
                ev = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
                ev[0].record()
            cur = _thread(cur, step_fn(*cur))
            if cuda:
                ev[1].record()
                marks.append(ev)
            _sync(cuda)
            _tstep.step_boundary(source=source)
    wall_s = time.perf_counter() - wall0
    launched = {k: v - launches0[k] for k, v in kernel_launches().items()}
    tele_sum, _ = _telemetry_step_total()
    step_wall_s = tele_sum - base_sum
    if step_wall_s <= 0:
        step_wall_s = wall_s    # telemetry off: the harness's wall clock
    path = os.path.join(profile_dir, "mxtpu_%d_%d.pt.trace.json"
                        % (os.getpid(), int(time.time() * 1e6)))
    prof.export_chrome_trace(path)
    planes = xplane.load_xspace(path)
    device_step_s = (sum(a.elapsed_time(b) for a, b in marks) / 1e3
                     if marks else None)
    got = join(doc, planes, step_wall_s=step_wall_s, steps=steps,
               items_per_step=items_per_step, profile_dir=profile_dir,
               device_step_s=device_step_s)
    got["profile_file"] = path
    got["lost"] = lost_records(planes, launched)
    return got


def lost_records(planes, launched):
    """Each hand kernel's events in the capture (its counted kernel, by
    the device's own event names) against its wrapper's launches in the
    same window: ``{wrapper: {"launches", "events", "lost"}}`` for the
    kernels that launched or left events."""
    counts = dict.fromkeys(launched, 0)
    for plane in planes:
        for name, n in plane.get("device_event_counts", {}).items():
            for _, fn, pat in _KERNELS:
                if pat.search(name):
                    counts[fn] += n
                    break
    out = {}
    for fn, n in launched.items():
        if n or counts[fn]:
            out[fn] = {"launches": n, "events": counts[fn],
                       "lost": n - counts[fn]}
    return out


def _thread(cur, out):
    """Thread a step's outputs back as the next step's inputs when the
    step returns a tuple whose prefix matches its inputs in type and
    shape (``step(params, moms, ...) -> (params, moms, loss)``)."""
    if not isinstance(out, tuple) or not cur:
        return cur
    n = min(len(out), len(cur))
    k = 0
    while k < n and _like(out[k], cur[k]):
        k += 1
    return tuple(out[:k]) + tuple(cur[k:])


def _like(a, b):
    if type(a) is not type(b):
        return False
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_like(x, y) for x, y in zip(a, b))
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_like(a[k], b[k]) for k in a)
    return getattr(a, "shape", None) == getattr(b, "shape", None) and \
        getattr(a, "dtype", None) == getattr(b, "dtype", None)


def join(ledger_doc, planes, step_wall_s=None, steps=None,
         items_per_step=None, profile_dir=None, device_step_s=None):
    """Join measured times onto a ledger document, on its row names (the
    JAX package's join: one nanosecond of device time lands on exactly
    one row; the interval union, not the row sum, reconciles against
    the step time). ``device_step_s`` (the CUDA-event time of all the
    steps) adds ``device_step_s`` / ``device_ratio`` per step."""
    if ledger_doc.get("device") == "cuda" and not any(
            p["name"].startswith("/device:GPU") for p in planes):
        raise MXNetError(
            "the program ran on the card but its capture holds no kernel "
            "event (no /device:GPU plane): nothing to attribute")
    names = {row["instr"] for row in ledger_doc["rows"]}
    measured = xplane.measure_ops(planes, names)
    per_step = float(steps) if steps else 1.0
    peak_fs = ledger_doc["peak_tflops"] * 1e12
    peak_bs = ledger_doc["peak_hbm_gbs"] * 1e9
    rows = []
    attributed_s = 0.0
    for row in ledger_doc["rows"]:
        m = measured["ops"].get(row["instr"])
        out = dict(row)
        if m:
            self_s = m["self_s"] / per_step
            out["measured_s"] = self_s
            out["measured_count"] = m["count"]
            attributed_s += self_s
            if self_s > 0:
                achieved_fs = row["flops"] / self_s
                achieved_bs = row["bytes"] / self_s
                out["mfu"] = round(achieved_fs / peak_fs, 4)
                out["hbm_util"] = round(achieved_bs / peak_bs, 4)
                out["bound_measured"] = (
                    "comms" if row["bound"] == "comms" else
                    "compute" if achieved_fs / peak_fs
                    >= achieved_bs / peak_bs else "hbm")
        rows.append(out)
    rows.sort(key=lambda r: -(r.get("measured_s", 0.0)
                              or r.get("est_s", 0.0)))
    covered_per_step = measured["covered_s"] / per_step
    window_per_step = measured["window_s"] / per_step
    unattributed = max(window_per_step - covered_per_step, 0.0)
    doc = dict(ledger_doc)
    doc["kind"] = "mfu_attribution"
    doc["version"] = ATTRIBUTION_VERSION
    doc["rows"] = rows
    by_op = _merge_measured(doc, rows)
    if unattributed > 0:
        # busy time no named event claims: an explicit row, never silence
        by_op.append({
            "op": "_unattributed", "instrs": 0, "flops": 0, "bytes": 0,
            "est_s": 0.0, "bound": "?",
            "measured_s": round(unattributed, 6)})
        by_op.sort(key=lambda g: -(g.get("measured_s", 0.0)
                                   or g.get("est_s", 0.0)))
    doc["by_op"] = by_op
    doc["measured"] = {
        "steps": steps,
        "matched_events": measured["matched_events"],
        "named_s_per_step": round(covered_per_step, 6),
        "attributed_s_per_step": round(attributed_s, 6),
        "device_window_s_per_step": round(window_per_step, 6),
        "unattributed_s_per_step": round(unattributed, 6),
    }
    if profile_dir:
        doc["profile_dir"] = profile_dir
    if step_wall_s:
        per_step_wall = step_wall_s / per_step
        rec = {
            "step_wall_s": round(per_step_wall, 6),
            # the table's total claim on the step: named rows plus the
            # explicit _unattributed row = the busy window
            "attributed_s": round(window_per_step, 6),
            "named_s": round(covered_per_step, 6),
            "ratio": round(window_per_step / per_step_wall, 4)
            if per_step_wall > 0 else 0.0,
            "idle_s": round(max(per_step_wall - window_per_step, 0.0), 6),
        }
        if device_step_s:
            dev = device_step_s / per_step
            rec["device_step_s"] = round(dev, 6)
            rec["device_ratio"] = round(window_per_step / dev, 4)
        doc["reconciliation"] = rec
        doc["reconciled"] = rec["ratio"] >= 0.9
        doc["mfu"] = round(doc["totals"]["flops"]
                           / (per_step_wall * peak_fs), 4)
        if items_per_step:
            doc["items_per_s"] = round(items_per_step / per_step_wall, 2)
    return doc


def _merge_measured(doc, rows):
    """by_op regrouped with measured seconds and measured MFU."""
    groups = ledger.group_by_op(
        [{k: r[k] for k in ("op", "hlo_op", "flops", "bytes", "est_s",
                            "bound") if k in r} | (
            {"rule": r["rule"]} if r.get("rule") else {})
         for r in rows],
        doc["peak_tflops"], doc["peak_hbm_gbs"])
    meas = {}
    for r in rows:
        if "measured_s" in r:
            key = r.get("op") or r["hlo_op"]
            meas[key] = meas.get(key, 0.0) + r["measured_s"]
    peak_fs = doc["peak_tflops"] * 1e12
    for g in groups:
        if g["op"] in meas:
            g["measured_s"] = round(meas[g["op"]], 6)
            if g["measured_s"] > 0:
                g["mfu"] = round(
                    g["flops"] / g["measured_s"] / peak_fs, 4)
    groups.sort(key=lambda g: -(g.get("measured_s", 0.0)
                                or g.get("est_s", 0.0)))
    return groups


def analyze_dir(profile_dir, compiled=None, hlo_text=None,
                step_wall_s=None, steps=None, args=(), **kwargs):
    """Join an existing capture (a directory's newest capture file, or a
    file) against a ledger: ``compiled`` is a ledger document, an
    :class:`~.optrace.Trace`, or a program ``ledger.from_compiled``
    traces once (on ``args``); ``hlo_text`` prices that HLO text."""
    if isinstance(compiled, dict) and "rows" in compiled:
        doc = compiled
    elif compiled is not None:
        doc = ledger.from_compiled(compiled, args=args, **kwargs)
    elif hlo_text is not None:
        doc = ledger.build_ledger(hlo_text, **kwargs)
    else:
        raise ValueError("analyze_dir needs compiled= or hlo_text=")
    planes = xplane.load_xspace(profile_dir)
    return join(doc, planes, step_wall_s=step_wall_s, steps=steps,
                profile_dir=profile_dir)
