"""Device-memory attribution: the live-tensor census and the OOM
postmortem (the port of the census and OOM half of
``mxnet_tpu/profiling/memory.py``).

1. **Census**: tensors are tagged with a role (parameter / gradient /
   optimizer_state / io_buffer / kv_cache) by the framework seams
   (gluon parameters, ``attach_grad``, the optimizer ``Updater``, the
   executor's gradients, the sharded train step, the KV block pool)
   through a weak side table: the tag lives next to the tensor, never
   pins it. :func:`live_census` reports bytes by role and by device;
   a tensor laid out over a mesh (``parallel.mesh.Sharded``) reports each
   position's block under that position (``cpu:<position>`` on the CPU,
   ``gpu:<index>`` on a card), so a ZeRO-3 run shows 1/dp of the bytes a
   position, as the JAX census shows per device shard.

   torch keeps no list of live tensors (the JAX census walks
   ``jax.live_arrays()``). So the whole-process census classifies the
   tagged tensors, counting each storage once (a view and its base
   share bytes), and on each CUDA device reports
   ``torch.cuda.memory_allocated(i)`` less the tagged bytes there as
   ``activation``. On the CPU no allocator counts the process's tensors,
   so the whole-process census has no ``activation`` there; with
   ``arrays=`` it classifies exactly the tensors given (untagged ones as
   ``activation``), as the JAX census does.

2. **OOM postmortem**: :func:`maybe_oom_postmortem` at the executor,
   Trainer and sharded-step seams catches an allocation failure
   (``torch.cuda.OutOfMemoryError`` or the JAX package's markers) and
   writes one atomic artifact with the census, each card's
   ``torch.cuda.memory_stats`` and a flight-recorder dump.

3. **Static liveness ledger**: :func:`build_memory_ledger` sweeps the
   buffers of a program into its peak live bytes, the instruction at the
   peak and the ranked table of the buffers live there, each keyed to a
   framework op (and, for a fused cluster, its ``subgraph/`` rule) as
   the cost ledger keys its rows. The program is HLO text (priced as
   the JAX package prices it: def-use intervals over the entry
   computation, donation included) or the port's op trace
   (:mod:`.optrace`): a storage is born at the op that first writes it
   and dies after its last use; a storage the call was given (an input,
   a parameter, an optimizer state) is an ``argument`` live throughout,
   and what the call returns is an ``output`` live to its end. A hand
   kernel's scratch (its plain version's temporaries on the CPU) is not
   a buffer: only what it hands on is. The OOM postmortem carries the
   ranked table when its caller gives the program.

Env: ``MXTPU_MEMORY_CENSUS`` (0 turns tagging and the census collector
off), ``MXTPU_OOM_DUMP_PATH`` (postmortem destination).
"""
from __future__ import annotations

import json
import os
import re
import sys
import time
import weakref

import torch

from . import hlo
from . import ledger as _ledger
from . import optrace as _optrace

CENSUS_VERSION = 1
POSTMORTEM_VERSION = 1

# the role taxonomy; "activation" is whatever nothing tagged
ROLES = ("parameter", "gradient", "optimizer_state", "io_buffer",
         "kv_cache", "activation")

MEMORY_LEDGER_VERSION = 1

# ---------------------------------------------------------------------------
# static liveness ledger
# ---------------------------------------------------------------------------

# opcodes that alias/forward their operand buffers instead of defining
# storage of their own (XLA buffer assignment gives them no allocation)
_FORWARDING = {"tuple", "get-tuple-element", "bitcast",
               "bitcast-convert", "opt-barrier", "after-all"}

_ALIAS_PAIR_RE = re.compile(r"\{\s*(\d*)\s*\}\s*:\s*\(\s*(\d+)\s*[,)]")


def parse_input_output_aliases(hlo_text):
    """{output tuple index: parameter number} donation pairs from the
    HloModule header, e.g.
    ``input_output_alias={ {0}: (0, {}, may-alias), {1}: (1, {}) }``.
    The value is brace-nested, so the span is found by depth scan, not
    regex. Nested output indices ({0,1}) are rare at the entry and
    skipped."""
    start = hlo_text.find("input_output_alias={")
    if start < 0:
        return {}
    i = hlo_text.index("{", start)
    depth = 0
    for j in range(i, min(len(hlo_text), i + 100000)):
        c = hlo_text[j]
        if c == "{":
            depth += 1
        elif c == "}":
            depth -= 1
            if depth == 0:
                body = hlo_text[i + 1:j]
                break
    else:
        return {}
    out = {}
    for oidx, pnum in _ALIAS_PAIR_RE.findall(body):
        out[int(oidx) if oidx else 0] = int(pnum)
    return out


def buffer_intervals(mod, aliases=None):
    """Def-use liveness intervals: of an op trace's buffers when ``mod``
    is an :class:`~.optrace.Trace` (``{buffer name: {"def", "last_use",
    "bytes", "entry", "aliased": False, "kind"}}``, indices into its
    entries), else over the entry computation of an HLO module, as
    follows.

    Returns ``{buffer name: {"def": i, "last_use": j, "bytes": b,
    "instr": Instr, "aliased": bool}}`` where indices are positions in
    the entry instruction list. Forwarding opcodes (tuple / gte /
    bitcast / opt-barrier) resolve through to the defining buffer —
    they own no storage. A fusion's internal producer/consumer buffers
    never appear at all: only entry instructions allocate (the fused
    temporaries live in registers/scratch, which is exactly the HBM
    accounting the cost ledger's bytes column already uses). Donated
    parameters (``aliases``: output index -> parameter number) keep
    the donor parameter live through the aliased output's definition
    and zero the output's own footprint — the output writes into the
    donor's buffer (the reference's inplace pass, compiler-decided).
    """
    if isinstance(mod, _optrace.Trace):
        return _trace_intervals(mod)
    instrs = mod.entry_instructions
    index = {ins.name: i for i, ins in enumerate(instrs)}
    resolve_cache = {}

    def resolve(name):
        """Underlying storage-owning buffer names for ``name``."""
        got = resolve_cache.get(name)
        if got is not None:
            return got
        i = index.get(name)
        if i is None:
            out = ()
        else:
            ins = instrs[i]
            if ins.opcode in _FORWARDING:
                resolve_cache[name] = ()   # cycle guard
                out = []
                for op in ins.operands:
                    out.extend(resolve(op))
                out = tuple(dict.fromkeys(out))
            else:
                out = (name,)
        resolve_cache[name] = out
        return out

    bufs = {}
    end = len(instrs) - 1
    for i, ins in enumerate(instrs):
        if ins.opcode in _FORWARDING:
            continue
        # non-donated argument buffers are owned by the caller and
        # stay resident for the WHOLE execution — live [0, end]
        # regardless of where the parameter instruction sits in the
        # text. They can never be reused for temporaries, which is why
        # memory_analysis() sums argument bytes wholesale. Donation is
        # the exception; the aliased-output bookkeeping below accounts
        # for it.
        first, last = (0, end) if ins.opcode == "parameter" else (i, i)
        bufs[ins.name] = {"def": first, "last_use": last,
                          "bytes": hlo.shape_bytes(ins.shape),
                          "instr": ins, "aliased": False}
    for i, ins in enumerate(instrs):
        for op in ins.operands:
            for name in resolve(op):
                b = bufs.get(name)
                if b is not None and i > b["last_use"]:
                    b["last_use"] = i
    # outputs stay live to the end of the program. is_output marks
    # reachability from the root — a temp merely CONSUMED by the last
    # instruction shares its last_use index but is not an output
    root = next((ins for ins in instrs if ins.is_root), None)
    root_bufs = resolve(root.name) if root is not None else ()
    for name in root_bufs:
        if name in bufs:
            bufs[name]["last_use"] = end
            bufs[name]["is_output"] = True
    # donated params: the aliased output reuses the donor's storage
    if aliases and root is not None:
        # output tuple component k = root's k-th operand when the root
        # is a forwarding tuple, else the root itself for index 0;
        # parameter numbers follow textual order in XLA dumps
        comps = (root.operands if root.opcode == "tuple"
                 else [root.name])
        pnum_order = [ins.name for ins in instrs
                      if ins.opcode == "parameter"]
        for oidx, pnum in aliases.items():
            if oidx >= len(comps) or pnum >= len(pnum_order):
                continue
            donor = pnum_order[pnum]
            for name in resolve(comps[oidx]):
                b = bufs.get(name)
                if b is None or name == donor:
                    continue
                b["aliased"] = True
                b["bytes"] = 0
                d = bufs.get(donor)
                if d is not None and b["def"] > d["last_use"]:
                    d["last_use"] = b["def"]
    return bufs


def _trace_intervals(trace):
    end = max(len(trace.entries) - 1, 0)
    out = {}
    for i, b in enumerate(trace.buffers):
        kind = ("argument" if b["arg"] else "output" if b["out"]
                else "temp")
        first, last = (0, end) if b["arg"] else (b["def"], b["last"])
        out["b%d" % i] = {"def": first, "last_use": last,
                          "bytes": b["bytes"], "entry": b["def"],
                          "aliased": False, "kind": kind}
    return out


def _trace_memory_ledger(trace, rule_map, top):
    if rule_map is None:
        rule_map = _ledger.fusion_rule_map()
    bufs = buffer_intervals(trace)
    n = len(trace.entries)
    peak, peak_i = _sweep_peak(bufs, n)
    totals = {"arg_bytes": 0, "constant_bytes": 0, "output_bytes": 0}
    rows = []
    for name, b in bufs.items():
        if b["kind"] == "argument":
            totals["arg_bytes"] += b["bytes"]
        elif b["kind"] == "output":
            totals["output_bytes"] += b["bytes"]
        if not (b["def"] <= peak_i <= b["last_use"]) or b["bytes"] == 0:
            continue
        e = trace.entries[b["entry"]] if b["kind"] != "argument" \
            and b["entry"] < n else None
        scopes = e["scopes"] if e is not None else ()
        row = {"buffer": name,
               "hlo_op": e["name"] if e is not None else "parameter",
               "op": _ledger.scope_op(scopes[-1]) if scopes else None,
               "bytes": b["bytes"], "kind": b["kind"],
               "born": b["def"], "dies": b["last_use"]}
        rule = _ledger._rule_of(scopes, rule_map)
        if rule:
            row["rule"] = rule
        rows.append(row)
    rows.sort(key=lambda r: (-r["bytes"], r["buffer"]))
    by_op = group_buffers_by_op(rows)
    live_at_peak = len(rows)
    if top is not None:
        rows = rows[:top]
    peak_instr = None
    if 0 <= peak_i < n:
        peak_instr = "%d:%s" % (peak_i, _ledger.trace_row_name(
            trace.entries[peak_i]))
    return {
        "version": MEMORY_LEDGER_VERSION,
        "kind": "memory_ledger",
        "module": trace.module,
        "program": "optrace",
        "device": trace.device,
        "peak_live_bytes": peak,
        "peak_index": peak_i,
        "peak_instr": peak_instr,
        "totals": dict(totals, instructions=n, buffers=len(bufs),
                       live_at_peak=live_at_peak),
        "buffers": rows,
        "by_op": by_op,
    }


def _sweep_peak(bufs, n):
    """(peak_bytes, peak_index) from interval deltas."""
    if n <= 0:
        return 0, 0
    delta = [0] * (n + 1)
    for b in bufs.values():
        delta[b["def"]] += b["bytes"]
        delta[b["last_use"] + 1] -= b["bytes"]
    live = peak = 0
    peak_i = 0
    for i in range(n):
        live += delta[i]
        if live > peak:
            peak = live
            peak_i = i
    return peak, peak_i


def build_memory_ledger(hlo_text, fn_map=None, rule_map=None,
                        module=None, top=None):
    """A memory-ledger document of a program (optimized HLO text or an
    :class:`~.optrace.Trace`): peak live bytes, the instruction at the
    peak, and the ranked table of buffers live at that point, attributed
    to framework ops (and, for fused clusters, the subgraph rule that
    made them: the same channels as the cost ledger)."""
    if isinstance(hlo_text, _optrace.Trace):
        return _trace_memory_ledger(hlo_text, rule_map, top)
    mod = module if module is not None else hlo.parse_module(hlo_text)
    if fn_map is None:
        fn_map = _ledger.framework_fn_map()
    if rule_map is None:
        rule_map = _ledger.fusion_rule_map()
    aliases = parse_input_output_aliases(hlo_text) if hlo_text else {}
    bufs = buffer_intervals(mod, aliases=aliases)
    instrs = mod.entry_instructions
    n = len(instrs)
    peak, peak_i = _sweep_peak(bufs, n)
    rows = []
    arg_bytes = const_bytes = 0
    out_bytes = 0
    for name, b in bufs.items():
        ins = b["instr"]
        if ins.opcode == "parameter":
            arg_bytes += b["bytes"]
        elif ins.opcode == "constant":
            const_bytes += b["bytes"]
        is_out = b.get("is_output") and not b["aliased"] \
            and ins.opcode != "parameter"
        if is_out:
            out_bytes += b["bytes"]
        if not (b["def"] <= peak_i <= b["last_use"]) or b["bytes"] == 0:
            continue
        kind = ("argument" if ins.opcode == "parameter" else
                "constant" if ins.opcode == "constant" else
                "output" if is_out else "temp")
        op = _ledger.attribute_op_name(ins.op_name, fn_map)
        row = {
            "buffer": name,
            "hlo_op": ins.opcode,
            "op": op,
            "bytes": b["bytes"],
            "kind": kind,
            "born": b["def"],
            "dies": b["last_use"],
        }
        rule = rule_map.get(op)
        if rule:
            row["rule"] = rule
        rows.append(row)
    rows.sort(key=lambda r: (-r["bytes"], r["buffer"]))
    # aggregates are computed over the FULL live-at-peak set; `top`
    # bounds only the stored per-buffer table
    by_op = group_buffers_by_op(rows)
    live_at_peak = len(rows)
    if top is not None:
        rows = rows[:top]
    return {
        "version": MEMORY_LEDGER_VERSION,
        "kind": "memory_ledger",
        "module": mod.name,
        "peak_live_bytes": peak,
        "peak_index": peak_i,
        "peak_instr": instrs[peak_i].name if 0 <= peak_i < n else None,
        "totals": {
            "instructions": n,
            "buffers": len(bufs),
            "live_at_peak": live_at_peak,
            "arg_bytes": arg_bytes,
            "constant_bytes": const_bytes,
            "output_bytes": out_bytes,
        },
        "buffers": rows,
        "by_op": by_op,
    }


def group_buffers_by_op(rows):
    """Live-at-peak bytes re-aggregated on the framework-op
    attribution (the ranked answer to "which op's buffers hold the
    HBM at the worst moment")."""
    agg = {}
    for r in rows:
        key = r.get("op") or r["hlo_op"]
        a = agg.setdefault(key, {"op": key, "buffers": 0, "bytes": 0})
        a["buffers"] += 1
        a["bytes"] += r["bytes"]
        if r.get("rule"):
            a["rule"] = r["rule"]
        kinds = a.setdefault("kinds", {})
        kinds[r["kind"]] = kinds.get(r["kind"], 0) + 1
    return sorted(agg.values(), key=lambda a: -a["bytes"])


def from_compiled(compiled, hlo_text=None, args=(), **kwargs):
    """Memory ledger of one call of a compiled program
    (``ledger.program``: an Executor, a hybridized block, a
    ``compile_symbol_forward`` result or a callable, on ``args``),
    traced once; ``hlo_text`` builds it from that text instead, and an
    :class:`~.optrace.Trace` as recorded. The JAX package cross-checks
    XLA's ``memory_analysis`` (``peak_vs_xla``): the port has no second
    count, so the key is absent, as in the JAX document when
    ``memory_analysis`` fails."""
    if hlo_text is not None:
        return build_memory_ledger(hlo_text, **kwargs)
    if isinstance(compiled, _optrace.Trace):
        return build_memory_ledger(compiled, **kwargs)
    trace, _ = _optrace.record(_ledger.program(compiled, args),
                               module=type(compiled).__name__)
    return build_memory_ledger(trace, **kwargs)


def from_fn(fn, *args, **kwargs):
    """Run ``fn(*args)`` once under the op trace and build its memory
    ledger."""
    trace, _ = _optrace.record(fn, *args)
    return build_memory_ledger(trace, **kwargs)


def summarize(doc, top=5):
    """Bounded summary for embedding in bench artifacts."""
    out = {
        "peak_live_mb": round(doc["peak_live_bytes"] / 1e6, 3),
        "peak_instr": doc.get("peak_instr"),
        "top": [{"op": g["op"], "mb": round(g["bytes"] / 1e6, 3)}
                for g in doc.get("by_op", [])[:top]],
    }
    if "peak_vs_xla" in doc:
        out["peak_vs_xla"] = doc["peak_vs_xla"]
    return out


def diff(before, after):
    """Ranked per-op delta of live-at-peak bytes between two memory
    ledgers — the ``memory_report --diff`` payload, mirroring
    ``telemetry_dump --diff`` / ``mfu_report --diff``."""
    def index(doc):
        return {g["op"]: g for g in doc.get("by_op", [])}

    ia, ib = index(before), index(after)
    out = []
    for op in sorted(set(ia) | set(ib)):
        a, b = ia.get(op, {}), ib.get(op, {})
        out.append({
            "op": op,
            "before_bytes": a.get("bytes", 0),
            "after_bytes": b.get("bytes", 0),
            "delta_bytes": b.get("bytes", 0) - a.get("bytes", 0),
        })
    out.sort(key=lambda r: -abs(r["delta_bytes"]))
    return {
        "peak_before": before.get("peak_live_bytes", 0),
        "peak_after": after.get("peak_live_bytes", 0),
        "peak_delta": (after.get("peak_live_bytes", 0)
                       - before.get("peak_live_bytes", 0)),
        "by_op": out,
    }


def load(path):
    with open(path, "r", encoding="utf-8") as f:
        doc = json.load(f)
    if not isinstance(doc, dict) or "peak_live_bytes" not in doc:
        raise ValueError("%s is not a memory-ledger document" % path)
    return doc


def dump(doc, path):
    tmp = "%s.tmp.%d" % (path, os.getpid())
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(doc, f)
    os.replace(tmp, path)
    return doc


# ---------------------------------------------------------------------------
# runtime census
# ---------------------------------------------------------------------------

_census = [os.environ.get("MXTPU_MEMORY_CENSUS", "1") not in (
    "0", "off", "false")]


def census_enabled():
    """MXTPU_MEMORY_CENSUS gate (default on), read once at import: the
    tag seams run per parameter per step."""
    return _census[0]


def set_census_enabled(on):
    _census[0] = bool(on)


# id(tensor) -> (weakref, role). The weakref's callback drops the entry
# when the tensor dies, so the table never pins a tensor or serves a
# recycled id; a tag write is one dict store
_TAGS = {}


def _target(x):
    return getattr(x, "_data", x)


def tag_role(x, role):
    """Tag a tensor (an NDArray, a tensor or a ``Sharded``) with a census
    role. No-op for other leaves and when MXTPU_MEMORY_CENSUS=0."""
    if not census_enabled():
        return x
    data = _target(x)
    if data is None or isinstance(data, (int, float, str)):
        return x
    try:
        key = id(data)
        ref = weakref.ref(data, lambda _r, _k=key: _TAGS.pop(_k, None))
    except TypeError:
        return x  # numpy arrays, scalars: not device memory
    _TAGS[key] = (ref, str(role))
    return x


def tag_tree(tree, role):
    """Tag every leaf of a dict / list / tuple tree (parameters, an
    optimizer state, a batch)."""
    if not census_enabled():
        return tree
    if isinstance(tree, dict):
        for v in tree.values():
            tag_tree(v, role)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            tag_tree(v, role)
    elif tree is not None:
        tag_role(tree, role)
    return tree


def role_of(x):
    """The tagged census role of a tensor, or None."""
    data = _target(x)
    got = _TAGS.get(id(data))
    if got is None:
        return None
    ref, role = got
    return role if ref() is data else None


def _dev_key(device, position=None):
    """The census's device name: ``gpu:<index>`` for a card, and on the
    CPU the mesh position holding the block (``cpu:0`` outside a
    mesh)."""
    if device.type == "cuda":
        return "gpu:%d" % (device.index if device.index is not None
                           else torch.cuda.current_device())
    return "%s:%d" % (device.type, position or 0)


def _blocks(data):
    """[(device key, tensor)] of a census entry: a Sharded value's block
    at each mesh position, else the tensor itself."""
    from ..parallel.mesh import Sharded
    if isinstance(data, Sharded):
        if data.shards is None:     # donated to a step
            return []
        return [(_dev_key(t.device, i), t)
                for i, t in enumerate(data.shards.reshape(-1))
                if isinstance(t, torch.Tensor)]
    if isinstance(data, torch.Tensor):
        return [(_dev_key(data.device), data)]
    return []


def _storage(t):
    st = t.untyped_storage()
    return st.data_ptr(), st.nbytes()


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif tree is not None:
        yield tree


def live_census(arrays=None, top=0):
    """Classify device tensors into roles, per device (see the module
    docstring). ``arrays`` (a list or tree) censuses just those, the way
    the JAX package does; without it, the tagged tensors of the process,
    with each card's untagged allocator bytes as ``activation``. Reads
    sizes and allocator counters only: no sync, no copy."""
    doc = {"version": CENSUS_VERSION, "kind": "memory_census",
           "ts": time.time(), "arrays": 0, "total_bytes": 0,
           "by_role": {}, "by_device": {}}
    if arrays is None:
        if not census_enabled():
            # tagging was off: every tensor would read as activation, so
            # an empty marked document instead of wrong role totals
            doc["disabled"] = True
            return doc
        entries = []
        for ref, role in list(_TAGS.values()):
            data = ref()
            if data is not None:
                entries.append((data, role))
    else:
        entries = [(_target(a), None) for a in _leaves(arrays)]
        entries = [(d, role_of(d) or "activation") for d, _ in entries]
    seen = set()
    tops = []
    for data, role in entries:
        total = 0
        for dkey, t in _blocks(data):
            try:
                ptr, nb = _storage(t)
            except (RuntimeError, NotImplementedError):
                continue   # a tensor without storage (meta, sparse)
            if (dkey, ptr) in seen and ptr:
                continue   # a view of a storage counted already
            seen.add((dkey, ptr))
            d = doc["by_device"].setdefault(
                dkey, {"total_bytes": 0, "by_role": {}})
            d["total_bytes"] += nb
            d["by_role"][role] = d["by_role"].get(role, 0) + nb
            total += nb
        r = doc["by_role"].setdefault(role, {"bytes": 0, "arrays": 0})
        r["bytes"] += total
        r["arrays"] += 1
        doc["arrays"] += 1
        doc["total_bytes"] += total
        if top:
            tops.append((total, {
                "shape": list(getattr(data, "shape", ())),
                "dtype": str(getattr(data, "dtype", "?")).replace(
                    "torch.", ""),
                "role": role, "bytes": total}))
    if arrays is None:
        _activation(doc)
    if top:
        tops.sort(key=lambda t: -t[0])
        doc["top"] = [t[1] for t in tops[:top]]
    return doc


def _activation(doc):
    """Each initialized card's allocated bytes less the tagged bytes on
    it, as ``activation`` (never initializes CUDA)."""
    if not torch.cuda.is_available() or not torch.cuda.is_initialized():
        return
    for i in range(torch.cuda.device_count()):
        dkey = "gpu:%d" % i
        d = doc["by_device"].get(dkey)
        allocated = torch.cuda.memory_allocated(i)
        if d is None:
            if not allocated:
                continue
            d = doc["by_device"][dkey] = {"total_bytes": 0, "by_role": {}}
        act = allocated - d["total_bytes"]
        d["by_role"]["activation"] = d["by_role"].get("activation", 0) \
            + act
        d["total_bytes"] += act
        r = doc["by_role"].setdefault("activation",
                                      {"bytes": 0, "arrays": 0})
        r["bytes"] += act
        doc["total_bytes"] += act


# ---------------------------------------------------------------------------
# OOM postmortem
# ---------------------------------------------------------------------------

_OOM_MARKERS = ("RESOURCE_EXHAUSTED", "Out of memory", "out of memory",
                "Allocation failure", "failed to allocate")
# the short marker only as a standalone word: '/models/BLOOM-7b' in an
# unrelated message must not read as an allocation failure
_OOM_WORD_RE = re.compile(r"\bOOM\b")


def is_oom_error(e):
    """Whether an exception is an allocation failure: a
    ``torch.cuda.OutOfMemoryError``, or a message with the JAX package's
    markers."""
    if e is None:
        return False
    if isinstance(e, torch.cuda.OutOfMemoryError):
        return True
    s = str(e)
    return any(m in s for m in _OOM_MARKERS) or \
        _OOM_WORD_RE.search(s) is not None


def oom_dump_path():
    return os.environ.get("MXTPU_OOM_DUMP_PATH") or "oom_postmortem.json"


_STAT_KEYS = {"bytes_in_use": "allocated_bytes.all.current",
              "peak_bytes_in_use": "allocated_bytes.all.peak",
              "reserved_bytes": "reserved_bytes.all.current",
              "num_alloc_retries": "num_alloc_retries",
              "num_ooms": "num_ooms"}


def _device_stats():
    """Each initialized card's allocator statistics: the JAX package's
    keys (``bytes_in_use``, ``peak_bytes_in_use``, ``bytes_limit``) from
    ``torch.cuda.memory_stats`` and ``mem_get_info``, and the whole
    ``memory_stats`` dict beside them."""
    out = {}
    if not torch.cuda.is_available() or not torch.cuda.is_initialized():
        return out
    for i in range(torch.cuda.device_count()):
        try:
            stats = torch.cuda.memory_stats(i)
            _free, limit = torch.cuda.mem_get_info(i)
        except Exception:  # noqa: BLE001 — per-device support varies
            continue
        row = {k: stats[v] for k, v in _STAT_KEYS.items() if v in stats}
        row["bytes_limit"] = int(limit)
        row["memory_stats"] = dict(stats)
        out["gpu:%d" % i] = row
    return out


def oom_postmortem(error=None, hlo_text=None, compiled=None,
                   source=None, path=None, extra=None):
    """Write the memory artifact: the ranked peak-liveness table (when
    the caller gives the failing program), the census, each card's
    allocator statistics and a flight-recorder dump. Atomic write; every
    section guarded: a postmortem never raises over the OOM it
    documents. The program: ``hlo_text`` (HLO text, an
    :class:`~.optrace.Trace`, or a callable returning either, called
    now) or ``compiled`` (a Trace, or an object with ``as_text()``)."""
    doc = {"version": POSTMORTEM_VERSION, "kind": "oom_postmortem",
           "ts": time.time()}
    if source:
        doc["source"] = str(source)[:120]
    if error is not None:
        doc["error"] = str(error)[:800]
        doc["error_type"] = type(error).__name__
    program = hlo_text
    if program is None and compiled is not None:
        try:
            program = compiled if isinstance(compiled, _optrace.Trace) \
                else compiled.as_text()
        except Exception:  # noqa: BLE001
            pass
    if callable(program):
        try:
            program = program()
        except Exception:  # noqa: BLE001 — tracing again can fail too
            program = None
    if program:
        try:
            led = build_memory_ledger(program)
            led["buffers"] = led["buffers"][:25]
            doc["memory_ledger"] = led
        except Exception as e:  # noqa: BLE001
            doc["memory_ledger_error"] = repr(e)[:200]
    try:
        doc["census"] = live_census(top=10)
    except Exception as e:  # noqa: BLE001
        doc["census_error"] = repr(e)[:200]
    doc["device_stats"] = _device_stats()
    try:
        from ..tracing import flight as _flight
        doc["flight"] = _flight.snapshot(max_spans=10)
    except Exception as e:  # noqa: BLE001
        doc["flight_error"] = repr(e)[:200]
    if extra:
        doc.update(extra)
    path = path or oom_dump_path()
    try:
        tmp = "%s.tmp.%d" % (path, os.getpid())
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(doc, f)
        os.replace(tmp, path)
        doc["path"] = path
    except OSError as e:
        doc["write_error"] = repr(e)[:200]
        print("[mxtpu] OOM postmortem write failed: %r" % (e,),
              file=sys.stderr, flush=True)
    return doc


def maybe_oom_postmortem(error, source=None, hlo_text=None,
                         compiled=None):
    """Seam helper: write a postmortem iff ``error`` is an allocation
    failure; returns the document (None otherwise), so callers just
    re-raise. Repeated OOMs inside one second coalesce into one
    artifact."""
    if error is None or not is_oom_error(error):
        return None
    now = time.monotonic()
    if now - _LAST_POSTMORTEM[0] < 1.0:
        return None
    _LAST_POSTMORTEM[0] = now
    try:
        return oom_postmortem(error=error, source=source,
                              hlo_text=hlo_text, compiled=compiled)
    except Exception as e:  # noqa: BLE001 — never mask the real OOM
        print("[mxtpu] OOM postmortem failed: %r" % (e,),
              file=sys.stderr, flush=True)
        return None


_LAST_POSTMORTEM = [-10.0]
