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

The static liveness ledger of the JAX module (HLO buffer intervals, the
ranked peak-liveness table) waits for its design on ``torch.profiler``:
its functions raise and name ROADMAP queue 1 item 6b-ii, and the
postmortem says so in its ``memory_ledger_pending`` field.

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

CENSUS_VERSION = 1
POSTMORTEM_VERSION = 1

# the role taxonomy; "activation" is whatever nothing tagged
ROLES = ("parameter", "gradient", "optimizer_state", "io_buffer",
         "kv_cache", "activation")

_LEDGER_PENDING = ("the liveness ledger waits for its port on "
                   "torch.profiler (ROADMAP queue 1 item 6b-ii)")


def _pending_ledger(name):
    def fn(*args, **kwargs):
        raise NotImplementedError("profiling.memory.%s: %s"
                                  % (name, _LEDGER_PENDING))
    fn.__name__ = name
    fn.__doc__ = "Raises: %s." % _LEDGER_PENDING
    return fn


buffer_intervals = _pending_ledger("buffer_intervals")
build_memory_ledger = _pending_ledger("build_memory_ledger")
from_compiled = _pending_ledger("from_compiled")
from_fn = _pending_ledger("from_fn")
summarize = _pending_ledger("summarize")
diff = _pending_ledger("diff")
load = _pending_ledger("load")
dump = _pending_ledger("dump")

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
    """Write the memory artifact: the census, each card's allocator
    statistics and a flight-recorder dump. Atomic write; every section
    guarded: a postmortem never raises over the OOM it documents.
    ``hlo_text`` / ``compiled`` are accepted for the JAX package's
    signature; the ranked peak-liveness table they feed waits for
    ROADMAP queue 1 item 6b-ii (``memory_ledger_pending``)."""
    doc = {"version": POSTMORTEM_VERSION, "kind": "oom_postmortem",
           "ts": time.time()}
    if source:
        doc["source"] = str(source)[:120]
    if error is not None:
        doc["error"] = str(error)[:800]
        doc["error_type"] = type(error).__name__
    doc["memory_ledger_pending"] = _LEDGER_PENDING
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
