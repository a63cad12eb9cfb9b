"""The layout plane: one mesh-first sharding vocabulary (counterpart of
``mxnet_tpu/parallel/layout.py``).

:class:`SpecLayout` keys :class:`~.mesh.PartitionSpec` entries by
parameter *role* — ``embedding`` / ``attention-qkv`` /
``attention-out`` / ``mlp-in`` / ``mlp-out`` / ``norm`` / ``bias`` —
over the axes ``data`` / ``fsdp`` / ``tp``, in the framework's
``(out_units, in_units)`` weight convention: ``mlp-in`` and
``attention-qkv`` are column-parallel (output features over ``tp``),
``mlp-out`` and ``attention-out`` row-parallel (the contraction dim
over ``tp``: one all-reduce on use), the embedding and the output head
vocab-sharded.

- Any parameter name resolves to a role through an ordered regex rule
  list; a model can pin exceptions first (``overrides``), by name or
  regex, to a role or to a literal spec.
- A spec is a request: :func:`_fit_spec` drops the axes the mesh does
  not carry, axes already used by an earlier dim and axes whose size
  does not divide the dim, so one table resolves on any mesh.
- :func:`zero_shard_leaf` and :meth:`SpecLayout.zero_specs` spell the
  cross-replica weight-update (ZeRO) sharding; :func:`collective_shardings`
  the stacked-input / replicated-output pair of a process-mesh reducer.

The JSON of a table (:meth:`SpecLayout.to_json`) is the JAX package's:
a layout file written by either package loads in the other.
:func:`collectives_summary` counts the collectives a program issues, by
kind, with the bytes they move, in the JAX document: from the port's own
run (a mesh's or a sharded train step's last call) or from HLO text.
"""
from __future__ import annotations

import json
import re

import numpy as np
import torch

from ..base import MXNetError, get_env
from .mesh import NamedSharding, PartitionSpec as P, entry_axes

AXES = ("data", "fsdp", "tp")

#: the role vocabulary; "default" is the replicated catch-all every
#: unmatched parameter lands on
ROLES = ("embedding", "attention-qkv", "attention-out", "mlp-in",
         "mlp-out", "norm", "bias", "default")

# role -> spec template over logical axis names, in the framework's
# (out_units, in_units) weight convention. Entries: None = replicated
# dim, str = one axis, tuple = multiple axes on one dim.
_DEFAULT_TABLE = {
    # (vocab, d_model): vocab over fsdp x tp — the output head resolves
    # here too, making logits column-parallel (see _DEFAULT_RULES)
    "embedding": (("fsdp", "tp"), None),
    # column-parallel: output features over tp, fsdp on the in dim
    "attention-qkv": ("tp", "fsdp"),
    # row-parallel: contraction dim over tp (one all-reduce on use)
    "attention-out": ("fsdp", "tp"),
    "mlp-in": ("tp", "fsdp"),
    "mlp-out": ("fsdp", "tp"),
    "norm": (),
    "bias": (),
    "default": (),
}

# ordered (regex, role) fallback rules, matched with re.search on the
# "/"-joined lowercased leaf path. First match wins; order matters (norm
# parameters before the bias catch-all, qkv before the generic dense
# rule).
_DEFAULT_RULES = (
    (r"(ln|layer_?norm|batch_?norm|group_?norm|norm)\w*_"
     r"(g(amma)?|b(eta)?)$", "norm"),
    (r"running_(mean|var)$", "norm"),
    (r"(_b|_?bias)$", "bias"),
    (r"embed\w*(_w(eight)?)?$|embedding", "embedding"),
    (r"(qkv|query|q_proj|k_proj|v_proj)\w*(_w(eight)?)?$",
     "attention-qkv"),
    # the MLP rules sit above attention-out: its bare "proj" alternative
    # would otherwise shadow up_proj / gate_proj / down_proj (LLaMA
    # naming) into row-parallel specs
    (r"(ff1|fc1|w1|up_proj|gate_proj|mlp_in)\w*(_w(eight)?)?$",
     "mlp-in"),
    (r"(ff2|fc2|w2|down_proj|mlp_out)\w*(_w(eight)?)?$", "mlp-out"),
    (r"(o_proj|out_proj|attn_out|proj)\w*(_w(eight)?)?$",
     "attention-out"),
    # LM / classifier heads share the embedding spec ((vocab, d) with
    # vocab sharded = column-parallel logits)
    (r"(head|logits)\w*(_w(eight)?)?$", "embedding"),
    # generic dense / fc weights: column-parallel
    (r"(dense|fc)\w*_w(eight)?$", "mlp-in"),
)


def _entries(spec):
    """PartitionSpec | tuple | list | None -> canonical tuple."""
    return () if spec is None else tuple(spec)


def spec_to_json(spec):
    """A spec as plain JSON (None | str | [str, ...] dims)."""
    out = []
    for entry in _entries(spec):
        axes = entry_axes(entry)
        if not axes:
            out.append(None)
        elif len(axes) == 1:
            out.append(axes[0])
        else:
            out.append(list(axes))
    return out


def spec_from_json(doc):
    return P(*(None if e is None else e if isinstance(e, str)
               else tuple(e) for e in doc or ()))


def _mesh_sizes(mesh):
    return {str(a): int(s) for a, s in mesh.shape.items()}


class SpecLayout:
    """Canonical PartitionSpec tables keyed by parameter role.

    ``data_axis`` / ``fsdp_axis`` / ``tp_axis`` name the mesh axes the
    table's logical axes map to; ``table`` entries merge over the
    default table; ``rules`` (ordered ``(regex, role)``) replace the
    default rule list; ``overrides`` (ordered ``(regex, role_or_spec)``)
    are checked first."""

    def __init__(self, data_axis="data", fsdp_axis="fsdp", tp_axis="tp",
                 table=None, rules=None, overrides=None):
        self.data_axis = str(data_axis)
        self.fsdp_axis = str(fsdp_axis)
        self.tp_axis = str(tp_axis)
        self._axis_map = {"data": self.data_axis,
                          "fsdp": self.fsdp_axis, "tp": self.tp_axis}
        self.table = {role: self._rename(spec)
                      for role, spec in _DEFAULT_TABLE.items()}
        for role, spec in (table or {}).items():
            self.table[str(role)] = _entries(spec)
        self.rules = tuple(
            (str(pat), str(role))
            for pat, role in (rules if rules is not None
                              else _DEFAULT_RULES))
        self.overrides = tuple(
            (str(pat), val if isinstance(val, str) else _entries(val))
            for pat, val in (overrides or ()))
        for _, role in self.rules:
            if role not in self.table:
                raise MXNetError(
                    f"layout: rule names unknown role {role!r} "
                    f"(table has {sorted(self.table)})")

    def _rename(self, spec):
        """Logical axis names -> this layout's axis names."""
        out = []
        for entry in _entries(spec):
            axes = tuple(self._axis_map.get(a, a) for a in entry_axes(entry))
            out.append(None if not axes
                       else axes[0] if len(axes) == 1 else axes)
        return tuple(out)

    # -- role / spec resolution ----------------------------------------------
    def role_of(self, path):
        """Role of one "/"-joined leaf path: overrides (role-valued)
        first, then the ordered rule list, else ``default``."""
        name = str(path).lower()
        for pat, val in self.overrides:
            if isinstance(val, str) and re.search(pat, name):
                return val
        for pat, role in self.rules:
            if re.search(pat, name):
                return role
        return "default"

    def spec_for(self, path, shape=None, mesh=None):
        """The PartitionSpec of one leaf path: the raw table entry, or
        (with ``shape`` / ``mesh``) its mesh-fit normalization."""
        name = str(path).lower()
        entries = None
        for pat, val in self.overrides:
            if not isinstance(val, str) and re.search(pat, name):
                entries = val
                break
        if entries is None:
            entries = self.table[self.role_of(path)]
        if shape is None and mesh is None:
            return P(*entries)
        return _fit_spec(entries, shape, mesh)

    def resolve_specs(self, tree, mesh=None):
        """Pytree of PartitionSpecs matching ``tree`` — every leaf
        resolved by path and (with ``mesh``) fitted to the mesh and the
        leaf's shape."""
        return _map_with_path(
            tree, lambda path, leaf: self.spec_for(
                path, shape=_shape(leaf), mesh=mesh))

    def resolve(self, tree, mesh):
        """Pytree of :class:`~.mesh.NamedSharding` for ``tree`` over
        ``mesh`` (the port's mesh): ``sharding.shard(tensor)`` places a
        leaf."""
        return _map_with_path(
            tree, lambda path, leaf: NamedSharding(
                mesh, self.spec_for(path, shape=_shape(leaf), mesh=mesh)))

    # -- the ZeRO consumer ----------------------------------------------------
    def zero_specs(self, tree, dp, axis=None, base=None):
        """Cross-replica weight-update sharding specs: each leaf's
        leading dim over the data axis iff :func:`zero_shard_leaf`
        admits it; ``base`` (a spec pytree) composes — the data axis
        lands on dim 0 only where the base leaves it free and the extent
        still divides."""
        axis = self.data_axis if axis is None else axis

        def one(path, leaf):
            b = _entries(_lookup_path(base, path)) if base is not None \
                else ()
            if not zero_shard_leaf(leaf, dp):
                return P(*b)
            if b and entry_axes(b[0]):     # base already shards dim 0
                return P(*b)
            shape = _shape(leaf)
            if shape and shape[0] % dp:
                return P(*b)
            return P(axis, *b[1:])
        return _map_with_path(tree, one)

    # -- placement reporting --------------------------------------------------
    def report(self, tree, mesh):
        """Per-parameter placement over ``mesh``: one row per leaf with
        its role, requested and fitted spec, bytes and per-device bytes
        (total / product of the fitted spec's axis sizes)."""
        sizes = _mesh_sizes(mesh)
        rows = []
        total = per_dev = 0
        for path, leaf in iter_named_leaves(tree):
            shape = _shape(leaf)
            dtype = _dtype_name(leaf)
            fitted = self.spec_for(path, shape=shape, mesh=mesh)
            itemsize = np.dtype(dtype).itemsize if dtype != "bfloat16" \
                else 2
            nbytes = int(np.prod(shape, dtype=np.int64) * itemsize) \
                if shape else int(itemsize)
            ways = 1
            for entry in fitted:
                for a in entry_axes(entry):
                    ways *= sizes[a]
            rows.append({
                "param": path, "shape": list(shape), "dtype": dtype,
                "role": self.role_of(path),
                "spec": spec_to_json(self.spec_for(path)),
                "fitted_spec": spec_to_json(fitted),
                "shard_ways": ways,
                "bytes": nbytes,
                "per_device_bytes": nbytes // ways,
            })
            total += nbytes
            per_dev += nbytes // ways
        return {
            "mesh": sizes,
            "devices": int(np.prod(list(sizes.values()))),
            "params": rows,
            "total_bytes": total,
            "per_device_param_bytes": per_dev,
        }

    # -- JSON round trip ------------------------------------------------------
    def to_json(self):
        return {
            "version": 1,
            "axes": {"data": self.data_axis, "fsdp": self.fsdp_axis,
                     "tp": self.tp_axis},
            "table": {role: spec_to_json(entries)
                      for role, entries in sorted(self.table.items())},
            "rules": [[pat, role] for pat, role in self.rules],
            "overrides": [
                [pat, val if isinstance(val, str)
                 else {"spec": spec_to_json(val)}]
                for pat, val in self.overrides],
        }

    @classmethod
    def from_json(cls, doc):
        if doc.get("version") != 1:
            raise MXNetError(
                f"layout: unknown layout-table version "
                f"{doc.get('version')!r} (expected 1)")
        axes = doc.get("axes") or {}
        overrides = [(pat, val if isinstance(val, str)
                      else spec_from_json(val["spec"]))
                     for pat, val in doc.get("overrides") or ()]
        # the table rides the constructor so rules naming roles the
        # doc's own table defines validate against the merged table
        return cls(data_axis=axes.get("data", "data"),
                   fsdp_axis=axes.get("fsdp", "fsdp"),
                   tp_axis=axes.get("tp", "tp"),
                   table={role: spec_from_json(spec)
                          for role, spec in (doc.get("table") or {}).items()},
                   rules=[tuple(r) for r in doc["rules"]]
                   if "rules" in doc else None,
                   overrides=overrides)

    @classmethod
    def default(cls):
        """The process default table: ``SpecLayout()`` unless
        ``MXTPU_LAYOUT_TABLE`` points at a JSON table."""
        path = get_env("MXTPU_LAYOUT_TABLE", "", str)
        if not path:
            return cls()
        try:
            with open(path, encoding="utf-8") as f:
                return cls.from_json(json.load(f))
        except (OSError, ValueError, KeyError) as e:
            raise MXNetError(
                f"layout: cannot load MXTPU_LAYOUT_TABLE={path!r}: "
                f"{e}") from e


# ---------------------------------------------------------------------------
# mesh-fit normalization + pytree walking
# ---------------------------------------------------------------------------

def _shape(leaf):
    return tuple(int(s) for s in getattr(leaf, "shape", ()))


def _dtype_name(leaf):
    dtype = getattr(leaf, "dtype", "float32")
    if isinstance(dtype, torch.dtype):
        return str(dtype).replace("torch.", "")
    return str(dtype)


def _fit_spec(entries, shape, mesh):
    """Normalize a spec request to a concrete (shape, mesh): drop axes
    the mesh does not carry, axes already used by an earlier dim, and
    axes whose size does not divide the dim. Trailing replicated dims
    are trimmed (``P('tp')`` == ``P('tp', None)``)."""
    entries = _entries(entries)
    shape = tuple(shape or ())
    sizes = _mesh_sizes(mesh) if mesh is not None else None
    used = set()
    out = []
    for i, dim in enumerate(shape):
        entry = entries[i] if i < len(entries) else None
        keep = []
        extent = 1
        for a in entry_axes(entry):
            if sizes is not None:
                if a not in sizes or a in used:
                    continue
                if dim % (extent * sizes[a]):
                    continue
                extent *= sizes[a]
            elif a in used:
                continue
            keep.append(a)
            used.add(a)
        out.append(None if not keep
                   else keep[0] if len(keep) == 1 else tuple(keep))
    while out and out[-1] is None:
        out.pop()
    return P(*out)


def iter_named_leaves(tree):
    """``[(path, leaf), ...]`` of a dict / list / tuple pytree, None
    leaves skipped, paths "/"-joined and sorted (the JAX package's
    ``profiling.health.iter_named_leaves`` walk)."""
    leaves = []

    def walk(node, path):
        if isinstance(node, dict):
            for k in sorted(node, key=str):
                walk(node[k], path + (str(k),))
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, path + (str(i),))
        elif node is not None:
            leaves.append(("/".join(path), node))

    walk(tree, ())
    leaves.sort(key=lambda kv: kv[0])
    return leaves


def _map_with_path(tree, fn):
    """Rebuild a dict / list / tuple pytree applying ``fn(path, leaf)``
    with the "/"-joined path naming :func:`iter_named_leaves` uses.
    PartitionSpec and NamedSharding values are leaves, though a
    PartitionSpec is a tuple."""
    def walk(node, path):
        if isinstance(node, (P, NamedSharding)):
            return fn("/".join(path), node)
        if isinstance(node, dict):
            return {k: walk(node[k], path + (str(k),)) for k in node}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v, path + (str(i),))
                              for i, v in enumerate(node))
        if node is None:
            return None
        return fn("/".join(path), node)
    return walk(tree, ())


def _lookup_path(tree, path):
    node = tree
    for part in path.split("/"):
        node = node[part] if isinstance(node, dict) else node[int(part)]
    return node


def zero_shard_leaf(leaf, dp):
    """The per-leaf ZeRO predicate: a leaf shards over the data axis iff
    its leading dim divides evenly by ``dp`` and is at least ``dp``."""
    shape = _shape(leaf)
    return len(shape) >= 1 and shape[0] % dp == 0 and shape[0] >= dp


def collective_shardings(mesh, axis=None):
    """The (stacked-input, replicated-output) sharding pair over a
    process mesh: each worker contributes one slice of the leading
    axis, the reduction lands replicated. ``axis`` defaults to the
    mesh's first axis."""
    axis = tuple(mesh.shape)[0] if axis is None else axis
    return (NamedSharding(mesh, P(axis)), NamedSharding(mesh, P()))


#: the collective opcodes the report names (``profiling/hlo.py``
#: prices the same set), and the port's collectives under those names
_COLLECTIVE_OPS = ("all-reduce", "all-gather", "reduce-scatter",
                   "all-to-all", "collective-permute",
                   "collective-broadcast")
_PORT_KINDS = {"allreduce": "all-reduce", "allgather": "all-gather",
               "reduce_scatter": "reduce-scatter", "alltoall": "all-to-all",
               "ppermute": "collective-permute"}
_HLO_TYPES = {"float32": "f32", "bfloat16": "bf16", "float16": "f16",
              "float64": "f64", "int64": "s64", "int32": "s32",
              "int8": "s8", "uint8": "u8", "bool": "pred"}


def collectives_summary(source):
    """Per-kind count and bytes moved of a program's collectives:
    ``{"total", "by_op": {kind: {"count", "bytes", "shapes"}}}`` under
    the HLO opcode names. ``source`` is HLO text (its collectives priced
    by output footprint, as the JAX package reads what GSPMD inserted),
    or a mesh or sharded train step whose last call ran the port's
    collectives (one per group; bytes of one rank's output, as an SPMD
    program's instruction is one device's)."""
    ops = {}
    if isinstance(source, str):
        from ..profiling import hlo as _hlo
        mod = _hlo.parse_module(source)
        for comp in mod.computations.values():
            for instr in comp:
                base = instr.opcode
                for c in _COLLECTIVE_OPS:
                    if base == c or base.startswith(c + "-"):
                        base = c
                        break
                else:
                    continue
                row = ops.setdefault(base, {"count": 0, "bytes": 0,
                                            "shapes": []})
                row["count"] += 1
                row["bytes"] += _hlo.shape_bytes(instr.shape)
                if len(row["shapes"]) < 8:
                    row["shapes"].append(instr.shape)
    else:
        log = getattr(source, "last_collective_log", None)
        if log is None:
            raise TypeError("collectives_summary reads HLO text, a mesh or "
                            "a sharded train step, not a "
                            + type(source).__name__)
        for kind, r in log.items():
            ops[_PORT_KINDS.get(kind, kind)] = {
                "count": r["count"], "bytes": r["bytes"],
                "shapes": ["%s[%s]" % (_HLO_TYPES.get(
                    r.get("dtype", "float32"), "f32"),
                    ",".join(str(d) for d in shp))
                    for shp in r["shapes"]]}
    return {
        "total": int(sum(r["count"] for r in ops.values())),
        "by_op": {k: ops[k] for k in sorted(ops)},
    }


def dryrun_report(layout, tree, mesh, extra=None):
    """One placement document: ``{"tool": "layout_report", "version":
    1}``, ``extra``, the per-parameter rows of :meth:`SpecLayout.report`
    and the table's JSON (the JAX package's report without its
    ``collectives`` section, which reads XLA's HLO)."""
    doc = {"tool": "layout_report", "version": 1}
    doc.update(extra or {})
    doc.update(layout.report(tree, mesh))
    doc["layout"] = layout.to_json()
    return doc
