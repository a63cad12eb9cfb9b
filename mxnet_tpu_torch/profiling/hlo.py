"""Optimized-HLO text parser and per-instruction analytic cost model:
the port's own copy of ``mxnet_tpu/profiling/hlo.py`` (stdlib only; it
imports nothing of either package), so :func:`~.ledger.build_ledger`,
:func:`~.capture.analyze_dir` and :func:`~.memory.build_memory_ledger`
price an HLO text (a committed ``.hlo.txt``, or one a JAX program
printed) exactly as the JAX package does. The port's own programs are
priced from their op trace (:mod:`.optrace`), which prices each torch op
the way this module prices its HLO counterpart.

Each instruction is priced analytically:

- ``dot``: 2 * out_elems * K (K = product of lhs contracting dims),
- ``convolution``: 2 * out_elems * kernel_spatial * rhs_input_features
  (the rhs 'i' dim is already per-group, so grouped/depthwise convs
  price correctly),
- ``fusion`` / ``call`` / ``while`` / ``conditional``: the called
  computation's instructions summed (a while body is priced for one
  trip: static text has no trip count),
- elementwise / reduce / rng: one flop per element touched,
- everything else: 0 flops (pure data movement).

Bytes are the instruction's own operand + output footprints: for a
fusion that is exactly the memory traffic the fusion bought, since
internal producer/consumer pairs never touch device memory.
"""
from __future__ import annotations

import math
import re

# dtype -> bytes per element (HLO spellings)
_DTYPE_BYTES = {
    "pred": 1, "s2": 1, "u2": 1, "s4": 1, "u4": 1,
    "s8": 1, "u8": 1, "f8e4m3fn": 1, "f8e5m2": 1, "f8e4m3": 1,
    "f8e3m4": 1, "f8e4m3b11fnuz": 1, "f8e5m2fnuz": 1, "f8e4m3fnuz": 1,
    "s16": 2, "u16": 2, "f16": 2, "bf16": 2,
    "s32": 4, "u32": 4, "f32": 4, "tf32": 4,
    "s64": 8, "u64": 8, "f64": 8, "c64": 8,
    "c128": 16, "token": 0, "opaque": 0,
}

# one entry per *array* component: "f32[2,3]{1,0}" or "(f32[2], s32[])"
_ARRAY_RE = re.compile(r"([a-z0-9]+)\[([\d,]*)\]")

_COMMS_OPCODES = {
    "all-reduce", "all-gather", "all-to-all", "reduce-scatter",
    "collective-permute", "collective-broadcast", "all-reduce-start",
    "all-gather-start", "collective-permute-start", "send", "recv",
    "send-done", "recv-done", "partition-id", "replica-id",
}

# opcodes priced at ~1 flop per output element (elementwise + cheap
# transcendentals — the roofline bound for these is bytes anyway)
_ELEMENTWISE = {
    "add", "subtract", "multiply", "divide", "maximum", "minimum",
    "power", "remainder", "and", "or", "xor", "not", "negate", "abs",
    "exponential", "exponential-minus-one", "log", "log-plus-one",
    "sqrt", "rsqrt", "cbrt", "sign", "cosine", "sine", "tan", "tanh",
    "atan2", "erf", "logistic", "floor", "ceil", "round-nearest-afz",
    "round-nearest-even", "compare", "select", "clamp", "convert",
    "is-finite", "shift-left", "shift-right-arithmetic",
    "shift-right-logical", "popcnt", "clz", "stochastic-convert",
}

# free / pure-movement opcodes: never worth a ledger row of their own
TRIVIAL_OPCODES = {
    "parameter", "constant", "tuple", "get-tuple-element", "bitcast",
    "bitcast-convert", "after-all", "opt-barrier", "partition-id",
    "replica-id", "iota",
}


def _shape_components(shape_text):
    """[(dtype, elems)] for every array component of a shape string
    (tuples flatten; layout annotations ignored)."""
    out = []
    for dtype, dims in _ARRAY_RE.findall(shape_text):
        if dtype not in _DTYPE_BYTES:
            continue  # e.g. a stray identifier that looked shape-like
        elems = 1
        if dims:
            elems = math.prod(int(d) for d in dims.split(","))
        out.append((dtype, elems))
    return out


def shape_elems(shape_text):
    return sum(e for _, e in _shape_components(shape_text))


def shape_bytes(shape_text):
    return sum(e * _DTYPE_BYTES[d] for d, e in
               _shape_components(shape_text))


class Instr:
    """One parsed HLO instruction."""

    __slots__ = ("name", "opcode", "shape", "operand_shapes", "operands",
                 "attrs", "op_name", "calls", "is_root")

    def __init__(self, name, opcode, shape, operand_shapes, operands,
                 attrs, op_name, calls, is_root):
        self.name = name
        self.opcode = opcode
        self.shape = shape
        self.operand_shapes = operand_shapes
        self.operands = operands          # operand instruction names
        self.attrs = attrs                # raw trailing attr text
        self.op_name = op_name            # jax metadata op_name path
        self.calls = calls                # called computation names
        self.is_root = is_root

    def __repr__(self):
        return "<Instr %s = %s %s>" % (self.name, self.shape, self.opcode)


_COMP_HEAD = re.compile(r"^(ENTRY\s+)?%?([\w.\-]+)\s*(?:\([^)]*\))?\s*"
                        r"(?:->\s*.+?)?\s*{\s*$")
_INSTR_HEAD = re.compile(
    r"^\s*(ROOT\s+)?%?([\w.\-]+)\s+=\s+"
    r"(\(.*?\)|[a-z0-9]+\[[\d,]*\](?:{[^}]*})?)\s+"
    r"([\w\-]+)\(")


def _split_args(line, open_idx):
    """(args, tail) splitting at the paren that matches ``open_idx``.
    Operand lists may contain nested parens (tuple-typed operands) and
    the trailing metadata contains parens inside quoted strings, so a
    regex can't do this — a depth scan can."""
    depth = 0
    in_str = False
    i = open_idx
    n = len(line)
    while i < n:
        c = line[i]
        if in_str:
            if c == '"' and line[i - 1] != "\\":
                in_str = False
        elif c == '"':
            in_str = True
        elif c == "(":
            depth += 1
        elif c == ")":
            depth -= 1
            if depth == 0:
                return line[open_idx + 1:i], line[i + 1:]
        i += 1
    return line[open_idx + 1:], ""
_OPERAND_RE = re.compile(
    r"([a-z0-9]+\[[\d,]*\])(?:{[^}]*})?\s+%?([\w.\-]+)")
_METADATA_RE = re.compile(r'op_name="([^"]*)"')
_CALLS_RE = re.compile(r"(?:calls|to_apply|body|condition|branch_"
                       r"computations)=\{?%?([\w.\-, %]+)\}?")


class Module:
    """Parsed HLO module: {computation name: [Instr]} + entry name."""

    def __init__(self, name, computations, entry):
        self.name = name
        self.computations = computations
        self.entry = entry

    @property
    def entry_instructions(self):
        return self.computations.get(self.entry, [])

    def all_instruction_names(self):
        names = set()
        for instrs in self.computations.values():
            names.update(i.name for i in instrs)
        return names


def parse_module(text):
    """Parse optimized HLO text into a :class:`Module`."""
    mod_name = "hlo"
    m = re.search(r"^HloModule\s+([\w.\-]+)", text, re.M)
    if m:
        mod_name = m.group(1)
    computations = {}
    entry = None
    cur = None
    for line in text.splitlines():
        stripped = line.strip()
        if cur is None:
            if not stripped or stripped.startswith(("HloModule", "//")):
                continue
            head = _COMP_HEAD.match(stripped)
            if head and stripped.endswith("{"):
                cur = head.group(2)
                computations[cur] = []
                if head.group(1):
                    entry = cur
            continue
        if stripped == "}":
            cur = None
            continue
        im = _INSTR_HEAD.match(line)
        if im is None:
            continue
        is_root, name, shape, opcode = im.groups()
        args, tail = _split_args(line, im.end() - 1)
        operand_shapes = []
        operands = []
        for oshape, oname in _OPERAND_RE.findall(args):
            operand_shapes.append(oshape)
            operands.append(oname)
        md = _METADATA_RE.search(tail)
        calls = []
        for cm in _CALLS_RE.finditer(tail):
            calls.extend(c.strip().lstrip("%") for c in
                         cm.group(1).split(",") if c.strip())
        computations[cur].append(Instr(
            name=name, opcode=opcode, shape=shape,
            operand_shapes=operand_shapes, operands=operands,
            attrs=tail, op_name=md.group(1) if md else None,
            calls=calls, is_root=bool(is_root)))
    if entry is None and computations:
        # fall back to the lexically last computation (XLA prints the
        # entry last when the ENTRY marker is absent)
        entry = list(computations)[-1]
    return Module(mod_name, computations, entry)


def _dot_flops(instr):
    out = shape_elems(instr.shape)
    k = 1
    m = re.search(r"lhs_contracting_dims=\{([\d,]*)\}", instr.attrs)
    if m and instr.operand_shapes:
        lhs = _ARRAY_RE.search(instr.operand_shapes[0])
        if lhs:
            dims = [int(d) for d in lhs.group(2).split(",") if d]
            for i in (int(x) for x in m.group(1).split(",") if x):
                if i < len(dims):
                    k *= dims[i]
    return 2 * out * k


def _conv_flops(instr):
    out = shape_elems(instr.shape)
    ksp = 1
    m = re.search(r"size=([\dx]+)", instr.attrs)
    if m:
        ksp = math.prod(int(x) for x in m.group(1).split("x"))
    cin = 1
    dl = re.search(r"dim_labels=(\S+?)(?:,|$|\s)", instr.attrs)
    if dl and len(instr.operand_shapes) >= 2:
        rhs = _ARRAY_RE.search(instr.operand_shapes[1])
        labels = dl.group(1).split("_")
        if rhs and len(labels) >= 2:
            rdims = [int(d) for d in rhs.group(2).split(",") if d]
            rlab = labels[1].split("-")[0]
            if "i" in rlab and rlab.index("i") < len(rdims):
                # rhs input-feature dim is already per-group
                cin = rdims[rlab.index("i")]
    return 2 * out * ksp * cin


def instr_cost(instr, module, _seen=None):
    """(flops, bytes) for one instruction. Called computations price
    recursively (cycle-guarded); bytes stay the instruction's own
    operand/output footprint."""
    nbytes = shape_bytes(instr.shape) + sum(
        shape_bytes(s) for s in instr.operand_shapes)
    op = instr.opcode
    if op in TRIVIAL_OPCODES:
        return 0, 0
    if op in _COMMS_OPCODES:
        return 0, nbytes
    if op == "dot":
        return _dot_flops(instr), nbytes
    if op == "convolution":
        return _conv_flops(instr), nbytes
    if op in ("fusion", "call", "while", "conditional", "map",
              "async-start", "custom-call"):
        flops = 0
        seen = _seen if _seen is not None else set()
        for cname in instr.calls:
            if cname in seen:
                continue
            seen.add(cname)
            for sub in module.computations.get(cname, ()):
                f, _ = instr_cost(sub, module, _seen=seen)
                flops += f
        return flops, nbytes
    if op in ("reduce", "reduce-window", "select-and-scatter", "sort",
              "scatter", "gather", "cholesky", "triangular-solve",
              "rng", "rng-bit-generator"):
        touched = sum(shape_elems(s) for s in instr.operand_shapes) or \
            shape_elems(instr.shape)
        if op == "reduce-window":
            m = re.search(r"size=([\dx]+)", instr.attrs)
            if m:
                touched = shape_elems(instr.shape) * math.prod(
                    int(x) for x in m.group(1).split("x"))
        return touched, nbytes
    if op in _ELEMENTWISE or op.endswith("-convert"):
        return shape_elems(instr.shape), nbytes
    # movement-shaped leftovers (copy, transpose, reshape, slice,
    # broadcast, concatenate, pad, dynamic-slice, ...): bytes only
    return 0, nbytes


def is_comms(instr):
    return instr.opcode in _COMMS_OPCODES
