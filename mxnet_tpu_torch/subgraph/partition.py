"""Graph partitioner (the port of ``mxnet_tpu/subgraph/partition.py``):
the SubgraphSelector seed-grow protocol over the Symbol DAG (ref:
src/operator/subgraph/partition_graph.cc + subgraph_property.h).

A property supplies a selector; the partitioner seeds at each matching
node, grows along input/output edges under the selector's control,
filters the candidate set, checks convexity (no path from the set back
into it through outside nodes) and a unique sink, and replaces each
surviving set with one node built by the property. A backend may
register a fleet of rules, applied as passes in the deterministic order
``(-priority, rule_name)``. :class:`ChainPattern` / :class:`ChainSelector`
say the common "seed op + ordered epilogue stages + input-producer
pulls" shape declaratively. The JAX package also lets a cost model gate
each cluster; the port has no HLO to price, so every cluster that passes
the structural checks fuses (the JAX package's ``MXTPU_FUSE_COST=0``).
"""
from __future__ import annotations

import ast

from ..base import MXNetError
from ..symbol.symbol import Symbol, _Node

_PROPERTIES = {}


# ---------------------------------------------------------------------------
# attr coercion — JSON-deserialized / externally-imported symbols carry
# STRING attr values (MXNet's C++ serializer spells booleans "true"/
# "false" and tuples "(3, 3)"); every rule that does arithmetic on an
# attr must coerce first. ``"false"`` is truthy as a raw string — the
# exact bug class these helpers exist to kill.
# ---------------------------------------------------------------------------

_FALSE_STRINGS = frozenset(("false", "0", "no", "off", ""))


def as_bool(v, default=False):
    if v is None:
        return default
    if isinstance(v, str):
        return v.strip().lower() not in _FALSE_STRINGS
    return bool(v)


def as_float(v, default=0.0):
    if v is None:
        return default
    return float(v)


def as_int(v, default=0):
    if v is None:
        return default
    if isinstance(v, str):
        return int(float(v))
    return int(v)


def as_tuple(v, default=()):
    if v is None:
        return tuple(default)
    if isinstance(v, str):
        try:
            v = ast.literal_eval(v)
        except (ValueError, SyntaxError):
            raise MXNetError(f"cannot parse tuple attr {v!r}") from None
    if isinstance(v, (int, float)):
        return (int(v),)
    return tuple(int(x) for x in v)


class SubgraphSelector:
    """Grow protocol (ref: subgraph_property.h:54 SubgraphSelector)."""

    def select(self, node):
        """Is `node` a seed?"""
        return False

    def select_input(self, node, input_node):
        """Grow from `node` to its producer `input_node`?"""
        return False

    def select_output(self, node, output_node):
        """Grow from `node` to its consumer `output_node`?"""
        return False

    def filter(self, candidates):
        """Final say over the grown candidate list."""
        return candidates

    def optional_ids(self):
        """ids of members the partitioner may drop instead of rejecting
        the cluster when their outputs escape it."""
        return set()


class SubgraphProperty:
    """Backend fusion policy (ref: subgraph_property.h:93).

    ``rule_name`` names the fusion decision in partition reports;
    ``priority`` orders rules within a backend fleet (higher first,
    ties broken by rule_name — deterministic by construction).
    """

    op_name = "_subgraph"
    rule_name = None
    priority = 0

    def create_selector(self):
        return SubgraphSelector()

    def create_subgraph_node(self, nodes, external_inputs, idx):
        """Build the replacement node.

        Parameters
        ----------
        nodes : list[_Node] — the matched nodes, topo-ordered.
        external_inputs : list[(node, k)] — inputs entering the set,
            in first-use order.
        idx : int — running subgraph index (for naming).

        Returns the new _Node whose inputs are `external_inputs`.
        """
        raise NotImplementedError


# ---------------------------------------------------------------------------
# declarative pattern vocabulary
# ---------------------------------------------------------------------------


class Stage:
    """One optional consumer-chain stage of a :class:`ChainPattern`.

    ops : op names that match this stage.
    guard : ``fn(chain, node) -> bool`` extra admission check (e.g. the
        BN-normalizes-the-conv-channel-axis test); ``chain`` is the
        matched node list so far, ``chain[0]`` the seed.
    required : a chain that ends without matching this stage is
        discarded by ``filter`` (quantize chains *must* requantize).
    terminal : once matched, the chain stops growing (relu is always
        the last post-op: the fused ops apply sum before act).
    """

    __slots__ = ("name", "ops", "guard", "required", "terminal")

    def __init__(self, name, ops, guard=None, required=False,
                 terminal=False):
        self.name = name
        self.ops = frozenset(ops)
        self.guard = guard
        self.required = required
        self.terminal = terminal


class ChainPattern:
    """seed op + ordered epilogue stages + producer pulls.

    seed_ops : op names a chain may start at.
    stages : ordered ``Stage`` list; the chain may skip optional stages
        but never goes back (the kStart→kBN→kSum→kSuccess state machine
        of mkldnn_conv_property.cc, said declaratively).
    input_pulls : ``{(node_op, arg_index): producer_op}`` — grow from a
        matched node to the producer of its ``arg_index``-th input when
        the producer has that op (quantize feeding a quantized conv).
    """

    def __init__(self, seed_ops, stages=(), input_pulls=None):
        self.seed_ops = frozenset(seed_ops)
        self.stages = tuple(stages)
        self.input_pulls = dict(input_pulls or {})


class ChainSelector(SubgraphSelector):
    """Execute a :class:`ChainPattern` under the seed-grow protocol."""

    def __init__(self, pattern):
        self.pattern = pattern
        self.chain = []
        self._stages = []            # per-chain-node stage index (seed=-1)
        self.done = False
        self.failed = True
        self.pulled = []             # producers pulled via input_pulls

    @property
    def stage_idx(self):
        return self._stages[-1] if self._stages else -1

    def select(self, node):
        if node.op in self.pattern.seed_ops:
            self.chain = [node]
            self._stages = [-1]
            self.done = False
            self.failed = False
            self.pulled = []
            return True
        return False

    def select_input(self, node, input_node):
        if self.failed:
            return False
        for i, (child, _k) in enumerate(node.inputs):
            want = self.pattern.input_pulls.get((node.op, i))
            if want and child is input_node and input_node.op == want:
                self.pulled.append(input_node)
                return True
        return False

    def select_output(self, node, output_node):
        if self.failed or self.done:
            return False
        if self.chain[-1] is not node:
            if node in self.chain:
                # internal branch: truncate behind `node` and stop
                while self.chain[-1] is not node:
                    self.chain.pop()
                    self._stages.pop()
                self.done = True
            # a pulled producer's other consumers never grow the chain
            return False
        for i in range(self.stage_idx + 1, len(self.pattern.stages)):
            st = self.pattern.stages[i]
            if output_node.op not in st.ops:
                continue
            if st.guard is not None and not st.guard(self.chain,
                                                    output_node):
                self.done = True
                return False
            self.chain.append(output_node)
            self._stages.append(i)
            if st.terminal:
                self.done = True
            return True
        self.done = True
        return False

    def filter(self, candidates):
        if self.failed:
            return []
        matched = set(self._stages)
        for i, st in enumerate(self.pattern.stages):
            if st.required and i not in matched:
                return []
        keep = set(map(id, self.chain)) | set(map(id, self.pulled))
        return [n for n in candidates if id(n) in keep]

    def optional_ids(self):
        """Pulled producers are optional: if one's outputs escape the
        cluster the partitioner drops it instead of rejecting."""
        return {id(n) for n in self.pulled}


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------


def _rule_sort_key(prop):
    return (-int(getattr(prop, "priority", 0) or 0),
            str(getattr(prop, "rule_name", None) or prop.op_name))


def register_subgraph_property(name, prop):
    """Register a backend: one property, or a whole rule fleet (any
    sequence of properties). Fleets are stored in their deterministic
    application order — sorted by ``(-priority, rule_name)`` — so
    multi-rule partitioning never depends on registration order."""
    if isinstance(prop, (list, tuple)):
        _PROPERTIES[name] = tuple(sorted(prop, key=_rule_sort_key))
    else:
        _PROPERTIES[name] = prop
    return prop


def backend_rules(prop_or_name):
    """Resolve a backend name / property / fleet to the ordered tuple
    of rule properties one partition call will apply."""
    prop = (get_subgraph_property(prop_or_name)
            if isinstance(prop_or_name, str) else prop_or_name)
    if isinstance(prop, (list, tuple)):
        return tuple(sorted(prop, key=_rule_sort_key))
    return (prop,)


def get_subgraph_property(name):
    try:
        return _PROPERTIES[name]
    except KeyError:
        raise MXNetError(
            f"subgraph backend {name!r} not registered; known: "
            f"{sorted(_PROPERTIES)}") from None


def _consumers(order):
    cons = {}
    for node in order:
        for child, k in node.inputs:
            cons.setdefault(id(child), []).append(node)
    return cons


def _external_inputs(group_topo, in_group):
    """External inputs in first-use positional order, one entry PER
    USE (no dedup): fused ops unpack inputs positionally, so a tensor
    feeding two group edges (e.g. x + conv(x)) must appear twice."""
    ext = []
    for n in group_topo:
        for c, k in n.inputs:
            if id(c) not in in_group:
                ext.append((c, k))
    return ext


def partition_graph(symbol, prop_or_name):
    """Apply a backend (one property or its whole rule fleet) over the
    graph (ref: partition_graph.cc PartitionGraph pass)."""
    out = symbol
    for prop in backend_rules(prop_or_name):
        out = _partition_one(out, prop)
    return out


def _partition_one(symbol, prop):
    order = symbol._topo()
    consumers = _consumers(order)
    out_ids = {id(n) for n, _ in symbol._outputs}
    claimed = set()
    groups = []  # list[(group_topo, sink, ext_inputs)]

    for seed in order:
        if seed.op is None or id(seed) in claimed:
            continue
        selector = prop.create_selector()
        if not selector.select(seed):
            continue
        # grow: BFS along input and output edges under selector control
        group = [seed]
        in_group = {id(seed)}
        frontier = [seed]
        while frontier:
            node = frontier.pop(0)
            for child, _ in node.inputs:
                if id(child) in in_group or id(child) in claimed:
                    continue
                if selector.select_input(node, child):
                    group.append(child)
                    in_group.add(id(child))
                    frontier.append(child)
            for cons in consumers.get(id(node), ()):
                if id(cons) in in_group or id(cons) in claimed:
                    continue
                if selector.select_output(node, cons):
                    group.append(cons)
                    in_group.add(id(cons))
                    frontier.append(cons)
        group = selector.filter(group)
        if not group:
            continue
        # optional members (pulled producers) whose outputs escape the
        # group are dropped rather than failing the whole cluster — a
        # quantize node shared with another consumer stays outside and
        # the conv→requantize core still fuses
        opt_ids = selector.optional_ids()
        if opt_ids:
            changed = True
            while changed:
                changed = False
                in_group = {id(n) for n in group}
                for n in list(group):
                    if id(n) not in opt_ids:
                        continue
                    ext = [c for c in consumers.get(id(n), ())
                           if id(c) not in in_group]
                    if ext or id(n) in out_ids:
                        group.remove(n)
                        changed = True
        if not group:
            continue
        in_group = {id(n) for n in group}
        if not _is_convex(group, in_group, consumers):
            continue
        # intermediate outputs consumed outside the group (except the
        # group's sink) make the rewrite invalid — reject (the branch
        # negative case, ref: test_neg_conv_bn)
        sink = _find_sink(group, in_group, consumers, out_ids)
        if sink is None:
            continue
        ok = True
        for n in group:
            if n is sink:
                continue
            ext = [c for c in consumers.get(id(n), ())
                   if id(c) not in in_group]
            if ext or id(n) in out_ids:
                ok = False
                break
        if not ok:
            continue
        group_topo = _topo_of(group, in_group)
        ext_inputs = _external_inputs(group_topo, in_group)
        claimed |= in_group
        groups.append((group_topo, sink, ext_inputs))

    if not groups:
        return symbol

    # rewrite: topo-copy the graph, splicing in subgraph nodes
    group_of = {}     # id(original node) -> (group, sink, ext)
    for group, sink, ext in groups:
        for n in group:
            group_of[id(n)] = (group, sink, ext)

    memo = {}
    sub_idx = [0]

    def copy(node):
        if id(node) in memo:
            return memo[id(node)]
        if id(node) in group_of:
            group, sink, ext = group_of[id(node)]
            new = prop.create_subgraph_node(group, ext, sub_idx[0])
            sub_idx[0] += 1
            for n in group:
                memo[id(n)] = new
            new.inputs = [(copy(c), k) for c, k in ext]
            return new
        new = _Node(node.op, node.name, node.attrs)
        memo[id(node)] = new
        new.inputs = [(copy(c), k) for c, k in node.inputs]
        return new

    outs = [(copy(n), k) for n, k in symbol._outputs]
    return Symbol(outs)


def _topo_of(group, in_group):
    """Topo-order the group's nodes (inputs before users)."""
    order, seen = [], set()

    def visit(n):
        if id(n) in seen:
            return
        seen.add(id(n))
        for c, _ in n.inputs:
            if id(c) in in_group:
                visit(c)
        order.append(n)

    for n in group:
        visit(n)
    return order


def _find_sink(group, in_group, consumers, out_ids):
    """The unique node whose outputs leave the group."""
    sinks = []
    for n in group:
        ext = [c for c in consumers.get(id(n), ())
               if id(c) not in in_group]
        if ext or id(n) in out_ids or not consumers.get(id(n)):
            sinks.append(n)
    return sinks[0] if len(sinks) == 1 else None


def _is_convex(group, in_group, consumers):
    """No path from inside the group back in through external nodes
    (would create a cycle after fusion — ref: partition_graph.cc cycle
    detection)."""
    # walk forward from external consumers of group nodes; if any
    # external path re-enters the group, reject
    start = []
    for n in group:
        for c in consumers.get(id(n), ()):
            if id(c) not in in_group:
                start.append(c)
    seen = set()
    frontier = list(start)
    while frontier:
        node = frontier.pop()
        if id(node) in seen:
            continue
        seen.add(id(node))
        if id(node) in in_group:
            return False
        for c in consumers.get(id(node), ()):
            frontier.append(c)
    return True
