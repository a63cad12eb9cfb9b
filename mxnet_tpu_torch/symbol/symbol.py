"""Symbolic graph API (the port of ``mxnet_tpu/symbol/symbol.py``).

A ``Symbol`` is an immutable DAG of op applications over the op
registry. The JSON format is the reference's ("nodes" with
op/name/attrs/inputs, "arg_nodes", "heads"), written and read exactly as
the JAX package writes and reads it, so either package loads the
other's graphs. Shape and type inference run each op on ``meta``
tensors; ``bind`` / ``simple_bind`` hand the graph to
:class:`~mxnet_tpu_torch.executor.Executor`, which runs it op by op.
"""
from __future__ import annotations

import ast
import json
import os

import numpy as np

from ..base import MXNetError, attr_bool
from ..ops import registry as _reg

# variable-name suffixes treated as auxiliary states (BatchNorm moving
# statistics) rather than learnable arguments
_AUX_SUFFIXES = ("moving_mean", "moving_var", "running_mean", "running_var")

_NAME_COUNTS = {}


def _gen_name(hint):
    """``hint`` plus a per-hint counter (convolution0, convolution1...)."""
    n = _NAME_COUNTS.get(hint, 0)
    _NAME_COUNTS[hint] = n + 1
    return f"{hint}{n}"


class _Node:
    """One graph node: an op application or a variable (op is None)."""

    __slots__ = ("op", "name", "attrs", "inputs")

    def __init__(self, op, name, attrs=None, inputs=()):
        self.op = op                      # op name str, or None for vars
        self.name = name
        self.attrs = dict(attrs or {})
        self.inputs = list(inputs)        # [(Node, out_index)]

    def num_outputs(self):
        if self.op is None:
            return 1
        if "__num_outputs__" in self.attrs:
            return int(self.attrs["__num_outputs__"])
        n = _reg.get(self.op).num_outputs
        if attr_bool(self.attrs.get("output_mean_var")):
            n = 3
        return max(n, 1)


def is_aux_name(name):
    return name.endswith(_AUX_SUFFIXES)


def op_attrs(node):
    """A node's op parameters: its attrs without the ``__x__`` ones."""
    return {k: v for k, v in node.attrs.items() if not k.startswith("__")}


class Symbol:
    """An output list over a shared node DAG."""

    def __init__(self, outputs):
        self._outputs = list(outputs)     # [(Node, out_index)]

    @property
    def name(self):
        if len(self._outputs) == 1:
            return self._outputs[0][0].name
        return None

    def __repr__(self):
        names = ", ".join(n.name for n, _ in self._outputs)
        return f"<Symbol {names}>"

    def __iter__(self):
        return (Symbol([o]) for o in self._outputs)

    def __len__(self):
        return len(self._outputs)

    def __getitem__(self, index):
        if isinstance(index, str):
            names = self.list_outputs()
            if index not in names:
                raise MXNetError(f"no output named {index!r}")
            index = names.index(index)
        if isinstance(index, slice):
            return Symbol(self._outputs[index])
        return Symbol([self._outputs[index]])

    # -- graph walking -----------------------------------------------------
    def _topo(self):
        """Topological node order (inputs before users)."""
        order, seen = [], set()
        stack = [(n, False) for n, _ in reversed(self._outputs)]
        while stack:
            node, processed = stack.pop()
            if id(node) in seen:
                continue
            if processed:
                seen.add(id(node))
                order.append(node)
                continue
            stack.append((node, True))
            for child, _ in reversed(node.inputs):
                if id(child) not in seen:
                    stack.append((child, False))
        return order

    def list_arguments(self):
        return [n.name for n in self._topo()
                if n.op is None and not is_aux_name(n.name)]

    def list_auxiliary_states(self):
        return [n.name for n in self._topo()
                if n.op is None and is_aux_name(n.name)]

    def list_inputs(self):
        return [n.name for n in self._topo() if n.op is None]

    def list_outputs(self):
        names = []
        for node, k in self._outputs:
            if node.op is None:
                names.append(node.name)
            elif node.num_outputs() == 1:
                names.append(f"{node.name}_output")
            else:
                names.append(f"{node.name}_output{k}")
        return names

    def get_internals(self):
        return Symbol([(node, k) for node in self._topo()
                       for k in range(node.num_outputs())])

    # -- shape / type inference -------------------------------------------
    def infer_shape(self, *args, **kwargs):
        known = {name: tuple(s) for name, s in zip(self.list_arguments(),
                                                   args) if s is not None}
        known.update({k: tuple(v) for k, v in kwargs.items()
                      if v is not None})
        shapes, _ = self._infer(known, {})
        args_res = [shapes.get((id(n), 0)) for n in self._var_nodes(False)]
        aux_res = [shapes.get((id(n), 0)) for n in self._var_nodes(True)]
        out_res = [shapes.get((id(node), k)) for node, k in self._outputs]
        return args_res, out_res, aux_res

    def infer_type(self, *args, **kwargs):
        known = {name: np.dtype(t).name for name, t in
                 zip(self.list_arguments(), args) if t is not None}
        known.update({k: np.dtype(v).name for k, v in kwargs.items()})
        _, dtypes = self._infer({}, known, partial=True)

        def res(key):
            return np.dtype(dtypes[key]) if key in dtypes else None

        return ([res((id(n), 0)) for n in self._var_nodes(False)],
                [res((id(node), k)) for node, k in self._outputs],
                [res((id(n), 0)) for n in self._var_nodes(True)])

    def _var_nodes(self, aux):
        return [n for n in self._topo()
                if n.op is None and is_aux_name(n.name) == aux]

    def _infer(self, shape_hints, dtype_hints, partial=False):
        """Forward-propagate (shape, dtype) through the graph, running
        each op on meta tensors; unknown parameter shapes are
        back-inferred from the op's data input first."""
        shapes, dtypes = {}, {}
        for node in self._topo():
            key = (id(node), 0)
            if node.op is None:
                shape = shape_hints.get(node.name)
                if shape is None and node.attrs.get("__shape__"):
                    shape = tuple(node.attrs["__shape__"])
                if shape is not None:
                    shapes[key] = tuple(shape)
                dtypes[key] = dtype_hints.get(
                    node.name, node.attrs.get("__dtype__", "float32"))
                continue
            _infer_param_shapes(node, shapes, dtypes)
            ins = [(id(c), k) for c, k in node.inputs]
            missing = [c.name for (c, _), ck in zip(node.inputs, ins)
                       if ck not in shapes]
            if missing:
                if not partial:
                    raise MXNetError(
                        f"cannot infer shape at {node.op}({node.name}): "
                        f"inputs {missing} unknown")
                dt = next((dtypes[ck] for ck in ins if ck in dtypes), None)
                if dt:
                    for k in range(node.num_outputs()):
                        dtypes.setdefault((id(node), k), dt)
                continue
            try:
                outs = _reg.infer_output(
                    node.op, [(shapes[ck], dtypes[ck]) for ck in ins],
                    op_attrs(node))
            except MXNetError:
                raise
            except Exception as e:  # inference must name the node
                raise MXNetError(f"shape inference failed at "
                                 f"{node.op}({node.name}): {e}") from None
            for k, (shape, dt) in enumerate(outs):
                shapes[(id(node), k)] = shape
                dtypes[(id(node), k)] = dt
        return shapes, dtypes

    # -- serialization -----------------------------------------------------
    def tojson(self):
        order = self._topo()
        index = {id(n): i for i, n in enumerate(order)}
        nodes, arg_nodes = [], []
        for i, node in enumerate(order):
            if node.op is None:
                arg_nodes.append(i)
            entry = {
                "op": node.op or "null",
                "name": node.name,
                "inputs": [[index[id(c)], k, 0] for c, k in node.inputs],
            }
            if node.attrs:
                entry["attrs"] = {k: _attr_str(v)
                                  for k, v in node.attrs.items()}
            nodes.append(entry)
        heads = [[index[id(n)], k, 0] for n, k in self._outputs]
        return json.dumps({
            "nodes": nodes,
            "arg_nodes": arg_nodes,
            "node_row_ptr": list(range(len(nodes) + 1)),
            "heads": heads,
            "attrs": {"mxnet_version": ["int", 10400]},
        }, indent=2)

    def save(self, fname):
        from ..checkpoint import atomic_write
        with atomic_write(fname, mode="w") as f:
            f.write(self.tojson())

    # -- execution ---------------------------------------------------------
    def eval_dict(self, bindings):
        """Evaluate with NDArray bindings by variable name."""
        from ..executor import run_graph
        from ..ndarray.ndarray import NDArray, as_tensor
        values = {name: as_tensor(v) for name, v in bindings.items()}
        device = next(iter(values.values())).device if values else None
        outs = run_graph(self, values)
        results = [NDArray(as_tensor(o, device)) for o in outs]
        return results[0] if len(results) == 1 else results

    def bind(self, ctx=None, args=None, args_grad=None, grad_req="write",
             aux_states=None, group2ctx=None, shared_exec=None, mesh=None,
             arg_specs=None):
        """Bind the given arrays; ``mesh`` / ``arg_specs`` as in
        :meth:`simple_bind`."""
        from ..executor import Executor
        return Executor(self, ctx, args=args, args_grad=args_grad,
                        grad_req=grad_req, aux_states=aux_states, mesh=mesh,
                        arg_specs=arg_specs)

    def simple_bind(self, ctx=None, grad_req="write", type_dict=None,
                    shared_exec=None, group2ctx=None, mesh=None,
                    arg_specs=None, **kwargs):
        """Allocate argument and auxiliary arrays from the inferred
        shapes and bind; ``grad_req`` is one of "null", "write", "add"
        or a dict of them by argument name ("null" for the rest), and
        the executor allocates a gradient array for every argument that
        is not "null". An inference bind (every grad_req "null") applies
        the subgraph backend ``MXNET_SUBGRAPH_BACKEND`` names, as the
        reference does at bind. With a ``mesh`` (``parallel.create_mesh``)
        the executor runs data-parallel over it: ``arg_specs`` maps
        argument names to ``PartitionSpec``s (``P("dp")`` splits the
        batch, the rest are replicated), and the arrays live on the
        mesh's first device (``executor.py``)."""
        if mesh is not None:
            ctx = mesh.devices.flat[0]
        from ..executor import Executor
        from ..ndarray import zeros
        req_all_null = (grad_req == "null" if isinstance(grad_req, str)
                        else all(v == "null" for v in grad_req.values()))
        if req_all_null:
            self = self._maybe_partition(
                os.environ.get("MXNET_SUBGRAPH_BACKEND"))
        arg_shapes, _, aux_shapes = self.infer_shape(**kwargs)
        arg_types, _, aux_types = self.infer_type(**(type_dict or {}))
        args = {}
        for name, shape, dt in zip(self.list_arguments(), arg_shapes,
                                   arg_types):
            if shape is None:
                raise MXNetError(f"simple_bind: shape of {name} unknown")
            args[name] = zeros(shape, ctx=ctx, dtype=dt or "float32")
        aux = {name: zeros(shape, ctx=ctx, dtype=dt or "float32")
               for name, shape, dt in zip(self.list_auxiliary_states(),
                                          aux_shapes, aux_types)}
        return Executor(self, ctx, args=args, grad_req=grad_req,
                        aux_states=aux, mesh=mesh, arg_specs=arg_specs)

    def _maybe_partition(self, backend):
        """The always-fire partitioner: the JAX package prices clusters
        from XLA HLO first (``subgraph/cost.py``, off with
        ``MXTPU_FUSE_COST=0``); the port has no HLO to price."""
        if not backend:
            return self
        from ..subgraph import partition_graph
        return partition_graph(self, backend)

    def get_backend_symbol(self, backend):
        """Apply a registered subgraph backend."""
        from ..subgraph import partition_graph
        return partition_graph(self, backend)

    # -- operators ---------------------------------------------------------
    def __add__(self, other):
        return _binary(self, other, "broadcast_add", "_plus_scalar")

    __radd__ = __add__

    def __sub__(self, other):
        return _binary(self, other, "broadcast_sub", "_minus_scalar")

    def __rsub__(self, other):
        return _binary(self, other, "broadcast_sub", "_rminus_scalar")

    def __mul__(self, other):
        return _binary(self, other, "broadcast_mul", "_mul_scalar")

    __rmul__ = __mul__

    def __truediv__(self, other):
        return _binary(self, other, "broadcast_div", "_div_scalar")

    def __rtruediv__(self, other):
        return _binary(self, other, "broadcast_div", "_rdiv_scalar")

    def __neg__(self):
        return _binary(self, -1.0, "broadcast_mul", "_mul_scalar")

    def __hash__(self):
        return id(self)


def _fc_shapes(ins, attrs):
    data = ins[0]
    if data is None:
        return None
    nh = int(attrs.get("num_hidden", 0))
    flatten = attr_bool(attrs.get("flatten"), True)
    in_units = int(np.prod(data[1:])) if flatten else int(data[-1])
    out = [None, (nh, in_units)]
    if not attr_bool(attrs.get("no_bias")):
        out.append((nh,))
    return out


def _conv_shapes(ins, attrs):
    data = ins[0]
    if data is None:
        return None
    kernel = tuple(attrs.get("kernel", ()))
    nf = int(attrs.get("num_filter", 0))
    ng = int(attrs.get("num_group", 1))
    out = [None, (nf, int(data[1]) // ng) + kernel]
    if not attr_bool(attrs.get("no_bias")):
        out.append((nf,))
    return out


def _norm_shapes(ins, attrs):
    data = ins[0]
    if data is None:
        return None
    axis = int(attrs.get("axis", 1))
    return [None] + [(int(data[axis % len(data)]),)] * (len(ins) - 1)


def _softmax_label_shapes(ins, attrs):
    """The label of SoftmaxOutput: one class index per row (per pixel
    with ``multi_output``), as the reference's SoftmaxOutput infers it."""
    data = ins[0]
    if data is None:
        return None
    if attr_bool(attrs.get("multi_output")):
        return [None, (data[0],) + tuple(data[2:])]
    return [None, tuple(data[:-1])]


# op name -> fn(input shapes (None when unknown), attrs) -> shapes of the
# inputs (None to leave one alone), in positional order; the fused
# subgraph ops add theirs when their modules load
_PARAM_SHAPE_INFER = {
    "FullyConnected": _fc_shapes,
    "Convolution": _conv_shapes,
    "BatchNorm": _norm_shapes,
    "SoftmaxOutput": _softmax_label_shapes,
    "Softmax": _softmax_label_shapes,
}


def _infer_param_shapes(node, shapes, dtypes):
    """Back-infer unknown variable-input shapes from the op semantics,
    enough for simple_bind to work from the data shape alone."""
    fn = _PARAM_SHAPE_INFER.get(node.op)
    if fn is None:
        return
    inferred = fn([shapes.get((id(c), k)) for c, k in node.inputs],
                  node.attrs)
    for (child, k), shape in zip(node.inputs, inferred or ()):
        key = (id(child), k)
        if shape is None or child.op is not None or key in shapes:
            continue
        shapes[key] = tuple(int(s) for s in shape)
        dtypes.setdefault(key, "float32")


def _attr_str(v):
    return v if isinstance(v, str) else str(v)


def _parse_attr(s):
    if not isinstance(s, str):
        return s
    try:
        return ast.literal_eval(s)
    except (ValueError, SyntaxError):
        return s


def _apply(op_name, input_syms, attrs, name=None):
    """A node applying ``op_name`` to single-output input symbols."""
    opdef = _reg.get(op_name)
    inputs = []
    for s in input_syms:
        if len(s._outputs) != 1:
            raise MXNetError(
                f"{op_name}: multi-output symbol used as a single input")
        inputs.append(s._outputs[0])
    name = name or _gen_name(opdef.name.lower().lstrip("_"))
    node = _Node(opdef.name, name, attrs, inputs)
    return Symbol([(node, k) for k in range(node.num_outputs())])


def _binary(lhs, rhs, broadcast_op, scalar_op):
    if isinstance(rhs, Symbol):
        return _apply(broadcast_op, [lhs, rhs], {})
    return _apply(scalar_op, [lhs], {"scalar": float(rhs)})


def var(name, attr=None, shape=None, dtype=None, **kwargs):
    """A free variable."""
    attrs = dict(attr or {})
    if shape is not None:
        attrs["__shape__"] = tuple(shape)
    if dtype is not None:
        attrs["__dtype__"] = np.dtype(dtype).name
    attrs.update(kwargs)
    return Symbol([(_Node(None, name, attrs), 0)])


Variable = var


def Group(symbols):
    return Symbol([o for s in symbols for o in s._outputs])


def load_json(json_str):
    graph = json.loads(json_str)
    nodes = []
    for entry in graph["nodes"]:
        op = entry["op"]
        attrs = {k: _parse_attr(v)
                 for k, v in (entry.get("attrs") or entry.get("param")
                              or {}).items()}
        node = _Node(None if op == "null" else op, entry["name"], attrs)
        nodes.append((node, entry["inputs"]))
    for node, inputs in nodes:
        node.inputs = [(nodes[i][0], k) for i, k, *_ in inputs]
    heads = graph.get("heads") or [[len(nodes) - 1, 0, 0]]
    return Symbol([(nodes[i][0], k) for i, k, *_ in heads])


def load(fname):
    with open(fname) as f:
        return load_json(f.read())
