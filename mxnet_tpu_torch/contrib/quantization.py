"""INT8 quantization flow (the port of ``mxnet_tpu/contrib/quantization.py``;
ref: python/mxnet/contrib/quantization.py + quantize_graph_pass.cc).

``quantize_model`` folds inference BatchNorm into the preceding
convolutions, clones the symbol replacing quantizable ops with their
int8 forms (``_contrib_quantize_v2`` on fp32→int8 edges,
``_contrib_requantize`` after int32-accumulating ops,
``_contrib_dequantize`` on int8→fp32 edges), calibrates per-tensor
ranges by running the fp32 graph over sample batches (naive min/max or
the KL-entropy threshold search) and bakes them into the graph, and
quantizes the weights offline on the host. ``quantize_net`` runs the
same flow on a gluon network and returns a forward function of the
quantized graph on the device.
"""
from __future__ import annotations

import logging

import numpy as np

from ..base import MXNetError, attr_bool
from .. import ndarray as nd
from ..symbol.symbol import Symbol, _Node

_QUANTIZED_OP = {
    "Convolution": "_contrib_quantized_conv",
    "FullyConnected": "_contrib_quantized_fully_connected",
    "Pooling": "_contrib_quantized_pooling",
    "Flatten": "_contrib_quantized_flatten",
    "flatten": "_contrib_quantized_flatten",
}
# ops whose int8 output needs requantize (int32 accumulators)
_NEEDS_REQUANTIZE = {"_contrib_quantized_conv",
                     "_contrib_quantized_fully_connected"}

INT8_RANGE = 127.0


def _array_like(value, like):
    """``value`` as an NDArray on the context of the parameter ``like``
    (the current context when ``like`` is not an NDArray)."""
    ctx = like.context if isinstance(like, nd.NDArray) else None
    return nd.array(value, ctx=ctx)


class _Entry:
    """A (node, k) output plus its precision state during the pass."""

    __slots__ = ("node", "k", "is_int8", "min_entry", "max_entry",
                 "calib_key")

    def __init__(self, node, k, is_int8=False, min_entry=None,
                 max_entry=None, calib_key=None):
        self.node = node
        self.k = k
        self.is_int8 = is_int8
        self.min_entry = min_entry
        self.max_entry = max_entry
        self.calib_key = calib_key


def fold_batch_norm(symbol, arg_params, aux_params):
    """Fold inference-mode BatchNorm into the preceding Convolution
    (ref: the MKLDNN backend's conv+BN fusion the quantization example
    applies before quantizing, example/quantization/
    imagenet_gen_qsym_mkldnn.py + mkldnn_conv_property.cc kBN state).

    BN(conv(x)) = conv(x)*s + (beta - mean*s) with s = gamma/sqrt(var+eps)
    is absorbed into the conv weights/bias, so the quantized graph chains
    quantized_conv -> requantize -> int8 relu with no f32 round-trip.
    Returns (new symbol, new arg_params); aux stats become unused.
    """
    from collections import Counter as _Counter

    arg_params = dict(arg_params)
    consumers = _Counter()
    for n in symbol._topo():
        for c, k in n.inputs:
            consumers[(id(c), k)] += 1
    for c, k in symbol._outputs:
        # a conv output that is ALSO a graph output must keep its raw
        # (pre-BN) value, so it counts as an extra consumer
        consumers[(id(c), k)] += 1

    def _val(params, name):
        v = params.get(name)
        if v is None:
            return None
        return v.asnumpy() if isinstance(v, nd.NDArray) else np.asarray(v)

    # functional rewrite: the input graph is never mutated
    memo = {}      # id(old node) -> new node
    redirect = {}  # id(old bn node) -> (new conv node, 0)
    folded = 0

    def entry(c, k):
        if id(c) in redirect:
            return redirect[id(c)]
        return (memo[id(c)], k)

    for node in symbol._topo():
        if node.op is None:
            memo[id(node)] = _Node(None, node.name, node.attrs)
            continue
        new = _Node(node.op, node.name, dict(node.attrs),
                    [entry(c, k) for c, k in node.inputs])
        memo[id(node)] = new
        if node.op != "BatchNorm":
            continue
        old_conv, k0 = node.inputs[0]
        if old_conv.op != "Convolution" or k0 != 0 or \
                consumers[(id(old_conv), 0)] != 1:
            continue
        if consumers[(id(node), 1)] or consumers[(id(node), 2)]:
            # someone consumes the BN's mean/var outputs — folding would
            # rewire them to the conv activation; leave this BN alone
            continue
        conv = memo[id(old_conv)]
        wnode = conv.inputs[1][0]
        if wnode.op is not None:
            continue
        old_wnode = old_conv.inputs[1][0]
        if consumers[(id(old_wnode), 0)] > 1:
            # a weight shared by several convs would get scaled once per
            # fold — skip (the reference's fusion requires exclusive use)
            continue
        names = [c.name for c, _ in node.inputs[1:5]]
        gamma = _val(arg_params, names[0])
        beta = _val(arg_params, names[1])
        mean = _val(aux_params, names[2])
        var = _val(aux_params, names[3])
        W = _val(arg_params, wnode.name)
        if any(v is None for v in (gamma, beta, mean, var, W)):
            continue
        eps = float(node.attrs.get("eps", 1e-3))
        if attr_bool(node.attrs.get("fix_gamma"), True):
            gamma = np.ones_like(gamma)
        s = gamma / np.sqrt(var + eps)
        arg_params[wnode.name] = _array_like(
            (W * s.reshape((-1,) + (1,) * (W.ndim - 1))).astype(W.dtype),
            arg_params[wnode.name])
        has_bias = len(conv.inputs) >= 3 and \
            not attr_bool(conv.attrs.get("no_bias"), False)
        b = _val(arg_params, conv.inputs[2][0].name) if has_bias \
            else np.zeros_like(beta)
        new_b = (b * s + beta - mean * s).astype(beta.dtype)
        if has_bias:
            arg_params[conv.inputs[2][0].name] = _array_like(
                new_b, arg_params[names[1]])
        else:
            bname = f"{conv.name}_bias"
            arg_params[bname] = _array_like(new_b, arg_params[names[1]])
            conv.attrs["no_bias"] = False
            bvar = _Node(None, bname)
            if len(conv.inputs) >= 3:
                conv.inputs[2] = (bvar, 0)
            else:
                conv.inputs.append((bvar, 0))
        redirect[id(node)] = (conv, 0)
        folded += 1

    if not folded:
        return symbol, arg_params
    return Symbol([entry(c, k) for c, k in symbol._outputs]), arg_params


def _quantize_symbol(symbol, excluded_sym_names=(), offline_params=()):
    """The QuantizeGraph pass (ref: quantize_graph_pass.cc:118).

    Returns (quantized Symbol, calib_key->node map) where calib keys
    name the fp32 tensors whose ranges calibration must provide.
    """
    excluded = set(excluded_sym_names)
    offline = set(offline_params)
    memo = {}          # id(orig node) -> list[_Entry] per output
    qcache = {}        # (id(orig node), k) -> quantized triple
    dqcache = {}       # (id(int8 node), k) -> dequantize entry
    calib_nodes = {}   # calib_key -> [nodes needing min/max attrs]

    def fp32_entry(entry):
        """Get the fp32 version of an original graph edge (one shared
        dequantize per int8 edge)."""
        e = memo[id(entry[0])][entry[1]]
        if not e.is_int8:
            return (e.node, e.k)
        cached = dqcache.get((id(e.node), e.k))
        if cached is not None:
            return cached
        deq = _Node("_contrib_dequantize", f"{e.node.name}_dequantize",
                    {}, [(e.node, e.k), e.min_entry, e.max_entry])
        dqcache[(id(e.node), e.k)] = (deq, 0)
        return (deq, 0)

    def int8_entry(entry, orig_name):
        """Get (int8, min, max) of an original graph edge, inserting
        quantize_v2 when needed."""
        e = memo[id(entry[0])][entry[1]]
        if e.is_int8:
            return (e.node, e.k), e.min_entry, e.max_entry
        cached = qcache.get((id(entry[0]), entry[1]))
        if cached is not None:
            return cached
        q = _Node("_contrib_quantize_v2", f"{orig_name}_quantize",
                  {"out_type": "int8"}, [(e.node, e.k)])
        key = e.calib_key
        if key is not None:
            calib_nodes.setdefault(key, []).append(q)
        trip = (q, 0), (q, 1), (q, 2)
        # shared inputs quantize once; fp32 consumers keep the original
        qcache[(id(entry[0]), entry[1])] = trip
        return trip

    for node in symbol._topo():
        if node.op is None:
            # variable outputs keep their bare name in list_outputs
            memo[id(node)] = [_Entry(node, 0, False,
                                     calib_key=node.name)]
            continue
        if node.op in _QUANTIZED_OP and node.name not in excluded:
            qop = _QUANTIZED_OP[node.op]
            ins, mins, maxs = [], [], []
            for c, k in node.inputs:
                (qn, qk), mn, mx = int8_entry((c, k), c.name)
                ins.append((qn, qk))
                mins.append(mn)
                maxs.append(mx)
            interleaved = []
            for mn, mx in zip(mins, maxs):
                interleaved.extend([mn, mx])
            qnode = _Node(qop, f"quantized_{node.name}", dict(node.attrs),
                          ins + interleaved)
            if qop in _NEEDS_REQUANTIZE:
                req = _Node("_contrib_requantize",
                            f"{node.name}_requantize", {},
                            [(qnode, 0), (qnode, 1), (qnode, 2)])
                key = f"{node.name}_output"
                calib_nodes.setdefault(key, []).append(req)
                memo[id(node)] = [_Entry(req, 0, True, (req, 1),
                                         (req, 2), key)]
            else:
                memo[id(node)] = [_Entry(qnode, 0, True, (qnode, 1),
                                         (qnode, 2),
                                         f"{node.name}_output")]
            continue
        if node.op in ("elemwise_add", "broadcast_add") and \
                len(node.inputs) == 2 and node.name not in excluded:
            # residual adds between two int8 producers stay int8
            # (rescale + requantize in one fused kernel); the reference
            # fuses the sum into the conv as an MKL-DNN post-op
            e1 = memo[id(node.inputs[0][0])][node.inputs[0][1]]
            e2 = memo[id(node.inputs[1][0])][node.inputs[1][1]]
            if e1.is_int8 and e2.is_int8:
                qn = _Node("_contrib_quantized_elemwise_add",
                           f"quantized_{node.name}", {},
                           [(e1.node, e1.k), (e2.node, e2.k),
                            e1.min_entry, e1.max_entry,
                            e2.min_entry, e2.max_entry])
                key = f"{node.name}_output"
                calib_nodes.setdefault(key, []).append(qn)
                memo[id(node)] = [_Entry(qn, 0, True, (qn, 1), (qn, 2),
                                         key)]
                continue
        if node.op == "Activation" and \
                node.attrs.get("act_type", "relu") == "relu" and \
                node.name not in excluded:
            # relu commutes with symmetric int8 quantization (zero point
            # 0), so an int8 input passes through as max(q, 0) with no
            # dequantize/quantize round-trip — the fusion the reference
            # gets from MKLDNN conv post-ops (mkldnn_conv_property.cc)
            e = memo[id(node.inputs[0][0])][node.inputs[0][1]]
            if e.is_int8:
                qn = _Node("_contrib_quantized_act",
                           f"quantized_{node.name}",
                           {"act_type": "relu"},
                           [(e.node, e.k), e.min_entry, e.max_entry])
                memo[id(node)] = [_Entry(qn, 0, True, (qn, 1), (qn, 2),
                                         f"{node.name}_output")]
                continue
        # fp32 node: wire fp32 inputs (dequantizing where needed)
        new = _Node(node.op, node.name, node.attrs,
                    [fp32_entry((c, k)) for c, k in node.inputs])
        memo[id(node)] = [
            _Entry(new, k, False,
                   calib_key=(f"{node.name}_output" if
                              node.num_outputs() == 1 else
                              f"{node.name}_output{k}"))
            for k in range(node.num_outputs())]

    outs = []
    for n, k in symbol._outputs:
        outs.append(fp32_entry((n, k)))
    return Symbol(outs), calib_nodes


def _collect_layer_outputs(symbol, arg_params, aux_params, data_iter,
                           num_examples, logger=logging, ctx=None):
    """Run the fp32 graph, recording every internal tensor's min/max and
    (for entropy mode) histograms (ref: quantization.py:209
    _LayerOutputCollector)."""
    internals = symbol.get_internals()
    data_descs = data_iter.provide_data
    shape_hints = {d.name: d.shape for d in data_descs}
    known = set(internals.list_inputs())
    args = dict(arg_params)
    ex = None
    stats = {}
    samples = {}
    seen = 0
    data_iter.reset()
    label_descs = getattr(data_iter, "provide_label", None) or []
    for batch in data_iter:
        feeds = {d.name: a for d, a in zip(data_descs, batch.data)}
        if batch.label:
            feeds.update({d.name: a for d, a in
                          zip(label_descs, batch.label)})
        feeds = {k: v for k, v in feeds.items() if k in known}
        if ex is None:
            bind_args = {**args, **feeds}
            bind_args = {k: v for k, v in bind_args.items() if k in known}
            missing = [n for n in internals.list_arguments()
                       if n not in bind_args]
            if missing:
                raise MXNetError(f"calibration missing inputs {missing}")
            ex = internals.bind(ctx, args=bind_args,
                                aux_states=dict(aux_params),
                                grad_req="null")
        outs = ex.forward(is_train=False, **feeds)
        names = internals.list_outputs()
        for name, out in zip(names, outs):
            a = out.asnumpy()
            mn, mx = float(a.min()), float(a.max())
            if name in stats:
                omn, omx = stats[name]
                stats[name] = (min(mn, omn), max(mx, omx))
            else:
                stats[name] = (mn, mx)
            samples.setdefault(name, []).append(a.ravel()[:65536])
        seen += batch.data[0].shape[0]
        if seen >= num_examples:
            break
    return stats, samples


def _smooth_distribution(p, eps=0.0001):
    """Replace zeros with eps mass taken from non-zeros
    (ref: quantization.py:245 _smooth_distribution)."""
    is_zeros = (p == 0).astype(np.float32)
    is_nonzeros = (p != 0).astype(np.float32)
    n_zeros = is_zeros.sum()
    n_nonzeros = p.size - n_zeros
    if not n_nonzeros:
        return None
    eps1 = eps * float(n_zeros) / float(n_nonzeros)
    if eps1 >= 1.0:
        return None
    hist = p.astype(np.float32)
    hist += eps * is_zeros + (-eps1) * is_nonzeros
    return hist


def _kl_divergence(p, q):
    p = p / p.sum()
    q = q / q.sum()
    mask = p > 0
    return float(np.sum(p[mask] * np.log(p[mask] /
                                         np.maximum(q[mask], 1e-30))))


def _get_optimal_threshold(samples, num_bins=8001,
                           num_quantized_bins=255, max_windows=96):
    """KL-divergence threshold search (ref: quantization.py:266, the
    TensorRT calibration recipe): slide a symmetric clip window over the
    signed histogram; p = clipped hist with outlier mass folded into the
    edge bins, q = p's 255-bin re-quantization built from the UNCLIPPED
    slice; pick the window minimizing KL(p||q). `max_windows` subsamples
    the search (the reference scans every window; the optimum is flat)."""
    if isinstance(samples, list):
        arr = np.concatenate([np.asarray(s).ravel() for s in samples])
    else:
        arr = np.asarray(samples).ravel()
    if arr.size == 0:
        return 0.0
    th = float(np.abs(arr).max())
    if th == 0.0:
        return 0.0
    hist, hist_edges = np.histogram(arr, bins=num_bins, range=(-th, th))
    zero_bin = num_bins // 2
    half_q = num_quantized_bins // 2
    best_t, best_kl = th, np.inf
    i_values = np.unique(np.linspace(
        half_q, num_bins // 2, max_windows).astype(int))
    for i in i_values:
        start, stop = zero_bin - i, zero_bin + i + 1
        sliced = hist[start:stop]
        p = sliced.astype(np.float64).copy()
        p[0] += hist[:start].sum()
        p[-1] += hist[stop:].sum()
        is_nonzero = sliced != 0
        num_merged = p.size // num_quantized_bins
        q = np.zeros(p.size, np.float64)
        for j in range(num_quantized_bins):
            s0 = j * num_merged
            s1 = p.size if j == num_quantized_bins - 1 \
                else s0 + num_merged
            total = sliced[s0:s1].sum()
            norm = is_nonzero[s0:s1].sum()
            if norm:
                q[s0:s1] = float(total) / float(norm)
        q[~is_nonzero] = 0
        ps = _smooth_distribution(p)
        qs = _smooth_distribution(q)
        if ps is None or qs is None:
            continue
        kl = _kl_divergence(ps, qs)
        if kl < best_kl:
            best_kl, best_t = kl, float(hist_edges[stop])
    return best_t


def _set_calib_table(calib_nodes, ranges):
    """Bake ranges into quantize/requantize nodes (ref:
    quantize_graph_pass.cc:345 SetCalibTableToQuantizedGraph)."""
    baked = 0
    for key, nodes in calib_nodes.items():
        if key not in ranges:
            continue
        mn, mx = ranges[key]
        for n in nodes:
            n.attrs["min_calib_range"] = float(mn)
            n.attrs["max_calib_range"] = float(mx)
            baked += 1
    return baked


def _offline_quantize_params(qsym, arg_params):
    """Quantize weight params host-side and splice the results in as
    constants (ref: quantize_graph_pass.cc:65 OfflineParams)."""
    new_params = dict(arg_params)
    for node in qsym._topo():
        if node.op != "_contrib_quantize_v2":
            continue
        src, k = node.inputs[0]
        if src.op is not None or src.name not in arg_params:
            continue
        w = arg_params[src.name]
        a = w.asnumpy() if isinstance(w, nd.NDArray) else np.asarray(w)
        amax = float(np.abs(a).max()) or 1.0
        q = np.clip(np.rint(a * (INT8_RANGE / amax)),
                    -INT8_RANGE, INT8_RANGE).astype(np.int8)
        qname = f"{src.name}_int8"
        new_params[qname] = _array_like(q, w)
        new_params[f"{qname}_min"] = _array_like(
            np.array(-amax, np.float32), w)
        new_params[f"{qname}_max"] = _array_like(
            np.array(amax, np.float32), w)
        # rewrite the quantize node into a passthrough variable triple
        node.op = None
        node.name = qname
        node.attrs = {}
        node.inputs = []
    # re-point consumers of outputs 1/2 at the min/max vars: done by
    # replacing entries during executor walk is not possible for a var
    # with 3 outputs — instead insert explicit var nodes
    memo = {}

    def fix(node):
        if id(node) in memo:
            return
        memo[id(node)] = True
        for i, (c, k) in enumerate(node.inputs):
            fix(c)
            if c.op is None and c.name.endswith("_int8") and k in (1, 2):
                suffix = "_min" if k == 1 else "_max"
                node.inputs[i] = (_Node(None, c.name + suffix), 0)

    for n, _ in qsym._outputs:
        fix(n)
    return qsym, new_params


def dequantize_offline_params(qarg_params):
    """Inverse of ``_offlineQuantizeParams`` for weight-only execution
    lowerings (serving/variants.py): every ``<w>_int8`` constant (with
    its ``_min``/``_max`` scale pair) folds back to an fp32 ``<w>``
    through the calibrated symmetric scale. The round-trip keeps the
    quantization's accuracy effect while letting a backend without
    fast int8 compute serve the quantized model at fp32 speed.
    Returns ``{base_name: NDArray}`` for exactly the params the
    QuantizeGraph pass quantized offline."""
    def _np(v):
        return v.asnumpy() if isinstance(v, nd.NDArray) \
            else np.asarray(v)

    out = {}
    for k, v in qarg_params.items():
        if not k.endswith("_int8"):
            continue
        amax = qarg_params.get(k + "_max")
        if amax is None:
            continue
        out[k[:-len("_int8")]] = _array_like(
            _np(v).astype(np.float32) * (float(_np(amax)) / INT8_RANGE), v)
    return out


def quantize_model(sym, arg_params, aux_params, ctx=None,
                   excluded_sym_names=None, calib_mode="entropy",
                   calib_data=None, num_calib_examples=None,
                   quantized_dtype="int8", logger=logging, fold_bn=True,
                   **kwargs):
    """End-to-end int8 conversion (ref: quantization.py:423). The fp32
    calibration runs on ``ctx`` (the current context when None)."""
    if quantized_dtype not in ("int8", "auto"):
        raise MXNetError(f"unsupported quantized_dtype {quantized_dtype}")
    if fold_bn:
        sym, arg_params = fold_batch_norm(sym, arg_params, aux_params)
    qsym, calib_nodes = _quantize_symbol(
        sym, excluded_sym_names=excluded_sym_names or ())

    if calib_mode != "none":
        if calib_data is None:
            raise MXNetError("calib_data required for calibration")
        num = num_calib_examples or (calib_data.batch_size * 10)
        stats, samples = _collect_layer_outputs(
            sym, arg_params, aux_params, calib_data, num, logger, ctx)
        ranges = {}
        for key in calib_nodes:
            if key in stats:
                if calib_mode == "naive":
                    ranges[key] = stats[key]
                elif calib_mode == "entropy":
                    t = _get_optimal_threshold(samples[key])
                    ranges[key] = (-t, t)
                else:
                    raise MXNetError(f"unknown calib_mode {calib_mode}")
        n = _set_calib_table(calib_nodes, ranges)
        logger.info("quantization: baked %d calibrated ranges "
                    "(mode=%s)", n, calib_mode)

    qsym, qarg_params = _offline_quantize_params(qsym, arg_params)
    # drop fp32 weights replaced by offline int8 versions
    used = set(qsym.list_inputs())
    qarg_params = {k: v for k, v in qarg_params.items() if k in used}
    return qsym, qarg_params, dict(aux_params)


def quantized_forward(qsym, qarg_params, qaux_params, device=None):
    """``(fwd, params)`` for a quantized graph on ``device`` (``cuda:0``
    when None), lowered by ``predictor.compile_symbol_forward``:
    ``params`` is the tuple of its parameters there, and ``fwd(params,
    data)`` runs the unpartitioned graph (the plain ``requantize``, as
    the JAX package's ``quantize_net`` program) on ``data`` (a numpy
    array, NDArray or tensor) and returns its first output, a tensor on
    the device. ``fwd.symbol`` is ``qsym``, whose calibrated ranges are
    its table."""
    from ..ndarray.ndarray import as_tensor
    from ..predictor import compile_symbol_forward

    run, params = compile_symbol_forward(
        qsym, {**qarg_params, **qaux_params}, device)

    def fwd(pvals, data):
        return run(pvals, {"data": as_tensor(data)})[0]

    fwd.symbol = qsym
    return fwd, params


def quantize_net(net, batch, calib_data, mode="naive",
                 excluded_sym_names=None, ctx=None):
    """Quantize a gluon network end to end (the reference's
    example/quantization flow as one call). ``net`` is a HybridBlock or
    a model-zoo name (a name builds and initializes a fresh net). The
    net is traced to a Symbol at ``(batch,) + calib_data.shape[1:]``,
    calibrated on ``calib_data`` (numpy, NCHW) with ``mode`` ("naive" or
    "entropy") and quantized with offline weights, on ``ctx`` (``cuda:0``
    when None; raises without CUDA unless the CPU is asked for).

    Returns ``(fwd, params)`` as :func:`quantized_forward` does:
    ``fwd(params, data)`` runs the int8 graph on the device.
    """
    from ..context import Context, resolve_device
    from ..gluon.block import infer_shapes
    from ..gluon.model_zoo import vision
    from ..io import NDArrayIter
    from ..symbol.trace import trace_block

    device = resolve_device(ctx)
    calib_data = np.asarray(calib_data, np.float32)
    if isinstance(net, str):
        net = vision.get_model(net)
        net.initialize(ctx=device)
    infer_shapes(net, (batch,) + tuple(calib_data.shape[1:]))
    sym_out, params = trace_block(net)
    aux_names = set(sym_out.list_auxiliary_states())
    arg_params = {k: p.data().detach() for k, p in params.items()
                  if k not in aux_names}
    aux_params = {k: p.data().detach() for k, p in params.items()
                  if k in aux_names}
    with Context(device):   # calibration batches go to the device
        it = NDArrayIter(data=calib_data,
                         batch_size=min(len(calib_data), 8))
        qsym, qarg, qaux = quantize_model(
            sym_out, arg_params, aux_params, ctx=Context(device),
            calib_mode=mode, excluded_sym_names=excluded_sym_names,
            calib_data=it, num_calib_examples=len(calib_data))
    return quantized_forward(qsym, qarg, qaux, device)
