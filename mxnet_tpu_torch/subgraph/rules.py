"""The rest of the "XLA" backend's rule fleet (the port of
``mxnet_tpu/subgraph/rules.py``; ``xla_fuse.py`` holds the conv rule):

- ``fc_add_act``: FullyConnected → [add] → [activation] collapsed into
  ``_sg_xla_fc`` (ref: mkldnn_fc_property.cc);
- ``quantize_conv_requantize``: [quantize_v2 →] quantized_conv →
  requantize [→ int8 relu] collapsed into ``_sg_xla_quant_conv``, whose
  requantize(+relu) tail is the hand-written epilogue kernel
  (``ops/int8.quantized_conv_epilogue``, ``csrc/int8_epilogue.cu``).
  ``MXTPU_KERNEL_INT8_EPILOGUE=0`` switches that tail back to the unfused
  ``requantize`` + ``quantized_act`` ops, as in the JAX package. A
  quantize shared by two consumers stays outside the cluster (the pull
  is optional) and the conv→requantize core still fuses, taking the
  int8 data and its range as inputs (``with_quantize=False``).

The three rules register as ONE fleet, applied in (-priority,
rule_name) order: conv_bn_add_relu (100), quantize_conv_requantize
(90), fc_add_act (80).
"""
from __future__ import annotations

import os

from ..ops import int8 as _int8
from ..ops import registry as _reg
from ..ops.nn import activation, fully_connected
from ..ops.quantized import (quantize_v2, quantized_act, quantized_conv,
                             requantize)
from ..symbol import symbol as _sym
from ..symbol.symbol import _Node
from .partition import (ChainPattern, ChainSelector, Stage,
                        SubgraphProperty, as_bool, as_float, as_int,
                        as_tuple, register_subgraph_property)
from .xla_fuse import _SUM_OPS, XlaConvProperty

_FC_ACTS = ("relu", "sigmoid", "tanh", "softrelu", "softsign")


@_reg.register("_sg_xla_fc")
def sg_xla_fc(data, weight, *rest, num_hidden=0, no_bias=False,
              flatten=True, with_sum=False, with_act=False,
              act_type="relu"):
    """Fused FullyConnected[+sum][+activation]; input order after
    (data, weight): [bias], [sum_input]."""
    rest = list(rest)
    bias = rest.pop(0) if not as_bool(no_bias) else None
    out = fully_connected(data, weight, bias, no_bias=bias is None,
                          flatten=as_bool(flatten, True))
    if as_bool(with_sum):
        out = out + rest.pop(0)
    if as_bool(with_act):
        out = activation(out, act_type=act_type)
    return out


def _is_fc_act(chain, act_node):
    return act_node.attrs.get("act_type", "relu") in _FC_ACTS


_FC_PATTERN = ChainPattern(
    seed_ops=("FullyConnected",),
    stages=(
        Stage("sum", _SUM_OPS),
        Stage("act", ("Activation",), guard=_is_fc_act, terminal=True),
    ),
)


class XlaFCProperty(SubgraphProperty):
    op_name = "_sg_xla_fc"
    rule_name = "fc_add_act"
    priority = 80

    def create_selector(self):
        return ChainSelector(_FC_PATTERN)

    def create_subgraph_node(self, nodes, external_inputs, idx):
        fc = next(n for n in nodes if n.op == "FullyConnected")
        act = next((n for n in nodes if n.op == "Activation"), None)
        keep = ("num_hidden", "no_bias", "flatten")
        attrs = {k: v for k, v in fc.attrs.items() if k in keep}
        attrs["with_sum"] = any(n.op in _SUM_OPS for n in nodes)
        attrs["with_act"] = act is not None
        if act is not None:
            attrs["act_type"] = act.attrs.get("act_type", "relu")
        return _Node("_sg_xla_fc", f"sg_xla_fc_{fc.name}_{idx}", attrs)


def _sg_fc_shapes(ins, attrs):
    data = ins[0]
    if data is None:
        return None
    nh = as_int(attrs.get("num_hidden", 0))
    flatten = as_bool(attrs.get("flatten", True), True)
    in_units = 1
    for d in (data[1:] if flatten else data[-1:]):
        in_units *= int(d)
    out = [None, (nh, in_units)]
    if not as_bool(attrs.get("no_bias", False)):
        out.append((nh,))
    if as_bool(attrs.get("with_sum")):
        lead = (data[0],) if flatten else tuple(data[:-1])
        out.append(lead + (nh,))
    return out


@_reg.register("_sg_xla_quant_conv", num_outputs=3)
def sg_xla_quant_conv(*args, kernel=(), stride=(), dilate=(), pad=(),
                      num_filter=0, num_group=1, no_bias=False,
                      layout="NCHW", with_quantize=True, with_act=False,
                      q_min_calib=None, q_max_calib=None,
                      r_min_calib=None, r_max_calib=None):
    """Fused [quantize_v2 →] quantized_conv → requantize [→ int8 relu].

    Input order with ``with_quantize``: (data_fp32, weight_i8, [bias],
    min_weight, max_weight, [min_bias, max_bias]); without it the data
    arrives quantized with its range after the bias: (data_i8,
    weight_i8, [bias], min_data, max_data, min_weight, max_weight,
    [min_bias, max_bias]), the first-use order the partitioner collects
    external inputs in. Outputs mirror requantize / quantized_act:
    (int8, min, max).
    """
    no_bias = as_bool(no_bias)
    with_act = as_bool(with_act)
    args = list(args)
    if as_bool(with_quantize, True):
        qdata, min_data, max_data = quantize_v2(
            args.pop(0), min_calib_range=q_min_calib,
            max_calib_range=q_max_calib)
        weight = args.pop(0)
        bias = args.pop(0) if not no_bias else None
    else:
        qdata = args.pop(0)
        weight = args.pop(0)
        bias = args.pop(0) if not no_bias else None
        min_data, max_data = args.pop(0), args.pop(0)
    min_w, max_w = args.pop(0), args.pop(0)
    if no_bias:
        conv_args = (qdata, weight, min_data, max_data, min_w, max_w)
    else:
        min_b, max_b = args.pop(0), args.pop(0)
        conv_args = (qdata, weight, bias, min_data, max_data,
                     min_w, max_w, min_b, max_b)
    acc, amin, amax = quantized_conv(
        *conv_args, kernel=as_tuple(kernel), stride=as_tuple(stride),
        dilate=as_tuple(dilate), pad=as_tuple(pad), num_filter=num_filter,
        num_group=as_int(num_group, 1), no_bias=no_bias, layout=layout)
    if os.environ.get("MXTPU_KERNEL_INT8_EPILOGUE", "auto").lower() \
            not in ("0", "off", "false", "no"):
        return _int8.quantized_conv_epilogue(
            acc, amin, amax, min_calib_range=r_min_calib,
            max_calib_range=r_max_calib, relu=with_act)
    out, omin, omax = requantize(acc, amin, amax,
                                 min_calib_range=r_min_calib,
                                 max_calib_range=r_max_calib)
    if with_act:
        out, omin, omax = quantized_act(out, omin, omax)
    return out, omin, omax


def _is_int8_relu(chain, act_node):
    return act_node.attrs.get("act_type", "relu") == "relu"


_QUANT_PATTERN = ChainPattern(
    seed_ops=("_contrib_quantized_conv",),
    stages=(
        Stage("requantize", ("_contrib_requantize",), required=True),
        Stage("act", ("_contrib_quantized_act",), guard=_is_int8_relu,
              terminal=True),
    ),
    # pull the quantize feeding the conv's DATA input (index 0) into the
    # cluster; weight-side quantizes stay outside (usually offline-folded
    # into int8 parameter variables anyway)
    input_pulls={("_contrib_quantized_conv", 0): "_contrib_quantize_v2"},
)


class XlaQuantConvProperty(SubgraphProperty):
    op_name = "_sg_xla_quant_conv"
    rule_name = "quantize_conv_requantize"
    priority = 90

    def create_selector(self):
        return ChainSelector(_QUANT_PATTERN)

    def create_subgraph_node(self, nodes, external_inputs, idx):
        conv = next(n for n in nodes
                    if n.op == "_contrib_quantized_conv")
        q = next((n for n in nodes if n.op == "_contrib_quantize_v2"),
                 None)
        req = next(n for n in nodes if n.op == "_contrib_requantize")
        keep = ("kernel", "stride", "dilate", "pad", "num_filter",
                "num_group", "no_bias", "layout")
        attrs = {k: v for k, v in conv.attrs.items() if k in keep}
        attrs["with_quantize"] = q is not None
        attrs["with_act"] = any(n.op == "_contrib_quantized_act"
                                for n in nodes)
        attrs["__num_outputs__"] = 3
        for src, dst in ((q, "q"), (req, "r")):
            if src is None:
                continue
            mn = src.attrs.get("min_calib_range")
            mx = src.attrs.get("max_calib_range")
            if mn is not None and mx is not None:
                attrs[f"{dst}_min_calib"] = as_float(mn)
                attrs[f"{dst}_max_calib"] = as_float(mx)
        return _Node("_sg_xla_quant_conv",
                     f"sg_xla_quant_conv_{conv.name}_{idx}", attrs)


_sym._PARAM_SHAPE_INFER["_sg_xla_fc"] = _sg_fc_shapes

register_subgraph_property("XLA", (XlaConvProperty(),
                                   XlaQuantConvProperty(),
                                   XlaFCProperty()))
