"""The conv rule of the "XLA" fusion backend (the port of
``mxnet_tpu/subgraph/xla_fuse.py``): Convolution → [BatchNorm] → [add]
→ [relu] collapsed into one ``_sg_xla_conv`` op (the mirror of the
MKL-DNN property, ref: mkldnn_conv_property.cc kStart→kBN→kSum→kSuccess).

The gain is algebraic: the inference BatchNorm folds into the conv
weights before the product (w' = w·γ/√(σ²+ε), b' = β+(b−μ)·γ/√(σ²+ε)),
so the normalisation disappears. All attr reads coerce through
``partition.as_*``: JSON-loaded symbols may carry string attrs.
"""
from __future__ import annotations

import torch

from ..ops import registry as _reg
from ..ops.nn import convolution
from ..symbol import symbol as _sym
from ..symbol.symbol import _Node
from .partition import (ChainPattern, ChainSelector, Stage,
                        SubgraphProperty, as_bool, as_float, as_int,
                        as_tuple)

_SUM_OPS = ("elemwise_add", "broadcast_add", "_add")


@_reg.register("_sg_xla_conv")
def sg_xla_conv(data, weight, *rest, kernel=(), stride=(), dilate=(),
                pad=(), num_filter=0, num_group=1, no_bias=False,
                layout=None, with_bn=False, with_sum=False, with_act=False,
                bn_eps=1e-3, bn_fix_gamma=True):
    """Fused Convolution[+BatchNorm][+sum][+relu].

    Input order after (data, weight): [bias], [gamma, beta, moving_mean,
    moving_var], [sum_input], presence controlled by attrs.
    """
    rest = list(rest)
    bias = rest.pop(0) if not as_bool(no_bias) else None
    if as_bool(with_bn):
        gamma, beta, mean, var = rest[:4]
        rest = rest[4:]
        g = torch.ones_like(gamma) if as_bool(bn_fix_gamma, True) else gamma
        scale = g * torch.rsqrt(var + as_float(bn_eps, 1e-3))
        weight = weight * scale.reshape((-1,) + (1,) * (weight.ndim - 1))
        fold_b = beta - mean * scale
        bias = fold_b if bias is None else bias * scale + fold_b
    out = convolution(data, weight, bias, kernel=as_tuple(kernel),
                      stride=as_tuple(stride), dilate=as_tuple(dilate),
                      pad=as_tuple(pad), num_group=as_int(num_group, 1),
                      layout=layout, no_bias=bias is None)
    if as_bool(with_sum):
        out = out + rest.pop(0)
    if as_bool(with_act):
        out = torch.relu(out)
    return out


def _bn_foldable(chain, bn_node):
    """Only a BatchNorm over the conv's channel axis folds."""
    conv = chain[0]
    layout = str(conv.attrs.get("layout") or "")
    nd = len(as_tuple(conv.attrs.get("kernel", ()))) or 2
    c_axis = (nd + 1) if layout and not layout.startswith("NC") else 1
    return as_int(bn_node.attrs.get("axis", 1), 1) % (nd + 2) == c_axis


def _is_relu(chain, act_node):
    return act_node.attrs.get("act_type") == "relu"


_CONV_PATTERN = ChainPattern(
    seed_ops=("Convolution",),
    stages=(
        Stage("bn", ("BatchNorm",), guard=_bn_foldable),
        Stage("sum", _SUM_OPS),
        # relu is always the last post-op: sum applies before act
        Stage("act", ("Activation",), guard=_is_relu, terminal=True),
    ),
)


class XlaConvProperty(SubgraphProperty):
    op_name = "_sg_xla_conv"
    rule_name = "conv_bn_add_relu"
    priority = 100

    def create_selector(self):
        return ChainSelector(_CONV_PATTERN)

    def create_subgraph_node(self, nodes, external_inputs, idx):
        conv = next(n for n in nodes if n.op == "Convolution")
        bn = next((n for n in nodes if n.op == "BatchNorm"), None)
        keep = ("kernel", "stride", "dilate", "pad", "num_filter",
                "num_group", "no_bias", "layout")
        attrs = {k: v for k, v in conv.attrs.items() if k in keep}
        attrs["with_bn"] = bn is not None
        attrs["with_sum"] = any(n.op in _SUM_OPS for n in nodes)
        attrs["with_act"] = any(n.op == "Activation" for n in nodes)
        if bn is not None:
            attrs["bn_eps"] = as_float(bn.attrs.get("eps", 1e-3), 1e-3)
            attrs["bn_fix_gamma"] = as_bool(
                bn.attrs.get("fix_gamma", True), True)
        return _Node("_sg_xla_conv", f"sg_xla_conv_{conv.name}_{idx}",
                     attrs)


def _sg_conv_shapes(ins, attrs):
    """Parameter shapes of the fused node (weight/bias, folded BN
    vectors, the sum input at the conv output's shape)."""
    data = ins[0]
    if data is None:
        return None
    kernel = as_tuple(attrs.get("kernel", ()))
    stride = as_tuple(attrs.get("stride", ())) or (1,) * len(kernel)
    dilate = as_tuple(attrs.get("dilate", ())) or (1,) * len(kernel)
    pad = as_tuple(attrs.get("pad", ())) or (0,) * len(kernel)
    nf = as_int(attrs.get("num_filter", 0))
    ng = as_int(attrs.get("num_group", 1), 1)
    out = [None, (nf, int(data[1]) // ng) + kernel]
    if not as_bool(attrs.get("no_bias", False)):
        out.append((nf,))
    if as_bool(attrs.get("with_bn")):
        out.extend([(nf,)] * 4)
    if as_bool(attrs.get("with_sum")):
        spatial = tuple(
            (data[2 + i] + 2 * pad[i] - (dilate[i] * (kernel[i] - 1) + 1))
            // stride[i] + 1 for i in range(len(kernel)))
        out.append((data[0], nf) + spatial)
    return out


_sym._PARAM_SHAPE_INFER["_sg_xla_conv"] = _sg_conv_shapes
