"""Convolution and pooling layers (the port of
``mxnet_tpu/gluon/nn/conv_layers.py``): Conv2D, the 2-d max and
average pools and the 2-d global pools, in NC-first or channel-last
layouts. The 1-d, 3-d and transposed convolutions, the 1-d and 3-d
pools and ``ReflectionPad2D`` wait."""
from __future__ import annotations

import threading

from ...base import MXNetError
from ..block import HybridBlock
from .basic_layers import Activation


def _pair(x, n):
    if isinstance(x, (tuple, list)):
        return tuple(x)
    return (x,) * n


_layout_tls = threading.local()
_NC_FIRST = {"NCW", "NCHW", "NCDHW"}
_CHANNEL_LAST_BY_ND = {1: "NWC", 2: "NHWC", 3: "NDHWC"}


class layout_scope:
    """Build layers channel-last without per-layer layout arguments:
    inside ``with nn.layout_scope("NHWC"):`` every Conv/Pool layer
    constructed with the default NC-first layout takes the channel-last
    layout of its rank, and BatchNorm's default axis=1 becomes -1. The
    weights stay OIHW either way, so checkpoints of the two layouts
    interchange. On the card a channel-last layer's convolution is
    cuDNN's channels-last one, with no copy at either side."""

    def __init__(self, layout="NHWC"):
        if layout not in ("NHWC", "NWC", "NDHWC", None):
            raise MXNetError(f"layout_scope: unsupported {layout!r}")
        self._layout = layout

    def __enter__(self):
        self._prev = getattr(_layout_tls, "value", None)
        _layout_tls.value = self._layout
        return self

    def __exit__(self, *exc):
        _layout_tls.value = self._prev
        return False


def active_layout():
    return getattr(_layout_tls, "value", None)


def _resolve_layout(layout, nd):
    """Switch a defaulted NC-first layout to channel-last when a
    channel-last layout_scope is active (explicit layouts win)."""
    if active_layout() and layout in _NC_FIRST:
        return _CHANNEL_LAST_BY_ND[nd]
    return layout


class _Conv(HybridBlock):
    def __init__(self, channels, kernel_size, strides, padding, dilation,
                 groups, layout, in_channels=0, activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._channels = channels
        self._in_channels = in_channels
        ndim = len(kernel_size)
        layout = _resolve_layout(layout, ndim)
        self._kwargs = {
            "kernel": kernel_size, "stride": strides, "dilate": dilation,
            "pad": padding, "num_filter": channels, "num_group": groups,
            "no_bias": not use_bias, "layout": layout}
        self._groups = groups
        with self.name_scope():
            wshape = (channels, in_channels // groups if in_channels else 0) \
                + kernel_size
            self.weight = self.params.get(
                "weight", shape=wshape, init=weight_initializer,
                allow_deferred_init=True)
            if use_bias:
                self.bias = self.params.get(
                    "bias", shape=(channels,), init=bias_initializer,
                    allow_deferred_init=True)
            else:
                self.bias = None
            self.act = Activation(activation) if activation else None

    def infer_shape(self, x, *args):
        c = x.shape[self._kwargs["layout"].index("C")]
        self.weight.shape_inferred(
            (self._channels, c // self._groups) + self._kwargs["kernel"])
        if self.bias is not None:
            self.bias.shape_inferred((self._channels,))

    def hybrid_forward(self, F, x, weight, bias=None):
        out = F.Convolution(x, weight, bias, **self._kwargs)
        if self.act is not None:
            out = self.act(out)
        return out


class Conv2D(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1), padding=(0, 0),
                 dilation=(1, 1), groups=1, layout="NCHW", in_channels=0,
                 activation=None, use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", prefix=None, params=None):
        super().__init__(channels, _pair(kernel_size, 2), _pair(strides, 2),
                         _pair(padding, 2), _pair(dilation, 2), groups,
                         layout, in_channels, activation, use_bias,
                         weight_initializer, bias_initializer,
                         prefix=prefix, params=params)


class _Pooling(HybridBlock):
    def __init__(self, pool_size, strides, padding, ceil_mode, global_pool,
                 pool_type, layout, count_include_pad=None, prefix=None,
                 params=None):
        super().__init__(prefix=prefix, params=params)
        if strides is None:
            strides = pool_size
        layout = _resolve_layout(layout, len(pool_size))
        self._kwargs = {
            "kernel": pool_size, "stride": strides, "pad": padding,
            "pool_type": pool_type, "global_pool": global_pool,
            "pooling_convention": "full" if ceil_mode else "valid"}
        if layout and "C" in layout and not layout.startswith("NC"):
            self._kwargs["layout"] = layout
        if count_include_pad is not None:
            self._kwargs["count_include_pad"] = count_include_pad

    def hybrid_forward(self, F, x):
        return F.Pooling(x, **self._kwargs)


class MaxPool2D(_Pooling):
    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 layout="NCHW", ceil_mode=False, prefix=None, params=None):
        super().__init__(_pair(pool_size, 2),
                         None if strides is None else _pair(strides, 2),
                         _pair(padding, 2), ceil_mode, False, "max", layout,
                         prefix=prefix, params=params)


class AvgPool2D(_Pooling):
    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 layout="NCHW", ceil_mode=False, count_include_pad=True,
                 prefix=None, params=None):
        super().__init__(_pair(pool_size, 2),
                         None if strides is None else _pair(strides, 2),
                         _pair(padding, 2), ceil_mode, False, "avg", layout,
                         count_include_pad, prefix=prefix, params=params)


class GlobalMaxPool2D(_Pooling):
    def __init__(self, layout="NCHW", prefix=None, params=None):
        super().__init__((1, 1), None, (0, 0), False, True, "max", layout,
                         prefix=prefix, params=params)


class GlobalAvgPool2D(_Pooling):
    def __init__(self, layout="NCHW", prefix=None, params=None):
        super().__init__((1, 1), None, (0, 0), False, True, "avg", layout,
                         prefix=prefix, params=params)
