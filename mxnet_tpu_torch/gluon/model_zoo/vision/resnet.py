"""ResNet V1/V2 (the port of
``mxnet_tpu/gluon/model_zoo/vision/resnet.py``): BasicBlock/Bottleneck x
{18, 34, 50, 101, 152}, NCHW or NHWC (``layout=``), the standard 7x7
stem or its space-to-depth form (``stem="s2d"``). Every parameter has
the JAX package's name, and the weights of every layout and stem are
the same OIHW arrays, so one checkpoint serves them all.
``pretrained=True`` raises: there are no weights to fetch.
"""
from __future__ import annotations

from ....base import MXNetError
from ...block import HybridBlock
from ... import nn
from ...nn import conv_layers as _conv_layers


class BasicBlockV1(HybridBlock):
    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.body = nn.HybridSequential(prefix="")
            self.body.add(nn.Conv2D(channels, 3, stride, 1,
                                    use_bias=False, in_channels=in_channels))
            self.body.add(nn.BatchNorm())
            self.body.add(nn.Activation("relu"))
            self.body.add(nn.Conv2D(channels, 3, 1, 1, use_bias=False,
                                    in_channels=channels))
            self.body.add(nn.BatchNorm())
            if downsample:
                self.downsample = nn.HybridSequential(prefix="")
                self.downsample.add(nn.Conv2D(channels, 1, stride,
                                              use_bias=False,
                                              in_channels=in_channels))
                self.downsample.add(nn.BatchNorm())
            else:
                self.downsample = None

    def hybrid_forward(self, F, x):
        residual = x
        x = self.body(x)
        if self.downsample is not None:
            residual = self.downsample(residual)
        return F.Activation(residual + x, act_type="relu")


class BottleneckV1(HybridBlock):
    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.body = nn.HybridSequential(prefix="")
            self.body.add(nn.Conv2D(channels // 4, 1, stride, use_bias=False))
            self.body.add(nn.BatchNorm())
            self.body.add(nn.Activation("relu"))
            self.body.add(nn.Conv2D(channels // 4, 3, 1, 1, use_bias=False))
            self.body.add(nn.BatchNorm())
            self.body.add(nn.Activation("relu"))
            self.body.add(nn.Conv2D(channels, 1, 1, use_bias=False))
            self.body.add(nn.BatchNorm())
            if downsample:
                self.downsample = nn.HybridSequential(prefix="")
                self.downsample.add(nn.Conv2D(channels, 1, stride,
                                              use_bias=False,
                                              in_channels=in_channels))
                self.downsample.add(nn.BatchNorm())
            else:
                self.downsample = None

    def hybrid_forward(self, F, x):
        residual = x
        x = self.body(x)
        if self.downsample is not None:
            residual = self.downsample(residual)
        return F.Activation(residual + x, act_type="relu")


class BasicBlockV2(HybridBlock):
    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.bn1 = nn.BatchNorm()
            self.conv1 = nn.Conv2D(channels, 3, stride, 1, use_bias=False,
                                   in_channels=in_channels)
            self.bn2 = nn.BatchNorm()
            self.conv2 = nn.Conv2D(channels, 3, 1, 1, use_bias=False,
                                   in_channels=channels)
            if downsample:
                self.downsample = nn.Conv2D(channels, 1, stride,
                                            use_bias=False,
                                            in_channels=in_channels)
            else:
                self.downsample = None

    def hybrid_forward(self, F, x):
        residual = x
        x = self.bn1(x)
        x = F.Activation(x, act_type="relu")
        if self.downsample is not None:
            residual = self.downsample(x)
        x = self.conv1(x)
        x = self.bn2(x)
        x = F.Activation(x, act_type="relu")
        x = self.conv2(x)
        return x + residual


class BottleneckV2(HybridBlock):
    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.bn1 = nn.BatchNorm()
            self.conv1 = nn.Conv2D(channels // 4, 1, 1, use_bias=False)
            self.bn2 = nn.BatchNorm()
            self.conv2 = nn.Conv2D(channels // 4, 3, stride, 1,
                                   use_bias=False)
            self.bn3 = nn.BatchNorm()
            self.conv3 = nn.Conv2D(channels, 1, 1, use_bias=False)
            if downsample:
                self.downsample = nn.Conv2D(channels, 1, stride,
                                            use_bias=False,
                                            in_channels=in_channels)
            else:
                self.downsample = None

    def hybrid_forward(self, F, x):
        residual = x
        x = self.bn1(x)
        x = F.Activation(x, act_type="relu")
        if self.downsample is not None:
            residual = self.downsample(x)
        x = self.conv1(x)
        x = self.bn2(x)
        x = F.Activation(x, act_type="relu")
        x = self.conv2(x)
        x = self.bn3(x)
        x = F.Activation(x, act_type="relu")
        x = self.conv3(x)
        return x + residual


def _layout_build_scope(layout):
    """Constructing with layout="NHWC" must build every conv/pool/BN in
    the subtree channel-last — resolve the scope HERE so direct class
    construction works, not only the get_resnet factory."""
    from contextlib import nullcontext
    return nn.layout_scope("NHWC") if layout == "NHWC" else nullcontext()


class S2DStemConv(HybridBlock):
    """7x7/s2 stem conv computed in space-to-depth form (ops/nn.py
    s2d_stem_conv). Holds the SAME (O, C, 7, 7) OIHW weight a standard
    stem Conv2D would, so checkpoints interoperate; only the compute
    layout differs."""

    def __init__(self, channels, in_channels=3, block=2, **kwargs):
        super().__init__(**kwargs)
        self._block = block
        self._layout = _conv_layers.active_layout() or "NCHW"
        with self.name_scope():
            self.weight = self.params.get(
                "weight", shape=(channels, in_channels, 7, 7),
                init=None, allow_deferred_init=False)

    def hybrid_forward(self, F, x, weight):
        return F._contrib_s2d_stem_conv(
            x, weight, stride=2, pad=3, block=self._block,
            layout=self._layout)


def _stem_layers(stem, channels0):
    """The reference's 7x7 stem, optionally in space-to-depth form."""
    if stem == "s2d":
        # explicit Conv2D-convention prefix: the stem weight must be
        # named <net>_conv2d0_weight exactly like the standard stem's
        # auto-named Conv2D, or load_parameters/pretrained checkpoints
        # cannot cross stems (stage convs live in stage*_ scopes, so
        # the bare conv2d0_ name stays collision-free)
        conv = S2DStemConv(channels0, prefix="conv2d0_")
    elif stem == "standard":
        conv = nn.Conv2D(channels0, 7, 2, 3, use_bias=False)
    else:
        raise MXNetError(f"unknown stem {stem!r}")
    return [conv, nn.BatchNorm(), nn.Activation("relu"),
            nn.MaxPool2D(3, 2, 1)]


class ResNetV1(HybridBlock):
    def __init__(self, block, layers, channels, classes=1000, thumbnail=False,
                 layout="NCHW", stem="standard", **kwargs):
        super().__init__(**kwargs)
        assert len(layers) == len(channels) - 1
        self._data_layout = layout
        with _layout_build_scope(layout), self.name_scope():
            self.features = nn.HybridSequential(prefix="")
            if thumbnail:
                self.features.add(nn.Conv2D(channels[0], 3, 1, 1,
                                            use_bias=False))
            else:
                for layer in _stem_layers(stem, channels[0]):
                    self.features.add(layer)
            for i, num_layer in enumerate(layers):
                stride = 1 if i == 0 else 2
                self.features.add(self._make_layer(
                    block, num_layer, channels[i + 1], stride, i + 1,
                    in_channels=channels[i]))
            self.features.add(nn.GlobalAvgPool2D())
            self.output = nn.Dense(classes, in_units=channels[-1])

    def _make_layer(self, block, layers, channels, stride, stage_index,
                    in_channels=0):
        layer = nn.HybridSequential(prefix=f"stage{stage_index}_")
        with layer.name_scope():
            layer.add(block(channels, stride, channels != in_channels,
                            in_channels=in_channels, prefix=""))
            for _ in range(layers - 1):
                layer.add(block(channels, 1, False, in_channels=channels,
                                prefix=""))
        return layer

    def hybrid_forward(self, F, x):
        if self._data_layout == "NHWC":
            # models always take NCHW user data; one transpose at the
            # graph edge puts the whole internal graph channel-last
            x = F.transpose(x, axes=(0, 2, 3, 1))
        x = self.features(x)
        return self.output(x)


class ResNetV2(HybridBlock):
    def __init__(self, block, layers, channels, classes=1000, thumbnail=False,
                 layout="NCHW", stem="standard", **kwargs):
        super().__init__(**kwargs)
        assert len(layers) == len(channels) - 1
        self._data_layout = layout
        with _layout_build_scope(layout), self.name_scope():
            self.features = nn.HybridSequential(prefix="")
            self.features.add(nn.BatchNorm(scale=False, center=False))
            if thumbnail:
                self.features.add(nn.Conv2D(channels[0], 3, 1, 1,
                                            use_bias=False))
            else:
                for layer in _stem_layers(stem, channels[0]):
                    self.features.add(layer)
            in_channels = channels[0]
            for i, num_layer in enumerate(layers):
                stride = 1 if i == 0 else 2
                self.features.add(self._make_layer(
                    block, num_layer, channels[i + 1], stride, i + 1,
                    in_channels=in_channels))
                in_channels = channels[i + 1]
            self.features.add(nn.BatchNorm())
            self.features.add(nn.Activation("relu"))
            self.features.add(nn.GlobalAvgPool2D())
            self.features.add(nn.Flatten())
            self.output = nn.Dense(classes, in_units=in_channels)

    _make_layer = ResNetV1._make_layer

    def hybrid_forward(self, F, x):
        if self._data_layout == "NHWC":
            x = F.transpose(x, axes=(0, 2, 3, 1))
        x = self.features(x)
        return self.output(x)


resnet_spec = {
    18: ("basic_block", [2, 2, 2, 2], [64, 64, 128, 256, 512]),
    34: ("basic_block", [3, 4, 6, 3], [64, 64, 128, 256, 512]),
    50: ("bottle_neck", [3, 4, 6, 3], [64, 256, 512, 1024, 2048]),
    101: ("bottle_neck", [3, 4, 23, 3], [64, 256, 512, 1024, 2048]),
    152: ("bottle_neck", [3, 8, 36, 3], [64, 256, 512, 1024, 2048]),
}

resnet_net_versions = [ResNetV1, ResNetV2]
resnet_block_versions = [
    {"basic_block": BasicBlockV1, "bottle_neck": BottleneckV1},
    {"basic_block": BasicBlockV2, "bottle_neck": BottleneckV2},
]


def get_resnet(version, num_layers, pretrained=False, ctx=None, root=None,
               **kwargs):
    if num_layers not in resnet_spec:
        raise MXNetError(f"invalid resnet depth {num_layers}")
    block_type, layers, channels = resnet_spec[num_layers]
    resnet_class = resnet_net_versions[version - 1]
    block_class = resnet_block_versions[version - 1][block_type]
    if pretrained:
        raise MXNetError(
            f"resnet{num_layers}_v{version}: pretrained weights are not "
            "available (nothing is downloaded); build the net, then "
            "load_parameters from a local file")
    return resnet_class(block_class, layers, channels, **kwargs)


def resnet18_v1(**kwargs):
    return get_resnet(1, 18, **kwargs)


def resnet34_v1(**kwargs):
    return get_resnet(1, 34, **kwargs)


def resnet50_v1(**kwargs):
    return get_resnet(1, 50, **kwargs)


def resnet101_v1(**kwargs):
    return get_resnet(1, 101, **kwargs)


def resnet152_v1(**kwargs):
    return get_resnet(1, 152, **kwargs)


def resnet18_v2(**kwargs):
    return get_resnet(2, 18, **kwargs)


def resnet34_v2(**kwargs):
    return get_resnet(2, 34, **kwargs)


def resnet50_v2(**kwargs):
    return get_resnet(2, 50, **kwargs)


def resnet101_v2(**kwargs):
    return get_resnet(2, 101, **kwargs)


def resnet152_v2(**kwargs):
    return get_resnet(2, 152, **kwargs)
