"""Vision model zoo of the port (``mxnet_tpu/gluon/model_zoo/vision``):
the ResNet family. The other families (VGG, AlexNet, MobileNet,
SqueezeNet, DenseNet, Inception) wait; ``pretrained=True`` raises, as
there are no weights to fetch."""
from .resnet import (ResNetV1, ResNetV2, get_resnet, resnet18_v1,
                     resnet34_v1, resnet50_v1, resnet101_v1, resnet152_v1,
                     resnet18_v2, resnet34_v2, resnet50_v2, resnet101_v2,
                     resnet152_v2)

_models = {
    "resnet18_v1": resnet18_v1, "resnet34_v1": resnet34_v1,
    "resnet50_v1": resnet50_v1, "resnet101_v1": resnet101_v1,
    "resnet152_v1": resnet152_v1, "resnet18_v2": resnet18_v2,
    "resnet34_v2": resnet34_v2, "resnet50_v2": resnet50_v2,
    "resnet101_v2": resnet101_v2, "resnet152_v2": resnet152_v2,
}


def get_model(name, **kwargs):
    """A model of the zoo by name (``get_model("resnet50_v1",
    layout="NHWC")``)."""
    name = name.lower()
    if name not in _models:
        raise ValueError(
            f"model {name!r} not in the port's model zoo; available: "
            f"{sorted(_models)}")
    return _models[name](**kwargs)
