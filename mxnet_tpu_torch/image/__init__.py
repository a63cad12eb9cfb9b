"""mx.image: image loading and the augmenter zoo (the port of
``mxnet_tpu/image``; ref: python/mxnet/image/). The detection
augmenters and ``ImageDetIter`` (``image/detection.py``) are not ported
yet."""
from .image import (Augmenter, BrightnessJitterAug, CastAug,
                    CenterCropAug, ColorJitterAug, ContrastJitterAug,
                    CreateAugmenter, ForceResizeAug, HorizontalFlipAug,
                    HueJitterAug, ImageIter, LightingAug, RandomCropAug,
                    RandomGrayAug, RandomOrderAug, RandomRotateAug,
                    RandomShearAug, RandomSizedCropAug, ResizeAug,
                    SaturationJitterAug, SequentialAug, color_normalize,
                    imdecode, imread, imresize, random_crop,
                    center_crop, fixed_crop, scale_down)

__all__ = ["Augmenter", "BrightnessJitterAug", "CastAug", "CenterCropAug",
           "ColorJitterAug", "ContrastJitterAug", "CreateAugmenter",
           "ForceResizeAug", "HorizontalFlipAug", "HueJitterAug",
           "ImageIter", "LightingAug", "RandomCropAug", "RandomGrayAug",
           "RandomOrderAug", "RandomRotateAug", "RandomShearAug",
           "RandomSizedCropAug", "ResizeAug", "SaturationJitterAug",
           "SequentialAug", "center_crop", "color_normalize", "fixed_crop",
           "imdecode", "imread", "imresize", "random_crop", "scale_down"]
