"""mx.image: image loading, the augmenter zoo, and the detection
augmenters with ``ImageDetIter`` (the port of ``mxnet_tpu/image``; ref:
python/mxnet/image/)."""
from .image import (Augmenter, BrightnessJitterAug, CastAug,
                    CenterCropAug, ColorJitterAug, ContrastJitterAug,
                    CreateAugmenter, ForceResizeAug, HorizontalFlipAug,
                    HueJitterAug, ImageIter, LightingAug, RandomCropAug,
                    RandomGrayAug, RandomOrderAug, RandomRotateAug,
                    RandomShearAug, RandomSizedCropAug, ResizeAug,
                    SaturationJitterAug, SequentialAug, color_normalize,
                    imdecode, imread, imresize, random_crop,
                    center_crop, fixed_crop, scale_down)
from .detection import (CreateDetAugmenter, DetBorderAug,
                        DetHorizontalFlipAug, DetRandomCropAug,
                        ImageDetIter)

__all__ = ["Augmenter", "BrightnessJitterAug", "CastAug", "CenterCropAug",
           "ColorJitterAug", "ContrastJitterAug", "CreateAugmenter",
           "CreateDetAugmenter", "DetBorderAug", "DetHorizontalFlipAug",
           "DetRandomCropAug", "ImageDetIter",
           "ForceResizeAug", "HorizontalFlipAug", "HueJitterAug",
           "ImageIter", "LightingAug", "RandomCropAug", "RandomGrayAug",
           "RandomOrderAug", "RandomRotateAug", "RandomShearAug",
           "RandomSizedCropAug", "ResizeAug", "SaturationJitterAug",
           "SequentialAug", "center_crop", "color_normalize", "fixed_crop",
           "imdecode", "imread", "imresize", "random_crop", "scale_down"]
