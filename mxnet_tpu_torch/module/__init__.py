"""mx.mod: the Module API (the port of ``mxnet_tpu/module``; ref:
python/mxnet/module/)."""
from .base_module import BaseModule
from .module import Module
from .bucketing_module import BucketingModule
from .sequential_module import SequentialModule

__all__ = ["BaseModule", "BucketingModule", "Module", "SequentialModule"]
