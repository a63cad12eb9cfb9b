"""Gluon, the imperative / hybrid layer API of the port
(``mxnet_tpu/gluon``): parameters, blocks, layers, the ResNet model
zoo, losses, the single-card ``Trainer``, utilities and ``data``
(datasets, samplers, the DataLoader, vision transforms)."""
from . import parameter
from .parameter import Constant, Parameter, ParameterDict
from .block import Block, HybridBlock, SymbolBlock
from . import nn
from . import model_zoo
from . import loss
from . import trainer
from .trainer import Trainer
from . import utils
from .utils import clip_global_norm, split_and_load, split_data
from . import data
