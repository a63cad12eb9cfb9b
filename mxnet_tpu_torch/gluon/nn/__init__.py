"""Gluon layers of the port (``mxnet_tpu/gluon/nn``)."""
from .basic_layers import (Activation, BatchNorm, Dense, Dropout, ELU,
                           Embedding, Flatten, GELU, HybridLambda,
                           HybridSequential, Lambda, LayerNorm, LeakyReLU,
                           PReLU, SELU, Sequential, Swish)
from .conv_layers import (AvgPool2D, Conv2D, GlobalAvgPool2D,
                          GlobalMaxPool2D, MaxPool2D, active_layout,
                          layout_scope)
from ..block import Block, HybridBlock, SymbolBlock
