"""Ops of the port: plain torch counterparts of ``mxnet_tpu/ops`` and
the hand-written CUDA kernels that replace its Pallas kernels. Importing
the package registers every op (``registry``) under its MXNet name."""
from . import (contrib, elemwise, nn, optimizer_ops,  # noqa: F401
               quantized, tensor)
