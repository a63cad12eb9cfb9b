"""Ops of the port: plain torch counterparts of ``mxnet_tpu/ops`` and
the hand-written CUDA kernels that replace its Pallas kernels. Importing
the package registers every op (``registry``) under its MXNet name."""
from . import (contrib, detection, elemwise, nn,  # noqa: F401
               optimizer_ops, quantized, tensor)
