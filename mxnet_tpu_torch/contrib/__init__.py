"""Contributed components of the port (``mxnet_tpu/contrib``): the INT8
quantization flow and ``io.DataLoaderIter``."""
from . import io, quantization  # noqa: F401
