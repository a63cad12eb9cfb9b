"""Contributed components of the port (``mxnet_tpu/contrib``): so far the
INT8 quantization flow."""
from . import quantization  # noqa: F401
