"""Ops of the port: plain torch counterparts of ``mxnet_tpu/ops`` and
the hand-written CUDA kernels that replace its Pallas kernels."""
