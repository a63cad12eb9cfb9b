"""Data iterators (the port of ``mxnet_tpu/io``, calibration's subset)."""
from .io import DataBatch, DataDesc, DataIter, NDArrayIter

__all__ = ["DataBatch", "DataDesc", "DataIter", "NDArrayIter"]
