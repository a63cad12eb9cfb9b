"""Data iterators (the port of ``mxnet_tpu/io``; ``ImageRecordIter`` and
the record pipeline are not ported yet)."""
from .io import (CSVIter, DataBatch, DataDesc, DataIter, LibSVMIter,
                 MNISTIter, NDArrayIter, PrefetchingIter, ResizeIter)

__all__ = ["CSVIter", "DataBatch", "DataDesc", "DataIter", "LibSVMIter",
           "MNISTIter", "NDArrayIter", "PrefetchingIter", "ResizeIter"]
