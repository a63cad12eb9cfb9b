"""Data iterators (the port of ``mxnet_tpu/io``): the in-memory and file
iterators, ``ImageRecordIter`` over RecordIO files, and the record
pipeline (``ShardedRecordPipeline``, ``DeviceFeeder``)."""
from .io import (CSVIter, DataBatch, DataDesc, DataIter, ImageRecordIter,
                 LibSVMIter, MNISTIter, NDArrayIter, PrefetchingIter,
                 ResizeIter)
from .pipeline import DeviceFeeder, ShardedRecordPipeline

__all__ = ["CSVIter", "DataBatch", "DataDesc", "DataIter", "DeviceFeeder",
           "ImageRecordIter", "LibSVMIter", "MNISTIter", "NDArrayIter",
           "PrefetchingIter", "ResizeIter", "ShardedRecordPipeline"]
