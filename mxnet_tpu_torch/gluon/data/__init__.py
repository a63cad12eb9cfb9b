"""gluon.data: datasets, samplers and the DataLoader (the port of
``mxnet_tpu/gluon/data``; ref: python/mxnet/gluon/data/)."""
from .dataset import ArrayDataset, Dataset, RecordFileDataset, SimpleDataset
from .sampler import BatchSampler, RandomSampler, Sampler, SequentialSampler
from .dataloader import DataLoader
from . import vision
