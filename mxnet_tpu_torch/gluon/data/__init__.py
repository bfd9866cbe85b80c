"""Gluon data: datasets, samplers and the DataLoader (counterpart of
``mxnet_tpu/gluon/data``)."""
from .dataset import (Dataset, SimpleDataset, ArrayDataset,
                      RecordFileDataset)
from .sampler import (Sampler, SequentialSampler, RandomSampler,
                      FilterSampler, BatchSampler, ElasticSampler,
                      IntervalSampler)
from .dataloader import DataLoader
from . import vision
