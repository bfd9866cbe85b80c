"""Data iterators (counterpart of ``mxnet_tpu/io``)."""
from .io import (DataDesc, DataBatch, DataIter, ElasticShard, NDArrayIter,
                 ResizeIter, PrefetchingIter, DevicePrefetchIter, CSVIter,
                 MNISTIter, ImageRecordIter)

__all__ = ['DataDesc', 'DataBatch', 'DataIter', 'ElasticShard',
           'NDArrayIter', 'ResizeIter', 'PrefetchingIter',
           'DevicePrefetchIter', 'CSVIter', 'MNISTIter', 'ImageRecordIter']
