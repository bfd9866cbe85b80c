"""MXNet's KVStore (counterpart of ``mxnet_tpu/kvstore/``): the local,
device and dist stores, gradient compression and the optimizer run in
the store."""
from .base import KVStoreBase
from .kvstore import KVStore, create

__all__ = ['KVStoreBase', 'KVStore', 'create']
