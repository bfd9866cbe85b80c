"""KVStoreBase, the interface a store backend implements, and its
registry (counterpart of ``mxnet_tpu/kvstore/base.py``, ref:
python/mxnet/kvstore/base.py:74,220). ``gluon.Trainer`` takes any
registered backend."""
from __future__ import annotations

from ..base import MXNetError

_STORES = {}


class KVStoreBase:
    """Abstract key-value store interface."""

    def broadcast(self, key, value, out, priority=0):
        raise NotImplementedError

    def pushpull(self, key, value, out=None, priority=0):
        raise NotImplementedError

    def set_optimizer(self, optimizer):
        raise NotImplementedError

    @staticmethod
    def is_capable(capability):
        raise NotImplementedError

    def save_optimizer_states(self, fname, dump_optimizer=False):
        raise NotImplementedError

    def load_optimizer_states(self, fname):
        raise NotImplementedError

    @property
    def type(self):
        raise NotImplementedError

    @property
    def rank(self):
        raise NotImplementedError

    @property
    def num_workers(self):
        raise NotImplementedError

    OPTIMIZER = 'optimizer'

    @staticmethod
    def register(klass):
        """Register a KVStore backend (ref: base.py:220)."""
        _STORES[klass.__name__.lower()] = klass
        return klass


def get_kvstore_class(name):
    key = name.lower()
    if key not in _STORES:
        raise MXNetError(f"unknown kvstore type {name!r}; registered: "
                         f"{sorted(_STORES)}")
    return _STORES[key]
