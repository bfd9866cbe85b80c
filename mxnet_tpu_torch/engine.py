"""Engine control surface (counterpart of ``mxnet_tpu/engine.py``).

PyTorch's streams order the work, so ``bulk`` and ``set_bulk_size`` do
nothing beyond remembering the size, as in the JAX package; they stay for
scripts written against MXNet.
"""
from __future__ import annotations

import contextlib

__all__ = ['bulk', 'set_bulk_size']

_bulk_size = 15


def set_bulk_size(size):
    global _bulk_size
    prev = _bulk_size
    _bulk_size = size
    return prev


@contextlib.contextmanager
def bulk(size):
    prev = set_bulk_size(size)
    try:
        yield
    finally:
        set_bulk_size(prev)
