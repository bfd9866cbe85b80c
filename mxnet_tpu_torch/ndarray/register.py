"""Generate an NDArray-level wrapper for every registered op (counterpart
of ``mxnet_tpu/ndarray/register.py``, ref: python/mxnet/ndarray/
register.py)."""
from __future__ import annotations

import functools

from ..base import _OP_REGISTRY
from .ndarray import _invoke


def make_wrapper(opdef):
    @functools.wraps(opdef.fn)
    def wrapper(*args, **kwargs):
        kwargs.pop('out', None)
        kwargs.pop('name', None)
        return _invoke(opdef.fn, *args, **kwargs)
    wrapper.__name__ = opdef.name
    wrapper.__qualname__ = opdef.name
    return wrapper


def populate(namespace: dict, skip=()):
    for name, opdef in _OP_REGISTRY.items():
        if name in skip or name in namespace:
            continue
        namespace[name] = make_wrapper(opdef)
    return namespace
