"""The np-shape and np-array switches (counterpart of
``mxnet_tpu/util.py``, ref: python/mxnet/util.py): ``set_np``,
``reset_np``, the ``np_shape``/``np_array`` scopes and the ``use_np*``
decorators, each flag thread-local, and ``getenv``/``setenv``."""
from __future__ import annotations

import functools
import os
import threading

__all__ = ['is_np_shape', 'set_np_shape', 'is_np_array', 'set_np_array',
           'set_np', 'reset_np', 'np_shape', 'np_array', 'use_np_shape',
           'use_np_array', 'use_np', 'getenv', 'setenv']

_tls = threading.local()


def _flags():
    if not hasattr(_tls, 'np_shape'):
        _tls.np_shape = True
        _tls.np_array = False
    return _tls


def is_np_shape():
    return _flags().np_shape


def set_np_shape(active):
    """Set the np-shape flag; returns the previous value."""
    prev = _flags().np_shape
    _flags().np_shape = bool(active)
    return prev


def is_np_array():
    return _flags().np_array


def set_np_array(active):
    """Set the np-array flag; returns the previous value."""
    prev = _flags().np_array
    _flags().np_array = bool(active)
    return prev


def set_np(shape=True, array=True, dtype=False):
    set_np_shape(shape)
    set_np_array(array)


def reset_np():
    set_np(False, False, False)


class np_shape:
    """Scope with the np-shape flag set to ``active``."""

    def __init__(self, active=True):
        self._active = active

    def __enter__(self):
        self._prev = set_np_shape(self._active)

    def __exit__(self, *exc):
        set_np_shape(self._prev)


class np_array:
    """Scope with the np-array flag set to ``active``."""

    def __init__(self, active=True):
        self._active = active

    def __enter__(self):
        self._prev = set_np_array(self._active)

    def __exit__(self, *exc):
        set_np_array(self._prev)


def use_np_shape(func):
    @functools.wraps(func)
    def wrapper(*args, **kwargs):
        with np_shape(True):
            return func(*args, **kwargs)
    return wrapper


def use_np_array(func):
    @functools.wraps(func)
    def wrapper(*args, **kwargs):
        with np_array(True):
            return func(*args, **kwargs)
    return wrapper


def use_np(func):
    return use_np_array(use_np_shape(func))


def getenv(name):
    return os.environ.get(name)


def setenv(name, value):
    os.environ[name] = value
