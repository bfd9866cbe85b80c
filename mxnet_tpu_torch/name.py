"""Automatic naming for the symbolic API (counterpart of
``mxnet_tpu/name.py``, ref: python/mxnet/name.py).

`NameManager` assigns `<hint><counter>` names to symbols created without
an explicit name; `Prefix` prepends a fixed prefix. Managers nest as
context managers on a thread-local stack, and Symbol construction
consults the innermost active manager."""
from __future__ import annotations

import threading

__all__ = ['NameManager', 'Prefix', 'current']

_local = threading.local()


def _stack():
    if not hasattr(_local, 'stack'):
        _local.stack = []
    return _local.stack


class NameManager:
    """Counter-based automatic naming (ref: name.py NameManager.get)."""

    def __init__(self):
        self._counter = {}

    def get(self, name, hint):
        if name:
            return name
        hint = (hint or 'sym').lower()
        n = self._counter.get(hint, 0)
        self._counter[hint] = n + 1
        return f"{hint}{n}"

    def __enter__(self):
        _stack().append(self)
        return self

    def __exit__(self, *exc):
        _stack().pop()

    # reference-compat accessor (NameManager.current was a classproperty)
    @property
    def current(self):
        return current()


class Prefix(NameManager):
    """Prefixes every name created in scope — explicit names included,
    matching the reference (ref: name.py Prefix.get prefixes the result
    of NameManager.get unconditionally)."""

    def __init__(self, prefix):
        super().__init__()
        self._prefix = prefix

    def get(self, name, hint):
        return self._prefix + super().get(name, hint)


def current():
    """The innermost active manager, or None (Symbol falls back to its
    global counter)."""
    stack = _stack()
    return stack[-1] if stack else None
