"""Attribute scoping for symbol construction (counterpart of
``mxnet_tpu/attribute.py``, ref: python/mxnet/attribute.py AttrScope).

`with mx.AttrScope(ctx_group='stage1', lr_mult='0.1'):` attaches the
given attributes to every Symbol created inside the block, stored under
dunder keys (`__ctx_group__`, `__lr_mult__`) exactly like the reference,
so graph passes — notably the group2ctxs manual model-parallel placement
in Module (module.py) — can read them back. Scopes nest; inner values
win."""
from __future__ import annotations

import threading

__all__ = ['AttrScope', 'current_attrs']

_local = threading.local()


def _stack():
    if not hasattr(_local, 'stack'):
        _local.stack = []
    return _local.stack


class AttrScope:
    """Attribute manager applying attrs to symbols created in scope
    (ref: python/mxnet/attribute.py:AttrScope)."""

    def __init__(self, **kwargs):
        for v in kwargs.values():
            if not isinstance(v, str):
                raise ValueError(
                    "AttrScope values must be strings (reference "
                    "convention); got %r" % (v,))
        self._attr = {f"__{k}__": v for k, v in kwargs.items()}

    def get(self, attr=None):
        """Merge THIS scope's attrs with explicitly-passed ones (explicit
        wins). Reference-API parity (AttrScope.get); symbol construction
        uses module-level current_attrs(), which merges the whole stack."""
        merged = dict(self._attr)
        if attr:
            merged.update(attr)
        return merged

    def __enter__(self):
        _stack().append(self)
        return self

    def __exit__(self, *exc):
        _stack().pop()


def current_attrs(attr=None):
    """Attrs from all active scopes (outer to inner) merged with `attr`."""
    merged = {}
    for scope in _stack():
        merged.update(scope._attr)
    if attr:
        merged.update(attr)
    return merged
