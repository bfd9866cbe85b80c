"""Registries of string-creatable class families (counterpart of
``mxnet_tpu/registry.py``, ref: python/mxnet/registry.py):
``get_register_func``, ``get_alias_func`` and ``get_create_func``, as
the optimizers and initializers use them. A name that is not registered,
or a config string that is not JSON with a "name", raises MXNetError.
"""
from __future__ import annotations

import json

from .base import MXNetError

__all__ = ['get_register_func', 'get_alias_func', 'get_create_func']

_registries = {}


def _get(base_class, nickname):
    return _registries.setdefault((base_class, nickname), {})


def get_register_func(base_class, nickname):
    """A decorator registering subclasses of ``base_class`` under their
    lower-case class name (or ``name``)."""
    reg = _get(base_class, nickname)

    def register(klass, name=None):
        if not issubclass(klass, base_class):
            raise MXNetError(
                f"can only register subclasses of {base_class.__name__}")
        reg[(name or klass.__name__).lower()] = klass
        return klass
    return register


def get_alias_func(base_class, nickname):
    """A decorator adding alias names to a registered class."""
    reg = _get(base_class, nickname)

    def alias(*aliases):
        def deco(klass):
            for a in aliases:
                reg[a.lower()] = klass
            return klass
        return deco
    return alias


def get_create_func(base_class, nickname):
    """A factory making a registered object from its name or from a
    '{"name": ..., <kwargs>}' JSON string; an instance passes through."""
    reg = _get(base_class, nickname)

    def create(*args, **kwargs):
        if args and isinstance(args[0], base_class):
            return args[0]
        if not args:
            raise MXNetError(f"{nickname} name required")
        name, args = args[0], args[1:]
        if isinstance(name, str) and name.startswith('{'):
            try:
                cfg = json.loads(name)
                name = cfg.pop('name')
            except (json.JSONDecodeError, KeyError) as e:
                raise MXNetError(
                    f"invalid {nickname} config string: {e!r}") from None
            kwargs.update(cfg)
        klass = reg.get(str(name).lower())
        if klass is None:
            raise MXNetError(f"{name!r} is not a registered {nickname}")
        return klass(*args, **kwargs)
    return create
