"""Generate an NDArray-level wrapper for every registered op (counterpart
of ``mxnet_tpu/ndarray/register.py``, ref: python/mxnet/ndarray/
register.py).

An op registered with ``mutate_inputs`` updates in place, as MXNet's
optimizer updates do: output j goes into input ``mutate_inputs[j]``,
except the first (the new weight of an update, whose slot 0 names the
weight), which goes into ``out=`` when one is given
(``nd.adamw_update(w, g, m, v, out=w)``) and nowhere otherwise; for
'all' every output goes into its input. The call returns ``out`` when
given, else what the op returned. Other ops ignore ``out=``, as the JAX
package's do.
"""
from __future__ import annotations

import functools

from ..base import _OP_REGISTRY, mutated_input_indices
from .ndarray import NDArray, _invoke


def _assign(dst, src):
    if isinstance(dst, (list, tuple)):
        for d, s in zip(dst, src):
            _assign(d, s)
    elif isinstance(dst, NDArray) and isinstance(src, NDArray):
        dst[:] = src


def write_back(opdef, args, res, out=None):
    """Write an in-place op's outputs into its mutated inputs (and the
    first into ``out``); returns ``out`` when given, else ``res``."""
    outs = res if isinstance(res, (tuple, list)) else (res,)
    if opdef.mutate_inputs == 'all':
        targets = list(zip(args, outs))
    else:
        idx = mutated_input_indices(opdef, len(args))
        targets = [(args[i], o) for i, o in zip(idx[1:], outs[1:])]
        if out is not None:
            targets.append((out, outs[0]))
    for dst, src in targets:
        _assign(dst, src)
    return res if out is None else out


def make_wrapper(opdef):
    @functools.wraps(opdef.fn)
    def wrapper(*args, **kwargs):
        out = kwargs.pop('out', None)
        kwargs.pop('name', None)
        res = _invoke(opdef.fn, *args, **kwargs)
        if opdef.mutate_inputs:
            return write_back(opdef, args, res, out)
        return res
    wrapper.__name__ = opdef.name
    wrapper.__qualname__ = opdef.name
    return wrapper


def populate(namespace: dict, skip=()):
    for name, opdef in _OP_REGISTRY.items():
        if name in skip or name in namespace:
            continue
        namespace[name] = make_wrapper(opdef)
    return namespace
