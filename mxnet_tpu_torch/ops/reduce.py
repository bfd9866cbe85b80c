"""Reduce and broadcast ops (counterpart of ``mxnet_tpu/ops/reduce.py``,
ref: src/operator/tensor/broadcast_reduce_op.h).

JAX's rules kept where torch differs: an integer sum or product stays in
its dtype (torch widens to int64), the mean of integers is float32 (torch
refuses it), ``axis=()`` reduces nothing (torch's ``dim=()`` reduces
everything), and ``argmax``/``argmin`` return float32.
"""
from __future__ import annotations

import builtins

import torch

from ..base import register_op, torch_dtype

__all__ = []


def _reg(fn):
    register_op(fn.__name__)(fn)
    __all__.append(fn.__name__)
    return fn


def _axes(data, axis, exclude=False):
    """The reduced axes as a tuple (all of them for None)."""
    if axis is None:
        return tuple(range(data.dim()))
    axes = tuple(int(a) for a in axis) if isinstance(axis, (list, tuple)) \
        else (int(axis),)
    axes = tuple(a % builtins.max(data.dim(), 1) for a in axes)
    if exclude:
        axes = tuple(i for i in range(data.dim()) if i not in axes)
    return axes


def _reduce(fn, data, axis, keepdims, exclude=False, one_axis=False):
    """``fn(x, dim, keepdim)`` over the reduced axes at once, or one axis
    at a time from the last where torch takes a single ``dim``."""
    axes = _axes(data, axis, exclude)
    if not axes:
        return data.clone()
    if not one_axis:
        return fn(data, axes, keepdims)
    out = data
    for a in sorted(axes, reverse=True):
        out = fn(out, a, True)
    return out if keepdims else out.squeeze(axes)


def _int_keep(fn):
    """A torch reduction that keeps an integer input's dtype."""
    def red(x, dim, keepdim):
        if x.is_floating_point() or x.is_complex():
            return fn(x, dim=dim, keepdim=keepdim)
        return fn(x, dim=dim, keepdim=keepdim, dtype=x.dtype)
    return red


def _float_mean(x, dim, keepdim):
    if not x.is_floating_point():
        x = x.to(torch.float32)
    return torch.mean(x, dim=dim, keepdim=keepdim)


def _nanprod(x, dim, keepdim):
    return _int_keep(torch.prod)(
        torch.where(torch.isnan(x), torch.ones_like(x), x), dim, keepdim)


@_reg
def sum(data, axis=None, keepdims=False, exclude=False):
    return _reduce(_int_keep(torch.sum), data, axis, keepdims, exclude)


@_reg
def mean(data, axis=None, keepdims=False, exclude=False):
    return _reduce(_float_mean, data, axis, keepdims, exclude)


@_reg
def prod(data, axis=None, keepdims=False, exclude=False):
    return _reduce(_int_keep(torch.prod), data, axis, keepdims, exclude,
                   one_axis=True)


@_reg
def nansum(data, axis=None, keepdims=False, exclude=False):
    return _reduce(lambda x, d, k: torch.nansum(x, dim=d, keepdim=k), data,
                   axis, keepdims, exclude)


@_reg
def nanprod(data, axis=None, keepdims=False, exclude=False):
    return _reduce(_nanprod, data, axis, keepdims, exclude, one_axis=True)


@_reg
def max(data, axis=None, keepdims=False, exclude=False):
    return _reduce(lambda x, d, k: torch.amax(x, dim=d, keepdim=k), data,
                   axis, keepdims, exclude)


@_reg
def min(data, axis=None, keepdims=False, exclude=False):
    return _reduce(lambda x, d, k: torch.amin(x, dim=d, keepdim=k), data,
                   axis, keepdims, exclude)


def _arg(fn, data, axis, keepdims):
    if axis is None:
        out = fn(data.reshape(-1))
        if keepdims:
            out = out.reshape((1,) * data.dim())
    else:
        out = fn(data, dim=int(axis), keepdim=keepdims)
    return out.to(torch.float32)


@_reg
def argmax(data, axis=None, keepdims=False):
    return _arg(torch.argmax, data, axis, keepdims)


@_reg
def argmin(data, axis=None, keepdims=False):
    return _arg(torch.argmin, data, axis, keepdims)


@_reg
def norm(data, ord=2, axis=None, keepdims=False):
    if ord == 1:
        return sum(torch.abs(data), axis=axis, keepdims=keepdims)
    return torch.sqrt(sum(torch.square(data), axis=axis, keepdims=keepdims))


@_reg
def broadcast_to(data, shape=None):
    shape = tuple(int(s) if int(s) != 0 else data.shape[i]
                  for i, s in enumerate(shape))
    return torch.broadcast_to(data, shape)


@_reg
def broadcast_like(lhs, rhs):
    return torch.broadcast_to(lhs, rhs.shape)


@_reg
def broadcast_axis(data, axis=(), size=()):
    if isinstance(axis, int):
        axis, size = (axis,), (size,)
    shape = list(data.shape)
    for a, s in zip(axis, size):
        shape[a] = int(s)
    return torch.broadcast_to(data, tuple(shape))


def _cum(fn, a, axis, dtype):
    if axis is None:
        a, axis = a.reshape(-1), 0
    return fn(a, dim=axis,
              dtype=a.dtype if dtype is None else torch_dtype(dtype))


@_reg
def cumsum(a, axis=None, dtype=None):
    return _cum(torch.cumsum, a, axis, dtype)


@_reg
def cumprod(a, axis=None, dtype=None):
    return _cum(torch.cumprod, a, axis, dtype)


@_reg
def moments(data, axes=None, keepdims=False):
    """Mean and variance in one pass (ref: src/operator/nn/moments.cc)."""
    m = _reduce(_float_mean, data, axes, True)
    v = _reduce(_float_mean, torch.square(data - m), axes, keepdims)
    if not keepdims:
        m = m.squeeze(_axes(data, axes))
    return m, v
