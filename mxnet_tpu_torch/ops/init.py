"""Creation ops (counterpart of ``mxnet_tpu/ops/init.py``, ref:
src/operator/tensor/init_op.cc).

They take no array, so they place their result on ``ctx`` (a Context),
or on the current context when it is None: on the card by default.
"""
from __future__ import annotations

import torch

from ..base import register_op, torch_dtype
from ..context import current_context

__all__ = []


def _reg(fn):
    register_op(fn.__name__)(fn)
    __all__.append(fn.__name__)
    return fn


def _device(ctx):
    return (ctx or current_context()).device


@_reg
def zeros(shape=(), dtype='float32', ctx=None):
    return torch.zeros(shape, dtype=torch_dtype(dtype), device=_device(ctx))


@_reg
def ones(shape=(), dtype='float32', ctx=None):
    return torch.ones(shape, dtype=torch_dtype(dtype), device=_device(ctx))


@_reg
def full(shape=(), val=0.0, dtype='float32', ctx=None):
    return torch.full(shape, val, dtype=torch_dtype(dtype),
                      device=_device(ctx))


@_reg
def arange(start=0, stop=None, step=1.0, repeat=1, dtype='float32',
           ctx=None):
    if stop is None:
        start, stop = 0, start
    out = torch.arange(start, stop, step, dtype=torch_dtype(dtype),
                       device=_device(ctx))
    if repeat > 1:
        out = torch.repeat_interleave(out, repeat)
    return out


@_reg
def linspace(start=0, stop=1, num=50, endpoint=True, dtype='float32',
             ctx=None):
    if endpoint:
        return torch.linspace(start, stop, num, dtype=torch_dtype(dtype),
                              device=_device(ctx))
    step = (stop - start) / num
    return (start + step * torch.arange(num, dtype=torch.float64,
                                        device=_device(ctx))
            ).to(torch_dtype(dtype))


@_reg
def eye(N=0, M=0, k=0, dtype='float32', ctx=None):
    N, M, k = int(N), int(M) or int(N), int(k)
    rows = torch.arange(N, device=_device(ctx))[:, None]
    cols = torch.arange(M, device=_device(ctx))[None, :]
    return (cols - rows == k).to(torch_dtype(dtype))
