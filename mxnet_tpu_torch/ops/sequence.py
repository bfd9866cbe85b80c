"""Sequence ops (counterpart of ``mxnet_tpu/ops/sequence.py``, ref:
src/operator/sequence_{mask,last,reverse}.cc): ``data`` is (T, N, ...)
for ``axis=0`` or (N, T, ...) for ``axis=1``, ``sequence_length`` (N,).
"""
from __future__ import annotations

import torch

from ..base import register_op

__all__ = []


def _reg(fn):
    register_op(fn.__name__)(fn)
    __all__.append(fn.__name__)
    return fn


@_reg
def sequence_mask(data, sequence_length=None, use_sequence_length=False,
                  value=0.0, axis=0):
    """Steps at or past each sequence's length set to ``value``."""
    if not use_sequence_length or sequence_length is None:
        return data
    pos = torch.arange(data.shape[axis], device=data.device)
    shape = [1] * data.dim()
    shape[axis] = -1
    lshape = [1] * data.dim()
    lshape[1 - axis] = -1
    mask = pos.reshape(shape) < sequence_length.reshape(lshape)
    return torch.where(mask, data, torch.as_tensor(
        value, dtype=data.dtype, device=data.device))


@_reg
def sequence_last(data, sequence_length=None, use_sequence_length=False,
                  axis=0):
    """Each sequence's last valid step."""
    if not use_sequence_length or sequence_length is None:
        return data.select(axis, -1)
    moved = data.movedim(0, 1) if axis == 0 else data   # (N, T, ...)
    idx = (sequence_length - 1).to(torch.int64)
    idx = idx.reshape((-1, 1) + (1,) * (moved.dim() - 2)).expand(
        (moved.shape[0], 1) + tuple(moved.shape[2:]))
    return moved.gather(1, idx).squeeze(1)


@_reg
def sequence_reverse(data, sequence_length=None, use_sequence_length=False,
                     axis=0):
    """Each sequence's first ``sequence_length`` steps reversed, the rest
    in place."""
    if not use_sequence_length or sequence_length is None:
        return data.flip(axis)
    if axis != 0:
        data = data.movedim(axis, 0)
    pos = torch.arange(data.shape[0], device=data.device)[:, None]
    L = sequence_length.to(torch.int64)[None, :]
    idx = torch.where(pos < L, L - 1 - pos, pos)
    idx = idx.reshape(idx.shape + (1,) * (data.dim() - 2)).expand(
        data.shape)
    out = data.gather(0, idx)
    return out.movedim(0, axis) if axis != 0 else out
