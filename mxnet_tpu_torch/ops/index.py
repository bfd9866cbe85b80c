"""Indexing ops: take, gather, scatter, boolean_mask (counterpart of
``mxnet_tpu/ops/index.py``, ref: src/operator/tensor/indexing_op.cc,
src/operator/contrib/{boolean_mask,index_copy}.cc).

Out-of-range indices clamp (``mode='clip'``, and 'raise' as in the JAX
package) or wrap (``mode='wrap'``). The JAX package's row-dedup gather is
an XLA scatter optimisation; torch's ``index_select`` backward already
sums repeated rows, so the port gathers directly.
"""
from __future__ import annotations

import torch

from ..base import register_op

__all__ = []


def _reg(fn):
    register_op(fn.__name__)(fn)
    __all__.append(fn.__name__)
    return fn


def _index(indices, n, mode='clip'):
    idx = indices.to(torch.int64)
    if mode == 'wrap':
        return torch.remainder(idx, n)
    return idx.clamp(0, n - 1)


@_reg
def take(a, indices, axis=0, mode='clip'):
    axis = axis % a.dim()
    idx = _index(indices, a.shape[axis], mode)
    out = torch.index_select(a, axis, idx.reshape(-1))
    return out.reshape(a.shape[:axis] + idx.shape + a.shape[axis + 1:])


@_reg
def batch_take(a, indices):
    idx = indices.to(torch.int64)
    idx = idx.unsqueeze(-1) if idx.dim() < a.dim() else idx
    return torch.take_along_dim(a, idx, dim=-1).squeeze(-1)


@_reg
def pick(data, index, axis=-1, keepdims=False, mode='clip'):
    axis = axis % data.dim()
    idx = _index(index, data.shape[axis])
    out = torch.take_along_dim(data, idx.unsqueeze(axis), dim=axis)
    return out if keepdims else out.squeeze(axis)


@_reg
def gather_nd(data, indices):
    idx = indices.to(torch.int64)
    return data[tuple(idx[i] for i in range(idx.shape[0]))]


@_reg
def scatter_nd(data, indices, shape=None):
    idx = indices.to(torch.int64)
    out = torch.zeros(tuple(shape), dtype=data.dtype, device=data.device)
    return out.index_put(tuple(idx[i] for i in range(idx.shape[0])), data)


@_reg
def index_copy(old_tensor, index_vector, new_tensor):
    return torch.index_copy(old_tensor, 0, index_vector.to(torch.int64),
                            new_tensor)


@_reg
def index_add(data, indices, values):
    return torch.index_add(data, 0, indices.to(torch.int64), values)


@_reg
def boolean_mask(data, index, axis=0):
    """The rows (along ``axis``) where ``index`` is non-zero; the output's
    length depends on the data (ref: src/operator/contrib/boolean_mask.cc)."""
    sel = torch.nonzero(index.to(torch.bool)).reshape(-1)
    return torch.index_select(data, axis, sel)


@_reg
def sequence_mask_like(data, mask):
    return data * mask


@_reg
def ravel_multi_index(data, shape=None):
    idx = data.to(torch.int64)
    out = torch.zeros(idx.shape[1:], dtype=torch.int64, device=data.device)
    for i, s in enumerate(shape):
        out = out * s + idx[i]
    return out.to(torch.float32)


@_reg
def unravel_index(data, shape=None):
    rem = data.to(torch.int64)
    coords = []
    for s in reversed(shape):
        coords.append(torch.remainder(rem, s))
        rem = torch.div(rem, s, rounding_mode='floor')
    return torch.stack(list(reversed(coords)), dim=0).to(torch.float32)
