"""Sparse storage ops (counterpart of ``mxnet_tpu/ops/sparse_ops.py``;
ref: src/operator/tensor/cast_storage.cc, sparse_retain.cc, dot.cc's
FComputeEx csr paths).

The NDArray-level sparse API (``ndarray/sparse.py``) keeps a dense
payload, as the JAX package does, so ``cast_storage`` is metadata at
that level. The ops here supply the compute side: retain-by-rows, and a
sparse matrix product through ``torch.sparse_csr_tensor`` (cuSPARSE on
the card), which ``nd.dot`` takes when its lhs is a CSRNDArray, as the
reference's FComputeEx dispatch is storage-type driven. The JAX package
computes that product through ``jax.experimental.sparse`` BCOO, not in a
Pallas kernel.
"""
from __future__ import annotations

import warnings
import weakref

import numpy as onp
import torch

from ..base import register_op, register_sparse_impl

__all__ = []

# storage-dispatch telemetry: which sparse kernels ran
route_counts = {'dot_csr_dense': 0}


def _reg(fn):
    register_op(fn.__name__)(fn)
    __all__.append(fn.__name__)
    return fn


@_reg
def cast_storage(data, stype='default'):
    """Storage-type cast (ref: cast_storage.cc). The dense payload is the
    representation of every stype; values pass through unchanged, the
    stype tag lives on the NDArray wrapper."""
    return data


@_reg
def sparse_retain(data, indices):
    """Zero every row not named in ``indices`` (ref:
    src/operator/tensor/sparse_retain.cc)."""
    idx = torch.as_tensor(indices, device=data.device).reshape(-1).to(
        torch.int64)
    mask = torch.zeros((data.shape[0],), dtype=torch.bool, device=data.device)
    mask[idx] = True
    shape = (data.shape[0],) + (1,) * (data.dim() - 1)
    return torch.where(mask.reshape(shape), data, torch.zeros_like(data))


@_reg
def dot_csr_dense(lhs, rhs, nse=None):
    """``lhs @ rhs`` with lhs contracted through a CSR representation
    (ref: dot.cc DotCsrDnsDnsImpl). ``nse``, the JAX function's budget of
    stored elements, is accepted: torch's CSR conversion counts the
    nonzeros itself. Differentiable in ``rhs``."""
    with warnings.catch_warnings():
        # torch marks its CSR layout beta on every conversion
        warnings.filterwarnings('ignore', message='Sparse CSR tensor')
        sp = lhs.to_sparse_csr() if lhs.requires_grad else \
            lhs.detach().to_sparse_csr()
    return sp @ rhs


@register_sparse_impl('dot', ('csr', 'default'))
def _dot_csr_dense_dispatch(lhs, rhs, transpose_a=False, transpose_b=False,
                            nse=None):
    """The FComputeEx route of ``nd.dot(csr, dense)``: a 2-D by 2-D
    product takes the CSR path (the reference's CSR dot is matrix-only);
    anything else defers to the dense op, so both storages keep one
    tensordot semantics."""
    from .matrix import dot as _dense_dot
    if lhs.dim() != 2 or rhs.dim() != 2:
        return _dense_dot(lhs, rhs, transpose_a=transpose_a,
                          transpose_b=transpose_b)
    if transpose_a:
        lhs = lhs.t()
    if transpose_b:
        rhs = rhs.t()
    route_counts['dot_csr_dense'] += 1
    return dot_csr_dense(lhs, rhs.to(lhs.dtype), nse=nse)


def _dot_csr_prepare(args, kwargs):
    """The nnz of the concrete payload, cached on the wrapper (a loop
    reusing one CSR matrix counts once); the cache holds a weak reference
    to the payload, so replacing ``_data`` does not pin the old one."""
    lhs = args[0]
    data = getattr(lhs, '_data', None)
    cached = getattr(lhs, '_nnz_cache', None)
    if cached is not None and data is not None and cached[0]() is data:
        return {'nse': cached[1]}
    payload = lhs.asnumpy() if hasattr(lhs, 'asnumpy') else onp.asarray(lhs)
    nse = max(1, int(onp.count_nonzero(payload)))
    if data is not None:
        try:
            lhs._nnz_cache = (weakref.ref(data), nse)
        except (AttributeError, TypeError):
            pass
    return {'nse': nse}


_dot_csr_dense_dispatch.__sparse_prepare__ = _dot_csr_prepare


@_reg
def storage_type(data):
    """Always 'default' at the payload level (kDefaultStorage = 0 in the
    reference's stype enum); the wrapper types carry csr/row_sparse."""
    return torch.zeros((), dtype=torch.int32, device=data.device)
