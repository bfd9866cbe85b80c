"""Sparse NDArrays: CSRNDArray and RowSparseNDArray (counterpart of
``mxnet_tpu/ndarray/sparse.py``; ref: python/mxnet/ndarray/sparse.py:300,
574).

As in the JAX package, a sparse NDArray keeps the API (``stype``, the
``indices``/``indptr``/``data`` accessors, ``tostype``, sparse creation)
over a dense payload tensor, and computes its compressed parts on the
host when asked, once per payload (``_cached_parts``). Math on these
arrays is exact and runs the dense ops, except where an op registers a
storage-specific implementation (``nd.dot(csr, dense)``, see
``ops/sparse_ops.py``). The compiled step's RowSparse gradients do not
go through these wrappers: they are ``(uids, rows)`` blocks on the
device (``ops/rowsparse.py``).
"""
from __future__ import annotations

import weakref

import numpy as onp
import torch

from ..base import MXNetError
from ..ops import sparse_ops as _sp
from .ndarray import NDArray, _device, array as _dense_array

__all__ = ['BaseSparseNDArray', 'CSRNDArray', 'RowSparseNDArray',
           'csr_matrix', 'row_sparse_array', 'cast_storage', 'retain',
           'zeros', 'dot']


class BaseSparseNDArray(NDArray):
    # compressed-parts cache: (weakref to the payload, parts). Every
    # write rebinds _data, so a dead or mismatched weakref means the
    # payload changed and the parts are recomputed: one computation per
    # payload
    __slots__ = ('_nnz_cache', '_parts_cache')

    def __init__(self, data, ctx=None):
        super().__init__(data, ctx)
        self._nnz_cache = None
        self._parts_cache = None

    def _cached_parts(self, compute):
        cache = self._parts_cache
        if cache is not None and cache[0]() is self._data:
            return cache[1]
        parts = compute()
        self._parts_cache = (weakref.ref(self._data), parts)
        return parts

    def _array(self, a):
        return _dense_array(a, ctx=self.context)

    @property
    def density(self):
        a = self.asnumpy()
        return float((a != 0).sum()) / max(1, a.size)

    def tostype(self, stype):
        return cast_storage(self, stype)


class CSRNDArray(BaseSparseNDArray):
    """Compressed sparse row matrix (ref: sparse.py:300)."""
    __slots__ = ()

    @property
    def stype(self):
        return 'csr'

    def _csr_parts(self):
        def compute():
            a = self.asnumpy()
            rows, cols = onp.nonzero(a)
            data = a[rows, cols]
            counts = onp.bincount(rows, minlength=a.shape[0])
            indptr = onp.concatenate([[0], onp.cumsum(counts)])
            return (data.astype(a.dtype), cols.astype(onp.int64),
                    indptr.astype(onp.int64))
        return self._cached_parts(compute)

    @property
    def data(self):
        return self._array(self._csr_parts()[0])

    @property
    def indices(self):
        return self._array(self._csr_parts()[1])

    @property
    def indptr(self):
        return self._array(self._csr_parts()[2])


class RowSparseNDArray(BaseSparseNDArray):
    """Row-sparse array (ref: sparse.py:574): the rows with a nonzero are
    the stored ones."""
    __slots__ = ()

    @property
    def stype(self):
        return 'row_sparse'

    def _rsp_parts(self):
        def compute():
            a = self.asnumpy()
            flat = a.reshape(a.shape[0], -1)
            nz = onp.nonzero((flat != 0).any(axis=1))[0].astype(onp.int64)
            return (a[nz], nz)
        return self._cached_parts(compute)

    @property
    def indices(self):
        return self._array(self._rsp_parts()[1])

    @property
    def data(self):
        return self._array(self._rsp_parts()[0])

    def retain(self, indices):
        return retain(self, indices)


def _np(x, dtype=None):
    a = x.asnumpy() if isinstance(x, NDArray) else onp.asarray(x)
    return a.astype(dtype) if dtype is not None else a


def _place(dense, ctx):
    return torch.from_numpy(onp.ascontiguousarray(dense)).to(_device(ctx))


def csr_matrix(arg1, shape=None, ctx=None, dtype='float32'):
    """A CSRNDArray from (data, indices, indptr) and ``shape``, or from a
    dense source."""
    if isinstance(arg1, tuple) and len(arg1) == 3:
        data, indices, indptr = arg1
        data = _np(data)
        indices, indptr = _np(indices, onp.int64), _np(indptr, onp.int64)
        dense = onp.zeros(shape, dtype=dtype)
        rows = onp.repeat(onp.arange(shape[0]), onp.diff(indptr))
        dense[rows, indices] = data
        return CSRNDArray(_place(dense, ctx))
    return CSRNDArray(_place(_np(arg1).astype(dtype), ctx))


def row_sparse_array(arg1, shape=None, ctx=None, dtype='float32'):
    """A RowSparseNDArray from (data, indices), with ``shape`` or the
    rows up to the largest index, or from a dense source."""
    if isinstance(arg1, tuple) and len(arg1) == 2:
        data, indices = arg1
        data, indices = _np(data), _np(indices, onp.int64)
        full_shape = shape or ((int(indices.max()) + 1,) + data.shape[1:])
        dense = onp.zeros(full_shape, dtype=dtype)
        dense[indices] = data
        return RowSparseNDArray(_place(dense, ctx))
    return RowSparseNDArray(_place(_np(arg1).astype(dtype), ctx))


def cast_storage(arr, stype):
    """Ref: src/operator/tensor/cast_storage.cc. The payload is shared;
    the wrapper's type is the storage type."""
    if stype == 'default':
        return NDArray(arr._data)
    if stype == 'csr':
        if arr.ndim != 2:
            raise MXNetError("csr requires 2D")
        return CSRNDArray(arr._data)
    if stype == 'row_sparse':
        return RowSparseNDArray(arr._data)
    raise MXNetError(f"unknown stype {stype}")


def retain(arr, indices):
    """Keep only the given rows (ref: src/operator/tensor/
    sparse_retain.cc)."""
    idx = indices._data if isinstance(indices, NDArray) else \
        torch.as_tensor(onp.asarray(indices))
    return RowSparseNDArray(_sp.sparse_retain(arr._data,
                                              idx.to(arr._data.device)))


def zeros(stype, shape, ctx=None, dtype='float32'):
    from .ndarray import zeros as _z
    return cast_storage(_z(shape, ctx, dtype), stype)


def dot(lhs, rhs, transpose_a=False, transpose_b=False):
    from . import dot as _dot
    return _dot(lhs, rhs, transpose_a=transpose_a, transpose_b=transpose_b)
