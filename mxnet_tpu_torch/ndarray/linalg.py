"""``nd.linalg`` (counterpart of ``mxnet_tpu/ndarray/linalg.py``, ref:
``python/mxnet/ndarray/linalg.py``): the registered ``linalg_*`` ops of
``ops/matrix.py`` under MXNet's short names, as the JAX package's
namespace has them (``gelqf``, ``syevd``, ``extracttrian`` and
``maketrian`` are ``nd.linalg_<name>``, as there).
"""
from __future__ import annotations

from .ndarray import _invoke
from ..ops import matrix as _m

__all__ = ['gemm', 'gemm2', 'potrf', 'potri', 'trsm', 'trmm', 'syrk',
           'sumlogdiag', 'extractdiag', 'makediag', 'det', 'inverse',
           'slogdet']


def gemm(A, B, C, transpose_a=False, transpose_b=False, alpha=1.0, beta=1.0,
         **kw):
    return _invoke(_m.linalg_gemm, A, B, C, transpose_a=transpose_a,
                   transpose_b=transpose_b, alpha=alpha, beta=beta)


def gemm2(A, B, transpose_a=False, transpose_b=False, alpha=1.0, **kw):
    return _invoke(_m.linalg_gemm2, A, B, transpose_a=transpose_a,
                   transpose_b=transpose_b, alpha=alpha)


def potrf(A, **kw):
    return _invoke(_m.linalg_potrf, A)


def potri(A, **kw):
    return _invoke(_m.linalg_potri, A)


def trsm(A, B, transpose=False, rightside=False, lower=True, alpha=1.0,
         **kw):
    return _invoke(_m.linalg_trsm, A, B, transpose=transpose,
                   rightside=rightside, lower=lower, alpha=alpha)


def trmm(A, B, transpose=False, rightside=False, lower=True, alpha=1.0,
         **kw):
    return _invoke(_m.linalg_trmm, A, B, transpose=transpose,
                   rightside=rightside, lower=lower, alpha=alpha)


def syrk(A, transpose=False, alpha=1.0, **kw):
    return _invoke(_m.linalg_syrk, A, transpose=transpose, alpha=alpha)


def sumlogdiag(A, **kw):
    return _invoke(_m.linalg_sumlogdiag, A)


def extractdiag(A, offset=0, **kw):
    return _invoke(_m.linalg_extractdiag, A, offset=offset)


def makediag(A, offset=0, **kw):
    return _invoke(_m.linalg_makediag, A, offset=offset)


def det(A, **kw):
    return _invoke(_m.linalg_det, A)


def inverse(A, **kw):
    return _invoke(_m.linalg_inverse, A)


def slogdet(A, **kw):
    return _invoke(_m.linalg_slogdet, A)

