"""Fused FFN1: gelu_erf(x @ W.T + b) in one CUDA kernel, and its plain
PyTorch version (counterpart of ``mxnet_tpu/ops/pallas_ffn.py``, forward
only). The kernel, its bound and its design are described in
``csrc/dense_gelu.cu``.
"""
from __future__ import annotations

import ctypes
import math

import torch

from ..base import MXNetError
from . import _build

__all__ = ['fused_dense_gelu', 'dense_gelu_reference']

_INV_SQRT2 = 1.0 / math.sqrt(2.0)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def dense_gelu_reference(x, w, b):
    """Plain version of ``_ffn_kernel``: f32 matmul, f32 bias and exact
    GELU, then the cast to x's dtype. w is (N, K), the Dense layout."""
    s = torch.matmul(x.to(torch.float32), w.to(torch.float32).t()) \
        + b.to(torch.float32)
    return (0.5 * s * (1.0 + torch.erf(s * _INV_SQRT2))).to(x.dtype)


def _launch(x, w, b):
    if not (w.is_cuda and b.is_cuda):
        raise MXNetError("fused_dense_gelu: all inputs must be on CUDA")
    if x.dtype not in _DTYPE_CODE or w.dtype != x.dtype or b.dtype != x.dtype:
        raise MXNetError(f"fused_dense_gelu: x, w, b must share one dtype "
                         f"of float32/bfloat16, got {x.dtype}, {w.dtype}, "
                         f"{b.dtype}")
    K = x.shape[-1]
    if w.dim() != 2 or w.shape[1] != K or b.shape != (w.shape[0],):
        raise MXNetError(f"fused_dense_gelu: w {tuple(w.shape)} / b "
                         f"{tuple(b.shape)} do not fit x {tuple(x.shape)}")
    for name, t in (('x', x), ('w', w), ('b', b)):
        if not t.is_contiguous():
            raise MXNetError(f"fused_dense_gelu: {name} must be contiguous")
    N = w.shape[0]
    M = x.numel() // K
    out = torch.empty(x.shape[:-1] + (N,), dtype=x.dtype, device=x.device)
    fn = _build.library('dense_gelu.cu').mxtt_dense_gelu
    if fn.argtypes is None:
        vp, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [i, vp, vp, vp, vp, i, i, i, vp]
        fn.restype = ctypes.c_int
    rc = fn(_DTYPE_CODE[x.dtype], x.data_ptr(), w.data_ptr(), b.data_ptr(),
            out.data_ptr(), M, N, K,
            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(rc, 'dense_gelu')
    _build.launch_counts['dense_gelu'] += 1
    return out


def fused_dense_gelu(x, w, b):
    """gelu(x @ w.T + b) with the epilogue fused into the matmul: the CUDA
    kernel for a CUDA tensor, the plain version for a CPU tensor."""
    if x.is_cuda:
        return _launch(x, w, b)
    if x.device.type != 'cpu':
        raise MXNetError(f"fused_dense_gelu: unsupported device {x.device}")
    return dense_gelu_reference(x, w, b)
