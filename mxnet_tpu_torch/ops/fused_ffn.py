"""Fused FFN1: gelu_erf(x @ W.T + b) in one CUDA kernel, its plain PyTorch
version, and the autograd Function around them (counterpart of
``mxnet_tpu/ops/pallas_ffn.py`` and its ``custom_vjp``). The kernel, its
bound and its design are described in ``csrc/dense_gelu.cu``.

The backward is ``_bwd``'s math in plain PyTorch, as the JAX package's is
plain ``jnp`` outside any Pallas kernel: it saves only (x, w, b) and
recomputes the pre-activation in f32 rather than keeping the (M, N)
intermediate the fusion exists to keep out of device memory. Its f32
products go to ``torch.matmul`` in full f32 (TF32 stays off).
"""
from __future__ import annotations

import ctypes
import math

import torch

from ..base import MXNetError
from . import _build

__all__ = ['fused_dense_gelu', 'dense_gelu_reference',
           'dense_gelu_backward']

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


def dense_gelu_backward(x, w, b, g):
    """``_bwd`` of the JAX package: (dx, dw, db) from the saved inputs and
    the output gradient, in f32, each cast to its input's dtype."""
    K = x.shape[-1]
    x2 = x.reshape(-1, K).to(torch.float32)
    w32 = w.to(torch.float32)
    g2 = g.reshape(-1, w.shape[0]).to(torch.float32)
    s = torch.matmul(x2, w32.t()) + b.to(torch.float32)
    pdf = torch.exp(-0.5 * s * s) * (1.0 / math.sqrt(2.0 * math.pi))
    dgelu = 0.5 * (1.0 + torch.erf(s * _INV_SQRT2)) + s * pdf
    ds = g2 * dgelu
    dx = torch.matmul(ds, w32).reshape(x.shape).to(x.dtype)
    dw = torch.matmul(ds.t(), x2).to(w.dtype)
    db = ds.sum(0).to(b.dtype)
    return dx, dw, db


class _FusedDenseGelu(torch.autograd.Function):
    """Forward: the CUDA kernel for CUDA tensors, the plain version for CPU
    tensors. Backward: ``dense_gelu_backward`` on both."""

    @staticmethod
    def forward(ctx, x, w, b):
        out = _launch(x, w, b) if x.is_cuda else dense_gelu_reference(x, w, b)
        ctx.save_for_backward(x, w, b)
        return out

    @staticmethod
    def backward(ctx, g):
        return dense_gelu_backward(*ctx.saved_tensors, g)


def fused_dense_gelu(x, w, b):
    """gelu(x @ w.T + b) with the epilogue fused into the matmul,
    differentiable in x, w and b: the CUDA kernel for a CUDA tensor, the
    plain version for a CPU tensor."""
    if not x.is_cuda and x.device.type != 'cpu':
        raise MXNetError(f"fused_dense_gelu: unsupported device {x.device}")
    return _FusedDenseGelu.apply(x, w, b)
