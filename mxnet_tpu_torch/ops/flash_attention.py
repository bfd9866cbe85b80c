"""Flash-attention forward: the hand-written Hopper kernel and its plain
PyTorch version (counterpart of ``mxnet_tpu/ops/pallas_attention.py``,
forward only).

``flash_attention`` keeps the JAX signature and mask handling: q/k/v are
(B, H, T, D); ``key_mask`` is an optional (B, Tk) or (B*H, Tk) mask,
additive f32 (0 = keep, large negative = drop) or boolean (True = keep);
``dropout_p > 0`` needs ``dropout_seed``. A CUDA tensor goes to the CUDA
kernel in ``csrc/flash_attn_fwd.cu``; a CPU tensor goes to
``flash_attention_reference``, which does the same arithmetic in torch
f32. There is no fallback from one to the other.

Attention dropout is the JAX package's counter hash (``counter_keep``):
the keep mask is a pure function of (seed, batch*head, row, col), so the
kernel, the plain version and the Pallas kernel agree bit for bit.
"""
from __future__ import annotations

import ctypes
import math

import numpy as onp
import torch

from ..base import MXNetError
from . import _build

__all__ = ['flash_attention', 'flash_attention_forward',
           'flash_attention_reference', 'counter_keep', 'dropout_threshold',
           'KERNEL_HEAD_DIMS']

_NEG_INF = -1e30
_MASK32 = 0xFFFFFFFF
KERNEL_HEAD_DIMS = (8, 16, 32, 64, 128)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def dropout_threshold(rate):
    """The uint32 keep threshold: keep where hash >= threshold."""
    return min(int(float(rate) * 2.0 ** 32), 2 ** 32 - 1)


def _mul32(a, c):
    """(a * c) mod 2**32 for int64 tensors a < 2**32 and a constant c,
    split so that no partial product leaves the int64 range."""
    lo = a * (c & 0xFFFF)
    hi = ((a * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK32


def counter_keep(seed, bh, rows, cols, rate):
    """keep/(1-rate) multipliers (f32) from broadcastable integer tensors
    (bh, rows, cols): the JAX package's ``_counter_keep`` (murmur3
    finalizer over the global element coordinates), in int64 arithmetic
    masked to 32 bits."""
    seed = int(seed) & _MASK32
    rows = torch.as_tensor(rows, dtype=torch.int64) & _MASK32
    cols = torch.as_tensor(cols, dtype=torch.int64) & _MASK32
    bh = torch.as_tensor(bh, dtype=torch.int64) & _MASK32
    h = (_mul32(rows, 0x9E3779B1) + cols) & _MASK32
    h = (h + _mul32(bh, 0x9e3779b9)) & _MASK32
    h = h ^ seed
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85ebca6b)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xc2b2ae35)
    h = h ^ (h >> 16)
    keep = (h >= dropout_threshold(rate)).to(torch.float32)
    return keep * float(onp.float32(1.0 / (1.0 - rate)))


def _seed_int(dropout_seed):
    if isinstance(dropout_seed, torch.Tensor):
        dropout_seed = dropout_seed.reshape(-1)[0].item()
    return int(onp.asarray(dropout_seed).reshape(-1)[0]) & _MASK32


def _normalize_mask(key_mask, B, H, Tk):
    """(mask as (rows, Tk) f32 additive, rows-per-mask divisor) or
    (None, 1)."""
    if key_mask is None:
        return None, 1
    if key_mask.dtype == torch.bool:
        key_mask = torch.where(key_mask, 0.0, _NEG_INF)
    key_mask = key_mask.to(torch.float32)
    if key_mask.dim() != 2 or key_mask.shape[1] != Tk:
        raise ValueError(f"key_mask must be (B, Tk) or (B*H, Tk), got "
                         f"{tuple(key_mask.shape)}")
    if key_mask.shape[0] == B * H:
        return key_mask.contiguous(), 1
    if key_mask.shape[0] == B:
        return key_mask.contiguous(), H
    raise ValueError(
        f"key_mask leading dim {key_mask.shape[0]} matches neither "
        f"batch {B} nor batch*heads {B * H}")


def flash_attention_reference(q, k, v, key_mask=None, causal=False,
                              dropout_p=0.0, dropout_seed=None):
    """Plain PyTorch version of the kernel: the same arithmetic in f32,
    with the whole key range as one tile. Returns (out (B, H, Tq, D) in
    q's dtype, lse (B, H, Tq) f32). ``key_mask`` is additive f32 of shape
    (B, Tk) or (B*H, Tk), or None."""
    B, H, Tq, D = q.shape
    Tk = k.shape[2]
    scale = 1.0 / math.sqrt(D)
    s = torch.einsum('bhqd,bhkd->bhqk', q.float(), k.float()) * scale
    if key_mask is not None:
        km = key_mask.to(torch.float32)
        s = s + km.reshape(B, -1, 1, Tk)
    if causal:
        keep = torch.ones(Tq, Tk, dtype=torch.bool,
                          device=q.device).tril()
        s = torch.where(keep, s, _NEG_INF)
    m = s.amax(-1, keepdim=True).clamp_min(_NEG_INF)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    if dropout_p > 0.0:
        dev = q.device
        bh = torch.arange(B * H, device=dev).reshape(B, H, 1, 1)
        rows = torch.arange(Tq, device=dev).reshape(1, 1, Tq, 1)
        cols = torch.arange(Tk, device=dev).reshape(1, 1, 1, Tk)
        p = p * counter_keep(_seed_int(dropout_seed), bh, rows, cols,
                             dropout_p).to(dev)
    acc = torch.einsum('bhqk,bhkd->bhqd', p.to(v.dtype).float(), v.float())
    safe_l = l.clamp_min(1e-30)
    out = (acc / safe_l).to(q.dtype)
    lse = (m + torch.log(safe_l))[..., 0]
    return out, lse


def _check_kernel_inputs(q, k, v):
    for name, t in (('q', q), ('k', k), ('v', v)):
        if not t.is_cuda:
            raise MXNetError(f"flash_attention: {name} is on {t.device} "
                             f"while q is on CUDA")
        if t.dim() != 4:
            raise MXNetError(f"flash_attention: {name} must be (B, H, T, "
                             f"D), got {tuple(t.shape)}")
        if t.dtype != q.dtype:
            raise MXNetError("flash_attention: q, k, v dtypes differ")
        if t.stride(-1) != 1:
            raise MXNetError(f"flash_attention: {name} needs a unit "
                             f"stride on D")
    if q.dtype not in _DTYPE_CODE:
        raise MXNetError(f"flash_attention kernel takes float32 or "
                         f"bfloat16, got {q.dtype}")
    B, H, _, D = q.shape
    if k.shape[:2] != (B, H) or v.shape != k.shape or k.shape[3] != D:
        raise MXNetError(f"flash_attention: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)} disagree")
    if D not in KERNEL_HEAD_DIMS:
        raise MXNetError(f"flash_attention kernel head dim must be one of "
                         f"{KERNEL_HEAD_DIMS}, got {D}")


def _launch(q, k, v, kmask, mask_div, causal, dropout_p, seed):
    _check_kernel_inputs(q, k, v)
    B, H, Tq, D = q.shape
    Tk = k.shape[2]
    if kmask is not None and kmask.device != q.device:
        raise MXNetError("flash_attention: key_mask is on another device")
    # o in (B, Tq, H, D) memory, viewed as (B, H, Tq, D): the caller's
    # transpose back to (B, Tq, H*D) is then free
    o = torch.empty(B, Tq, H, D, dtype=q.dtype,
                    device=q.device).permute(0, 2, 1, 3)
    lse = torch.empty(B * H, Tq, dtype=torch.float32, device=q.device)
    lib = _build.library('flash_attn_fwd.cu')
    fn = lib.mxtt_flash_attn_fwd
    if fn.argtypes is None:
        ll, i, vp = ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p
        fn.argtypes = [i, i, vp, vp, vp, vp, vp, vp, i, i, i, i] + \
            [ll] * 12 + [i, ctypes.c_float, i, ctypes.c_uint,
                         ctypes.c_uint, ctypes.c_float, i, vp]
        fn.restype = ctypes.c_int
    use_dropout = dropout_p > 0.0
    strides = []
    for t in (q, k, v, o):
        strides += [t.stride(0), t.stride(1), t.stride(2)]
    rc = fn(_DTYPE_CODE[q.dtype], D, q.data_ptr(), k.data_ptr(),
            v.data_ptr(), kmask.data_ptr() if kmask is not None else None,
            o.data_ptr(), lse.data_ptr(), B, H, Tq, Tk, *strides, mask_div,
            1.0 / math.sqrt(D), int(bool(causal)),
            seed if use_dropout else 0,
            dropout_threshold(dropout_p) if use_dropout else 0,
            float(onp.float32(1.0 / (1.0 - dropout_p))) if use_dropout
            else 1.0,
            int(use_dropout), torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(rc, 'flash_attn_fwd')
    _build.launch_counts['flash_attn_fwd'] += 1
    return o, lse.reshape(B, H, Tq)


def flash_attention_forward(q, k, v, key_mask=None, causal=False,
                            dropout_p=0.0, dropout_seed=None):
    """(out (B, H, Tq, D), lse (B, H, Tq) f32): the kernel's two outputs,
    as ``_fa_forward`` returns them."""
    B, H, Tq, D = q.shape
    Tk = k.shape[2]
    km, mask_div = _normalize_mask(key_mask, B, H, Tk)
    dropout_p = float(dropout_p)
    if dropout_p > 0.0 and dropout_seed is None:
        raise ValueError("dropout_p > 0 requires dropout_seed")
    if q.is_cuda:
        seed = _seed_int(dropout_seed) if dropout_p > 0.0 else 0
        return _launch(q, k, v, km, mask_div, causal, dropout_p, seed)
    if q.device.type != 'cpu':
        raise MXNetError(f"flash_attention: unsupported device {q.device}")
    return flash_attention_reference(q, k, v, km, causal, dropout_p,
                                     dropout_seed)


def flash_attention(q, k, v, key_mask=None, causal=False, dropout_p=0.0,
                    dropout_seed=None):
    """Flash attention over (B, H, T, D) q/k/v; returns (B, H, Tq, D)."""
    return flash_attention_forward(q, k, v, key_mask, causal, dropout_p,
                                   dropout_seed)[0]
