"""Flash attention: the hand-written Hopper kernels, forward and backward,
and their plain PyTorch versions (counterpart of
``mxnet_tpu/ops/pallas_attention.py``).

``flash_attention`` keeps the JAX signature and mask handling: q/k/v are
(B, H, T, D); ``key_mask`` is an optional (B, Tk) or (B*H, Tk) mask,
additive f32 (0 = keep, large negative = drop) or boolean (True = keep);
``dropout_p > 0`` needs ``dropout_seed``. It goes through
``_FlashAttention``, the counterpart of the JAX ``custom_vjp``: for CUDA
tensors the forward is the kernel in ``csrc/flash_attn_fwd.cu`` and the
backward the dq and dk/dv kernels in ``csrc/flash_attn_bwd.cu``; for CPU
tensors they are ``flash_attention_reference`` and
``flash_attention_backward_reference``, which do the same arithmetic in
torch f32. There is no fallback from one to the other.

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
           'flash_attention_backward', 'flash_attention_reference',
           'flash_attention_backward_reference', 'counter_keep',
           'dropout_threshold', 'KERNEL_HEAD_DIMS']

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


def _scores(q, k, key_mask, causal):
    """(B, H, Tq, Tk) f32 scores in the order of ``_masked_scores``:
    q.k^T * scale, the additive mask, the causal cut."""
    B, H, Tq, D = q.shape
    Tk = k.shape[2]
    s = torch.einsum('bhqd,bhkd->bhqk', q.float(), k.float()) * \
        (1.0 / math.sqrt(D))
    if key_mask is not None:
        s = s + key_mask.to(torch.float32).reshape(B, -1, 1, Tk)
    if causal:
        keep = torch.ones(Tq, Tk, dtype=torch.bool, device=q.device).tril()
        s = torch.where(keep, s, _NEG_INF)
    return s


def _keep_multipliers(dropout_seed, B, H, Tq, Tk, rate, dev):
    """(B, H, Tq, Tk) keep/(1-rate) multipliers over global coordinates."""
    bh = torch.arange(B * H, device=dev).reshape(B, H, 1, 1)
    rows = torch.arange(Tq, device=dev).reshape(1, 1, Tq, 1)
    cols = torch.arange(Tk, device=dev).reshape(1, 1, 1, Tk)
    return counter_keep(_seed_int(dropout_seed), bh, rows, cols,
                        rate).to(dev)


def flash_attention_reference(q, k, v, key_mask=None, causal=False,
                              dropout_p=0.0, dropout_seed=None):
    """Plain PyTorch version of the forward kernel: the same arithmetic in
    f32, with the whole key range as one tile. Returns (out (B, H, Tq, D)
    in q's dtype, lse (B, H, Tq) f32). ``key_mask`` is additive f32 of
    shape (B, Tk) or (B*H, Tk), or None."""
    B, H, Tq, D = q.shape
    Tk = k.shape[2]
    s = _scores(q, k, key_mask, causal)
    m = s.amax(-1, keepdim=True).clamp_min(_NEG_INF)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    if dropout_p > 0.0:
        p = p * _keep_multipliers(dropout_seed, B, H, Tq, Tk, dropout_p,
                                  q.device)
    acc = torch.einsum('bhqk,bhkd->bhqd', p.to(v.dtype).float(), v.float())
    safe_l = l.clamp_min(1e-30)
    out = (acc / safe_l).to(q.dtype)
    lse = (m + torch.log(safe_l))[..., 0]
    return out, lse


def flash_attention_backward_reference(q, k, v, key_mask, causal, dropout_p,
                                       dropout_seed, out, lse, do):
    """Plain PyTorch version of the two backward kernels (``_fa_backward``):
    p = exp(s - lse) from the forward's lse, dp = dO.v^T, dp *= keep under
    dropout, ds = p * (dp - delta) * scale with delta = rowsum(dO * O),
    then dq = ds.k, dk = ds^T.q and dv = (p*keep)^T.dO with p in f32, all
    in f32 with the whole key range as one tile, cast to the input dtypes.
    ``key_mask`` is as for ``flash_attention_reference``; lse is
    (B, H, Tq) f32."""
    B, H, Tq, D = q.shape
    Tk = k.shape[2]
    scale = 1.0 / math.sqrt(D)
    p = torch.exp(_scores(q, k, key_mask, causal) - lse.float()[..., None])
    do32 = do.float()
    dp = torch.einsum('bhqd,bhkd->bhqk', do32, v.float())
    pv = p
    if dropout_p > 0.0:
        keep = _keep_multipliers(dropout_seed, B, H, Tq, Tk, dropout_p,
                                 q.device)
        pv = p * keep
        dp = dp * keep
    delta = (do32 * out.float()).sum(-1, keepdim=True)
    ds = p * (dp - delta) * scale
    dq = torch.einsum('bhqk,bhkd->bhqd', ds, k.float())
    dk = torch.einsum('bhqk,bhqd->bhkd', ds, q.float())
    dv = torch.einsum('bhqk,bhqd->bhkd', pv, do32)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check_kernel_inputs(q, k, v, *more):
    """Raises on what the kernels do not take. ``more`` holds (name,
    tensor) pairs shaped like q (dO and O for the backward)."""
    for name, t in (('q', q), ('k', k), ('v', v)) + more:
        if not t.is_cuda:
            raise MXNetError(f"flash_attention: {name} is on {t.device} "
                             f"while q is on CUDA")
        if t.dim() != 4:
            raise MXNetError(f"flash_attention: {name} must be (B, H, T, "
                             f"D), got {tuple(t.shape)}")
        if t.dtype != q.dtype:
            raise MXNetError(f"flash_attention: {name}'s dtype {t.dtype} "
                             f"differs from q's {q.dtype}")
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
    for name, t in more:
        if t.shape != q.shape:
            raise MXNetError(f"flash_attention: {name} {tuple(t.shape)} "
                             f"does not match q {tuple(q.shape)}")
    if D not in KERNEL_HEAD_DIMS:
        raise MXNetError(f"flash_attention kernel head dim must be one of "
                         f"{KERNEL_HEAD_DIMS}, got {D}")


def _check_rows(name, t, q, BH, Tq):
    if t.device != q.device or t.dtype != torch.float32 or \
            tuple(t.shape) != (BH, Tq) or not t.is_contiguous():
        raise MXNetError(f"flash_attention: {name} must be a contiguous "
                         f"({BH}, {Tq}) float32 tensor on {q.device}, got "
                         f"{tuple(t.shape)} {t.dtype} on {t.device}")


def _dropout_args(dropout_p, seed):
    """(seed, uint32 threshold, keep scale, flag) as the kernels take them."""
    if dropout_p <= 0.0:
        return 0, 0, 1.0, 0
    return (seed, dropout_threshold(dropout_p),
            float(onp.float32(1.0 / (1.0 - dropout_p))), 1)


def _like_bthd(t):
    """An empty (B, H, T, D) tensor in (B, T, H, D) memory, like the caller's
    (B, T, H*D) projections: the transpose back is then free."""
    B, H, T, D = t.shape
    return torch.empty(B, T, H, D, dtype=t.dtype,
                       device=t.device).permute(0, 2, 1, 3)


def _launch(q, k, v, kmask, mask_div, causal, dropout_p, seed):
    _check_kernel_inputs(q, k, v)
    B, H, Tq, D = q.shape
    Tk = k.shape[2]
    if kmask is not None and kmask.device != q.device:
        raise MXNetError("flash_attention: key_mask is on another device")
    o = _like_bthd(q)
    lse = torch.empty(B * H, Tq, dtype=torch.float32, device=q.device)
    lib = _build.library('flash_attn_fwd.cu')
    fn = lib.mxtt_flash_attn_fwd
    if fn.argtypes is None:
        ll, i, vp = ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p
        fn.argtypes = [i, i, vp, vp, vp, vp, vp, vp, i, i, i, i] + \
            [ll] * 12 + [i, ctypes.c_float, i, ctypes.c_uint,
                         ctypes.c_uint, ctypes.c_float, i, vp]
        fn.restype = ctypes.c_int
    strides = []
    for t in (q, k, v, o):
        strides += [t.stride(0), t.stride(1), t.stride(2)]
    rc = fn(_DTYPE_CODE[q.dtype], D, q.data_ptr(), k.data_ptr(),
            v.data_ptr(), kmask.data_ptr() if kmask is not None else None,
            o.data_ptr(), lse.data_ptr(), B, H, Tq, Tk, *strides, mask_div,
            1.0 / math.sqrt(D), int(bool(causal)),
            *_dropout_args(dropout_p, seed),
            torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(rc, 'flash_attn_fwd')
    _build.launch_counts['flash_attn_fwd'] += 1
    return o, lse.reshape(B, H, Tq)


def _bwd_fn(name):
    fn = getattr(_build.library('flash_attn_bwd.cu'), name)
    if fn.argtypes is None:
        i, vp = ctypes.c_int, ctypes.c_void_p
        outs = [vp] if name.endswith('_dq') else [vp, vp]
        fn.argtypes = [i, i] + [vp] * 7 + outs + [i] * 4 + [vp] + \
            [i, ctypes.c_float, i, ctypes.c_uint, ctypes.c_uint,
             ctypes.c_float, i, vp]
        fn.restype = ctypes.c_int
    return fn


def _launch_bwd(q, k, v, kmask, mask_div, causal, dropout_p, seed, out,
                lse, do):
    """The dq kernel, then the dk/dv kernel, on the current stream."""
    _check_kernel_inputs(q, k, v, ('dO', do), ('out', out))
    B, H, Tq, D = q.shape
    Tk = k.shape[2]
    if kmask is not None and kmask.device != q.device:
        raise MXNetError("flash_attention: key_mask is on another device")
    lse = lse.reshape(B * H, Tq)
    _check_rows('lse', lse, q, B * H, Tq)
    # delta = rowsum(dO * O) in f32: XLA outside the kernels in JAX too
    delta = (do.float() * out.float()).sum(-1).reshape(B * H, Tq)
    dq, dk, dv = _like_bthd(q), _like_bthd(k), _like_bthd(v)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    common = (_DTYPE_CODE[q.dtype], D, q.data_ptr(), k.data_ptr(),
              v.data_ptr(), kmask.data_ptr() if kmask is not None else None,
              do.data_ptr(), lse.data_ptr(), delta.data_ptr())
    tail = (mask_div, 1.0 / math.sqrt(D), int(bool(causal)),
            *_dropout_args(dropout_p, seed), stream)
    for name, outs, count in (
            ('mxtt_flash_attn_bwd_dq', (dq,), 'flash_attn_bwd_dq'),
            ('mxtt_flash_attn_bwd_dkv', (dk, dv), 'flash_attn_bwd_dkv')):
        st = []
        for t in (q, k, v, do, outs[0]):
            st += [t.stride(0), t.stride(1), t.stride(2)]
        strides = (ctypes.c_longlong * 15)(*st)
        rc = _bwd_fn(name)(*common, *(t.data_ptr() for t in outs), B, H,
                           Tq, Tk, strides, *tail)
        _build.check(rc, count)
        _build.launch_counts[count] += 1
    return dq, dk, dv


def _prepare(q, k, key_mask, dropout_p, dropout_seed):
    """Checks the device and the dropout arguments; returns (mask as
    (rows, Tk) f32 additive or None, rows-per-mask divisor, dropout_p,
    uint32 seed)."""
    if not q.is_cuda and q.device.type != 'cpu':
        raise MXNetError(f"flash_attention: unsupported device {q.device}")
    dropout_p = float(dropout_p)
    if dropout_p > 0.0 and dropout_seed is None:
        raise ValueError("dropout_p > 0 requires dropout_seed")
    B, H = q.shape[:2]
    km, mask_div = _normalize_mask(key_mask, B, H, k.shape[2])
    seed = _seed_int(dropout_seed) if dropout_p > 0.0 else 0
    return km, mask_div, dropout_p, seed


def _forward(q, k, v, km, mask_div, causal, dropout_p, seed):
    """(out, lse): the forward kernel for CUDA tensors, the plain version
    for CPU tensors."""
    if q.is_cuda:
        return _launch(q, k, v, km, mask_div, causal, dropout_p, seed)
    return flash_attention_reference(q, k, v, km, causal, dropout_p, seed)


def _backward(q, k, v, km, mask_div, causal, dropout_p, seed, out, lse, do):
    """(dq, dk, dv): the two backward kernels for CUDA tensors, the plain
    version for CPU tensors."""
    if q.is_cuda:
        return _launch_bwd(q, k, v, km, mask_div, causal, dropout_p, seed,
                           out, lse, do)
    return flash_attention_backward_reference(q, k, v, km, causal, dropout_p,
                                              seed, out, lse, do)


def flash_attention_forward(q, k, v, key_mask=None, causal=False,
                            dropout_p=0.0, dropout_seed=None):
    """(out (B, H, Tq, D), lse (B, H, Tq) f32): the forward's two outputs,
    as ``_fa_forward`` returns them, with no gradient."""
    km, mask_div, dropout_p, seed = _prepare(q, k, key_mask, dropout_p,
                                             dropout_seed)
    return _forward(q, k, v, km, mask_div, causal, dropout_p, seed)


def flash_attention_backward(q, k, v, key_mask, causal, dropout_p,
                             dropout_seed, out, lse, do):
    """(dq, dk, dv) in the input dtypes, as ``_fa_backward`` returns them:
    the two backward kernels for CUDA tensors, the plain version for CPU
    tensors."""
    km, mask_div, dropout_p, seed = _prepare(q, k, key_mask, dropout_p,
                                             dropout_seed)
    return _backward(q, k, v, km, mask_div, causal, dropout_p, seed, out,
                     lse, do)


class _FlashAttention(torch.autograd.Function):
    """The counterpart of the JAX ``_flash`` custom_vjp: the forward saves
    q, k, v, the normalised mask, the seed, out and lse; the backward runs
    the two backward kernels (the plain version on the CPU). The mask and
    the seed get no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, km, mask_div, causal, dropout_p, seed):
        out, lse = _forward(q, k, v, km, mask_div, causal, dropout_p, seed)
        ctx.save_for_backward(q, k, v, km, out, lse)
        ctx.args = (mask_div, causal, dropout_p, seed)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, km, out, lse = ctx.saved_tensors
        mask_div, causal, dropout_p, seed = ctx.args
        if do.stride(-1) != 1:
            do = do.contiguous()
        dq, dk, dv = _backward(q, k, v, km, mask_div, causal, dropout_p,
                               seed, out, lse, do)
        return dq, dk, dv, None, None, None, None, None


def flash_attention(q, k, v, key_mask=None, causal=False, dropout_p=0.0,
                    dropout_seed=None):
    """Flash attention over (B, H, T, D) q/k/v; returns (B, H, Tq, D),
    differentiable in q, k and v."""
    km, mask_div, dropout_p, seed = _prepare(q, k, key_mask, dropout_p,
                                             dropout_seed)
    return _FlashAttention.apply(q, k, v, km, mask_div, bool(causal),
                                 dropout_p, seed)
