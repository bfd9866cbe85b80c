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

The forward, dq and dk/dv kernels each come in two variants, chosen by
``kernel_variant`` from the dtype and the head dim alone: ``'tc'`` runs
the products on the tensor cores (bfloat16 or float16, D a multiple of
16, 16-byte aligned rows, else the wrapper raises), ``'simt'`` is the
first design in scalar f32 FMAs (f32, or D = 8). The backward's two
kernels take one variant. ``_build.variant_counts`` records which one
each launch took, ``_build.dtype_counts`` in which dtype.

In float16 the tensor-core backward cannot split its f32 operands (ds,
and p*keep) into two float16 terms as the bfloat16 kernels do: float16
overflows above 65504, and under the float16 AMP recipe dO carries the
loss scale, so ds reaches that. ``split_f16`` gives the kernels' answer:
each row is scaled by a power of two that brings its largest magnitude
into [2**14, 2**15) before the split, and the product is scaled back.

Attention dropout is the JAX package's counter hash (``counter_keep``):
the keep mask is a pure function of (seed, batch*head, row, col), so the
kernel, the plain version and the Pallas kernel agree bit for bit. The
seed lives on the device, as the Pallas kernels' ``seed_ref`` operand
does: ``dropout_seed`` is a one-element int64 (or int32) tensor, whose low
32 bits the kernels read once per block through a pointer, so a seed drawn
on the card never passes through the host and a CUDA graph that draws it
replays with a fresh one. A Python int is accepted too and put in a device
tensor first, which is refused inside a CUDA-graph capture.

Under data parallelism each rank holds its rows of the global batch, and
the JAX package's program hashes the global batch*head index. ``bh_base``
(a rank's first global batch*head, ``rank * local batch * heads``; 0 by
default) is added to the local index in the hash, in the kernels and the
plain versions alike, so two ranks with one seed draw the masks the
one-device program draws for their rows. ``bh_base = 0`` is bit for bit
the hash without it. The key mask's rows stay local.
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
           'dropout_threshold', 'seed_tensor', 'split_bf16',
           'split_f16', 'kernel_variant', 'tile_built', 'tile_attributes',
           'tile_kernel_name', 'KERNEL_HEAD_DIMS', 'TC_HEAD_DIMS', 'TILES',
           'DEFAULT_TILE']

_NEG_INF = -1e30
_MASK32 = 0xFFFFFFFF
KERNEL_HEAD_DIMS = (8, 16, 32, 64, 128)
TC_HEAD_DIMS = (16, 32, 64, 128)       # the tensor-core variants' head dims
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_TC_DTYPES = (torch.bfloat16, torch.float16)
F16_TOP = 14         # split_f16 scales a row's largest |x| below 2**15
F16_MIN_EXP = -100   # the least row exponent split_f16 scales by

# The tensor-core kernels' built tiles, (bq, bk) -> head dims, by kernel:
# the default in flash_attn_fwd.cu / flash_attn_bwd.cu for every
# tensor-core head dim, the others in flash_attn_{fwd,dq,dkv}_tiles.cu
# (their MXTT_*_TILES lists, which a CPU test reads against this table).
# One backward tile sizes both dq and dk/dv, so their tiles are the same.
DEFAULT_TILE = (64, 64)
_FWD_TILES = ((64, 32), (64, 128), (128, 32), (128, 64), (128, 128))
_BWD_TILES = ((64, 128), (128, 64), (128, 128))
TILES = {
    kernel: {DEFAULT_TILE: TC_HEAD_DIMS, **{t: (64, 128) for t in extra}}
    for kernel, extra in (('fwd', _FWD_TILES), ('dq', _BWD_TILES),
                          ('dkv', _BWD_TILES))}
_TILE_SOURCES = {'fwd': ('flash_attn_fwd.cu', 'flash_attn_fwd_tiles.cu'),
                 'dq': ('flash_attn_bwd.cu', 'flash_attn_dq_tiles.cu'),
                 'dkv': ('flash_attn_bwd.cu', 'flash_attn_dkv_tiles.cu')}
_TILE_ENTRY = {'fwd': 'mxtt_flash_attn_fwd_tc',
               'dq': 'mxtt_flash_attn_bwd_dq_tc',
               'dkv': 'mxtt_flash_attn_bwd_dkv_tc'}
_TILE_KERNEL = {'fwd': 'flash_fwd_tc_kernel', 'dq': 'flash_bwd_dq_tc_kernel',
                'dkv': 'flash_bwd_dkv_tc_kernel'}


def dropout_threshold(rate):
    """The uint32 keep threshold: keep where hash >= threshold."""
    return min(int(float(rate) * 2.0 ** 32), 2 ** 32 - 1)


def kernel_variant(dtype, D):
    """'tc' (tensor cores) for bfloat16 and float16 at a head dim in
    ``TC_HEAD_DIMS``, else 'simt': the kernel the forward, dq and dk/dv
    wrappers launch."""
    return 'tc' if dtype in _TC_DTYPES and D in TC_HEAD_DIMS else 'simt'


def tile_built(kernel, D, tile):
    """Whether the tensor-core ``kernel`` ('fwd', 'dq' or 'dkv') is built
    at ``tile`` (bq, bk) for head dim D."""
    return D in TILES[kernel].get(tuple(tile), ())


def _tile_library(kernel, tile):
    default, others = _TILE_SOURCES[kernel]
    return _build.library(default if tuple(tile) == DEFAULT_TILE
                          else others)


def tile_kernel_name(kernel, dtype, D, tile):
    """The instantiation's name, as the ptxas report names it
    ('flash_fwd_tc_kernel<13__nv_bfloat16Li64ELi64ELi64E>')."""
    e = {torch.bfloat16: '13__nv_bfloat16', torch.float16: '6__half'}[dtype]
    bq, bk = tile
    return f'{_TILE_KERNEL[kernel]}<{e}Li{D}ELi{bq}ELi{bk}E>'


def tile_attributes(kernel, dtype, D, tile):
    """{'registers', 'local_bytes', 'max_threads'} of one built
    tensor-core instantiation on the card (``cudaFuncGetAttributes``):
    local bytes above 0 are spills."""
    _check_tile(kernel, dtype, D, tile)
    fn = getattr(_tile_library(kernel, tile), _TILE_ENTRY[kernel] + '_attrs')
    if fn.argtypes is None:
        i = ctypes.c_int
        fn.argtypes = [i, i, i, i, ctypes.POINTER(ctypes.c_int)]
        fn.restype = i
    out = (ctypes.c_int * 3)()
    _build.check(fn(_DTYPE_CODE[dtype], D, tile[0], tile[1], out),
                 f'{_TILE_ENTRY[kernel]}_attrs')
    return {'registers': out[0], 'local_bytes': out[1],
            'max_threads': out[2]}


def _check_tile(kernel, dtype, D, tile):
    if dtype not in _TC_DTYPES or not tile_built(kernel, D, tile):
        raise MXNetError(
            f"flash_attention: the {kernel} kernel is not built at tile "
            f"{tuple(tile)} for {dtype}, D={D} (built: "
            f"{ {t: d for t, d in TILES[kernel].items()} }); no other tile "
            f"is taken in its place")


def _block_sizes(BH, Tq, Tk, D, dtype, kind='fwd'):
    """(G, bq, bk) of one kernel instance: ``autotune.resolve`` over the
    ladder env override (``MXTPU_FA_*``) > tuning-DB winner
    (``MXTPU_AUTOTUNE_DIR``) > the default (1, 64, 64), clamped to a
    legal, built tile and recorded (the counterpart of the JAX
    ``_block_sizes``)."""
    from . import autotune
    return autotune.resolve(autotune.KERNEL_FA, BH, Tq, Tk, D, dtype, kind,
                            default=(1,) + DEFAULT_TILE)


def _tile(q, k, kind):
    B, H, Tq, D = q.shape
    return tuple(_block_sizes(B * H, Tq, k.shape[2], D, q.dtype, kind)[1:])


def split_bf16(x):
    """(hi, lo) bf16 with hi = bf16(x) and lo = bf16(x - hi): the two terms
    the tensor-core dq and dk/dv kernels multiply in place of one f32
    operand (ds; p*keep). hi + lo is within 2**-16 |x| of x."""
    hi = x.to(torch.bfloat16)
    return hi, (x - hi.float()).to(torch.bfloat16)


def split_f16(x):
    """(hi, lo, e): the float16 tensor-core backward's split of an f32
    operand, row by row (the last dim). e (int32, one per row) is the
    exponent of the row's largest |x|, at least ``F16_MIN_EXP``; with
    y = x * 2**(F16_TOP - e), whose magnitudes are below 2**15,
    hi = f16(y) and lo = f16(y - hi), so x = (hi + lo) * 2**(e - F16_TOP)
    within 2**-22 |x| plus 2**-25 of the scale (where y is subnormal in
    float16). The kernels multiply both terms against the exact float16
    operand with f32 sums and scale the sum back by 2**(e - F16_TOP); a
    non-finite x stays non-finite. In the kernels e is the largest
    exponent of the tiles seen so far along the row (the sums rescaled
    when it grows); over one tile, as here, it is the row's."""
    m = x.abs().amax(-1, keepdim=True)
    e = (torch.frexp(m)[1] - 1).clamp_min(F16_MIN_EXP)   # floor(log2 m)
    y = x * torch.exp2((F16_TOP - e).to(torch.float32))
    hi = y.to(torch.float16)
    return hi, (y - hi.float()).to(torch.float16), e[..., 0]


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
    masked to 32 bits. ``seed`` is an int or a one-element integer tensor
    on the coordinates' device (read there, with no host sync)."""
    if isinstance(seed, torch.Tensor):
        seed = seed.reshape(-1)[:1].to(torch.int64) & _MASK32
    else:
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


_SEED_DTYPES = (torch.int64, torch.int32)


def seed_tensor(dropout_seed, device):
    """``dropout_seed`` as a one-element int64/int32 tensor on ``device``:
    a tensor already there is used as it is (its first element); an int,
    a numpy value or a tensor elsewhere is copied there, which is refused
    while the current stream is being captured into a CUDA graph (the
    copy would be frozen into the graph, or would sync)."""
    device = torch.device(device)
    if isinstance(dropout_seed, torch.Tensor):
        if dropout_seed.dtype not in _SEED_DTYPES:
            raise MXNetError(f"flash_attention: dropout_seed must be an "
                             f"int64 or int32 tensor, got "
                             f"{dropout_seed.dtype}")
        t = dropout_seed.reshape(-1)[:1]
        if t.numel() != 1:
            raise MXNetError("flash_attention: dropout_seed is empty")
        if t.device == device:
            return t
    else:
        t = torch.tensor([int(onp.asarray(dropout_seed).reshape(-1)[0]) &
                          _MASK32], dtype=torch.int64)
    if device.type == 'cuda' and torch.cuda.is_current_stream_capturing():
        raise MXNetError("flash_attention: a dropout_seed on the host cannot "
                         "be captured into a CUDA graph; draw it on the "
                         "device (a one-element int64 tensor)")
    return t.to(device)


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


def _bh_base(bh_base):
    """``bh_base`` as the kernels' uint32 (the hash wraps mod 2**32)."""
    bh_base = int(bh_base)
    if bh_base < 0:
        raise ValueError(f"flash_attention: bh_base must be >= 0, got "
                         f"{bh_base}")
    return bh_base & _MASK32


def _keep_multipliers(dropout_seed, B, H, Tq, Tk, rate, dev, bh_base=0):
    """(B, H, Tq, Tk) keep/(1-rate) multipliers over global coordinates,
    the batch*head index counted from ``bh_base``."""
    bh = bh_base + torch.arange(B * H, device=dev).reshape(B, H, 1, 1)
    rows = torch.arange(Tq, device=dev).reshape(1, 1, Tq, 1)
    cols = torch.arange(Tk, device=dev).reshape(1, 1, 1, Tk)
    return counter_keep(seed_tensor(dropout_seed, dev), bh, rows, cols,
                        rate).to(dev)


def flash_attention_reference(q, k, v, key_mask=None, causal=False,
                              dropout_p=0.0, dropout_seed=None, bh_base=0):
    """Plain PyTorch version of the forward kernel: the same arithmetic in
    f32, with the whole key range as one tile. Returns (out (B, H, Tq, D)
    in q's dtype, lse (B, H, Tq) f32). ``key_mask`` is additive f32 of
    shape (B, Tk) or (B*H, Tk), or None; ``bh_base`` as for
    ``flash_attention``."""
    B, H, Tq, D = q.shape
    Tk = k.shape[2]
    s = _scores(q, k, key_mask, causal)
    m = s.amax(-1, keepdim=True).clamp_min(_NEG_INF)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    if dropout_p > 0.0:
        p = p * _keep_multipliers(dropout_seed, B, H, Tq, Tk, dropout_p,
                                  q.device, _bh_base(bh_base))
    acc = torch.einsum('bhqk,bhkd->bhqd', p.to(v.dtype).float(), v.float())
    safe_l = l.clamp_min(1e-30)
    out = (acc / safe_l).to(q.dtype)
    lse = (m + torch.log(safe_l))[..., 0]
    return out, lse


def flash_attention_backward_reference(q, k, v, key_mask, causal, dropout_p,
                                       dropout_seed, out, lse, do,
                                       bh_base=0):
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
                                 q.device, _bh_base(bh_base))
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
        raise MXNetError(f"flash_attention kernel takes float32, bfloat16 "
                         f"or float16, got {q.dtype}")
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


def _tc_aligned(t):
    """Whether every (B, H, T) row of a 16-bit tensor starts on 16 bytes, as
    the tensor-core kernels' 16-byte copies need: the base, and the
    strides of the dims longer than 1, in multiples of 8 elements."""
    return t.data_ptr() % 16 == 0 and all(
        st % 8 == 0 for n, st in zip(t.shape[:3], t.stride()[:3]) if n > 1)


def _pick_variant(q, named, forced):
    """The variant to launch: ``kernel_variant`` unless ``forced`` names
    one. Raises where the tensor-core kernel cannot take the inputs."""
    D = q.shape[-1]
    variant = forced or kernel_variant(q.dtype, D)
    if variant not in ('tc', 'simt'):
        raise MXNetError(f"flash_attention: unknown kernel variant "
                         f"{variant!r}")
    if variant == 'tc':
        if kernel_variant(q.dtype, D) != 'tc':
            raise MXNetError(f"flash_attention: the tensor-core kernel takes "
                             f"bfloat16 or float16 with a head dim in "
                             f"{TC_HEAD_DIMS}, got {q.dtype}, D={D}")
        for name, t in named:
            if not _tc_aligned(t):
                raise MXNetError(
                    f"flash_attention: {name} rows are not 16-byte aligned "
                    f"(offset {t.data_ptr() % 16} bytes, strides "
                    f"{tuple(t.stride())}); the tensor-core kernel copies "
                    f"16 bytes at a time")
    return variant


def _dropout_args(dropout_p, seed, bh_base):
    """(seed pointer, uint32 threshold, keep scale, flag, bh_base) as the
    kernels take them; ``seed`` is the device tensor of ``_prepare``."""
    if dropout_p <= 0.0:
        return None, 0, 1.0, 0, 0
    return (seed.data_ptr(), dropout_threshold(dropout_p),
            float(onp.float32(1.0 / (1.0 - dropout_p))), 1,
            _bh_base(bh_base))


def _like_bthd(t):
    """An empty (B, H, T, D) tensor in (B, T, H, D) memory, like the caller's
    (B, T, H*D) projections: the transpose back is then free."""
    B, H, T, D = t.shape
    return torch.empty(B, T, H, D, dtype=t.dtype,
                       device=t.device).permute(0, 2, 1, 3)


def _variant_tile(kernel, q, variant, tile):
    """The tile a launch runs at: the tensor-core kernels at a built tile
    (else MXNetError), the SIMT kernels at their one tile."""
    tile = tuple(tile)
    if variant == 'tc':
        _check_tile(kernel, q.dtype, q.shape[-1], tile)
    elif tile != DEFAULT_TILE:
        raise MXNetError(f"flash_attention: the SIMT {kernel} kernel is "
                         f"built at {DEFAULT_TILE} only, not {tile}")
    return tile


def _launch(q, k, v, kmask, mask_div, causal, dropout_p, seed,
            variant=None, bh_base=0, tile=DEFAULT_TILE):
    _check_kernel_inputs(q, k, v)
    B, H, Tq, D = q.shape
    Tk = k.shape[2]
    if kmask is not None and kmask.device != q.device:
        raise MXNetError("flash_attention: key_mask is on another device")
    o = _like_bthd(q)
    variant = _pick_variant(q, (('q', q), ('k', k), ('v', v)), variant)
    tile = _variant_tile('fwd', q, variant, tile)
    lse = torch.empty(B * H, Tq, dtype=torch.float32, device=q.device)
    if variant == 'tc':
        fn = getattr(_tile_library('fwd', tile), 'mxtt_flash_attn_fwd_tc')
        head = (_DTYPE_CODE[q.dtype], D) + tile
    else:
        fn = _build.library('flash_attn_fwd.cu').mxtt_flash_attn_fwd
        head = (_DTYPE_CODE[q.dtype], D)
    if fn.argtypes is None:
        ll, i, vp = ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p
        fn.argtypes = [i] * len(head) + [vp] * 6 + [i] * 4 + \
            [ll] * 12 + [i, ctypes.c_float, i, vp, ctypes.c_uint,
                         ctypes.c_float, i, ctypes.c_uint, vp]
        fn.restype = ctypes.c_int
    strides = []
    for t in (q, k, v, o):
        strides += [t.stride(0), t.stride(1), t.stride(2)]
    rc = fn(*head, q.data_ptr(), k.data_ptr(),
            v.data_ptr(), kmask.data_ptr() if kmask is not None else None,
            o.data_ptr(), lse.data_ptr(), B, H, Tq, Tk, *strides, mask_div,
            1.0 / math.sqrt(D), int(bool(causal)),
            *_dropout_args(dropout_p, seed, bh_base),
            torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(rc, f'flash_attn_fwd ({variant}, tile {tile})')
    _build.count_launch('flash_attn_fwd', variant, q.dtype, tile)
    return o, lse.reshape(B, H, Tq)


def _bwd_fn(kernel, variant, tile):
    if variant == 'tc':
        fn = getattr(_tile_library(kernel, tile), _TILE_ENTRY[kernel])
        n_head = 4
    else:
        fn = getattr(_build.library('flash_attn_bwd.cu'),
                     'mxtt_flash_attn_bwd_' + kernel)
        n_head = 2
    if fn.argtypes is None:
        i, vp = ctypes.c_int, ctypes.c_void_p
        outs = [vp] if kernel == 'dq' else [vp, vp]
        fn.argtypes = [i] * n_head + [vp] * 7 + outs + [i] * 4 + [vp] + \
            [i, ctypes.c_float, i, vp, ctypes.c_uint, ctypes.c_float, i,
             ctypes.c_uint, vp]
        fn.restype = ctypes.c_int
    return fn


def _launch_bwd(q, k, v, kmask, mask_div, causal, dropout_p, seed, out,
                lse, do, variant=None, bh_base=0, tile=DEFAULT_TILE):
    """The dq kernel, then the dk/dv kernel, both of one variant (picked
    as for the forward) and at one tile, on the current stream."""
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
    variant = _pick_variant(
        q, (('q', q), ('k', k), ('v', v), ('dO', do)), variant)
    tile = _variant_tile('dq', q, variant, tile)
    if variant == 'tc':
        _check_tile('dkv', q.dtype, D, tile)
    head = (_DTYPE_CODE[q.dtype], D) + (tile if variant == 'tc' else ())
    stream = torch.cuda.current_stream(q.device).cuda_stream
    common = (q.data_ptr(), k.data_ptr(),
              v.data_ptr(), kmask.data_ptr() if kmask is not None else None,
              do.data_ptr(), lse.data_ptr(), delta.data_ptr())
    tail = (mask_div, 1.0 / math.sqrt(D), int(bool(causal)),
            *_dropout_args(dropout_p, seed, bh_base), stream)
    for kernel, outs in (('dq', (dq,)), ('dkv', (dk, dv))):
        st = []
        for t in (q, k, v, do, outs[0]):
            st += [t.stride(0), t.stride(1), t.stride(2)]
        strides = (ctypes.c_longlong * 15)(*st)
        rc = _bwd_fn(kernel, variant, tile)(
            *head, *common, *(t.data_ptr() for t in outs), B, H, Tq, Tk,
            strides, *tail)
        _build.check(rc, f'flash_attn_bwd_{kernel} ({variant}, tile {tile})')
        _build.count_launch(f'flash_attn_bwd_{kernel}', variant, q.dtype,
                            tile)
    return dq, dk, dv


def _prepare(q, k, key_mask, dropout_p, dropout_seed):
    """Checks the device and the dropout arguments; returns (mask as
    (rows, Tk) f32 additive or None, rows-per-mask divisor, dropout_p,
    the seed as a one-element tensor on q's device, or None without
    dropout)."""
    if not q.is_cuda and q.device.type != 'cpu':
        raise MXNetError(f"flash_attention: unsupported device {q.device}")
    dropout_p = float(dropout_p)
    if dropout_p > 0.0 and dropout_seed is None:
        raise ValueError("dropout_p > 0 requires dropout_seed")
    B, H = q.shape[:2]
    km, mask_div = _normalize_mask(key_mask, B, H, k.shape[2])
    seed = seed_tensor(dropout_seed, q.device) if dropout_p > 0.0 else None
    return km, mask_div, dropout_p, seed


def _forward(q, k, v, km, mask_div, causal, dropout_p, seed, variant=None,
             bh_base=0):
    """(out, lse): the forward kernel for CUDA tensors at the resolved
    tile, the plain version for CPU tensors (the decision is recorded on
    both)."""
    tile = _tile(q, k, 'fwd')
    if q.is_cuda:
        return _launch(q, k, v, km, mask_div, causal, dropout_p, seed,
                       variant, bh_base, tile)
    return flash_attention_reference(q, k, v, km, causal, dropout_p, seed,
                                     bh_base)


def _backward(q, k, v, km, mask_div, causal, dropout_p, seed, out, lse, do,
              variant=None, bh_base=0):
    """(dq, dk, dv): the two backward kernels for CUDA tensors at the
    resolved tile, the plain version for CPU tensors."""
    tile = _tile(q, k, 'bwd')
    if q.is_cuda:
        return _launch_bwd(q, k, v, km, mask_div, causal, dropout_p, seed,
                           out, lse, do, variant, bh_base, tile)
    return flash_attention_backward_reference(q, k, v, km, causal, dropout_p,
                                              seed, out, lse, do, bh_base)


def flash_attention_forward(q, k, v, key_mask=None, causal=False,
                            dropout_p=0.0, dropout_seed=None, _variant=None,
                            bh_base=0):
    """(out (B, H, Tq, D), lse (B, H, Tq) f32): the forward's two outputs,
    as ``_fa_forward`` returns them, with no gradient. ``_variant``
    ('simt' or 'tc') overrides ``kernel_variant`` on the card, so that
    both kernels can be held against each other; nothing else passes it."""
    km, mask_div, dropout_p, seed = _prepare(q, k, key_mask, dropout_p,
                                             dropout_seed)
    return _forward(q, k, v, km, mask_div, causal, dropout_p, seed, _variant,
                    bh_base)


def flash_attention_backward(q, k, v, key_mask, causal, dropout_p,
                             dropout_seed, out, lse, do, _variant=None,
                             bh_base=0):
    """(dq, dk, dv) in the input dtypes, as ``_fa_backward`` returns them:
    the two backward kernels for CUDA tensors, the plain version for CPU
    tensors. ``_variant`` picks the dq and dk/dv kernels as for the
    forward."""
    km, mask_div, dropout_p, seed = _prepare(q, k, key_mask, dropout_p,
                                             dropout_seed)
    return _backward(q, k, v, km, mask_div, causal, dropout_p, seed, out,
                     lse, do, _variant, bh_base)


class _FlashAttention(torch.autograd.Function):
    """The counterpart of the JAX ``_flash`` custom_vjp: the forward saves
    q, k, v, the normalised mask, the seed tensor, out and lse; the
    backward runs the two backward kernels (the plain version on the CPU)
    with the same seed tensor. The mask and the seed get no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, km, mask_div, causal, dropout_p, seed,
                bh_base):
        out, lse = _forward(q, k, v, km, mask_div, causal, dropout_p, seed,
                            bh_base=bh_base)
        ctx.save_for_backward(q, k, v, km, seed, out, lse)
        ctx.args = (mask_div, causal, dropout_p, bh_base)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, km, seed, out, lse = ctx.saved_tensors
        mask_div, causal, dropout_p, bh_base = ctx.args
        if do.stride(-1) != 1 or (
                do.is_cuda and kernel_variant(do.dtype, do.shape[-1]) == 'tc'
                and not _tc_aligned(do)):
            do = do.contiguous()
        dq, dk, dv = _backward(q, k, v, km, mask_div, causal, dropout_p,
                               seed, out, lse, do, bh_base=bh_base)
        return dq, dk, dv, None, None, None, None, None, None


def flash_attention(q, k, v, key_mask=None, causal=False, dropout_p=0.0,
                    dropout_seed=None, bh_base=0):
    """Flash attention over (B, H, T, D) q/k/v; returns (B, H, Tq, D),
    differentiable in q, k and v. ``bh_base`` offsets the batch*head
    index of the dropout hash (see the module docstring)."""
    km, mask_div, dropout_p, seed = _prepare(q, k, key_mask, dropout_p,
                                             dropout_seed)
    return _FlashAttention.apply(q, k, v, km, mask_div, bool(causal),
                                 dropout_p, seed, _bh_base(bh_base))
