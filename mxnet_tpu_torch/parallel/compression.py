"""Gradient-compression codecs, the quantize->dequantize round trip
(counterpart of ``encode_decode`` in ``mxnet_tpu/parallel/compression.py``).

The codec contract is the reference's 2-bit kvstore semantics
(src/kvstore/gradient_compression.h: quantize to {-t, 0, +t}),
generalized to three formats:

- ``fp16``  — truncate fp32 -> fp16;
- ``int8``  — per-block max-abs scale, round to [-127, 127];
- ``2bit``  — sign+threshold: {-t*s, 0, +t*s} where ``s`` is the
  per-block max-abs scale (or 1.0 with ``block=0``, the reference's
  absolute threshold).

NaN/Inf inputs propagate through every codec: a comparison against a
NaN is False, so a threshold quantizer would silently map a poisoned
value to 0; ``encode_decode`` re-injects non-finite inputs instead.

Plain torch ops, as the JAX codec is plain jnp (no hand-written
kernel). ``serving.quantize_weights(block, 'int8')`` snaps weights to
the int8 grid with it; the kvstore's ``GradientCompression`` (and
through it ``gluon.Trainer`` and ``Module``'s ``compression_params``)
carries its error-feedback residual. ``resolve`` validates a
``compression_params`` dict, ``wire_bytes`` counts a tensor's encoded
bytes. ``ShardedTrainStep``'s compression and its wire accounting wait
for ROADMAP queue 1 item 8.
"""
from __future__ import annotations

import torch

from ..base import MXNetError

__all__ = ['CODECS', 'BITS_PER_ELEM', 'resolve', 'n_scales', 'encode_decode',
           'wire_bytes']

CODECS = ('none', 'fp16', 'int8', '2bit')

#: encoded payload size, bits per element (per-block scales apart)
BITS_PER_ELEM = {'fp16': 16, 'int8': 8, '2bit': 2}


def resolve(compression_params):
    """Validate ``compression_params`` (a dict with ``type`` and optional
    ``threshold``/``block_size``) into ``{'type', 'threshold', 'block'}``,
    or None when compression is off (None, or type 'none'). An unknown
    codec, a threshold <= 0 or a negative block raises."""
    if compression_params is None:
        return None
    ctype = compression_params.get('type', '2bit')
    if ctype not in CODECS:
        raise MXNetError(
            f"gradient compression type {ctype!r} is not supported "
            f"(supported: {', '.join(repr(c) for c in CODECS)}). "
            f"'fp16' truncates to half precision, 'int8' rounds against "
            f"a per-block max-abs scale, '2bit' is the reference "
            f"kvstore's sign+threshold quantizer.")
    if ctype == 'none':
        return None
    threshold = float(compression_params.get('threshold', 0.5))
    block = int(compression_params.get('block_size', 256))
    if threshold <= 0:
        raise MXNetError(
            f"gradient compression threshold must be > 0, got "
            f"{threshold!r}")
    if block < 0:
        raise MXNetError(
            f"gradient compression block_size must be >= 0 "
            f"(0 = one per-tensor scale), got {block!r}")
    return {'type': ctype, 'threshold': threshold, 'block': block}


def _block_scale(x, block):
    """Per-block max-abs scale of ``x`` broadcast back to x's shape.
    Blocks tile the LAST dim when it divides evenly; otherwise one
    per-tensor scale. ``block=0`` is the explicit per-tensor mode. Zero
    blocks get scale 1.0 so the quantizer never divides by zero."""
    one = torch.ones((), dtype=torch.float32, device=x.device)
    if block and x.dim() and x.shape[-1] % block == 0 and \
            x.shape[-1] >= block:
        nb = x.shape[-1] // block
        v = x.reshape(tuple(x.shape[:-1]) + (nb, block))
        s = v.abs().amax(dim=-1, keepdim=True)
        s = torch.where(s > 0, s, one)
        return s.expand(v.shape).reshape(x.shape)
    s = x.abs().max() if x.numel() else one
    return torch.where(s > 0, s, one)


def n_scales(shape, block):
    """How many per-block float32 scales the encoded form of a tensor of
    ``shape`` carries."""
    if not shape:
        return 1
    size = 1
    for d in shape:
        size *= d
    if block and shape[-1] % block == 0 and shape[-1] >= block:
        return size // block
    return 1


def encode_decode(x, ctype, threshold=0.5, block=256):
    """The float32 value the far end of a compressed exchange would
    decode from ``x``. Non-finite inputs propagate to the output."""
    x = x.to(torch.float32)
    if ctype == 'fp16':
        return x.to(torch.float16).to(torch.float32)
    if ctype == 'int8':
        # a tensor divisor: CUDA divides by a Python number as a multiply
        # by its reciprocal, which rounds apart from the CPU's (and XLA's)
        # division
        s = _block_scale(x, block) / x.new_full((), 127.0)
        q = torch.clamp(torch.round(x / s), -127.0, 127.0)
        dec = q * s
    elif ctype == '2bit':
        s = _block_scale(x, block) if block else torch.ones(
            (), dtype=torch.float32, device=x.device)
        t = threshold * s
        zero = torch.zeros((), dtype=torch.float32, device=x.device)
        dec = torch.where(x >= t, t, torch.where(x <= -t, -t, zero))
    else:
        raise MXNetError(f"encode_decode: unknown codec {ctype!r}")
    return torch.where(torch.isfinite(x), dec, x)


def wire_bytes(shape, ctype, block=256):
    """Encoded bytes of one tensor on the wire: the payload's bits plus
    one float32 scale per block (fp16 and the absolute-threshold 2bit
    carry none). Uncompressed: ``4 * n`` float32 bytes."""
    size = 1
    for d in tuple(shape):
        size *= d
    if ctype == 'none' or not ctype:
        return 4 * size
    payload = (size * BITS_PER_ELEM[ctype] + 7) // 8
    scales = 0 if ctype == 'fp16' else 4 * n_scales(tuple(shape), block)
    if ctype == '2bit' and not block:
        scales = 0
    return payload + scales

