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
the int8 grid with it. The kvstore, the error-feedback callers, the
wire accounting and ``compression_params`` wait for ROADMAP queue 1
item 8.
"""
from __future__ import annotations

import torch

from ..base import MXNetError

__all__ = ['CODECS', 'BITS_PER_ELEM', 'encode_decode']

CODECS = ('none', 'fp16', 'int8', '2bit')

#: encoded payload size, bits per element (per-block scales apart)
BITS_PER_ELEM = {'fp16': 16, 'int8': 8, '2bit': 2}


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


def encode_decode(x, ctype, threshold=0.5, block=256):
    """The float32 value the far end of a compressed exchange would
    decode from ``x``. Non-finite inputs propagate to the output."""
    x = x.to(torch.float32)
    if ctype == 'fp16':
        return x.to(torch.float16).to(torch.float32)
    if ctype == 'int8':
        s = _block_scale(x, block) / 127.0
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
