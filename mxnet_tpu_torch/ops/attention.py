"""Fused multi-head attention (counterpart of ``mxnet_tpu/ops/attention.py``
``multi_head_attention``).

Routing: CUDA tensors with no mask or a key-padding mask go to the flash
kernels (ops/flash_attention.py), forward and backward, so training takes
the flash route as the JAX package's does; everything else takes the
plain einsum path below, which is ordinary PyTorch math, not a fused
library call. A kernel failure raises: there is no quiet fallback.
``route_counts`` records each call's route (``'flash'`` is the JAX
package's ``'pallas'``, ``'plain'`` its ``'xla'``), so a run can show
that it took the kernel.
"""
from __future__ import annotations

import math

import torch

__all__ = ['multi_head_attention', 'route_counts']

route_counts = {'flash': 0, 'plain': 0}


def _as_key_padding_mask(mask, N, Tk):
    """If ``mask`` is a key-padding mask — broadcastable (N,1,1,Tk) or
    (N,Tk) — return it as (N, Tk) preserving its dtype; else None.
    Mask convention (both paths): boolean/integer masks are keep/drop
    (truthy = keep); floating masks are ADDITIVE (0.0 = keep, large
    negative = drop)."""
    if mask is None:
        return None
    shp = tuple(mask.shape)
    if shp == (N, Tk):
        return mask
    if len(shp) == 4 and shp[0] in (1, N) and shp[1] == 1 and shp[2] == 1 \
            and shp[3] == Tk:
        m = mask.reshape(shp[0], Tk)
        if shp[0] == 1:
            m = m.expand(N, Tk)
        return m
    return None


def _dropout_seed(generator, device):
    """One uint32 seed drawn on the generator's own device (the tensors'
    device when there is no generator), brought to the host once."""
    dev = generator.device if generator is not None else device
    return int(torch.randint(0, 2 ** 32, (1,), generator=generator,
                             device=dev, dtype=torch.int64).item())


def multi_head_attention(query, key, value, mask=None, num_heads=1,
                         dropout_p=0.0, causal=False, generator=None,
                         dropout_seed=None):
    """Fused MHA on (N, T, H*D) q/k/v. ``dropout_p`` applies attention
    dropout (the caller passes 0 outside training). On the flash route its
    seed is ``dropout_seed`` when given (the counterpart of JAX's
    ``dropout_key``), else drawn from ``generator``; the plain route draws
    its keep mask from ``generator`` on the tensors' device."""
    N, Tq, tot = query.shape
    H = num_heads
    D = tot // H
    q = query.reshape(N, Tq, H, D).permute(0, 2, 1, 3)
    k = key.reshape(N, key.shape[1], H, D).permute(0, 2, 1, 3)
    v = value.reshape(N, value.shape[1], H, D).permute(0, 2, 1, 3)
    Tk = k.shape[2]

    kpm = _as_key_padding_mask(mask, N, Tk)
    if kpm is not None and not kpm.is_floating_point():
        kpm = kpm.to(torch.bool)

    if query.is_cuda and (mask is None or kpm is not None):
        from .flash_attention import flash_attention
        seed = None
        if dropout_p > 0.0:
            seed = dropout_seed if dropout_seed is not None else \
                _dropout_seed(generator, query.device)
        out = flash_attention(q, k, v, key_mask=kpm, causal=causal,
                              dropout_p=dropout_p, dropout_seed=seed)
        route_counts['flash'] += 1
        return out.permute(0, 2, 1, 3).reshape(N, Tq, tot)

    route_counts['plain'] += 1
    scale = 1.0 / math.sqrt(D)
    scores = torch.einsum('nhqd,nhkd->nhqk', (q * scale).float(), k.float())
    if causal:
        cmask = torch.ones(Tq, Tk, dtype=torch.bool,
                           device=scores.device).tril()
        scores = torch.where(cmask, scores, -1e30)
    if mask is not None:
        if mask.is_floating_point():
            scores = scores + mask.to(scores.dtype)
        else:
            scores = torch.where(mask.to(torch.bool), scores, -1e30)
    att = torch.softmax(scores, dim=-1).to(q.dtype)
    if dropout_p > 0.0:
        keep = torch.rand(att.shape, generator=generator,
                          device=att.device) >= dropout_p
        att = torch.where(keep, att / (1.0 - dropout_p),
                          torch.zeros_like(att)).to(q.dtype)
    out = torch.einsum('nhqk,nhkd->nhqd', att, v)
    return out.permute(0, 2, 1, 3).reshape(N, Tq, tot)
