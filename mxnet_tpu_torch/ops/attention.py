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

Attention dropout draws one seed from ``generator`` on either route and
keeps an element by the counter hash of the flash kernels
(``flash_attention.counter_keep``) at its (batch*head, row, col), so the
plain route on the CPU draws the masks the kernels draw on the card. In
a world of more than one rank the batch*head index is the global one
(``bh_base = rank * N * H``, N the rank's batch), as the JAX package's
program over the global batch hashes it.

The registered ops (``multi_head_attention`` with the JAX signature, the
four ``interleaved_matmul_*`` ops and ``div_sqrt_dim``) are at the end;
``mx.sym`` graphs reach the flash kernels through the first.
"""
from __future__ import annotations

import math

import torch

__all__ = ['multi_head_attention', 'multi_head_attention_op', 'route_counts',
           'interleaved_matmul_selfatt_qk',
           'interleaved_matmul_selfatt_valatt', 'interleaved_matmul_encdec_qk',
           'interleaved_matmul_encdec_valatt', 'div_sqrt_dim']

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
    """One uint32 seed in a one-element int64 tensor, drawn on the
    generator's own device (the tensors' device when there is no
    generator) and left there, as the JAX package draws its seed with
    ``jax.random.bits``: no host sync, so a CUDA graph that draws it
    replays with a fresh seed when the generator is registered with the
    graph (or is the device's default generator)."""
    dev = generator.device if generator is not None else device
    return torch.randint(0, 2 ** 32, (1,), generator=generator, device=dev,
                         dtype=torch.int64)


def _world_bh_base(N, H):
    """This rank's first global batch*head: rank * N * H (0 outside a
    world; every rank holds N rows)."""
    from ..parallel import dist
    return dist.rank() * N * H


def multi_head_attention(query, key, value, mask=None, num_heads=1,
                         dropout_p=0.0, causal=False, generator=None,
                         dropout_seed=None):
    """Fused MHA on (N, T, H*D) q/k/v. ``dropout_p`` applies attention
    dropout (the caller passes 0 outside training). Its seed is
    ``dropout_seed`` when given (the counterpart of JAX's
    ``dropout_key``), else drawn from ``generator``; the keep mask is the
    counter hash over (batch*head, row, col), the batch*head index the
    global one in a world of ranks."""
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

    seed, bh_base = None, 0
    if dropout_p > 0.0:
        seed = dropout_seed if dropout_seed is not None else \
            _dropout_seed(generator, query.device)
        bh_base = _world_bh_base(N, H)
    if query.is_cuda and (mask is None or kpm is not None):
        from .flash_attention import flash_attention
        out = flash_attention(q, k, v, key_mask=kpm, causal=causal,
                              dropout_p=dropout_p, dropout_seed=seed,
                              bh_base=bh_base)
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
        from .flash_attention import _keep_multipliers, seed_tensor
        keep = _keep_multipliers(seed_tensor(seed, att.device), N, H, Tq, Tk,
                                 dropout_p, att.device, bh_base)
        att = (att.float() * keep).to(q.dtype)
    out = torch.einsum('nhqk,nhkd->nhqd', att, v)
    return out.permute(0, 2, 1, 3).reshape(N, Tq, tot)


# ---------------------------------------------------------------------------
# The registered ops (``mx.nd.<name>``, ``mx.sym.<name>``): the JAX
# package's names and signatures (``mxnet_tpu/ops/attention.py:41-83,
# 143``), so that a symbol graph written for either package runs in both.
# ---------------------------------------------------------------------------

def _split_heads_interleaved(queries_keys_values, num_heads, parts):
    """(T, N, parts*H*D) interleaved per head -> list of (N*H, T, D)."""
    T, N, tot = queries_keys_values.shape
    D = tot // (num_heads * parts)
    x = queries_keys_values.reshape(T, N, num_heads, parts, D)
    return [x[:, :, :, p, :].permute(1, 2, 0, 3).reshape(N * num_heads, T, D)
            for p in range(parts)]


def _merge_heads(out, heads):
    NH, T, D = out.shape
    N = NH // heads
    return out.reshape(N, heads, T, D).permute(2, 0, 1, 3).reshape(
        T, N, heads * D)


def interleaved_matmul_selfatt_qk(queries_keys_values, heads=1):
    """Scaled Q K^T from packed qkv (ref: transformer.cc:650)."""
    q, k, _ = _split_heads_interleaved(queries_keys_values, heads, 3)
    return torch.matmul(q * (1.0 / math.sqrt(q.shape[-1])),
                        k.transpose(-1, -2))


def interleaved_matmul_selfatt_valatt(queries_keys_values, attention,
                                      heads=1):
    """att V, re-packed to (T, N, H*D) (ref: transformer.cc:708)."""
    _, _, v = _split_heads_interleaved(queries_keys_values, heads, 3)
    return _merge_heads(torch.matmul(attention, v), heads)


def interleaved_matmul_encdec_qk(queries, keys_values, heads=1):
    """queries (Tq, N, H*D), keys_values (Tk, N, 2*H*D) (ref:
    transformer.cc:766)."""
    Tq, N, tot = queries.shape
    D = tot // heads
    q = queries.reshape(Tq, N, heads, D).permute(1, 2, 0, 3).reshape(
        N * heads, Tq, D)
    k, _ = _split_heads_interleaved(keys_values, heads, 2)
    return torch.matmul(q * (1.0 / math.sqrt(D)), k.transpose(-1, -2))


def interleaved_matmul_encdec_valatt(keys_values, attention, heads=1):
    _, v = _split_heads_interleaved(keys_values, heads, 2)
    return _merge_heads(torch.matmul(attention, v), heads)


def div_sqrt_dim(data):
    """data / sqrt(data.shape[-1]) (ref: transformer.cc
    _contrib_div_sqrt_dim)."""
    return data / math.sqrt(data.shape[-1])


def multi_head_attention_op(query, key, value, mask=None, num_heads=1,
                            dropout_p=0.0, causal=False, use_pallas='auto',
                            dropout_key=None):
    """``multi_head_attention`` as the JAX package registers it: dropout
    only in autograd train mode or with ``dropout_key`` (the seed here).
    ``use_pallas`` is accepted and changes nothing: CUDA tensors take the
    flash kernels whenever the mask allows, as 'auto' does on a TPU."""
    from ..base import state
    p = dropout_p if (dropout_key is not None or state.is_training) else 0.0
    return multi_head_attention(query, key, value, mask, num_heads, p,
                                causal, dropout_seed=dropout_key)


def _register():
    from ..base import register_op
    for fn in (interleaved_matmul_selfatt_qk,
               interleaved_matmul_selfatt_valatt,
               interleaved_matmul_encdec_qk, interleaved_matmul_encdec_valatt,
               div_sqrt_dim):
        register_op(fn.__name__)(fn)
    register_op('multi_head_attention')(multi_head_attention_op)


_register()
