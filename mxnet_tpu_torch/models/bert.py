"""BERT encoder (counterpart of ``mxnet_tpu/models/bert.py``: the config,
``BertSelfAttention``, ``BertLayer`` and ``BertModel``).

Each encoder layer runs qkv Dense, ``multi_head_attention`` (the flash
kernel on CUDA), proj, ``add_layer_norm`` (the fused LayerNorm kernel
when ``MXTPU_PALLAS_LN=1``), ``dense_gelu`` (the fused FFN1 kernel when
``MXTPU_PALLAS_FFN=1``), ffn2 and ``add_layer_norm`` again: the same seams
as the JAX model. Activations run in the parameters' dtype; LayerNorm
statistics in f32.
"""
from __future__ import annotations

import torch
from torch import nn as tnn

from ..context import resolve_device
from ..gluon import nn
from ..ops import attention as attn_ops
from ..ops import nn as F

__all__ = ['bert_base_config', 'BertSelfAttention',
           'BertLayer', 'BertModel']


def bert_base_config():
    return dict(vocab_size=30522, hidden=768, layers=12, heads=12,
                intermediate=3072, max_len=512, type_vocab=2)


class BertSelfAttention(tnn.Module):
    def __init__(self, hidden, heads, dropout=0.1, device=None,
                 dtype=torch.float32, generator=None):
        super().__init__()
        self._heads = heads
        self._hidden = hidden
        self._attn_dropout = dropout
        self.generator = generator
        self.qkv = nn.Dense(3 * hidden, flatten=False, in_units=hidden,
                            device=device, dtype=dtype)
        self.proj = nn.Dense(hidden, flatten=False, in_units=hidden,
                             device=device, dtype=dtype)
        self.dropout = nn.Dropout(dropout, generator=generator)

    def forward(self, x, mask=None):
        q, k, v = self.qkv(x).chunk(3, dim=-1)
        out = attn_ops.multi_head_attention(
            q, k, v, mask, num_heads=self._heads,
            dropout_p=self._attn_dropout if self.training else 0.0,
            generator=self.generator)
        return self.dropout(self.proj(out))


class BertLayer(tnn.Module):
    def __init__(self, hidden, heads, intermediate, dropout=0.1, device=None,
                 dtype=torch.float32, generator=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.attention = BertSelfAttention(hidden, heads, dropout,
                                           generator=generator, **kw)
        self.ln1 = nn.LayerNorm(in_channels=hidden, **kw)
        self.ffn1 = nn.Dense(intermediate, flatten=False, in_units=hidden,
                             **kw)
        self.ffn2 = nn.Dense(hidden, flatten=False, in_units=intermediate,
                             **kw)
        self.ln2 = nn.LayerNorm(in_channels=hidden, **kw)
        self.dropout = nn.Dropout(dropout, generator=generator)

    @staticmethod
    def _add_ln(ln, x, sub):
        # residual + LN through one op, so the fused kernel can take it
        return F.add_layer_norm(x, sub, ln.gamma, ln.beta, eps=ln._epsilon)

    def forward(self, x, mask=None):
        x = self._add_ln(self.ln1, x, self.attention(x, mask))
        # FFN1 matmul + bias + GELU through one op, so the fused kernel
        # can take it
        h = F.dense_gelu(x, self.ffn1.weight, self.ffn1.bias)
        h = self.dropout(self.ffn2(h))
        return self._add_ln(self.ln2, x, h)


class BertModel(tnn.Module):
    """Returns (sequence output (N, T, hidden), pooled (N, hidden)).
    Built on the CUDA device unless ``device='cpu'`` is given."""

    def __init__(self, vocab_size=30522, hidden=768, layers=12, heads=12,
                 intermediate=3072, max_len=512, type_vocab=2, dropout=0.1,
                 device=None, dtype=torch.float32, generator=None):
        super().__init__()
        dev = resolve_device(device)
        kw = dict(device=dev, dtype=dtype)
        self._hidden = hidden
        self.word_embed = nn.Embedding(vocab_size, hidden, **kw)
        self.pos_embed = nn.Embedding(max_len, hidden, **kw)
        self.type_embed = nn.Embedding(type_vocab, hidden, **kw)
        self.embed_ln = nn.LayerNorm(in_channels=hidden, **kw)
        self.embed_dropout = nn.Dropout(dropout, generator=generator)
        self.encoder = tnn.ModuleList(
            BertLayer(hidden, heads, intermediate, dropout,
                      generator=generator, **kw) for _ in range(layers))
        self.pooler = nn.Dense(hidden, flatten=False, in_units=hidden,
                               activation='tanh', **kw)

    def forward(self, tokens, token_types=None, valid_length=None):
        T = tokens.shape[1]
        pos = torch.arange(T, device=tokens.device).reshape(1, T)
        emb = self.word_embed(tokens) + self.pos_embed(pos)
        if token_types is not None:
            emb = emb + self.type_embed(token_types)
        x = self.embed_dropout(self.embed_ln(emb))
        mask = None
        if valid_length is not None:
            # the JAX model's NDArray comparison yields 0/1 in float32, and
            # a floating mask is ADDITIVE: valid keys get +1, padded keys
            # +0, so padding is down-weighted, not removed. Kept as is to
            # match the reference.
            ar = torch.arange(T, dtype=torch.float32, device=tokens.device)
            mask = (ar.reshape(1, 1, 1, T) <
                    valid_length.to(torch.float32).reshape(-1, 1, 1, 1)
                    ).to(torch.float32)
        for layer in self.encoder:
            x = layer(x, mask)
        pooled = self.pooler(x[:, 0, :])
        return x, pooled
