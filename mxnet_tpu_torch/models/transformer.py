"""Transformer encoder-decoder (counterpart of
``mxnet_tpu/models/transformer.py``: ``PositionalEncoding``,
``MultiHeadAttention``, ``EncoderLayer``, ``DecoderLayer``,
``TransformerEncoder``, ``TransformerModel``).

The blocks are the JAX model's, in its name scopes, so the structured
names (``encoder.layers.0.attn.q_proj.weight``, ``dec_layers.0.cross_attn
...``, ``encoder.pos.pe``) are its names. ``PositionalEncoding``'s table
is a Constant (``params.get_constant``): it crosses by name like a
weight, and it takes no gradient.

Attention runs through ``multi_head_attention``: on CUDA the flash
kernels, with the encoder's and the cross-attention's key-padding mask
((N, 1, 1, Tk); boolean keeps, floating adds) and the decoder's causal
self-attention. The cross-attention has Tq != Tk. As in
the JAX model, ``MultiHeadAttention`` applies no attention dropout; the
``dropout`` rate goes to the hidden Dropout layers.

Besides the JAX constructors' arguments each block takes the port's
``device`` (when not given, the current context's: the card, unless
``with mx.cpu():`` says otherwise; weights zero until an initializer or
a weight file fills them, the positional table filled at once),
``dtype`` and ``generator`` (the hidden dropout's stream).
"""
from __future__ import annotations

import math

import numpy as onp
import torch

from ..context import resolve_device
from ..gluon import nn
from ..gluon.block import HybridBlock
from .. import ndarray as nd
from ..ops import attention as attn_ops

__all__ = ['PositionalEncoding', 'MultiHeadAttention', 'EncoderLayer',
           'DecoderLayer', 'TransformerEncoder', 'TransformerModel']


class PositionalEncoding(HybridBlock):
    def __init__(self, hidden, max_len=1024, dropout=0.1, device=None,
                 generator=None, **kwargs):
        super().__init__(**kwargs)
        pe = onp.zeros((max_len, hidden), onp.float32)
        position = onp.arange(max_len)[:, None].astype(onp.float32)
        div = onp.exp(onp.arange(0, hidden, 2) *
                      (-math.log(10000.0) / hidden))
        pe[:, 0::2] = onp.sin(position * div)
        pe[:, 1::2] = onp.cos(position * div)
        self.pe = self.params.get_constant('pe', pe, device=device)
        self.dropout = nn.Dropout(dropout, generator=generator)

    def forward(self, x):
        pe = self.pe.tensor[:x.shape[1]].unsqueeze(0)
        return self.dropout(x + pe.to(x.dtype))


class MultiHeadAttention(HybridBlock):
    """``causal`` is a construction-time flag: a Block call forwards only
    positional tensors, so the masking mode cannot ride the call."""

    def __init__(self, hidden, heads, dropout=0.1, causal=False, device=None,
                 dtype=torch.float32, **kwargs):
        super().__init__(**kwargs)
        self._heads = heads
        self._causal = causal
        kw = dict(device=device, dtype=dtype)
        with self.name_scope():
            self.q_proj = nn.Dense(hidden, flatten=False, in_units=hidden,
                                   **kw)
            self.k_proj = nn.Dense(hidden, flatten=False, in_units=hidden,
                                   **kw)
            self.v_proj = nn.Dense(hidden, flatten=False, in_units=hidden,
                                   **kw)
            self.out_proj = nn.Dense(hidden, flatten=False, in_units=hidden,
                                     **kw)

    def forward(self, q, k, v, mask=None):
        out = attn_ops.multi_head_attention(
            self.q_proj(q), self.k_proj(k), self.v_proj(v), mask,
            num_heads=self._heads, causal=self._causal)
        return self.out_proj(out)


class EncoderLayer(HybridBlock):
    def __init__(self, hidden, heads, ffn_hidden, dropout=0.1, device=None,
                 dtype=torch.float32, generator=None, **kwargs):
        super().__init__(**kwargs)
        kw = dict(device=device, dtype=dtype)
        with self.name_scope():
            self.attn = MultiHeadAttention(hidden, heads, dropout, **kw)
            self.ln1 = nn.LayerNorm(in_channels=hidden, **kw)
            self.ffn1 = nn.Dense(ffn_hidden, flatten=False, in_units=hidden,
                                 **kw)
            self.ffn2 = nn.Dense(hidden, flatten=False, in_units=ffn_hidden,
                                 **kw)
            self.ln2 = nn.LayerNorm(in_channels=hidden, **kw)
            self.drop = nn.Dropout(dropout, generator=generator)

    def forward(self, x, mask=None):
        x = self.ln1(x + self.drop(self.attn(x, x, x, mask)))
        h = self.ffn2(nd.activation(self.ffn1(x), act_type='relu'))
        return self.ln2(x + self.drop(h))


class DecoderLayer(HybridBlock):
    def __init__(self, hidden, heads, ffn_hidden, dropout=0.1, device=None,
                 dtype=torch.float32, generator=None, **kwargs):
        super().__init__(**kwargs)
        kw = dict(device=device, dtype=dtype)
        with self.name_scope():
            self.self_attn = MultiHeadAttention(hidden, heads, dropout,
                                                causal=True, **kw)
            self.ln1 = nn.LayerNorm(in_channels=hidden, **kw)
            self.cross_attn = MultiHeadAttention(hidden, heads, dropout, **kw)
            self.ln2 = nn.LayerNorm(in_channels=hidden, **kw)
            self.ffn1 = nn.Dense(ffn_hidden, flatten=False, in_units=hidden,
                                 **kw)
            self.ffn2 = nn.Dense(hidden, flatten=False, in_units=ffn_hidden,
                                 **kw)
            self.ln3 = nn.LayerNorm(in_channels=hidden, **kw)
            self.drop = nn.Dropout(dropout, generator=generator)

    def forward(self, x, memory, mem_mask=None):
        x = self.ln1(x + self.drop(self.self_attn(x, x, x)))
        x = self.ln2(x + self.drop(self.cross_attn(x, memory, memory,
                                                   mem_mask)))
        h = self.ffn2(nd.activation(self.ffn1(x), act_type='relu'))
        return self.ln3(x + self.drop(h))


class TransformerEncoder(HybridBlock):
    def __init__(self, vocab_size, hidden=512, layers=6, heads=8,
                 ffn_hidden=2048, max_len=1024, dropout=0.1, device=None,
                 dtype=torch.float32, generator=None, **kwargs):
        super().__init__(**kwargs)
        self._hidden = hidden
        dev = resolve_device(device)
        kw = dict(device=dev, dtype=dtype, generator=generator)
        with self.name_scope():
            self.embed = nn.Embedding(vocab_size, hidden, device=dev,
                                      dtype=dtype)
            self.pos = PositionalEncoding(hidden, max_len, dropout,
                                          device=dev, generator=generator)
            self.layers = nn.HybridSequential(prefix='layers_')
            with self.layers.name_scope():
                for _ in range(layers):
                    self.layers.add(EncoderLayer(hidden, heads, ffn_hidden,
                                                 dropout, **kw))

    def forward(self, tokens, mask=None):
        x = self.pos(self.embed(tokens) * math.sqrt(self._hidden))
        for layer in self.layers:
            x = layer(x, mask)
        return x


class TransformerModel(HybridBlock):
    """Full enc-dec (transformer-big when hidden=1024, heads=16)."""

    def __init__(self, src_vocab, tgt_vocab, hidden=512, enc_layers=6,
                 dec_layers=6, heads=8, ffn_hidden=2048, max_len=1024,
                 dropout=0.1, device=None, dtype=torch.float32,
                 generator=None, **kwargs):
        super().__init__(**kwargs)
        self._hidden = hidden
        dev = resolve_device(device)
        kw = dict(device=dev, dtype=dtype, generator=generator)
        with self.name_scope():
            self.encoder = TransformerEncoder(src_vocab, hidden, enc_layers,
                                              heads, ffn_hidden, max_len,
                                              dropout, **kw)
            self.tgt_embed = nn.Embedding(tgt_vocab, hidden, device=dev,
                                          dtype=dtype)
            self.tgt_pos = PositionalEncoding(hidden, max_len, dropout,
                                              device=dev, generator=generator)
            self.dec_layers = nn.HybridSequential(prefix='dec_')
            with self.dec_layers.name_scope():
                for _ in range(dec_layers):
                    self.dec_layers.add(DecoderLayer(hidden, heads,
                                                     ffn_hidden, dropout,
                                                     **kw))
            self.out_proj = nn.Dense(tgt_vocab, flatten=False,
                                     in_units=hidden, device=dev,
                                     dtype=dtype)

    def forward(self, src_tokens, tgt_tokens, src_mask=None):
        memory = self.encoder(src_tokens, src_mask)
        x = self.tgt_pos(self.tgt_embed(tgt_tokens) *
                         math.sqrt(self._hidden))
        for layer in self.dec_layers:
            x = layer(x, memory, src_mask)
        return self.out_proj(x)
