"""GPT-style decoder-only causal language model (counterpart of
``mxnet_tpu/models/gpt.py``: ``gpt2_small_config``, ``GPTBlock``,
``GPTModel``, ``gpt_lm_loss``).

Pre-norm decoder blocks over ``multi_head_attention`` with
``causal=True``, which on CUDA routes to the flash kernels' causal path
(no (T, T) mask is made), and a head tied to the token embedding. The
blocks are built in the JAX model's name scopes (``word_embed_``,
``pos_embed_``, ``blocks_``, ``qkv_``, ``proj_``, ``ffn1_``, ``ffn2_``),
so the structured names are the JAX model's and ``weights.py``
``params_from_mxnet_tpu`` carries its weights by name.

The tied head reads the embedding's own tensor, so the embedding's
gradient is the sum of the lookup's and the head's in any backward that
runs through this forward (the Trainer, ``ShardedTrainStep`` captured or
eager, ZeRO-1 included).

Attention dropout. The JAX op gates it on autograd's training flag
inside the op; the port's ``multi_head_attention`` leaves the gate to
its caller, so ``GPTBlock`` passes 0 unless the block is in training mode
(``module.training``: set from ``autograd.is_training()`` by a call with
NDArrays, and by ``ShardedTrainStep`` for its forward). Inference never
draws attention noise.

Besides the JAX constructors' arguments the models take the port's
``device`` (built there at once; when not given, on the current
context's device: the card, unless ``with mx.cpu():`` says otherwise;
weights zero until an initializer or a weight file fills them),
``dtype``, ``generator`` (hidden dropout) and ``attn_generator`` (the
attention-dropout seeds; ``generator`` when not given), as the BERT
models do.
"""
from __future__ import annotations

import torch

from ..context import resolve_device
from ..gluon import nn
from ..gluon.block import HybridBlock
from .. import ndarray as nd
from ..ops import attention as attn_ops
from .bert import masked_cross_entropy

__all__ = ['gpt2_small_config', 'GPTBlock', 'GPTModel', 'gpt_lm_loss']


def gpt2_small_config():
    return dict(vocab_size=50257, hidden=768, layers=12, heads=12,
                max_len=1024)


class GPTBlock(HybridBlock):
    # every rank draws the attention seed from one stream, as
    # BertSelfAttention does: the compiled step broadcasts it at dp > 1
    generator_replicated = True

    def __init__(self, hidden, heads, dropout=0.1, device=None,
                 dtype=torch.float32, generator=None, attn_generator=None,
                 **kwargs):
        super().__init__(**kwargs)
        self._heads = heads
        self._attn_dropout = dropout
        self.generator = generator if attn_generator is None \
            else attn_generator
        kw = dict(device=device, dtype=dtype)
        with self.name_scope():
            self.ln1 = nn.LayerNorm(in_channels=hidden, **kw)
            self.qkv = nn.Dense(3 * hidden, flatten=False, in_units=hidden,
                                prefix='qkv_', **kw)
            self.proj = nn.Dense(hidden, flatten=False, in_units=hidden,
                                 prefix='proj_', **kw)
            self.ln2 = nn.LayerNorm(in_channels=hidden, **kw)
            self.ffn1 = nn.Dense(4 * hidden, flatten=False, in_units=hidden,
                                 prefix='ffn1_', **kw)
            self.ffn2 = nn.Dense(hidden, flatten=False,
                                 in_units=4 * hidden, prefix='ffn2_', **kw)
            self.dropout = nn.Dropout(dropout, generator=generator)

    def forward(self, x):
        # pre-norm residual blocks (GPT-2 recipe)
        q, k, v = self.qkv(self.ln1(x)).chunk(3, dim=-1)
        attn = attn_ops.multi_head_attention(
            q, k, v, None, num_heads=self._heads,
            dropout_p=self._attn_dropout if self.training else 0.0,
            causal=True, generator=self.generator)
        x = x + self.dropout(self.proj(attn))
        h = nd.activation(self.ffn1(self.ln2(x)), act_type='gelu')
        return x + self.dropout(self.ffn2(h))


class GPTModel(HybridBlock):
    """Decoder-only LM. forward(tokens) -> (N, T, vocab) logits with the
    output projection tied to the token embedding."""

    def __init__(self, vocab_size=50257, hidden=768, layers=12, heads=12,
                 max_len=1024, dropout=0.1, device=None, dtype=torch.float32,
                 generator=None, attn_generator=None, **kwargs):
        super().__init__(**kwargs)
        self._cfg = dict(vocab_size=vocab_size, hidden=hidden,
                         layers=layers, heads=heads, max_len=max_len)
        kw = dict(device=resolve_device(device), dtype=dtype)
        with self.name_scope():
            self.word_embed = nn.Embedding(vocab_size, hidden,
                                           prefix='word_embed_', **kw)
            self.pos_embed = nn.Embedding(max_len, hidden,
                                          prefix='pos_embed_', **kw)
            self.embed_dropout = nn.Dropout(dropout, generator=generator)
            self.blocks = nn.HybridSequential(prefix='blocks_')
            with self.blocks.name_scope():
                for _ in range(layers):
                    self.blocks.add(GPTBlock(
                        hidden, heads, dropout, generator=generator,
                        attn_generator=attn_generator, **kw))
            self.ln_f = nn.LayerNorm(in_channels=hidden, **kw)

    def forward(self, tokens):
        T = tokens.shape[1]
        pos = torch.arange(T, device=tokens.device).reshape(1, T)
        x = self.embed_dropout(self.word_embed(tokens) + self.pos_embed(pos))
        for blk in self.blocks:
            x = blk(x)
        x = self.ln_f(x)
        # the weight-tied LM head: logits = x @ E^T, on the embedding's own
        # tensor, so both uses add into its one gradient
        return nd.dot(x, self.word_embed.weight.tensor, transpose_b=True)


def gpt_lm_loss(logits, labels):
    """Next-token cross entropy; labels = tokens shifted left, -1 pads."""
    return masked_cross_entropy(logits, labels)
