"""BERT (counterpart of ``mxnet_tpu/models/bert.py``: the config,
``BertSelfAttention``, ``BertLayer``, ``BertModel``, ``BertForPretraining``
and its loss).

The four models are Gluon ``HybridBlock``s built as the JAX package
builds them: the same children in the same name scopes, so the prefixed
names (``collect_params()``) and the structured ones
(``_collect_params_with_prefix()``, which ``named_parameters()`` yields
too) are the JAX model's; ``encoder`` is a ``HybridSequential`` with
prefix ``encoder_``. ``hybridize()`` makes a call with CUDA tensors
outside autograd one CUDA graph per input signature (``gluon/block.py``),
which is how ``serving.BlockRunner`` serves ``BertModel``; inside another
capture (``ShardedTrainStep``'s) a block runs plain.

Each encoder layer runs qkv Dense, ``multi_head_attention`` (the flash
kernel on CUDA), proj, ``add_layer_norm`` (the fused LayerNorm kernel
when ``MXTPU_PALLAS_LN=1``), ``dense_gelu`` (the fused FFN1 kernel when
``MXTPU_PALLAS_FFN=1``), ffn2 and ``add_layer_norm`` again: the same seams
as the JAX model. Activations run in the parameters' dtype; LayerNorm
statistics in f32. Dropout and attention dropout are active in training
mode (``module.train()``), their noise drawn from ``generator`` on the
model's device.

Besides the JAX constructors' arguments each model takes the port's
``device`` (built there at once, on the card unless ``device='cpu'``;
weights zero until an initializer or a weight file fills them),
``dtype``, ``generator`` (hidden dropout) and ``attn_generator`` (the
attention-dropout seeds; ``generator`` when not given).

Under data parallelism the two streams must differ. The attention seed
is drawn alike on every rank, since the kernels' mask is a hash of the
global coordinates (``ops/attention.py``): ``BertSelfAttention`` marks
its generator ``generator_replicated``, and ``ShardedTrainStep``
broadcasts such generators' state from rank 0 at build. Hidden dropout
draws one mask per local element, so its stream is per rank, as a
global-batch draw gives each example its own mask. ``dp_generators``
makes the pair.
"""
from __future__ import annotations

import torch

from ..context import resolve_device
from ..gluon import nn
from ..gluon.block import HybridBlock
from .. import ndarray as nd
from ..ops import attention as attn_ops
from ..ops import nn as F

__all__ = ['bert_base_config', 'BertSelfAttention', 'BertLayer',
           'BertModel', 'BertForPretraining', 'masked_cross_entropy',
           'bert_pretrain_loss', 'dp_generators']


def bert_base_config():
    return dict(vocab_size=30522, hidden=768, layers=12, heads=12,
                intermediate=3072, max_len=512, type_vocab=2)


def dp_generators(seed, device=None):
    """(hidden, attention) generators on ``device`` for a rank of a
    data-parallel world: the attention stream seeded ``seed`` on every
    rank, the hidden stream ``seed + 1 + rank``, one per rank."""
    from ..parallel import dist
    dev = resolve_device(device)
    hidden = torch.Generator(dev).manual_seed(seed + 1 + dist.rank())
    return hidden, torch.Generator(dev).manual_seed(seed)


class BertSelfAttention(HybridBlock):
    # every rank draws the attention seed from one stream (see the module
    # docstring): the compiled step broadcasts this generator at dp > 1
    generator_replicated = True

    def __init__(self, hidden, heads, dropout=0.1, device=None,
                 dtype=torch.float32, generator=None, attn_generator=None,
                 **kwargs):
        super().__init__(**kwargs)
        self._heads = heads
        self._hidden = hidden
        self._attn_dropout = dropout
        # the attention seeds' stream; the hidden dropout's is the
        # Dropout child's
        self.generator = generator if attn_generator is None \
            else attn_generator
        with self.name_scope():
            self.qkv = nn.Dense(3 * hidden, flatten=False, in_units=hidden,
                                prefix='qkv_', device=device, dtype=dtype)
            self.proj = nn.Dense(hidden, flatten=False, in_units=hidden,
                                 prefix='proj_', device=device, dtype=dtype)
            self.dropout = nn.Dropout(dropout, generator=generator)

    def forward(self, x, mask=None):
        q, k, v = self.qkv(x).chunk(3, dim=-1)
        out = attn_ops.multi_head_attention(
            q, k, v, mask, num_heads=self._heads,
            dropout_p=self._attn_dropout if self.training else 0.0,
            generator=self.generator)
        return self.dropout(self.proj(out))


class BertLayer(HybridBlock):
    def __init__(self, hidden, heads, intermediate, dropout=0.1, device=None,
                 dtype=torch.float32, generator=None, attn_generator=None,
                 **kwargs):
        super().__init__(**kwargs)
        kw = dict(device=device, dtype=dtype)
        with self.name_scope():
            self.attention = BertSelfAttention(
                hidden, heads, dropout, generator=generator,
                attn_generator=attn_generator, **kw)
            self.ln1 = nn.LayerNorm(in_channels=hidden, **kw)
            self.ffn1 = nn.Dense(intermediate, flatten=False,
                                 in_units=hidden, prefix='ffn1_', **kw)
            self.ffn2 = nn.Dense(hidden, flatten=False,
                                 in_units=intermediate, prefix='ffn2_', **kw)
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


class BertModel(HybridBlock):
    """Returns (sequence output (N, T, hidden), pooled (N, hidden))."""

    def __init__(self, vocab_size=30522, hidden=768, layers=12, heads=12,
                 intermediate=3072, max_len=512, type_vocab=2, dropout=0.1,
                 device=None, dtype=torch.float32, generator=None,
                 attn_generator=None, **kwargs):
        super().__init__(**kwargs)
        kw = dict(device=resolve_device(device), dtype=dtype)
        self._hidden = hidden
        with self.name_scope():
            self.word_embed = nn.Embedding(vocab_size, hidden,
                                           prefix='word_embed_', **kw)
            self.pos_embed = nn.Embedding(max_len, hidden,
                                          prefix='pos_embed_', **kw)
            self.type_embed = nn.Embedding(type_vocab, hidden,
                                           prefix='type_embed_', **kw)
            self.embed_ln = nn.LayerNorm(in_channels=hidden, **kw)
            self.embed_dropout = nn.Dropout(dropout, generator=generator)
            self.encoder = nn.HybridSequential(prefix='encoder_')
            with self.encoder.name_scope():
                for _ in range(layers):
                    self.encoder.add(BertLayer(
                        hidden, heads, intermediate, dropout,
                        generator=generator, attn_generator=attn_generator,
                        **kw))
            self.pooler = nn.Dense(hidden, flatten=False, in_units=hidden,
                                   activation='tanh', prefix='pooler_', **kw)

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


def _gather_positions(seq, positions):
    """(N, T, C) gathered at (N, M) int positions -> (N, M, C)."""
    idx = positions.to(torch.int64)[:, :, None].expand(-1, -1, seq.shape[2])
    return torch.gather(seq, 1, idx)


class BertForPretraining(HybridBlock):
    """MLM + NSP heads on BertModel (the pretraining objective). Parameter
    names (``bert.*``, ``mlm_dense.*``, ``mlm_ln.gamma/beta``,
    ``mlm_decoder.*``, ``nsp.*``) are the JAX model's structured names.
    ``config`` is a ``bert_base_config()``-style dict (it may carry
    ``dropout``)."""

    def __init__(self, config=None, device=None, dtype=torch.float32,
                 generator=None, attn_generator=None, **kwargs):
        super().__init__(**kwargs)
        cfg = dict(config or bert_base_config())
        self._cfg = cfg
        kw = dict(device=resolve_device(device), dtype=dtype)
        hidden = cfg['hidden']
        with self.name_scope():
            self.bert = BertModel(**cfg, generator=generator,
                                  attn_generator=attn_generator, **kw)
            self.mlm_dense = nn.Dense(hidden, flatten=False, in_units=hidden,
                                      activation='gelu',
                                      prefix='mlm_dense_', **kw)
            self.mlm_ln = nn.LayerNorm(in_channels=hidden, **kw)
            self.mlm_decoder = nn.Dense(cfg['vocab_size'], flatten=False,
                                        in_units=hidden,
                                        prefix='mlm_decoder_', **kw)
            self.nsp = nn.Dense(2, in_units=hidden, prefix='nsp_', **kw)

    def forward(self, tokens, token_types=None, valid_length=None,
                masked_positions=None):
        """masked_positions: optional (N, M) ints; the decoder then runs
        only on those M positions, and mlm is (N, M, vocab)."""
        seq, pooled = self.bert(tokens, token_types, valid_length)
        if masked_positions is not None:
            seq = _gather_positions(seq, masked_positions)
        mlm = self.mlm_decoder(self.mlm_ln(self.mlm_dense(seq)))
        return mlm, self.nsp(pooled)


def masked_cross_entropy(logits, labels):
    """Mean cross entropy over the positions where labels >= 0 (-1 marks
    padding / unmasked). Through the ``nd`` ops the JAX function calls,
    so ``amp.init`` reaches them as it does there (``log_softmax``,
    ``sum`` in f32)."""
    logp = nd.log_softmax(logits, axis=-1)
    valid = (labels >= 0).to(logp.dtype)
    safe = nd.where(valid, labels, nd.zeros_like(labels))
    token_loss = -nd.pick(logp, safe, axis=-1) * valid
    return nd.sum(token_loss) / (nd.sum(valid) + 1e-6)


def bert_pretrain_loss(mlm_logits, nsp_logits, labels, nsp_labels):
    """Masked-LM + NSP cross entropy, each a mean. labels: (N, M) with -1
    where there is nothing to predict."""
    mlm_loss = masked_cross_entropy(mlm_logits, labels)
    nsp_logp = nd.log_softmax(nsp_logits, axis=-1)
    return mlm_loss + nd.mean(-nd.pick(nsp_logp, nsp_labels, axis=-1))
