"""Wide & Deep (Cheng et al. 2016), the CTR model of the JAX package's
``examples/train_wide_deep.py``, on the port's layers: the recsys shape
the RowSparse path exists for. The embedding tables hold almost all the
parameters and each step touches only the rows its batch hits; with
``sparse_grad=True`` ``parallel.ShardedTrainStep`` dedups the batch's
ids and updates only the live rows (lazy Adam) inside its one CUDA
graph, and ``sparse_report()`` gives the update bytes against dense.

    net = WideDeep(vocab=100000, dim=16, hidden=64)
    net.initialize(mx.init.Normal(0.01))
    bce = gluon.loss.SigmoidBinaryCrossEntropyLoss()
    step = parallel.ShardedTrainStep(net, lambda o, y: bce(o, y), 'adam',
                                     {'learning_rate': 0.01})
    ids, y = synthetic_ctr(B * steps, fields=20, vocab=100000,
                           hot_fraction=0.05)
    loss = step(ids[:B], y[:B])

``criteo_config()`` is the same model at the sizes of DLRM's Criteo
Terabyte script: 26 categorical fields sharing one table hashed to
10,000,000 rows, dim 16, batch 2048.
"""
from __future__ import annotations

import numpy as onp

from ..gluon import nn

__all__ = ['WideDeep', 'synthetic_ctr', 'example_config', 'criteo_config']


class WideDeep(nn.HybridBlock):
    """A wide (linear in the ids) head plus a deep MLP over the shared
    categorical fields, summed into one CTR logit. Both tables are
    ``sparse_grad``; the wide one is vocab x 1."""

    def __init__(self, vocab, dim=16, hidden=64, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.wide = nn.Embedding(vocab, 1, sparse_grad=True)
            self.deep = nn.Embedding(vocab, dim, sparse_grad=True)
            self.mlp = nn.HybridSequential()
            with self.mlp.name_scope():
                self.mlp.add(nn.Dense(hidden, activation='relu'))
                self.mlp.add(nn.Dense(hidden // 2, activation='relu'))
                self.mlp.add(nn.Dense(1))

    def hybrid_forward(self, F, x):
        wide = self.wide(x).sum(axis=(1, 2))         # (B,)
        deep = self.mlp(self.deep(x))                # (B, 1), flattened in
        return wide + deep.reshape((-1,))            # the CTR logit


def synthetic_ctr(n_rows, fields, vocab, hot_fraction, seed=0):
    """Synthetic impressions, as the example makes them: ids concentrated
    in the hot prefix of the vocabulary, labels from a hidden linear
    model. Returns float32 (ids, labels) numpy arrays."""
    rng = onp.random.RandomState(seed)
    hot = max(fields, int(vocab * hot_fraction))
    ids = rng.randint(0, hot, size=(n_rows, fields))
    w = rng.randn(vocab) * 0.3
    logits = w[ids].sum(axis=1)
    y = (rng.rand(n_rows) < 1.0 / (1.0 + onp.exp(-logits)))
    return ids.astype('float32'), y.astype('float32')


def example_config():
    """``examples/train_wide_deep.py``'s defaults."""
    return dict(vocab=100000, fields=20, dim=16, hidden=64, batch=128,
                hot_fraction=0.05)


def criteo_config():
    """Criteo's 26 categorical fields in one table hashed to 10,000,000
    rows, dim 16, batch 2048 (about DLRM's Criteo Terabyte sizes)."""
    return dict(vocab=10_000_000, fields=26, dim=16, hidden=64, batch=2048,
                hot_fraction=0.05)
