"""Contrib layers (counterpart of ``mxnet_tpu/gluon/contrib/nn.py``, ref:
python/mxnet/gluon/contrib/nn/basic_layers.py): ``HybridConcurrent``,
``Concurrent``, ``Identity``, ``SparseEmbedding`` (an Embedding whose
gradient is ``row_sparse``) and ``PixelShuffle2D``."""
from __future__ import annotations

from ... import ndarray as nd
from ..block import Block, HybridBlock

__all__ = ['HybridConcurrent', 'Concurrent', 'Identity', 'SparseEmbedding',
           'PixelShuffle2D']


class HybridConcurrent(HybridBlock):
    """Apply the children to the same input and concatenate their outputs
    along ``axis``."""

    def __init__(self, axis=-1, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self.axis = axis

    def add(self, *blocks):
        for block in blocks:
            self.register_child(block)

    def forward(self, x):
        out = [block(x) for block in self._children.values()]
        return nd.concat(*out, dim=self.axis)


class Concurrent(HybridConcurrent):
    pass


class Identity(HybridBlock):
    def hybrid_forward(self, F, x):
        return F.identity(x)


class SparseEmbedding(Block):
    """An Embedding whose weight gradient is ``row_sparse`` (ref: contrib
    SparseEmbedding): the Trainer's lazy updates touch only the rows a
    batch looked up. An eager Block, as in the JAX package."""

    def __init__(self, input_dim, output_dim, dtype='float32',
                 weight_initializer=None, **kwargs):
        super().__init__(**kwargs)
        self._input_dim = input_dim
        self._output_dim = output_dim
        self.weight = self.params.get(
            'weight', shape=(input_dim, output_dim), dtype=dtype,
            init=weight_initializer, grad_stype='row_sparse')

    def forward(self, x):
        return nd.embedding(x, self.weight.data(), input_dim=self._input_dim,
                            output_dim=self._output_dim, sparse_grad=True)


class PixelShuffle2D(HybridBlock):
    """Channels to space by ``factor`` (``depth_to_space``, as the JAX
    package computes it)."""

    def __init__(self, factor):
        super().__init__()
        self._factor = int(factor)

    def hybrid_forward(self, F, x):
        return F.depth_to_space(x, block_size=self._factor)
