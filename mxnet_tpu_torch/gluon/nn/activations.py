"""Activation layers (counterpart of ``mxnet_tpu/gluon/nn/activations.py``,
ref: python/mxnet/gluon/nn/activations.py)."""
from __future__ import annotations

import torch

from ..block import HybridBlock
from ... import initializer

__all__ = ['Activation', 'LeakyReLU', 'PReLU', 'ELU', 'SELU', 'GELU',
           'Swish']


class Activation(HybridBlock):
    """relu, sigmoid, tanh, softrelu, softsign, gelu, gelu_tanh, silu."""

    def __init__(self, activation, **kwargs):
        self._act_type = activation
        super().__init__(**kwargs)

    def _alias(self):
        return self._act_type

    def hybrid_forward(self, F, x):
        return F.activation(x, act_type=self._act_type)

    def __repr__(self):
        return f"Activation({self._act_type})"


class LeakyReLU(HybridBlock):
    def __init__(self, alpha, **kwargs):
        super().__init__(**kwargs)
        self._alpha = alpha

    def hybrid_forward(self, F, x):
        return F.leaky_relu(x, act_type='leaky', slope=self._alpha)

    def __repr__(self):
        return f"LeakyReLU({self._alpha})"


class PReLU(HybridBlock):
    """LeakyReLU with a learned slope ``alpha`` (one value, 0.25)."""

    def __init__(self, alpha_initializer=None, device=None, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.alpha = self.params.get(
                'alpha', shape=(1,), device=device,
                init=alpha_initializer or initializer.Constant(0.25))

    def hybrid_forward(self, F, x, alpha):
        return F.leaky_relu(x, gamma=alpha, act_type='prelu')


class ELU(HybridBlock):
    def __init__(self, alpha=1.0, **kwargs):
        super().__init__(**kwargs)
        self._alpha = alpha

    def hybrid_forward(self, F, x):
        return F.leaky_relu(x, act_type='elu', slope=self._alpha)


class SELU(HybridBlock):
    def hybrid_forward(self, F, x):
        return F.leaky_relu(x, act_type='selu')


class GELU(HybridBlock):
    def hybrid_forward(self, F, x):
        return F.leaky_relu(x, act_type='gelu')


class Swish(HybridBlock):
    """x * sigmoid(beta * x)."""

    def __init__(self, beta=1.0, **kwargs):
        super().__init__(**kwargs)
        self._beta = beta

    def hybrid_forward(self, F, x):
        return x * torch.sigmoid(self._beta * x)
