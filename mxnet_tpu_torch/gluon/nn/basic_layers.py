"""Dense, LayerNorm, Embedding and Dropout as ``nn.Module``s (counterpart
of ``mxnet_tpu/gluon/nn/basic_layers.py``).

Parameter names follow the JAX package (``weight``/``bias`` for Dense and
Embedding, ``gamma``/``beta`` for LayerNorm), so ``named_parameters()``
yields the structured names of ``_collect_params_with_prefix`` and a
``.params`` file written by ``mxnet_tpu`` loads 1:1. Shapes are given at
construction (``in_units``, ``in_channels``): there is no deferred
initialisation. Weights start at zero until an initializer or a weight
file fills them; biases and beta start at zero and gamma at one.
"""
from __future__ import annotations

import torch
from torch import nn

from ...base import MXNetError
from ...context import resolve_device
from ...ops import nn as F

__all__ = ['Dense', 'LayerNorm', 'Embedding', 'Dropout']


def _param(shape, fill, device, dtype):
    return nn.Parameter(torch.full(shape, fill, device=device, dtype=dtype))


class Dense(nn.Module):
    """Fully-connected layer: y = act(x W^T + b), W (units, in_units)."""

    def __init__(self, units, activation=None, use_bias=True, flatten=True,
                 in_units=0, device=None, dtype=torch.float32):
        super().__init__()
        if in_units <= 0:
            raise MXNetError("Dense needs in_units: the port has no "
                             "deferred initialisation")
        dev = resolve_device(device)
        self._units = units
        self._flatten = flatten
        self._act_type = activation
        self.weight = _param((units, in_units), 0.0, dev, dtype)
        self.bias = _param((units,), 0.0, dev, dtype) if use_bias else None

    def forward(self, x):
        out = F.fully_connected(x, self.weight, self.bias,
                                num_hidden=self._units,
                                no_bias=self.bias is None,
                                flatten=self._flatten)
        if self._act_type is not None:
            out = F.activation(out, act_type=self._act_type)
        return out


class LayerNorm(nn.Module):
    def __init__(self, axis=-1, epsilon=1e-5, in_channels=0, device=None,
                 dtype=torch.float32):
        super().__init__()
        if in_channels <= 0:
            raise MXNetError("LayerNorm needs in_channels")
        dev = resolve_device(device)
        self._axis = axis
        self._epsilon = epsilon
        self.gamma = _param((in_channels,), 1.0, dev, dtype)
        self.beta = _param((in_channels,), 0.0, dev, dtype)

    def forward(self, x):
        return F.layer_norm(x, self.gamma, self.beta, axis=self._axis,
                            eps=self._epsilon)


class Embedding(nn.Module):
    def __init__(self, input_dim, output_dim, device=None,
                 dtype=torch.float32):
        super().__init__()
        dev = resolve_device(device)
        self.weight = _param((input_dim, output_dim), 0.0, dev, dtype)

    def forward(self, x):
        return F.embedding(x, self.weight)


class Dropout(nn.Module):
    """Active only in training mode, as the JAX package's dropout is only
    under autograd training. Its noise comes from ``generator`` (a CPU
    ``torch.Generator``; None draws from PyTorch's default one)."""

    def __init__(self, rate, generator=None):
        super().__init__()
        self._rate = rate
        self.generator = generator

    def forward(self, x):
        if not self.training or self._rate <= 0:
            return x
        keep = torch.rand(x.shape, generator=self.generator,
                          device='cpu').to(x.device) >= self._rate
        return torch.where(keep, x / (1.0 - self._rate),
                           torch.zeros_like(x))
