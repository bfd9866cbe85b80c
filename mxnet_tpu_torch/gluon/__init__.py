"""Gluon-style layers as PyTorch modules, the parameter collection and the
Trainer (counterpart of ``mxnet_tpu/gluon``). ``hybridize()``/CachedOp has
no counterpart: a runner calls the module under
``torch.inference_mode()``; a training loop uses ``torch.autograd`` in
place of ``mx.autograd.record()`` and ``module.train()`` in place of its
train mode."""
from . import nn
from .parameter import collect_params
from .trainer import Trainer

__all__ = ['nn', 'collect_params', 'Trainer']
