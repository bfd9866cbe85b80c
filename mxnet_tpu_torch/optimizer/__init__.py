"""Optimizers (counterpart of ``mxnet_tpu/optimizer``; AdamW so far)."""
from .optimizer import AdamW, Optimizer, create, register

__all__ = ['AdamW', 'Optimizer', 'create', 'register']
