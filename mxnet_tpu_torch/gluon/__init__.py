"""Gluon-style layers as PyTorch modules (counterpart of
``mxnet_tpu/gluon``). ``hybridize()``/CachedOp has no counterpart: a
runner calls the module under ``torch.inference_mode()``."""
from . import nn

__all__ = ['nn']
