"""Gluon contrib (counterpart of ``mxnet_tpu/gluon/contrib``): the
Estimator and its event handlers, and the contrib layers."""
from . import estimator
from . import nn

__all__ = ['estimator', 'nn']
