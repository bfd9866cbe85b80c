"""Optimizers (counterpart of ``mxnet_tpu/optimizer``: every optimizer of
the JAX package)."""
from .optimizer import (DCASGD, FTML, LAMB, LARS, NAG, SGD, SGLD, AdaDelta,
                        AdaGrad, Adam, Adamax, AdamW, Ftrl, Nadam, Optimizer,
                        RMSProp, Signum, Test, Updater, create, get_updater,
                        register)

__all__ = ['AdaDelta', 'AdaGrad', 'Adam', 'Adamax', 'AdamW', 'DCASGD', 'FTML',
           'Ftrl', 'LAMB', 'LARS', 'NAG', 'Nadam', 'Optimizer', 'RMSProp',
           'SGD', 'SGLD', 'Signum', 'Test', 'Updater', 'create',
           'get_updater', 'register']
