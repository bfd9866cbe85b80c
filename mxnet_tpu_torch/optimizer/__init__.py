"""Optimizers (counterpart of ``mxnet_tpu/optimizer``: SGD, NAG, Adam,
AdamW and LAMB so far)."""
from .optimizer import (LAMB, NAG, SGD, Adam, AdamW, Optimizer, Updater,
                        create, get_updater, register)

__all__ = ['Adam', 'AdamW', 'LAMB', 'NAG', 'Optimizer', 'SGD', 'Updater',
           'create', 'get_updater', 'register']
