"""mxnet_tpu_torch: the PyTorch/CUDA port of ``mxnet_tpu`` for an NVIDIA
H100 (Hopper, sm_90a).

It imports torch and numpy, never jax and nothing of ``mxnet_tpu``.
Module names mirror ``mxnet_tpu`` so each counterpart is easy to find.
Entry points run on the card unless the caller passes ``device='cpu'``;
with no CUDA device and no explicit ``'cpu'`` they raise.

It serves ``models.bert.BertModel`` through ``serving.InferenceEngine``
and trains ``models.bert.BertForPretraining`` through ``gluon.Trainer``
(AdamW) on five hand-written kernels (see ``ops``).
"""
from .base import MXNetError
from . import (config, context, gluon, initializer, models, ops, optimizer,
               serialization, serving, weights)

__all__ = ['MXNetError', 'config', 'context', 'gluon', 'initializer',
           'models', 'ops', 'optimizer', 'serialization', 'serving',
           'weights']
