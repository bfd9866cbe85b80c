"""Parameters for the Trainer (counterpart of ``mxnet_tpu/gluon/
parameter.py``'s collection API).

A parameter is a ``torch.nn.Parameter``; ``collect_params`` keys them by
the JAX package's structured names (those of
``Block._collect_params_with_prefix``, e.g. ``bert.encoder.0.ln1.gamma``,
which ``weights.params_from_mxnet_tpu`` uses too) and gives each one the
JAX ``Parameter``'s ``lr_mult`` and ``wd_mult`` (default 1.0), which the
optimizer reads.
"""
from __future__ import annotations

from collections import OrderedDict

__all__ = ['collect_params']


def collect_params(module):
    """OrderedDict {structured name: nn.Parameter} of ``module``."""
    out = OrderedDict()
    for name, p in module.named_parameters():
        for attr in ('lr_mult', 'wd_mult'):
            if not hasattr(p, attr):
                setattr(p, attr, 1.0)
        out[name] = p
    return out
