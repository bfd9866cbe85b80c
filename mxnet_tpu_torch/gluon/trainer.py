"""Gluon Trainer on one device (counterpart of ``mxnet_tpu/gluon/
trainer.py``).

    trainer = gluon.Trainer(gluon.collect_params(net), 'adamw',
                            {'learning_rate': 1e-4, 'wd': 0.01})
    loss.backward()            # torch.autograd in place of mx.autograd
    trainer.step(batch_size)
    net.zero_grad(set_to_none=False)

``step(batch_size)`` sets ``rescale_grad = scale / batch_size`` and applies
one optimizer update to every parameter that requires a gradient, as the
JAX Trainer does to every parameter whose ``grad_req`` is not 'null'. A
parameter that took no part in the loss (``.grad`` is None, e.g.
``type_embed.weight`` when no token types are fed) is updated with a zero
gradient, as the JAX Trainer updates its zero-filled gradient buffer:
AdamW's decoupled weight decay still shrinks it.

Single device only: the kvstore types 'device' and 'local' (and None) are
accepted and mean nothing; a distributed kvstore, gradient compression and
update_on_kvstore raise. The guard, elastic, ZeRO and telemetry hooks of
the JAX Trainer are not ported.
"""
from __future__ import annotations

import torch

from ..base import MXNetError
from .. import optimizer as opt

__all__ = ['Trainer']


class Trainer:
    def __init__(self, params, optimizer, optimizer_params=None,
                 kvstore='device', compression_params=None,
                 update_on_kvstore=None):
        if isinstance(params, dict):
            params = list(params.values())
        if not isinstance(params, (list, tuple)):
            raise ValueError("First argument must be a list or dict of "
                             "Parameters")
        for p in params:
            if not isinstance(p, torch.nn.Parameter):
                raise ValueError(f"First argument must contain Parameters, "
                                 f"got {type(p)}")
        if kvstore not in ('device', 'local', None):
            raise MXNetError(f"kvstore {kvstore!r} is not ported: the port's "
                             f"Trainer runs on one device ('device', "
                             f"'local' or None)")
        if compression_params is not None:
            raise MXNetError("gradient compression is not ported")
        if update_on_kvstore:
            raise MXNetError("update_on_kvstore is not ported")
        self._params = list(params)
        optimizer_params = dict(optimizer_params or {})
        self._scale = float(optimizer_params.get('rescale_grad', 1.0))
        param_dict = dict(enumerate(self._params))
        if isinstance(optimizer, opt.Optimizer):
            if optimizer_params:
                raise ValueError("optimizer_params must be None if optimizer "
                                 "is an Optimizer instance")
            self._optimizer = optimizer
            self._optimizer.param_dict = param_dict
        else:
            self._optimizer = opt.create(optimizer, param_dict=param_dict,
                                         **optimizer_params)
        self._states = {}

    @property
    def optimizer(self):
        return self._optimizer

    @property
    def learning_rate(self):
        return self._optimizer.learning_rate

    def set_learning_rate(self, lr):
        self._optimizer.set_learning_rate(lr)

    def step(self, batch_size):
        """One update of every parameter, its gradient scaled by
        1/batch_size."""
        self.update(batch_size)

    def update(self, batch_size):
        self._optimizer.rescale_grad = self._scale / batch_size
        self._update()

    @torch.no_grad()
    def _update(self):
        o = self._optimizer
        for i, p in enumerate(self._params):
            if not p.requires_grad:
                continue
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            if i not in self._states:
                self._states[i] = o.create_state_multi_precision(i, p)
            o.update_multi_precision(i, p, g, self._states[i])
