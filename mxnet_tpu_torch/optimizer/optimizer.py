"""Optimizers (counterpart of ``mxnet_tpu/optimizer/optimizer.py``).

The stateful Optimizer API of the JAX package: a registry, per-parameter
lr/wd multipliers, update counts and multi-precision master weights,
over torch tensors updated in place. The math lives in
``ops/optimizer_ops.py``. Only AdamW is ported so far; ``create`` of any
other name raises and lists what is ported, and so does an
``lr_scheduler``.
"""
from __future__ import annotations

import torch

from ..base import MXNetError
from ..ops import optimizer_ops as O

__all__ = ['Optimizer', 'AdamW', 'register', 'create']

_REG = {}


def register(klass):
    _REG[klass.__name__.lower()] = klass
    return klass


def create(name, **kwargs):
    """An optimizer by its (case-insensitive) name; an Optimizer instance
    is returned as it is."""
    if not isinstance(name, str):
        return name
    klass = _REG.get(name.lower())
    if klass is None:
        raise MXNetError(f"optimizer {name!r} is not ported; ported: "
                         f"{sorted(_REG)}")
    return klass(**kwargs)


def _cg(v):
    return -1.0 if v is None else v


class Optimizer:
    """Base optimizer: rescale_grad, wd, clip_gradient, the learning rate,
    update counts, lr_mult/wd_mult (read from ``param_dict``'s parameters,
    1.0 where a parameter has none) and ``multi_precision``, which keeps an
    f32 master copy of every f16/bf16 weight."""

    def __init__(self, rescale_grad=1.0, wd=0.0, clip_gradient=None,
                 learning_rate=0.01, lr_scheduler=None, multi_precision=False,
                 param_dict=None):
        if lr_scheduler is not None:
            raise MXNetError("lr_scheduler is not ported yet; set the rate "
                             "with set_learning_rate")
        self.rescale_grad = rescale_grad
        self.lr = learning_rate
        self.wd = wd
        self.num_update = 0
        self._index_update_count = {}
        self.clip_gradient = clip_gradient
        self.multi_precision = multi_precision
        self.param_dict = param_dict if param_dict else {}

    def create_state(self, index, weight):
        return None

    def _low_precision(self, weight):
        return self.multi_precision and \
            weight.dtype in (torch.float16, torch.bfloat16)

    def create_state_multi_precision(self, index, weight):
        """(f32 master copy, state) for a low-precision weight under
        ``multi_precision``; else the plain state."""
        if self._low_precision(weight):
            master = weight.detach().to(torch.float32).clone()
            return (master, self.create_state(index, master))
        return self.create_state(index, weight)

    def update(self, index, weight, grad, state):
        raise NotImplementedError

    @torch.no_grad()
    def update_multi_precision(self, index, weight, grad, state):
        if self._low_precision(weight):
            master, base_state = state
            self.update(index, master, grad.to(torch.float32), base_state)
            weight.copy_(master.to(weight.dtype))
        else:
            self.update(index, weight, grad, state)

    def set_learning_rate(self, lr):
        self.lr = lr

    @property
    def learning_rate(self):
        return self.lr

    def _update_count(self, index):
        count = self._index_update_count.get(index, 0) + 1
        self._index_update_count[index] = count
        self.num_update = max(count, self.num_update)

    def _get_lr(self, index):
        return self.lr * getattr(self.param_dict.get(index), 'lr_mult', 1.0)

    def _get_wd(self, index):
        return self.wd * getattr(self.param_dict.get(index), 'wd_mult', 1.0)


@register
class AdamW(Optimizer):
    """Decoupled weight decay Adam (the JAX package's AdamW: no bias
    correction, the decay scaled by lr)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, eta=1.0, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon
        self.eta = eta

    def create_state(self, index, weight):
        return (torch.zeros(weight.shape, dtype=torch.float32,
                            device=weight.device),
                torch.zeros(weight.shape, dtype=torch.float32,
                            device=weight.device))

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        self._update_count(index)
        mean, var = state
        new_w, new_mean, new_var = O.adamw_update(
            weight, grad, mean, var, rescale_grad=self.rescale_grad,
            lr=self._get_lr(index), eta=self.eta, beta1=self.beta1,
            beta2=self.beta2, epsilon=self.epsilon, wd=self._get_wd(index),
            clip_gradient=_cg(self.clip_gradient))
        weight.copy_(new_w)
        mean.copy_(new_mean)
        var.copy_(new_var)
