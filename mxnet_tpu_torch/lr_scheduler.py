"""Learning-rate schedulers (counterpart of ``mxnet_tpu/lr_scheduler.py``;
ref: python/mxnet/lr_scheduler.py).

Host-side Python, as in the JAX package: a scheduler maps the optimizer's
update count to a rate. The optimizer evaluates it before each step and
the Trainer writes the result into the device scalar that its captured
update reads, so a schedule never retraces or recaptures anything.
"""
from __future__ import annotations

import math

from .base import MXNetError

__all__ = ['LRScheduler', 'FactorScheduler', 'MultiFactorScheduler',
           'PolyScheduler', 'CosineScheduler']


class LRScheduler:
    """Base scheduler: ``warmup_steps`` of linear (or constant) warm-up
    from ``warmup_begin_lr`` to ``base_lr``."""

    def __init__(self, base_lr=0.01, warmup_steps=0, warmup_begin_lr=0.0,
                 warmup_mode='linear'):
        self.base_lr = base_lr
        self.warmup_steps = warmup_steps
        self.warmup_begin_lr = warmup_begin_lr
        self.warmup_final_lr = base_lr
        self.warmup_mode = warmup_mode
        if warmup_mode not in ('linear', 'constant'):
            raise MXNetError("warmup_mode must be 'linear' or 'constant'")

    def get_warmup_lr(self, num_update):
        if num_update >= self.warmup_steps:
            raise MXNetError(f"get_warmup_lr: update {num_update} is past "
                             f"the {self.warmup_steps} warm-up steps")
        if self.warmup_mode == 'linear':
            increase = ((self.warmup_final_lr - self.warmup_begin_lr)
                        * num_update / self.warmup_steps)
            return self.warmup_begin_lr + increase
        return self.warmup_begin_lr

    def __call__(self, num_update):
        raise NotImplementedError


class FactorScheduler(LRScheduler):
    """base_lr * factor ** (number of whole ``step``s passed), not below
    ``stop_factor_lr``."""

    def __init__(self, step, factor=1.0, stop_factor_lr=1e-8, base_lr=0.01,
                 warmup_steps=0, warmup_begin_lr=0.0, warmup_mode='linear'):
        super().__init__(base_lr, warmup_steps, warmup_begin_lr, warmup_mode)
        if step < 1:
            raise MXNetError("Schedule step must be greater or equal than 1")
        self.step = step
        self.factor = factor
        self.stop_factor_lr = stop_factor_lr
        self.count = 0

    def __call__(self, num_update):
        if num_update < self.warmup_steps:
            return self.get_warmup_lr(num_update)
        while num_update > self.count + self.step:
            self.count += self.step
            self.base_lr *= self.factor
            if self.base_lr < self.stop_factor_lr:
                self.base_lr = self.stop_factor_lr
        return self.base_lr


class MultiFactorScheduler(LRScheduler):
    """base_lr times ``factor`` once past each entry of the list ``step``."""

    def __init__(self, step, factor=1.0, base_lr=0.01, warmup_steps=0,
                 warmup_begin_lr=0.0, warmup_mode='linear'):
        super().__init__(base_lr, warmup_steps, warmup_begin_lr, warmup_mode)
        if not isinstance(step, list) or len(step) < 1:
            raise MXNetError("MultiFactorScheduler: step must be a "
                             "non-empty list")
        self.step = step
        self.cur_step_ind = 0
        self.factor = factor
        self.count = 0

    def __call__(self, num_update):
        if num_update < self.warmup_steps:
            return self.get_warmup_lr(num_update)
        while self.cur_step_ind <= len(self.step) - 1:
            if num_update > self.step[self.cur_step_ind]:
                self.count = self.step[self.cur_step_ind]
                self.cur_step_ind += 1
                self.base_lr *= self.factor
            else:
                return self.base_lr
        return self.base_lr


class PolyScheduler(LRScheduler):
    """Polynomial decay of power ``pwr`` from base_lr to ``final_lr`` over
    the updates after warm-up, up to ``max_update``."""

    def __init__(self, max_update, base_lr=0.01, pwr=2, final_lr=0,
                 warmup_steps=0, warmup_begin_lr=0.0, warmup_mode='linear'):
        super().__init__(base_lr, warmup_steps, warmup_begin_lr, warmup_mode)
        self.power = pwr
        self.base_lr_orig = self.base_lr
        self.max_update = max_update
        self.final_lr = final_lr
        self.max_steps = self.max_update - self.warmup_steps

    def __call__(self, num_update):
        if num_update < self.warmup_steps:
            return self.get_warmup_lr(num_update)
        if num_update <= self.max_update:
            self.base_lr = self.final_lr + \
                (self.base_lr_orig - self.final_lr) * pow(
                    1 - float(num_update - self.warmup_steps) /
                    float(self.max_steps), self.power)
        return self.base_lr


class CosineScheduler(LRScheduler):
    """Half-cosine decay from base_lr to ``final_lr`` over the updates after
    warm-up, up to ``max_update``."""

    def __init__(self, max_update, base_lr=0.01, final_lr=0,
                 warmup_steps=0, warmup_begin_lr=0.0, warmup_mode='linear'):
        super().__init__(base_lr, warmup_steps, warmup_begin_lr, warmup_mode)
        self.base_lr_orig = base_lr
        self.max_update = max_update
        self.final_lr = final_lr
        self.max_steps = self.max_update - self.warmup_steps

    def __call__(self, num_update):
        if num_update < self.warmup_steps:
            return self.get_warmup_lr(num_update)
        if num_update <= self.max_update:
            self.base_lr = self.final_lr + \
                (self.base_lr_orig - self.final_lr) * \
                (1 + math.cos(math.pi * (num_update - self.warmup_steps)
                              / self.max_steps)) / 2
        return self.base_lr
