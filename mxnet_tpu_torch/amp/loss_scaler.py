"""Dynamic loss scaler (counterpart of ``mxnet_tpu/amp/loss_scaler.py``,
ref: python/mxnet/contrib/amp/loss_scaler.py).

With bfloat16 the exponent range matches f32 and the scale stays 1; the
scaler is what makes float16 training work: the loss is multiplied by
the scale before the backward, so that small gradients do not flush to
zero in float16, and a step whose gradients overflowed is skipped.
"""
from __future__ import annotations

import torch

from ..ops.optimizer_ops import all_finite

__all__ = ['LossScaler']


def _grad_of(x):
    """The gradient tensor of a Gluon Parameter or ``torch.nn.Parameter``
    (None when it has none); any other tensor is taken as a gradient."""
    if isinstance(x, torch.nn.Parameter):
        return x.grad
    if isinstance(x, torch.Tensor):
        return x
    return x.tensor.grad


class LossScaler:
    """Doubles the scale every ``scale_window`` clean steps, halves it (not
    below ``min_scale``) on non-finite gradients, and tells the trainer to
    skip that update."""

    def __init__(self, init_scale=2.**16, scale_factor=2., scale_window=2000,
                 min_scale=1., dynamic=True):
        self.loss_scale = float(init_scale)
        self.dynamic = dynamic
        self._scale_factor = float(scale_factor)
        self._scale_window = int(scale_window)
        self._min_scale = float(min_scale)
        self._unskipped = 0

    def has_overflow(self, params):
        """True if any gradient is non-finite. ``params`` holds Gluon
        Parameters, ``torch.nn.Parameter``s (their ``.grad`` is read) or
        gradient tensors (the Trainer passes the buffers its update
        reads). The finiteness of every gradient is reduced on the
        device first, so the check costs one device-to-host sync."""
        grads = [g for g in map(_grad_of, params) if g is not None]
        if not grads:
            return False
        return not bool(all_finite(*grads))

    def update_scale(self, overflow: bool):
        if overflow:
            self.loss_scale = max(self._min_scale,
                                  self.loss_scale / self._scale_factor)
            self._unskipped = 0
        else:
            self._unskipped += 1
            if self._unskipped >= self._scale_window:
                self.loss_scale *= self._scale_factor
                self._unskipped = 0
