"""Optimizer update math (counterpart of ``mxnet_tpu/ops/optimizer_ops.py``,
AdamW so far).

Plain PyTorch functions over (weight, grad, states) that return the new
values, as the JAX package's pure functions do: the arithmetic runs in
f32 and the weight comes back in its own dtype. In the JAX package the
whole update is one fused XLA program, not a Pallas kernel, so there is no
hand-written kernel here.
"""
from __future__ import annotations

import torch

__all__ = ['adamw_update']


def _grad_prep(grad, rescale_grad, clip_gradient):
    """f32 cast, then ``rescale_grad``, then the clip when it is > 0."""
    g = grad.to(torch.float32) * rescale_grad
    if clip_gradient is not None and clip_gradient > 0:
        g = g.clamp(-clip_gradient, clip_gradient)
    return g


def adamw_update(weight, grad, mean, var, rescale_grad=1.0, lr=0.001,
                 eta=1.0, beta1=0.9, beta2=0.999, epsilon=1e-8, wd=0.0,
                 clip_gradient=-1.0):
    """Decoupled weight decay Adam with no bias correction, the decay scaled
    by lr: returns (new weight in weight's dtype, new mean, new var)."""
    g = _grad_prep(grad, rescale_grad, clip_gradient)
    new_mean = beta1 * mean + (1 - beta1) * g
    new_var = beta2 * var + (1 - beta2) * torch.square(g)
    w32 = weight.to(torch.float32)
    new_w = w32 - eta * (lr * new_mean / (torch.sqrt(new_var) + epsilon)
                         + wd * lr * w32)
    return new_w.to(weight.dtype), new_mean, new_var
