"""Weight initialisation (counterpart of ``mxnet_tpu/initializer.py``;
only ``Normal`` so far), driven by an explicit ``torch.Generator``."""
from __future__ import annotations

import torch

__all__ = ['Normal']


class Normal:
    """N(0, sigma^2) for every parameter whose name ends in ``weight``;
    gamma, beta and biases keep their constructed values (one and zero),
    as the JAX package's name-pattern initialisation does."""

    def __init__(self, sigma=0.01):
        self.sigma = sigma

    @torch.no_grad()
    def __call__(self, module, generator=None):
        """Fill ``module``'s weights, drawing from ``generator`` (a CPU
        ``torch.Generator``) on the CPU and copying to each parameter's
        device, so the values do not depend on the device."""
        for name, p in module.named_parameters():
            if name.endswith('weight'):
                vals = torch.randn(p.shape, generator=generator,
                                   dtype=torch.float32) * self.sigma
                p.copy_(vals.to(device=p.device, dtype=p.dtype))
        return module
