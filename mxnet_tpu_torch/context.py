"""Device resolution for the port's entry points (counterpart of
``mxnet_tpu/context.py``).

Entry points run on the card unless the caller asks for the CPU. With no
CUDA device and no explicit ``'cpu'`` they raise: the port never runs on
the CPU by accident.
"""
from __future__ import annotations

import torch

from .base import MXNetError

__all__ = ['resolve_device']


def resolve_device(device=None) -> torch.device:
    """``None`` means the current CUDA device; ``'cpu'`` (or a CPU
    ``torch.device``) is honoured only when asked for by name."""
    dev = torch.device('cuda') if device is None else torch.device(device)
    if dev.type == 'cuda' and not torch.cuda.is_available():
        raise MXNetError(
            f"device {str(dev)!r} requested but no CUDA device is "
            f"available; pass device='cpu' to run the plain PyTorch path")
    if dev.type not in ('cuda', 'cpu'):
        raise MXNetError(f"unsupported device {str(dev)!r}")
    return dev
