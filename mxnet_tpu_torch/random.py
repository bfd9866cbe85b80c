"""Random state (counterpart of ``mxnet_tpu/random.py``).

One ``torch.Generator`` per device, made at first use. ``nd.dropout``
draws its mask from the generator of its input's device, so noise for a
tensor on the card is drawn on the card, never on the host and copied.
The generators give other numbers than the JAX package's keys from the
same seed: tests feed both packages the same numpy noise, or compare
distributions.
"""
from __future__ import annotations

import threading

import numpy as _onp
import torch

__all__ = ['seed', 'generator']

_lock = threading.Lock()
_seed = 0
_generators = {}


def seed(seed_state: int, ctx=None):
    """Seed the generator of ``ctx`` (every device's when None) and, as the
    JAX package does, numpy's global generator."""
    global _seed
    s = int(seed_state)
    with _lock:
        if ctx is None:
            _seed = s
            for g in _generators.values():
                g.manual_seed(s)
        else:
            generator(ctx.device).manual_seed(s)
    _onp.random.seed(s % (2 ** 31))


def generator(device) -> torch.Generator:
    """The generator of a torch device, seeded with the last global seed
    when first made."""
    device = torch.device(device)
    key = (device.type, device.index or 0)
    g = _generators.get(key)
    if g is None:
        with _lock:
            g = _generators.get(key)
            if g is None:
                g = torch.Generator(device=device).manual_seed(_seed)
                _generators[key] = g
    return g
