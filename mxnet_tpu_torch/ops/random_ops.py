"""Random sampling ops (counterpart of ``mxnet_tpu/ops/random_ops.py``,
ref: src/operator/random/sample_op.cc, multisample_op.cc).

Every op draws from ``random.generator(device)`` of the device it samples
on: never from torch's default generator, never from a new one. So
``mx.random.seed`` seeds them, ``random.get_state``/``set_state`` carry
them in a checkpoint, and a CUDA graph that draws (``hybridize()``, the
compiled step) registers that generator, so each replay draws fresh
numbers. An op with no array argument samples on ``ctx`` (a Context) or
on the current context: the card by default. The numbers differ from the
JAX package's for the same seed; the distributions are the same.
"""
from __future__ import annotations

import torch

from ..base import register_op, torch_dtype
from ..context import current_context
from .. import random as _random

__all__ = []


def _reg(fn):
    register_op(fn.__name__, nograd=True)(fn)
    __all__.append(fn.__name__)
    return fn


def _device(ctx):
    return (ctx or current_context()).device


def _gen(device):
    return _random.generator(device)


def _shape(shape):
    if shape is None:
        return ()
    return (int(shape),) if isinstance(shape, int) else tuple(shape)


def uniform(shape, device, dtype=torch.float32):
    """U[0, 1) of ``shape`` on ``device`` from the port's generator."""
    return torch.rand(shape, generator=_gen(device), device=device,
                      dtype=dtype)


def normal(shape, device, dtype=torch.float32):
    return torch.randn(shape, generator=_gen(device), device=device,
                       dtype=dtype)


def gamma(alpha, shape, device):
    """Gamma(alpha, 1) in float32; ``alpha`` a number or a tensor that
    broadcasts to ``shape``."""
    a = torch.as_tensor(alpha, dtype=torch.float32, device=device)
    return torch._standard_gamma(a.expand(shape).contiguous(),
                                 generator=_gen(device))


def poisson(rate, device):
    return torch.poisson(rate.to(torch.float32), generator=_gen(device))


def exponential(shape, device, dtype=torch.float32):
    return torch.empty(shape, device=device, dtype=dtype).exponential_(
        generator=_gen(device))


@_reg
def random_uniform(low=0.0, high=1.0, shape=(), dtype='float32', ctx=None):
    d = _device(ctx)
    u = uniform(_shape(shape), d, torch_dtype(dtype))
    return low + u * (high - low)


@_reg
def random_normal(loc=0.0, scale=1.0, shape=(), dtype='float32', ctx=None):
    d = _device(ctx)
    return loc + scale * normal(_shape(shape), d, torch_dtype(dtype))


@_reg
def random_gamma(alpha=1.0, beta=1.0, shape=(), dtype='float32', ctx=None):
    d = _device(ctx)
    return (beta * gamma(alpha, _shape(shape), d)).to(torch_dtype(dtype))


@_reg
def random_exponential(lam=1.0, shape=(), dtype='float32', ctx=None):
    d = _device(ctx)
    return exponential(_shape(shape), d, torch_dtype(dtype)) / lam


@_reg
def random_poisson(lam=1.0, shape=(), dtype='float32', ctx=None):
    d = _device(ctx)
    rate = torch.full(_shape(shape), float(lam), device=d)
    return poisson(rate, d).to(torch_dtype(dtype))


@_reg
def random_negative_binomial(k=1, p=1.0, shape=(), dtype='float32',
                             ctx=None):
    d = _device(ctx)
    g = gamma(k, _shape(shape), d) * ((1 - p) / p)
    return poisson(g, d).to(torch_dtype(dtype))


@_reg
def random_generalized_negative_binomial(mu=1.0, alpha=1.0, shape=(),
                                         dtype='float32', ctx=None):
    d = _device(ctx)
    g = gamma(1.0 / alpha, _shape(shape), d) * (alpha * mu)
    return poisson(g, d).to(torch_dtype(dtype))


@_reg
def random_randint(low=0, high=1, shape=(), dtype='int32', ctx=None):
    d = _device(ctx)
    return torch.randint(int(low), int(high), _shape(shape),
                         generator=_gen(d), device=d,
                         dtype=torch_dtype(dtype))


@_reg
def sample_multinomial(data, shape=(), get_prob=False, dtype='int32'):
    """Category indices drawn from each row of ``data`` (..., K). As in the
    JAX op, ``get_prob`` is accepted and no log-probabilities are
    returned (ROADMAP queue 3)."""
    extra = _shape(shape) if shape else ()
    n = 1
    for s in extra:
        n *= int(s) if s else 1
    rows = data.reshape(-1, data.shape[-1]).to(torch.float32)
    rows = torch.clamp(rows, min=1e-30)
    samp = torch.multinomial(rows, n, replacement=True,
                             generator=_gen(data.device))
    return samp.reshape(tuple(data.shape[:-1]) + extra).to(
        torch_dtype(dtype))


@_reg
def shuffle(data):
    """``data`` with its rows (axis 0) in a random order."""
    perm = torch.randperm(data.shape[0], generator=_gen(data.device),
                          device=data.device)
    return data[perm]


def _per_element(param, shape):
    extra = _shape(shape)
    return param.reshape(tuple(param.shape) + (1,) * len(extra)), \
        tuple(param.shape) + extra


@_reg
def sample_uniform(low, high, shape=(), dtype='float32'):
    """One draw of ``shape`` per element of ``low``/``high``."""
    low_b, sshape = _per_element(low, shape)
    high_b, _ = _per_element(high, shape)
    u = uniform(sshape, low.device, torch_dtype(dtype))
    return low_b + u * (high_b - low_b)


@_reg
def sample_normal(mu, sigma, shape=(), dtype='float32'):
    mu_b, sshape = _per_element(mu, shape)
    sig_b, _ = _per_element(sigma, shape)
    return mu_b + normal(sshape, mu.device, torch_dtype(dtype)) * sig_b


@_reg
def sample_gamma(alpha, beta, shape=(), dtype='float32'):
    a_b, sshape = _per_element(alpha, shape)
    b_b, _ = _per_element(beta, shape)
    g = gamma(a_b, sshape, alpha.device).to(torch_dtype(dtype))
    return g * b_b
