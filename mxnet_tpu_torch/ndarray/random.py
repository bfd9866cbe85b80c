"""``nd.random`` (counterpart of ``mxnet_tpu/ndarray/random.py``, ref:
python/mxnet/ndarray/random.py): the registered samplers of
``ops/random_ops.py``, drawing from ``random.generator`` of the device
they sample on: ``ctx``, else the current context (the card by default),
or the device of the NDArray parameters of the per-element forms.
"""
from __future__ import annotations

from .ndarray import NDArray, _invoke
from ..ops import random_ops as _r

__all__ = ['uniform', 'normal', 'randn', 'gamma', 'exponential', 'poisson',
           'negative_binomial', 'generalized_negative_binomial', 'randint',
           'multinomial', 'shuffle']


def _shape(shape):
    if shape is None:
        return ()
    if isinstance(shape, int):
        return (shape,)
    return tuple(shape)


def _draw(fn, ctx, **kwargs):
    return _invoke(fn, ctx=ctx, **kwargs)


def uniform(low=0.0, high=1.0, shape=None, dtype='float32', ctx=None,
            out=None, **kwargs):
    if isinstance(low, NDArray):
        return _invoke(_r.sample_uniform, low, high, shape=_shape(shape),
                       dtype=dtype)
    return _draw(_r.random_uniform, ctx, low=low, high=high,
                 shape=_shape(shape), dtype=dtype)


def normal(loc=0.0, scale=1.0, shape=None, dtype='float32', ctx=None,
           out=None, **kwargs):
    if isinstance(loc, NDArray):
        return _invoke(_r.sample_normal, loc, scale, shape=_shape(shape),
                       dtype=dtype)
    return _draw(_r.random_normal, ctx, loc=loc, scale=scale,
                 shape=_shape(shape), dtype=dtype)


def randn(*shape, loc=0.0, scale=1.0, dtype='float32', ctx=None, **kwargs):
    """Standard normal draws of the given shape (ref: random.py randn)."""
    return normal(loc, scale, shape=shape or None, dtype=dtype, ctx=ctx)


def gamma(alpha=1.0, beta=1.0, shape=None, dtype='float32', ctx=None,
          out=None, **kwargs):
    if isinstance(alpha, NDArray):
        return _invoke(_r.sample_gamma, alpha, beta, shape=_shape(shape),
                       dtype=dtype)
    return _draw(_r.random_gamma, ctx, alpha=alpha, beta=beta,
                 shape=_shape(shape), dtype=dtype)


def exponential(scale=1.0, shape=None, dtype='float32', ctx=None, out=None,
                **kwargs):
    return _draw(_r.random_exponential, ctx, lam=1.0 / scale,
                 shape=_shape(shape), dtype=dtype)


def poisson(lam=1.0, shape=None, dtype='float32', ctx=None, out=None,
            **kwargs):
    return _draw(_r.random_poisson, ctx, lam=lam, shape=_shape(shape),
                 dtype=dtype)


def negative_binomial(k=1, p=1.0, shape=None, dtype='float32', ctx=None,
                      **kwargs):
    return _draw(_r.random_negative_binomial, ctx, k=k, p=p,
                 shape=_shape(shape), dtype=dtype)


def generalized_negative_binomial(mu=1.0, alpha=1.0, shape=None,
                                  dtype='float32', ctx=None, **kwargs):
    return _draw(_r.random_generalized_negative_binomial, ctx, mu=mu,
                 alpha=alpha, shape=_shape(shape), dtype=dtype)


def randint(low, high, shape=None, dtype='int32', ctx=None, out=None,
            **kwargs):
    return _draw(_r.random_randint, ctx, low=low, high=high,
                 shape=_shape(shape), dtype=dtype)


def multinomial(data, shape=None, get_prob=False, dtype='int32', **kwargs):
    """Category indices drawn from each row of ``data``; as in the JAX
    package, no log-probabilities even with ``get_prob`` (ROADMAP
    queue 3)."""
    return _invoke(_r.sample_multinomial, data,
                   shape=_shape(shape) if shape else (), get_prob=get_prob,
                   dtype=dtype)


def shuffle(data, **kwargs):
    return _invoke(_r.shuffle, data)
