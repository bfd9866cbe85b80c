"""Elementwise unary, binary and scalar ops (counterpart of
``mxnet_tpu/ops/elemwise.py``), with the JAX package's dtype rules:

- comparisons and logical ops return 0/1 in the lhs dtype, not ``bool``;
- ``broadcast_mod``/``mod_scalar`` take the divisor's sign
  (``jnp.mod`` is ``torch.remainder``, not ``torch.fmod``);
- a Python scalar does not widen an array (``int32 + 1`` stays int32,
  ``int32 + 1.5`` is float32), as JAX's weak types and torch's 0-dim
  promotion both do.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..base import register_op, torch_dtype

__all__ = []


def _export(fn):
    __all__.append(fn.__name__)
    return fn


def _reg(fn):
    register_op(fn.__name__)(fn)
    return _export(fn)


def _scalar_like(s, x):
    """A 0-dim tensor on x's device: it takes part in type promotion
    without widening x within its kind."""
    return torch.as_tensor(s, device=x.device)


# --- binary broadcast (ref: elemwise_binary_broadcast_op_basic.cc) ---------

@_reg
def broadcast_add(lhs, rhs):
    return torch.add(lhs, rhs)


@_reg
def broadcast_sub(lhs, rhs):
    return torch.sub(lhs, rhs)


@_reg
def broadcast_mul(lhs, rhs):
    return torch.mul(lhs, rhs)


@_reg
def broadcast_div(lhs, rhs):
    return torch.div(lhs, rhs)


@_reg
def broadcast_mod(lhs, rhs):
    return torch.remainder(lhs, rhs)


@_reg
def broadcast_power(lhs, rhs):
    return torch.pow(lhs, rhs)


@_reg
def broadcast_maximum(lhs, rhs):
    return torch.maximum(lhs, rhs)


@_reg
def broadcast_minimum(lhs, rhs):
    return torch.minimum(lhs, rhs)


@_reg
def broadcast_hypot(lhs, rhs):
    return torch.hypot(lhs, rhs)


def _cmp(name, fn):
    def op(lhs, rhs):
        return fn(lhs, rhs).to(lhs.dtype)
    op.__name__ = name
    globals()[name] = op
    _reg(op)


for _name, _fn in (('broadcast_equal', torch.eq),
                   ('broadcast_not_equal', torch.ne),
                   ('broadcast_greater', torch.gt),
                   ('broadcast_greater_equal', torch.ge),
                   ('broadcast_lesser', torch.lt),
                   ('broadcast_lesser_equal', torch.le),
                   ('broadcast_logical_and', torch.logical_and),
                   ('broadcast_logical_or', torch.logical_or),
                   ('broadcast_logical_xor', torch.logical_xor)):
    _cmp(_name, _fn)


# aliases matching the non-broadcast elemwise names
@_reg
def elemwise_add(lhs, rhs):
    return torch.add(lhs, rhs)


@_reg
def elemwise_sub(lhs, rhs):
    return torch.sub(lhs, rhs)


@_reg
def elemwise_mul(lhs, rhs):
    return torch.mul(lhs, rhs)


@_reg
def elemwise_div(lhs, rhs):
    return torch.div(lhs, rhs)


# --- unary math (ref: elemwise_unary_op_basic.cc, _trig.cc, _pow.cc, _logexp.cc)

def _cbrt(x):
    return torch.sign(x) * torch.abs(x).pow(1.0 / 3.0)


_UNARY = {
    'abs': torch.abs, 'sign': torch.sign, 'rint': torch.round,
    'ceil': torch.ceil, 'floor': torch.floor, 'trunc': torch.trunc,
    'fix': torch.trunc, 'square': torch.square, 'sqrt': torch.sqrt,
    'cbrt': _cbrt, 'exp': torch.exp, 'log': torch.log, 'log10': torch.log10,
    'log2': torch.log2, 'log1p': torch.log1p, 'expm1': torch.expm1,
    'sin': torch.sin, 'cos': torch.cos, 'tan': torch.tan,
    'arcsin': torch.asin, 'arccos': torch.acos, 'arctan': torch.atan,
    'sinh': torch.sinh, 'cosh': torch.cosh, 'tanh': torch.tanh,
    'arcsinh': torch.asinh, 'arccosh': torch.acosh, 'arctanh': torch.atanh,
    'degrees': torch.rad2deg, 'radians': torch.deg2rad,
    'erf': torch.erf, 'erfinv': torch.erfinv,
    'gamma': lambda x: torch.exp(torch.lgamma(x)),
    'gammaln': torch.lgamma,
    'logical_not': lambda x: torch.logical_not(x).to(x.dtype),
}

for _name, _tfn in _UNARY.items():
    def _mk(tfn):
        def op(data):
            return tfn(data)
        return op
    _f = _mk(_tfn)
    _f.__name__ = _name
    globals()[_name] = _f
    register_op(_name)(_f)
    __all__.append(_name)


@_reg
def reciprocal(data):
    return 1.0 / data


@_reg
def rsqrt(data):
    return torch.rsqrt(data)


@_reg
def rcbrt(data):
    return 1.0 / _cbrt(data)


@_reg
def negative(data):
    return torch.neg(data)


@_reg
def relu(data):
    return torch.relu(data)


@_reg
def sigmoid(data):
    return torch.sigmoid(data)


@_reg
def hard_sigmoid(data, alpha=0.2, beta=0.5):
    return torch.clamp(alpha * data + beta, 0.0, 1.0)


@_reg
def softsign(data):
    return data / (1.0 + torch.abs(data))


@_reg
def gelu(data):
    return F.gelu(data, approximate='none')


@_reg
def gelu_tanh(data):
    return F.gelu(data, approximate='tanh')


@_reg
def clip(data, a_min=None, a_max=None):
    if a_min is None and a_max is None:
        return data
    return torch.clamp(data, a_min, a_max)


# --- scalar ops (ref: elemwise_binary_scalar_op_basic.cc) ------------------

def _scalar(name, fn):
    def op(data, scalar=1.0):
        return fn(data, scalar)
    op.__name__ = name
    register_op(name)(op)
    globals()[name] = op
    __all__.append(name)


def _bool_to(fn):
    return lambda x, s: fn(x, _scalar_like(s, x)).to(x.dtype)


_scalar('plus_scalar', lambda x, s: x + s)
_scalar('minus_scalar', lambda x, s: x - s)
_scalar('rminus_scalar', lambda x, s: s - x)
_scalar('mul_scalar', lambda x, s: x * s)
_scalar('div_scalar', lambda x, s: x / s)
_scalar('rdiv_scalar', lambda x, s: s / x)
_scalar('mod_scalar', lambda x, s: torch.remainder(x, s))
_scalar('rmod_scalar', lambda x, s: torch.remainder(_scalar_like(s, x), x))
_scalar('power_scalar', lambda x, s: torch.pow(x, s))
_scalar('rpower_scalar', lambda x, s: torch.pow(s, x))
_scalar('maximum_scalar', lambda x, s: torch.maximum(x, _scalar_like(s, x)))
_scalar('minimum_scalar', lambda x, s: torch.minimum(x, _scalar_like(s, x)))
_scalar('equal_scalar', _bool_to(torch.eq))
_scalar('not_equal_scalar', _bool_to(torch.ne))
_scalar('greater_scalar', _bool_to(torch.gt))
_scalar('greater_equal_scalar', _bool_to(torch.ge))
_scalar('lesser_scalar', _bool_to(torch.lt))
_scalar('lesser_equal_scalar', _bool_to(torch.le))
_scalar('logical_and_scalar', _bool_to(torch.logical_and))
_scalar('logical_or_scalar', _bool_to(torch.logical_or))
_scalar('logical_xor_scalar', _bool_to(torch.logical_xor))


@_reg
def add_n(*args):
    """Sum of N arrays (ref: src/ndarray/ndarray_function.h ElementwiseSum)."""
    out = args[0]
    for a in args[1:]:
        out = out + a
    return out


@_reg
def cast(data, dtype='float32'):
    return data.to(torch_dtype(dtype))


@_reg
def amp_cast(data, dtype='float16'):
    """AMP cast (ref: src/operator/tensor/amp_cast.cc)."""
    return data.to(torch_dtype(dtype))


@_reg
def where(condition, x, y):
    return torch.where(condition.to(torch.bool), x, y)


@_reg
def isnan(data):
    return torch.isnan(data).to(data.dtype)


@_reg
def isinf(data):
    return torch.isinf(data).to(data.dtype)


@_reg
def isfinite(data):
    return torch.isfinite(data).to(data.dtype)
