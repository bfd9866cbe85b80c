"""The numpy (``_npi_*``/``_np_*``) operator namespace as registered ops
(counterpart of ``mxnet_tpu/ops/numpy_ops.py``, ref: src/operator/numpy/).

Each op is plain PyTorch (cuBLAS, cuSOLVER and torch's own kernels on the
card), as the JAX package left them to XLA, and ``mx.np`` dispatches
through this registry as ``mx.nd`` does through the legacy one.

dtypes follow the JAX ops, which run with 64-bit types off: no op returns
int64, float64 or complex128 (torch's int64 indices, counts and sums come
back as int32, ``_x32``), a Python scalar never widens an array (it takes
part as a 0-dim float32 or int tensor), integer inputs of the float-valued
functions give float32, and the creation ops default to float32
(``_npi_indices`` to int32). An op with no array argument places its
result on ``ctx`` or on the current context. The random samplers draw from
``random.generator`` of their device (``ops/random_ops.py``).

Ops whose output shape depends on values (``_npi_unique``,
``_npi_nonzero``, ``_npi_delete``, ``_npi_bincount``) read those values on
the host, as the JAX ops do.
"""
from __future__ import annotations

import math

import numpy as onp
import torch
import torch.nn.functional as F

from ..base import register_op, torch_dtype
from ..context import current_context
from . import random_ops as _r

__all__ = []

_NARROW = {torch.int64: torch.int32, torch.float64: torch.float32,
           torch.complex128: torch.complex64}


def _x32(out):
    """64-bit outputs narrowed to 32 bits, in tuples and lists too."""
    if isinstance(out, torch.Tensor):
        t = _NARROW.get(out.dtype)
        return out if t is None else out.to(t)
    if isinstance(out, (tuple, list)):
        return type(out)(_x32(o) for o in out)
    return out


def _reg(name, num_outputs=1, nograd=False):
    def deco(fn):
        def op(*args, **kwargs):
            return _x32(fn(*args, **kwargs))
        op.__name__ = name
        op.__doc__ = fn.__doc__
        register_op(name, num_outputs=num_outputs, nograd=nograd)(op)
        __all__.append(name)
        return fn
    return deco


def _device(ctx):
    return (ctx or current_context()).device


def _dt(dtype, default='float32'):
    return torch_dtype(dtype if dtype is not None else default)


def _shape(shape):
    return (int(shape),) if isinstance(shape, (int, onp.integer)) \
        else tuple(int(s) for s in shape)


def _scalar(s, device):
    """A Python number as a 0-dim tensor that takes part in promotion as
    JAX's weak types do: float32 for a float (never widening a float16 or
    bfloat16 array), int64 for an int, bool for a bool."""
    if isinstance(s, bool):
        return torch.tensor(s, device=device)
    if isinstance(s, (int, onp.integer)):
        return torch.tensor(int(s), dtype=torch.int64, device=device)
    return torch.tensor(float(s), dtype=torch.float32, device=device)


def _pair(a, b):
    """Both operands as tensors, a number taking the other's device."""
    if not isinstance(a, torch.Tensor):
        a = _scalar(a, b.device) if isinstance(b, torch.Tensor) \
            else torch.as_tensor(a)
    if not isinstance(b, torch.Tensor):
        b = _scalar(b, a.device)
    return a, b


def _float(x):
    """x itself when floating, else as float32 (the JAX ops' result for
    an integer input of a float-valued function)."""
    return x if x.is_floating_point() or x.is_complex() else \
        x.to(torch.float32)


def _axes(axis, ndim):
    if axis is None:
        return tuple(range(ndim))
    if isinstance(axis, int):
        return (axis % max(ndim, 1),)
    return tuple(a % max(ndim, 1) for a in axis)


# --- elemwise broadcast binary (ref: np_elemwise_broadcast_op*.cc) ---------

def _ldexp(a, b):
    return a * torch.pow(2.0, b)


def _promote_int(f):
    """f over float32 when both operands are integers or bools."""
    def g(a, b):
        if not (a.is_floating_point() or b.is_floating_point()):
            a, b = a.to(torch.float32), b.to(torch.float32)
        return f(a, b)
    return g


_BINARY = {
    'add': torch.add, 'subtract': torch.sub, 'multiply': torch.mul,
    'mod': torch.remainder, 'power': torch.pow,
    'true_divide': torch.true_divide, 'floor_divide': torch.floor_divide,
    'arctan2': _promote_int(torch.atan2), 'hypot': _promote_int(torch.hypot),
    'copysign': _promote_int(torch.copysign), 'ldexp': _ldexp,
    'lcm': torch.lcm, 'gcd': torch.gcd,
    'bitwise_and': torch.bitwise_and, 'bitwise_or': torch.bitwise_or,
    'bitwise_xor': torch.bitwise_xor,
    'bitwise_left_shift': torch.bitwise_left_shift,
    'bitwise_right_shift': torch.bitwise_right_shift,
    'maximum': torch.maximum, 'minimum': torch.minimum,
    'fmax': torch.fmax, 'fmin': torch.fmin, 'fmod': torch.fmod,
}
_LOGIC = {
    'equal': torch.eq, 'not_equal': torch.ne, 'greater': torch.gt,
    'greater_equal': torch.ge, 'less': torch.lt, 'less_equal': torch.le,
    'logical_and': torch.logical_and, 'logical_or': torch.logical_or,
    'logical_xor': torch.logical_xor,
}


def _binary(f):
    def op(lhs, rhs):
        return f(*_pair(lhs, rhs))
    return op


def _with_scalar(f, default):
    def op(data, scalar=default):
        return f(*_pair(data, scalar))
    return op


def _reflected(f):
    def op(data, scalar=1.0):
        return f(*_pair(scalar, data))
    return op


for _n, _f in _BINARY.items():
    _reg(f'_npi_{_n}')(_binary(_f))
    _reg(f'_npi_{_n}_scalar')(_with_scalar(_f, 1.0))
for _n in ('subtract', 'mod', 'power', 'true_divide', 'floor_divide',
           'arctan2', 'copysign', 'ldexp'):
    _reg(f'_npi_r{_n}_scalar')(_reflected(_BINARY[_n]))
for _n, _f in _LOGIC.items():
    _reg(f'_npi_{_n}', nograd=True)(_binary(_f))
    _reg(f'_npi_{_n}_scalar', nograd=True)(_with_scalar(_f, 0.0))


# --- elemwise unary (ref: np_elemwise_unary_op_basic.cc) -------------------

def _on_float(f):
    return lambda x: f(_float(x))


def _keep_int(f):
    """Rounding functions: an integer array is returned as it is."""
    return lambda x: f(x) if x.is_floating_point() else x


_UNARY = {
    'abs': torch.abs, 'absolute': torch.abs, 'negative': torch.neg,
    'reciprocal': _on_float(torch.reciprocal), 'sign': torch.sign,
    'rint': _on_float(torch.round), 'ceil': _keep_int(torch.ceil),
    'floor': _keep_int(torch.floor), 'trunc': _keep_int(torch.trunc),
    'fix': _keep_int(torch.trunc), 'square': torch.square,
    'sqrt': _on_float(torch.sqrt),
    'cbrt': _on_float(lambda x: torch.sign(x) * torch.abs(x) ** (1.0 / 3)),
    'exp': _on_float(torch.exp), 'expm1': _on_float(torch.expm1),
    'log': _on_float(torch.log), 'log2': _on_float(torch.log2),
    'log10': _on_float(torch.log10), 'log1p': _on_float(torch.log1p),
    'degrees': _on_float(torch.rad2deg), 'radians': _on_float(torch.deg2rad),
    'deg2rad': _on_float(torch.deg2rad), 'rad2deg': _on_float(torch.rad2deg),
    'sin': _on_float(torch.sin), 'cos': _on_float(torch.cos),
    'tan': _on_float(torch.tan), 'arcsin': _on_float(torch.asin),
    'arccos': _on_float(torch.acos), 'arctan': _on_float(torch.atan),
    'sinh': _on_float(torch.sinh), 'cosh': _on_float(torch.cosh),
    'tanh': _on_float(torch.tanh), 'arcsinh': _on_float(torch.asinh),
    'arccosh': _on_float(torch.acosh), 'arctanh': _on_float(torch.atanh),
    'invert': torch.bitwise_not, 'bitwise_not': torch.bitwise_not,
    'exp2': _on_float(torch.exp2), 'positive': torch.positive,
    'conjugate': torch.conj,
}
for _n, _f in _UNARY.items():
    _reg(f'_npi_{_n}')(lambda data, _f=_f: _f(data))
_reg('_npi_logical_not', nograd=True)(lambda data: torch.logical_not(data))
for _n, _f in (('isnan', torch.isnan), ('isinf', torch.isinf),
               ('isfinite', torch.isfinite), ('isposinf', torch.isposinf),
               ('isneginf', torch.isneginf)):
    _reg(f'_npi_{_n}', nograd=True)(lambda data, _f=_f: _f(data))


@_reg('_npi_around')
def _npi_around(data, decimals=0):
    if not data.is_floating_point():
        return data
    return torch.round(data, decimals=decimals)


@_reg('_npi_nan_to_num')
def _npi_nan_to_num(data, copy=True, nan=0.0, posinf=None, neginf=None):
    if not data.is_floating_point():
        return data
    return torch.nan_to_num(data, nan=nan, posinf=posinf, neginf=neginf)


@_reg('_np_copy')
def _np_copy(a):
    return a.clone()


# --- reductions (ref: np_broadcast_reduce_op_value.cc, *_index.cc) --------

def _reduced(a, fn, axis, keepdims, identity, initial, where):
    dims = _axes(axis, a.dim())
    if where is not None:
        a = torch.where(where.to(torch.bool), a,
                        torch.as_tensor(identity, dtype=a.dtype,
                                        device=a.device))
    out = fn(a, dims, keepdims) if a.dim() else a
    if initial is not None:
        out = out + initial if fn is _sum else \
            out * initial if fn is _prod else \
            torch.maximum(out, torch.as_tensor(initial, dtype=out.dtype,
                                               device=out.device)) \
            if fn is _amax else torch.minimum(out, torch.as_tensor(
                initial, dtype=out.dtype, device=out.device))
    return out


def _sum(a, dims, keepdims):
    return torch.sum(a, dim=dims, keepdim=keepdims)


def _prod(a, dims, keepdims):
    out = a
    for d in sorted(dims, reverse=True):
        out = torch.prod(out, dim=d, keepdim=keepdims)
    return out


def _amax(a, dims, keepdims):
    return torch.amax(a, dim=dims, keepdim=keepdims)


def _amin(a, dims, keepdims):
    return torch.amin(a, dim=dims, keepdim=keepdims)


def _red(name, fn, identity, nograd=False):
    @_reg(name, nograd=nograd)
    def op(a, axis=None, dtype=None, keepdims=False, initial=None,
           where=None):
        if dtype is not None:
            a = a.to(torch_dtype(dtype))
        return _reduced(a, fn, axis, keepdims, identity, initial, where)
    return op


_red('_np_sum', _sum, 0)
_red('_np_prod', _prod, 1)
_red('_np_max', _amax, -math.inf)
_red('_np_min', _amin, math.inf)
_red('_np_any', lambda a, d, k: torch.any(a.to(torch.bool), dim=d,
                                          keepdim=k), False, nograd=True)
_red('_np_all', lambda a, d, k: torch.all(a.to(torch.bool), dim=d,
                                          keepdim=k), True, nograd=True)


@_reg('_npi_mean')
def _npi_mean(a, axis=None, dtype=None, keepdims=False):
    a = a.to(torch_dtype(dtype)) if dtype is not None else _float(a)
    return torch.mean(a, dim=_axes(axis, a.dim()), keepdim=keepdims)


@_reg('_npi_std')
def _npi_std(a, axis=None, dtype=None, ddof=0, keepdims=False):
    a = a.to(torch_dtype(dtype)) if dtype is not None else _float(a)
    return torch.std(a, dim=_axes(axis, a.dim()), correction=ddof,
                     keepdim=keepdims)


@_reg('_npi_var')
def _npi_var(a, axis=None, dtype=None, ddof=0, keepdims=False):
    a = a.to(torch_dtype(dtype)) if dtype is not None else _float(a)
    return torch.var(a, dim=_axes(axis, a.dim()), correction=ddof,
                     keepdim=keepdims)


@_reg('_npi_average')
def _npi_average(a, axis=None, weights=None, returned=False):
    a = _float(a)
    dims = _axes(axis, a.dim())
    if weights is None:
        avg = torch.mean(a, dim=dims)
        scl = torch.tensor(float(a.numel() if axis is None
                                 else a.shape[axis]), device=a.device)
    else:
        scl = torch.sum(weights, dim=dims)
        avg = torch.sum(a * weights, dim=dims) / scl
    if returned:
        return avg, torch.broadcast_to(scl, avg.shape)
    return avg


@_reg('_npi_norm')
def _npi_norm(a, ord=2, axis=None, keepdims=False, flag=0):
    return torch.linalg.norm(_float(a), ord=None if flag == 0 else ord,
                             dim=axis, keepdim=keepdims)


def _arg(fn):
    def op(a, axis=None, keepdims=False):
        if axis is None:
            return fn(a.reshape(-1))
        out = fn(a, dim=axis)
        return out.unsqueeze(axis) if keepdims else out
    return op


_reg('_npi_argmax', nograd=True)(_arg(torch.argmax))
_reg('_npi_argmin', nograd=True)(_arg(torch.argmin))


def _quantile(a, q, axis, interpolation, keepdims):
    a = _float(a)
    q = torch.as_tensor(q, dtype=a.dtype, device=a.device)
    if axis is not None and not isinstance(axis, int):
        dims = _axes(axis, a.dim())
        rest = [d for d in range(a.dim()) if d not in dims]
        moved = a.permute(rest + list(dims)).reshape(
            [a.shape[d] for d in rest] + [-1])
        out = torch.quantile(moved, q, dim=-1, interpolation=interpolation)
        if keepdims:
            shape = list(out.shape[:q.dim()]) + [
                1 if d in dims else a.shape[d] for d in range(a.dim())]
            out = out.reshape(shape)
        return out
    return torch.quantile(a, q, dim=axis, keepdim=keepdims,
                          interpolation=interpolation)


@_reg('_npi_percentile')
def _npi_percentile(a, q, axis=None, interpolation='linear',
                    keepdims=False):
    q = torch.as_tensor(q, dtype=torch.float32, device=a.device) / 100.0
    return _quantile(a, q, axis, interpolation, keepdims)


@_reg('_npi_quantile')
def _npi_quantile(a, q, axis=None, interpolation='linear', keepdims=False):
    return _quantile(a, q, axis, interpolation, keepdims)


@_reg('_np_cumsum')
def _np_cumsum(a, axis=None, dtype=None):
    if axis is None:
        a, axis = a.reshape(-1), 0
    return torch.cumsum(a, dim=axis,
                        dtype=None if dtype is None else torch_dtype(dtype))


@_reg('_npi_diff')
def _npi_diff(a, n=1, axis=-1):
    return torch.diff(a, n=n, dim=axis)


@_reg('_npi_ediff1d')
def _npi_ediff1d(a, to_end=None, to_begin=None):
    out = torch.diff(a.reshape(-1))
    parts = [out]
    if to_begin is not None:
        parts.insert(0, torch.as_tensor(to_begin, dtype=out.dtype,
                                        device=out.device).reshape(-1))
    if to_end is not None:
        parts.append(torch.as_tensor(to_end, dtype=out.dtype,
                                     device=out.device).reshape(-1))
    return torch.cat(parts)


@_reg('_npi_bincount', nograd=True)
def _npi_bincount(a, weights=None, minlength=0):
    length = max(int(minlength), int(a.max()) + 1 if a.numel() else 1)
    out = torch.bincount(a.to(torch.int64), weights=weights,
                         minlength=length)
    return out if weights is None else out.to(weights.dtype)


# --- matrix / shape manipulation (ref: np_matrix_op.cc) --------------------

@_reg('_np_reshape')
def _np_reshape(a, newshape=None, order='C'):
    shape = _shape(newshape)
    if order == 'F':
        return a.permute(*reversed(range(a.dim()))).reshape(
            shape[::-1]).permute(*reversed(range(len(shape))))
    return a.reshape(shape)


@_reg('_np_transpose')
def _np_transpose(a, axes=None):
    return a.permute(*(reversed(range(a.dim())) if axes is None else axes))


def _squeeze(a, axis=None):
    if axis is None:
        return a.squeeze()
    return a.squeeze(_axes(axis, a.dim()))


_reg('_np_squeeze')(_squeeze)
_reg('_npi_squeeze')(_squeeze)


@_reg('_np_moveaxis')
def _np_moveaxis(a, source, destination):
    return torch.movedim(a, source, destination)


@_reg('_npi_swapaxes')
def _npi_swapaxes(a, dim1=0, dim2=1):
    return a.transpose(dim1, dim2)


@_reg('_np_roll')
def _np_roll(a, shift, axis=None):
    if axis is None:
        return torch.roll(a.reshape(-1), shift).reshape(a.shape)
    return torch.roll(a, shift, axis)


@_reg('_npi_flip')
def _npi_flip(a, axis=None):
    return a.flip(_axes(axis, a.dim()))


@_reg('_npi_rot90')
def _npi_rot90(a, k=1, axes=(0, 1)):
    return torch.rot90(a, k, tuple(axes))


@_reg('_npi_broadcast_to')
def _npi_broadcast_to(a, shape=()):
    return torch.broadcast_to(a, _shape(shape))


@_reg('_npi_expand_dims')
def _npi_expand_dims(a, axis=0):
    return a.unsqueeze(axis)


@_reg('_npi_concatenate')
def _npi_concatenate(*data, axis=0):
    if axis is None:
        return torch.cat([d.reshape(-1) for d in data])
    return torch.cat(data, dim=axis)


@_reg('_npi_stack')
def _npi_stack(*data, axis=0):
    return torch.stack(data, dim=axis)


_reg('_npi_vstack')(lambda *data: torch.vstack(data))
_reg('_npi_hstack')(lambda *data: torch.hstack(data))
_reg('_npi_dstack')(lambda *data: torch.dstack(data))
_reg('_npi_column_stack')(lambda *data: torch.column_stack(data))


def _split(ary, ios, axis, equal):
    if isinstance(ios, (int, onp.integer)):
        if equal and ary.shape[axis] % int(ios):
            raise ValueError("array split does not result in an equal "
                             "division")
        return tuple(torch.tensor_split(ary, int(ios), dim=axis))
    return tuple(torch.tensor_split(ary, [int(i) for i in ios], dim=axis))


@_reg('_npi_split', num_outputs=-1)
def _npi_split(ary, indices_or_sections=1, axis=0):
    return _split(ary, indices_or_sections, axis, True)


@_reg('_npi_hsplit', num_outputs=-1)
def _npi_hsplit(ary, indices_or_sections=1):
    return _split(ary, indices_or_sections, 1 if ary.dim() > 1 else 0, True)


@_reg('_npi_vsplit', num_outputs=-1)
def _npi_vsplit(ary, indices_or_sections=1):
    return _split(ary, indices_or_sections, 0, True)


@_reg('_npi_dsplit', num_outputs=-1)
def _npi_dsplit(ary, indices_or_sections=1):
    return _split(ary, indices_or_sections, 2, True)


@_reg('_npi_array_split', num_outputs=-1)
def _npi_array_split(ary, indices_or_sections=1, axis=0):
    return _split(ary, indices_or_sections, axis, False)


def _atleast(fn):
    def op(*arys):
        out = fn(*arys)
        return tuple(out) if isinstance(out, (list, tuple)) else (out,)
    return op


_reg('_np_atleast_1d', num_outputs=-1)(_atleast(torch.atleast_1d))
_reg('_np_atleast_2d', num_outputs=-1)(_atleast(torch.atleast_2d))
_reg('_np_atleast_3d', num_outputs=-1)(_atleast(torch.atleast_3d))


@_reg('_np_diag')
def _np_diag(v, k=0):
    return torch.diag(v, k)


@_reg('_np_diagflat')
def _np_diagflat(v, k=0):
    return torch.diagflat(v, k)


@_reg('_np_diagonal')
def _np_diagonal(a, offset=0, axis1=0, axis2=1):
    return torch.diagonal(a, offset, axis1, axis2)


@_reg('_np_trace')
def _np_trace(a, offset=0, axis1=0, axis2=1):
    return torch.diagonal(a, offset, axis1, axis2).sum(-1)


@_reg('_npi_tril')
def _npi_tril(m, k=0):
    return torch.tril(m, k)


@_reg('_npi_triu')
def _npi_triu(m, k=0):
    return torch.triu(m, k)


@_reg('_npi_diag_indices_from', nograd=True)
def _npi_diag_indices_from(a):
    idx = torch.arange(a.shape[0], dtype=torch.int32, device=a.device)
    return tuple(idx for _ in range(a.dim()))


@_reg('_npi_pad')
def _npi_pad(a, pad_width, mode='constant', constant_values=0, **kwargs):
    pw = [tuple(int(x) for x in p) for p in pad_width]
    if mode == 'constant':
        flat = [x for p in reversed(pw) for x in p]
        return F.pad(a, flat, value=constant_values)
    out = a
    for axis, (before, after) in enumerate(pw):
        idx = onp.pad(onp.arange(a.shape[axis]), (before, after), mode=mode)
        out = out.index_select(axis, torch.as_tensor(idx, device=a.device))
    return out


@_reg('_npi_tile')
def _npi_tile(a, reps=(1,)):
    return torch.tile(a, _shape(reps))


@_reg('_npi_repeat')
def _npi_repeat(a, repeats=1, axis=None):
    if axis is None:
        return torch.repeat_interleave(a.reshape(-1), repeats)
    return torch.repeat_interleave(a, repeats, dim=axis)


@_reg('_npi_ravel')
def _npi_ravel(a, order='C'):
    if order == 'F':
        return a.permute(*reversed(range(a.dim()))).reshape(-1)
    return a.reshape(-1)


@_reg('_npi_share_memory', nograd=True)
def _npi_share_memory(a, b):
    # arrays are values: no two ever alias from the user's side
    return torch.zeros((), dtype=torch.bool, device=a.device)


def _insert(arr, obj, values, axis):
    """numpy.insert: numpy lays out the index of the result along the
    axis (-1 marks a new slot); the tensors are then copied into it."""
    if axis is None:
        arr, axis = arr.reshape(-1), 0
    vals = torch.as_tensor(values, dtype=arr.dtype, device=arr.device)
    scalar_obj = onp.ndim(obj) == 0
    if scalar_obj:
        while vals.dim() < arr.dim():
            vals = vals.unsqueeze(0)
        vals = vals.movedim(0, axis) if vals.dim() else vals
        numnew = vals.shape[axis] if vals.dim() else 1
        layout = onp.insert(onp.arange(arr.shape[axis]), int(obj),
                            onp.full(numnew, -1))
    else:
        obj = onp.asarray(obj)
        numnew = obj.size
        layout = onp.insert(onp.arange(arr.shape[axis]), obj, -1)
    shape = list(arr.shape)
    shape[axis] = numnew
    vals = torch.broadcast_to(vals, shape)
    out_shape = list(arr.shape)
    out_shape[axis] += numnew
    out = torch.empty(out_shape, dtype=arr.dtype, device=arr.device)
    old = torch.as_tensor(onp.nonzero(layout >= 0)[0], device=arr.device)
    new = torch.as_tensor(onp.nonzero(layout < 0)[0], device=arr.device)
    out.index_copy_(axis, old, arr)
    out.index_copy_(axis, new, vals)
    return out


@_reg('_npi_insert_scalar')
def _npi_insert_scalar(arr, obj=0, values=0.0, axis=None):
    return _insert(arr, int(obj), values, axis)


@_reg('_npi_insert_slice')
def _npi_insert_slice(arr, values, start=None, stop=None, step=None,
                      axis=None):
    n = arr.shape[axis] if axis is not None else arr.numel()
    return _insert(arr, onp.arange(*slice(start, stop, step).indices(n)),
                   values, axis)


@_reg('_npi_insert_tensor')
def _npi_insert_tensor(arr, obj, values, axis=None):
    return _insert(arr, obj.cpu().numpy(), values, axis)


@_reg('_npi_delete', nograd=True)
def _npi_delete(arr, obj=None, start=None, stop=None, step=None, axis=None):
    if axis is None:
        arr, axis = arr.reshape(-1), 0
    n = arr.shape[axis]
    if obj is None:
        obj = onp.arange(*slice(start, stop, step).indices(n))
    elif isinstance(obj, torch.Tensor):
        obj = obj.cpu().numpy()
    else:
        obj = int(obj)
    keep = onp.delete(onp.arange(n), obj)
    return arr.index_select(axis, torch.as_tensor(keep, device=arr.device))


@_reg('_npi_unique', nograd=True, num_outputs=-1)
def _npi_unique(a, return_index=False, return_inverse=False,
                return_counts=False, axis=None):
    src = a.reshape(-1) if axis is None else a
    dim = 0 if axis is None else axis
    vals, inverse, counts = torch.unique(src, sorted=True,
                                         return_inverse=True,
                                         return_counts=True, dim=dim)
    out = [vals]
    if return_index:
        pos = torch.arange(src.shape[dim], device=a.device)
        first = torch.full((vals.shape[dim],), src.shape[dim],
                           dtype=pos.dtype, device=a.device)
        out.append(first.scatter_reduce(0, inverse, pos, 'amin'))
    if return_inverse:
        out.append(inverse)
    if return_counts:
        out.append(counts)
    return tuple(out)


@_reg('_npi_nonzero', nograd=True)
def _npi_nonzero(a):
    """(ndim, nnz) index tensor, as the reference's np_nonzero_op.cc."""
    return torch.nonzero(a).t()


@_reg('_npi_flatnonzero', nograd=True)
def _npi_flatnonzero(a):
    return torch.nonzero(a.reshape(-1)).reshape(-1)


@_reg('_npi_searchsorted', nograd=True)
def _npi_searchsorted(a, v, side='left'):
    return torch.searchsorted(a, v, right=side == 'right')


def _where(c, x, y):
    x, y = _pair(x, y)
    return torch.where(c.to(torch.bool), x, y)


_reg('_npi_where')(lambda condition, x, y: _where(condition, x, y))
_reg('_npi_where_lscalar')(
    lambda condition, y, scalar=0.0: _where(condition, scalar, y))
_reg('_npi_where_rscalar')(
    lambda condition, x, scalar=0.0: _where(condition, x, scalar))


@_reg('_npi_where_scalar2')
def _npi_where_scalar2(condition, x=0.0, y=0.0):
    dev = condition.device
    x, y = _scalar(x, dev), _scalar(y, dev)
    return torch.where(condition.to(torch.bool), x, y)


@_reg('_npi_boolean_mask_assign_scalar')
def _npi_boolean_mask_assign_scalar(data, mask, value=0.0):
    return torch.where(mask.to(torch.bool),
                       torch.as_tensor(value, dtype=data.dtype,
                                       device=data.device), data)


@_reg('_npi_boolean_mask_assign_tensor')
def _npi_boolean_mask_assign_tensor(data, mask, value):
    m = mask.to(torch.bool)
    if value.dim() == data.dim():
        return torch.where(m, value, data)
    # values packed for the True positions, row-major, as the reference
    idx = torch.cumsum(m.reshape(-1).to(torch.int64), 0) - 1
    picked = value.reshape(-1)[idx.clamp(0, value.numel() - 1)]
    return torch.where(m, picked.reshape(data.shape), data)


@_reg('_npi_polyval')
def _npi_polyval(p, x):
    y = torch.zeros_like(x, dtype=torch.promote_types(p.dtype, x.dtype))
    for i in range(p.shape[0]):
        y = y * x + p[i]
    return y


@_reg('_npi_constraint_check', nograd=True)
def _npi_constraint_check(data, msg="constraint violated"):
    """Raises when any element is False (a sync on the card)."""
    if not bool(torch.all(data)):
        raise ValueError(msg)
    return torch.ones((), dtype=torch.bool, device=data.device)


# --- products (ref: np_tensordot_op.cc, np_matmul_op.cc, np_einsum_op.cc) --

_reg('_npi_matmul')(lambda a, b: torch.matmul(a, b))


@_reg('_np_dot')
def _np_dot(a, b):
    if a.dim() == 0 or b.dim() == 0:
        return a * b
    return torch.tensordot(a, b, dims=([-1], [0 if b.dim() == 1 else -2]))


@_reg('_npi_tensordot')
def _npi_tensordot(a, b, a_axes_summed=(), b_axes_summed=()):
    return torch.tensordot(a, b, dims=(list(a_axes_summed),
                                       list(b_axes_summed)))


@_reg('_npi_tensordot_int_axes')
def _npi_tensordot_int_axes(a, b, axes=2):
    return torch.tensordot(a, b, dims=int(axes))


_reg('_npi_kron')(lambda a, b: torch.kron(a, b))


@_reg('_npi_einsum')
def _npi_einsum(*operands, subscripts='', optimize=False):
    return torch.einsum(subscripts, *operands)


@_reg('_npi_cross')
def _npi_cross(a, b, axisa=-1, axisb=-1, axisc=-1):
    a = torch.movedim(a, axisa, -1)
    b = torch.movedim(b, axisb, -1)
    a, b = torch.broadcast_tensors(a, b)
    return torch.movedim(torch.linalg.cross(a, b, dim=-1), -1, axisc)


@_reg('_npi_vdot')
def _npi_vdot(a, b):
    return torch.sum(torch.conj(a.reshape(-1)) * b.reshape(-1))


_reg('_npi_inner')(lambda a, b: torch.inner(a, b))
_reg('_npi_outer')(lambda a, b: torch.outer(a.reshape(-1), b.reshape(-1)))


# --- linalg (ref: src/operator/numpy/linalg/np_*.cc) -----------------------

@_reg('_npi_cholesky')
def _npi_cholesky(a, lower=True):
    L = torch.linalg.cholesky(a)
    return L if lower else L.transpose(-1, -2)


@_reg('_npi_svd', num_outputs=3)
def _npi_svd(a):
    u, s, vh = torch.linalg.svd(a, full_matrices=False)
    return u, s, vh


@_reg('_npi_eig', num_outputs=2, nograd=True)
def _npi_eig(a):
    w, v = torch.linalg.eig(a)
    return w, v


@_reg('_npi_eigh', num_outputs=2)
def _npi_eigh(a, upper=False):
    w, v = torch.linalg.eigh(a, UPLO='U' if upper else 'L')
    return w, v


_reg('_npi_eigvals', nograd=True)(lambda a: torch.linalg.eigvals(a))


@_reg('_npi_eigvalsh')
def _npi_eigvalsh(a, upper=False):
    return torch.linalg.eigvalsh(a, UPLO='U' if upper else 'L')


_reg('_npi_solve')(lambda a, b: torch.linalg.solve(a, b))


@_reg('_npi_lstsq', num_outputs=4, nograd=True)
def _npi_lstsq(a, b, rcond=None):
    """jnp.linalg.lstsq's SVD solve: (x, residuals (always the full
    sum of squares per column of b), rank, singular values)."""
    m, n = a.shape[-2], a.shape[-1]
    if rcond is None:
        rcond = torch.finfo(a.dtype).eps * max(n, m)
    b2 = b if b.dim() == 2 else b[:, None]
    u, s, vt = torch.linalg.svd(a, full_matrices=False)
    mask = (s > 0) & (s >= rcond * s[0])
    safe_s = torch.where(mask, s, torch.ones_like(s))
    s_inv = torch.where(mask, 1 / safe_s, torch.zeros_like(s))[:, None]
    x = vt.conj().t() @ (s_inv * (u.conj().t() @ b2))
    resid = torch.linalg.vector_norm(b2 - a @ x, dim=0) ** 2
    if b.dim() == 1:
        x = x.reshape(-1)
    return x, resid, mask.sum(), s


_reg('_npi_inv')(lambda a: torch.linalg.inv(a))


@_reg('_npi_pinv')
def _npi_pinv(a, rcond):
    return torch.linalg.pinv(a, rtol=rcond)


@_reg('_npi_pinv_scalar_rcond')
def _npi_pinv_scalar_rcond(a, rcond=1e-15):
    return torch.linalg.pinv(a, rtol=rcond)


@_reg('_npi_tensorinv')
def _npi_tensorinv(a, ind=2):
    return torch.linalg.tensorinv(a, ind=ind)


@_reg('_npi_tensorsolve')
def _npi_tensorsolve(a, b, a_axes=None):
    return torch.linalg.tensorsolve(a, b, dims=a_axes)


@_reg('_npi_matrix_rank', nograd=True)
def _npi_matrix_rank(M, tol=None, hermitian=False):
    return torch.linalg.matrix_rank(M, rtol=tol)


_reg('_npi_det')(lambda a: torch.linalg.det(a))


@_reg('_npi_slogdet', num_outputs=2)
def _npi_slogdet(a):
    sign, logdet = torch.linalg.slogdet(a)
    return sign, logdet


@_reg('_npi_qr', num_outputs=2)
def _npi_qr(a):
    q, r = torch.linalg.qr(a)
    return q, r


_reg('_npi_multi_dot')(lambda *arrays: torch.linalg.multi_dot(arrays))


@_reg('_npi_matrix_power')
def _npi_matrix_power(a, n=1):
    return torch.linalg.matrix_power(a, n)


# --- creation (ref: np_init_op.cc) and windows (np_window_op.cc) -----------

@_reg('_npi_zeros', nograd=True)
def _npi_zeros(shape=(), dtype='float32', ctx=None):
    return torch.zeros(_shape(shape), dtype=_dt(dtype), device=_device(ctx))


@_reg('_npi_ones', nograd=True)
def _npi_ones(shape=(), dtype='float32', ctx=None):
    return torch.ones(_shape(shape), dtype=_dt(dtype), device=_device(ctx))


@_reg('_npi_full', nograd=True)
def _npi_full(shape=(), fill_value=0.0, dtype=None, ctx=None):
    return torch.full(_shape(shape), fill_value, dtype=_dt(dtype),
                      device=_device(ctx))


@_reg('_npi_full_like', nograd=True)
def _npi_full_like(a, fill_value=0.0, dtype=None):
    return torch.full_like(a, fill_value,
                           dtype=None if dtype is None else _dt(dtype))


@_reg('_npi_arange', nograd=True)
def _npi_arange(start=0, stop=None, step=1, dtype='float32', ctx=None):
    if stop is None:
        start, stop = 0, start
    return torch.arange(start, stop, step, dtype=_dt(dtype),
                        device=_device(ctx))


def _linspace(start, stop, num, endpoint, device):
    div = (num - 1) if endpoint else num
    i = torch.arange(num, dtype=torch.float64, device=device)
    out = start + i * ((stop - start) / div) if div > 0 else \
        torch.full((num,), float(start), dtype=torch.float64, device=device)
    if endpoint and num > 1:
        out[-1] = stop
    return out


@_reg('_npi_linspace', nograd=True)
def _npi_linspace(start=0.0, stop=1.0, num=50, endpoint=True,
                  dtype='float32', ctx=None):
    return _linspace(start, stop, int(num), endpoint,
                     _device(ctx)).to(_dt(dtype))


@_reg('_npi_logspace', nograd=True)
def _npi_logspace(start=0.0, stop=1.0, num=50, endpoint=True, base=10.0,
                  dtype='float32', ctx=None):
    lin = _linspace(start, stop, int(num), endpoint, _device(ctx))
    return torch.pow(base, lin).to(_dt(dtype))


@_reg('_npi_eye', nograd=True)
def _npi_eye(N=1, M=None, k=0, dtype='float32', ctx=None):
    N = int(N)
    M = N if M is None else int(M)
    dev = _device(ctx)
    return (torch.arange(M, device=dev)[None, :]
            - torch.arange(N, device=dev)[:, None] == int(k)).to(_dt(dtype))


@_reg('_npi_identity', nograd=True)
def _npi_identity(n=1, dtype='float32', ctx=None):
    return torch.eye(int(n), dtype=_dt(dtype), device=_device(ctx))


@_reg('_npi_indices', nograd=True)
def _npi_indices(dimensions=(), dtype='int32', ctx=None):
    dims = _shape(dimensions)
    grids = torch.meshgrid(*[torch.arange(d, device=_device(ctx))
                             for d in dims], indexing='ij')
    return torch.stack(grids).to(_dt(dtype, 'int32')) if dims else \
        torch.zeros((0,), dtype=_dt(dtype, 'int32'), device=_device(ctx))


@_reg('_npi_tri', nograd=True)
def _npi_tri(N=1, M=None, k=0, dtype='float32', ctx=None):
    N = int(N)
    M = N if M is None else int(M)
    dev = _device(ctx)
    return (torch.arange(M, device=dev)[None, :]
            <= torch.arange(N, device=dev)[:, None] + int(k)).to(_dt(dtype))


def _window(name, coeffs):
    @_reg(f'_npi_{name}', nograd=True)
    def op(M=1, dtype='float32', ctx=None):
        M = int(M)
        dev = _device(ctx)
        if M < 1:
            return torch.zeros((0,), dtype=_dt(dtype), device=dev)
        if M == 1:
            return torch.ones((1,), dtype=_dt(dtype), device=dev)
        n = torch.arange(M, dtype=torch.float64, device=dev)
        out = torch.zeros(M, dtype=torch.float64, device=dev)
        for j, c in enumerate(coeffs):
            out = out + c * torch.cos(2.0 * math.pi * j * n / (M - 1))
        return out.to(_dt(dtype))
    return op


_window('hanning', (0.5, -0.5))
_window('hamming', (0.54, -0.46))
_window('blackman', (0.42, -0.5, 0.08))


@_reg('_npi_meshgrid', num_outputs=-1, nograd=True)
def _npi_meshgrid(*xi, indexing='xy'):
    return tuple(torch.meshgrid(*[x.reshape(-1) for x in xi],
                                indexing=indexing))


# --- random samplers (ref: src/operator/numpy/random/np_*_op.cc) -----------

def _place(params, ctx):
    for p in params:
        if isinstance(p, torch.Tensor):
            return p.device
    return _device(ctx)


def _sample_shape(size, *params):
    if size is not None:
        return _shape(size)
    shp = ()
    for p in params:
        if isinstance(p, torch.Tensor):
            shp = torch.broadcast_shapes(shp, p.shape)
    return tuple(shp)


@_reg('_npi_uniform', nograd=True)
def _npi_uniform(low=0.0, high=1.0, size=None, dtype='float32', ctx=None):
    d = _place((low, high), ctx)
    u = _r.uniform(_sample_shape(size, low, high), d, _dt(dtype))
    return low + u * (high - low)


@_reg('_npi_normal', nograd=True)
def _npi_normal(loc=0.0, scale=1.0, size=None, dtype='float32', ctx=None):
    d = _place((loc, scale), ctx)
    return loc + scale * _r.normal(_sample_shape(size, loc, scale), d,
                                   _dt(dtype))


@_reg('_npi_gamma', nograd=True)
def _npi_gamma(shape=1.0, scale=1.0, size=None, dtype='float32', ctx=None):
    d = _place((shape, scale), ctx)
    return (scale * _r.gamma(shape, _sample_shape(size, shape, scale),
                             d)).to(_dt(dtype))


@_reg('_npi_bernoulli', nograd=True)
def _npi_bernoulli(prob=0.5, size=None, dtype='float32', ctx=None):
    d = _place((prob,), ctx)
    u = _r.uniform(_sample_shape(size, prob), d)
    return (u < prob).to(_dt(dtype))


@_reg('_npi_exponential', nograd=True)
def _npi_exponential(scale=1.0, size=None, dtype='float32', ctx=None):
    d = _place((scale,), ctx)
    return scale * _r.exponential(_sample_shape(size, scale), d, _dt(dtype))


def _open_uniform(shape, d, dtype):
    """U(0, 1) kept at or above 1e-7, as the JAX samplers' minval."""
    return torch.clamp(_r.uniform(shape, d, dtype), min=1e-7)


@_reg('_npi_gumbel', nograd=True)
def _npi_gumbel(loc=0.0, scale=1.0, size=None, dtype='float32', ctx=None):
    d = _place((loc, scale), ctx)
    u = _open_uniform(_sample_shape(size, loc, scale), d, _dt(dtype))
    return loc + scale * -torch.log(-torch.log(u))


@_reg('_npi_logistic', nograd=True)
def _npi_logistic(loc=0.0, scale=1.0, size=None, dtype='float32', ctx=None):
    d = _place((loc, scale), ctx)
    u = _open_uniform(_sample_shape(size, loc, scale), d, _dt(dtype))
    return loc + scale * (torch.log(u) - torch.log1p(-u))


@_reg('_npi_laplace', nograd=True)
def _npi_laplace(loc=0.0, scale=1.0, size=None, dtype='float32', ctx=None):
    d = _place((loc, scale), ctx)
    u = _r.uniform(_sample_shape(size, loc, scale), d, _dt(dtype)) * 2 - 1
    u = torch.clamp(u, -1 + 1e-7, 1 - 1e-7)
    return loc - scale * torch.sign(u) * torch.log1p(-torch.abs(u))


@_reg('_npi_rayleigh', nograd=True)
def _npi_rayleigh(scale=1.0, size=None, dtype='float32', ctx=None):
    d = _place((scale,), ctx)
    u = _open_uniform(_sample_shape(size, scale), d, _dt(dtype))
    return scale * torch.sqrt(-2.0 * torch.log(u))


@_reg('_npi_weibull', nograd=True)
def _npi_weibull(a=1.0, size=None, dtype='float32', ctx=None):
    d = _place((a,), ctx)
    u = _open_uniform(_sample_shape(size, a), d, _dt(dtype))
    return torch.pow(-torch.log(u), 1.0 / a)


@_reg('_npi_pareto', nograd=True)
def _npi_pareto(a=1.0, size=None, dtype='float32', ctx=None):
    d = _place((a,), ctx)
    u = _open_uniform(_sample_shape(size, a), d, _dt(dtype))
    return torch.pow(u, -1.0 / a) - 1.0


@_reg('_npi_powerd', nograd=True)
def _npi_powerd(a=1.0, size=None, dtype='float32', ctx=None):
    d = _place((a,), ctx)
    u = _open_uniform(_sample_shape(size, a), d, _dt(dtype))
    return torch.pow(u, 1.0 / a)


@_reg('_npi_multinomial', nograd=True)
def _npi_multinomial(n=1, pvals=None, size=None, ctx=None):
    """Counts of n draws from pvals, per row of ``size``; int32."""
    d = _place((pvals,), ctx)
    pv = torch.as_tensor(pvals, dtype=torch.float32, device=d)
    shp = () if size is None else _shape(size)
    rows = torch.broadcast_to(pv, shp + tuple(pv.shape)).reshape(
        -1, pv.shape[-1])
    draws = torch.multinomial(rows, int(n), replacement=True,
                              generator=_r._gen(d))
    counts = F.one_hot(draws, pv.shape[-1]).sum(1)
    return counts.reshape(shp + tuple(pv.shape)).to(torch.int32)


@_reg('_npi_choice', nograd=True)
def _npi_choice(a, size=None, replace=True, p=None, ctx=None):
    if not isinstance(a, torch.Tensor) or a.dim() == 0:
        a = torch.arange(int(a), dtype=torch.int32, device=_device(ctx))
    shp = () if size is None else _shape(size)
    k = int(onp.prod(shp)) if shp else 1
    g = _r._gen(a.device)
    if p is not None:
        probs = torch.as_tensor(p, dtype=torch.float32, device=a.device)
        idx = torch.multinomial(probs, k, replacement=replace, generator=g)
    elif replace:
        idx = torch.randint(0, a.shape[0], (k,), generator=g,
                            device=a.device)
    else:
        idx = torch.randperm(a.shape[0], generator=g, device=a.device)[:k]
    return a[idx].reshape(shp + tuple(a.shape[1:]))


@_reg('_npi_shuffle', nograd=True)
def _npi_shuffle(a):
    return _r.shuffle(a)


@_reg('_npi_randint', nograd=True)
def _npi_randint(low=0, high=None, size=None, dtype='int32', ctx=None):
    if high is None:
        low, high = 0, low
    d = _device(ctx)
    shp = () if size is None else _shape(size)
    return torch.randint(int(low), int(high), shp, generator=_r._gen(d),
                         device=d, dtype=_dt(dtype, 'int32'))
