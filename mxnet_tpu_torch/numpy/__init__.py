"""``mx.np``: the NumPy-compatible frontend (counterpart of
``mxnet_tpu/numpy/__init__.py``, ref: python/mxnet/numpy/multiarray.py).

``ndarray`` is an NDArray with numpy semantics: true 0-dim results,
numpy broadcasting and the JAX package's dtypes (64-bit types off: a
Python int list gives int32, argmax int32, the sum of a bool array
int32; ``ops/numpy_ops.py``). Arrays live on ``ctx`` or the current
context, the card by default. Each function dispatches through the
registered ``_npi_*``/``_np_*`` op of its name when there is one whose
calling convention is numpy's; the others are written here over torch
(numpy's conventions, the JAX package's results). As in the JAX
package, the frontend is not recorded by ``autograd``.
"""
from __future__ import annotations

import builtins as _builtins
import math as _math

import numpy as _onp
import torch

from ..base import _OP_REGISTRY, get_op as _get_op, \
    torch_dtype as _torch_dtype
from ..context import current_context as _current_context
from ..ndarray.ndarray import NDArray as _NDArray
from ..ops import numpy_ops as _nops
from ..ops import random_ops as _r


_x32 = _nops._x32
_float = _nops._float


def _wrap(out):
    if isinstance(out, torch.Tensor):
        return ndarray(_x32(out))
    if isinstance(out, tuple):
        return tuple(_wrap(o) for o in out)
    if isinstance(out, list):
        return [_wrap(o) for o in out]
    return out


def _device(ctx=None):
    return (ctx or _current_context()).device


def _as_tensor(obj, dtype=None, ctx=None):
    """obj as a tensor with the JAX package's dtypes: float64 becomes
    float32 and int64 int32 unless ``dtype`` says otherwise."""
    if isinstance(obj, _NDArray):
        t = obj._data
        return t if dtype is None else t.to(_torch_dtype(dtype))
    if isinstance(obj, torch.Tensor):
        return obj if dtype is None else obj.to(_torch_dtype(dtype))
    if isinstance(obj, (list, tuple)) and _builtins.any(
            isinstance(o, (_NDArray, torch.Tensor)) for o in obj):
        return torch.stack([_as_tensor(o, dtype, ctx) for o in obj])
    arr = _onp.asarray(obj)
    if dtype is not None:
        t = _torch_dtype(dtype)
        if t == torch.bfloat16:
            return torch.tensor(arr.astype(_onp.float32),
                                device=_device(ctx)).to(t)
        return torch.tensor(arr.astype(_onp.dtype(str(t)[6:])),
                            device=_device(ctx))
    if arr.dtype == _onp.float64:
        arr = arr.astype(_onp.float32)
    elif arr.dtype == _onp.int64:
        arr = arr.astype(_onp.int32)
    elif arr.dtype == _onp.complex128:
        arr = arr.astype(_onp.complex64)
    return torch.tensor(arr, device=_device(ctx))


def _t(x):
    """An argument as a tensor when it is array-like, else as it is."""
    if isinstance(x, _NDArray):
        return x._data
    if isinstance(x, (torch.Tensor, str)) or x is None or callable(x):
        return x
    if isinstance(x, (_builtins.bool, int, float, complex, _onp.ndarray,
                      _onp.generic, list)):
        return _as_tensor(x)
    return x


def _unwrap(x):
    if isinstance(x, _NDArray):
        return x._data
    if isinstance(x, (list, tuple)):
        return type(x)(_unwrap(i) for i in x)
    return x


class ndarray(_NDArray):
    """An NDArray with numpy semantics (ref: multiarray.py ndarray)."""
    __slots__ = ()

    def as_nd_ndarray(self):
        return _NDArray(self._data)

    def __getitem__(self, key):
        if isinstance(key, _NDArray):
            key = key._data.to(torch.int64) if not key._data.dtype == \
                torch.bool else key._data
        elif isinstance(key, tuple):
            key = tuple(k._data if isinstance(k, _NDArray) else k
                        for k in key)
        return ndarray(self._data[key])

    def __repr__(self):
        return f"array({self.asnumpy()})"

    def item(self, *args):
        return self.asnumpy().item(*args)

    @property
    def T(self):
        return ndarray(self._data.permute(*reversed(range(self.ndim))))

    def reshape(self, *shape, **kwargs):
        if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
            shape = tuple(shape[0])
        return ndarray(self._data.reshape(shape))

    def transpose(self, *axes):
        if len(axes) == 1 and isinstance(axes[0], (tuple, list)):
            axes = tuple(axes[0])
        return ndarray(self._data.permute(
            *(axes or reversed(range(self.ndim)))))

    def astype(self, dtype, copy=True):
        return ndarray(self._data.to(_torch_dtype(dtype)))

    def copy(self):
        return ndarray(self._data.clone())

    def tolist(self):
        return self.asnumpy().tolist()

    def _b(self, other, op):
        return _wrap(_get_op(op).fn(self._data, _t(other)))

    def _rb(self, other, op):
        return _wrap(_get_op(op).fn(_t(other), self._data))

    def __add__(self, o):
        return self._b(o, '_npi_add')

    def __radd__(self, o):
        return self._rb(o, '_npi_add')

    def __sub__(self, o):
        return self._b(o, '_npi_subtract')

    def __rsub__(self, o):
        return self._rb(o, '_npi_subtract')

    def __mul__(self, o):
        return self._b(o, '_npi_multiply')

    def __rmul__(self, o):
        return self._rb(o, '_npi_multiply')

    def __truediv__(self, o):
        return self._b(o, '_npi_true_divide')

    def __rtruediv__(self, o):
        return self._rb(o, '_npi_true_divide')

    def __pow__(self, o):
        return self._b(o, '_npi_power')

    def __mod__(self, o):
        return self._b(o, '_npi_mod')

    def __matmul__(self, o):
        return self._b(o, '_npi_matmul')

    def __neg__(self):
        return ndarray(-self._data)

    def __eq__(self, o):
        return False if o is None else self._b(o, '_npi_equal')

    def __ne__(self, o):
        return True if o is None else self._b(o, '_npi_not_equal')

    def __gt__(self, o):
        return self._b(o, '_npi_greater')

    def __ge__(self, o):
        return self._b(o, '_npi_greater_equal')

    def __lt__(self, o):
        return self._b(o, '_npi_less')

    def __le__(self, o):
        return self._b(o, '_npi_less_equal')

    __hash__ = object.__hash__


def array(obj, dtype=None, ctx=None):
    return ndarray(_as_tensor(obj, dtype, ctx))


def asarray(a, dtype=None):
    return array(a, dtype=dtype)


def ascontiguousarray(a, dtype=None):
    return array(a, dtype=dtype)


# functions whose first argument is a shape or a number, not an array
_CREATION = frozenset({'zeros', 'ones', 'full', 'empty', 'arange', 'eye',
                       'identity', 'indices', 'logspace', 'tril_indices',
                       'triu_indices', 'diag_indices'})
# the registered op has another convention than numpy's: written below
_OWN = frozenset({
    'where', 'insert', 'delete', 'unique', 'nonzero', 'percentile',
    'quantile', 'tensordot', 'pad', 'linspace', 'einsum', 'split',
    'hsplit', 'vsplit', 'dsplit', 'array_split', 'concatenate', 'stack',
    'vstack', 'hstack', 'dstack', 'column_stack', 'meshgrid', 'atleast_1d',
    'atleast_2d', 'atleast_3d', 'copy', 'round', 'fix'})


def _op_of(fname):
    if fname in _OWN:
        return None
    for cand in ('_npi_' + fname, '_np_' + fname):
        if cand in _OP_REGISTRY:
            return _get_op(cand).fn
    return None


def _make(fname, fn, creation=False):
    def f(*args, **kwargs):
        kwargs.pop('out', None)
        if not creation:
            kwargs.pop('ctx', None)
            if args:
                args = (_t(args[0]),) + tuple(_unwrap(a) for a in args[1:])
        else:
            args = tuple(_unwrap(a) for a in args)
        kwargs = {k: _unwrap(v) for k, v in kwargs.items()}
        return _wrap(fn(*args, **kwargs))
    f.__name__ = f.__qualname__ = fname
    return f


# --- functions written over torch (numpy's conventions) --------------------

def _nan_fill(a, v):
    return torch.where(torch.isnan(a), torch.as_tensor(v, dtype=a.dtype,
                                                       device=a.device), a)


def _sort(a, axis=-1, kind=None, order=None):
    if axis is None:
        return torch.sort(a.reshape(-1)).values
    return torch.sort(a, dim=axis, stable=True).values


def _argsort(a, axis=-1, kind=None, order=None):
    if axis is None:
        return torch.argsort(a.reshape(-1), stable=True)
    return torch.argsort(a, dim=axis, stable=True)


def _median(a, axis=None, keepdims=False):
    return _nops._quantile(a, 0.5, axis, 'linear', keepdims)


def _nanquantile_impl(a, q, axis=None, keepdims=False):
    a = _float(a)
    q = torch.as_tensor(q, dtype=a.dtype, device=a.device)
    return torch.nanquantile(a, q, dim=axis, keepdim=keepdims)


def _histogram(a, bins=10, range=None, weights=None, density=None):
    a = _float(a).reshape(-1)
    if isinstance(bins, int):
        lo, hi = (float(a.min()), float(a.max())) if range is None \
            else range
        if lo == hi:
            lo, hi = lo - 0.5, hi + 0.5
        edges = torch.linspace(lo, hi, bins + 1, device=a.device,
                               dtype=a.dtype)
    else:
        edges = _float(_t(bins))
    idx = torch.bucketize(a, edges, right=True) - 1
    n = edges.numel() - 1
    idx = torch.where(a == edges[-1], torch.full_like(idx, n - 1), idx)
    ok = (idx >= 0) & (idx < n)
    w = torch.ones_like(a) if weights is None else _t(weights).reshape(-1)
    counts = torch.zeros(n, dtype=w.dtype, device=a.device).index_add(
        0, idx[ok], w[ok])
    if density:
        counts = counts / counts.sum() / torch.diff(edges)
    return counts, edges


def _interp(x, xp, fp, left=None, right=None):
    x, xp, fp = _float(x), _float(_t(xp)), _float(_t(fp))
    i = torch.clamp(torch.searchsorted(xp, x, right=True), 1,
                    xp.numel() - 1)
    x0, x1, y0, y1 = xp[i - 1], xp[i], fp[i - 1], fp[i]
    y = y0 + (x - x0) * (y1 - y0) / torch.where(x1 == x0,
                                                torch.ones_like(x1),
                                                x1 - x0)
    y = torch.where(x < xp[0], fp[0] if left is None else
                    torch.as_tensor(left, dtype=y.dtype), y)
    return torch.where(x > xp[-1], fp[-1] if right is None else
                       torch.as_tensor(right, dtype=y.dtype), y)


def _convolve(a, v, mode='full'):
    a, v = _float(a).reshape(-1), _float(_t(v)).reshape(-1)
    if a.numel() < v.numel():
        a, v = v, a
    n, m = a.numel(), v.numel()
    full = torch.nn.functional.conv1d(
        a[None, None], v.flip(0)[None, None], padding=m - 1)[0, 0]
    if mode == 'full':
        return full
    if mode == 'same':
        start = (m - 1) // 2
        return full[start:start + n]
    return full[m - 1:n]


def _correlate(a, v, mode='valid'):
    return _convolve(a, torch.conj(_t(v)).flip(0), mode)


def _gradient(f, *varargs, axis=None, edge_order=1):
    f = _float(f)
    axes = range(f.dim()) if axis is None else \
        ([axis] if isinstance(axis, int) else axis)
    outs = []
    for ax in axes:
        h = float(varargs[0]) if varargs else 1.0
        n = f.shape[ax]
        inner = (f.narrow(ax, 2, n - 2) - f.narrow(ax, 0, n - 2)) / (2 * h)
        first = (f.narrow(ax, 1, 1) - f.narrow(ax, 0, 1)) / h
        last = (f.narrow(ax, n - 1, 1) - f.narrow(ax, n - 2, 1)) / h
        outs.append(torch.cat([first, inner, last], dim=ax))
    return outs[0] if len(outs) == 1 else outs


def _vander(x, N=None, increasing=False):
    n = x.numel() if N is None else N
    p = torch.arange(n, device=x.device)
    if not increasing:
        p = p.flip(0)
    return x.reshape(-1, 1) ** p


def _unique1(a):
    return torch.unique(a.reshape(-1), sorted=True)


def _isin(element, test_elements, assume_unique=False, invert=False):
    out = torch.isin(element, _t(test_elements))
    return ~out if invert else out


def _setdiff1d(ar1, ar2, assume_unique=False):
    u = _unique1(ar1)
    return u[~torch.isin(u, _t(ar2))]


def _intersect1d(ar1, ar2, assume_unique=False, return_indices=False):
    u = _unique1(ar1)
    return u[torch.isin(u, _t(ar2))]


def _union1d(ar1, ar2):
    return _unique1(torch.cat([ar1.reshape(-1), _t(ar2).reshape(-1)]))


def _unravel_index(indices, shape, order='C'):
    idx = indices.to(torch.int64)
    out = []
    for s in reversed(tuple(shape)):
        out.append(idx % s)
        idx = idx // s
    return tuple(reversed(out))


def _ravel_multi_index(multi_index, dims, mode='raise', order='C'):
    idx = [_t(m).to(torch.int64) for m in multi_index]
    flat = torch.zeros_like(idx[0])
    for i, d in zip(idx, dims):
        flat = flat * d + i
    return flat


def _apply_along_axis(func1d, axis, arr, *args, **kwargs):
    moved = arr.movedim(axis, -1)
    rows = moved.reshape(-1, moved.shape[-1])
    res = [_unwrap(func1d(ndarray(r), *args, **kwargs)) for r in rows]
    res = torch.stack([torch.as_tensor(r, device=arr.device) for r in res])
    out = res.reshape(tuple(moved.shape[:-1]) + tuple(res.shape[1:]))
    return out.movedim(-1, axis) if out.dim() == moved.dim() else out


def _apply_over_axes(func, a, axes):
    for ax in ([axes] if isinstance(axes, int) else axes):
        res = _unwrap(func(ndarray(a), ax))
        a = res if res.dim() == a.dim() else res.unsqueeze(ax)
    return a


def _polyfit(x, y, deg, rcond=None, full=False, w=None, cov=False):
    A = _vander(_float(x), deg + 1)
    return _nops._npi_lstsq(A, _float(_t(y)), rcond)[0]


def _packbits(a, axis=None, bitorder='big'):
    bits = (a != 0).to(torch.uint8)
    if axis is None:
        bits, axis = bits.reshape(-1), 0
    bits = bits.movedim(axis, -1)
    n = bits.shape[-1]
    pad = (-n) % 8
    bits = torch.nn.functional.pad(bits, (0, pad))
    bits = bits.reshape(tuple(bits.shape[:-1]) + (-1, 8))
    w = torch.tensor([128, 64, 32, 16, 8, 4, 2, 1], device=a.device)
    if bitorder == 'little':
        w = w.flip(0)
    return (bits.to(torch.int32) * w).sum(-1).to(torch.uint8).movedim(-1,
                                                                      axis)


def _unpackbits(a, axis=None, count=None, bitorder='big'):
    if axis is None:
        a, axis = a.reshape(-1), 0
    x = a.movedim(axis, -1).to(torch.int32)
    sh = torch.arange(7, -1, -1, device=a.device)
    if bitorder == 'little':
        sh = sh.flip(0)
    bits = ((x[..., None] >> sh) & 1).to(torch.uint8)
    bits = bits.reshape(tuple(x.shape[:-1]) + (-1,))
    if count is not None:
        bits = bits[..., :count]
    return bits.movedim(-1, axis)


def _nanarg(fn, fill):
    def f(a, axis=None):
        a = _nan_fill(_float(a), fill)
        return fn(a.reshape(-1)) if axis is None else fn(a, dim=axis)
    return f


def _nanred(fn, fill):
    def f(a, axis=None, keepdims=False, **kw):
        a = _nan_fill(a, fill) if a.is_floating_point() else a
        return fn(a, axis=axis, keepdims=keepdims)
    return f


def _nanmean(a, axis=None, keepdims=False, **kw):
    a = _float(a)
    dims = _nops._axes(axis, a.dim())
    ok = ~torch.isnan(a)
    s = torch.sum(_nan_fill(a, 0), dim=dims, keepdim=keepdims)
    return s / ok.sum(dim=dims, keepdim=keepdims)


def _nanvar(a, axis=None, keepdims=False, ddof=0, **kw):
    a = _float(a)
    dims = _nops._axes(axis, a.dim())
    m = _nanmean(a, axis, True)
    ok = ~torch.isnan(a)
    d = torch.where(ok, a - m, torch.zeros_like(a))
    return (d * d).sum(dim=dims, keepdim=keepdims) / (
        ok.sum(dim=dims, keepdim=keepdims) - ddof)


def _choose(a, choices, mode='raise'):
    ch = torch.stack([_t(c) for c in choices])
    idx = a.to(torch.int64)
    ch, idx = torch.broadcast_tensors(ch, idx.unsqueeze(0))
    return ch.gather(0, idx[:1])[0]


def _compress(condition, a, axis=None):
    a = _t(a)
    keep = torch.nonzero(condition.reshape(-1)).reshape(-1)
    if axis is None:
        return a.reshape(-1)[keep]
    return a.index_select(axis, keep)


def _select(condlist, choicelist, default=0):
    out = torch.as_tensor(default)
    out = _t(choicelist[-1]) * 0 + out.to(_t(choicelist[-1]).dtype)
    for c, v in reversed(list(zip(condlist, choicelist))):
        out = torch.where(_t(c), _t(v), out)
    return out


def _trim_zeros(filt, trim='fb'):
    nz = torch.nonzero(filt).reshape(-1)
    if nz.numel() == 0:
        return filt[:0]
    lo = int(nz[0]) if 'f' in trim else 0
    hi = int(nz[-1]) + 1 if 'b' in trim else filt.numel()
    return filt[lo:hi]


def _resize(a, new_shape):
    shape = (new_shape,) if isinstance(new_shape, int) else tuple(new_shape)
    n = int(_onp.prod(shape))
    flat = a.reshape(-1)
    reps = -(-n // _builtins.max(flat.numel(), 1))
    return flat.repeat(reps)[:n].reshape(shape)


def _frexp(x):
    m, e = torch.frexp(_float(x))
    return m, e.to(torch.int32)


def _modf(x):
    x = _float(x)
    i = torch.trunc(x)
    return x - i, i


def _divmod(a, b):
    a, b = _nops._pair(a, b)
    return torch.floor_divide(a, b), torch.remainder(a, b)


def _append(arr, values, axis=None):
    values = _t(values)
    if axis is None:
        return torch.cat([arr.reshape(-1), values.reshape(-1).to(
            torch.promote_types(arr.dtype, values.dtype))])
    return torch.cat([arr, values], dim=axis)


def _ptp(a, axis=None, keepdims=False):
    dims = _nops._axes(axis, a.dim())
    return torch.amax(a, dim=dims, keepdim=keepdims) - torch.amin(
        a, dim=dims, keepdim=keepdims)


def _count_nonzero(a, axis=None, keepdims=False):
    out = torch.count_nonzero(a, dim=axis)
    if keepdims:
        for d in sorted(_nops._axes(axis, a.dim())):
            out = out.unsqueeze(d)
    return out


def _take(a, indices, axis=None, mode=None):
    idx = _t(indices).to(torch.int64)
    if axis is None:
        return a.reshape(-1)[idx]
    return a.index_select(axis, idx.reshape(-1)).reshape(
        a.shape[:axis] + idx.shape + a.shape[axis + 1:])


def _sinc(x):
    x = _float(x)
    y = _math.pi * torch.where(x == 0, torch.ones_like(x), x)
    return torch.where(x == 0, torch.ones_like(x), torch.sin(y) / y)


_TORCH = {
    'empty': lambda shape, dtype='float32', ctx=None: torch.zeros(
        _nops._shape(shape), dtype=_torch_dtype(dtype), device=_device(ctx)),
    'zeros_like': lambda a, dtype=None: torch.zeros_like(
        a, dtype=None if dtype is None else _torch_dtype(dtype)),
    'ones_like': lambda a, dtype=None: torch.ones_like(
        a, dtype=None if dtype is None else _torch_dtype(dtype)),
    'divide': lambda a, b: torch.true_divide(*_nops._pair(a, b)),
    'remainder': lambda a, b: torch.remainder(*_nops._pair(a, b)),
    'fabs': lambda a: torch.abs(_float(a)),
    'clip': lambda a, a_min=None, a_max=None: torch.clamp(a, a_min, a_max),
    'amin': lambda a, axis=None, keepdims=False: _nops._amin(
        a, _nops._axes(axis, a.dim()), keepdims),
    'amax': lambda a, axis=None, keepdims=False: _nops._amax(
        a, _nops._axes(axis, a.dim()), keepdims),
    'cumprod': lambda a, axis=None, dtype=None: torch.cumprod(
        a.reshape(-1) if axis is None else a, 0 if axis is None else axis),
    'rollaxis': lambda a, axis, start=0: torch.movedim(
        a, axis, start if start <= axis else start - 1),
    'fliplr': lambda a: a.flip(1), 'flipud': lambda a: a.flip(0),
    'take': _take,
    'take_along_axis': lambda a, indices, axis: torch.take_along_dim(
        a, indices.to(torch.int64), dim=axis),
    'choose': _choose, 'compress': _compress,
    'sort': _sort, 'argsort': _argsort,
    'partition': lambda a, kth, axis=-1: _sort(a, axis),
    'count_nonzero': _count_nonzero,
    'broadcast_arrays': lambda *args: tuple(torch.broadcast_tensors(
        *[_t(a) for a in args])),
    'isclose': lambda a, b, rtol=1e-05, atol=1e-08, equal_nan=False:
        torch.isclose(*_nops._pair(_float(a), _float(_t(b))), rtol=rtol,
                      atol=atol, equal_nan=equal_nan),
    'allclose': lambda a, b, rtol=1e-05, atol=1e-08, equal_nan=False:
        torch.tensor(torch.allclose(*_nops._pair(_float(a), _float(_t(b))),
                                    rtol=rtol, atol=atol,
                                    equal_nan=equal_nan)),
    'array_equal': lambda a, b, equal_nan=False: torch.tensor(
        tuple(a.shape) == tuple(_t(b).shape) and bool(torch.all(
            a == _t(b)))),
    'float_power': lambda a, b: torch.float_power(*_nops._pair(a, b)),
    'left_shift': lambda a, b: torch.bitwise_left_shift(*_nops._pair(a, b)),
    'right_shift': lambda a, b: torch.bitwise_right_shift(
        *_nops._pair(a, b)),
    'interp': _interp, 'histogram': _histogram, 'median': _median,
    'cov': lambda m, y=None, rowvar=True, bias=False, ddof=None:
        torch.cov(_float(m) if rowvar else _float(m).t(),
                  correction=(0 if bias else 1) if ddof is None else ddof),
    'corrcoef': lambda x, y=None, rowvar=True: torch.corrcoef(
        _float(x) if rowvar else _float(x).t()),
    'convolve': _convolve, 'correlate': _correlate, 'gradient': _gradient,
    'append': _append, 'resize': _resize, 'trim_zeros': _trim_zeros,
    'tril_indices': lambda n, k=0, m=None: tuple(torch.tril_indices(
        n, n if m is None else m, k, device=_device())),
    'triu_indices': lambda n, k=0, m=None: tuple(torch.triu_indices(
        n, n if m is None else m, k, device=_device())),
    'diag_indices': lambda n, ndim=2: tuple(
        torch.arange(n, device=_device()) for _ in range(ndim)),
    'vander': _vander,
    'nansum': _nanred(lambda a, axis, keepdims: torch.sum(
        a, dim=_nops._axes(axis, a.dim()), keepdim=keepdims), 0),
    'nanprod': _nanred(lambda a, axis, keepdims: _nops._prod(
        a, _nops._axes(axis, a.dim()), keepdims), 1),
    'nanmean': _nanmean,
    'nanvar': _nanvar,
    'nanstd': lambda a, axis=None, keepdims=False, ddof=0, **kw: torch.sqrt(
        _nanvar(a, axis, keepdims, ddof)),
    'nanmin': _nanred(lambda a, axis, keepdims: _nops._amin(
        a, _nops._axes(axis, a.dim()), keepdims), _math.inf),
    'nanmax': _nanred(lambda a, axis, keepdims: _nops._amax(
        a, _nops._axes(axis, a.dim()), keepdims), -_math.inf),
    'nanargmin': _nanarg(torch.argmin, _math.inf),
    'nanargmax': _nanarg(torch.argmax, -_math.inf),
    'nancumsum': lambda a, axis=None: torch.cumsum(
        _nan_fill(_float(a), 0).reshape(-1) if axis is None
        else _nan_fill(_float(a), 0), 0 if axis is None else axis),
    'nancumprod': lambda a, axis=None: torch.cumprod(
        _nan_fill(_float(a), 1).reshape(-1) if axis is None
        else _nan_fill(_float(a), 1), 0 if axis is None else axis),
    'nanmedian': lambda a, axis=None, keepdims=False: _nanquantile_impl(
        a, 0.5, axis, keepdims),
    'nanpercentile': lambda a, q, axis=None, keepdims=False:
        _nanquantile_impl(a, torch.as_tensor(q, dtype=torch.float32) / 100,
                          axis, keepdims),
    'nanquantile': lambda a, q, axis=None, keepdims=False:
        _nanquantile_impl(a, q, axis, keepdims),
    'heaviside': lambda x1, x2: torch.heaviside(
        *_nops._pair(_float(x1), _float(_t(x2)))),
    'frexp': _frexp, 'modf': _modf, 'divmod': _divmod,
    'nextafter': lambda a, b: torch.nextafter(*_nops._pair(a, b)),
    'signbit': lambda x: torch.signbit(x),
    'logaddexp': lambda a, b: torch.logaddexp(*_nops._pair(_float(a),
                                                           _float(_t(b)))),
    'logaddexp2': lambda a, b: torch.logaddexp2(*_nops._pair(
        _float(a), _float(_t(b)))),
    'iscomplex': lambda x: torch.zeros_like(x, dtype=torch.bool)
        if not x.is_complex() else x.imag != 0,
    'isreal': lambda x: torch.ones_like(x, dtype=torch.bool)
        if not x.is_complex() else x.imag == 0,
    'sinc': _sinc, 'i0': lambda x: torch.special.i0(_float(x)),
    'ptp': _ptp,
    'digitize': lambda x, bins, right=False: torch.bucketize(
        x, _t(bins), right=not right),
    'real': lambda x: x.real if x.is_complex() else x,
    'imag': lambda x: x.imag if x.is_complex() else torch.zeros_like(x),
    'conj': torch.conj,
    'angle': lambda z, deg=False: torch.angle(_float(z)) * (
        180 / _math.pi if deg else 1),
    'setdiff1d': _setdiff1d, 'union1d': _union1d,
    'intersect1d': _intersect1d, 'isin': _isin,
    'in1d': lambda ar1, ar2, assume_unique=False, invert=False: _isin(
        ar1.reshape(-1), ar2, invert=invert),
    'argwhere': lambda a: torch.argwhere(a),
    'extract': lambda condition, arr: _t(arr).reshape(-1)[
        condition.reshape(-1).to(torch.bool)],
    'select': _select,
    'unravel_index': _unravel_index,
    'ravel_multi_index': _ravel_multi_index,
    'polyfit': _polyfit,
    'shape': lambda a: tuple(a.shape), 'ndim': lambda a: a.dim(),
    'size': lambda a: a.numel(),
    'iterable': lambda y: hasattr(y, '__iter__'),
    'packbits': _packbits, 'unpackbits': _unpackbits,
}

_FUNCS = [
    'zeros', 'ones', 'full', 'empty', 'arange', 'logspace', 'eye',
    'identity', 'zeros_like', 'ones_like', 'full_like', 'add', 'subtract',
    'multiply', 'divide', 'true_divide', 'mod', 'remainder', 'power',
    'matmul', 'dot', 'inner', 'outer', 'sqrt', 'cbrt', 'square', 'exp',
    'expm1', 'log', 'log2', 'log10', 'log1p', 'sin', 'cos', 'tan', 'arcsin',
    'arccos', 'arctan', 'arctan2', 'sinh', 'cosh', 'tanh', 'arcsinh',
    'arccosh', 'arctanh', 'degrees', 'radians', 'abs', 'absolute', 'fabs',
    'sign', 'floor', 'ceil', 'trunc', 'rint', 'around', 'reciprocal',
    'negative', 'maximum', 'minimum', 'clip', 'sum', 'prod', 'mean', 'std',
    'var', 'min', 'max', 'amin', 'amax', 'argmin', 'argmax', 'cumsum',
    'cumprod', 'reshape', 'ravel', 'transpose', 'swapaxes', 'moveaxis',
    'rollaxis', 'expand_dims', 'squeeze', 'tile', 'repeat', 'flip', 'fliplr',
    'flipud', 'roll', 'rot90', 'take', 'take_along_axis', 'choose',
    'compress', 'diag', 'diagonal', 'diagflat', 'tril', 'triu', 'trace',
    'sort', 'argsort', 'partition', 'count_nonzero', 'searchsorted',
    'broadcast_to', 'broadcast_arrays', 'indices', 'logical_and',
    'logical_or', 'logical_not', 'logical_xor', 'equal', 'not_equal',
    'greater', 'greater_equal', 'less', 'less_equal', 'isnan', 'isinf',
    'isfinite', 'isclose', 'allclose', 'array_equal', 'floor_divide',
    'float_power', 'hypot', 'lcm', 'gcd', 'bitwise_and', 'bitwise_or',
    'bitwise_xor', 'invert', 'left_shift', 'right_shift', 'nan_to_num',
    'interp', 'histogram', 'bincount', 'median', 'average', 'cov',
    'corrcoef', 'convolve', 'correlate', 'gradient', 'diff', 'ediff1d',
    'cross', 'kron', 'vdot', 'append', 'resize', 'trim_zeros',
    'tril_indices', 'triu_indices', 'diag_indices', 'polyval', 'vander',
    'nansum', 'nanprod', 'nanmean', 'nanstd', 'nanvar', 'nanmin', 'nanmax',
    'nanargmin', 'nanargmax', 'nancumsum', 'nancumprod', 'nanmedian',
    'nanpercentile', 'nanquantile', 'heaviside', 'ldexp', 'frexp', 'modf',
    'divmod', 'copysign', 'nextafter', 'signbit', 'logaddexp', 'logaddexp2',
    'exp2', 'fmax', 'fmin', 'fmod', 'isposinf', 'isneginf', 'iscomplex',
    'isreal', 'positive', 'deg2rad', 'rad2deg', 'sinc', 'i0', 'ptp',
    'digitize', 'real', 'imag', 'conj', 'conjugate', 'angle', 'setdiff1d',
    'union1d', 'intersect1d', 'isin', 'in1d', 'flatnonzero', 'argwhere',
    'extract', 'select', 'unravel_index', 'ravel_multi_index', 'polyfit',
    'shape', 'ndim', 'size', 'iterable', 'packbits', 'unpackbits', 'any',
    'all',
]

for _f in _FUNCS:
    _fn = _op_of(_f) or _TORCH.get(_f)
    if _fn is not None:
        globals()[_f] = _make(_f, _fn, creation=_f in _CREATION)


def apply_along_axis(func1d, axis, arr, *args, **kwargs):
    return _wrap(_apply_along_axis(func1d, axis, _t(arr), *args, **kwargs))


def apply_over_axes(func, a, axes):
    return _wrap(_apply_over_axes(func, _t(a), axes))


# --- numpy's conventions over the registered ops ---------------------------

def _op(name, *args, **kwargs):
    return _wrap(_get_op(name).fn(*args, **kwargs))


def copy(a):
    return _op('_np_copy', _t(a))


def round(a, decimals=0):
    return _op('_npi_around', _t(a), decimals=decimals)


around = round


def fix(x):
    return _op('_npi_fix', _t(x))


def where(condition, x=None, y=None):
    if x is None and y is None:
        return nonzero(condition)
    return _op('_npi_where', _t(condition), _t(x), _t(y))


def nonzero(a):
    out = _get_op('_npi_nonzero').fn(_t(a))
    return tuple(_wrap(row) for row in out)


def unique(ar, return_index=False, return_inverse=False,
           return_counts=False, axis=None):
    out = _op('_npi_unique', _t(ar), return_index=return_index,
              return_inverse=return_inverse, return_counts=return_counts,
              axis=axis)
    return out[0] if len(out) == 1 else out


def insert(arr, obj, values, axis=None):
    arr, values = _t(arr), _t(values)
    if isinstance(obj, slice):
        return _op('_npi_insert_slice', arr, values, start=obj.start,
                   stop=obj.stop, step=obj.step, axis=axis)
    if isinstance(obj, (int, _onp.integer)):
        return _op('_npi_insert_scalar', arr, int(obj), values, axis=axis)
    return _op('_npi_insert_tensor', arr, _t(obj), values, axis=axis)


def delete(arr, obj, axis=None):
    arr = _t(arr)
    if isinstance(obj, slice):
        return _op('_npi_delete', arr, start=obj.start, stop=obj.stop,
                   step=obj.step, axis=axis)
    return _op('_npi_delete', arr, _t(obj) if not isinstance(
        obj, (int, _onp.integer)) else int(obj), axis=axis)


def percentile(a, q, axis=None, out=None, overwrite_input=False,
               method='linear', keepdims=False, interpolation=None):
    return _op('_npi_percentile', _t(a), _t(q), axis=axis,
               interpolation=interpolation or method, keepdims=keepdims)


def quantile(a, q, axis=None, out=None, overwrite_input=False,
             method='linear', keepdims=False, interpolation=None):
    return _op('_npi_quantile', _t(a), _t(q), axis=axis,
               interpolation=interpolation or method, keepdims=keepdims)


def tensordot(a, b, axes=2):
    if isinstance(axes, int):
        return _op('_npi_tensordot_int_axes', _t(a), _t(b), axes=axes)
    a_axes, b_axes = axes
    a_axes = [a_axes] if isinstance(a_axes, int) else list(a_axes)
    b_axes = [b_axes] if isinstance(b_axes, int) else list(b_axes)
    return _op('_npi_tensordot', _t(a), _t(b), a_axes, b_axes)


def pad(array, pad_width, mode='constant', **kwargs):
    a = _t(array)
    pw = _onp.broadcast_to(_onp.asarray(pad_width, dtype=_onp.int64),
                           (a.dim(), 2))
    return _op('_npi_pad', a, [tuple(int(v) for v in p) for p in pw],
               mode=mode, constant_values=kwargs.get('constant_values', 0))


def linspace(start, stop, num=50, endpoint=True, retstep=False, dtype=None,
             axis=0, ctx=None):
    out = _op('_npi_linspace', start, stop, num, endpoint=endpoint,
              dtype=dtype or 'float32', ctx=ctx)
    if retstep:
        return out, (stop - start) / ((num - 1) if endpoint else num)
    return out


def einsum(subscripts, *operands, **kwargs):
    """Dispatches through the registered _npi_einsum op."""
    return _op('_npi_einsum', *[_t(o) for o in operands],
               subscripts=subscripts,
               optimize=bool(kwargs.get('optimize', False)))


def split(ary, indices_or_sections, axis=0):
    return list(_op('_npi_split', _t(ary), indices_or_sections, axis))


def array_split(ary, indices_or_sections, axis=0):
    return list(_op('_npi_array_split', _t(ary), indices_or_sections, axis))


def hsplit(ary, indices_or_sections):
    return list(_op('_npi_hsplit', _t(ary), indices_or_sections))


def vsplit(ary, indices_or_sections):
    return list(_op('_npi_vsplit', _t(ary), indices_or_sections))


def dsplit(ary, indices_or_sections):
    return list(_op('_npi_dsplit', _t(ary), indices_or_sections))


def concatenate(seq, axis=0, out=None):
    return _op('_npi_concatenate', *[_t(a) for a in seq], axis=axis)


def stack(arrays, axis=0, out=None):
    return _op('_npi_stack', *[_t(a) for a in arrays], axis=axis)


def vstack(tup):
    return _op('_npi_vstack', *[_t(a) for a in tup])


def hstack(tup):
    return _op('_npi_hstack', *[_t(a) for a in tup])


def dstack(tup):
    return _op('_npi_dstack', *[_t(a) for a in tup])


def column_stack(tup):
    return _op('_npi_column_stack', *[_t(a) for a in tup])


def meshgrid(*xi, indexing='xy', **kwargs):
    return list(_op('_npi_meshgrid', *[_t(x) for x in xi],
                    indexing=indexing))


def _atleast(name):
    def f(*arys):
        out = _op(name, *[_t(a) for a in arys])
        return out[0] if len(out) == 1 else list(out)
    f.__name__ = name[4:]
    return f


atleast_1d = _atleast('_np_atleast_1d')
atleast_2d = _atleast('_np_atleast_2d')
atleast_3d = _atleast('_np_atleast_3d')


def finfo(dtype):
    return _onp.finfo(_onp.dtype(dtype))


def iinfo(dtype):
    return _onp.iinfo(_onp.dtype(dtype))


def _as_dtype_tensor(x):
    if isinstance(x, _NDArray):
        return torch.empty(1, dtype=x._data.dtype)
    if isinstance(x, torch.Tensor):
        return torch.empty(1, dtype=x.dtype)
    if isinstance(x, (bool, int, float)):
        return x
    return torch.empty(1, dtype=_torch_dtype(x))


def _np_dtype(t):
    return torch.bfloat16 if t == torch.bfloat16 else \
        _onp.dtype(str(t)[len('torch.'):])


def result_type(*arrays_and_dtypes):
    """The JAX package's result dtype: torch's (JAX's) promotion lattice,
    a Python number weak, 64-bit types narrowed to 32."""
    args = [_as_dtype_tensor(x) for x in arrays_and_dtypes]
    acc = args[0] if isinstance(args[0], torch.Tensor) else \
        torch.tensor(args[0]).reshape(())
    for x in args[1:]:
        acc = torch.empty(1, dtype=torch.result_type(acc, x))
    return _np_dtype(_nops._NARROW.get(acc.dtype, acc.dtype))


def promote_types(type1, type2):
    """JAX's promote_types: the lattice's join of two dtypes, unnarrowed."""
    return _np_dtype(torch.promote_types(_torch_dtype(type1),
                                         _torch_dtype(type2)))


def can_cast(from_, to, casting='safe'):
    return _onp.can_cast(from_.dtype if isinstance(from_, _NDArray)
                         else from_, to, casting)


pi = _onp.pi
e = _onp.e
inf = _onp.inf
nan = _onp.nan
newaxis = None
float32 = _onp.float32
float64 = _onp.float64
float16 = _onp.float16
int32 = _onp.int32
int64 = _onp.int64
int8 = _onp.int8
uint8 = _onp.uint8
bool_ = _onp.bool_
dtype = _onp.dtype


def _sizes(size):
    if size is None:
        return ()
    return (size,) if isinstance(size, int) else tuple(size)


class random:
    """``np.random``: the registered ``_npi_*`` samplers, drawing from
    ``random.generator`` of the device they sample on."""

    @staticmethod
    def uniform(low=0.0, high=1.0, size=None, dtype='float32', ctx=None):
        return _op('_npi_uniform', _t(low), _t(high), size=_sizes(size),
                   dtype=dtype, ctx=ctx)

    @staticmethod
    def normal(loc=0.0, scale=1.0, size=None, dtype='float32', ctx=None):
        return _op('_npi_normal', _t(loc), _t(scale), size=_sizes(size),
                   dtype=dtype, ctx=ctx)

    @staticmethod
    def randint(low, high=None, size=None, dtype='int32', ctx=None):
        return _op('_npi_randint', low, high, size=_sizes(size),
                   dtype=dtype, ctx=ctx)

    @staticmethod
    def rand(*size):
        return random.uniform(size=size or None)

    @staticmethod
    def randn(*size):
        return random.normal(size=size or None)

    @staticmethod
    def choice(a, size=None, replace=True, p=None, ctx=None):
        return _op('_npi_choice', _t(a) if not isinstance(a, int) else a,
                   size=size if size is None else _sizes(size),
                   replace=replace, p=_t(p), ctx=ctx)

    @staticmethod
    def shuffle(x):
        """Shuffle x's rows in place (x must be an ndarray)."""
        if not isinstance(x, _NDArray):
            raise TypeError("shuffle requires an mx.np.ndarray")
        x._data = _r.shuffle(x._data)

    @staticmethod
    def seed(s):
        from .. import random as _framework_random
        _framework_random.seed(s)

    @staticmethod
    def _sample(opname, *args, **kwargs):
        kwargs.pop('ctx', None)
        return _op(opname, *[_t(a) for a in args],
                   **{k: _unwrap(v) for k, v in kwargs.items()})

    @staticmethod
    def gamma(shape=1.0, scale=1.0, size=None):
        return random._sample('_npi_gamma', shape, scale, size=size)

    @staticmethod
    def exponential(scale=1.0, size=None):
        return random._sample('_npi_exponential', scale, size=size)

    @staticmethod
    def gumbel(loc=0.0, scale=1.0, size=None):
        return random._sample('_npi_gumbel', loc, scale, size=size)

    @staticmethod
    def logistic(loc=0.0, scale=1.0, size=None):
        return random._sample('_npi_logistic', loc, scale, size=size)

    @staticmethod
    def laplace(loc=0.0, scale=1.0, size=None):
        return random._sample('_npi_laplace', loc, scale, size=size)

    @staticmethod
    def rayleigh(scale=1.0, size=None):
        return random._sample('_npi_rayleigh', scale, size=size)

    @staticmethod
    def weibull(a=1.0, size=None):
        return random._sample('_npi_weibull', a, size=size)

    @staticmethod
    def pareto(a=1.0, size=None):
        return random._sample('_npi_pareto', a, size=size)

    @staticmethod
    def power(a=1.0, size=None):
        return random._sample('_npi_powerd', a, size=size)

    @staticmethod
    def bernoulli(prob=0.5, size=None):
        return random._sample('_npi_bernoulli', prob, size=size)

    @staticmethod
    def multinomial(n, pvals, size=None):
        return _op('_npi_multinomial', n, _t(pvals), size=size)


class linalg:
    """``np.linalg`` over the registered ``_npi_*`` ops and torch.linalg."""

    @staticmethod
    def norm(x, ord=None, axis=None, keepdims=False):
        return _wrap(torch.linalg.norm(_float(_t(x)), ord=ord, dim=axis,
                                       keepdim=keepdims))

    @staticmethod
    def inv(a):
        return _op('_npi_inv', _t(a))

    @staticmethod
    def det(a):
        return _op('_npi_det', _t(a))

    @staticmethod
    def slogdet(a):
        return _op('_npi_slogdet', _t(a))

    @staticmethod
    def cholesky(a):
        return _op('_npi_cholesky', _t(a))

    @staticmethod
    def svd(a, full_matrices=True, compute_uv=True):
        if not compute_uv:
            return _wrap(torch.linalg.svdvals(_t(a)))
        return _wrap(tuple(torch.linalg.svd(_t(a),
                                            full_matrices=full_matrices)))

    @staticmethod
    def eigh(a, UPLO='L'):
        return _op('_npi_eigh', _t(a), upper=UPLO == 'U')

    @staticmethod
    def solve(a, b):
        return _op('_npi_solve', _t(a), _t(b))

    @staticmethod
    def lstsq(a, b, rcond=None):
        return _op('_npi_lstsq', _t(a), _t(b), rcond=rcond)

    @staticmethod
    def qr(a):
        return _op('_npi_qr', _t(a))

    @staticmethod
    def matrix_rank(a):
        return _op('_npi_matrix_rank', _t(a))

    @staticmethod
    def pinv(a):
        a = _t(a)
        rtol = 10 * _builtins.max(a.shape[-2:]) * torch.finfo(a.dtype).eps
        return _wrap(torch.linalg.pinv(a, rtol=rtol))

    @staticmethod
    def eig(a):
        return _op('_npi_eig', _t(a))

    @staticmethod
    def eigvals(a):
        return _op('_npi_eigvals', _t(a))

    @staticmethod
    def eigvalsh(a, UPLO='L'):
        return _op('_npi_eigvalsh', _t(a), upper=UPLO == 'U')

    @staticmethod
    def tensorinv(a, ind=2):
        return _op('_npi_tensorinv', _t(a), ind=ind)

    @staticmethod
    def tensorsolve(a, b, axes=None):
        return _op('_npi_tensorsolve', _t(a), _t(b), a_axes=axes)

    @staticmethod
    def multi_dot(arrays):
        return _op('_npi_multi_dot', *[_t(a) for a in arrays])

    @staticmethod
    def matrix_power(a, n):
        return _op('_npi_matrix_power', _t(a), n=n)
