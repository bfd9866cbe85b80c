"""NDArray: the framework tensor, a mutable handle over a ``torch.Tensor``
(counterpart of ``mxnet_tpu/ndarray/ndarray.py``, ref:
include/mxnet/ndarray.h and python/mxnet/ndarray/ndarray.py).

Value semantics, as in the JAX package, whose arrays are immutable: no
NDArray ever writes into its tensor. ``a[key] = v``, ``+=`` and a user
kernel's launch (``rtc``) rebind ``_data`` to a new tensor, so two
NDArrays may share storage (torch's reshape, transpose and slices are
views) without one's write showing in the other, and no tensor that a
recorded graph saved is modified in place.

Placement: an NDArray lives where its context says (``ctx=``, else the
current context, ``gpu(0)`` by default); ops put their result where
their inputs are. ``asnumpy`` copies to the host.

dtypes: ``dtype`` is a numpy dtype, except for bfloat16, which numpy has
not: a bf16 NDArray's ``dtype`` is ``torch.bfloat16`` and ``asnumpy()``
returns float32 (every bf16 value is exactly representable), so
``nd.save`` writes it as float32.
"""
from __future__ import annotations

import functools
import numbers
import os
import tempfile

import numpy as onp
import torch

from ..base import MXNetError, get_op, lookup_sparse_impl, torch_dtype
from ..context import Context, context_of, current_context
from .. import _imperative
from ..ops import (elemwise as _ew, reduce as _red, matrix as _mat,
                   nn as _nn, index as _idx, init as _init)

__all__ = ['NDArray', 'array', 'zeros', 'ones', 'full', 'arange', 'empty',
           'concat', 'stack', 'save', 'load', 'load_frombuffer',
           'imperative_invoke', 'waitall', 'from_numpy', 'from_dlpack',
           'to_dlpack_for_read']


def _device(ctx):
    return (ctx or current_context()).device


class NDArray:
    __slots__ = ('_data', '_grad', '_grad_req', '_in_graph', '__weakref__')

    def __init__(self, data, ctx=None):
        if isinstance(data, NDArray):
            data = data._data
        if ctx is not None:
            data = data.to(ctx.device)
        self._data = data
        self._grad = None
        self._grad_req = 'write'
        self._in_graph = False

    # ---- basic properties -------------------------------------------------
    @property
    def shape(self):
        return tuple(self._data.shape)

    @property
    def dtype(self):
        if self._data.dtype == torch.bfloat16:
            return torch.bfloat16
        return onp.dtype(str(self._data.dtype)[len('torch.'):])

    @property
    def ndim(self):
        return self._data.dim()

    @property
    def size(self):
        return self._data.numel()

    @property
    def stype(self):
        return 'default'

    @property
    def context(self) -> Context:
        return context_of(self._data.device)

    ctx = context

    @property
    def grad(self):
        return self._grad

    @property
    def T(self):
        return self.transpose()

    # ---- host interop -----------------------------------------------------
    def asnumpy(self) -> onp.ndarray:
        """A copy on the host: a parameter's tensor (``Parameter.data()``)
        is updated in place, so a host array must not alias it."""
        t = self._data.detach()
        if t.dtype == torch.bfloat16:
            t = t.to(torch.float32)
        return t.cpu().numpy() if t.is_cuda else t.numpy().copy()

    def asscalar(self):
        return self.asnumpy().item()

    def item(self):
        return self.asnumpy().item()

    def __float__(self):
        return float(self.asscalar())

    def __int__(self):
        return int(self.asscalar())

    def __bool__(self):
        return bool(self.asnumpy())

    def __len__(self):
        return self.shape[0]

    def wait_to_read(self):
        """Wait for the work queued on this array's device stream."""
        if self._data.is_cuda:
            torch.cuda.current_stream(self._data.device).synchronize()

    wait_to_write = wait_to_read

    def __repr__(self):
        return (f"\n{self.asnumpy()}\n<NDArray "
                f"{'x'.join(map(str, self.shape))} @{self.context}>")

    # ---- data movement ----------------------------------------------------
    def as_in_context(self, ctx) -> "NDArray":
        if ctx == self.context:
            return self
        return NDArray(self._data.detach().to(ctx.device))

    as_in_ctx = as_in_context

    def copyto(self, other):
        if isinstance(other, NDArray):
            other._data = self._data.detach().to(other._data.device,
                                                 copy=True)
            return other
        if isinstance(other, Context):
            return NDArray(self._data.detach().to(other.device, copy=True))
        raise MXNetError("copyto expects NDArray or Context")

    def copy(self):
        return NDArray(self._data.detach().clone())

    def astype(self, dtype, copy=True):
        return _invoke(_ew.cast, self, dtype=dtype)

    def to_dlpack_for_read(self):
        return torch.utils.dlpack.to_dlpack(self._data.detach())

    # ---- autograd ---------------------------------------------------------
    def attach_grad(self, grad_req='write', stype=None):
        """Ref: python/mxnet/ndarray/ndarray.py attach_grad. A non-default
        ``stype`` makes the gradient a sparse NDArray (dense payload), so
        the sparse API (indices/data/retain) and the stype-dispatching
        optimizers see it."""
        grad = NDArray(torch.zeros_like(self._data.detach()))
        if stype not in (None, 'default'):
            from .sparse import cast_storage
            grad = cast_storage(grad, stype)
        self._grad = grad
        self._grad_req = grad_req
        self._in_graph = True

    def detach(self):
        return NDArray(self._data.detach())

    def backward(self, out_grad=None, retain_graph=False, train_mode=True):
        _imperative.backward([self], [out_grad], retain_graph, train_mode)

    # ---- shape ops (methods mirroring the reference API) -------------------
    def reshape(self, *shape, **kwargs):
        if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
            shape = tuple(shape[0])
        shape = kwargs.get('shape', shape)
        return _invoke(_mat.reshape, self, shape=shape,
                       reverse=kwargs.get('reverse', False))

    def reshape_like(self, other):
        return _invoke(_mat.reshape, self, shape=other.shape)

    def transpose(self, *axes):
        if len(axes) == 1 and isinstance(axes[0], (tuple, list)):
            axes = tuple(axes[0])
        return _invoke(_mat.transpose, self, axes=axes or None)

    def flatten(self):
        return _invoke(_mat.flatten, self)

    def expand_dims(self, axis):
        return _invoke(_mat.expand_dims, self, axis=axis)

    def squeeze(self, axis=None):
        return _invoke(_mat.squeeze, self, axis=axis)

    def swapaxes(self, dim1, dim2):
        return _invoke(_mat.swapaxes, self, dim1=dim1, dim2=dim2)

    def split(self, num_outputs, axis=1, squeeze_axis=False):
        return _invoke(_mat.split, self, num_outputs=num_outputs, axis=axis,
                       squeeze_axis=squeeze_axis)

    def tile(self, reps):
        return _invoke(_mat.tile, self, reps=reps)

    def repeat(self, repeats, axis=None):
        return _invoke(_mat.repeat, self, repeats=repeats, axis=axis)

    def broadcast_to(self, shape):
        return _invoke(_red.broadcast_to, self, shape=shape)

    def broadcast_like(self, other):
        return _invoke(_red.broadcast_like, self, other)

    def slice_axis(self, axis, begin, end):
        return _invoke(_mat.slice_axis, self, axis=axis, begin=begin, end=end)

    # ---- math methods ------------------------------------------------------
    def sum(self, axis=None, keepdims=False):
        return _invoke(_red.sum, self, axis=axis, keepdims=keepdims)

    def mean(self, axis=None, keepdims=False):
        return _invoke(_red.mean, self, axis=axis, keepdims=keepdims)

    def prod(self, axis=None, keepdims=False):
        return _invoke(_red.prod, self, axis=axis, keepdims=keepdims)

    def max(self, axis=None, keepdims=False):
        return _invoke(_red.max, self, axis=axis, keepdims=keepdims)

    def min(self, axis=None, keepdims=False):
        return _invoke(_red.min, self, axis=axis, keepdims=keepdims)

    def argmax(self, axis=None, keepdims=False):
        return _invoke(_red.argmax, self, axis=axis, keepdims=keepdims)

    def argmin(self, axis=None, keepdims=False):
        return _invoke(_red.argmin, self, axis=axis, keepdims=keepdims)

    def norm(self, ord=2, axis=None, keepdims=False):
        return _invoke(_red.norm, self, ord=ord, axis=axis, keepdims=keepdims)

    def abs(self):
        return _invoke(_ew.abs, self)

    def sqrt(self):
        return _invoke(_ew.sqrt, self)

    def square(self):
        return _invoke(_ew.square, self)

    def exp(self):
        return _invoke(_ew.exp, self)

    def log(self):
        return _invoke(_ew.log, self)

    def relu(self):
        return _invoke(_ew.relu, self)

    def sigmoid(self):
        return _invoke(_ew.sigmoid, self)

    def tanh(self):
        return _invoke(_ew.tanh, self)

    def softmax(self, axis=-1):
        return _invoke(_nn.softmax, self, axis=axis)

    def log_softmax(self, axis=-1):
        return _invoke(_nn.log_softmax, self, axis=axis)

    def clip(self, a_min=None, a_max=None):
        return _invoke(_ew.clip, self, a_min=a_min, a_max=a_max)

    def dot(self, other, transpose_a=False, transpose_b=False):
        return _invoke(_mat.dot, self, other, transpose_a=transpose_a,
                       transpose_b=transpose_b)

    def one_hot(self, depth, on_value=1.0, off_value=0.0):
        return _invoke(_nn.one_hot, self, depth=depth, on_value=on_value,
                       off_value=off_value)

    def topk(self, axis=-1, k=1, ret_typ='indices', is_ascend=False):
        return _invoke(_mat.topk, self, axis=axis, k=k, ret_typ=ret_typ,
                       is_ascend=is_ascend)

    def sort(self, axis=-1, is_ascend=True):
        return _invoke(_mat.sort, self, axis=axis, is_ascend=is_ascend)

    def argsort(self, axis=-1, is_ascend=True):
        return _invoke(_mat.argsort, self, axis=axis, is_ascend=is_ascend)

    def take(self, indices, axis=0, mode='clip'):
        return _invoke(_idx.take, self, indices, axis=axis, mode=mode)

    def tostype(self, stype):
        """This array under storage type ``stype`` ('default', 'csr',
        'row_sparse'): the same dense payload, as in the JAX package."""
        from .sparse import cast_storage
        return cast_storage(self, stype)

    # ---- arithmetic dunders -------------------------------------------------
    def _binop(self, other, fn, scalar_fn):
        if isinstance(other, NDArray):
            return _invoke(fn, self, other)
        if isinstance(other, numbers.Number):
            return _invoke(scalar_fn, self, scalar=other)
        if isinstance(other, onp.ndarray):
            return _invoke(fn, self, NDArray(torch.as_tensor(
                other, device=self._data.device)))
        return NotImplemented

    def __add__(self, other):
        return self._binop(other, _ew.broadcast_add, _ew.plus_scalar)

    __radd__ = __add__

    def __sub__(self, other):
        return self._binop(other, _ew.broadcast_sub, _ew.minus_scalar)

    def __rsub__(self, other):
        return self._binop(other, _ew.broadcast_sub, _ew.rminus_scalar) \
            if isinstance(other, numbers.Number) else NotImplemented

    def __mul__(self, other):
        return self._binop(other, _ew.broadcast_mul, _ew.mul_scalar)

    __rmul__ = __mul__

    def __truediv__(self, other):
        return self._binop(other, _ew.broadcast_div, _ew.div_scalar)

    def __rtruediv__(self, other):
        return self._binop(other, _ew.broadcast_div, _ew.rdiv_scalar) \
            if isinstance(other, numbers.Number) else NotImplemented

    def __mod__(self, other):
        return self._binop(other, _ew.broadcast_mod, _ew.mod_scalar)

    def __pow__(self, other):
        return self._binop(other, _ew.broadcast_power, _ew.power_scalar)

    def __rpow__(self, other):
        return self._binop(other, _ew.broadcast_power, _ew.rpower_scalar) \
            if isinstance(other, numbers.Number) else NotImplemented

    def __neg__(self):
        return _invoke(_ew.negative, self)

    def __abs__(self):
        return _invoke(_ew.abs, self)

    def __eq__(self, other):
        if other is None:
            return False
        return self._binop(other, _ew.broadcast_equal, _ew.equal_scalar)

    def __ne__(self, other):
        if other is None:
            return True
        return self._binop(other, _ew.broadcast_not_equal,
                           _ew.not_equal_scalar)

    def __gt__(self, other):
        return self._binop(other, _ew.broadcast_greater, _ew.greater_scalar)

    def __ge__(self, other):
        return self._binop(other, _ew.broadcast_greater_equal,
                           _ew.greater_equal_scalar)

    def __lt__(self, other):
        return self._binop(other, _ew.broadcast_lesser, _ew.lesser_scalar)

    def __le__(self, other):
        return self._binop(other, _ew.broadcast_lesser_equal,
                           _ew.lesser_equal_scalar)

    __hash__ = object.__hash__

    # in-place: rebind _data
    def __iadd__(self, other):
        self._data = self.__add__(other)._data
        return self

    def __isub__(self, other):
        self._data = self.__sub__(other)._data
        return self

    def __imul__(self, other):
        self._data = self.__mul__(other)._data
        return self

    def __itruediv__(self, other):
        self._data = self.__truediv__(other)._data
        return self

    # ---- indexing -----------------------------------------------------------
    def __getitem__(self, key):
        if isinstance(key, NDArray):
            return _invoke(_idx.take, self, key)
        return _invoke(lambda d: d[key], self)

    def __setitem__(self, key, value):
        """Rebinds ``_data`` to a new tensor with the slice replaced, as
        the JAX package's ``.at[key].set`` does; ``x[:] = v`` replaces
        the whole value, keeping shape and dtype."""
        old = self._data.detach()
        if isinstance(value, NDArray):
            value = value._data.detach()
        value = torch.as_tensor(value, dtype=old.dtype, device=old.device)
        if isinstance(key, slice) and key == slice(None):
            self._data = torch.broadcast_to(value, old.shape)
            return
        if isinstance(key, NDArray):
            key = key._data.to(torch.int64)
        new = old.clone()
        new[key] = value
        self._data = new

    def __iter__(self):
        for i in range(self.shape[0]):
            yield self[i]


def _wrap(data) -> NDArray:
    return NDArray(data)


def _invoke(fn, *args, **kwargs):
    """Eager dispatch of an op over tensors on NDArray arguments. Called
    with torch tensors and no NDArray (a HybridBlock's ``hybrid_forward``
    given ``F = nd``, a loss function inside the compiled step), the op
    runs on them as they are and returns tensors."""
    if not any(isinstance(a, NDArray) for a in args) and \
            not any(isinstance(v, NDArray) for v in kwargs.values()) and (
                any(isinstance(a, torch.Tensor) for a in args) or
                any(isinstance(v, torch.Tensor) for v in kwargs.values())):
        return fn(*args, **kwargs)
    fn = _storage_dispatch(fn, args, kwargs)
    out, recording = _imperative.invoke(fn, args, kwargs)
    if isinstance(out, (tuple, list)):
        return _wrap_outputs(out, recording)
    out = NDArray(out)
    if recording:
        _imperative.record_output(out)
    return out


def _wrap_outputs(out, recording):
    """An op's tuple (or list) of outputs as NDArrays, nested lists (the
    multi-tensor updates) included."""
    if isinstance(out, (tuple, list)):
        return type(out)(_wrap_outputs(o, recording) for o in out)
    if not isinstance(out, torch.Tensor):
        return out
    arr = NDArray(out)
    if recording:
        _imperative.record_output(arr)
    return arr


def _storage_dispatch(fn, args, kwargs):
    """Storage-driven dispatch (the reference's FComputeEx,
    op_attr_types.h:304): when a positional argument carries a sparse
    stype and an implementation is registered for the op's stype
    signature (``base.register_sparse_impl``), that one runs instead.
    Its ``__sparse_prepare__`` hook reads host-side facts (the nnz
    budget) from the concrete payloads first."""
    stypes = tuple(a.stype for a in args if isinstance(a, NDArray))
    if all(st == 'default' for st in stypes):
        return fn
    impl = lookup_sparse_impl(getattr(fn, '__name__', ''), stypes)
    if impl is None:
        return fn
    prepare = getattr(impl, '__sparse_prepare__', None)
    if prepare is None:
        return impl
    return functools.wraps(impl)(functools.partial(impl,
                                                   **prepare(args, kwargs)))


def imperative_invoke(op_name, *args, **kwargs):
    """Invoke a registered op by name (the MXImperativeInvokeEx analog,
    ref: include/mxnet/c_api.h:1251)."""
    return _invoke(get_op(op_name).fn, *args, **kwargs)


# ---- creation -----------------------------------------------------------

def array(source_array, ctx=None, dtype=None) -> NDArray:
    """From a numpy array, a nested list or an NDArray. As in the JAX
    package, float64 becomes float32 and int64 int32 unless ``dtype``
    says otherwise."""
    device = _device(ctx)
    if isinstance(source_array, NDArray):
        source_array = source_array.asnumpy()
    if dtype is not None and torch_dtype(dtype) == torch.bfloat16:
        return NDArray(torch.tensor(onp.asarray(source_array, 'float32'),
                                    device=device).to(torch.bfloat16))
    arr = onp.asarray(source_array,
                      dtype=onp.dtype(dtype) if dtype is not None else None)
    if arr.dtype == onp.float64 and dtype is None:
        arr = arr.astype(onp.float32)
    if arr.dtype == onp.int64 and dtype is None:
        arr = arr.astype(onp.int32)
    return NDArray(torch.tensor(arr, device=device))


def empty(shape, ctx=None, dtype='float32') -> NDArray:
    return zeros(shape, ctx, dtype)


def zeros(shape, ctx=None, dtype='float32', **kwargs) -> NDArray:
    return NDArray(_init.zeros(shape, dtype, ctx))


def ones(shape, ctx=None, dtype='float32', **kwargs) -> NDArray:
    return NDArray(_init.ones(shape, dtype, ctx))


def full(shape, val, ctx=None, dtype='float32') -> NDArray:
    return NDArray(_init.full(shape, val, dtype, ctx))


def arange(start, stop=None, step=1.0, repeat=1, ctx=None, dtype='float32'):
    return NDArray(_init.arange(start, stop, step, repeat, dtype, ctx))


def concat(*args, dim=1):
    return _invoke(_mat.concat, *args, dim=dim)


def stack(*args, axis=0):
    return _invoke(_mat.stack, *args, axis=axis)


def from_numpy(a, zero_copy=False):
    return array(a)


def from_dlpack(dl):
    return NDArray(torch.utils.dlpack.from_dlpack(dl))


def to_dlpack_for_read(arr):
    return arr.to_dlpack_for_read()


def waitall():
    """Ref: Engine::WaitForAll: wait for all work queued on the card."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


# ---- serialization (ref: src/ndarray/ndarray.cc Save/Load) ---------------

def save(fname, data):
    """Write the reference's binary container (ref: src/ndarray/
    ndarray.cc NDArray::Save), which the JAX package reads and writes."""
    from ..serialization import save_ndarray_file
    if isinstance(data, NDArray):
        payload = [data.asnumpy()]
    elif isinstance(data, (list, tuple)):
        if not all(isinstance(d, NDArray) for d in data):
            raise MXNetError("save expects a list of NDArrays")
        payload = [d.asnumpy() for d in data]
    elif isinstance(data, dict):
        payload = {k: v.asnumpy() for k, v in data.items()}
    else:
        raise MXNetError("save expects NDArray, list, or dict")
    blob = save_ndarray_file(payload)
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(os.path.abspath(fname)),
                               prefix='.nd-save-')
    try:
        with os.fdopen(fd, 'wb') as f:
            f.write(blob)
        os.replace(tmp, fname)
    except BaseException:
        os.unlink(tmp)
        raise


def _decode_loaded(entry, ctx):
    from ..serialization import sparse_to_dense
    if isinstance(entry, tuple):
        return array(sparse_to_dense(*entry), ctx=ctx)
    if entry is None:
        return None
    if entry.dtype.name == 'bfloat16':     # read through ml_dtypes
        return array(entry.astype(onp.float32), ctx=ctx, dtype='bfloat16')
    return array(entry, ctx=ctx)


def load_frombuffer(buf, ctx=None):
    """Ref: mx.nd.load_frombuffer (c_api MXNDArrayLoadFromBuffer). Arrays
    go to ``ctx`` (the current context when None)."""
    from ..serialization import is_ndarray_file, load_ndarray_file
    if not is_ndarray_file(buf):
        raise MXNetError("buffer is not an NDArray file")
    arrays, names = load_ndarray_file(buf)
    if names:
        return {k: _decode_loaded(v, ctx) for k, v in zip(names, arrays)}
    return [_decode_loaded(a, ctx) for a in arrays]


def load(fname, ctx=None):
    """Read a reference-format binary file (the JAX package's earliest
    pickle files are not readable here)."""
    with open(fname, 'rb') as f:
        return load_frombuffer(f.read(), ctx)
