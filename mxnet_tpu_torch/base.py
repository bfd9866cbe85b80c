"""Error type, op registry and thread-local autograd flags shared by every
module of the port (counterpart of ``mxnet_tpu/base.py``).

Ops are plain Python functions over ``torch.Tensor``s registered by name;
``mx.nd.<name>`` wraps each one for NDArrays (``ndarray/register.py``).
An op may also register a storage-specific implementation for the
storage types of its NDArray arguments (``register_sparse_impl``), which
``NDArray`` dispatch swaps in, as the JAX package's FComputeEx seam does.
The JAX package's op-use accounting is not carried over.
"""
from __future__ import annotations

import threading
from typing import Callable, Dict, Optional

import numpy as onp
import torch

__all__ = ['MXNetError', 'DataError', 'OpDef', 'register_op',
           'register_op_alias', 'get_op', 'list_ops',
           'register_sparse_impl', 'lookup_sparse_impl',
           'state', 'telem_flags', 'torch_dtype']


class MXNetError(RuntimeError):
    """Raised for invalid usage, bad inputs and kernel failures."""


class DataError(MXNetError):
    """A corrupt or truncated input record, with the record's index, its
    file offset and the file's path, so a caller can act on it; the
    image iterator can skip and count these instead
    (``MXNET_TPU_IO_CORRUPT_POLICY=skip``)."""

    def __init__(self, message, index=None, offset=None, path=None):
        super().__init__(message)
        self.index = index
        self.offset = offset
        self.path = path


_TORCH_DTYPES = {n: getattr(torch, n) for n in (
    'float16', 'bfloat16', 'float32', 'float64', 'uint8', 'int8', 'int16',
    'int32', 'int64', 'bool')}


def torch_dtype(dtype) -> torch.dtype:
    """A torch dtype from a torch dtype, a numpy dtype or type, or a name
    ('float32', 'bfloat16', ...)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    name = (dtype if isinstance(dtype, str) and dtype == 'bfloat16'
            else onp.dtype(dtype).name)
    if name not in _TORCH_DTYPES:
        raise MXNetError(f"unsupported dtype {dtype!r}")
    return _TORCH_DTYPES[name]


class OpDef:
    __slots__ = ('name', 'fn', 'num_outputs')

    def __init__(self, name: str, fn: Callable, num_outputs: int = 1):
        self.name = name
        self.fn = fn
        self.num_outputs = num_outputs   # -1: set by the op's arguments


_OP_REGISTRY: Dict[str, OpDef] = {}

# alias -> canonical name (the JAX package's ``register_op_alias``): an
# alias resolves through ``get_op`` and is not listed by ``list_ops``
_OP_ALIASES: Dict[str, str] = {}


def register_op(name: Optional[str] = None, num_outputs: int = 1):
    """Register a function over torch tensors as a framework op."""
    def deco(fn: Callable):
        opname = name or fn.__name__
        _OP_REGISTRY[opname] = OpDef(opname, fn, num_outputs)
        return fn
    return deco


def register_op_alias(alias: str, canonical: str):
    """Make ``alias`` resolve to the registered op ``canonical``."""
    if canonical not in _OP_REGISTRY:
        raise MXNetError(f"Cannot alias {alias!r}: target {canonical!r} "
                         f"is not registered")
    _OP_ALIASES[alias] = canonical


def get_op(name: str) -> OpDef:
    od = _OP_REGISTRY.get(name) or _OP_REGISTRY.get(_OP_ALIASES.get(name))
    if od is None:
        raise MXNetError(f"Operator {name!r} is not registered")
    return od


def list_ops():
    return sorted(_OP_REGISTRY)


# Storage-driven kernel dispatch (ref: FComputeEx,
# include/mxnet/op_attr_types.h:304): an op may register alternative
# implementations keyed by the storage types of its tensor arguments;
# NDArray dispatch swaps them in when the stype signature matches.
_SPARSE_IMPLS: Dict[tuple, Callable] = {}


def register_sparse_impl(opname: str, stypes: tuple):
    """Register a storage-specific implementation of ``opname`` for the
    given tuple of positional-argument storage types, e.g.
    ('csr', 'default')."""
    def deco(fn: Callable):
        _SPARSE_IMPLS[(opname, tuple(stypes))] = fn
        return fn
    return deco


def lookup_sparse_impl(opname: str, stypes: tuple):
    return _SPARSE_IMPLS.get((opname, tuple(stypes)))


class _ThreadLocalState(threading.local):
    """Thread-local runtime flags (ref: include/mxnet/imperative.h:206-212)."""

    def __init__(self):
        self.is_recording = False
        self.is_training = False
        self.record_depth = 0  # nesting depth of autograd.record scopes


state = _ThreadLocalState()

# PROCESS-wide telemetry gate (shared across threads, unlike the autograd
# flags above): written by telemetry.enable()/disable(), read inline by
# every instrumented path, so a disabled run pays one dict lookup per site
# and records nothing.
telem_flags = {'on': False}
