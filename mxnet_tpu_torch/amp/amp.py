"""Automatic mixed precision (counterpart of ``mxnet_tpu/amp/amp.py``,
ref: python/mxnet/contrib/amp/amp.py:82-215).

``init(target_dtype)`` rewrites the ``mxnet_tpu_torch.ndarray`` module in
place, as the reference rewrites its op namespaces: every op the policy
table (``lists.policy_table``) marks ``lp16`` casts its floating inputs to
the target dtype, every ``fp32`` op casts low-precision inputs up to f32,
and every ``widest`` op unifies a mix of f32 and low precision on f32.
That module is the ``F`` every ``hybrid_forward`` receives
(``gluon/block.py``), eager or hybridized, so one patch covers both; its
ops take NDArrays (the cast is recorded by ``mx.autograd``) or torch
tensors (the cast is a differentiable ``.to``). Ops the model calls
outside that namespace (the BERT layers' attention, ``add_layer_norm``
and ``dense_gelu``, as in the JAX package) are not cast.

The target is ``'bfloat16'`` (the default: f32's exponent range, so the
loss scale stays 1) or ``'float16'`` (MXNet 1.6's GPU target, with the
reference's dynamic loss scale of 2**16). On the card, float16 and
bfloat16 activations reach the hand-written kernels through their
tensor-core variants.
"""
from __future__ import annotations

import copy
import logging
from contextlib import contextmanager

import torch

from ..base import MXNetError, torch_dtype
from ..ndarray.ndarray import NDArray
from . import lists
from .loss_scaler import LossScaler

__all__ = ['init', 'init_trainer', 'scale_loss', 'unscale',
           'convert_hybrid_block', 'convert_model', 'list_lp16_ops',
           'list_fp32_ops', 'patch_epoch']

_amp_initialized = False
_target_dtype = 'bfloat16'
_originals = {}
_patch_epoch = 0  # bumped on init/_deinit; part of the CachedOp key

_LOW_DTYPES = ('float16', 'bfloat16')
_LOW = (torch.float16, torch.bfloat16)


def patch_epoch():
    return _patch_epoch


def _dtype_of(x):
    """The torch dtype of an NDArray or tensor, else None."""
    if isinstance(x, NDArray):
        return x._data.dtype
    if isinstance(x, torch.Tensor):
        return x.dtype
    return None


def _cast(x, dtype):
    """x in ``dtype`` when it is a floating NDArray or tensor of another
    dtype; anything else as it is."""
    dt = _dtype_of(x)
    if dt is None or not dt.is_floating_point or dt == dtype:
        return x
    return x.astype(dtype) if isinstance(x, NDArray) else x.to(dtype)


def _is_array(x):
    return isinstance(x, (NDArray, torch.Tensor))


def _map_args(args, kwargs, fn):
    new_args = [fn(a) if _is_array(a) else
                ([fn(e) if _is_array(e) else e for e in a]
                 if isinstance(a, (list, tuple)) else a)
                for a in args]
    new_kwargs = {k: (fn(v) if _is_array(v) else v)
                  for k, v in kwargs.items()}
    return new_args, new_kwargs


def _up(x):
    return _cast(x, torch.float32) if _dtype_of(x) in _LOW else x


def _wrap(orig, fn, tag):
    def wrapper(*args, **kwargs):
        a, k = _map_args(args, kwargs, fn)
        return orig(*a, **k)
    wrapper.__name__ = getattr(orig, '__name__', tag)
    wrapper.__amp_original__ = orig
    return wrapper


def _wrap_widest(orig):
    def wrapper(*args, **kwargs):
        leaves = [a for a in list(args) + list(kwargs.values())
                  if _is_array(a)]
        for a in args:
            if isinstance(a, (list, tuple)):
                leaves += [e for e in a if _is_array(e)]
        float_dts = {_dtype_of(x) for x in leaves
                     if _dtype_of(x).is_floating_point}
        if torch.float32 in float_dts and float_dts & set(_LOW):
            a, k = _map_args(args, kwargs, _up)
            return orig(*a, **k)
        return orig(*args, **kwargs)
    wrapper.__name__ = getattr(orig, '__name__', 'amp_widest')
    wrapper.__amp_original__ = orig
    return wrapper


def init(target_dtype='bfloat16'):
    """Turn on autocast (ref: amp.py:82 init): patches the nd namespace in
    place; ops in LP16_OPS run in ``target_dtype``, FP32_OPS in f32. A
    second call with another target is ignored with a warning, as in the
    reference."""
    global _amp_initialized, _target_dtype, _patch_epoch
    if target_dtype not in _LOW_DTYPES:
        raise MXNetError(f"AMP target_dtype must be one of {_LOW_DTYPES}, "
                         f"got {target_dtype!r}")
    if _amp_initialized:
        if target_dtype != _target_dtype:
            logging.warning(
                "amp.init(target_dtype=%r) ignored: AMP already initialized "
                "with target_dtype=%r", target_dtype, _target_dtype)
        return
    logging.info("Using AMP (target_dtype=%s)", target_dtype)
    _target_dtype = target_dtype
    _patch_epoch += 1
    low = torch_dtype(target_dtype)

    from .. import ndarray as ndmod
    wraps = {'lp16': lambda f: _wrap(f, lambda x: _cast(x, low), 'amp_lp16'),
             'fp32': lambda f: _wrap(f, _up, 'amp_fp32'),
             'widest': _wrap_widest}
    # 'passthrough' / 'nofloat': explicitly untouched
    for name, pol in sorted(lists.policy_table().items()):
        if pol in wraps and hasattr(ndmod, name):
            _originals[name] = getattr(ndmod, name)
            setattr(ndmod, name, wraps[pol](_originals[name]))
    _amp_initialized = True


def _deinit():
    """Undo init(): a test helper, the reference has no un-init."""
    global _amp_initialized, _patch_epoch
    from .. import ndarray as ndmod
    for name, orig in _originals.items():
        setattr(ndmod, name, orig)
    _originals.clear()
    _amp_initialized = False
    _patch_epoch += 1


def init_trainer(optimizer_or_trainer, loss_scale=None):
    """Attach a loss scaler to a Trainer (ref: amp.py init_trainer). With
    bfloat16 the default scale is 1.0 and the scaler is not dynamic
    unless another scale is given; float16 gets the reference's dynamic
    2**16."""
    from ..gluon.trainer import Trainer
    if not isinstance(optimizer_or_trainer, Trainer):
        raise MXNetError("init_trainer expects a gluon.Trainer")
    if loss_scale is None:
        loss_scale = 1.0 if _target_dtype == 'bfloat16' else 2.**16
    scaler = LossScaler(init_scale=loss_scale,
                        dynamic=(_target_dtype != 'bfloat16'
                                 or loss_scale != 1.0))
    optimizer_or_trainer._amp_loss_scaler = scaler
    optimizer_or_trainer._amp_original_scale = optimizer_or_trainer._scale
    return optimizer_or_trainer


def _scaler(trainer, what):
    scaler = getattr(trainer, '_amp_loss_scaler', None)
    if scaler is None:
        raise MXNetError(f"call amp.init_trainer(trainer) before {what}")
    return scaler


@contextmanager
def scale_loss(loss, optimizer_or_trainer):
    """Yields the loss times the loss scale (a list for a list) and sets
    the trainer to divide the gradients by it at ``step()`` (ref: amp.py
    scale_loss). At scale 1 the loss itself is yielded."""
    scaler = _scaler(optimizer_or_trainer, 'scale_loss')
    optimizer_or_trainer._scale = (optimizer_or_trainer._amp_original_scale /
                                   scaler.loss_scale)
    if scaler.loss_scale == 1.0:
        yield loss
    elif isinstance(loss, (list, tuple)):
        yield [l * scaler.loss_scale for l in loss]
    else:
        yield loss * scaler.loss_scale


def unscale(optimizer_or_trainer):
    """Divide the gradients by the loss scale in place; ``step()`` then
    divides by nothing more."""
    from ..gluon.parameter import tensor_of
    scaler = _scaler(optimizer_or_trainer, 'unscale')
    for p in optimizer_or_trainer._params:
        g = tensor_of(p).grad
        if g is not None:
            g.div_(scaler.loss_scale)
    optimizer_or_trainer._scale = optimizer_or_trainer._amp_original_scale


_NORM_PARAM_SUFFIXES = ('gamma', 'beta', 'running_mean', 'running_var',
                        'moving_mean', 'moving_var')


def convert_hybrid_block(block, target_dtype='bfloat16',
                         cast_optional_params=False):
    """A low-precision copy of a trained block for inference (ref: amp.py
    convert_hybrid_block); the input block is left untouched. The copy's
    floating weights are cast to ``target_dtype`` (norm-layer parameters
    stay f32 unless ``cast_optional_params``), and it is wrapped in a
    block that casts the inputs down and the outputs back to f32, the
    reference's inserted amp_cast symbols."""
    from .. import gluon
    low = torch_dtype(target_dtype)
    block = copy.deepcopy(block)
    for name, p in block.collect_params().items():
        if not cast_optional_params and name.endswith(_NORM_PARAM_SUFFIXES):
            continue
        if p._is_materialized() and p._dtype.is_floating_point:
            p.cast(low)

    class _AMPConverted(gluon.HybridBlock):
        def __init__(self, inner):
            super().__init__()
            self.inner = inner

        def hybrid_forward(self, F, *args):
            out = self.inner(*(_cast(a, low) for a in args))
            if isinstance(out, (list, tuple)):
                return type(out)(_cast(o, torch.float32) for o in out)
            return _cast(out, torch.float32)

    return _AMPConverted(block)


def convert_model(*args, **kwargs):
    raise NotImplementedError(
        "convert_model operates on the legacy symbol API; use "
        "convert_hybrid_block (Module users: rebuild via gluon)")


def list_lp16_ops():
    return list(lists.LP16_OPS)


def list_fp32_ops():
    return list(lists.FP32_OPS)
