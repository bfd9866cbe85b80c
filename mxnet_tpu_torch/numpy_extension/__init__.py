"""``mx.npx``: the numpy extension ops on ``mx.np`` arrays (counterpart of
``mxnet_tpu/numpy_extension/__init__.py``, ref:
python/mxnet/numpy_extension/): the NN ops numpy has no name for,
``npx.random`` and ``npx.image``, ``save``/``load``, the np switches of
``util``, and every other registered op by its name (``__getattr__``).
"""
from __future__ import annotations

import torch

from ..numpy import ndarray, _unwrap
from ..ops import nn as _nn, index as _idx, sequence as _seq
from ..ops import matrix as _mat
from ..util import (set_np, reset_np, is_np_array, is_np_shape,  # noqa: F401
                    use_np, use_np_array, use_np_shape)
from ..context import cpu, gpu, num_gpus  # noqa: F401


def _wrap_out(out):
    if isinstance(out, tuple):
        return tuple(ndarray(o) for o in out)
    return ndarray(out)


def _opt(x):
    return None if x is None else _unwrap(x)


def softmax(data, axis=-1, length=None, temperature=None):
    return _wrap_out(_nn.softmax(_unwrap(data), axis=axis,
                                 temperature=temperature,
                                 length=_opt(length)))


def log_softmax(data, axis=-1, temperature=None):
    return _wrap_out(_nn.log_softmax(_unwrap(data), axis=axis,
                                     temperature=temperature))


def relu(data):
    return _wrap_out(torch.relu(_unwrap(data)))


def sigmoid(data):
    return _wrap_out(torch.sigmoid(_unwrap(data)))


def activation(data, act_type='relu'):
    return _wrap_out(_nn.activation(_unwrap(data), act_type=act_type))


def fully_connected(x, weight, bias=None, num_hidden=None, no_bias=False,
                    flatten=True):
    return _wrap_out(_nn.fully_connected(
        _unwrap(x), _unwrap(weight), _opt(bias), num_hidden=num_hidden,
        no_bias=no_bias, flatten=flatten))


def convolution(data=None, weight=None, bias=None, **kwargs):
    return _wrap_out(_nn.convolution(_unwrap(data), _unwrap(weight),
                                     _opt(bias), **kwargs))


def pooling(data=None, **kwargs):
    return _wrap_out(_nn.pooling(_unwrap(data), **kwargs))


def batch_norm(x, gamma, beta, running_mean, running_var, **kwargs):
    out, _, _ = _nn.batch_norm(_unwrap(x), _unwrap(gamma), _unwrap(beta),
                               _unwrap(running_mean), _unwrap(running_var),
                               **kwargs)
    return ndarray(out)


def layer_norm(data, gamma, beta, axis=-1, eps=1e-5):
    return _wrap_out(_nn.layer_norm(_unwrap(data), _unwrap(gamma),
                                    _unwrap(beta), axis=axis, eps=eps))


def embedding(data, weight, input_dim=None, output_dim=None,
              dtype='float32', sparse_grad=False):
    return _wrap_out(_nn.embedding(_unwrap(data), _unwrap(weight)))


def topk(data, axis=-1, k=1, ret_typ='indices', is_ascend=False,
         dtype='float32'):
    return _wrap_out(_mat.topk(_unwrap(data), axis=axis, k=k,
                               ret_typ=ret_typ, is_ascend=is_ascend,
                               dtype=dtype))


def pick(data, index, axis=-1, mode='clip', keepdims=False):
    return _wrap_out(_idx.pick(_unwrap(data), _unwrap(index), axis=axis,
                               keepdims=keepdims, mode=mode))


def one_hot(data, depth=None, on_value=1.0, off_value=0.0, dtype='float32'):
    return _wrap_out(_nn.one_hot(_unwrap(data), depth=depth,
                                 on_value=on_value, off_value=off_value,
                                 dtype=dtype))


def gather_nd(data, indices):
    return _wrap_out(_idx.gather_nd(_unwrap(data), _unwrap(indices)))


def reshape_like(lhs, rhs):
    return _wrap_out(_unwrap(lhs).reshape(_unwrap(rhs).shape))


def sequence_mask(data, sequence_length=None, use_sequence_length=False,
                  value=0., axis=0):
    return _wrap_out(_seq.sequence_mask(
        _unwrap(data), _opt(sequence_length),
        use_sequence_length=use_sequence_length, value=value, axis=axis))


def seed(s):
    from .. import random as _r
    _r.seed(s)


def waitall():
    from ..ndarray import waitall as _w
    _w()


def save(file, arr):
    """Save a dict or list of np arrays in the .params container (ref:
    numpy_extension/utils.py save)."""
    from .. import ndarray as _nd
    if isinstance(arr, dict):
        _nd.save(file, {k: _nd.NDArray(_unwrap(v)) for k, v in arr.items()})
        return
    if not isinstance(arr, (list, tuple)):
        arr = [arr]
    _nd.save(file, [_nd.NDArray(_unwrap(a)) for a in arr])


def load(file):
    """Load a .params file into np arrays."""
    from .. import ndarray as _nd
    out = _nd.load(file)
    if isinstance(out, dict):
        return {k: ndarray(v._data) for k, v in out.items()}
    return [ndarray(v._data) for v in out]


def _registered(name, *args, **kwargs):
    from ..base import get_op
    return _wrap_out(get_op(name).fn(
        *[_unwrap(a) for a in args],
        **{k: _unwrap(v) for k, v in kwargs.items()}))


class random:
    """``npx.random``: samplers that draw one batch per parameter row
    (ref: numpy_extension/random.py bernoulli/normal_n/uniform_n)."""

    @staticmethod
    def bernoulli(prob=0.5, size=None, dtype='float32'):
        return _registered('_npi_bernoulli', prob, size=size, dtype=dtype)

    @staticmethod
    def normal_n(loc=0.0, scale=1.0, batch_shape=None, dtype='float32'):
        shp = None
        if batch_shape is not None:
            shp = tuple(batch_shape) + tuple(getattr(_unwrap(loc), 'shape',
                                                     ()))
        return _registered('_npi_normal', loc, scale, size=shp, dtype=dtype)

    @staticmethod
    def uniform_n(low=0.0, high=1.0, batch_shape=None, dtype='float32'):
        shp = None
        if batch_shape is not None:
            shp = tuple(batch_shape) + tuple(getattr(_unwrap(low), 'shape',
                                                     ()))
        return _registered('_npi_uniform', low, high, size=shp, dtype=dtype)

    seed = staticmethod(seed)


class image:
    """``npx.image`` (ref: numpy_extension/image.py): the registered
    image ops over np arrays, HWC, float or uint8."""

    _op = staticmethod(_registered)
    resize = staticmethod(lambda data, size, **kw: _registered(
        'image_resize', data, size=size, **kw))
    crop = staticmethod(lambda data, x, y, width, height: _registered(
        'image_crop', data, x=x, y=y, width=width, height=height))
    to_tensor = staticmethod(lambda data: _registered('image_to_tensor',
                                                      data))
    normalize = staticmethod(lambda data, mean=0.0, std=1.0: _registered(
        'image_normalize', data, mean=mean, std=std))
    flip_left_right = staticmethod(
        lambda data: _registered('image_flip_left_right', data))
    flip_top_bottom = staticmethod(
        lambda data: _registered('image_flip_top_bottom', data))
    random_flip_left_right = staticmethod(lambda data, p=0.5: _registered(
        '_image_random_flip_left_right', data, p=p))
    random_flip_top_bottom = staticmethod(lambda data, p=0.5: _registered(
        '_image_random_flip_top_bottom', data, p=p))
    random_brightness = staticmethod(
        lambda data, min_factor, max_factor: _registered(
            '_image_random_brightness', data, min_factor=min_factor,
            max_factor=max_factor))
    random_contrast = staticmethod(
        lambda data, min_factor, max_factor: _registered(
            '_image_random_contrast', data, min_factor=min_factor,
            max_factor=max_factor))
    random_saturation = staticmethod(
        lambda data, min_factor, max_factor: _registered(
            '_image_random_saturation', data, min_factor=min_factor,
            max_factor=max_factor))
    random_hue = staticmethod(
        lambda data, min_factor, max_factor: _registered(
            '_image_random_hue', data, min_factor=min_factor,
            max_factor=max_factor))
    random_color_jitter = staticmethod(
        lambda data, brightness=0.0, contrast=0.0, saturation=0.0, hue=0.0:
        _registered('_image_random_color_jitter', data,
                    brightness=brightness, contrast=contrast,
                    saturation=saturation, hue=hue))
    random_lighting = staticmethod(lambda data, alpha_std=0.05: _registered(
        '_image_random_lighting', data, alpha_std=alpha_std))


def __getattr__(name):
    """Any registered op (or alias) is ``npx.<name>``, as MXNet generates
    npx from its registry (numpy_extension/_register.py); the wrappers
    above take precedence."""
    if name.startswith('_'):
        raise AttributeError(name)
    from ..base import get_op, MXNetError
    try:
        op = get_op(name)
    except MXNetError:
        raise AttributeError(
            f"module 'mxnet_tpu_torch.numpy_extension' has no attribute "
            f"{name!r}") from None

    def f(*args, **kwargs):
        return _wrap_out(op.fn(*[_unwrap(a) for a in args],
                               **{k: _unwrap(v) for k, v in kwargs.items()}))
    f.__name__ = f.__qualname__ = name
    f.__doc__ = op.doc
    globals()[name] = f
    return f
