"""Weight initializers (counterpart of ``mxnet_tpu/initializer.py``, ref:
python/mxnet/initializer.py).

An initializer is called as MXNet calls it, ``init(InitDesc(name), arr)``,
and fills ``arr`` (a torch tensor or an NDArray) by the parameter's name:
``*weight`` takes the initializer's own rule, ``*bias`` and ``*beta``
zero, ``*gamma`` one, ``*running_mean`` zero and ``*running_var`` one,
anything else the weight rule. An ``__init__`` attribute on the
descriptor overrides the rule, as in MXNet.

Random values are drawn on the CPU from a ``torch.Generator`` (the port's
CPU generator, ``random.generator('cpu')``, which ``mx.random.seed``
seeds, unless one is passed) and then copied to the parameter's device,
so they do not depend on the device. They are not the JAX package's
numbers (that one draws from numpy's global generator): parity tests
carry weights across by name, and the rules are checked by their
statistics.

The port's earlier call form ``init(module, generator)`` stays: it fills
every parameter of a ``torch.nn.Module`` whose name ends in ``weight``
and leaves the others at their constructed values.
"""
from __future__ import annotations

import json
import math
import re

import torch

from .base import MXNetError
from . import random as _random

__all__ = ['InitDesc', 'Initializer', 'Zero', 'One', 'Constant', 'Uniform',
           'Normal', 'Xavier', 'MSRAPrelu', 'Orthogonal', 'Bilinear',
           'LSTMBias', 'Mixed', 'create', 'register']

_REGISTRY = {}


def register(cls, name=None):
    """Register an Initializer class under its lower-case name (and
    ``name``), for ``create``."""
    _REGISTRY[(name or cls.__name__).lower()] = cls
    return cls


class InitDesc(str):
    """A parameter's name with its attributes (ref: initializer.py
    InitDesc)."""

    def __new__(cls, name, attrs=None, global_init=None):
        ret = super().__new__(cls, name)
        ret.attrs = attrs or {}
        ret.global_init = global_init
        return ret


def _fill(arr, value):
    """Write ``value`` (a CPU f32 tensor) into ``arr`` on its device and in
    its dtype."""
    from .ndarray.ndarray import NDArray
    if isinstance(arr, NDArray):
        arr[:] = value.to(arr._data.device)
        return
    with torch.no_grad():
        arr.copy_(value.to(device=arr.device, dtype=arr.dtype))


class Initializer:
    """Base class: the name-pattern dispatch and the constant rules."""

    def __init__(self, **kwargs):
        self._kwargs = kwargs
        self._gen = None

    def __call__(self, desc, arr=None):
        if isinstance(desc, torch.nn.Module):
            return self._init_module(desc, arr)
        if not isinstance(desc, str):
            raise TypeError("initializer first arg must be a name/InitDesc")
        name = str(desc)
        init_attr = getattr(desc, 'attrs', {}).get('__init__', '')
        if init_attr:
            create(init_attr)._init_weight(name, arr)
            return
        if name.endswith('weight'):
            self._init_weight(name, arr)
        elif name.endswith('bias'):
            self._init_bias(name, arr)
        elif name.endswith('gamma'):
            self._init_gamma(name, arr)
        elif name.endswith('beta'):
            self._init_beta(name, arr)
        elif name.endswith('running_mean') or name.endswith('moving_mean'):
            self._init_zero(name, arr)
        elif name.endswith('running_var') or name.endswith('moving_var'):
            self._init_one(name, arr)
        else:
            self._init_default(name, arr)

    def _init_module(self, module, generator=None):
        """The earlier call form: every ``*weight`` parameter of ``module``
        by the weight rule, drawn from ``generator`` (a CPU generator)."""
        prev, self._gen = self._gen, generator
        try:
            for name, p in module.named_parameters():
                if name.endswith('weight'):
                    self._init_weight(name, p)
        finally:
            self._gen = prev
        return module

    # ---- drawing, on the CPU -------------------------------------------
    def _generator(self):
        return self._gen if self._gen is not None else \
            _random.generator('cpu')

    def _uniform(self, shape, low, high):
        u = torch.rand(tuple(shape), generator=self._generator(),
                       dtype=torch.float32)
        return u * (high - low) + low

    def _normal(self, shape, sigma):
        return torch.randn(tuple(shape), generator=self._generator(),
                           dtype=torch.float32) * sigma

    # ---- the rules --------------------------------------------------------
    def init_weight(self, name, arr):
        self._init_weight(name, arr)

    def _init_zero(self, name, arr):
        _fill(arr, torch.zeros(tuple(arr.shape)))

    def _init_one(self, name, arr):
        _fill(arr, torch.ones(tuple(arr.shape)))

    def _init_bias(self, name, arr):
        self._init_zero(name, arr)

    def _init_gamma(self, name, arr):
        self._init_one(name, arr)

    def _init_beta(self, name, arr):
        self._init_zero(name, arr)

    def _init_weight(self, name, arr):
        raise NotImplementedError

    def _init_default(self, name, arr):
        self._init_weight(name, arr)

    def __repr__(self):
        return f"{type(self).__name__}({self._kwargs})"

    def dumps(self):
        return json.dumps([type(self).__name__.lower(), self._kwargs])


@register
class Zero(Initializer):
    def _init_weight(self, name, arr):
        self._init_zero(name, arr)


@register
class One(Initializer):
    def _init_weight(self, name, arr):
        self._init_one(name, arr)


@register
class Constant(Initializer):
    def __init__(self, value=0.0):
        super().__init__(value=value)
        self.value = value

    def _init_weight(self, name, arr):
        _fill(arr, torch.full(tuple(arr.shape), float(self.value)))


@register
class Uniform(Initializer):
    """U(-scale, scale)."""

    def __init__(self, scale=0.07):
        super().__init__(scale=scale)
        self.scale = scale

    def _init_weight(self, name, arr):
        _fill(arr, self._uniform(arr.shape, -self.scale, self.scale))


@register
class Normal(Initializer):
    """N(0, sigma^2)."""

    def __init__(self, sigma=0.01):
        super().__init__(sigma=sigma)
        self.sigma = sigma

    def _init_weight(self, name, arr):
        _fill(arr, self._normal(arr.shape, self.sigma))


@register
class Xavier(Initializer):
    """scale = sqrt(magnitude / factor), factor the mean of fan in and
    fan out ('avg'), fan in ('in') or fan out ('out'), each times the
    receptive field; U(-scale, scale) or N(0, scale^2) ('gaussian')."""

    def __init__(self, rnd_type='uniform', factor_type='avg', magnitude=3):
        super().__init__(rnd_type=rnd_type, factor_type=factor_type,
                         magnitude=magnitude)
        self.rnd_type = rnd_type
        self.factor_type = factor_type
        self.magnitude = float(magnitude)

    def _init_weight(self, name, arr):
        shape = tuple(arr.shape)
        if len(shape) < 2:
            raise MXNetError(f"Xavier requires ndim>=2, got shape {shape} "
                             f"for {name}")
        hw_scale = math.prod(shape[2:]) if len(shape) > 2 else 1.0
        fan_in, fan_out = shape[1] * hw_scale, shape[0] * hw_scale
        factor = {'avg': (fan_in + fan_out) / 2.0, 'in': fan_in,
                  'out': fan_out}[self.factor_type]
        scale = math.sqrt(self.magnitude / factor)
        if self.rnd_type == 'uniform':
            _fill(arr, self._uniform(shape, -scale, scale))
        else:
            _fill(arr, self._normal(shape, scale))


@register
class MSRAPrelu(Xavier):
    """Xavier, gaussian, magnitude 2 / (1 + slope^2)."""

    def __init__(self, factor_type='avg', slope=0.25):
        super().__init__('gaussian', factor_type, 2.0 / (1 + slope ** 2))
        self._kwargs = {'factor_type': factor_type, 'slope': slope}


@register
class Orthogonal(Initializer):
    """scale times an orthonormal basis from the SVD of a random (out, in)
    matrix."""

    def __init__(self, scale=1.414, rand_type='uniform'):
        super().__init__(scale=scale, rand_type=rand_type)
        self.scale = scale
        self.rand_type = rand_type

    def _init_weight(self, name, arr):
        nout = arr.shape[0]
        nin = math.prod(arr.shape[1:])
        if self.rand_type == 'uniform':
            tmp = self._uniform((nout, nin), -1.0, 1.0).double()
        else:
            tmp = self._normal((nout, nin), 1.0).double()
        u, _, v = torch.linalg.svd(tmp, full_matrices=False)
        q = u if u.shape == tmp.shape else v
        _fill(arr, (self.scale * q.reshape(tuple(arr.shape))).float())


@register
class Bilinear(Initializer):
    """The bilinear upsampling kernel over the last two axes."""

    def _init_weight(self, name, arr):
        shape = tuple(arr.shape)
        f = math.ceil(shape[3] / 2.0)
        c = (2 * f - 1 - f % 2) / (2.0 * f)
        x = torch.arange(shape[3], dtype=torch.float64)
        y = torch.arange(shape[2], dtype=torch.float64)
        k = (1 - (x / f - c).abs())[None, :] * (1 - (y / f - c).abs())[:, None]
        _fill(arr, k.float().expand(shape).contiguous())


@register
class LSTMBias(Initializer):
    """Zero, except the forget gate's quarter, which is forget_bias."""

    def __init__(self, forget_bias=1.0):
        super().__init__(forget_bias=forget_bias)
        self.forget_bias = forget_bias

    def _init_weight(self, name, arr):
        b = torch.zeros(tuple(arr.shape))
        num_hidden = arr.shape[0] // 4
        b[num_hidden:2 * num_hidden] = self.forget_bias
        _fill(arr, b)

    _init_bias = _init_weight
    _init_default = _init_weight


register(Zero, 'zeros')
register(One, 'ones')
register(Normal, 'gaussian')


def create(name, **kwargs):
    """An Initializer from an instance, a registered name or a ``dumps()``
    string."""
    if isinstance(name, Initializer):
        return name
    if isinstance(name, str) and name.startswith('['):
        kind, kw = json.loads(name)
        return _REGISTRY[kind](**kw)
    key = str(name).lower()
    if key not in _REGISTRY:
        raise MXNetError(f"initializer {name!r} is not registered; "
                         f"known: {sorted(_REGISTRY)}")
    return _REGISTRY[key](**kwargs)


class Mixed:
    """The first initializer whose pattern matches the name (ref:
    initializer.py Mixed)."""

    def __init__(self, patterns, initializers):
        self.map = [(re.compile(p), create(i))
                    for p, i in zip(patterns, initializers)]

    def __call__(self, name, arr):
        for pat, init in self.map:
            if pat.match(str(name)):
                init(name, arr)
                return
        raise MXNetError(f"no initializer pattern matched {name}")
