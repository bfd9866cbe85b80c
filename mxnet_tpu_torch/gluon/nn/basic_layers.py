"""Basic layers as Gluon Blocks (counterpart of ``mxnet_tpu/gluon/nn/
basic_layers.py``, ref: python/mxnet/gluon/nn/basic_layers.py).

Each layer takes MXNet's arguments and, for the port's own models, two of
its own: ``device`` (a layer built with it is usable at once, its
weights zero until an initializer or a weight file fills them, see
``gluon/parameter.py``) and, for Dropout, ``generator`` (the
``torch.Generator`` its noise is drawn from, on the input's device; None
draws from that device's default one; a generator on another device
raises). ``dtype`` may be a name or a torch dtype. ``in_units=0`` /
``in_channels=0`` defer the shape to the first forward. Parameter names
are the JAX package's (``weight``/``bias``, ``gamma``/``beta``,
``running_mean``/``running_var``).

``SyncBatchNorm`` waits for data parallelism (ROADMAP queue 1 item 6).
"""
from __future__ import annotations

import math

import torch

from ...base import MXNetError
from ...ops import nn as _nn_ops
from ..block import Block, HybridBlock

__all__ = ['Sequential', 'HybridSequential', 'Dense', 'Dropout',
           'BatchNorm', 'SyncBatchNorm', 'LayerNorm', 'GroupNorm',
           'InstanceNorm', 'Embedding', 'Flatten', 'Lambda', 'HybridLambda']


class _Stack:
    """What Sequential and HybridSequential share."""

    def add(self, *blocks):
        for block in blocks:
            self.register_child(block)

    def forward(self, x):
        for block in self._children.values():
            x = block(x)
        return x

    def __getitem__(self, key):
        layers = list(self._children.values())[key]
        if isinstance(layers, list):
            net = type(self)(prefix=self._prefix)
            with net.name_scope():
                net.add(*layers)
            return net
        return layers

    def __len__(self):
        return len(self._children)

    def __iter__(self):
        return iter(self._children.values())


class Sequential(_Stack, Block):
    """Stack of blocks (ref: basic_layers.py Sequential)."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix, params)


class HybridSequential(_Stack, HybridBlock):
    """Hybridizable stack (ref: basic_layers.py HybridSequential)."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix, params)


class Dense(HybridBlock):
    """y = act(x W^T + b), W (units, in_units) (ref: basic_layers.py
    Dense)."""

    def __init__(self, units, activation=None, use_bias=True, flatten=True,
                 dtype='float32', weight_initializer=None,
                 bias_initializer='zeros', in_units=0, device=None,
                 **kwargs):
        super().__init__(**kwargs)
        self._units = units
        self._flatten = flatten
        self._act_type = activation
        with self.name_scope():
            self.weight = self.params.get(
                'weight', shape=(units, in_units), dtype=dtype,
                init=weight_initializer, allow_deferred_init=True,
                device=device)
            if use_bias:
                self.bias = self.params.get(
                    'bias', shape=(units,), dtype=dtype,
                    init=bias_initializer, allow_deferred_init=True,
                    device=device)
            else:
                self.bias = None

    def _infer_param_shapes(self, x, args):
        in_units = math.prod(x.shape[1:]) if self._flatten else x.shape[-1]
        self.weight._finish_deferred_init((self._units, in_units))

    def hybrid_forward(self, F, x, weight, bias=None):
        out = F.fully_connected(x, weight, bias, num_hidden=self._units,
                                no_bias=bias is None, flatten=self._flatten)
        if self._act_type is not None:
            out = F.activation(out, act_type=self._act_type)
        return out

    def __repr__(self):
        shape = self.weight.shape
        return (f"Dense({shape[1] if shape and len(shape) > 1 else None} -> "
                f"{self._units}, "
                f"{'linear' if self._act_type is None else self._act_type})")


class Dropout(HybridBlock):
    """Zero each element with probability ``rate`` in training mode and
    scale the rest by 1/(1-rate); ``axes`` share one draw along them."""

    def __init__(self, rate, axes=(), generator=None, **kwargs):
        super().__init__(**kwargs)
        self._rate = rate
        self._axes = tuple(axes)
        self.generator = generator

    def forward(self, x):
        if not isinstance(x, torch.Tensor):
            # a Symbol: the JAX layer's graph
            from ... import symbol as F
            if self._rate > 0:
                return F.dropout(x, p=self._rate, axes=self._axes)
            return F.identity(x)
        return _nn_ops.dropout(x, self._rate, self.training, self.generator,
                               self._axes)

    def __repr__(self):
        return f"Dropout(p = {self._rate}, axes={self._axes})"


class BatchNorm(HybridBlock):
    """Batch normalisation over ``axis`` (ref: basic_layers.py BatchNorm).
    In training mode each forward updates running_mean and running_var in
    place: ``momentum`` of the old value plus the batch's mean and biased
    variance, in the parameters' dtype (``ops.nn.batch_norm``)."""

    def __init__(self, axis=1, momentum=0.9, epsilon=1e-5, center=True,
                 scale=True, use_global_stats=False,
                 beta_initializer='zeros', gamma_initializer='ones',
                 running_mean_initializer='zeros',
                 running_variance_initializer='ones', in_channels=0,
                 device=None, dtype='float32', **kwargs):
        super().__init__(**kwargs)
        self._kwargs = {'axis': axis, 'eps': epsilon, 'momentum': momentum,
                        'fix_gamma': not scale,
                        'use_global_stats': use_global_stats}
        self._axis = axis
        kw = dict(shape=(in_channels,), allow_deferred_init=True,
                  device=device, dtype=dtype)
        self.gamma = self.params.get(
            'gamma', grad_req='write' if scale else 'null',
            init=gamma_initializer, differentiable=scale, **kw)
        self.beta = self.params.get(
            'beta', grad_req='write' if center else 'null',
            init=beta_initializer, differentiable=center, **kw)
        self.running_mean = self.params.get(
            'running_mean', grad_req='null', init=running_mean_initializer,
            differentiable=False, **kw)
        self.running_var = self.params.get(
            'running_var', grad_req='null',
            init=running_variance_initializer, differentiable=False, **kw)

    def _infer_param_shapes(self, x, args):
        c = x.shape[self._axis]
        for p in (self.gamma, self.beta, self.running_mean, self.running_var):
            if not p._is_materialized():
                p._finish_deferred_init((c,))

    def hybrid_forward(self, F, x, gamma, beta, running_mean, running_var):
        if not isinstance(x, torch.Tensor):
            # a Symbol: the inference graph, as the JAX layer traces it
            return F.batch_norm(x, gamma, beta, running_mean, running_var,
                                **self._kwargs)[0]
        out, new_mean, new_var = F.batch_norm(
            x, gamma, beta, running_mean, running_var,
            training=self.training, **self._kwargs)
        if self.training and not self._kwargs['use_global_stats']:
            with torch.no_grad():
                running_mean.copy_(new_mean)
                running_var.copy_(new_var)
        return out

    def __repr__(self):
        shape = self.gamma.shape
        return (f"BatchNorm(axis={self._axis}, "
                f"in_channels={shape[0] if shape else None})")


class SyncBatchNorm(BatchNorm):
    """Cross-device BatchNorm (ref: src/operator/contrib/sync_batch_norm.cc).

    Inside a world of more than one rank, under ``collectives.data_axis``
    (the compiled step declares it around its forward), the batch
    statistics are the world's (``ops.nn.sync_batch_norm_op``); otherwise
    it is BatchNorm, as in the JAX package. ``num_devices`` is accepted
    and unused: the world's size counts."""

    def __init__(self, in_channels=0, num_devices=None, **kwargs):
        super().__init__(in_channels=in_channels, **kwargs)
        self._num_devices = num_devices

    def hybrid_forward(self, F, x, gamma, beta, running_mean, running_var):
        from ...parallel import collectives
        axis_name = collectives.current_data_axis()
        if axis_name is None:
            return super().hybrid_forward(F, x, gamma, beta, running_mean,
                                          running_var)
        out, new_mean, new_var = F.sync_batch_norm_op(
            x, gamma, beta, running_mean, running_var, axis_name=axis_name,
            training=self.training, **self._kwargs)
        if self.training and not self._kwargs['use_global_stats']:
            with torch.no_grad():
                running_mean.copy_(new_mean)
                running_var.copy_(new_var)
        return out


class _Norm(HybridBlock):
    """gamma and beta of ``in_channels`` (deferred when 0), the channel
    read from ``self._channel_axis`` of the input."""

    _channel_axis = 1

    def __init__(self, center, scale, beta_initializer, gamma_initializer,
                 in_channels, device, dtype, **kwargs):
        super().__init__(**kwargs)
        kw = dict(shape=(in_channels,), allow_deferred_init=True,
                  device=device, dtype=dtype)
        self.gamma = self.params.get(
            'gamma', grad_req='write' if scale else 'null',
            init=gamma_initializer, **kw)
        self.beta = self.params.get(
            'beta', grad_req='write' if center else 'null',
            init=beta_initializer, **kw)

    def _infer_param_shapes(self, x, args):
        c = x.shape[self._channel_axis]
        for p in (self.gamma, self.beta):
            if not p._is_materialized():
                p._finish_deferred_init((c,))


class LayerNorm(_Norm):
    """Normalise over ``axis``, statistics in f32 (ref: basic_layers.py
    LayerNorm)."""

    def __init__(self, axis=-1, epsilon=1e-5, center=True, scale=True,
                 beta_initializer='zeros', gamma_initializer='ones',
                 in_channels=0, device=None, dtype='float32', **kwargs):
        self._axis = self._channel_axis = axis
        self._epsilon = epsilon
        super().__init__(center, scale, beta_initializer, gamma_initializer,
                         in_channels, device, dtype, **kwargs)

    def hybrid_forward(self, F, x, gamma, beta):
        return F.layer_norm(x, gamma, beta, axis=self._axis,
                            eps=self._epsilon)


class GroupNorm(_Norm):
    """Normalise each group of channels (ref: basic_layers.py GroupNorm)."""

    def __init__(self, num_groups=1, epsilon=1e-5, center=True, scale=True,
                 beta_initializer='zeros', gamma_initializer='ones',
                 in_channels=0, device=None, dtype='float32', **kwargs):
        self._num_groups = num_groups
        self._epsilon = epsilon
        super().__init__(center, scale, beta_initializer, gamma_initializer,
                         in_channels, device, dtype, **kwargs)

    def hybrid_forward(self, F, x, gamma, beta):
        return F.group_norm(x, gamma, beta, num_groups=self._num_groups,
                            eps=self._epsilon)


class InstanceNorm(_Norm):
    """Normalise each (sample, channel) (ref: basic_layers.py
    InstanceNorm)."""

    def __init__(self, axis=1, epsilon=1e-5, center=True, scale=False,
                 beta_initializer='zeros', gamma_initializer='ones',
                 in_channels=0, device=None, dtype='float32', **kwargs):
        self._axis = self._channel_axis = axis
        self._epsilon = epsilon
        super().__init__(center, scale, beta_initializer, gamma_initializer,
                         in_channels, device, dtype, **kwargs)

    def hybrid_forward(self, F, x, gamma, beta):
        return F.instance_norm(x, gamma, beta, eps=self._epsilon)


class Embedding(HybridBlock):
    """Row lookup in a (input_dim, output_dim) table (ref: basic_layers.py
    Embedding). ``sparse_grad=True`` declares the weight's gradient
    ``row_sparse``: ``weight.grad()`` is a RowSparseNDArray, the Trainer's
    SGD and Adam update only the rows a batch looked up (``lazy_update``),
    and ``ShardedTrainStep`` takes the table's RowSparse path (deduped row
    blocks, live-row updates inside the captured step)."""

    def __init__(self, input_dim, output_dim, dtype='float32',
                 weight_initializer=None, sparse_grad=False, device=None,
                 **kwargs):
        super().__init__(**kwargs)
        self._input_dim = input_dim
        self._output_dim = output_dim
        self._sparse_grad = sparse_grad
        self.weight = self.params.get(
            'weight', shape=(input_dim, output_dim), dtype=dtype,
            init=weight_initializer, allow_deferred_init=True, device=device,
            grad_stype='row_sparse' if sparse_grad else 'default')

    def hybrid_forward(self, F, x, weight):
        return F.embedding(x, weight, input_dim=self._input_dim,
                           output_dim=self._output_dim,
                           sparse_grad=self._sparse_grad)

    def __repr__(self):
        return f"Embedding({self._input_dim} -> {self._output_dim})"


class Flatten(HybridBlock):
    def hybrid_forward(self, F, x):
        return F.flatten(x)

    def __repr__(self):
        return "Flatten"


def _nd_function(name):
    from ... import ndarray as nd_mod
    try:
        return getattr(nd_mod, name)
    except AttributeError:
        raise MXNetError(f"Function name {name} is not found in nd.") \
            from None


class Lambda(Block):
    """A function as a Block (ref: basic_layers.py Lambda)."""

    def __init__(self, function, prefix=None):
        super().__init__(prefix=prefix)
        if isinstance(function, str):
            self._func_impl = _nd_function(function)
            self._func_name = function
        elif callable(function):
            self._func_impl = function
            self._func_name = function.__name__
        else:
            raise ValueError("Unrecognized function in lambda")

    def forward(self, *args):
        return self._func_impl(*args)

    def __repr__(self):
        return f"Lambda({self._func_name})"


class HybridLambda(HybridBlock):
    """A function of (F, x, *args) as a HybridBlock."""

    def __init__(self, function, prefix=None):
        super().__init__(prefix=prefix)
        if isinstance(function, str):
            fn = _nd_function(function)
            self._func = lambda F, *args: fn(*args)
            self._func_name = function
        elif callable(function):
            self._func = function
            self._func_name = function.__name__
        else:
            raise ValueError("Unrecognized function in lambda")

    def hybrid_forward(self, F, x, *args):
        return self._func(F, x, *args)

    def __repr__(self):
        return f"HybridLambda({self._func_name})"
