"""Convolution and pooling layers (counterpart of ``mxnet_tpu/gluon/nn/
conv_layers.py``, ref: python/mxnet/gluon/nn/conv_layers.py). Layouts are
channels-first (NCW, NCHW, NCDHW), as in the JAX package; ``device`` is
the port's, as for the basic layers."""
from __future__ import annotations

from ...base import MXNetError
from ..block import HybridBlock

__all__ = ['Conv1D', 'Conv2D', 'Conv3D', 'Conv1DTranspose',
           'Conv2DTranspose', 'Conv3DTranspose', 'MaxPool1D', 'MaxPool2D',
           'MaxPool3D', 'AvgPool1D', 'AvgPool2D', 'AvgPool3D',
           'GlobalMaxPool1D', 'GlobalMaxPool2D', 'GlobalMaxPool3D',
           'GlobalAvgPool1D', 'GlobalAvgPool2D', 'GlobalAvgPool3D',
           'ReflectionPad2D']

_LAYOUTS = ('NCW', 'NCHW', 'NCDHW')


def _tuple(v, n):
    return (v,) * n if isinstance(v, int) else tuple(v)


def _check_layout(layout):
    if layout not in _LAYOUTS:
        raise MXNetError(f"layout {layout!r}: only the channels-first "
                         f"layouts {_LAYOUTS} are ported")


class _Conv(HybridBlock):
    """Weight (channels, in_channels/groups, *k) for a convolution,
    (in_channels, channels/groups, *k) for a transposed one; in_channels
    0 defers it to the first forward."""

    def __init__(self, channels, kernel_size, strides, padding, dilation,
                 groups, layout, in_channels=0, activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer='zeros', op_name='convolution', adj=None,
                 device=None, dtype='float32', **kwargs):
        super().__init__(**kwargs)
        _check_layout(layout)
        self._channels = channels
        self._kernel_size = kernel_size
        self._op_name = op_name
        ndim = len(kernel_size)
        self._kwargs = {
            'kernel': kernel_size, 'stride': _tuple(strides, ndim),
            'dilate': _tuple(dilation, ndim), 'pad': _tuple(padding, ndim),
            'num_filter': channels, 'num_group': groups,
            'no_bias': not use_bias, 'layout': layout}
        if adj is not None:
            self._kwargs['adj'] = _tuple(adj, ndim)
        self._act_type = activation
        with self.name_scope():
            self.weight = self.params.get(
                'weight', shape=self._weight_shape(in_channels),
                init=weight_initializer, allow_deferred_init=True,
                device=device, dtype=dtype)
            if use_bias:
                self.bias = self.params.get(
                    'bias', shape=(channels,), init=bias_initializer,
                    allow_deferred_init=True, device=device, dtype=dtype)
            else:
                self.bias = None

    def _weight_shape(self, in_c):
        g = self._kwargs['num_group']
        if self._op_name == 'convolution':
            return (self._channels, in_c // g if in_c else 0) + \
                tuple(self._kernel_size)
        return (in_c, self._channels // g) + tuple(self._kernel_size)

    def _infer_param_shapes(self, x, args):
        self.weight._finish_deferred_init(self._weight_shape(x.shape[1]))

    def hybrid_forward(self, F, x, weight, bias=None):
        act = getattr(F, self._op_name)(x, weight, bias, **self._kwargs)
        if self._act_type is not None:
            act = F.activation(act, act_type=self._act_type)
        return act

    def __repr__(self):
        return (f"{type(self).__name__}({self._channels}, "
                f"kernel_size={self._kernel_size})")


def _conv_class(name, ndim, transpose):
    layout = _LAYOUTS[ndim - 1]

    def __init__(self, channels, kernel_size, strides=1, padding=0,
                 dilation=1, groups=1, layout=layout, activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer='zeros', in_channels=0,
                 output_padding=0, **kwargs):
        if transpose:
            kwargs.update(op_name='deconvolution', adj=output_padding)
        elif output_padding:
            raise TypeError("output_padding is for the Transpose layers")
        _Conv.__init__(self, channels, _tuple(kernel_size, ndim), strides,
                       padding, dilation, groups, layout, in_channels,
                       activation, use_bias, weight_initializer,
                       bias_initializer, **kwargs)
    return type(name, (_Conv,), {'__init__': __init__, '__doc__':
                                 f"{ndim}-D {'transposed ' * transpose}"
                                 f"convolution over {layout}."})


Conv1D = _conv_class('Conv1D', 1, False)
Conv2D = _conv_class('Conv2D', 2, False)
Conv3D = _conv_class('Conv3D', 3, False)
Conv1DTranspose = _conv_class('Conv1DTranspose', 1, True)
Conv2DTranspose = _conv_class('Conv2DTranspose', 2, True)
Conv3DTranspose = _conv_class('Conv3DTranspose', 3, True)


class _Pooling(HybridBlock):
    """``ceil_mode`` is MXNet's 'full' pooling convention."""

    def __init__(self, pool_size, strides, padding, ceil_mode=False,
                 global_pool=False, pool_type='max', layout='NCHW',
                 count_include_pad=None, **kwargs):
        super().__init__(**kwargs)
        _check_layout(layout)
        if strides is None:
            strides = pool_size
        self._kwargs = {
            'kernel': pool_size, 'stride': _tuple(strides, len(pool_size)),
            'pad': _tuple(padding, len(pool_size)),
            'global_pool': global_pool, 'pool_type': pool_type,
            'pooling_convention': 'full' if ceil_mode else 'valid'}
        if count_include_pad is not None:
            self._kwargs['count_include_pad'] = count_include_pad

    def hybrid_forward(self, F, x):
        return F.pooling(x, **self._kwargs)

    def __repr__(self):
        return f"{type(self).__name__}(size={self._kwargs['kernel']})"


def _pool_class(name, ndim, pool_type):
    layout = _LAYOUTS[ndim - 1]
    if pool_type == 'max':
        def __init__(self, pool_size=2, strides=None, padding=0,
                     layout=layout, ceil_mode=False, **kwargs):
            _Pooling.__init__(self, _tuple(pool_size, ndim), strides,
                              padding, ceil_mode, False, 'max', layout,
                              **kwargs)
    else:
        def __init__(self, pool_size=2, strides=None, padding=0,
                     layout=layout, ceil_mode=False, count_include_pad=True,
                     **kwargs):
            _Pooling.__init__(self, _tuple(pool_size, ndim), strides,
                              padding, ceil_mode, False, 'avg', layout,
                              count_include_pad, **kwargs)
    return type(name, (_Pooling,), {'__init__': __init__, '__doc__':
                                    f"{ndim}-D {pool_type} pooling."})


def _global_pool_class(name, ndim, pool_type):
    layout = _LAYOUTS[ndim - 1]

    def __init__(self, layout=layout, **kwargs):
        _Pooling.__init__(self, (1,) * ndim, None, 0, True, True, pool_type,
                          layout, **kwargs)
    return type(name, (_Pooling,), {'__init__': __init__, '__doc__':
                                    f"{ndim}-D global {pool_type} pooling."})


MaxPool1D = _pool_class('MaxPool1D', 1, 'max')
MaxPool2D = _pool_class('MaxPool2D', 2, 'max')
MaxPool3D = _pool_class('MaxPool3D', 3, 'max')
AvgPool1D = _pool_class('AvgPool1D', 1, 'avg')
AvgPool2D = _pool_class('AvgPool2D', 2, 'avg')
AvgPool3D = _pool_class('AvgPool3D', 3, 'avg')
GlobalMaxPool1D = _global_pool_class('GlobalMaxPool1D', 1, 'max')
GlobalMaxPool2D = _global_pool_class('GlobalMaxPool2D', 2, 'max')
GlobalMaxPool3D = _global_pool_class('GlobalMaxPool3D', 3, 'max')
GlobalAvgPool1D = _global_pool_class('GlobalAvgPool1D', 1, 'avg')
GlobalAvgPool2D = _global_pool_class('GlobalAvgPool2D', 2, 'avg')
GlobalAvgPool3D = _global_pool_class('GlobalAvgPool3D', 3, 'avg')


class ReflectionPad2D(HybridBlock):
    """Reflect-pad the last two axes by ``padding`` (an int, or MXNet's
    8-tuple pad_width)."""

    def __init__(self, padding=0, **kwargs):
        super().__init__(**kwargs)
        if isinstance(padding, int):
            padding = (0, 0, 0, 0, padding, padding, padding, padding)
        self._padding = padding

    def hybrid_forward(self, F, x):
        return F.pad(x, mode='reflect', pad_width=self._padding)
