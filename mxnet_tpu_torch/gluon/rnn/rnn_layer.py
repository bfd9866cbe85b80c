"""Fused RNN layers (counterpart of ``mxnet_tpu/gluon/rnn/rnn_layer.py``;
ref: python/mxnet/gluon/rnn/rnn_layer.py).

Each layer packs its parameters into the ``rnn`` op's flat vector and
calls the op once (``ops/nn.py``: a loop over time in plain PyTorch, as
the JAX package's op is a ``lax.scan``). The parameters keep MXNet's
names, ``{l,r}{layer}_{i2h,h2h}_{weight,bias}``, so weights carry across
by structured name; the first layer's input size is deferred to the
first forward unless ``input_size`` is given.

A call takes ``(inputs, states=None)``: without states it starts from
zeros on the inputs' device and returns the output only, with them it
returns ``(output, new_states)``. The states pass to the op as separate
arguments, so a hybridized layer's key holds them like any input.
"""
from __future__ import annotations

import torch

from ...ndarray.ndarray import NDArray
from ... import ndarray as nd
from ..block import HybridBlock
from . import rnn_cell

__all__ = ['RNN', 'LSTM', 'GRU']


class _RNNLayer(HybridBlock):
    def __init__(self, hidden_size, num_layers, layout, dropout,
                 bidirectional, input_size, i2h_weight_initializer,
                 h2h_weight_initializer, i2h_bias_initializer,
                 h2h_bias_initializer, mode, projection_size=None,
                 **kwargs):
        super().__init__(**kwargs)
        assert layout in ('TNC', 'NTC'), \
            f"Invalid layout {layout}; must be one of ['TNC' or 'NTC']"
        self._hidden_size = hidden_size
        self._projection_size = projection_size
        self._num_layers = num_layers
        self._mode = mode
        self._layout = layout
        self._dropout = dropout
        self._dir = 2 if bidirectional else 1
        self._input_size = input_size
        self._gates = {'rnn_relu': 1, 'rnn_tanh': 1, 'lstm': 4,
                       'gru': 3}[mode]
        ng, ni, nh = self._gates, input_size, hidden_size
        self._layer_names = []
        for j in range(num_layers):
            for d in ['l', 'r'][:self._dir]:
                size = ni if j == 0 else nh * self._dir
                shapes = {'i2h_weight': ((ng * nh, size),
                                         i2h_weight_initializer),
                          'h2h_weight': ((ng * nh, nh),
                                         h2h_weight_initializer),
                          'i2h_bias': ((ng * nh,), i2h_bias_initializer),
                          'h2h_bias': ((ng * nh,), h2h_bias_initializer)}
                for kind, (shape, init) in shapes.items():
                    name = f'{d}{j}_{kind}'
                    setattr(self, name, self.params.get(
                        name, shape=shape, init=init,
                        allow_deferred_init=True))
                self._layer_names.append(f'{d}{j}_')

    def state_info(self, batch_size=0):
        raise NotImplementedError

    def _infer_param_shapes(self, x, args):
        ng, nh = self._gates, self._hidden_size
        for j, prefix in enumerate(self._layer_names):
            layer = j // self._dir
            size = x.shape[-1] if layer == 0 else nh * self._dir
            w = getattr(self, prefix + 'i2h_weight')
            if not w._ready:
                w._finish_deferred_init((ng * nh, size))

    def begin_state(self, batch_size=0, func=nd.zeros, **kwargs):
        states = []
        for info in self.state_info(batch_size):
            if info is not None:
                info.update(kwargs)
            else:
                info = kwargs
            states.append(func(**info))
        return states

    def __call__(self, inputs, states=None, **kwargs):
        skip_states = states is None
        if isinstance(states, (NDArray, torch.Tensor)):
            states = [states]
        out = super().__call__(inputs, *(states or ()), **kwargs)
        if skip_states:
            return out[0]
        return out[0], list(out[1:])

    def hybrid_forward(self, F, inputs, *states, **params):
        if self._layout == 'NTC':
            inputs = inputs.swapaxes(0, 1)
        if not states:
            shape = (self._num_layers * self._dir, inputs.shape[1],
                     self._hidden_size)
            states = [inputs.new_zeros(shape)
                      for _ in self.state_info(inputs.shape[1])]
        flat = torch.cat(
            [params[p + k].reshape(-1) for p in self._layer_names
             for k in ('i2h_weight', 'h2h_weight')] +
            [params[p + k].reshape(-1) for p in self._layer_names
             for k in ('i2h_bias', 'h2h_bias')])
        out = F.rnn(inputs, flat, states[0],
                    states[1] if self._mode == 'lstm' else None,
                    state_size=self._hidden_size,
                    num_layers=self._num_layers, mode=self._mode,
                    bidirectional=self._dir == 2, p=self._dropout)
        if self._layout == 'NTC':
            out = (out[0].swapaxes(0, 1),) + tuple(out[1:])
        return out

    def _unfuse(self):
        """The SequentialRNNCell equivalent, sharing this layer's
        parameters (ref: rnn_layer.py:147)."""
        get_cell = {
            'rnn_relu': lambda **kw: rnn_cell.RNNCell(
                self._hidden_size, activation='relu', **kw),
            'rnn_tanh': lambda **kw: rnn_cell.RNNCell(
                self._hidden_size, activation='tanh', **kw),
            'lstm': lambda **kw: rnn_cell.LSTMCell(self._hidden_size, **kw),
            'gru': lambda **kw: rnn_cell.GRUCell(self._hidden_size, **kw),
        }[self._mode]
        stack = rnn_cell.SequentialRNNCell(prefix=self.prefix,
                                           params=self.params)
        with stack.name_scope():
            ni = self._input_size
            for i in range(self._num_layers):
                kwargs = {'input_size': ni}
                if self._dir == 2:
                    stack.add(rnn_cell.BidirectionalCell(
                        get_cell(prefix=f'l{i}_', **kwargs),
                        get_cell(prefix=f'r{i}_', **kwargs)))
                else:
                    stack.add(get_cell(prefix=f'l{i}_', **kwargs))
                if self._dropout > 0 and i != self._num_layers - 1:
                    stack.add(rnn_cell.DropoutCell(self._dropout))
                ni = self._hidden_size * self._dir
        return stack

    def __repr__(self):
        return (f"{type(self).__name__}({self._input_size} -> "
                f"{self._hidden_size}, {self._layout}, "
                f"num_layers={self._num_layers})")


def _lnc(self, batch_size):
    return {'shape': (self._num_layers * self._dir, batch_size,
                      self._hidden_size), '__layout__': 'LNC'}


class RNN(_RNNLayer):
    """Elman RNN, relu or tanh (ref: rnn_layer.py RNN)."""

    def __init__(self, hidden_size, num_layers=1, activation='relu',
                 layout='TNC', dropout=0, bidirectional=False,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer='zeros', h2h_bias_initializer='zeros',
                 input_size=0, **kwargs):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, i2h_weight_initializer,
                         h2h_weight_initializer, i2h_bias_initializer,
                         h2h_bias_initializer, 'rnn_' + activation, **kwargs)

    def state_info(self, batch_size=0):
        return [_lnc(self, batch_size)]


class LSTM(_RNNLayer):
    """Ref: rnn_layer.py LSTM. ``projection_size`` is accepted and
    ignored, as in the JAX package."""

    def __init__(self, hidden_size, num_layers=1, layout='TNC', dropout=0,
                 bidirectional=False, input_size=0,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer='zeros', h2h_bias_initializer='zeros',
                 projection_size=None, **kwargs):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, i2h_weight_initializer,
                         h2h_weight_initializer, i2h_bias_initializer,
                         h2h_bias_initializer, 'lstm', projection_size,
                         **kwargs)

    def state_info(self, batch_size=0):
        return [_lnc(self, batch_size), _lnc(self, batch_size)]


class GRU(_RNNLayer):
    """Ref: rnn_layer.py GRU."""

    def __init__(self, hidden_size, num_layers=1, layout='TNC', dropout=0,
                 bidirectional=False, input_size=0,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer='zeros', h2h_bias_initializer='zeros',
                 **kwargs):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, i2h_weight_initializer,
                         h2h_weight_initializer, i2h_bias_initializer,
                         h2h_bias_initializer, 'gru', **kwargs)

    def state_info(self, batch_size=0):
        return [_lnc(self, batch_size)]
