"""Recurrent cells (counterpart of ``mxnet_tpu/gluon/rnn/rnn_cell.py``;
ref: python/mxnet/gluon/rnn/rnn_cell.py).

A cell steps one time step over NDArrays, ``cell(inputs, states) ->
(output, new_states)``, with the ``nd`` ops (recorded by ``autograd``
like any other); ``unroll`` steps it over a sequence. The parameters keep
MXNet's names (``i2h_weight``, ``h2h_weight``, ``i2h_bias``,
``h2h_bias``) and the first input size is deferred to the first step.

``SequentialRNNCell`` has no ``unroll`` of its own, as in the JAX
package: the base one steps each child, so a stack holding a
``BidirectionalCell`` (a bidirectional layer's ``_unfuse()``) raises
"Bidirectional cannot be stepped", where MXNet unrolls cell by cell.
"""
from __future__ import annotations

from ...base import MXNetError
from ... import ndarray as nd
from ..block import Block

__all__ = ['RecurrentCell', 'HybridRecurrentCell', 'RNNCell', 'LSTMCell',
           'GRUCell', 'SequentialRNNCell', 'DropoutCell', 'ModifierCell',
           'ZoneoutCell', 'ResidualCell', 'BidirectionalCell']


class RecurrentCell(Block):
    """Base recurrent cell (ref: rnn_cell.py RecurrentCell)."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._modified = False
        self.reset()

    def reset(self):
        self._init_counter = -1
        self._counter = -1
        for cell in self._children.values():
            if isinstance(cell, RecurrentCell):
                cell.reset()

    def state_info(self, batch_size=0):
        raise NotImplementedError

    def begin_state(self, batch_size=0, func=nd.zeros, **kwargs):
        assert not self._modified
        states = []
        for info in self.state_info(batch_size):
            self._init_counter += 1
            if info is not None:
                info.update(kwargs)
            else:
                info = kwargs
            states.append(func(**info))
        return states

    def __call__(self, inputs, states):
        self._counter += 1
        return super().__call__(inputs, states)

    def forward(self, inputs, states):
        raise NotImplementedError

    def unroll(self, length, inputs, begin_state=None, layout='NTC',
               merge_outputs=None, valid_length=None):
        """Step the cell over ``length`` steps of ``inputs`` (ref:
        rnn_cell.py unroll)."""
        axis = layout.find('T')
        batch_size = inputs.shape[layout.find('N')]
        if begin_state is None:
            begin_state = self.begin_state(batch_size)
        states = begin_state
        outputs = []
        if axis == 1:
            seq = [nd._invoke(lambda d, t=t: d[:, t], inputs)
                   for t in range(length)]
        else:
            seq = [nd._invoke(lambda d, t=t: d[t], inputs)
                   for t in range(length)]
        for t in range(length):
            out, states = self(seq[t], states)
            outputs.append(out)
        if valid_length is not None:
            stacked = nd.stack(*outputs, axis=axis)
            stacked = nd.sequence_mask(stacked, valid_length,
                                       use_sequence_length=True, axis=axis)
            if merge_outputs is False:
                outputs = [nd._invoke(lambda d, t=t: d[:, t] if axis == 1
                                      else d[t], stacked)
                           for t in range(length)]
            else:
                outputs = stacked
        elif merge_outputs is not False:
            outputs = nd.stack(*outputs, axis=axis)
        return outputs, states


class HybridRecurrentCell(RecurrentCell):
    pass


class _GatedCell(HybridRecurrentCell):
    """A cell with i2h and h2h weights and biases of ``gates * hidden``
    rows."""

    _gates = 1

    def __init__(self, hidden_size, i2h_weight_initializer,
                 h2h_weight_initializer, i2h_bias_initializer,
                 h2h_bias_initializer, input_size, prefix, params):
        super().__init__(prefix=prefix, params=params)
        self._hidden_size = hidden_size
        self._input_size = input_size
        rows = self._gates * hidden_size
        self.i2h_weight = self.params.get('i2h_weight',
                                          shape=(rows, input_size),
                                          init=i2h_weight_initializer,
                                          allow_deferred_init=True)
        self.h2h_weight = self.params.get('h2h_weight',
                                          shape=(rows, hidden_size),
                                          init=h2h_weight_initializer,
                                          allow_deferred_init=True)
        self.i2h_bias = self.params.get('i2h_bias', shape=(rows,),
                                        init=i2h_bias_initializer,
                                        allow_deferred_init=True)
        self.h2h_bias = self.params.get('h2h_bias', shape=(rows,),
                                        init=h2h_bias_initializer,
                                        allow_deferred_init=True)

    def _projections(self, inputs, h):
        """(i2h, h2h): the two Dense products with their biases."""
        if not self.i2h_weight._ready:
            self.i2h_weight._finish_deferred_init(
                (self._gates * self._hidden_size, inputs.shape[-1]))
        n = self._gates * self._hidden_size
        i2h = nd.fully_connected(inputs, self.i2h_weight.data(),
                                 self.i2h_bias.data(), num_hidden=n)
        h2h = nd.fully_connected(h, self.h2h_weight.data(),
                                 self.h2h_bias.data(), num_hidden=n)
        return i2h, h2h


class RNNCell(_GatedCell):
    """Elman RNN cell (ref: rnn_cell.py RNNCell)."""

    def __init__(self, hidden_size, activation='tanh',
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer='zeros', h2h_bias_initializer='zeros',
                 input_size=0, prefix=None, params=None):
        super().__init__(hidden_size, i2h_weight_initializer,
                         h2h_weight_initializer, i2h_bias_initializer,
                         h2h_bias_initializer, input_size, prefix, params)
        self._activation = activation

    def state_info(self, batch_size=0):
        return [{'shape': (batch_size, self._hidden_size),
                 '__layout__': 'NC'}]

    def _alias(self):
        return 'rnn'

    def forward(self, inputs, states):
        i2h, h2h = self._projections(inputs, states[0])
        output = nd.activation(i2h + h2h, act_type=self._activation)
        return output, [output]


class LSTMCell(_GatedCell):
    """Ref: rnn_cell.py LSTMCell. Gate order i, f, g, o (MXNet's)."""

    _gates = 4

    def __init__(self, hidden_size, i2h_weight_initializer=None,
                 h2h_weight_initializer=None, i2h_bias_initializer='zeros',
                 h2h_bias_initializer='zeros', input_size=0, prefix=None,
                 params=None, activation='tanh',
                 recurrent_activation='sigmoid'):
        super().__init__(hidden_size, i2h_weight_initializer,
                         h2h_weight_initializer, i2h_bias_initializer,
                         h2h_bias_initializer, input_size, prefix, params)
        self._activation = activation
        self._recurrent_activation = recurrent_activation

    def state_info(self, batch_size=0):
        return [{'shape': (batch_size, self._hidden_size),
                 '__layout__': 'NC'},
                {'shape': (batch_size, self._hidden_size),
                 '__layout__': 'NC'}]

    def _alias(self):
        return 'lstm'

    def forward(self, inputs, states):
        i2h, h2h = self._projections(inputs, states[0])
        gates = (i2h + h2h).split(4, axis=1)
        rec, act = self._recurrent_activation, self._activation
        in_gate = nd.activation(gates[0], act_type=rec)
        forget_gate = nd.activation(gates[1], act_type=rec)
        in_transform = nd.activation(gates[2], act_type=act)
        out_gate = nd.activation(gates[3], act_type=rec)
        next_c = forget_gate * states[1] + in_gate * in_transform
        next_h = out_gate * nd.activation(next_c, act_type=act)
        return next_h, [next_h, next_c]


class GRUCell(_GatedCell):
    """Ref: rnn_cell.py GRUCell. Gate order r, z, n (MXNet's)."""

    _gates = 3

    def __init__(self, hidden_size, i2h_weight_initializer=None,
                 h2h_weight_initializer=None, i2h_bias_initializer='zeros',
                 h2h_bias_initializer='zeros', input_size=0, prefix=None,
                 params=None):
        super().__init__(hidden_size, i2h_weight_initializer,
                         h2h_weight_initializer, i2h_bias_initializer,
                         h2h_bias_initializer, input_size, prefix, params)

    def state_info(self, batch_size=0):
        return [{'shape': (batch_size, self._hidden_size),
                 '__layout__': 'NC'}]

    def _alias(self):
        return 'gru'

    def forward(self, inputs, states):
        prev_h = states[0]
        i2h, h2h = self._projections(inputs, prev_h)
        i2h_r, i2h_z, i2h = i2h.split(3, axis=1)
        h2h_r, h2h_z, h2h = h2h.split(3, axis=1)
        reset_gate = nd.sigmoid(i2h_r + h2h_r)
        update_gate = nd.sigmoid(i2h_z + h2h_z)
        next_h_tmp = nd.tanh(i2h + reset_gate * h2h)
        next_h = (1. - update_gate) * next_h_tmp + update_gate * prev_h
        return next_h, [next_h]


class SequentialRNNCell(RecurrentCell):
    """Cells stacked, each stepped on the previous one's output (ref:
    rnn_cell.py SequentialRNNCell)."""

    def add(self, cell):
        self.register_child(cell)

    def state_info(self, batch_size=0):
        infos = []
        for cell in self._children.values():
            infos.extend(cell.state_info(batch_size))
        return infos

    def begin_state(self, batch_size=0, **kwargs):
        states = []
        for cell in self._children.values():
            states.extend(cell.begin_state(batch_size, **kwargs))
        return states

    def forward(self, inputs, states):
        next_states = []
        p = 0
        for cell in self._children.values():
            n = len(cell.state_info())
            cell_states = states[p:p + n]
            p += n
            inputs, cell_states = cell(inputs, cell_states)
            next_states.extend(cell_states)
        return inputs, next_states

    def __len__(self):
        return len(self._children)


class DropoutCell(HybridRecurrentCell):
    """Dropout on the step's input, drawn in autograd train mode."""

    def __init__(self, rate, axes=(), prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._rate = rate
        self._axes = axes

    def state_info(self, batch_size=0):
        return []

    def _alias(self):
        return 'dropout'

    def forward(self, inputs, states):
        if self._rate > 0:
            inputs = nd.dropout(inputs, p=self._rate, axes=self._axes)
        return inputs, states


class ModifierCell(HybridRecurrentCell):
    """A cell around a base cell, whose parameters it uses."""

    def __init__(self, base_cell):
        super().__init__(prefix=base_cell.prefix + 'mod_')
        base_cell._modified = True
        self.base_cell = base_cell

    @property
    def params(self):
        return self.base_cell.params

    def state_info(self, batch_size=0):
        return self.base_cell.state_info(batch_size)

    def begin_state(self, batch_size=0, func=nd.zeros, **kwargs):
        self.base_cell._modified = False
        begin = self.base_cell.begin_state(batch_size, func=func, **kwargs)
        self.base_cell._modified = True
        return begin


class ZoneoutCell(ModifierCell):
    """Keeps each output and state unit from the previous step with
    probability ``zoneout_outputs``/``zoneout_states``."""

    def __init__(self, base_cell, zoneout_outputs=0., zoneout_states=0.):
        super().__init__(base_cell)
        self._zoneout_outputs = zoneout_outputs
        self._zoneout_states = zoneout_states
        self._prev_output = None

    def _alias(self):
        return 'zoneout'

    def reset(self):
        super().reset()
        self._prev_output = None

    def forward(self, inputs, states):
        next_output, next_states = self.base_cell(inputs, states)
        p_outputs, p_states = self._zoneout_outputs, self._zoneout_states

        def mask(p, like):
            return nd.dropout(nd.ones_like(like), p=p)

        prev_output = self._prev_output if self._prev_output is not None \
            else nd.zeros_like(next_output)
        output = (nd.where(mask(p_outputs, next_output), next_output,
                           prev_output)
                  if p_outputs != 0. else next_output)
        new_states = ([nd.where(mask(p_states, new_s), new_s, old_s)
                       for new_s, old_s in zip(next_states, states)]
                      if p_states != 0. else next_states)
        self._prev_output = output
        return output, new_states


class ResidualCell(ModifierCell):
    """The base cell's output plus its input."""

    def forward(self, inputs, states):
        output, states = self.base_cell(inputs, states)
        return output + inputs, states


class BidirectionalCell(HybridRecurrentCell):
    """A left and a right cell over the sequence, their outputs side by
    side (ref: rnn_cell.py BidirectionalCell); only ``unroll`` runs it."""

    def __init__(self, l_cell, r_cell, output_prefix='bi_'):
        super().__init__(prefix='', params=None)
        self.register_child(l_cell, 'l_cell')
        self.register_child(r_cell, 'r_cell')
        self._output_prefix = output_prefix

    def __call__(self, inputs, states):
        raise MXNetError("Bidirectional cannot be stepped. Please use unroll")

    def state_info(self, batch_size=0):
        infos = []
        for cell in self._children.values():
            infos.extend(cell.state_info(batch_size))
        return infos

    def begin_state(self, batch_size=0, **kwargs):
        states = []
        for cell in self._children.values():
            states.extend(cell.begin_state(batch_size, **kwargs))
        return states

    def unroll(self, length, inputs, begin_state=None, layout='NTC',
               merge_outputs=None, valid_length=None):
        axis = layout.find('T')
        batch_size = inputs.shape[layout.find('N')]
        if begin_state is None:
            begin_state = self.begin_state(batch_size)
        l_cell = self._children['l_cell']
        r_cell = self._children['r_cell']
        n_l = len(l_cell.state_info())
        l_outputs, l_states = l_cell.unroll(
            length, inputs, begin_state[:n_l], layout, merge_outputs=True,
            valid_length=valid_length)
        if valid_length is None:
            rev_inputs = nd.flip(inputs, axis=(axis,))
        else:
            rev_inputs = nd.sequence_reverse(
                inputs, valid_length, use_sequence_length=True, axis=axis)
        r_outputs, r_states = r_cell.unroll(
            length, rev_inputs, begin_state[n_l:], layout,
            merge_outputs=True, valid_length=valid_length)
        if valid_length is None:
            r_outputs = nd.flip(r_outputs, axis=(axis,))
        else:
            r_outputs = nd.sequence_reverse(
                r_outputs, valid_length, use_sequence_length=True,
                axis=axis)
        outputs = nd.concat(l_outputs, r_outputs, dim=2)
        return outputs, l_states + r_states
