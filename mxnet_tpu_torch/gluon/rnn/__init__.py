"""Recurrent layers and cells (counterpart of ``mxnet_tpu/gluon/rnn``;
ref: python/mxnet/gluon/rnn/): the fused ``RNN``, ``LSTM`` and ``GRU``
layers over the ``rnn`` op, and the cells, stepped or unrolled."""
from .rnn_cell import (RecurrentCell, HybridRecurrentCell, RNNCell, LSTMCell,
                       GRUCell, SequentialRNNCell, DropoutCell, ModifierCell,
                       ZoneoutCell, ResidualCell, BidirectionalCell)
from .rnn_layer import RNN, LSTM, GRU

__all__ = ['RecurrentCell', 'HybridRecurrentCell', 'RNNCell', 'LSTMCell',
           'GRUCell', 'SequentialRNNCell', 'DropoutCell', 'ModifierCell',
           'ZoneoutCell', 'ResidualCell', 'BidirectionalCell', 'RNN', 'LSTM',
           'GRU']
