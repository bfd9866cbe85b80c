"""Network visualization (counterpart of ``mxnet_tpu/visualization.py``,
ref: python/mxnet/visualization.py): ``print_summary`` prints a Symbol's
nodes; ``plot_network`` needs graphviz and raises without it."""
from __future__ import annotations

from .base import MXNetError
from .symbol import _iter_nodes


def print_summary(symbol, shape=None, line_length=120, positions=(.44, .64, .74, 1.)):
    """Textual summary of a Symbol graph (ref: visualization.py print_summary)."""
    nodes = _iter_nodes(symbol, 'post')
    line = '_' * line_length
    print(line)
    header = ['Layer (type)', 'Output Shape', 'Param #', 'Previous Layer']
    pos = [int(line_length * p) for p in positions]
    row = ''
    for name, p in zip(header, pos):
        row = row[:p - len(name)] if len(row) > p - len(name) else row
        row += name.ljust(p - len(row))
    print(row)
    print('=' * line_length)
    for node in nodes:
        op = node.op or 'Variable'
        fields = [f"{node.name} ({op})", '', '0',
                  ','.join(i.name for i in node.inputs)]
        row = ''
        for f, p in zip(fields, pos):
            row += str(f).ljust(p - len(row))[:p - len(row)]
        print(row)
    print('=' * line_length)


def plot_network(symbol, title='plot', save_format='pdf', shape=None,
                 node_attrs=None, hide_weights=True):
    """Graphviz rendering; returns a Digraph if graphviz is installed."""
    try:
        from graphviz import Digraph
    except ImportError:
        raise MXNetError("plot_network requires graphviz (not installed); "
                         "use print_summary instead")
    dot = Digraph(name=title)
    for s in _iter_nodes(symbol, 'post'):
        dot.node(str(id(s)), f"{s.name}\n{s.op or 'var'}")
        for i in s.inputs:
            dot.edge(str(id(i)), str(id(s)))
    return dot
