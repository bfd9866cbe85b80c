"""MXNet 1.6's op names in the port against the JAX package (the
counterpart of tests/test_ref_op_parity.py): the port's copy of the op
inventory is the JAX package's byte for byte; each of its names resolves
to the same canonical op in both packages, or is left out in both by the
same rule (the descope table or the backward-op rule); and a symbol JSON
that spells its ops as MXNet does binds through ``sym.load`` in both and
gives the same forward (f32, rtol 1e-5, atol 1e-6).
"""
import json
import os

import numpy as onp
import pytest

import mxnet_tpu as mj
import mxnet_tpu_torch as mt
from mxnet_tpu.base import get_op as jget
from mxnet_tpu.ops import ref_aliases as jra
from mxnet_tpu_torch.base import get_op as tget
from mxnet_tpu_torch.ops import ref_aliases as tra
from test_torch_jax_globals import jax_globals  # noqa: F401

ROOT = os.path.normpath(os.path.join(os.path.dirname(__file__), os.pardir))
NAMES = jra.reference_op_names()


@pytest.fixture(autouse=True, scope='module')
def _jax_symbol_counter():
    """The JAX Symbol counter as this file found it, put back after it."""
    from mxnet_tpu.symbol import Symbol
    count = Symbol._counter[0]
    yield
    Symbol._counter[0] = count


def test_inventory_copy_is_byte_equal():
    with open(os.path.join(ROOT, 'mxnet_tpu', 'ops',
                           'reference_op_names.txt'), 'rb') as a, \
            open(os.path.join(ROOT, 'mxnet_tpu_torch', 'ops',
                              'reference_op_names.txt'), 'rb') as b:
        assert a.read() == b.read()
    assert tra.reference_op_names() == NAMES
    assert len(NAMES) == 979


def test_descope_tables_agree():
    assert set(tra.DESCOPED) == set(jra.DESCOPED)
    assert tra.MANUAL_ALIASES == jra.MANUAL_ALIASES
    for reason in tra.DESCOPED.values():
        assert isinstance(reason, str) and len(reason) > 10


@pytest.mark.parametrize('name', NAMES)
def test_reference_name_resolves_as_in_jax(name):
    jd, td = jra.is_descoped(name), tra.is_descoped(name)
    assert (jd is None) == (td is None), name
    if jd is not None:
        # the same rule: the table in both, or the backward rule in both
        assert (name in jra.DESCOPED) == (name in tra.DESCOPED)
        return
    canonical = jra.resolve_reference_name(name)
    assert canonical is not None
    assert tra.resolve_reference_name(name) == canonical
    assert tget(name).name == jget(name).name == canonical


def test_pinned_counts():
    resolved = sum(1 for n in NAMES if not tra.is_descoped(n)
                   and tra.resolve_reference_name(n) is not None)
    descoped = sum(1 for n in NAMES if tra.is_descoped(n))
    assert resolved + descoped == len(NAMES)
    assert resolved == 739 and descoped == 240


def _mxnet_spelled_graph():
    """A graph whose ops are spelled as MXNet spells them."""
    nodes = [
        {'op': 'null', 'name': 'x', 'inputs': []},
        {'op': 'null', 'name': 'y', 'inputs': []},
        {'op': '_plus_scalar', 'name': 'p', 'attrs': {'scalar': '1.5'},
         'inputs': [[0, 0, 0]]},
        {'op': 'elemwise_add', 'name': 'a', 'inputs': [[2, 0, 0],
                                                       [1, 0, 0]]},
        {'op': '_contrib_div_sqrt_dim', 'name': 'd',
         'inputs': [[3, 0, 0]]},
        {'op': '_npi_add', 'name': 'n', 'inputs': [[4, 0, 0], [0, 0, 0]]},
        {'op': 'broadcast_mul', 'name': 'm', 'inputs': [[5, 0, 0],
                                                        [1, 0, 0]]},
        {'op': 'Activation', 'name': 'act', 'attrs': {'act_type': 'tanh'},
         'inputs': [[6, 0, 0]]},
        {'op': '_MulScalar', 'name': 's', 'attrs': {'scalar': '0.5'},
         'inputs': [[7, 0, 0]]},
    ]
    return {'nodes': nodes, 'arg_nodes': [0, 1], 'heads': [[8, 0, 0]]}


def test_mxnet_spelled_json_binds_and_runs_in_both(tmp_path):
    path = str(tmp_path / 'net-symbol.json')
    with open(path, 'w') as f:
        json.dump(_mxnet_spelled_graph(), f)
    rng = onp.random.RandomState(3)
    x = rng.uniform(-1, 1, (2, 4)).astype(onp.float32)
    y = rng.uniform(-1, 1, (2, 4)).astype(onp.float32)
    want = mj.sym.load(path).eval(x=mj.nd.array(x), y=mj.nd.array(y))
    with mt.cpu():
        got = mt.sym.load(path).eval(ctx=mt.cpu(), x=mt.nd.array(x),
                                     y=mt.nd.array(y))
    want = want[0] if isinstance(want, (list, tuple)) else want
    got = got[0] if isinstance(got, (list, tuple)) else got
    onp.testing.assert_allclose(got.asnumpy(), want.asnumpy(), rtol=1e-5,
                                atol=1e-6)
    expect = onp.tanh(((x + 1.5 + y) / 2.0 + x) * y) * 0.5
    onp.testing.assert_allclose(got.asnumpy(), expect, rtol=1e-5, atol=1e-6)


def test_mxnet_spellings_through_get_op():
    for n in ['FullyConnected', 'Activation', '_Plus', 'uniform',
              'BlockGrad', '_npx_relu', 'ElementWiseSum', 'crop',
              '_contrib_ROIAlign', 'choose_element_0index',
              '_random_normal_like', '_cond', 'Custom', '_plus_scalar',
              '_contrib_div_sqrt_dim', '_npi_add', 'broadcast_mul']:
        assert callable(tget(n).fn), n
        assert tget(n).name == jget(n).name, n


def test_symbol_legacy_names_keep_their_meaning():
    """The CamelCase names the symbol module resolved before the aliases
    (the JAX package's table) still resolve, to the same op."""
    for camel, snake in {
            'FullyConnected': 'fully_connected', 'Convolution': 'convolution',
            'Deconvolution': 'deconvolution', 'Pooling': 'pooling',
            'Activation': 'activation', 'BatchNorm': 'batch_norm',
            'LayerNorm': 'layer_norm', 'Dropout': 'dropout',
            'Flatten': 'flatten', 'SoftmaxOutput': 'softmax_output',
            'Embedding': 'embedding', 'Concat': 'concat',
            'LeakyReLU': 'leaky_relu', 'RNN': 'rnn',
            'SequenceMask': 'sequence_mask', 'SequenceLast': 'sequence_last',
            'SequenceReverse': 'sequence_reverse', 'SliceChannel': 'split',
            'UpSampling': 'upsampling', 'LRN': 'lrn', 'Cast': 'cast',
            'SwapAxis': 'swapaxes', 'Reshape': 'reshape'}.items():
        assert getattr(mt.sym, camel) is getattr(mt.sym, snake), camel
        assert getattr(mj.sym, camel).__name__ == snake, camel
