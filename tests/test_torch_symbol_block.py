"""The symbolic side of the port's Gluon (``HybridBlock`` called with a
Symbol, ``export``, ``SymbolBlock``, ``SymbolBlock.imports``,
``Parameter.var``) against the JAX package, on the CPU.

A HybridSequential of Conv2D, BatchNorm, Activation, MaxPool2D, Flatten,
Dropout and Dense with the same weights (carried across by name) is
exported by each package and imported by the other: the JSON is byte
equal, and the imported block's predict forward equals the exporting
block's. A Module checkpoint (BatchNorm's moving statistics as auxiliary
states) is imported into a SymbolBlock whose forward equals the Module's
inference forward, and which trains (its gradients against the Module
executor's, its moving statistics updated as the executor updates them).

Tolerance: f32, outputs rtol 1e-5, atol 1e-6; gradients rel Frobenius
1e-5.
"""
import numpy as onp
import pytest
import torch

import mxnet_tpu as mj
import mxnet_tpu_torch as mt
from mxnet_tpu_torch.base import MXNetError
from test_torch_jax_globals import jax_globals  # noqa: F401


@pytest.fixture(autouse=True)
def _port_on_cpu():
    with mt.cpu():
        yield


def rel_fro(got, want):
    got = onp.asarray(got, onp.float64)
    want = onp.asarray(want, onp.float64)
    return float(onp.linalg.norm(got - want) /
                 max(onp.linalg.norm(want), 1e-30))


def small_net(mx, prefix):
    nn = mx.gluon.nn
    net = nn.HybridSequential(prefix=prefix)
    with net.name_scope():
        net.add(nn.Conv2D(4, kernel_size=3, padding=1, in_channels=3),
                nn.BatchNorm(in_channels=4), nn.Activation('relu'),
                nn.MaxPool2D(pool_size=2), nn.Flatten(), nn.Dropout(0.5),
                nn.Dense(5, in_units=64))
    net.initialize(mx.init.Xavier())
    return net


def _weights(prefix):
    rng = onp.random.RandomState(0)
    shapes = {'conv2d0_weight': (4, 3, 3, 3), 'conv2d0_bias': (4,),
              'batchnorm0_gamma': (4,), 'batchnorm0_beta': (4,),
              'batchnorm0_running_mean': (4,),
              'batchnorm0_running_var': (4,), 'dense0_weight': (5, 64),
              'dense0_bias': (5,)}
    vals = {prefix + n: (rng.rand(*s) + 0.5 if 'running_var' in n
                         else rng.randn(*s) * 0.3).astype('float32')
            for n, s in shapes.items()}
    return vals


def _load(net, vals):
    for name, p in net.collect_params().items():
        p.set_data(vals[name])


X = onp.random.RandomState(1).randn(2, 3, 8, 8).astype('float32')


@pytest.mark.parametrize('exporter', ['port', 'jax'])
def test_export_imports_across_packages(tmp_path, exporter):
    src, dst = (mt, mj) if exporter == 'port' else (mj, mt)
    vals = _weights('net_')
    net = small_net(src, 'net_')
    _load(net, vals)
    want = net(src.nd.array(X)).asnumpy()
    path = str(tmp_path / 'exp')
    with src.name.NameManager():
        sym_file, params_file = net.export(path, epoch=2)
    assert params_file.endswith('-0002.params')
    blk = dst.gluon.SymbolBlock.imports(sym_file, ['data'], params_file,
                                        ctx=dst.cpu())
    got = blk(dst.nd.array(X)).asnumpy()
    onp.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_export_json_and_params_equal_jax(tmp_path):
    vals = _weights('net_')
    files = {}
    for name, mx in (('port', mt), ('jax', mj)):
        net = small_net(mx, 'net_')
        _load(net, vals)
        with mx.name.NameManager():     # the op nodes' names: counters
            files[name] = net.export(str(tmp_path / name))
    with open(files['port'][0]) as f, open(files['jax'][0]) as g:
        assert f.read() == g.read()
    tp = mt.nd.load(files['port'][1])
    jp = mj.nd.load(files['jax'][1])
    assert set(tp) == set(jp)
    assert {k for k in tp if k.startswith('aux:')} == {
        'aux:net_batchnorm0_running_mean', 'aux:net_batchnorm0_running_var'}
    for k in tp:
        onp.testing.assert_array_equal(tp[k].asnumpy(), jp[k].asnumpy())


def _module_checkpoint(tmp_path):
    """A conv/BatchNorm/FC Module trained a step, saved as a pair."""
    sym = mt.sym
    x = sym.Variable('data')
    c = sym.Convolution(x, kernel=(3, 3), num_filter=4, pad=(1, 1),
                        name='c1')
    bn = sym.BatchNorm(c, fix_gamma=False, name='bn1')
    a = sym.Activation(bn[0], act_type='relu', name='relu1')
    f = sym.FullyConnected(sym.Flatten(a, name='flat'), num_hidden=5,
                           name='fc')
    out = sym.SoftmaxOutput(f, sym.Variable('softmax_label'), name='sm')
    mod = mt.module.Module(out, context=mt.cpu())
    it = mt.io.NDArrayIter(onp.random.RandomState(2).randn(16, 3, 8, 8)
                           .astype('f'), onp.arange(16) % 5,
                           batch_size=8)
    mt.random.seed(3)
    mod.fit(it, num_epoch=1, initializer=mt.init.Xavier(),
            optimizer_params={'learning_rate': 0.1})
    prefix = str(tmp_path / 'ck')
    mod.save_checkpoint(prefix, 1)
    return mod, prefix


def test_module_checkpoint_imports_into_a_symbol_block(tmp_path):
    """The chip phase's round trip on the CPU: SymbolBlock.imports of a
    Module checkpoint (moving statistics as aux: entries) predicts what
    the Module predicts, with the same classes."""
    mod, prefix = _module_checkpoint(tmp_path)
    want = mod.predict(mt.io.NDArrayIter(X, batch_size=2)).asnumpy()
    blk = mt.gluon.SymbolBlock.imports(prefix + '-symbol.json',
                                       ['data', 'softmax_label'],
                                       prefix + '-0001.params')
    got = blk(mt.nd.array(X), mt.nd.zeros((2,))).asnumpy()
    onp.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert (got.argmax(1) == want.argmax(1)).all()
    assert blk.bn1_moving_mean.grad_req == 'null'
    assert blk.c1_weight.grad_req == 'write'


def test_jax_symbol_block_cannot_bind_auxiliary_states(tmp_path):
    """The JAX SymbolBlock makes parameters for the arguments only, so a
    graph with auxiliary states (a Module checkpoint's BatchNorm) cannot
    run there: the reference side of the case above (ROADMAP queue 3)."""
    _, prefix = _module_checkpoint(tmp_path)
    blk = mj.gluon.SymbolBlock.imports(prefix + '-symbol.json',
                                       ['data', 'softmax_label'],
                                       prefix + '-0001.params')
    with pytest.raises(mj.MXNetError, match='unbound variable bn1_moving'):
        blk(mj.nd.array(X), mj.nd.zeros((2,)))


def test_symbol_block_trains_like_the_executor(tmp_path):
    """Under autograd.record a SymbolBlock's gradients equal the Module
    executor's on the same batch, and its moving statistics move as the
    executor's do."""
    mod, prefix = _module_checkpoint(tmp_path)
    blk = mt.gluon.SymbolBlock.imports(prefix + '-symbol.json',
                                       ['data', 'softmax_label'],
                                       prefix + '-0001.params')
    label = onp.array([1, 3], 'f')
    x = mt.nd.array(X)
    with mt.autograd.record():
        out = blk(x, mt.nd.array(label))
    out.backward()
    mod2 = mt.module.Module.load(prefix, 1, context=mt.cpu())
    mod2.bind(data_shapes=[('data', (2, 3, 8, 8))],
              label_shapes=[('softmax_label', (2,))])
    mod2.forward(mt.io.DataBatch([x], [mt.nd.array(label)]), is_train=True)
    mod2.backward()
    e = mod2._execs[0]
    onp.testing.assert_allclose(out.asnumpy(), e.outputs[0].asnumpy(),
                                rtol=1e-6, atol=1e-7)
    for name in ('c1_weight', 'bn1_gamma', 'fc_weight'):
        got = getattr(blk, name).grad().asnumpy()
        assert rel_fro(got, e.grad_dict[name].asnumpy()) < 1e-5, name
    onp.testing.assert_allclose(blk.bn1_moving_mean.data().asnumpy(),
                                e.aux_dict['bn1_moving_mean'].asnumpy(),
                                rtol=1e-6)


def test_symbol_block_from_graph_and_internals():
    """SymbolBlock(outputs, inputs) over a graph's internal node: feature
    extraction, deferred parameters initialised by initialize()."""
    sym = mt.sym
    x = sym.Variable('data')
    h = sym.Activation(sym.FullyConnected(x, num_hidden=6, name='fc1'),
                       act_type='tanh', name='act')
    out = sym.FullyConnected(h, num_hidden=2, name='fc2')
    feat = out.get_internals()['act_output']
    blk = mt.gluon.SymbolBlock(feat, x)
    assert sorted(blk.collect_params()) == ['fc1_bias', 'fc1_weight']
    blk.collect_params()['fc1_weight'].shape = (6, 4)
    blk.collect_params()['fc1_bias'].shape = (6,)
    blk.initialize(mt.init.Xavier())
    assert blk(mt.nd.ones((3, 4))).shape == (3, 6)


def test_parameter_var_and_hybrid_forward_trace():
    p = mt.gluon.Parameter('w', shape=(3, 4))
    v = p.var()
    assert v.name == 'w' and v.attr('__shape__') == (3, 4)
    net = mt.gluon.nn.Dense(3, in_units=4, prefix='d_')
    with mt.name.NameManager():
        s = net(mt.sym.Variable('data'))
    assert s.list_arguments() == ['data', 'd_weight', 'd_bias']
    with mj.name.NameManager():
        j = mj.gluon.nn.Dense(3, in_units=4, prefix='d_')(
            mj.sym.Variable('data'))
    assert s.tojson() == j.tojson()


def test_export_of_an_uninitialised_block_raises(tmp_path):
    """A deferred parameter (no forward yet) has no value to export."""
    net = mt.gluon.nn.Dense(3, prefix='u_')
    net.initialize()
    with pytest.raises(MXNetError):
        net.export(str(tmp_path / 'never'))
