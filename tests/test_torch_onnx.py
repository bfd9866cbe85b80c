"""ONNX export and import (``mxnet_tpu_torch.contrib.onnx``) against the
JAX package's, on the CPU.

The eight cases of tests/test_onnx.py run through both packages. The
same net with the same weights, exported by each package, parses to the
same nodes (type, inputs, outputs, attributes), the same initializers
(bitwise) and the same graph inputs and outputs; only the producer name
differs. A file the JAX package exported imports into the port (a
SymbolBlock, and a Symbol with its parameters) and the port's into the
JAX package, each giving the exporting net's output within rel 1e-4
(f32), the bound tests/test_onnx.py holds its round trips to.
"""
import os

import numpy as onp
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu_torch.contrib.onnx import onnx_repr as O
from mxnet_tpu_torch.test_utils import assert_almost_equal
from test_torch_jax_globals import jax_globals  # noqa: F401

PKGS = {'jax': jmx, 'port': mx}


@pytest.fixture(autouse=True)
def _cpu():
    with mx.cpu():
        yield


def _cnn(m, arrays=None):
    net = m.gluon.nn.HybridSequential(prefix='cnn_')
    with net.name_scope():
        net.add(m.gluon.nn.Conv2D(8, 3, padding=1, activation='relu'),
                m.gluon.nn.MaxPool2D(2),
                m.gluon.nn.BatchNorm(),
                m.gluon.nn.Flatten(),
                m.gluon.nn.Dense(16, activation='tanh'),
                m.gluon.nn.Dropout(0.5),
                m.gluon.nn.Dense(4))
    return _init(m, net, (2, 1, 8, 8), arrays)


def _init(m, net, shape, arrays, dtype='float32'):
    net.initialize(m.init.Xavier())
    net(m.nd.array(onp.zeros(shape, dtype)))
    if arrays is not None:
        for k, p in net._collect_params_with_prefix().items():
            p.set_data(m.nd.array(arrays[k]))
    return net


def _arrays(net):
    return {k: p.data().asnumpy()
            for k, p in net._collect_params_with_prefix().items()}


def _lm(m, arrays=None):
    class TinyLM(m.gluon.HybridBlock):
        def __init__(self):
            super().__init__(prefix='lm_')
            with self.name_scope():
                self.emb = m.gluon.nn.Embedding(50, 16)
                self.ln = m.gluon.nn.LayerNorm()
                self.fc1 = m.gluon.nn.Dense(32, flatten=False)
                self.fc2 = m.gluon.nn.Dense(50, flatten=False)

        def hybrid_forward(self, F, x):
            h = self.ln(self.emb(x)) * 2.0 + 0.5
            h = F.activation(self.fc1(h), act_type='relu')
            return F.softmax(self.fc2(h), axis=-1)
    return _init(m, TinyLM(), (2, 7), arrays)


@pytest.mark.parametrize('pkg', ['jax', 'port'])
def test_hybrid_export_symbolblock_roundtrip(pkg, tmp_path):
    m = PKGS[pkg]
    net = _cnn(m)
    x = m.nd.array(onp.random.RandomState(0).rand(2, 1, 8, 8)
                   .astype(onp.float32))
    ref = net(x).asnumpy()
    sym_f, par_f = net.export(str(tmp_path / 'm'))
    assert os.path.exists(sym_f) and os.path.exists(par_f)
    net2 = m.gluon.SymbolBlock.imports(sym_f, 'data', par_f)
    assert_almost_equal(net2(x), ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize('pkg', ['jax', 'port'])
def test_symbol_json_multi_output_roundtrip(pkg):
    m = PKGS[pkg]
    sym = m.symbol
    out = sym.batch_norm(sym.var('x'), sym.var('gamma'), sym.var('beta'),
                         sym.var('mean'), sym.var('var'),
                         use_global_stats=True)
    head = out[0] + 1.0 if isinstance(out, tuple) else out + 1.0
    back = sym.fromjson(head.tojson())
    d = onp.random.rand(2, 3).astype(onp.float32)
    bindings = dict(x=m.nd.array(d),
                    gamma=m.nd.array(onp.ones(3, onp.float32)),
                    beta=m.nd.array(onp.zeros(3, onp.float32)),
                    mean=m.nd.array(onp.zeros(3, onp.float32)),
                    var=m.nd.array(onp.ones(3, onp.float32)))
    assert_almost_equal(back.eval_dict(bindings),
                        head.eval_dict(bindings).asnumpy(), rtol=1e-6)


@pytest.mark.parametrize('pkg', ['jax', 'port'])
def test_onnx_cnn_roundtrip(pkg, tmp_path):
    m = PKGS[pkg]
    net = _cnn(m)
    x = m.nd.array(onp.random.rand(2, 1, 8, 8).astype(onp.float32))
    ref = net(x).asnumpy()
    p = str(tmp_path / 'model.onnx')
    m.contrib.onnx.export_model(net, None, input_shapes=[(2, 1, 8, 8)],
                                onnx_file_path=p)
    assert os.path.getsize(p) > 1000
    sym, arg_params, aux = m.contrib.onnx.import_model(p)
    assert len(arg_params) > 0
    net2 = m.contrib.onnx.import_to_gluon(p)
    assert_almost_equal(net2(x), ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize('pkg', ['jax', 'port'])
def test_onnx_lm_roundtrip(pkg, tmp_path):
    m = PKGS[pkg]
    net = _lm(m)
    x = m.nd.array(onp.random.randint(0, 50, (2, 7)).astype(onp.float32))
    ref = net(x).asnumpy()
    p = str(tmp_path / 'lm.onnx')
    m.contrib.onnx.export_model(net, None, input_shapes=[(2, 7)],
                                onnx_file_path=p)
    net2 = m.contrib.onnx.import_to_gluon(p)
    assert_almost_equal(net2(x), ref, rtol=1e-4, atol=1e-5)


def _symbol_graph(m):
    x = m.symbol.var('data')
    w = m.symbol.var('w')
    return m.symbol.relu(m.symbol.dot(x, w) * 0.5)


@pytest.mark.parametrize('pkg', ['jax', 'port'])
def test_onnx_symbol_export(pkg, tmp_path):
    m = PKGS[pkg]
    w_val = onp.random.rand(3, 4).astype(onp.float32)
    p = str(tmp_path / 's.onnx')
    m.contrib.onnx.export_model(_symbol_graph(m), {'w': m.nd.array(w_val)},
                                input_shapes=[(2, 3)], onnx_file_path=p)
    sym2, args, _ = m.contrib.onnx.import_model(p)
    x_val = onp.random.rand(2, 3).astype(onp.float32)
    got = sym2.eval_dict({'data': m.nd.array(x_val), **args}).asnumpy()
    assert_almost_equal(got, onp.maximum((x_val @ w_val) * 0.5, 0),
                        rtol=1e-5)


@pytest.mark.parametrize('pkg', ['jax', 'port'])
def test_onnx_unsupported_op_raises(pkg, tmp_path):
    m = PKGS[pkg]
    out = m.symbol.topk(m.symbol.var('data'), k=2)
    with pytest.raises(ValueError, match="no translation"):
        m.contrib.onnx.export_model(out, {}, input_shapes=[(2, 3)],
                                    onnx_file_path=str(tmp_path / 'x.onnx'))


@pytest.mark.parametrize('pkg', ['jax', 'port'])
def test_protobuf_layer_varints(pkg):
    P = PKGS[pkg].contrib.onnx._proto
    for v in (0, 1, 127, 128, 300, 2 ** 32, -1, -42):
        enc = P.write_varint(v)
        dec, pos = P.read_varint(enc, 0)
        assert P.to_signed(dec) == v, v
        assert pos == len(enc)
    assert P.write_varint(300) == \
        jmx.contrib.onnx._proto.write_varint(300)


@pytest.mark.parametrize('pkg', ['jax', 'port'])
def test_tensor_proto_roundtrip(pkg):
    R = PKGS[pkg].contrib.onnx.onnx_repr
    for arr in (onp.random.rand(3, 4).astype(onp.float32),
                onp.arange(6, dtype=onp.int64).reshape(2, 3),
                onp.array(2.5, onp.float32)):
        name, back = R.parse_tensor(R.tensor('t', arr))
        assert name == 't'
        assert back.dtype == arr.dtype
        assert_almost_equal(back, arr)
        assert R.tensor('t', arr) == \
            jmx.contrib.onnx.onnx_repr.tensor('t', arr)


def _export_both(tmp_path, build, shape, params=None):
    """The same net (or Symbol) exported by each package, each traced or
    built under a fresh NameManager (the port's export of a block makes
    one itself): {pkg: path}."""
    paths, arrays = {}, None
    for pkg, m in PKGS.items():
        with m.name.NameManager():
            if params is not None:
                target, prm = build(m), {k: m.nd.array(v)
                                         for k, v in params.items()}
            else:
                target, prm = build(m, arrays), None
                arrays = arrays or _arrays(target)
            paths[pkg] = str(tmp_path / f'{pkg}.onnx')
            m.contrib.onnx.export_model(target, prm, input_shapes=[shape],
                                        onnx_file_path=paths[pkg])
    return paths


CASES = {'cnn': (_cnn, (2, 1, 8, 8), None),
         'lm': (_lm, (2, 7), None),
         'symbol': (_symbol_graph, (2, 3),
                    {'w': onp.random.RandomState(8).rand(3, 4)
                     .astype(onp.float32)})}


@pytest.mark.parametrize('case', sorted(CASES))
def test_both_exports_parse_to_the_same_graph(case, tmp_path):
    build, shape, params = CASES[case]
    paths = _export_both(tmp_path, build, shape, params)
    parsed = {}
    for pkg, p in paths.items():
        with open(p, 'rb') as f:
            parsed[pkg] = O.parse_model(f.read())
    got, want = parsed['port'], parsed['jax']
    assert got['producer'] == 'mxnet_tpu_torch'
    assert want['producer'] == 'mxnet_tpu'
    assert got['opset'] == want['opset'] == 17
    assert got['nodes'] == want['nodes']
    assert got['inputs'] == want['inputs']
    assert got['outputs'] == want['outputs']
    assert sorted(got['initializers']) == sorted(want['initializers'])
    for k, v in want['initializers'].items():
        assert got['initializers'][k].dtype == v.dtype
        assert got['initializers'][k].tobytes() == v.tobytes(), k


@pytest.mark.parametrize('case', ['cnn', 'lm'])
def test_port_exports_a_block_to_the_same_bytes_every_time(case, tmp_path):
    """Whatever symbols the process made in between, and whether the
    weights are read from one context or another."""
    build, shape, _ = CASES[case]
    net = build(mx)
    paths = [str(tmp_path / f'{i}.onnx') for i in range(2)]
    mx.contrib.onnx.export_model(net, None, input_shapes=[shape],
                                 onnx_file_path=paths[0])
    mx.sym.relu(mx.sym.var('other'))
    net.collect_params().reset_ctx(mx.cpu())
    mx.contrib.onnx.export_model(net, None, input_shapes=[shape],
                                 onnx_file_path=paths[1])
    with open(paths[0], 'rb') as f, open(paths[1], 'rb') as g:
        assert f.read() == g.read()


@pytest.mark.parametrize('case', ['cnn', 'lm'])
def test_files_cross_between_the_packages(case, tmp_path):
    build, shape, _ = CASES[case]
    rs = onp.random.RandomState(3)
    x = (rs.randint(0, 50, shape) if case == 'lm'
         else rs.rand(*shape)).astype(onp.float32)
    jnet = build(jmx)
    arrays = _arrays(jnet)
    ref = jnet(jmx.nd.array(x)).asnumpy()
    tnet = build(mx, arrays)
    assert_almost_equal(tnet(mx.nd.array(x)), ref, rtol=1e-4, atol=1e-5)
    jpath, tpath = str(tmp_path / 'j.onnx'), str(tmp_path / 't.onnx')
    jmx.contrib.onnx.export_model(jnet, None, input_shapes=[shape],
                                  onnx_file_path=jpath)
    mx.contrib.onnx.export_model(tnet, None, input_shapes=[shape],
                                 onnx_file_path=tpath)
    into_port = mx.contrib.onnx.import_to_gluon(jpath, ctx=mx.cpu())
    assert_almost_equal(into_port(mx.nd.array(x)), ref, rtol=1e-4,
                        atol=1e-5)
    sym, args, aux = mx.contrib.onnx.import_model(jpath)
    assert aux == {} and all(a.context == mx.cpu() for a in args.values())
    got = sym.eval_dict({'data': mx.nd.array(x), **args})
    assert_almost_equal(got, ref, rtol=1e-4, atol=1e-5)
    into_jax = jmx.contrib.onnx.import_to_gluon(tpath)
    assert_almost_equal(into_jax(jmx.nd.array(x)), ref, rtol=1e-4,
                        atol=1e-5)
