"""The port's C predict API (``csrc/embed/c_predict_api.{h,cc}`` over
``mxnet_tpu_torch._predict_embed``) against the JAX package's
``mxnet_tpu._predict_embed.Predictor`` (what the JAX C library calls), on
the CPU (``dev_type=1``).

The library is built with ``g++`` once for the module, into a build
directory of the module's own, and loaded with ``ctypes``; a failed build
fails the tests. Cases: the JAX MLP case of tests/test_c_predict.py on
files the JAX package exported (rel 1e-6); a 2-layer, hidden 64, 2-head
BERT encoder from ``mx.sym`` at B = 2, T = 16 under a key mask (rel
1e-5); every error path of ``test_c_predict_error_paths``; ``dev_type=2``
failing here with the missing card named; and the header's declarations,
which are the JAX package's.
"""
import ctypes
import os
import re

import numpy as onp
import pytest

import mxnet_tpu as mj
import mxnet_tpu_torch as mt
from mxnet_tpu._predict_embed import Predictor as JPredictor
from test_torch_jax_globals import jax_globals  # noqa: F401

ROOT = os.path.normpath(os.path.join(os.path.dirname(__file__), os.pardir))
P_FLOAT = ctypes.POINTER(ctypes.c_float)


def c_declarations(path):
    """{function name: (return type, arguments)} of the ``MX*`` functions
    a C header declares or a C++ source defines, whitespace and comments
    normalized away."""
    with open(path) as f:
        text = f.read()
    text = re.sub(r'/\*.*?\*/', ' ', text, flags=re.S)
    text = re.sub(r'//[^\n]*|^\s*#[^\n]*', ' ', text, flags=re.M)
    out = {}
    for chunk in re.split(r'[;{}]', text):
        m = re.search(r'(MX\w+)\s*\(([^()]*)\)\s*(try)?\s*$', chunk)
        if m is None:
            continue
        ret = ' '.join(chunk[:m.start()].split()[-3:])
        if not ret or 'return' in ret or '=' in ret or '"' in ret:
            continue
        args = ' '.join(m.group(2).split())
        norm = lambda t: re.sub(r'\s*,\s*', ', ', re.sub(  # noqa: E731
            r'\s*\*\s*', '* ', t)).strip()
        out[m.group(1)] = (norm(ret.replace('extern', '')),
                           '' if args == 'void' else norm(args))
    return out


@pytest.fixture(scope='module')
def lib(tmp_path_factory):
    from mxnet_tpu_torch import _capi
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv('MXTPU_COMPILE_CACHE_DIR',
                  str(tmp_path_factory.mktemp('build')))
        yield _capi.load('predict')


@pytest.fixture(autouse=True)
def _port_on_cpu():
    with mt.cpu():
        yield


@pytest.fixture(scope='module')
def exported_mlp(tmp_path_factory):
    """tests/test_c_predict.py's model, exported by the JAX package."""
    tmp = tmp_path_factory.mktemp('cpredict')
    net = mj.gluon.nn.HybridSequential()
    net.add(mj.gluon.nn.Dense(16, activation='relu'), mj.gluon.nn.Dense(4))
    net.initialize(mj.init.Xavier())
    x = onp.random.RandomState(0).rand(2, 8).astype(onp.float32)
    net(mj.nd.array(x))
    sym_f, par_f = net.export(str(tmp / 'm'))
    return sym_f, par_f, x


def _create(lib, sym_json, params, shapes, dev_type=1, dev_id=0):
    """(rc, handle) of MXPredCreate over {input name: shape}."""
    names = list(shapes)
    keys = (ctypes.c_char_p * len(names))(*[n.encode() for n in names])
    indptr, data = [0], []
    for n in names:
        data += list(shapes[n])
        indptr.append(len(data))
    handle = ctypes.c_void_p()
    rc = lib.MXPredCreate(sym_json, params, len(params), dev_type, dev_id,
                          len(names), keys,
                          (ctypes.c_uint * len(indptr))(*indptr),
                          (ctypes.c_uint * max(1, len(data)))(*data),
                          ctypes.byref(handle))
    return rc, handle


def _predict(lib, sym_json, params, inputs):
    from mxnet_tpu_torch import _capi
    return _capi.predict(lib, sym_json, params, inputs, dev_type=1)


def _jax_predict(sym_json, params, inputs):
    p = JPredictor(sym_json.decode(), params, list(inputs),
                   [v.shape for v in inputs.values()], 1)
    for k, v in inputs.items():
        p.set_input(k, onp.ascontiguousarray(v, onp.float32).tobytes())
    p.forward()
    return onp.frombuffer(p.output_bytes(0), onp.float32).reshape(
        p.output_shape(0))


def test_c_predict_matches_jax(lib, exported_mlp):
    sym_f, par_f, x = exported_mlp
    sym_json, params = open(sym_f, 'rb').read(), open(par_f, 'rb').read()
    got = _predict(lib, sym_json, params, {'data': x})
    want = _jax_predict(sym_json, params, {'data': x})
    assert got.shape == want.shape == (2, 4)
    onp.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def bert_sym_encoder(sym, hidden=64, heads=2, layers=2, ffn=128):
    """chip_smoke's symbolic BERT encoder at a small width."""
    h = sym.Variable('data')
    mask = sym.Variable('mask')
    for i in range(layers):
        p = f'l{i}_'

        def fc(x, n, name):
            return sym.FullyConnected(x, num_hidden=n, flatten=False,
                                      name=p + name)
        att = sym.multi_head_attention(fc(h, hidden, 'q'), fc(h, hidden, 'k'),
                                       fc(h, hidden, 'v'), mask,
                                       num_heads=heads, name=p + 'att')
        h = sym.LayerNorm(h + fc(att, hidden, 'o'), name=p + 'ln1')
        f = sym.Activation(fc(h, ffn, 'ffn1'), act_type='gelu',
                           name=p + 'gelu')
        h = sym.LayerNorm(h + fc(f, hidden, 'ffn2'), name=p + 'ln2')
    return h


def bert_files(tmp, batch=2, seq=16, hidden=64):
    """The encoder's symbol JSON, its parameters saved by the port
    (Normal(0.02) weights from a numpy seed) and the inputs: data and an
    additive key mask (0 kept, -1e4 past valid_length)."""
    net = bert_sym_encoder(mt.sym)
    rng = onp.random.RandomState(11)
    shapes = dict(data=(batch, seq, hidden), mask=(batch, 1, 1, seq))
    args, _, _ = net.infer_shape(**shapes)
    arrays = {}
    for n, s in zip(net.list_arguments(), args):
        if n in shapes:
            continue
        arrays[n] = (rng.standard_normal(s) * 0.02 if n.endswith('_weight')
                     else onp.ones(s) if n.endswith('_gamma')
                     else onp.zeros(s)).astype(onp.float32)
    mt.nd.save(str(tmp / 'enc-0000.params'),
               {f'arg:{k}': mt.nd.array(v) for k, v in arrays.items()})
    valid = rng.randint(seq // 2, seq + 1, batch)
    inputs = {
        'data': rng.standard_normal(shapes['data']).astype(onp.float32),
        'mask': onp.where(onp.arange(seq)[None] < valid[:, None], 0.0,
                          -1e4).astype(onp.float32).reshape(shapes['mask'])}
    return net.tojson().encode(), (tmp / 'enc-0000.params').read_bytes(), \
        inputs


def test_c_predict_bert_encoder_matches_jax(lib, tmp_path):
    sym_json, params, inputs = bert_files(tmp_path)
    got = _predict(lib, sym_json, params, inputs)
    want = _jax_predict(sym_json, params, inputs)
    assert got.shape == want.shape == (2, 16, 64)
    onp.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # the C layer adds nothing: the port's SymbolBlock forward, bitwise
    block = mt.gluon.SymbolBlock(mt.sym.fromjson(sym_json.decode()),
                                 [mt.sym.var('data'), mt.sym.var('mask')])
    from mxnet_tpu_torch.serialization import load_params_dict
    block._load_arg_dict({k: onp.array(v) for k, v in
                          load_params_dict(params).items()}, ctx=mt.cpu())
    direct = block(mt.nd.array(inputs['data']), mt.nd.array(inputs['mask']))
    onp.testing.assert_array_equal(got, direct.asnumpy())


def test_c_predict_error_paths(lib, exported_mlp):
    sym_f, par_f, x = exported_mlp
    sym_json, params = open(sym_f, 'rb').read(), open(par_f, 'rb').read()
    rc, h = _create(lib, sym_json, params, {'data': x.shape})
    assert rc == 0
    buf = onp.zeros(4, onp.float32)
    assert lib.MXPredSetInput(h, b'bogus', buf.ctypes.data_as(P_FLOAT),
                              buf.size) == -1
    assert b'unknown input' in lib.MXGetLastError()
    assert lib.MXPredSetInput(h, b'data', buf.ctypes.data_as(P_FLOAT),
                              buf.size) == -1
    assert b'needs 16' in lib.MXGetLastError()
    assert lib.MXPredForward(h) == -1
    assert b'inputs not set' in lib.MXGetLastError()
    shape_ptr = ctypes.POINTER(ctypes.c_uint)()
    ndim = ctypes.c_uint()
    assert lib.MXPredGetOutputShape(h, 0, ctypes.byref(shape_ptr),
                                    ctypes.byref(ndim)) == -1
    assert b'forward()' in lib.MXGetLastError()
    assert lib.MXPredFree(h) == 0
    rc, _ = _create(lib, sym_json, b'garbage', {'data': (2, 8)})
    assert rc == -1
    assert b'not a reference-format' in lib.MXGetLastError()
    # the output buffer must hold the output
    rc, h = _create(lib, sym_json, params, {'data': x.shape})
    xb = onp.ascontiguousarray(x).ravel()
    assert lib.MXPredSetInput(h, b'data', xb.ctypes.data_as(P_FLOAT),
                              xb.size) == 0
    assert lib.MXPredForward(h) == 0
    small = onp.zeros(3, onp.float32)
    assert lib.MXPredGetOutput(h, 0, small.ctypes.data_as(P_FLOAT),
                               small.size) == -1
    assert b'buffer too small' in lib.MXGetLastError()
    assert lib.MXPredGetOutput(h, 5, small.ctypes.data_as(P_FLOAT),
                               small.size) == -1
    assert b'out of range' in lib.MXGetLastError()
    lib.MXPredFree(h)


def test_dev_type_decides_the_device(lib, exported_mlp, monkeypatch):
    """dev_type 2 is the card: with none here MXPredCreate fails naming
    the missing device, even inside a CPU scope; 1 is the CPU; any other
    code fails."""
    import torch
    sym_f, par_f, x = exported_mlp
    sym_json, params = open(sym_f, 'rb').read(), open(par_f, 'rb').read()
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    rc, _ = _create(lib, sym_json, params, {'data': x.shape}, dev_type=2)
    assert rc == -1
    assert b'no CUDA device' in lib.MXGetLastError()
    rc, _ = _create(lib, sym_json, params, {'data': x.shape}, dev_type=3)
    assert rc == -1
    assert b'dev_type 3' in lib.MXGetLastError()
    rc, h = _create(lib, sym_json, params, {'data': x.shape}, dev_type=1)
    assert rc == 0
    lib.MXPredFree(h)


def test_the_header_declares_the_jax_packages_abi():
    """The port's predict header declares the JAX package's functions,
    argument for argument."""
    own = c_declarations(os.path.join(ROOT, 'mxnet_tpu_torch', 'csrc',
                                      'embed', 'c_predict_api.h'))
    ref = c_declarations(os.path.join(ROOT, 'src', 'predict',
                                      'c_predict_api.h'))
    assert len(own) == 7
    assert own == ref
    src = c_declarations(os.path.join(ROOT, 'mxnet_tpu_torch', 'csrc',
                                      'embed', 'c_predict_api.cc'))
    assert src == own
