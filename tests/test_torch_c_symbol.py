"""The port's Symbol C API (``csrc/embed/c_api_symbol.cc``), on the CPU.

The five cases of tests/test_c_symbol.py through the port's library: a
graph the port (and the JAX package) writes loads in the C library with
the same arguments, outputs, name, node count and attributes; the C
library's re-serialization loads back in both packages as the same
graph, its JSON equal to the original once parsed, and evaluates to the
same numbers; the file and error paths; non-ASCII names through
``\\uXXXX`` escapes. The exported functions are the JAX source's,
argument for argument. The library is built with ``g++`` once for the
module; a failed build fails the tests.
"""
import ctypes
import json
import os

import numpy as onp
import pytest

import mxnet_tpu as mj
import mxnet_tpu_torch as mt
from test_torch_c_predict import c_declarations
from test_torch_jax_globals import jax_globals  # noqa: F401

ROOT = os.path.normpath(os.path.join(os.path.dirname(__file__), os.pardir))
PKGS = {'jax': mj, 'port': mt}


@pytest.fixture(scope='module')
def lib(tmp_path_factory):
    from mxnet_tpu_torch import _capi
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv('MXTPU_COMPILE_CACHE_DIR',
                  str(tmp_path_factory.mktemp('build')))
        yield _capi.load('symbol')


@pytest.fixture(autouse=True)
def _port_on_cpu():
    with mt.cpu():
        yield


def _symbol(pk):
    x = pk.sym.Variable('data')
    with pk.AttrScope(ctx_group='g1'):
        w = pk.sym.Variable('fc_weight')
    fc = pk.sym.FullyConnected(x, w, None, num_hidden=4, no_bias=True,
                               name='fc')
    return pk.sym.Activation(fc, act_type='relu', name='act')


def _load(lib, js):
    h = ctypes.c_void_p()
    assert lib.MXSymbolCreateFromJSON(js.encode(), ctypes.byref(h)) == 0, \
        lib.MXGetLastError()
    return h


def _strs(fn, h):
    n = ctypes.c_uint32()
    arr = ctypes.POINTER(ctypes.c_char_p)()
    assert fn(h, ctypes.byref(n), ctypes.byref(arr)) == 0
    return [arr[i].decode() for i in range(n.value)]


@pytest.mark.parametrize('pkg', sorted(PKGS))
def test_load_and_introspect(lib, pkg):
    s = _symbol(PKGS[pkg])
    h = _load(lib, s.tojson())
    assert _strs(lib.MXSymbolListArguments, h) == s.list_arguments()
    assert _strs(lib.MXSymbolListOutputs, h) == s.list_outputs()
    name, ok = ctypes.c_char_p(), ctypes.c_int()
    assert lib.MXSymbolGetName(h, ctypes.byref(name), ctypes.byref(ok)) == 0
    assert ok.value == 1 and name.value.decode() == s.name
    n = ctypes.c_uint32()
    assert lib.MXSymbolGetNumNodes(h, ctypes.byref(n)) == 0
    assert n.value == len(json.loads(s.tojson())['nodes'])
    lib.MXSymbolFree(h)


def test_attrs_visible_from_c(lib):
    h = _load(lib, _symbol(mt).tojson())
    out, ok = ctypes.c_char_p(), ctypes.c_int()
    assert lib.MXSymbolGetAttr(h, b'fc_weight', b'__ctx_group__',
                               ctypes.byref(out), ctypes.byref(ok)) == 0
    assert ok.value == 1 and out.value == b'g1'
    assert lib.MXSymbolGetAttr(h, b'fc_weight', b'nope', ctypes.byref(out),
                               ctypes.byref(ok)) == 0
    assert ok.value == 0
    assert lib.MXSymbolGetAttr(h, b'ghost', b'k', ctypes.byref(out),
                               ctypes.byref(ok)) != 0
    assert b'ghost' in lib.MXGetLastError()
    lib.MXSymbolFree(h)


@pytest.mark.parametrize('reader', sorted(PKGS))
def test_roundtrip_reloads_in_python(lib, tmp_path, reader):
    """The port's graph re-serialized by the C library loads back in
    ``reader`` as the same graph (JSON equal once parsed) and computes the
    same numbers as the original in the port."""
    s = _symbol(mt)
    h = _load(lib, s.tojson())
    path = str(tmp_path / 'c_roundtrip-symbol.json')
    assert lib.MXSymbolSaveToFile(h, path.encode()) == 0
    cjson = ctypes.c_char_p()
    assert lib.MXSymbolSaveToJSON(h, ctypes.byref(cjson)) == 0
    assert json.loads(cjson.value.decode()) == json.loads(s.tojson())
    lib.MXSymbolFree(h)
    pk = PKGS[reader]
    s2 = pk.sym.load(path)
    assert pk.test_utils.same_symbol_structure(s2, pk.sym.fromjson(
        s.tojson()))
    assert json.loads(s2.tojson()) == json.loads(s.tojson())
    rng = onp.random.RandomState(0)
    binds = {'data': rng.randn(2, 8).astype('float32'),
             'fc_weight': rng.randn(4, 8).astype('float32')}
    want = s.eval_dict({k: mt.nd.array(v) for k, v in binds.items()})
    got = s2.eval_dict({k: pk.nd.array(v) for k, v in binds.items()})
    onp.testing.assert_allclose(got.asnumpy(), want.asnumpy(), rtol=1e-6)


def test_file_and_error_paths(lib, tmp_path):
    h = ctypes.c_void_p()
    assert lib.MXSymbolCreateFromFile(b'/nope/missing.json',
                                      ctypes.byref(h)) != 0
    assert b'cannot open' in lib.MXGetLastError()
    assert lib.MXSymbolCreateFromJSON(b'{"nodes": "bogus"}',
                                      ctypes.byref(h)) != 0
    assert b'invalid symbol JSON' in lib.MXGetLastError()
    bad = json.dumps({'nodes': [{'op': 'null', 'name': 'x', 'attrs': {},
                                 'inputs': [[5, 0, 0]]}],
                      'heads': [[0, 0, 0]]})
    assert lib.MXSymbolCreateFromJSON(bad.encode(), ctypes.byref(h)) != 0
    assert b'input index out of range' in lib.MXGetLastError()
    path = tmp_path / 'port-symbol.json'
    _symbol(mt).save(str(path))
    assert lib.MXSymbolCreateFromFile(str(path).encode(),
                                      ctypes.byref(h)) == 0
    lib.MXSymbolFree(h)


def test_unicode_names_roundtrip(lib):
    js = json.dumps({
        'nodes': [{'op': 'null', 'name': 'fc_über_\U0001F600',
                   'attrs': {'k': 'vé'}, 'inputs': []}],
        'heads': [[0, 0, 0]]})
    assert '\\u' in js
    h = _load(lib, js)
    assert _strs(lib.MXSymbolListArguments, h) == ['fc_über_\U0001F600']
    out, ok = ctypes.c_char_p(), ctypes.c_int()
    assert lib.MXSymbolGetAttr(h, 'fc_über_\U0001F600'.encode(), b'k',
                               ctypes.byref(out), ctypes.byref(ok)) == 0
    assert ok.value == 1 and out.value.decode() == 'vé'
    cjson = ctypes.c_char_p()
    assert lib.MXSymbolSaveToJSON(h, ctypes.byref(cjson)) == 0
    assert json.loads(cjson.value.decode())['nodes'][0]['name'] == \
        'fc_über_\U0001F600'
    lib.MXSymbolFree(h)


def test_the_exports_are_the_jax_sources():
    own = c_declarations(os.path.join(ROOT, 'mxnet_tpu_torch', 'csrc',
                                      'embed', 'c_api_symbol.cc'))
    assert len(own) == 11
    assert own == c_declarations(os.path.join(ROOT, 'src', 'symbol',
                                              'c_api_symbol.cc'))
