"""The port's NDArray C API (``csrc/embed/c_api_ndarray.cc``), on the CPU.

The four cases of tests/test_c_ndarray.py through the port's library,
with both packages' Python sides: a file the C library writes loads in
the JAX package and in the port, the arrays bitwise, and its bytes are
the ones both packages' ``nd.save`` write; a file either package writes
loads in the C library, bitwise; the version, the shape and the error
paths. The exported functions are the JAX source's, argument for
argument. The library is built with ``g++`` once for the module; a failed
build fails the tests.
"""
import ctypes
import os

import numpy as onp
import pytest

import mxnet_tpu as mj
import mxnet_tpu_torch as mt
from test_torch_c_predict import c_declarations
from test_torch_jax_globals import jax_globals  # noqa: F401

ROOT = os.path.normpath(os.path.join(os.path.dirname(__file__), os.pardir))
FLAGS = {'float32': 0, 'float64': 1, 'float16': 2, 'uint8': 3, 'int32': 4,
         'int8': 5, 'int64': 6}
NP = {v: onp.dtype(k) for k, v in FLAGS.items()}


@pytest.fixture(scope='module')
def lib(tmp_path_factory):
    from mxnet_tpu_torch import _capi
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv('MXTPU_COMPILE_CACHE_DIR',
                  str(tmp_path_factory.mktemp('build')))
        yield _capi.load('ndarray')


@pytest.fixture(autouse=True)
def _port_on_cpu():
    with mt.cpu():
        yield


def _make(lib, arr):
    h = ctypes.c_void_p()
    assert lib.MXNDArrayCreate((ctypes.c_uint32 * arr.ndim)(*arr.shape),
                               arr.ndim, 1, 0, 0, FLAGS[arr.dtype.name],
                               ctypes.byref(h)) == 0
    c = onp.ascontiguousarray(arr)
    assert lib.MXNDArraySyncCopyFromCPU(
        h, c.ctypes.data_as(ctypes.c_void_p), c.size) == 0
    return h


def _read(lib, h):
    ndim = ctypes.c_uint32()
    pdata = ctypes.POINTER(ctypes.c_int64)()
    assert lib.MXNDArrayGetShape(h, ctypes.byref(ndim),
                                 ctypes.byref(pdata)) == 0
    dt = ctypes.c_int()
    assert lib.MXNDArrayGetDType(h, ctypes.byref(dt)) == 0
    out = onp.zeros(tuple(pdata[j] for j in range(ndim.value)),
                    NP[dt.value])
    assert lib.MXNDArraySyncCopyToCPU(
        h, out.ctypes.data_as(ctypes.c_void_p), out.size) == 0
    return out


def _arrays():
    rng = onp.random.RandomState(0)
    return {'weight': rng.randn(2, 3).astype('float32'),
            'bias': onp.arange(4, dtype=onp.int32),
            'half': rng.randn(5).astype('float16'),
            'bytes': rng.randint(0, 255, (2, 2)).astype('uint8')}


def test_version_and_create(lib):
    v = ctypes.c_int()
    assert lib.MXGetVersion(ctypes.byref(v)) == 0 and v.value >= 20000
    a = onp.arange(12, dtype=onp.float32).reshape(3, 4)
    h = _make(lib, a)
    onp.testing.assert_array_equal(_read(lib, h), a)
    none = ctypes.c_int()
    assert lib.MXNDArrayIsNone(h, ctypes.byref(none)) == 0 and \
        none.value == 0
    ptr = ctypes.c_void_p()
    assert lib.MXNDArrayGetData(h, ctypes.byref(ptr)) == 0
    onp.testing.assert_array_equal(
        onp.ctypeslib.as_array(ctypes.cast(ptr, ctypes.POINTER(
            ctypes.c_float)), (3, 4)), a)
    assert lib.MXNDArrayFree(h) == 0
    assert lib.MXNotifyShutdown() == 0


@pytest.mark.parametrize('reader', ['jax', 'port'])
def test_c_save_python_load(lib, tmp_path, reader):
    arrays = _arrays()
    handles = [_make(lib, a) for a in arrays.values()]
    fname = str(tmp_path / 'c_written.params')
    assert lib.MXNDArraySave(
        fname.encode(), len(handles), (ctypes.c_void_p * len(handles))(
            *handles), (ctypes.c_char_p * len(handles))(
                *[k.encode() for k in arrays])) == 0, lib.MXGetLastError()
    pk = mj if reader == 'jax' else mt
    loaded = pk.nd.load(fname)
    wide = str(tmp_path / 'int64.params')
    h64 = _make(lib, onp.arange(5, dtype=onp.int64))
    assert lib.MXNDArraySave(wide.encode(), 1, (ctypes.c_void_p * 1)(h64),
                             (ctypes.c_char_p * 1)(b'ids')) == 0
    # both packages read int64 as their nd.array makes it (int32)
    onp.testing.assert_array_equal(pk.nd.load(wide)['ids'].asnumpy(),
                                   mj.nd.load(wide)['ids'].asnumpy())
    lib.MXNDArrayFree(h64)
    assert set(loaded) == set(arrays)
    for k, a in arrays.items():
        got = loaded[k].asnumpy()
        assert got.dtype == a.dtype, k
        onp.testing.assert_array_equal(got, a)
    # the bytes both packages' serializers write for the same arrays
    again = str(tmp_path / f'{reader}_written.params')
    pk.nd.save(again, {k: pk.nd.array(a, dtype=a.dtype)
                       for k, a in arrays.items()})
    assert open(again, 'rb').read() == open(fname, 'rb').read()
    for h in handles:
        lib.MXNDArrayFree(h)


@pytest.mark.parametrize('writer', ['jax', 'port'])
def test_python_save_c_load(lib, tmp_path, writer):
    arrays = _arrays()
    fname = str(tmp_path / f'{writer}.params')
    pk = mj if writer == 'jax' else mt
    pk.nd.save(fname, {k: pk.nd.array(a, dtype=a.dtype)
                       for k, a in arrays.items()})
    n, nn = ctypes.c_uint32(), ctypes.c_uint32()
    arrs = ctypes.POINTER(ctypes.c_void_p)()
    names = ctypes.POINTER(ctypes.c_char_p)()
    assert lib.MXNDArrayLoad(fname.encode(), ctypes.byref(n),
                             ctypes.byref(arrs), ctypes.byref(nn),
                             ctypes.byref(names)) == 0, lib.MXGetLastError()
    assert n.value == nn.value == len(arrays)
    got = {}
    for i in range(n.value):
        h = ctypes.c_void_p(arrs[i])
        got[names[i].decode()] = _read(lib, h)
        lib.MXNDArrayFree(h)
    lib.MXNDArrayListFree(n, arrs, nn, names)
    assert set(got) == set(arrays)
    for k, a in arrays.items():
        assert got[k].dtype == a.dtype, k
        onp.testing.assert_array_equal(got[k], a)


def test_error_paths(lib, tmp_path):
    h = ctypes.c_void_p()
    assert lib.MXNDArrayCreate((ctypes.c_uint32 * 1)(3), 1, 1, 0, 0, 99,
                               ctypes.byref(h)) == -1
    assert b'dtype' in lib.MXGetLastError()
    n, nn = ctypes.c_uint32(), ctypes.c_uint32()
    arrs = ctypes.POINTER(ctypes.c_void_p)()
    names = ctypes.POINTER(ctypes.c_char_p)()
    args = (ctypes.byref(n), ctypes.byref(arrs), ctypes.byref(nn),
            ctypes.byref(names))
    assert lib.MXNDArrayLoad(str(tmp_path / 'nope.params').encode(),
                             *args) == -1
    assert b'cannot open' in lib.MXGetLastError()
    bad = tmp_path / 'bad.params'
    bad.write_bytes(b'not an ndarray file at all')
    assert lib.MXNDArrayLoad(str(bad).encode(), *args) == -1
    assert b'not an NDArray list file' in lib.MXGetLastError()
    good = tmp_path / 'good.params'
    mt.nd.save(str(good), {'w': mt.nd.ones((4, 4))})
    (tmp_path / 'cut.params').write_bytes(good.read_bytes()[:-30])
    assert lib.MXNDArrayLoad(str(tmp_path / 'cut.params').encode(),
                             *args) == -1
    h = _make(lib, onp.zeros(3, onp.float32))
    buf = onp.zeros(2, onp.float32)
    assert lib.MXNDArraySyncCopyToCPU(
        h, buf.ctypes.data_as(ctypes.c_void_p), buf.size) == -1
    assert b'size mismatch' in lib.MXGetLastError()
    lib.MXNDArrayFree(h)


def test_the_exports_are_the_jax_sources():
    own = c_declarations(os.path.join(ROOT, 'mxnet_tpu_torch', 'csrc',
                                      'embed', 'c_api_ndarray.cc'))
    assert len(own) == 15
    assert own == c_declarations(os.path.join(ROOT, 'src', 'ndarray',
                                              'c_api_ndarray.cc'))
