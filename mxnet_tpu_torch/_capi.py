"""The port's C ABIs: build, load and link (the libraries the JAX package
builds with ``src/Makefile``).

Four C++ sources under ``csrc/embed/`` give MXNet's C surfaces over this
package:

- ``predict`` (``c_predict_api.{h,cc}``): ``MXPredCreate`` ...
  ``MXPredFree`` over ``_predict_embed``;
- ``train`` (``c_api_train.{h,cc}``): NDArrays, imperative ops, autograd,
  CachedOp and the KVStore over ``_train_embed``;
- ``ndarray`` (``c_api_ndarray.cc``): the ``.params`` container read and
  written in plain C++;
- ``symbol`` (``c_api_symbol.cc``): the symbol JSON read, inspected and
  written in plain C++.

Each has the JAX package's C ABI: the same function names, arguments,
return codes and error strings. ``build(name)`` compiles one with ``g++``
at first use into the build directory (``build/mxnet_tpu_torch/`` at the
root of the checkout, ``MXTPU_COMPILE_CACHE_DIR`` where set) as
``libmxtpu_torch_<name>-<hash>.so``, the hash over the source, its header
and the flags; ``build_all()`` starts the four compilers at once. Nothing
is built at import. The two embedding libraries take the include
directory of the interpreter that builds them (``sysconfig``) and link no
``libpython``: loaded with ``ctypes`` into a Python process, they resolve
the running interpreter's symbols. ``load(name)`` opens a library
``RTLD_LOCAL`` (the JAX package's libraries export the same symbol names)
with every function's argument and result types declared.

``PredictABI`` and ``TrainABI`` drive the predict and training
libraries' calls from Python, and ``predict`` runs one forward;
``ModuleTrainABI`` makes ``TrainABI``'s calls on a ``_train_embed``
module directly (checks use them; an embedder calls the C functions
itself).

A standalone C program links ``libpython`` itself: ``link_program``
compiles one against the train (or predict) library and the interpreter's
``libpython``, and ``program_env()`` is the environment it runs in (the
repository and this interpreter's site-packages on ``PYTHONPATH``).
Such a program has no ``with mx.cpu():`` scope, so its arrays go to the
card.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import sysconfig
import threading
import time

import numpy as onp

from .base import MXNetError
from .telemetry import compile as _compile

__all__ = ['LIBS', 'EMBED_DIR', 'header', 'lib_path', 'build', 'build_all',
           'load', 'link_program', 'program_env', 'python_link_flags',
           'predict', 'PredictABI', 'TrainABI', 'ModuleTrainABI']

_PKG = os.path.dirname(os.path.abspath(__file__))
EMBED_DIR = os.path.join(_PKG, 'csrc', 'embed')
CXX_FLAGS = ['-O3', '-std=c++17', '-fPIC', '-Wall', '-pthread', '-shared']

#: name -> (source, header or None, embeds CPython)
LIBS = {'predict': ('c_predict_api.cc', 'c_predict_api.h', True),
        'train': ('c_api_train.cc', 'c_api_train.h', True),
        'ndarray': ('c_api_ndarray.cc', None, False),
        'symbol': ('c_api_symbol.cc', None, False)}

_lock = threading.Lock()
_loaded = {}


def header(name):
    """The path of library ``name``'s C header."""
    return os.path.join(EMBED_DIR, LIBS[name][1])


def _python_include():
    paths = sysconfig.get_paths()
    return sorted({paths['include'], paths['platinclude']})


def _command(name):
    src, _hdr, py = LIBS[name]
    cmd = ['g++', *CXX_FLAGS]
    if py:
        for d in _python_include():
            cmd += ['-I', d]
    return cmd + [os.path.join(EMBED_DIR, src)]


def lib_path(name):
    """Where library ``name`` is built and loaded from."""
    src, hdr, _py = LIBS[name]
    digest = hashlib.sha1('\n'.join(_command(name)).encode())
    for f in [src] + ([hdr] if hdr else []):
        with open(os.path.join(EMBED_DIR, f), 'rb') as fh:
            digest.update(fh.read())
    return os.path.join(_compile.cache_dir(),
                        f'libmxtpu_torch_{name}-{digest.hexdigest()[:12]}.so')


def build_all(names=tuple(LIBS)):
    """Build every library of ``names`` that is not built yet, all
    compilers at once. Returns {name: path}; a failed build raises with
    the compiler's output."""
    from .ops._build import Compile
    with _lock:
        out, jobs = {}, {}
        t0 = time.perf_counter()
        for name in names:
            out[name] = path = lib_path(name)
            if os.path.isfile(path):
                _compile.cache_event(hit=True)
                continue
            _compile.cache_event(hit=False)
            jobs[name] = Compile(path, _command(name), timeout=300)
        errors = {n: j.wait() for n, j in jobs.items()}
        bad = {n: e for n, e in errors.items() if e is not None}
        if bad:
            raise MXNetError('C ABI build failed: ' + '\n'.join(
                f'{n}: {e}' for n, e in bad.items()))
        if jobs:
            _compile.report('build', time.perf_counter() - t0,
                            'capi:' + ','.join(sorted(jobs)),
                            lambda: _compile.signature(
                                [_compile.arg_sig(LIBS[n][0])
                                 for n in sorted(jobs)],
                                {'g++': ' '.join(CXX_FLAGS)}))
    return out


def build(name):
    """The path of library ``name``, built first where it is not."""
    if name not in LIBS:
        raise MXNetError(f"unknown C library {name!r}; known: "
                         f"{sorted(LIBS)}")
    return build_all((name,))[name]


_H = ctypes.c_void_p
_U32 = ctypes.c_uint32
_P = ctypes.POINTER


def _declare(lib, table):
    for fname, (restype, argtypes) in table.items():
        fn = getattr(lib, fname)
        fn.restype = restype
        fn.argtypes = argtypes


_INT = ctypes.c_int
_STR = ctypes.c_char_p

_SIGNATURES = {
    'predict': {
        'MXGetLastError': (_STR, []),
        'MXPredCreate': (_INT, [_STR, ctypes.c_void_p, _INT, _INT, _INT,
                                ctypes.c_uint, _P(_STR), _P(ctypes.c_uint),
                                _P(ctypes.c_uint), _P(_H)]),
        'MXPredSetInput': (_INT, [_H, _STR, _P(ctypes.c_float),
                                  ctypes.c_uint]),
        'MXPredForward': (_INT, [_H]),
        'MXPredGetOutputShape': (_INT, [_H, ctypes.c_uint,
                                        _P(_P(ctypes.c_uint)),
                                        _P(ctypes.c_uint)]),
        'MXPredGetOutput': (_INT, [_H, ctypes.c_uint, _P(ctypes.c_float),
                                   ctypes.c_uint]),
        'MXPredFree': (_INT, [_H]),
    },
    'train': {
        'MXTrainGetLastError': (_STR, []),
        'MXTrainNDArrayCreate': (_INT, [_P(_U32), _U32, _INT, _P(_H)]),
        'MXTrainNDArrayFree': (_INT, [_H]),
        'MXTrainNDArraySyncCopyFromCPU': (_INT, [_H, ctypes.c_void_p,
                                                 ctypes.c_size_t]),
        'MXTrainNDArraySyncCopyToCPU': (_INT, [_H, ctypes.c_void_p,
                                               ctypes.c_size_t]),
        'MXTrainNDArrayGetShape': (_INT, [_H, _P(_U32), _P(_U32)]),
        'MXTrainImperativeInvoke': (_INT, [_STR, _U32, _P(_H), _P(_U32),
                                           _P(_H), _U32, _U32, _P(_STR),
                                           _P(_STR)]),
        'MXTrainAutogradSetIsRecording': (_INT, [_INT, _P(_INT)]),
        'MXTrainAutogradSetIsTraining': (_INT, [_INT, _P(_INT)]),
        'MXTrainAutogradMarkVariables': (_INT, [_U32, _P(_H), _P(_U32),
                                                _P(_H)]),
        'MXTrainAutogradBackward': (_INT, [_U32, _P(_H), _P(_H), _INT]),
        'MXTrainNDArrayGetGrad': (_INT, [_H, _P(_H)]),
        'MXTrainSymbolCreateFromJSON': (_INT, [_STR, _P(_H)]),
        'MXTrainSymbolFree': (_INT, [_H]),
        'MXTrainSymbolGetNumOutputs': (_INT, [_H, _P(_U32)]),
        'MXTrainSymbolListInputs': (_INT, [_H, _P(_U32), _P(_P(_STR))]),
        'MXTrainCreateCachedOp': (_INT, [_H, _P(_H)]),
        'MXTrainFreeCachedOp': (_INT, [_H]),
        'MXTrainInvokeCachedOp': (_INT, [_H, _U32, _P(_H), _P(_U32), _P(_H),
                                         _U32]),
        'MXTrainKVStoreCreate': (_INT, [_STR, _P(_H)]),
        'MXTrainKVStoreFree': (_INT, [_H]),
        'MXTrainKVStoreInit': (_INT, [_H, _U32, _P(_INT), _P(_H)]),
        'MXTrainKVStorePush': (_INT, [_H, _U32, _P(_INT), _P(_H), _INT]),
        'MXTrainKVStorePull': (_INT, [_H, _U32, _P(_INT), _P(_H), _INT]),
    },
    'ndarray': {
        'MXGetLastError': (_STR, []),
        'MXGetVersion': (_INT, [_P(_INT)]),
        'MXNotifyShutdown': (_INT, []),
        'MXNDArrayCreate': (_INT, [_P(_U32), _U32, _INT, _INT, _INT, _INT,
                                   _P(_H)]),
        'MXNDArrayCreateEx': (_INT, [_P(_U32), _U32, _INT, _INT, _INT, _INT,
                                     _P(_H)]),
        'MXNDArrayFree': (_INT, [_H]),
        'MXNDArrayGetShape': (_INT, [_H, _P(_U32), _P(_P(ctypes.c_int64))]),
        'MXNDArrayGetDType': (_INT, [_H, _P(_INT)]),
        'MXNDArrayGetData': (_INT, [_H, _P(ctypes.c_void_p)]),
        'MXNDArraySyncCopyFromCPU': (_INT, [_H, ctypes.c_void_p,
                                            ctypes.c_size_t]),
        'MXNDArraySyncCopyToCPU': (_INT, [_H, ctypes.c_void_p,
                                          ctypes.c_size_t]),
        'MXNDArraySave': (_INT, [_STR, _U32, _P(_H), _P(_STR)]),
        'MXNDArrayIsNone': (_INT, [_H, _P(_INT)]),
        'MXNDArrayLoad': (_INT, [_STR, _P(_U32), _P(_P(_H)), _P(_U32),
                                 _P(_P(_STR))]),
        'MXNDArrayListFree': (_INT, [_U32, _P(_H), _U32, _P(_STR)]),
    },
    'symbol': {
        'MXGetLastError': (_STR, []),
        'MXSymbolCreateFromJSON': (_INT, [_STR, _P(_H)]),
        'MXSymbolCreateFromFile': (_INT, [_STR, _P(_H)]),
        'MXSymbolSaveToJSON': (_INT, [_H, _P(_STR)]),
        'MXSymbolSaveToFile': (_INT, [_H, _STR]),
        'MXSymbolListArguments': (_INT, [_H, _P(_U32), _P(_P(_STR))]),
        'MXSymbolListOutputs': (_INT, [_H, _P(_U32), _P(_P(_STR))]),
        'MXSymbolGetName': (_INT, [_H, _P(_STR), _P(_INT)]),
        'MXSymbolGetNumNodes': (_INT, [_H, _P(_U32)]),
        'MXSymbolGetAttr': (_INT, [_H, _STR, _STR, _P(_STR), _P(_INT)]),
        'MXSymbolFree': (_INT, [_H]),
    },
}


def load(name):
    """Library ``name`` (built first where it is not), opened
    ``RTLD_LOCAL`` with its functions' types declared; one handle per
    library and process."""
    path = build(name)
    with _lock:
        lib = _loaded.get(path)
        if lib is None:
            lib = ctypes.CDLL(path, mode=os.RTLD_LOCAL | os.RTLD_NOW)
            _declare(lib, _SIGNATURES[name])
            _loaded[path] = lib
    return lib


def python_link_flags():
    """The flags that link this interpreter's ``libpython`` into a
    program (``--no-as-needed``: the program itself calls none of it, the
    library it links does)."""
    cv = sysconfig.get_config_var
    libdir = cv('LIBDIR')
    flags = [f'-L{libdir}', f'-Wl,-rpath,{libdir}', '-Wl,--no-as-needed',
             f'-lpython{cv("LDVERSION") or cv("VERSION")}',
             '-Wl,--as-needed']
    for extra in ('LIBS', 'SYSLIBS'):
        flags += (cv(extra) or '').split()
    return flags


def link_program(source, out, include_dirs=(), lib='train'):
    """Compile the C program ``source`` into ``out`` against library
    ``lib`` and this interpreter's ``libpython`` (``cc``); a failed build
    raises with the compiler's output. Returns ``out``."""
    from .ops._build import Compile
    path = build(lib)
    cmd = ['cc', '-O2', '-Wall']
    for d in include_dirs:
        cmd += ['-I', d]
    cmd += [source, path, f'-Wl,-rpath,{os.path.dirname(path)}',
            *python_link_flags()]
    err = Compile(out, cmd, timeout=120).wait()
    if err is not None:
        raise MXNetError(f"linking {source} failed: {err}")
    return out


def program_env(base=None):
    """The environment a standalone program of ``link_program`` runs in:
    ``base`` (default ``os.environ``) with the repository and this
    interpreter's site-packages first on ``PYTHONPATH``, so that the
    interpreter the program embeds imports this package and its
    dependencies."""
    env = dict(os.environ if base is None else base)
    paths = sysconfig.get_paths()
    parts = [os.path.dirname(_PKG), paths['purelib'], paths['platlib']]
    if env.get('PYTHONPATH'):
        parts.append(env['PYTHONPATH'])
    env['PYTHONPATH'] = os.pathsep.join(dict.fromkeys(parts))
    return env


def _ok(rc, lib, err='MXGetLastError'):
    if rc != 0:
        raise MXNetError(getattr(lib, err)().decode())


class PredictABI:
    """One predictor of the predict library ``lib`` driven from Python over
    ``ctypes``: ``MXPredCreate`` over ``shapes`` ({input name: shape}),
    then ``set_input``, ``forward``, ``output`` and ``free``, on the card
    (``dev_type`` 2, ``cuda:dev_id``) unless ``dev_type`` is 1, the CPU.
    A failed call raises with ``MXGetLastError``."""

    def __init__(self, lib, symbol_json, params, shapes, dev_type=2,
                 dev_id=0):
        self.lib = lib
        names = list(shapes)
        indptr, dims = [0], []
        for n in names:
            dims += list(shapes[n])
            indptr.append(len(dims))
        self.handle = ctypes.c_void_p()
        _ok(lib.MXPredCreate(
            symbol_json, params, len(params), dev_type, dev_id, len(names),
            (ctypes.c_char_p * len(names))(*[n.encode() for n in names]),
            (ctypes.c_uint * len(indptr))(*indptr),
            (ctypes.c_uint * max(1, len(dims)))(*dims),
            ctypes.byref(self.handle)), lib)

    def set_input(self, name, arr):
        buf = onp.ascontiguousarray(arr, onp.float32).ravel()
        _ok(self.lib.MXPredSetInput(self.handle, name.encode(),
                                    buf.ctypes.data_as(_P(ctypes.c_float)),
                                    buf.size), self.lib)

    def forward(self):
        _ok(self.lib.MXPredForward(self.handle), self.lib)

    def output(self, index=0):
        shape_ptr, ndim = _P(ctypes.c_uint)(), ctypes.c_uint()
        _ok(self.lib.MXPredGetOutputShape(self.handle, index,
                                          ctypes.byref(shape_ptr),
                                          ctypes.byref(ndim)), self.lib)
        out = onp.empty(tuple(shape_ptr[i] for i in range(ndim.value)),
                        onp.float32)
        _ok(self.lib.MXPredGetOutput(self.handle, index, out.ctypes.data_as(
            _P(ctypes.c_float)), out.size), self.lib)
        return out

    def free(self):
        if self.handle:
            self.lib.MXPredFree(self.handle)
            self.handle = ctypes.c_void_p()


def predict(lib, symbol_json, params, inputs, dev_type=2, dev_id=0):
    """Output 0 of one forward through the predict library ``lib`` over
    ``inputs`` ({name: float32 array}), on the card unless ``dev_type`` is
    1."""
    p = PredictABI(lib, symbol_json, params,
                   {k: v.shape for k, v in inputs.items()}, dev_type, dev_id)
    try:
        for k, v in inputs.items():
            p.set_input(k, v)
        p.forward()
        return p.output(0)
    finally:
        p.free()


_TRAIN_DTYPES = {onp.dtype('float32'): 0, onp.dtype('float64'): 1,
                 onp.dtype('float16'): 2, onp.dtype('uint8'): 3,
                 onp.dtype('int32'): 4, onp.dtype('int8'): 5,
                 onp.dtype('int64'): 6}


class TrainABI:
    """The training library's calls driven from Python over ``ctypes``;
    handles stay opaque ``c_void_p``s and data crosses as host bytes, as
    in a C embedder. A failed call raises with
    ``MXTrainGetLastError``."""

    def __init__(self, lib):
        self.lib = lib
        self._symbols = []

    def _ok(self, rc):
        _ok(rc, self.lib, 'MXTrainGetLastError')

    def create(self, shape, dtype='float32'):
        h = _H()
        self._ok(self.lib.MXTrainNDArrayCreate(
            (_U32 * len(shape))(*shape), len(shape),
            _TRAIN_DTYPES[onp.dtype(dtype)], ctypes.byref(h)))
        return h

    def set(self, h, arr):
        """Copy ``arr`` (a numpy array in the array's dtype; a list is
        float32) into ``h``."""
        arr = onp.ascontiguousarray(arr if isinstance(arr, onp.ndarray)
                                    else onp.asarray(arr, onp.float32))
        self._ok(self.lib.MXTrainNDArraySyncCopyFromCPU(
            h, arr.ctypes.data_as(ctypes.c_void_p), arr.nbytes))

    def get(self, h, shape, dtype='float32'):
        out = onp.empty(shape, dtype)
        self._ok(self.lib.MXTrainNDArraySyncCopyToCPU(
            h, out.ctypes.data_as(ctypes.c_void_p), out.nbytes))
        return out

    def free(self, *hs):
        for h in hs:
            self.lib.MXTrainNDArrayFree(h)

    def invoke(self, name, ins, params=None, max_outputs=4):
        params = params or {}
        outs = (_H * max_outputs)()
        n = _U32()
        self._ok(self.lib.MXTrainImperativeInvoke(
            name.encode(), len(ins), (_H * len(ins))(*[i.value for i in ins]),
            ctypes.byref(n), outs, max_outputs, len(params),
            (_STR * len(params))(*[k.encode() for k in params]),
            (_STR * len(params))(*[str(v).encode()
                                   for v in params.values()])))
        return [_H(outs[i]) for i in range(n.value)]

    def mark(self, variables, grads):
        n = len(variables)
        self._ok(self.lib.MXTrainAutogradMarkVariables(
            n, (_H * n)(*[v.value for v in variables]),
            (_U32 * n)(*([1] * n)), (_H * n)(*[g.value for g in grads])))

    def flags(self, recording=None, training=None):
        prev = ctypes.c_int()
        if recording is not None:
            self._ok(self.lib.MXTrainAutogradSetIsRecording(
                int(recording), ctypes.byref(prev)))
        if training is not None:
            self._ok(self.lib.MXTrainAutogradSetIsTraining(
                int(training), ctypes.byref(prev)))

    def backward(self, outputs, head_grads=None):
        n = len(outputs)
        heads = None if head_grads is None else \
            (_H * n)(*[g.value for g in head_grads])
        self._ok(self.lib.MXTrainAutogradBackward(
            n, (_H * n)(*[o.value for o in outputs]), heads, 0))

    def grad(self, h):
        g = _H()
        self._ok(self.lib.MXTrainNDArrayGetGrad(h, ctypes.byref(g)))
        return g

    def cached_op(self, symbol_json):
        """(input names in MXTrainSymbolListInputs order, CachedOp)."""
        sym = _H()
        self._ok(self.lib.MXTrainSymbolCreateFromJSON(
            symbol_json.encode(), ctypes.byref(sym)))
        self._symbols.append(sym)
        n, names = _U32(), _P(_STR)()
        self._ok(self.lib.MXTrainSymbolListInputs(sym, ctypes.byref(n),
                                                  ctypes.byref(names)))
        cop = _H()
        self._ok(self.lib.MXTrainCreateCachedOp(sym, ctypes.byref(cop)))
        return [names[i].decode() for i in range(n.value)], cop

    def call(self, cop, inputs, max_outputs=2):
        outs = (_H * max_outputs)()
        n = _U32()
        self._ok(self.lib.MXTrainInvokeCachedOp(
            cop, len(inputs), (_H * len(inputs))(*[i.value for i in inputs]),
            ctypes.byref(n), outs, max_outputs))
        return [_H(outs[i]) for i in range(n.value)]


class ModuleTrainABI:
    """``TrainABI``'s calls made in Python on ``module``, a
    ``_train_embed`` module (the functions the training library calls),
    so a check can hold the C layer against the Python one."""

    def __init__(self, module):
        self.m = module

    def create(self, shape, dtype='float32'):
        return self.m.create_ndarray(shape, _TRAIN_DTYPES[onp.dtype(dtype)])

    def set(self, h, arr):
        arr = arr if isinstance(arr, onp.ndarray) else \
            onp.asarray(arr, onp.float32)
        self.m.copy_from_bytes(h, onp.ascontiguousarray(arr).tobytes())

    def get(self, h, shape, dtype='float32'):
        return self.m.copy_to_numpy(h).reshape(shape)

    def free(self, *hs):
        pass

    def invoke(self, name, ins, params=None):
        params = params or {}
        return self.m.imperative_invoke(name, ins, list(params),
                                        [str(v) for v in params.values()])

    def mark(self, variables, grads):
        self.m.mark_variables(variables, [1] * len(variables), grads)

    def flags(self, recording=None, training=None):
        if recording is not None:
            self.m.set_recording(recording)
        if training is not None:
            self.m.set_training(training)

    def backward(self, outputs, head_grads=None):
        self.m.backward(outputs, head_grads)

    def grad(self, h):
        return self.m.get_grad(h)

    def cached_op(self, symbol_json):
        sym = self.m.symbol_from_json(symbol_json)
        return self.m.symbol_list_inputs(sym), self.m.create_cached_op(sym)

    def call(self, cop, inputs):
        return self.m.invoke_cached_op(cop, inputs)
