"""Loader for the native IO runtime (counterpart of ``mxnet_tpu/_native.py``).

The runtime is ``csrc/io/mxtpu_io.cc``, the port's copy of the JAX
package's source: the RecordIO reader and writer and the threaded JPEG
decode pipeline, a flat C interface read with ``ctypes``. The port
compiles it with the JAX package's flags
(``g++ -O3 -std=c++17 -fPIC -pthread -shared -ljpeg``),
into the kernel build directory (``build/mxnet_tpu_torch/`` at the root
of the checkout, ``MXTPU_COMPILE_CACHE_DIR`` where set) at first use. It
builds to a temporary name and moves the library into place, so
processes that build at once do not load a half-written file; the build
counts in the compile ledger as the CUDA kernels' builds do. It never
loads the JAX package's library.

Two routes link a libjpeg, tried in this order:

- ``'system'``: the system's headers and ``-ljpeg``, as the JAX package
  builds it (a machine with the libjpeg development files);
- the libjpeg-turbo that Pillow's wheel bundles (``pillow.libs/
  libjpeg-*.so.62*``, the libjpeg ABI 62) through the ABI-62 headers kept
  in ``csrc/jpeg62/`` (a machine with Pillow and no libjpeg headers).

The route is part of the library's name (``libmxtpu_io-<hash>.so``, the
hash of the route, the flags, the source and the headers), so a library
built on one machine is never taken for the other route's. A library
found in the build directory that does not load (built on another
machine, or against a Pillow since replaced) is rebuilt once before the
next route is tried. ``jpeg_route()`` says which libjpeg the loaded
library links. Where no route builds, or ``MXNET_TPU_NO_NATIVE_BUILD``
is set and nothing loadable is built, ``get_lib()`` returns None and the
callers take the pure-Python (PIL) path, as in the JAX package; the
failure is logged with the compiler's stderr, ``build_error()`` returns
it, and ``ImageRecordIter.native`` says which path an iterator took.
"""
from __future__ import annotations

import ctypes
import glob
import hashlib
import importlib.util
import logging
import os
import threading
import time

from .telemetry import compile as _compile

__all__ = ['get_lib', 'native_available', 'lib_path', 'build_error',
           'jpeg_route', 'pillow_libjpeg', 'SOURCE', 'CXX_FLAGS',
           'LD_FLAGS']

_PKG = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_PKG, 'csrc', 'io', 'mxtpu_io.cc')
JPEG62_HEADERS = os.path.join(_PKG, 'csrc', 'jpeg62')
CXX_FLAGS = ['-O3', '-std=c++17', '-fPIC', '-Wall', '-pthread']
LD_FLAGS = ['-shared', '-pthread', '-ljpeg']

_log = logging.getLogger('mxnet_tpu_torch.io')
_lib = None
_lib_tried = False
_error = None
_route = None
_lock = threading.Lock()


def pillow_libjpeg():
    """The libjpeg-turbo (ABI 62) bundled in Pillow's wheel, resolved, or
    None. Found without importing PIL."""
    spec = importlib.util.find_spec('PIL')
    if spec is None or not spec.origin:
        return None
    libs = os.path.join(os.path.dirname(os.path.dirname(spec.origin)),
                        'pillow.libs')
    found = sorted(glob.glob(os.path.join(libs, 'libjpeg*.so.62*')))
    return os.path.realpath(found[0]) if found else None


def _routes():
    """(route, g++ command without ``-o``) in the order they are tried."""
    yield 'system', ['g++', *CXX_FLAGS, SOURCE, *LD_FLAGS]
    jpeg = pillow_libjpeg()
    if jpeg is not None:
        yield jpeg, ['g++', *CXX_FLAGS, '-I', JPEG62_HEADERS, SOURCE,
                     '-shared', '-pthread', jpeg,
                     f'-Wl,-rpath,{os.path.dirname(jpeg)}']


def lib_path(route=None):
    """Where the library of ``route`` ('system' or the path of Pillow's
    libjpeg) is built and loaded from, named by the hash of the route,
    the flags, the source and the headers kept for the Pillow route.
    With no route: the loaded library's path, else the system route's."""
    if route is None:
        route = _route or 'system'
    digest = hashlib.sha1('\n'.join([route] + CXX_FLAGS + LD_FLAGS).encode())
    for path in [SOURCE] + sorted(glob.glob(os.path.join(JPEG62_HEADERS,
                                                         '*.h'))):
        with open(path, 'rb') as f:
            digest.update(f.read())
    return os.path.join(_compile.cache_dir(),
                        f'libmxtpu_io-{digest.hexdigest()[:12]}.so')


def jpeg_route():
    """The libjpeg the loaded library links: 'system', the path of
    Pillow's bundled one, or None when nothing is loaded."""
    return _route if get_lib() is not None else None


def _configure(lib):
    u64 = ctypes.c_uint64
    lib.mxt_recordio_writer_create.restype = ctypes.c_void_p
    lib.mxt_recordio_writer_create.argtypes = [ctypes.c_char_p]
    lib.mxt_recordio_writer_write.restype = ctypes.c_int
    lib.mxt_recordio_writer_write.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint32,
        ctypes.POINTER(u64)]
    lib.mxt_recordio_writer_free.argtypes = [ctypes.c_void_p]

    lib.mxt_recordio_reader_create.restype = ctypes.c_void_p
    lib.mxt_recordio_reader_create.argtypes = [ctypes.c_char_p]
    lib.mxt_recordio_reader_read.restype = ctypes.c_int64
    lib.mxt_recordio_reader_read.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_char_p)]
    lib.mxt_recordio_reader_tell.restype = u64
    lib.mxt_recordio_reader_tell.argtypes = [ctypes.c_void_p]
    lib.mxt_recordio_reader_seek.restype = ctypes.c_int
    lib.mxt_recordio_reader_seek.argtypes = [ctypes.c_void_p, u64]
    lib.mxt_recordio_reader_free.argtypes = [ctypes.c_void_p]

    lib.mxt_pipeline_create.restype = ctypes.c_void_p
    lib.mxt_pipeline_create.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, u64,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.c_int, u64]
    lib.mxt_pipeline_num_records.restype = ctypes.c_int64
    lib.mxt_pipeline_num_records.argtypes = [ctypes.c_void_p]
    lib.mxt_pipeline_next.restype = ctypes.c_int
    lib.mxt_pipeline_next.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
        ctypes.POINTER(ctypes.POINTER(ctypes.c_float))]
    lib.mxt_pipeline_next_lease.restype = ctypes.c_int
    lib.mxt_pipeline_next_lease.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p),
        ctypes.POINTER(ctypes.POINTER(ctypes.c_float)), ctypes.POINTER(u64)]
    lib.mxt_pipeline_return.restype = ctypes.c_int
    lib.mxt_pipeline_return.argtypes = [ctypes.c_void_p, u64]
    lib.mxt_pipeline_leased.restype = ctypes.c_int
    lib.mxt_pipeline_leased.argtypes = [ctypes.c_void_p]
    lib.mxt_pipeline_cache_stats.restype = None
    lib.mxt_pipeline_cache_stats.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(u64), ctypes.POINTER(u64),
        ctypes.POINTER(u64)]
    lib.mxt_pipeline_error.restype = ctypes.c_char_p
    lib.mxt_pipeline_error.argtypes = [ctypes.c_void_p]
    lib.mxt_pipeline_reset.argtypes = [ctypes.c_void_p]
    lib.mxt_pipeline_free.argtypes = [ctypes.c_void_p]
    return lib


def _build(out, cmd):
    """Build ``out`` (``ops._build.Compile``): None on success, else the
    compiler's output."""
    from .ops._build import Compile
    t0 = time.perf_counter()
    _compile.cache_event(hit=False)
    err = Compile(out, cmd, timeout=300).wait()
    if err is not None:
        return err
    _compile.report('build', time.perf_counter() - t0, 'native:mxtpu_io',
                    lambda: _compile.signature(
                        [_compile.arg_sig(os.path.basename(SOURCE))],
                        {'g++': ' '.join(cmd[1:])}))
    return None


def _load(route, cmd):
    """(library, None) for one route, loaded from the build directory or
    built there first; (None, why) when it neither loads nor builds."""
    out = lib_path(route)
    stale = None
    if os.path.isfile(out):
        try:
            lib = _configure(ctypes.CDLL(out))
            _compile.cache_event(hit=True)
            return lib, None
        except OSError as e:
            stale = f'cannot load {out}: {e}'
            _log.info('%s; rebuilding it', stale)
    from . import config as _config
    if _config.get('MXNET_TPU_NO_NATIVE_BUILD'):
        return None, (stale or f'no library is built at {out}') + \
            ' and MXNET_TPU_NO_NATIVE_BUILD is set'
    err = _build(out, cmd)
    if err is not None:
        return None, err
    try:
        return _configure(ctypes.CDLL(out)), None
    except OSError as e:
        return None, f'cannot load {out} as built: {e}'


def get_lib():
    """The native IO library, loaded or built at first use, or None (the
    pure-Python path: no route built, or ``MXNET_TPU_NO_NATIVE_BUILD``
    forbids a build and no loadable library is built yet)."""
    global _lib, _lib_tried, _error, _route
    with _lock:
        if _lib_tried:
            return _lib
        _lib_tried = True
        errors = []
        for route, cmd in _routes():
            lib, err = _load(route, cmd)
            if lib is not None:
                if errors:
                    _log.info("libjpeg route 'system' failed (%s); linked "
                              "%s", errors[0].strip().splitlines()[-1],
                              route)
                _lib, _route, _error = lib, route, None
                _log.info('loaded the native IO runtime %s (libjpeg: %s)',
                          lib_path(route), route)
                return _lib
            errors.append(err)
        if len(errors) == 1:
            errors.append('(and no libjpeg bundled with Pillow)')
        _error = '\n'.join(errors)
        _log.warning('native IO runtime build failed; the pure-Python '
                     'decode path is used. %s', _error)
        return None


def native_available():
    return get_lib() is not None


def build_error():
    """Why ``get_lib()`` returned None (the compiler's stderr, the knob,
    the loader's error), or None."""
    return _error
