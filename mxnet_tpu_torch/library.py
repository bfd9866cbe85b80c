"""Operator libraries loaded at run time (counterpart of
``mxnet_tpu/library.py``, ref: python/mxnet/library.py MXLoadLib,
include/mxnet/lib_api.h:626).

``load(path)`` dlopens a shared object built against
``csrc/lib_api/mxtpu_lib_api.h`` (a plain C ABI, no framework headers;
the port's copy of the JAX package's header, declaration for declaration),
lists the ops it provides and registers each one in the port's registry,
so ``mx.nd.<name>``, ``mx.sym.<name>`` and ``F.<name>`` in a
``hybrid_forward`` reach it. ``loaded_libraries()`` lists them.

The library's compute runs on the host, as in the JAX package (there a
``jax.pure_callback``). For tensors on the card the inputs go device to
host and the outputs come back on the current stream, each copy
synchronous, so the op's result is ready when it returns. Such an op
cannot enter a CUDA graph: a hybridized block that calls it runs eagerly
on the card (``gluon.block.CachedOp.num_eager`` counts those keys;
``_capture.host_call``).

``build(source)`` compiles a library's C++ source with ``g++`` into the
port's build directory (``build/mxnet_tpu_torch/`` at the root of the
checkout, ``MXTPU_COMPILE_CACHE_DIR`` where set), named by a hash of the
source, the ABI header and the flags, at first use
(``ops._build.Compile``); a failed build raises with the compiler's
output. ``example_library()`` builds and returns
``csrc/lib_api/example_lib.cc``'s (``my_relu``, ``my_gemm``,
``my_split2``). Nothing is written beside the sources.
"""
from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import threading
import time

import numpy as onp
import torch

from ._capture import host_call
from .base import MXNetError, register_op
from .telemetry import compile as _compile

__all__ = ['load', 'loaded_libraries', 'build', 'example_library',
           'EXAMPLE_SOURCE', 'CXX_FLAGS']

INCLUDE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           'csrc', 'lib_api')
EXAMPLE_SOURCE = os.path.join(INCLUDE_DIR, 'example_lib.cc')
CXX_FLAGS = ['-O3', '-std=c++17', '-fPIC', '-Wall', '-pthread', '-shared']

_MAX_NDIM = 8

# dtype code <-> numpy (the reference's mshadow type flags)
_DTYPE_TO_NP = {0: onp.float32, 1: onp.float64, 2: onp.float16,
                3: onp.uint8, 4: onp.int32, 5: onp.int8, 6: onp.int64}
_NP_TO_DTYPE = {onp.dtype(v): k for k, v in _DTYPE_TO_NP.items()}

_lock = threading.Lock()
_loaded = {}


class _MXTPUTensor(ctypes.Structure):
    _fields_ = [('data', ctypes.c_void_p),
                ('shape', ctypes.c_int64 * _MAX_NDIM),
                ('ndim', ctypes.c_int32),
                ('dtype', ctypes.c_int32)]


def _fill_tensor(t, arr=None, shape=None, dtype=None):
    if arr is not None:
        shape, dtype = arr.shape, arr.dtype
        t.data = arr.ctypes.data_as(ctypes.c_void_p)
    else:
        t.data = None
    if len(shape) > _MAX_NDIM:
        raise MXNetError(f"external op tensors support <= {_MAX_NDIM} dims")
    t.ndim = len(shape)
    for i, s in enumerate(shape):
        t.shape[i] = int(s)
    code = _NP_TO_DTYPE.get(onp.dtype(dtype))
    if code is None:
        raise MXNetError(f"external op: unsupported dtype {dtype}")
    t.dtype = code


class _ExternalLibrary:
    """One loaded library and the ops it registered."""

    def __init__(self, path):
        self.path = os.path.abspath(path)
        try:
            self._lib = ctypes.CDLL(self.path)
        except OSError as e:
            raise MXNetError(f"{path}: cannot load: {e}") from e
        for sym, res in [('MXTPULibVersion', ctypes.c_int),
                         ('MXTPULibOpCount', ctypes.c_int),
                         ('MXTPULibOpName', ctypes.c_char_p),
                         ('MXTPULibOpNumOutputs', ctypes.c_int),
                         ('MXTPULibOpInferShape', ctypes.c_int),
                         ('MXTPULibOpCompute', ctypes.c_int)]:
            try:
                getattr(self._lib, sym).restype = res
            except AttributeError:
                raise MXNetError(
                    f"{path}: not an MXTPU op library (missing {sym})")
        ptr = ctypes.POINTER(_MXTPUTensor)
        for sym in ('MXTPULibOpInferShape', 'MXTPULibOpCompute'):
            getattr(self._lib, sym).argtypes = [
                ctypes.c_int, ptr, ctypes.c_int, ptr, ctypes.c_int]
        self._lib.MXTPULibOpName.argtypes = [ctypes.c_int]
        self._lib.MXTPULibOpNumOutputs.argtypes = [ctypes.c_int]
        try:
            self._lib.MXTPULibLastError.restype = ctypes.c_char_p
            self._has_err = True
        except AttributeError:
            self._has_err = False
        ver = self._lib.MXTPULibVersion()
        if ver != 1:
            raise MXNetError(
                f"{path}: ABI version {ver} unsupported (expected 1)")
        self.op_names = []
        for idx in range(self._lib.MXTPULibOpCount()):
            name = self._lib.MXTPULibOpName(idx).decode()
            n_out = self._lib.MXTPULibOpNumOutputs(idx)
            self._register(idx, name, n_out)
            self.op_names.append(name)

    def _error(self, what):
        msg = ''
        if self._has_err:
            raw = self._lib.MXTPULibLastError()
            msg = raw.decode() if raw else ''
        return MXNetError(f"{os.path.basename(self.path)}: {what}: {msg}")

    def _infer(self, idx, shapes, dtypes, n_out):
        n_in = len(shapes)
        ins = (_MXTPUTensor * max(n_in, 1))()
        for i, (s, d) in enumerate(zip(shapes, dtypes)):
            _fill_tensor(ins[i], shape=s, dtype=d)
        outs = (_MXTPUTensor * n_out)()
        rc = self._lib.MXTPULibOpInferShape(idx, ins, n_in, outs, n_out)
        if rc != 0:
            raise self._error("infer_shape failed")
        return [(tuple(int(outs[o].shape[i]) for i in range(outs[o].ndim)),
                 _DTYPE_TO_NP[outs[o].dtype]) for o in range(n_out)]

    def _compute(self, idx, arrays, out_specs):
        n_in = len(arrays)
        ins = (_MXTPUTensor * max(n_in, 1))()
        arrays = [onp.ascontiguousarray(a) for a in arrays]
        for i, a in enumerate(arrays):
            _fill_tensor(ins[i], arr=a)
        results = [onp.empty(s, d) for s, d in out_specs]
        outs = (_MXTPUTensor * len(results))()
        for o, r in enumerate(results):
            _fill_tensor(outs[o], arr=r)
        rc = self._lib.MXTPULibOpCompute(idx, ins, n_in, outs, len(results))
        if rc != 0:
            raise self._error("compute failed")
        return results

    def _register(self, idx, name, n_out):
        def op(*args):
            host_call(name)
            tensors = [a if isinstance(a, torch.Tensor) else torch.as_tensor(a)
                       for a in args]
            device = tensors[0].device if tensors else torch.device('cpu')
            bad = [t.dtype for t in tensors if t.dtype == torch.bfloat16]
            if bad:
                raise MXNetError(f"external op {name}: unsupported dtype "
                                 f"{bad[0]}")
            # the copies to the host wait for the current stream
            host = [t.detach().cpu().numpy() for t in tensors]
            specs = self._infer(idx, [h.shape for h in host],
                                [h.dtype for h in host], n_out)
            outs = [torch.from_numpy(r).to(device)
                    for r in self._compute(idx, host, specs)]
            return outs[0] if n_out == 1 else tuple(outs)

        op.__name__ = name
        op.__doc__ = (f"external op '{name}' from "
                      f"{os.path.basename(self.path)} (lib_api), computed "
                      f"on the host")
        register_op(name, num_outputs=n_out, nograd=True)(op)


def load(path, verbose=True):
    """Load an op library (ref: python/mxnet/library.py load); the names
    of the ops it registered. Loading a path again changes nothing."""
    path = os.path.abspath(path)
    if not os.path.exists(path):
        raise MXNetError(f"library {path} not found")
    with _lock:
        if path in _loaded:
            return _loaded[path].op_names
        lib = _ExternalLibrary(path)
        _loaded[path] = lib
    if verbose:
        logging.info("loaded library %s: ops %s", path, lib.op_names)
    return lib.op_names


def loaded_libraries():
    """{path: [op names]} of the libraries loaded in this process."""
    return {p: lib.op_names for p, lib in _loaded.items()}


def build(source, flags=()):
    """The path of ``source``'s op library in the build directory, built
    by ``g++`` (``CXX_FLAGS``, ``flags``, the ABI header's directory on
    the include path) where it is not there yet. A failed build raises
    ``MXNetError`` with the compiler's output."""
    flags = list(flags)
    digest = hashlib.sha1('\n'.join(CXX_FLAGS + flags).encode())
    for p in (source, os.path.join(INCLUDE_DIR, 'mxtpu_lib_api.h')):
        with open(p, 'rb') as f:
            digest.update(f.read())
    stem = os.path.splitext(os.path.basename(source))[0]
    out = os.path.join(_compile.cache_dir(),
                       f'lib{stem}-{digest.hexdigest()[:12]}.so')
    from .ops._build import Compile
    with _lock:
        if os.path.isfile(out):
            _compile.cache_event(hit=True)
            return out
        _compile.cache_event(hit=False)
        t0 = time.perf_counter()
        cmd = ['g++', *CXX_FLAGS, *flags, '-I', INCLUDE_DIR, source]
        err = Compile(out, cmd, timeout=300).wait()
        if err is not None:
            raise MXNetError(f"op library build of {source} failed: {err}")
        _compile.report('build', time.perf_counter() - t0, f'oplib:{stem}',
                        lambda: _compile.signature(
                            [_compile.arg_sig(os.path.basename(source))],
                            {'g++': ' '.join(cmd[1:])}))
    return out


def example_library():
    """``csrc/lib_api/example_lib.cc``'s library, built at first use."""
    return build(EXAMPLE_SOURCE)
