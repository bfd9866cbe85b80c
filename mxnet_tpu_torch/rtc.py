"""mx.rtc: user CUDA kernels compiled at run time by NVRTC (counterpart of
``mxnet_tpu/rtc.py``; ref: python/mxnet/rtc.py and src/common/rtc.cc).

The JAX package's user-kernel path is ``pallas_op``/``PallasKernel``
(``mxnet_tpu/rtc.py:32-97``): a user's Pallas kernel as an eager op over
NDArrays. On the card its counterpart is MXNet's own API, kept here:

    mod = mx.rtc.CudaModule(r'''
    extern "C" __global__ void axpy(const float *x, float *y, float a, int n)
    { int i = blockIdx.x * blockDim.x + threadIdx.x; if (i < n) y[i] += a * x[i]; }''')
    k = mod.get_kernel('axpy', 'const float *x, float *y, float a, int n')
    k.launch([x, y, 2.0, x.size], mx.gpu(0), ((x.size + 255) // 256, 1, 1),
             (256, 1, 1))

``CudaModule`` compiles with NVRTC for the card's architecture (``sm_90a``
on an H100), with ``-I`` the CUDA include directory so a source may
include ``cuda_fp16.h``/``cuda_bf16.h``, takes the CUBIN (not PTX, which
can be newer than the CUDA driver's JIT accepts) and loads it with the driver
API on each device at first use. It compiles in memory and writes nothing
to disk. Both libraries are bound with ctypes (``libnvrtc.so.12``, as
torch's wheel or the toolkit has it, and ``libcuda.so.1``); ``argtypes``
are set on every function. The source declares its own integer types
(``uint8_t``, ``int64_t`` ...) where it uses them.

``CudaKernel.launch`` checks everything before it launches and raises
``MXNetError``: the argument count, NDArray versus number, each array's
dtype against the signature, that ``ctx`` is a card and that every array
is on it. It launches on ``torch.cuda.current_stream``, with the device's
primary context made current in the calling thread, and counts the
launch in ``launch_counts``. A launch is outside the autograd tape, as in
MXNet; differentiate through ``autograd.Function``.

Value semantics: each non-const array argument is first copied into a
fresh contiguous tensor, the kernel writes there, and the NDArray is then
rebound to it. So a launch changes no other NDArray (even one that
shares storage with an argument, as ``b = a.reshape(...)`` does), never
hands a strided view to a kernel that expects a dense array, and never
writes into a tensor that a recorded graph saved. The cost is one copy of
each output array per launch. Const arrays are passed as they are when
contiguous, else as a contiguous copy.

``pallas_op`` raises with guidance to use ``CudaModule``: the mirror of
the JAX package's ``CudaModule``.
"""
from __future__ import annotations

import ctypes
import hashlib
import numbers
import os
import re
import threading
import time
from typing import NamedTuple

import torch

from .base import MXNetError
from .telemetry import compile as _compile
from .ndarray.ndarray import NDArray

__all__ = ['CudaModule', 'CudaKernel', 'pallas_op', 'parse_signature',
           'launch_counts', 'reset_launch_counts']

# kernel argument types (ref: python/mxnet/rtc.py _DTYPE_CPP_TO_NP)
_DTYPE_CPP = {
    'float': torch.float32, 'double': torch.float64,
    '__half': torch.float16, '__nv_bfloat16': torch.bfloat16,
    'uint8_t': torch.uint8, 'int': torch.int32, 'int32_t': torch.int32,
    'int8_t': torch.int8, 'char': torch.int8, 'int64_t': torch.int64,
}
_SCALAR_CTYPE = {
    torch.float32: ctypes.c_float, torch.float64: ctypes.c_double,
    torch.uint8: ctypes.c_uint8, torch.int32: ctypes.c_int32,
    torch.int8: ctypes.c_int8, torch.int64: ctypes.c_int64,
}
_ARG = re.compile(r'^\s*(const\s+)?(\w+)\s*(\*)?\s*(\w+)?\s*$')
_MAX_STATIC_SMEM = 48 * 1024
_CU_FUNC_ATTRIBUTE_MAX_DYNAMIC_SHARED_SIZE_BYTES = 8

launch_counts = {}


def reset_launch_counts():
    for k in launch_counts:
        launch_counts[k] = 0


class KernelArg(NamedTuple):
    is_const: bool
    dtype: torch.dtype
    is_array: bool
    name: str


def parse_signature(signature):
    """``'const float *x, float *y, int n'`` -> one KernelArg per
    argument, as MXNet parses it: ``*`` marks an array, ``const`` an
    input, names are optional."""
    if not signature.strip():
        return []
    args = []
    for arg in re.sub(r'\s+', ' ', signature).split(','):
        m = _ARG.match(arg)
        if not m or m.group(2) == 'const':
            raise MXNetError(f'invalid kernel argument "{arg.strip()}": the '
                             f'form is "(const) type (*) (name)"')
        if m.group(2) not in _DTYPE_CPP:
            raise MXNetError(f'unsupported kernel argument type '
                             f'"{arg.strip()}"; supported: '
                             f'{", ".join(_DTYPE_CPP)}')
        args.append(KernelArg(bool(m.group(1)), _DTYPE_CPP[m.group(2)],
                              bool(m.group(3)), m.group(4) or ''))
    return args


# ---- the two libraries, bound at first use --------------------------------

_lock = threading.Lock()
_lib = {}
_primary = {}       # device index -> its primary CUcontext


def _bind(lib, name, restype, *argtypes):
    fn = getattr(lib, name)
    fn.restype = restype
    fn.argtypes = list(argtypes)


def _load_nvrtc():
    from torch.utils.cpp_extension import CUDA_HOME
    major = (torch.version.cuda or '12').split('.')[0]
    names = [f'libnvrtc.so.{major}', 'libnvrtc.so']
    dirs = [os.path.join(os.path.dirname(torch.__file__), os.pardir,
                         'nvidia', 'cuda_nvrtc', 'lib')]
    if CUDA_HOME:
        dirs.append(os.path.join(CUDA_HOME, 'lib64'))
    for cand in names + [os.path.join(d, n) for d in dirs for n in names]:
        try:
            return ctypes.CDLL(cand)
        except OSError:
            continue
    raise MXNetError("NVRTC (libnvrtc.so) not found: mx.rtc needs the CUDA "
                     "runtime compiler")


def _libs():
    """(nvrtc, cuda): both libraries with their signatures set."""
    with _lock:
        if _lib:
            return _lib['nvrtc'], _lib['cuda']
        nv = _load_nvrtc()
        P, S, I, V = (ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int,
                      ctypes.POINTER(ctypes.c_size_t))
        PP = ctypes.POINTER(ctypes.c_void_p)
        SS = ctypes.POINTER(ctypes.c_char_p)
        _bind(nv, 'nvrtcCreateProgram', I, PP, S, S, I, SS, SS)
        _bind(nv, 'nvrtcAddNameExpression', I, P, S)
        _bind(nv, 'nvrtcCompileProgram', I, P, I, SS)
        _bind(nv, 'nvrtcGetProgramLogSize', I, P, V)
        _bind(nv, 'nvrtcGetProgramLog', I, P, ctypes.c_char_p)
        _bind(nv, 'nvrtcGetCUBINSize', I, P, V)
        _bind(nv, 'nvrtcGetCUBIN', I, P, ctypes.c_char_p)
        _bind(nv, 'nvrtcGetLoweredName', I, P, S, SS)
        _bind(nv, 'nvrtcDestroyProgram', I, PP)
        _bind(nv, 'nvrtcGetErrorString', S, I)
        try:
            cu = ctypes.CDLL('libcuda.so.1')
        except OSError as e:
            raise MXNetError(f"the CUDA driver (libcuda.so.1) is not "
                             f"loadable: {e}") from e
        U = ctypes.c_uint
        _bind(cu, 'cuInit', I, U)
        _bind(cu, 'cuDeviceGet', I, ctypes.POINTER(ctypes.c_int), I)
        _bind(cu, 'cuDevicePrimaryCtxRetain', I, PP, I)
        _bind(cu, 'cuCtxGetCurrent', I, PP)
        _bind(cu, 'cuCtxSetCurrent', I, P)
        _bind(cu, 'cuModuleLoadData', I, PP, P)
        _bind(cu, 'cuModuleGetFunction', I, PP, P, S)
        _bind(cu, 'cuFuncSetAttribute', I, P, I, I)
        _bind(cu, 'cuLaunchKernel', I, P, U, U, U, U, U, U, U, P, PP, PP)
        _bind(cu, 'cuGetErrorString', I, I, SS)
        _lib['nvrtc'], _lib['cuda'] = nv, cu
        return nv, cu


def _nvrtc_check(rc, what):
    if rc != 0:
        nv = _lib['nvrtc']
        raise MXNetError(f"{what}: {nv.nvrtcGetErrorString(rc).decode()}")


def _cu_check(rc, what):
    if rc != 0:
        cu = _lib['cuda']
        msg = ctypes.c_char_p()
        cu.cuGetErrorString(rc, ctypes.byref(msg))
        raise MXNetError(f"{what}: CUresult {rc} "
                         f"({(msg.value or b'unknown').decode()})")


def _make_current(dev):
    """Make device ``dev``'s primary context (the one torch uses) current
    in the calling thread."""
    _, cu = _libs()
    ctx = _primary.get(dev)
    if ctx is None:
        with _lock:
            ctx = _primary.get(dev)
            if ctx is None:
                _cu_check(cu.cuInit(0), 'cuInit')
                handle = ctypes.c_int()
                _cu_check(cu.cuDeviceGet(ctypes.byref(handle), dev),
                          'cuDeviceGet')
                ctx = ctypes.c_void_p()
                _cu_check(cu.cuDevicePrimaryCtxRetain(ctypes.byref(ctx),
                                                      handle.value),
                          'cuDevicePrimaryCtxRetain')
                _primary[dev] = ctx
    cur = ctypes.c_void_p()
    _cu_check(cu.cuCtxGetCurrent(ctypes.byref(cur)), 'cuCtxGetCurrent')
    if cur.value != ctx.value:
        _cu_check(cu.cuCtxSetCurrent(ctx), 'cuCtxSetCurrent')


def _cuda_include_dirs():
    from torch.utils.cpp_extension import CUDA_HOME
    dirs = []
    if CUDA_HOME:
        dirs.append(os.path.join(CUDA_HOME, 'include'))
    nv = os.path.join(os.path.dirname(torch.__file__), os.pardir, 'nvidia')
    for sub in ('cuda_runtime', 'cuda_nvrtc'):
        dirs.append(os.path.join(nv, sub, 'include'))
    return [d for d in dirs if os.path.isdir(d)]


def _arch(dev):
    major, minor = torch.cuda.get_device_capability(dev)
    # the 'a' target enables Hopper's wgmma and setmaxnreg
    return 'sm_90a' if (major, minor) == (9, 0) else f'sm_{major}{minor}'


class CudaModule:
    """A CUDA C++ source compiled by NVRTC (ref: python/mxnet/rtc.py
    CudaModule).

    ``options`` are NVRTC options added after the port's own
    (``--gpu-architecture``, ``-I`` the CUDA include directories,
    ``--std=c++17``). ``exports`` names templated or ``__global__``
    functions without ``extern "C"`` (e.g. ``'axpy<float>'``);
    ``get_kernel`` finds them by that name. Needs a card: without one it
    raises ``MXNetError``. A failed compile raises ``MXNetError`` with
    NVRTC's log. The compile's seconds go to the compile ledger
    (``telemetry.compile``) as a ``build`` phase.
    """

    def __init__(self, source, options=(), exports=()):
        if not torch.cuda.is_available():
            raise MXNetError("mx.rtc.CudaModule compiles for a CUDA card and "
                             "no CUDA device is available")
        if isinstance(options, str):
            options = (options,)
        if isinstance(exports, str):
            exports = (exports,)
        nv, _ = _libs()
        t0 = time.perf_counter()
        dev = torch.cuda.current_device()
        opts = ([f'--gpu-architecture={_arch(dev)}', '--std=c++17'] +
                [f'-I{d}' for d in _cuda_include_dirs()] + list(options))
        prog = ctypes.c_void_p()
        _nvrtc_check(nv.nvrtcCreateProgram(
            ctypes.byref(prog), source.encode(), b'mx_rtc.cu', 0, None,
            None), 'nvrtcCreateProgram')
        try:
            for name in exports:
                _nvrtc_check(nv.nvrtcAddNameExpression(prog, name.encode()),
                             f'nvrtcAddNameExpression({name})')
            c_opts = (ctypes.c_char_p * len(opts))(
                *[o.encode() for o in opts])
            rc = nv.nvrtcCompileProgram(prog, len(opts), c_opts)
            size = ctypes.c_size_t()
            nv.nvrtcGetProgramLogSize(prog, ctypes.byref(size))
            log = ctypes.create_string_buffer(size.value)
            nv.nvrtcGetProgramLog(prog, log)
            self.log = log.value.decode(errors='replace')
            if rc != 0:
                raise MXNetError(f"NVRTC failed to compile the module "
                                 f"({nv.nvrtcGetErrorString(rc).decode()}):"
                                 f"\n{self.log}")
            _nvrtc_check(nv.nvrtcGetCUBINSize(prog, ctypes.byref(size)),
                         'nvrtcGetCUBINSize')
            cubin = ctypes.create_string_buffer(size.value)
            _nvrtc_check(nv.nvrtcGetCUBIN(prog, cubin), 'nvrtcGetCUBIN')
            self._cubin = cubin.raw
            self._lowered = {}
            for name in exports:
                low = ctypes.c_char_p()
                _nvrtc_check(nv.nvrtcGetLoweredName(
                    prog, name.encode(), ctypes.byref(low)),
                    f'nvrtcGetLoweredName({name})')
                self._lowered[name] = low.value.decode()
        finally:
            nv.nvrtcDestroyProgram(ctypes.byref(prog))
        self.options = tuple(opts)
        _compile.report('build', time.perf_counter() - t0,
                        'rtc:' + (','.join(exports) or 'module'),
                        lambda: _compile.signature(flags={
                            'options': ' '.join(opts),
                            'source_sha1': hashlib.sha1(
                                source.encode()).hexdigest()[:16]}))
        self._modules = {}
        self._mod_lock = threading.Lock()

    def _module(self, dev):
        """The CUmodule on device ``dev``, loaded at first use."""
        with self._mod_lock:
            mod = self._modules.get(dev)
            if mod is None:
                _, cu = _libs()
                _make_current(dev)
                mod = ctypes.c_void_p()
                _cu_check(cu.cuModuleLoadData(ctypes.byref(mod), self._cubin),
                          'cuModuleLoadData')
                self._modules[dev] = mod
            return mod

    def _function(self, name, dev):
        _, cu = _libs()
        fn = ctypes.c_void_p()
        mod = self._module(dev)
        _make_current(dev)
        rc = cu.cuModuleGetFunction(ctypes.byref(fn), mod,
                                    self._lowered.get(name, name).encode())
        if rc != 0:
            raise MXNetError(f"kernel {name!r} not found in the module (a "
                             f"function without extern \"C\" must be listed "
                             f"in exports): CUresult {rc}")
        return fn

    def get_kernel(self, name, signature):
        """The kernel ``name`` with its argument list as in its source
        (``'const float *x, float *y, int n'``)."""
        args = parse_signature(signature)
        kernel = CudaKernel(self, name, args)
        kernel._fn(torch.cuda.current_device())   # fail now on a bad name
        return kernel


class CudaKernel:
    """One kernel of a CudaModule (ref: python/mxnet/rtc.py CudaKernel)."""

    def __init__(self, module, name, args):
        self._module = module
        self.name = name
        self._args = list(args)
        self._fns = {}
        self._smem_set = {}
        launch_counts.setdefault(name, 0)

    def _fn(self, dev):
        fn = self._fns.get(dev)
        if fn is None:
            fn = self._fns[dev] = self._module._function(self.name, dev)
        return fn

    def _check(self, args, ctx, grid_dims, block_dims):
        """Every check of a launch, before anything is launched; returns
        the torch device."""
        if len(args) != len(self._args):
            raise MXNetError(f"{self.name}: {len(args)} arguments for a "
                             f"kernel of {len(self._args)}")
        if len(grid_dims) != 3 or len(block_dims) != 3:
            raise MXNetError(f"{self.name}: grid_dims and block_dims take "
                             f"three values each")
        for i, (a, spec) in enumerate(zip(args, self._args)):
            if spec.is_array:
                if not isinstance(a, NDArray):
                    raise MXNetError(f"{self.name}: argument {i} is an "
                                     f"array, got {type(a).__name__}")
                if a._data.dtype != spec.dtype:
                    raise MXNetError(f"{self.name}: argument {i} must be "
                                     f"{spec.dtype}, got {a._data.dtype}")
            elif isinstance(a, NDArray) or not isinstance(a, numbers.Number):
                raise MXNetError(f"{self.name}: argument {i} is a number, "
                                 f"got {type(a).__name__}")
        if ctx.device_type not in ('gpu', 'tpu'):
            raise MXNetError(f"{self.name}: a CUDA kernel launches on a GPU "
                             f"context, not {ctx}")
        device = ctx.device
        for i, (a, spec) in enumerate(zip(args, self._args)):
            if spec.is_array and a._data.device != device:
                raise MXNetError(f"{self.name}: argument {i} is on "
                                 f"{a.context}, the launch on {ctx}")
        return device

    def launch(self, args, ctx, grid_dims, block_dims, shared_mem=0):
        """Launch on ``ctx``'s current stream (ref: CudaKernel.launch)."""
        device = self._check(args, ctx, grid_dims, block_dims)
        dev = device.index or 0
        keep, rebind, params = [], [], []
        for a, spec in zip(args, self._args):
            if spec.is_array:
                t = a._data.detach()
                t = t.contiguous() if spec.is_const else \
                    t.clone(memory_format=torch.contiguous_format)
                if not spec.is_const:
                    rebind.append((a, t))
                keep.append(t)
                params.append(ctypes.c_void_p(t.data_ptr()))
            elif spec.dtype in (torch.float16, torch.bfloat16):
                bits = torch.tensor(a, dtype=spec.dtype).view(torch.int16)
                params.append(ctypes.c_uint16(int(bits) & 0xFFFF))
            else:
                params.append(_SCALAR_CTYPE[spec.dtype](a))
        ptrs = (ctypes.c_void_p * len(params))(
            *[ctypes.addressof(p) for p in params])
        fn = self._fn(dev)
        _, cu = _libs()
        _make_current(dev)
        if shared_mem > _MAX_STATIC_SMEM and \
                self._smem_set.get(dev, 0) < shared_mem:
            _cu_check(cu.cuFuncSetAttribute(
                fn, _CU_FUNC_ATTRIBUTE_MAX_DYNAMIC_SHARED_SIZE_BYTES,
                int(shared_mem)), f'{self.name}: cuFuncSetAttribute')
            self._smem_set[dev] = shared_mem
        stream = torch.cuda.current_stream(device).cuda_stream
        _cu_check(cu.cuLaunchKernel(
            fn, *[int(g) for g in grid_dims], *[int(b) for b in block_dims],
            int(shared_mem), stream, ptrs, None), f'{self.name}: launch')
        launch_counts[self.name] = launch_counts.get(self.name, 0) + 1
        for a, t in rebind:
            a._data = t


def pallas_op(*args, **kwargs):
    """Not available on the card: the mirror of the JAX package's
    ``CudaModule``, which raises there."""
    raise MXNetError(
        "Pallas kernels run on the TPU backend only; on the card write the "
        "kernel in CUDA C++ and compile it with mxnet_tpu_torch.rtc."
        "CudaModule (get_kernel + CudaKernel.launch)")
