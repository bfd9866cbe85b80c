"""Build and load the port's CUDA kernels.

Each source under ``mxnet_tpu_torch/csrc/`` is compiled by ``nvcc`` for
``sm_90a`` into its own shared library with a plain C interface and
loaded with ``ctypes`` (no PyTorch headers, so a build takes seconds).
Libraries go to ``build/mxnet_tpu_torch/`` at the root of the checkout
(``MXTPU_COMPILE_CACHE_DIR`` where set), named by a hash of their
source, and are built at first use: every source is started at once, one
``nvcc`` each. Nothing is built when this module is imported. Each
library found there counts as a hit of the build directory, each
``nvcc`` run as a miss, and the batch's seconds go to the compile ledger
as a ``build`` phase (``telemetry.compile``); ``triton_first_launch``
does the same for a Triton kernel's JIT compile.

Each C entry point returns ``cudaGetLastError()`` after its launch;
``check`` raises when that is not 0.

``Compile`` is the one compiler run of every native build of the port:
these kernels, the native IO library (``_native.py``) and the op
libraries that ``library.py`` builds: the compiler writes a temporary
name beside the library and the library is moved into place only when
it built, so processes that build at once never load a half-written
file.

``launch_counts`` holds one plain integer per kernel. A wrapper adds one
where it launches its kernel and nowhere else, so a run can show that
its main path went through the kernels. ``variant_counts`` splits the
launches of the kernels that come in several variants: the flash forward,
dq and dk/dv (``'tc'`` on the tensor cores, ``'simt'`` the first design)
and FFN1 (``'tc'`` wgmma + TMA, ``'wmma'`` the first 16-bit design,
``'simt'`` f32). ``dtype_counts`` splits every kernel's launches by the
inputs' dtype (``'flash_attn_fwd.float16'``), ``tile_counts`` the flash
kernels' by tile (``'flash_attn_fwd.64x64'``); ``count_launch`` moves all
of them.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time

from ..base import MXNetError
from ..telemetry import compile as _compile

__all__ = ['launch_counts', 'variant_counts', 'dtype_counts', 'tile_counts',
           'count_launch', 'reset_launch_counts',
           'library', 'build_all', 'ptxas_report', 'check', 'SOURCES',
           'build_dir', 'triton_first_launch', 'Compile']

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, 'csrc')
SOURCES = ('flash_attn_fwd.cu', 'flash_attn_bwd.cu', 'dense_gelu.cu',
           'flash_attn_fwd_tiles.cu', 'flash_attn_dq_tiles.cu',
           'flash_attn_dkv_tiles.cu')
NVCC_FLAGS = ['-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v']

launch_counts = {'flash_attn_fwd': 0, 'flash_attn_bwd_dq': 0,
                 'flash_attn_bwd_dkv': 0, 'fused_add_layernorm': 0,
                 'dense_gelu': 0}
variant_counts = {'flash_attn_fwd.tc': 0, 'flash_attn_fwd.simt': 0,
                  'flash_attn_bwd_dq.tc': 0, 'flash_attn_bwd_dq.simt': 0,
                  'flash_attn_bwd_dkv.tc': 0, 'flash_attn_bwd_dkv.simt': 0,
                  'dense_gelu.tc': 0, 'dense_gelu.wmma': 0,
                  'dense_gelu.simt': 0}
dtype_counts = {}
tile_counts = {}

_lock = threading.Lock()
_libs = {}
_ptxas = {}
_triton_seen = set()


def build_dir():
    """Where libraries are built and looked for:
    ``MXTPU_COMPILE_CACHE_DIR`` where set, else ``build/mxnet_tpu_torch``
    at the root of the checkout (``telemetry.compile.cache_dir``)."""
    return _compile.cache_dir()


class Compile:
    """One compiler run that writes the library ``out``, started at once:
    ``cmd`` (without ``-o``) writes a temporary name beside ``out``.
    ``wait()`` moves the library into place and returns None, or removes
    the temporary file and returns the command with the compiler's output
    (or why it did not start, or ran past ``timeout`` seconds); ``log``
    holds the compiler's output either way."""

    def __init__(self, out, cmd, timeout=None):
        os.makedirs(os.path.dirname(out), exist_ok=True)
        self.out = out
        self.tmp = f'{out}.{os.getpid()}.{threading.get_ident()}.tmp'
        self.cmd = list(cmd) + ['-o', self.tmp]
        self.timeout = timeout
        self.log = ''
        self._error = None
        try:
            self._proc = subprocess.Popen(
                self.cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)
        except OSError as e:
            self._proc = None
            self._error = f'{" ".join(self.cmd)}: {e}'

    def wait(self):
        if self._proc is None:
            return self._error
        try:
            self.log, _ = self._proc.communicate(timeout=self.timeout)
            err = None if self._proc.returncode == 0 else (
                f'{" ".join(self.cmd)} exited {self._proc.returncode}:\n'
                f'{self.log}')
        except subprocess.TimeoutExpired as e:
            self._proc.kill()
            self.log, _ = self._proc.communicate()
            err = f'{" ".join(self.cmd)}: {e}'
        if err is not None:
            try:
                os.unlink(self.tmp)
            except OSError:
                pass
            return err
        os.replace(self.tmp, self.out)
        return None


def reset_launch_counts():
    for counts in (launch_counts, variant_counts):
        for k in counts:
            counts[k] = 0
    dtype_counts.clear()
    tile_counts.clear()


def count_launch(kernel, variant, dtype, tile=None):
    """One launch of ``kernel`` (in ``variant``, for a kernel that has
    variants; at ``tile`` (bq, bk), for a kernel built at several) on
    ``dtype`` inputs."""
    launch_counts[kernel] += 1
    if variant is not None:
        variant_counts[f'{kernel}.{variant}'] += 1
    if tile is not None:
        key = f'{kernel}.{tile[0]}x{tile[1]}'
        tile_counts[key] = tile_counts.get(key, 0) + 1
    key = f'{kernel}.{str(dtype)[len("torch."):]}'
    dtype_counts[key] = dtype_counts.get(key, 0) + 1


def _nvcc():
    from torch.utils.cpp_extension import CUDA_HOME
    cand = [shutil.which('nvcc')]
    if CUDA_HOME:
        cand.append(os.path.join(CUDA_HOME, 'bin', 'nvcc'))
    for c in cand:
        if c and os.path.exists(c):
            return c
    raise MXNetError("nvcc not found: the CUDA kernels are built at first "
                     "use and need the CUDA toolkit")


def _target(src):
    """The library path of one source, named by a hash of the source, the
    shared headers it may include and the flags."""
    digest = hashlib.sha1(' '.join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith('.cuh'))
    for name in [src] + headers:
        with open(os.path.join(CSRC_DIR, name), 'rb') as f:
            digest.update(f.read())
    stem = os.path.splitext(src)[0]
    return os.path.join(build_dir(), f'{stem}-{digest.hexdigest()[:12]}.so')


def build_all():
    """Compile every source whose library is missing, all in parallel,
    and load them. Returns {source: ctypes.CDLL}."""
    with _lock:
        todo = [s for s in SOURCES if s not in _libs]
        if not todo:
            return dict(_libs)
        jobs = {}
        t0 = time.perf_counter()
        for src in todo:
            out = _target(src)
            if os.path.exists(out):
                _compile.cache_event(hit=True)
                continue
            _compile.cache_event(hit=False)
            jobs[src] = Compile(out, [_nvcc(), *NVCC_FLAGS,
                                      os.path.join(CSRC_DIR, src)])
        failed = []
        for src, job in jobs.items():
            err = job.wait()
            _ptxas[src] = job.log
            if err is not None:
                failed.append(f'{src}:\n{err}')
        if failed:
            raise MXNetError('nvcc failed for ' + '\n'.join(failed))
        if jobs:
            built = sorted(jobs)
            _compile.report('build', time.perf_counter() - t0,
                            'kernel:' + ','.join(built),
                            lambda: _compile.signature(
                                [_compile.arg_sig(s) for s in built],
                                {'nvcc': ' '.join(NVCC_FLAGS)}))
        for src in todo:
            _libs[src] = ctypes.CDLL(_target(src))
        return dict(_libs)


def triton_first_launch(name, key, launch):
    """Run ``launch()``; the first time ``(name, key)`` is seen (``key``
    the arguments Triton specializes a kernel on), its seconds, Triton's
    JIT compile included, go to the compile ledger as a ``build``
    phase."""
    if (name, key) in _triton_seen:
        return launch()
    t0 = time.perf_counter()
    out = launch()
    _triton_seen.add((name, key))
    _compile.report('build', time.perf_counter() - t0, f'kernel:{name}',
                    lambda: _compile.signature(flags={'triton': repr(key)}))
    return out


def library(src):
    """The loaded library of one source, built on first use."""
    lib = _libs.get(src)
    return lib if lib is not None else build_all()[src]


def _template_args(mangled, i):
    """The mangled template arguments from ``mangled[i]`` (just past the
    'I') up to their closing 'E', as one string ('13__nv_bfloat16Li64ELi64E'),
    or None."""
    start = i
    while i < len(mangled):
        c = mangled[i]
        if c == 'E':
            return mangled[start:i]
        if c == 'L':                        # a literal: L<type><value>E
            end = mangled.find('E', i)
            if end < 0:
                return None
            i = end + 1
        elif c.isdigit():                   # a length-prefixed name
            m = re.match(r'\d+', mangled[i:])
            i += len(m.group()) + int(m.group())
        else:                               # a builtin type code
            i += 1
    return None


def _kernel_name(mangled):
    """'..._829481d916flash_fwd_kernelI13__nv_bfloat16Li64EE...' ->
    'flash_fwd_kernel<13__nv_bfloat16Li64E>': the length-prefixed name
    that ends in '_kernel', with its template arguments as mangled (a
    tiled kernel's tile too: 'flash_fwd_tc_kernel<13__nv_bfloat16Li64ELi128ELi64E>'
    is D = 64, BQ = 128, BK = 64)."""
    for m in re.finditer(r'\d+', mangled):
        digits, start = m.group(), m.end()
        for i in range(len(digits)):
            n = int(digits[i:])
            name = mangled[start:start + n]
            if len(name) == n and name.endswith('_kernel'):
                rest = start + n
                args = _template_args(mangled, rest + 1) \
                    if mangled[rest:rest + 1] == 'I' else None
                return name + (f'<{args}>' if args else '')
    return mangled


def ptxas_report():
    """One entry per kernel from ``-Xptxas -v``: registers, shared memory
    and spill bytes (empty for libraries loaded from an earlier build)."""
    entries = []
    for src, log in sorted(_ptxas.items()):
        fn, spill = None, ''
        for ln in log.splitlines():
            if 'Compiling entry function' in ln:
                fn = _kernel_name(ln.split("'")[1] if "'" in ln else ln)
            elif 'bytes stack frame' in ln:
                spill = ln.strip()
            elif 'Used' in ln and 'registers' in ln and fn is not None:
                used = ln.split(':', 1)[-1].strip()
                entries.append(f'{src} {fn}: {used}; {spill}')
    return entries


def check(rc, what):
    if rc != 0:
        raise MXNetError(f"{what}: CUDA error {rc} at launch")
