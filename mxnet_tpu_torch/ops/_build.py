"""Build and load the port's CUDA kernels.

Each source under ``mxnet_tpu_torch/csrc/`` is compiled by ``nvcc`` for
``sm_90a`` into its own shared library with a plain C interface and
loaded with ``ctypes`` (no PyTorch headers, so a build takes seconds).
Libraries go to ``build/mxnet_tpu_torch/`` at the root of the checkout,
named by a hash of their source, and are built at first use: every
source is started at once, one ``nvcc`` each. Nothing is built when this
module is imported.

Each C entry point returns ``cudaGetLastError()`` after its launch;
``check`` raises when that is not 0.

``launch_counts`` holds one plain integer per kernel. A wrapper adds one
where it launches its kernel and nowhere else, so a run can show that
its main path went through the kernels.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading

from ..base import MXNetError

__all__ = ['launch_counts', 'reset_launch_counts', 'library', 'build_all',
           'ptxas_report', 'check', 'SOURCES', 'BUILD_DIR']

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, 'csrc')
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), 'build',
                         'mxnet_tpu_torch')
SOURCES = ('flash_attn_fwd.cu', 'flash_attn_bwd.cu', 'dense_gelu.cu')
NVCC_FLAGS = ['-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v']

launch_counts = {'flash_attn_fwd': 0, 'flash_attn_bwd_dq': 0,
                 'flash_attn_bwd_dkv': 0, 'fused_add_layernorm': 0,
                 'dense_gelu': 0}

_lock = threading.Lock()
_libs = {}
_ptxas = {}


def reset_launch_counts():
    for k in launch_counts:
        launch_counts[k] = 0


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
    return os.path.join(BUILD_DIR, f'{stem}-{digest.hexdigest()[:12]}.so')


def build_all():
    """Compile every source whose library is missing, all in parallel,
    and load them. Returns {source: ctypes.CDLL}."""
    with _lock:
        todo = [s for s in SOURCES if s not in _libs]
        if not todo:
            return dict(_libs)
        os.makedirs(BUILD_DIR, exist_ok=True)
        procs = {}
        for src in todo:
            out = _target(src)
            if os.path.exists(out):
                continue
            tmp = f'{out}.{os.getpid()}.tmp'
            procs[src] = (subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, '-o', tmp,
                 os.path.join(CSRC_DIR, src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), tmp, out)
        failed = []
        for src, (proc, tmp, out) in procs.items():
            log, _ = proc.communicate()
            _ptxas[src] = log
            if proc.returncode != 0:
                failed.append(f'{src}:\n{log}')
                continue
            os.replace(tmp, out)
        if failed:
            raise MXNetError('nvcc failed for ' + '\n'.join(failed))
        for src in todo:
            _libs[src] = ctypes.CDLL(_target(src))
        return dict(_libs)


def library(src):
    """The loaded library of one source, built on first use."""
    lib = _libs.get(src)
    return lib if lib is not None else build_all()[src]


def _kernel_name(mangled):
    """'..._829481d916flash_fwd_kernelI13__nv_bfloat16Li64EE...' ->
    'flash_fwd_kernel<13__nv_bfloat16Li64>': the length-prefixed name
    that ends in '_kernel', with its template arguments as mangled."""
    for m in re.finditer(r'\d+', mangled):
        digits, start = m.group(), m.end()
        for i in range(len(digits)):
            n = int(digits[i:])
            name = mangled[start:start + n]
            if len(name) == n and name.endswith('_kernel'):
                t = re.match(r'I(.*?)E', mangled[start + n:])
                return name + (f'<{t.group(1)}>' if t else '')
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
