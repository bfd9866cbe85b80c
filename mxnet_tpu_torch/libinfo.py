"""Version and build information (counterpart of ``mxnet_tpu/libinfo.py``,
ref: python/mxnet/libinfo.py).

``find_lib_path()`` lists the native libraries the port has built in its
build directory (``build/mxnet_tpu_torch/`` at the root of the checkout,
``MXTPU_COMPILE_CACHE_DIR`` where set): the CUDA kernels
(``ops/_build.py``), the native IO runtime (``_native.py``), the op
libraries built by ``library.build`` and the C ABIs (``_capi.py``). Each
is built at first use, so the list holds what this checkout has built so
far. ``find_include_path()`` is the port's ``csrc/``, where its C headers
are (``lib_api/mxtpu_lib_api.h`` for op libraries, ``embed/`` for the
predict and training ABIs).
"""
from __future__ import annotations

import os

from .telemetry import compile as _compile

__all__ = ['find_lib_path', 'find_include_path', '__version__']

# the JAX package's version string: a version check written against
# either package reads alike
__version__ = '2.0.0.tpu'


def find_lib_path():
    """The built libraries (``*.so``) in the build directory, sorted."""
    libdir = _compile.cache_dir()
    if not os.path.isdir(libdir):
        return []
    return sorted(os.path.join(libdir, f) for f in os.listdir(libdir)
                  if f.endswith('.so'))


def find_include_path():
    """The directory of the C headers: the package's ``csrc/``."""
    return os.path.join(os.path.dirname(os.path.abspath(__file__)), 'csrc')
