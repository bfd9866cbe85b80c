"""The ``nd`` namespace: NDArray plus every registered op as a function
(counterpart of ``mxnet_tpu/ndarray/__init__.py``, ref:
python/mxnet/ndarray/__init__.py).

``nd.sparse``, ``nd.linalg``, ``nd.random`` and ``nd.contrib`` are not
ported yet.
"""
from .ndarray import (NDArray, array, zeros, ones, full, arange, empty,
                      concat, stack, save, load, load_frombuffer,
                      imperative_invoke, waitall, from_numpy, from_dlpack,
                      to_dlpack_for_read, _invoke, _wrap)
from . import register as _register

# op wrappers from the registry; the creation ops keep their ctx-aware
# front-ends above
_register.populate(globals(), skip=('zeros', 'ones', 'full', 'arange',
                                    'concat', 'stack'))


def __getattr__(name):
    """Late-bound wrappers for ops registered after import; the wrapper
    resolves the op by name at every call."""
    from ..base import _OP_REGISTRY
    if name not in _OP_REGISTRY:
        raise AttributeError(f"module 'mxnet_tpu_torch.ndarray' has no "
                             f"attribute {name!r}")

    def wrapper(*args, **kwargs):
        kwargs.pop('out', None)
        kwargs.pop('name', None)
        return imperative_invoke(name, *args, **kwargs)

    wrapper.__name__ = wrapper.__qualname__ = name
    globals()[name] = wrapper
    return wrapper
