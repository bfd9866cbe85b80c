"""The ``nd`` namespace: NDArray plus every registered op as a function
(counterpart of ``mxnet_tpu/ndarray/__init__.py``, ref:
python/mxnet/ndarray/__init__.py).

``nd.contrib`` holds the control-flow operators and the contrib and
attention ops; ``nd.Custom`` is ``operator.register``'s custom op.
``nd.sparse``, ``nd.linalg`` and ``nd.random`` are not ported yet.
"""
from .ndarray import (NDArray, array, zeros, ones, full, arange, empty,
                      concat, stack, save, load, load_frombuffer,
                      imperative_invoke, waitall, from_numpy, from_dlpack,
                      to_dlpack_for_read, _invoke, _wrap)
from . import register as _register
from .utils import split_data, split_and_load  # noqa: F401
from . import contrib  # noqa: F401

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
