"""The ``nd`` namespace: NDArray plus every registered op as a function
(counterpart of ``mxnet_tpu/ndarray/__init__.py``, ref:
python/mxnet/ndarray/__init__.py).

``nd.contrib`` holds the control-flow operators and the contrib and
attention ops; ``nd.Custom`` is ``operator.register``'s custom op;
``nd.sparse`` the CSR and RowSparse arrays; ``nd.linalg`` the
``linalg_*`` ops under MXNet's short names and ``nd.random`` the
samplers.
"""
from .ndarray import (NDArray, array, zeros, ones, full, arange, empty,
                      concat, stack, save, load, load_frombuffer,
                      imperative_invoke, waitall, from_numpy, from_dlpack,
                      to_dlpack_for_read, _invoke, _wrap)
from . import register as _register
from .utils import split_data, split_and_load  # noqa: F401
from . import contrib  # noqa: F401
from . import sparse  # noqa: F401
from . import random  # noqa: F401
from . import linalg  # noqa: F401

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
        return _register.make_wrapper(_OP_REGISTRY[name])(*args, **kwargs)

    wrapper.__name__ = wrapper.__qualname__ = name
    globals()[name] = wrapper
    return wrapper
