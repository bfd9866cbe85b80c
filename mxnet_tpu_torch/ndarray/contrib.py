"""``mx.nd.contrib`` (counterpart of ``mxnet_tpu/ndarray/contrib.py``,
ref: python/mxnet/ndarray/contrib.py): the control-flow operators
``foreach``, ``while_loop`` and ``cond``, and the registered ops of the
contrib and attention op modules (``box_nms``, ``multi_head_attention``,
the ``interleaved_matmul_*`` ops, ...)."""
from ..ops.control_flow import foreach, while_loop, cond  # noqa: F401
from ..ops import attention as _attention_ops, contrib as _contrib_ops
from ..base import _OP_REGISTRY
from .register import make_wrapper

_MODULES = (_contrib_ops.__name__, _attention_ops.__name__)

for _name, _opdef in list(_OP_REGISTRY.items()):
    if getattr(_opdef.fn, '__module__', None) in _MODULES and \
            _name not in globals():
        globals()[_name] = make_wrapper(_opdef)
