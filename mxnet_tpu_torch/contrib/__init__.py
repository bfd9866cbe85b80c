"""``mx.contrib`` (counterpart of ``mxnet_tpu/contrib/__init__.py``, ref:
python/mxnet/contrib/__init__.py): ``amp`` (MXNet's import path of
AMP), ``quantization`` (``quantize_net``), ``onnx``, ``text``,
``tensorboard`` and ``svrg_optimization``."""
from .. import amp  # noqa: F401
from . import quantization  # noqa: F401
from . import onnx  # noqa: F401
from . import text  # noqa: F401
from . import tensorboard  # noqa: F401
from . import svrg_optimization  # noqa: F401

__all__ = ['amp', 'quantization', 'onnx', 'text', 'tensorboard',
           'svrg_optimization']
