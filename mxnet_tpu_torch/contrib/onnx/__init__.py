"""ONNX interop (counterpart of ``mxnet_tpu/contrib/onnx/``, ref:
python/mxnet/contrib/onnx/): ``export_model`` and ``import_model`` /
``import_to_gluon``, without the ``onnx`` package (the protobuf wire
format is written and read directly, ``_proto.py``)."""
from .mx2onnx import export_model  # noqa: F401
from .onnx2mx import import_model, import_to_gluon  # noqa: F401

__all__ = ['export_model', 'import_model', 'import_to_gluon']
