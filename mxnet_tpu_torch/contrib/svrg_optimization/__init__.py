"""SVRG optimization (counterpart of ``mxnet_tpu/contrib/
svrg_optimization/``, ref: python/mxnet/contrib/svrg_optimization/)."""
from .svrg_module import SVRGModule  # noqa: F401

__all__ = ['SVRGModule']
