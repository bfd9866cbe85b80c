"""The Gluon model zoo (counterpart of ``mxnet_tpu/gluon/model_zoo``): the
vision ResNets so far (ROADMAP queue 1 lists the rest)."""
from . import vision
from .vision import get_model

__all__ = ['vision', 'get_model']
