"""mx.image: image loading and augmentation, and the detection iterator
(counterpart of ``mxnet_tpu/image``; ref: python/mxnet/image/)."""
from .image import *  # noqa: F401,F403
from .detection import *  # noqa: F401,F403
from . import detection, image  # noqa: F401
