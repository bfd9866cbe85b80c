"""mx.image: image loading and augmentation (counterpart of
``mxnet_tpu/image``; ref: python/mxnet/image/). ``image/detection.py``
waits for ROADMAP queue 1 item 14."""
from .image import *  # noqa: F401,F403
from . import image  # noqa: F401
