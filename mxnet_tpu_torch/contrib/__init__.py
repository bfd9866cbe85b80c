"""``mx.contrib``: MXNet 1.6's import path of AMP (``mxnet.contrib.amp``).
The rest of contrib is not ported (ROADMAP queue 1 item 17)."""
from .. import amp  # noqa: F401

__all__ = ['amp']
