"""Error type shared by every module of the port (counterpart of
``mxnet_tpu/base.py``'s ``MXNetError``)."""
from __future__ import annotations

__all__ = ['MXNetError']


class MXNetError(RuntimeError):
    """Raised for invalid usage, bad inputs and kernel failures."""
