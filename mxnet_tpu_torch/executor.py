"""Executor module (counterpart of ``mxnet_tpu/executor.py``, ref:
python/mxnet/executor.py): the Executor lives in ``symbol.py`` beside the
graph it runs; this module keeps the reference's import path
``mx.executor.Executor``.

With telemetry enabled, every ``Executor.forward`` reports into
``mxnet_tpu_executor_forward_total`` and
``mxnet_tpu_executor_forward_seconds``."""
from __future__ import annotations

from .symbol import Executor  # noqa: F401

__all__ = ['Executor']
