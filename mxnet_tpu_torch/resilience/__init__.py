"""Resilience helpers (counterpart of ``mxnet_tpu/resilience``): the
bounded retry only. The guard, elastic membership, the watchdog and the
drills wait for ROADMAP queue 1 items 9 and 10."""
from .retry import retry_call

__all__ = ['retry_call']
