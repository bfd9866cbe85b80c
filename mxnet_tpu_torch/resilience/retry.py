"""Bounded retry/backoff for transient failures (counterpart of
``mxnet_tpu/resilience/retry.py``).

One shared helper, so every layer that retries (``parallel.dist.init``
connecting to rank 0's store) uses the same bounded policy and reports
into the same ``mxnet_tpu_resilience_retries_total`` counter: unbounded
retry loops are how a transient failure becomes a silent hang.
"""
from __future__ import annotations

import logging
import time as _time

from ..base import telem_flags as _telem

__all__ = ['retry_call']

_log = logging.getLogger('mxnet_tpu_torch.resilience')


def retry_call(fn, *args, retries=2, backoff_seconds=0.05,
               max_backoff_seconds=2.0, retry_on=(OSError,),
               give_up_on=(), site='', sleep=_time.sleep, **kwargs):
    """Call ``fn(*args, **kwargs)``; on an exception in ``retry_on``,
    retry up to ``retries`` more times with exponential backoff
    (``backoff_seconds * 2**attempt``, capped). Exceptions outside
    ``retry_on``, or inside ``give_up_on`` (which wins even when it is a
    ``retry_on`` subclass), propagate at once; the last failure
    propagates with its own traceback once the budget is spent."""
    retries = max(0, int(retries))
    attempt = 0
    while True:
        try:
            return fn(*args, **kwargs)
        except retry_on as e:
            if give_up_on and isinstance(e, give_up_on):
                raise
            if attempt >= retries:
                raise
            delay = min(backoff_seconds * (2 ** attempt),
                        max_backoff_seconds)
            attempt += 1
            _log.warning(
                "%s: transient failure (%s), retry %d/%d in %.3fs",
                site or getattr(fn, '__name__', 'call'), e, attempt,
                retries, delay)
            if _telem['on']:
                from .. import telemetry as _telemetry
                _telemetry.inc('mxnet_tpu_resilience_retries_total',
                               site=site or 'unknown')
            if delay > 0:
                sleep(delay)
