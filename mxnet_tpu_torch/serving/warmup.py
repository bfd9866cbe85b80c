"""Warmup: build every serving bucket before the first request arrives
(counterpart of ``mxnet_tpu/serving/warmup.py``).

A replica that builds lazily pays each bucket's first-call costs on the
first unlucky request. The warmup pass walks the engine's full
``(batch, seq)`` bucket grid at startup and dispatches one dummy batch
per shape. On the card, with ``BlockRunner``'s hybridized block, that
call runs the bucket once eagerly (kernel builds, library set-up) and
captures it as a CUDA graph; every later request of that shape replays
the graph.

- each bucket's cold-start seconds are ledgered through the compile
  ledger (``serving:warmup_b{B}_s{S}`` sites) via ``compile.watching``:
  a bucket that compiled nothing (already captured, or the CPU, where
  nothing is captured) records nothing, so the ledger is exactly the
  list of compiles this process paid for;
- the recompile detector's threshold is lifted for the walk (warmup
  compiles the whole grid at one site on purpose) and restored after
  it, so a steady-state capture afterwards (a bucketing bug) warns
  at once.
"""
from __future__ import annotations

import time as _time

from ..base import telem_flags as _telem
from ..telemetry import compile as _compile, metrics as _metrics

__all__ = ['warmup']


def warmup(engine):
    """Build every bucket shape; returns the per-bucket report::

        {'buckets': {'b4_s64': seconds, ...},
         'total_seconds': ..., 'compiles': <ledger entries written, None
         while the ledger is disarmed>,
         'cache': <compile.persistent_cache_stats()>}

    Each bucket's seconds include its copy back to the host, so the
    device work has finished when the clock stops."""
    t0 = _time.perf_counter()
    before = len(_compile.ledger()) if _compile.enabled() else 0
    report = {}
    prev = _metrics._recompile_threshold
    _metrics.set_recompile_threshold(1 << 30)
    try:
        for b, s in engine.bucket_grid():
            site = f'serving:warmup_b{b}_s{s}'
            tb = _time.perf_counter()
            with _compile.watching(site, sig_fn=lambda b=b, s=s:
                                   _compile.signature(args=[
                                       _compile.arg_sig('batch', (b, s),
                                                        str(engine.dtype))],
                                       flags={'engine': engine.name})):
                engine.run_bucket(b, s)
            report[f'b{b}_s{s}'] = round(_time.perf_counter() - tb, 4)
    finally:
        _metrics.set_recompile_threshold(prev)
    total = _time.perf_counter() - t0
    compiles = (len(_compile.ledger()) - before) if _compile.enabled() \
        else None
    out = {'buckets': report, 'total_seconds': round(total, 4),
           'compiles': compiles,
           'cache': _compile.persistent_cache_stats()}
    if _telem['on']:
        _metrics.set_gauge('mxnet_tpu_serving_warmup_buckets',
                           len(report), engine=engine.name)
        _metrics.set_gauge('mxnet_tpu_serving_warmup_seconds',
                           round(total, 4), engine=engine.name)
    return out
