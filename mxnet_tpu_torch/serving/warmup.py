"""Warmup: dispatch one dummy batch of every bucket shape before the
first request arrives (counterpart of ``mxnet_tpu/serving/warmup.py``,
without its compile ledger). On the card the first call of each shape
pays the kernels' first-use costs (library load, Triton compile,
allocator growth); warmup moves them out of the requests' latency."""
from __future__ import annotations

import time as _time

__all__ = ['warmup']


def warmup(engine):
    """Run every bucket of ``engine.bucket_grid()`` once; returns
    ``{'buckets': {'b4_s64': seconds, ...}, 'total_seconds': ...}``. Each
    bucket's seconds include its copy back to the host, so the device work
    has finished when the clock stops."""
    t0 = _time.perf_counter()
    report = {}
    for b, s in engine.bucket_grid():
        tb = _time.perf_counter()
        engine.run_bucket(b, s)
        report[f'b{b}_s{s}'] = round(_time.perf_counter() - tb, 4)
    return {'buckets': report,
            'total_seconds': round(_time.perf_counter() - t0, 4)}
