"""Executor output monitoring (counterpart of ``mxnet_tpu/monitor.py``,
ref: python/mxnet/monitor.py Monitor).

``Monitor(interval, stat_func, pattern).install(executor)`` collects a
statistic of every graph node's output during monitored forwards: the
executor, which runs its graph node by node, hands each node's value to
the monitor's ``_record`` (its inputs too under ``monitor_all``). A
statistic reads the value on the host, so a monitored forward syncs."""
from __future__ import annotations

import logging
import re

import numpy as onp

__all__ = ['Monitor']


def _default_stat(x):
    return onp.abs(x).mean()


class Monitor:
    """Collect per-node output statistics every `interval` monitored
    batches (ref: monitor.py:51)."""

    def __init__(self, interval, stat_func=None, pattern='.*', sort=False,
                 monitor_all=False):
        self.interval = max(1, int(interval))
        self.stat_func = stat_func or _default_stat
        self.re_pattern = re.compile(pattern)
        self.sort = sort
        self.monitor_all = monitor_all
        self.step = 0
        self.activated = False
        self.queue = []

    def install(self, exe):
        """Attach to an Executor (ref: executor.set_monitor_callback)."""
        exe._monitor = self
        return exe

    def tic(self):
        """Start collecting for this batch if the interval says so."""
        if self.step % self.interval == 0:
            self.queue = []
            self.activated = True
        self.step += 1

    def toc(self):
        """Finish the batch; returns [(step, node_name, stat_str)]."""
        if not self.activated:
            return []
        self.activated = False
        res = []
        for name, value in self.queue:
            if not self.re_pattern.match(name):
                continue
            stat = self.stat_func(value.asnumpy()
                                  if hasattr(value, 'asnumpy')
                                  else onp.asarray(value))
            res.append((self.step, name, str(stat)))
        if self.sort:
            res.sort(key=lambda r: r[1])
        self.queue = []
        return res

    def toc_print(self):
        for step, name, stat in self.toc():
            logging.info('Batch: %7d %30s %s', step, name, stat)

    # called from Executor's monitored forward
    def _record(self, name, value):
        self.queue.append((name, value))
