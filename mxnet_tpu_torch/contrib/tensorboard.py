"""Training-metric logging callback (counterpart of
``mxnet_tpu/contrib/tensorboard.py``, ref: python/mxnet/contrib/
tensorboard.py).

MXNet forwards eval metrics to a TensorBoard SummaryWriter. The callback
takes any writer with ``add_scalar(tag, value, step)``; without one it
uses tensorboardX's where that is installed, else ``JSONLWriter``, which
writes one ``{"tag", "value", "step", "wall_time"}`` object a line to
``scalars.jsonl``: the JAX package's lines, apart from the wall times.
"""
from __future__ import annotations

import json
import os
import time

__all__ = ['LogMetricsCallback', 'JSONLWriter']


class JSONLWriter:
    """Minimal SummaryWriter-compatible scalar logger."""

    def __init__(self, logdir):
        os.makedirs(logdir, exist_ok=True)
        self._f = open(os.path.join(logdir, 'scalars.jsonl'), 'a')

    def add_scalar(self, tag, value, step=0):
        self._f.write(json.dumps({'tag': tag, 'value': float(value),
                                  'step': int(step),
                                  'wall_time': time.time()}) + '\n')
        self._f.flush()

    def close(self):
        self._f.close()


class LogMetricsCallback:
    """Batch-end callback pushing metrics to a writer
    (ref: tensorboard.py LogMetricsCallback)."""

    def __init__(self, logging_dir=None, prefix=None, summary_writer=None):
        self.prefix = prefix
        self.step = 0
        if summary_writer is not None:
            self.summary_writer = summary_writer
        else:
            if logging_dir is None:
                raise ValueError(
                    "LogMetricsCallback needs logging_dir or summary_writer")
            try:
                from tensorboardX import SummaryWriter  # optional
                self.summary_writer = SummaryWriter(logging_dir)
            except ImportError:
                self.summary_writer = JSONLWriter(logging_dir)

    def __call__(self, param):
        self.step += 1
        if param.eval_metric is None:
            return
        for name, value in param.eval_metric.get_name_value():
            if self.prefix is not None:
                name = f"{self.prefix}-{name}"
            self.summary_writer.add_scalar(name, value, self.step)
