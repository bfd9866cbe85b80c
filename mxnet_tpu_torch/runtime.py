"""Runtime feature detection (counterpart of ``mxnet_tpu/runtime.py``, ref:
python/mxnet/runtime.py, src/libinfo.cc).

``Features()`` has the JAX package's keys, so that ``is_enabled('XLA')``
and the like answer rather than raise; each value is what this process
has, read from torch: ``CUDA``, ``CUDNN`` and ``NCCL`` from torch's own
checks, ``TPU``, ``XLA`` and ``PALLAS`` false (the port runs none of
them), ``BF16`` true (torch's bfloat16 on the CPU and on the card),
``PROFILER`` true (``mx.profiler``).
"""
from __future__ import annotations

import collections

import torch

__all__ = ['Feature', 'Features', 'feature_list']


class Feature(collections.namedtuple('Feature', ['name', 'enabled'])):
    def __repr__(self):
        return f"[{'✔' if self.enabled else '✖'} {self.name}]"


def _detect():
    import torch.distributed as dist
    feats = {
        'TPU': False,
        'CUDA': torch.cuda.is_available(),
        'CUDNN': torch.backends.cudnn.is_available(),
        'NCCL': dist.is_available() and dist.is_nccl_available(),
        'XLA': False,
        'PALLAS': False,
        'CPU': True,
        'OPENMP': torch.backends.openmp.is_available(),
        'F16C': True,
        'BF16': True,
        'BLAS_OPEN': True,
        'DIST_KVSTORE': dist.is_available(),
        'INT64_TENSOR_SIZE': True,
        'SIGNAL_HANDLER': False,
        'DEBUG': False,
        'MKLDNN': torch.backends.mkldnn.is_available(),
        'TENSORRT': False,
        'TVM_OP': False,
        'PROFILER': True,
    }
    return {k: Feature(k, bool(v)) for k, v in feats.items()}


class Features(dict):
    """Ref: runtime.py Features: one instance a process, built at its
    first call."""

    instance = None

    def __new__(cls):
        if cls.instance is None:
            cls.instance = super().__new__(cls)
            dict.__init__(cls.instance, _detect())
        return cls.instance

    def __repr__(self):
        return str(list(self.values()))

    def is_enabled(self, feature_name):
        feature_name = feature_name.upper()
        if feature_name not in self:
            raise RuntimeError(f"Feature '{feature_name}' is unknown")
        return self[feature_name].enabled


def feature_list():
    return list(Features().values())
