"""Environment-variable knobs read by the port (counterpart of
``mxnet_tpu/config.py``).

Only the knobs this package reads are declared, under the JAX package's
names and with its defaults, so one run configuration drives both
packages. ``get`` reads the process environment at every call.
"""
from __future__ import annotations

import os
from typing import Any, Callable, Dict, NamedTuple

from .base import MXNetError

__all__ = ['EnvVar', 'get', 'list_vars']


class EnvVar(NamedTuple):
    name: str
    type: Callable
    default: Any
    help: str


_REGISTRY: Dict[str, EnvVar] = {}


def _register(name, type_, default, help_):
    _REGISTRY[name] = EnvVar(name, type_, default, help_)


def _bool(s):
    return str(s).lower() not in ('0', 'false', 'off', '', 'no', 'n',
                                  'none', 'disabled')


def get(name, default=None):
    """Typed value of a declared variable (process env > declared
    default > ``default``)."""
    var = _REGISTRY.get(name)
    if var is None:
        raise MXNetError(f"unknown config variable {name!r}; see "
                         f"mxnet_tpu_torch.config.list_vars()")
    raw = os.environ.get(name)
    if raw is None:
        return var.default if default is None else default
    try:
        return var.type(raw)
    except (TypeError, ValueError) as e:
        raise MXNetError(
            f"{name}={raw!r} is not a valid {var.type.__name__}") from e


def list_vars():
    return sorted(_REGISTRY)


_register('MXTPU_PALLAS_LN', _bool, False,
          'Route the transformer residual+LN epilogue through the fused '
          'Triton kernel (ops/fused_layernorm.py) when the tensors are on '
          'CUDA. Default: the plain PyTorch path.')
_register('MXTPU_PALLAS_FFN', _bool, False,
          'Route the BERT FFN1 dense+bias+GELU through the fused CUDA '
          'kernel (ops/fused_ffn.py) when the tensors are on CUDA. '
          'Default: the plain PyTorch path.')
_register('MXTPU_SERVE_BATCH_DEADLINE_MS', float, 5.0,
          'Continuous-batcher formation deadline: a batch dispatches when '
          'its sequence bucket fills to the largest batch bucket or when '
          'its oldest request has waited this long.')
_register('MXTPU_SERVE_BUCKETS', str, '32,64,128',
          'Sequence-length buckets (comma-separated). Every request pads '
          'up to the smallest bucket that fits; longer requests are '
          'rejected.')
_register('MXTPU_SERVE_BATCH_BUCKETS', str, '1,2,4,8',
          'Batch-size buckets (comma-separated). A formed batch pads its '
          'row count up to the smallest bucket that fits.')
_register('MXTPU_SERVE_QUEUE_LIMIT', int, 256,
          'Admission bound on total queued requests; beyond it '
          'submissions shed with RequestShed.')
_register('MXTPU_SERVE_DRAIN_SECONDS', float, 10.0,
          'Graceful-drain budget: how long drain() waits for in-flight '
          'requests before giving up.')
_register('MXTPU_REMAT', str, 'none',
          "Activation remat policy of ShardedTrainStep: only 'none' is "
          'ported; any other policy raises (ROADMAP queue 1 item 7).')
_register('MXNET_HOME', str, os.path.join(os.path.expanduser('~'), '.mxnet'),
          'Data directory: the model zoo looks for pretrained weights in '
          'its models/ folder.')
_register('MXNET_GLUON_REPO', str, '',
          'A local directory holding gluon/models/<name>-<hash>.params, '
          'where the model zoo also looks for pretrained weights (the '
          'port downloads nothing).')
