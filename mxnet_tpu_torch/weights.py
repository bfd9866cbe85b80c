"""Weights from the JAX package into the port.

Parameters are keyed by the JAX package's structured names (those of
``Block._collect_params_with_prefix``, e.g. ``encoder.0.ln1.gamma``),
which are the port modules' ``named_parameters()`` names too: for a Gluon
net (the model zoo's ResNets) these include BatchNorm's
``running_mean``/``running_var``, carried like any parameter, and for a
net that ``contrib.quantization.quantize_net`` converted, the quantized
layers' Constants (the int8 ``weight``, ``wrange``, ``bias`` and
``calib``), integer arrays carried as integers. Every
mismatch — a missing or extra key, a shape that differs, a parameter
still waiting for its shape (deferred initialisation: run one forward
first) — raises.
"""
from __future__ import annotations

from typing import Dict

import numpy as onp
import torch
from torch.nn.parameter import UninitializedParameter

from .base import MXNetError
from .serialization import load_params_dict

__all__ = ['params_from_mxnet_tpu', 'load_parameters']


def params_from_mxnet_tpu(arrays: Dict[str, onp.ndarray],
                          module: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """{structured name: numpy array} -> {name: tensor} on the device and
    in the dtype of ``module``'s parameter of that name, ready for
    ``module.load_state_dict``."""
    expected = dict(module.named_parameters())
    missing = sorted(set(expected) - set(arrays))
    extra = sorted(set(arrays) - set(expected))
    if missing or extra:
        raise MXNetError(f"parameter names differ: missing {missing}, "
                         f"extra {extra}")
    out = {}
    for name, p in expected.items():
        if isinstance(p, UninitializedParameter):
            raise MXNetError(f"parameter {name!r} has no shape yet "
                             f"(deferred initialisation): run one forward "
                             f"before loading")
        a = onp.asarray(arrays[name])
        if tuple(a.shape) != tuple(p.shape):
            raise MXNetError(f"parameter {name!r}: shape {a.shape} in the "
                             f"arrays, {tuple(p.shape)} in the module")
        if onp.issubdtype(a.dtype, onp.integer) or a.dtype == onp.bool_:
            # integers (a quantized layer's int8 weight) as they are
            t = torch.from_numpy(onp.ascontiguousarray(a))
        else:
            # through f32: numpy has no native bfloat16 for torch to take
            t = torch.from_numpy(onp.array(a, dtype=onp.float32))
        out[name] = t.to(device=p.device, dtype=p.dtype)
    return out


def load_parameters(module: torch.nn.Module, path: str) -> torch.nn.Module:
    """Load a ``.params`` file (as ``mxnet_tpu``'s ``save_parameters``
    writes it) into ``module``, through the port's own reader."""
    with open(path, 'rb') as f:
        arrays = load_params_dict(f.read())
    module.load_state_dict(params_from_mxnet_tpu(arrays, module))
    return module
