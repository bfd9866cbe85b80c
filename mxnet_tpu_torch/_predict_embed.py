"""Python side of the C predict API (counterpart of
``mxnet_tpu/_predict_embed.py``; driven by ``csrc/embed/c_predict_api.cc``).

The deployment path runs the same SymbolBlock forward as the Python
frontend, so a forward through the C ABI launches the same kernels (ref:
src/c_api/c_predict_api.cc, which rebuilt a static executor).

``dev_type`` decides the device, as in MXNet: 1 is the CPU, 2 CUDA
device ``dev_id``; with no such card ``MXPredCreate`` fails naming the
missing device, and any other code is an error. (The JAX Predictor
ignores ``dev_type``.)
"""
from __future__ import annotations

import numpy as onp

from .base import MXNetError

__all__ = ['create', 'Predictor']

_DEV_TYPES = {1: 'cpu', 2: 'gpu'}


def _context(dev_type, dev_id):
    from .context import Context
    if dev_type not in _DEV_TYPES:
        raise MXNetError(f"dev_type {dev_type} is not supported: 1 (cpu) or "
                         f"2 (gpu)")
    ctx = Context(_DEV_TYPES[dev_type], int(dev_id))
    ctx.device          # raises for a card that is not there
    return ctx


class Predictor:
    def __init__(self, symbol_json_str, param_bytes, input_keys,
                 input_shapes, dev_type, dev_id=0):
        from . import symbol as sym_mod
        from .gluon.block import SymbolBlock
        from .serialization import load_params_dict

        self.ctx = _context(dev_type, dev_id)
        s = sym_mod.fromjson(symbol_json_str)
        self.block = SymbolBlock(s, [sym_mod.var(k) for k in input_keys])
        # model files may come from third parties: the params blob is
        # parsed as the reference binary format only, which holds no
        # executable payload (the port's reader never unpickles)
        payload = load_params_dict(param_bytes)
        self.block._load_arg_dict({k: onp.array(v) for k, v in
                                   payload.items()}, ctx=self.ctx)
        self.input_keys = list(input_keys)
        self.input_shapes = {k: tuple(int(d) for d in shp)
                             for k, shp in zip(input_keys, input_shapes)}
        self.inputs = {}
        self.outputs = []

    def set_input(self, key, data_bytes):
        if key not in self.input_shapes:
            raise KeyError(f"unknown input '{key}' "
                           f"(declared: {self.input_keys})")
        shape = self.input_shapes[key]
        arr = onp.frombuffer(data_bytes, dtype=onp.float32)
        expected = int(onp.prod(shape)) if shape else 1
        if arr.size != expected:
            raise ValueError(
                f"input '{key}': got {arr.size} floats, shape {shape} "
                f"needs {expected}")
        self.inputs[key] = arr.reshape(shape)

    def forward(self):
        from .ndarray.ndarray import array as nd_array
        missing = [k for k in self.input_keys if k not in self.inputs]
        if missing:
            raise ValueError(f"inputs not set: {missing}")
        args = [nd_array(self.inputs[k], ctx=self.ctx)
                for k in self.input_keys]
        out = self.block(*args)
        self.outputs = list(out) if isinstance(out, (list, tuple)) else [out]

    def _out(self, index):
        if not self.outputs:
            raise ValueError("call forward() before reading outputs")
        if not 0 <= index < len(self.outputs):
            raise IndexError(f"output index {index} out of range")
        return self.outputs[index]

    def output_shape(self, index):
        return tuple(int(d) for d in self._out(index).shape)

    def output_bytes(self, index):
        return onp.ascontiguousarray(
            self._out(index).asnumpy().astype(onp.float32)).tobytes()


def create(symbol_json_str, param_bytes, input_keys, input_shapes, dev_type,
           dev_id=0):
    return Predictor(symbol_json_str, param_bytes, input_keys, input_shapes,
                     dev_type, dev_id)
