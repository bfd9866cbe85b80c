"""Python side of the C training API (counterpart of
``mxnet_tpu/_train_embed.py``; driven by ``csrc/embed/c_api_train.cc``).

MXNet's C surface lets an embedder train, not just predict: imperative op
invocation, autograd record/backward, CachedOp, KVStore (ref:
include/mxnet/c_api.h:1251 MXAutogradBackwardEx, :1341
MXInvokeCachedOpEx, :1405 MXImperativeInvokeEx, :2670 MXKVStorePush). The
C ABI embeds CPython and each entry point delegates to one function here,
so the C side is pure marshalling and training runs the Python frontend's
registry, autograd tape and kvstore, on the same kernels.

``MXTrainNDArrayCreate`` takes no device: an array goes to the caller's
current context (``context.current_context()``), the card unless a
``with mx.cpu():`` scope is open on the calling thread (the context is
per thread, and ``ctypes`` calls from the caller's thread). With no card
the call fails naming the missing device.
"""
from __future__ import annotations

import ast

import numpy as onp

__all__ = [
    'create_ndarray', 'copy_from_bytes', 'copy_to_numpy', 'get_shape',
    'set_recording', 'set_training', 'mark_variables', 'backward',
    'get_grad', 'symbol_from_json', 'symbol_num_outputs',
    'create_cached_op', 'invoke_cached_op', 'imperative_invoke',
    'kvstore_create', 'kvstore_init', 'kvstore_push', 'kvstore_pull',
]

_DTYPES = {0: 'float32', 1: 'float64', 2: 'float16', 3: 'uint8',
           4: 'int32', 5: 'int8', 6: 'int64'}


def create_ndarray(shape, dtype_code):
    from .ndarray.ndarray import zeros
    code = int(dtype_code)
    if code not in _DTYPES:
        raise ValueError(f"unsupported dtype code {code}; known codes: "
                         f"{sorted(_DTYPES)}")
    return zeros(tuple(shape), dtype=_DTYPES[code])


def copy_from_bytes(arr, buf):
    src = onp.frombuffer(buf, dtype=arr.dtype).reshape(arr.shape).copy()
    arr[:] = src
    return True


def copy_to_numpy(arr):
    return onp.ascontiguousarray(arr.asnumpy())


def get_shape(arr):
    return tuple(int(s) for s in arr.shape)


def set_recording(flag):
    from . import autograd
    return 1 if autograd.set_recording(bool(flag)) else 0


def set_training(flag):
    from . import autograd
    return 1 if autograd.set_training(bool(flag)) else 0


def mark_variables(arrays, grad_reqs, grads):
    from . import autograd
    reqs = ['write' if r else 'null' for r in grad_reqs] \
        if grad_reqs is not None else 'write'
    autograd.mark_variables(list(arrays), list(grads), grad_reqs=reqs)
    return True


def backward(outputs, out_grads=None, retain_graph=False):
    from . import autograd
    autograd.backward(list(outputs),
                      None if out_grads is None else list(out_grads),
                      retain_graph=bool(retain_graph))
    return True


def get_grad(arr):
    return arr.grad


def symbol_from_json(json_str):
    from . import symbol as sym_mod
    return sym_mod.fromjson(json_str)


def symbol_num_outputs(sym):
    return len(sym.list_outputs())


def symbol_list_inputs(sym):
    """The arguments, then the auxiliary states: the JAX package's order
    (not nnvm's graph order)."""
    return list(sym.list_arguments()) + list(sym.list_auxiliary_states())


class _CachedOp:
    """CachedOp over a Symbol: inputs bind positionally in
    ``symbol_list_inputs`` order (ref: src/imperative/cached_op.cc).

    The whole graph evaluates as one function dispatched through the
    NDArray invoke, so under ``autograd.record()`` it is one call on the
    tape and ``MXTrainAutogradBackward`` differentiates through it as
    through any op. It runs eagerly: capturing it as a CUDA graph is
    queued perf work. BatchNorm's moving statistics are not written back,
    as the JAX package's jitted CachedOp does not write them."""

    def __init__(self, sym):
        from . import symbol as sym_mod
        self.sym = sym
        self.input_names = names = symbol_list_inputs(sym)

        def cached_op(*datas):
            out, _cache = sym_mod._evaluate(sym, dict(zip(names, datas)))
            return out

        self._fn = cached_op

    def __call__(self, args):
        from .ndarray.ndarray import _invoke
        if len(args) != len(self.input_names):
            raise ValueError(
                f"CachedOp expects {len(self.input_names)} inputs "
                f"({self.input_names}), got {len(args)}")
        out = _invoke(self._fn, *args)
        return list(out) if isinstance(out, (list, tuple)) else [out]


def create_cached_op(sym):
    return _CachedOp(sym)


def invoke_cached_op(cop, inputs):
    return cop(list(inputs))


def _parse_param(v):
    """The reference marshals every op param as a string
    (src/c_api/c_api_ndarray.cc SetOpAttrs); parse numbers, tuples and
    bools, keep unparseable values as strings (e.g. act_type='relu')."""
    try:
        return ast.literal_eval(v)
    except (ValueError, SyntaxError):
        return v


def imperative_invoke(op_name, inputs, keys, vals):
    from .ndarray.ndarray import imperative_invoke as _nd_invoke
    kwargs = {k: _parse_param(v) for k, v in zip(keys, vals)}
    out = _nd_invoke(op_name, *inputs, **kwargs)
    return list(out) if isinstance(out, (list, tuple)) else [out]


def kvstore_create(kind):
    from . import kvstore as kv_mod
    return kv_mod.create(kind)


def kvstore_init(kv, keys, vals):
    kv.init(list(keys), list(vals))
    return True


def kvstore_push(kv, keys, vals, priority=0):
    kv.push(list(keys), list(vals), priority=priority)
    return True


def kvstore_pull(kv, keys, outs, priority=0):
    kv.pull(list(keys), out=list(outs), priority=priority)
    return True
