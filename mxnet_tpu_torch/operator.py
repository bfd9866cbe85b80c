"""``mx.operator``: operators written by the user in Python (counterpart
of ``mxnet_tpu/operator.py``, ref: python/mxnet/operator.py,
src/operator/custom/custom.cc).

``@register(op_type)`` names a ``CustomOpProp`` subclass; ``nd.Custom(*
inputs, op_type=..., **kwargs)`` and ``sym.Custom`` (the registered op
``Custom``, also ``custom``) run it. The prop's ``infer_shape``/
``infer_type`` give the outputs, which the user's ``CustomOp.forward``
fills through ``assign``; the call is a ``torch.autograd.Function``, so
``mx.autograd`` records it and its backward is the user's ``backward``
(``out_grad`` given only when the prop declares ``need_top_grad``). The
user's own ``nd`` calls inside ``forward``/``backward`` are not
recorded. Keyword arguments reach the prop as strings, as the reference
marshals them through its C API. A ``sym.Custom`` node's output shape is
the prop's ``infer_shape`` (a shape rule: no meta tensor reaches the
user's code).
"""
from __future__ import annotations

from typing import Dict, List, Type

import torch

from .base import MXNetError, get_op, register_op, state, torch_dtype

__all__ = ['CustomOp', 'CustomOpProp', 'CustomOpError', 'register',
           'get_registered_op', 'list_registered_ops']


class CustomOp:
    """Base class of a user operator (ref: operator.py CustomOp)."""

    def forward(self, is_train, req, in_data, out_data, aux):
        raise NotImplementedError

    def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
        raise NotImplementedError

    def assign(self, dst, req, src):
        """Write ``src`` into ``dst`` by the request ('null' skips, 'add'
        accumulates, 'write'/'inplace' replace; ref: op_attr_types.h:46)."""
        if req == 'null':
            return
        from .ndarray.ndarray import NDArray
        s = src._data if isinstance(src, NDArray) else torch.as_tensor(src)
        s = s.to(device=dst._data.device, dtype=dst._data.dtype)
        dst._data = dst._data + s if req == 'add' else s


class CustomOpProp:
    """A user operator's properties: its arguments, outputs, shapes and
    types, and its factory (ref: operator.py CustomOpProp)."""

    def __init__(self, need_top_grad=True):
        self.need_top_grad_ = need_top_grad

    def infer_shape(self, in_shape):
        return in_shape, [in_shape[0]] * len(self.list_outputs()), []

    def infer_type(self, in_type):
        return in_type, [in_type[0]] * len(self.list_outputs()), \
            [in_type[0]] * len(self.list_auxiliary_states())

    def list_arguments(self):
        return ['data']

    def list_outputs(self):
        return ['output']

    def list_auxiliary_states(self):
        return []

    def declare_backward_dependency(self, out_grad, in_data, out_data):
        deps = []
        if self.need_top_grad_:
            deps.extend(out_grad)
        deps.extend(in_data)
        deps.extend(out_data)
        return deps

    def create_operator(self, ctx, in_shapes, in_dtypes):
        return CustomOp()


_registry: Dict[str, Type[CustomOpProp]] = {}


class CustomOpError(MXNetError, ValueError):
    """An unregistered op type or a prop that contradicts its inputs: a
    ValueError, as the JAX package raises it, and an MXNetError, so the
    op dispatch passes it on as it is."""


def register(reg_name):
    """Register a CustomOpProp subclass under ``op_type`` (ref:
    operator.py register)."""
    def do_register(prop_cls):
        if not issubclass(prop_cls, CustomOpProp):
            raise TypeError("can only register subclasses of CustomOpProp")
        _registry[reg_name] = prop_cls
        return prop_cls
    return do_register


def get_registered_op(op_type) -> Type[CustomOpProp]:
    if op_type not in _registry:
        raise CustomOpError(
            f"custom op type '{op_type}' is not registered "
            f"(known: {sorted(_registry)})")
    return _registry[op_type]


def list_registered_ops() -> List[str]:
    return sorted(_registry)


def _make_prop(op_type, kwargs) -> CustomOpProp:
    return get_registered_op(op_type)(**{k: str(v)
                                         for k, v in kwargs.items()})


def _np_dtype(t):
    from .ndarray.ndarray import NDArray
    return NDArray(t).dtype


class _Custom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, op, prop, n_in, outs, is_train, *tensors):
        from .ndarray.ndarray import NDArray
        in_data = [NDArray(t) for t in tensors[:n_in]]
        aux = [NDArray(t) for t in tensors[n_in:]]
        out_data = [NDArray(torch.zeros(s, dtype=d, device=tensors[0].device))
                    for s, d in outs]
        rec, state.is_recording = state.is_recording, False
        try:
            op.forward(is_train=is_train, req=['write'] * len(out_data),
                       in_data=in_data, out_data=out_data, aux=aux)
        finally:
            state.is_recording = rec
        results = tuple(o._data.clone() for o in out_data)
        ctx.op, ctx.prop, ctx.n_in = op, prop, n_in
        ctx.save_for_backward(*tensors, *results)
        return results

    @staticmethod
    def backward(ctx, *cts):
        from .ndarray.ndarray import NDArray
        saved = ctx.saved_tensors
        n_in, n_out = ctx.n_in, len(cts)
        n_aux = len(saved) - n_in - n_out
        in_data = [NDArray(t) for t in saved[:n_in]]
        aux = [NDArray(t) for t in saved[n_in:n_in + n_aux]]
        out_data = [NDArray(t) for t in saved[n_in + n_aux:]]
        out_grad = [NDArray(c) for c in cts] if ctx.prop.need_top_grad_ \
            else []
        in_grad = [NDArray(torch.zeros_like(t)) for t in saved[:n_in]]
        rec, state.is_recording = state.is_recording, False
        try:
            ctx.op.backward(req=['write'] * n_in, out_grad=out_grad,
                            in_data=in_data, out_data=out_data,
                            in_grad=in_grad, aux=aux)
        finally:
            state.is_recording = rec
        return (None, None, None, None, None,
                *[g._data for g in in_grad], *[None] * n_aux)


def custom(*inputs, op_type=None, **kwargs):
    """The registered op behind ``nd.Custom``/``sym.Custom`` over tensors
    (NDArrays are taken as their tensors): the arguments, then the
    auxiliary states, as the prop lists them."""
    from .ndarray.ndarray import NDArray
    if op_type is None:
        raise CustomOpError("Custom requires op_type=")
    prop = _make_prop(op_type, kwargs)
    tensors = [a._data if isinstance(a, NDArray) else a for a in inputs]
    n_args = len(prop.list_arguments())
    n_aux = len(prop.list_auxiliary_states())
    if len(tensors) != n_args + n_aux:
        raise CustomOpError(
            f"custom op '{op_type}' expects {n_args} args + {n_aux} aux "
            f"states, got {len(tensors)} inputs")
    in_shapes = [tuple(t.shape) for t in tensors[:n_args]]
    in_shapes, out_shapes, _ = prop.infer_shape(in_shapes)
    in_types = [_np_dtype(t) for t in tensors[:n_args]]
    _, out_types, _ = prop.infer_type(in_types)
    n_out = len(prop.list_outputs())
    if len(out_shapes) != n_out or len(out_types) != n_out:
        raise CustomOpError(
            f"custom op '{op_type}': infer_shape/infer_type returned "
            f"{len(out_shapes)}/{len(out_types)} outputs but list_outputs() "
            f"declares {n_out}")
    op = prop.create_operator(None, in_shapes, in_types)
    outs = [(tuple(s), torch_dtype(t)) for s, t in zip(out_shapes,
                                                        out_types)]
    res = _Custom.apply(op, prop, n_args, outs, state.is_training, *tensors)
    return res[0] if n_out == 1 else tuple(res)


def _shape_rule(in_shapes, attrs):
    kwargs = {k: v for k, v in attrs.items()
              if not k.startswith('__') and k != 'op_type'}
    prop = _make_prop(attrs['op_type'], kwargs)
    n_args = len(prop.list_arguments())
    _, out_shapes, _ = prop.infer_shape([tuple(s)
                                         for s in in_shapes[:n_args]])
    out = [tuple(s) for s in out_shapes]
    return out[0] if len(out) == 1 else out


def _register():
    """``custom`` in the registry with ``Custom`` its alias, as the JAX
    package registers them; ``nd.Custom`` and ``sym.Custom`` by both
    names."""
    from . import ndarray, symbol
    from .base import register_op_alias
    from .ndarray.register import make_wrapper
    register_op('custom', num_outputs=-1)(custom)
    register_op_alias('Custom', 'custom')
    symbol.register_shape_rule('custom', _shape_rule)
    wrapper = make_wrapper(get_op('custom'))
    for name in ('custom', 'Custom'):
        setattr(ndarray, name, wrapper)
        setattr(symbol, name, symbol._OpMaker.make('custom'))


_register()
