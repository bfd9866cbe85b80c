"""Autograd: record/pause/train_mode/predict_mode, backward/grad and
custom Functions (counterpart of ``mxnet_tpu/autograd.py``, ref:
python/mxnet/autograd.py:120-179,244,271,368). The machinery is
``torch.autograd`` behind ``_imperative``.
"""
from __future__ import annotations

import torch

from .base import state
from . import _imperative
from ._imperative import grad  # noqa: F401  (public API)

__all__ = ['record', 'pause', 'train_mode', 'predict_mode', 'is_recording',
           'is_training', 'set_recording', 'set_training', 'mark_variables',
           'backward', 'grad', 'Function']


class _RecordingStateScope:
    def __init__(self, is_record, train_mode):
        self._enter_is_record = is_record
        self._enter_train_mode = train_mode
        self._prev_is_record = None
        self._prev_train_mode = None

    def __enter__(self):
        if self._enter_is_record is not None:
            self._prev_is_record = state.is_recording
            if self._enter_is_record:
                # a fresh top-level record scope drops what the last one
                # recorded, unless a retain_graph backward keeps it
                if state.record_depth == 0 and not state.is_recording \
                        and not _imperative.tape.retained:
                    _imperative.tape.clear()
                state.record_depth += 1
            state.is_recording = self._enter_is_record
        if self._enter_train_mode is not None:
            self._prev_train_mode = state.is_training
            state.is_training = self._enter_train_mode
        return self

    def __exit__(self, *exc):
        if self._enter_is_record is not None:
            if self._enter_is_record:
                state.record_depth -= 1
            state.is_recording = self._prev_is_record
        if self._enter_train_mode is not None:
            state.is_training = self._prev_train_mode


def record(train_mode=True):
    """Scope for recording the autograd graph (ref: autograd.py:120)."""
    return _RecordingStateScope(True, train_mode)


def pause(train_mode=False):
    return _RecordingStateScope(False, train_mode)


def train_mode():
    return _RecordingStateScope(None, True)


def predict_mode():
    return _RecordingStateScope(None, False)


def is_recording():
    return state.is_recording


def is_training():
    return state.is_training


def set_recording(is_record):
    prev = state.is_recording
    state.is_recording = bool(is_record)
    return prev


def set_training(train_mode_flag):
    prev = state.is_training
    state.is_training = bool(train_mode_flag)
    return prev


def mark_variables(variables, gradients, grad_reqs='write'):
    """Ref: autograd.py mark_variables."""
    if isinstance(grad_reqs, str):
        grad_reqs = [grad_reqs] * len(variables)
    for v, g, req in zip(variables, gradients, grad_reqs):
        v._grad = g
        v._grad_req = req
        v._in_graph = True


def backward(heads, head_grads=None, retain_graph=False, train_mode=True):
    """Ref: autograd.py:244."""
    _imperative.backward(heads, head_grads, retain_graph, train_mode)


class _FunctionNode(torch.autograd.Function):
    """Runs a user Function's forward and backward on NDArrays inside
    torch's graph."""

    @staticmethod
    def forward(ctx, fn, *datas):
        from .ndarray.ndarray import NDArray
        outs = fn.forward(*[NDArray(d) for d in datas])
        ctx.fn = fn
        if isinstance(outs, (list, tuple)):
            return tuple(o._data for o in outs)
        return outs._data

    @staticmethod
    def backward(ctx, *grads):
        from .ndarray.ndarray import NDArray
        gs = ctx.fn.backward(*[NDArray(g) for g in grads])
        if not isinstance(gs, (list, tuple)):
            gs = [gs]
        return (None,) + tuple(None if g is None else g._data for g in gs)


class Function:
    """Custom differentiable function (ref: autograd.py:368).

    Subclass and implement forward(self, *inputs) and
    backward(self, *output_grads) over NDArrays; call the instance on
    NDArrays. Both run with recording off, on fresh NDArrays, so what
    they compute is not itself recorded.
    """

    def __call__(self, *inputs):
        from .ndarray.ndarray import NDArray
        if not (state.is_recording and any(x._in_graph for x in inputs)):
            return self.forward(*[NDArray(x._data) for x in inputs])
        datas = [_imperative.leaf_tensor(x) if x._grad is not None
                 else x._data for x in inputs]
        with torch.enable_grad():
            outs = _FunctionNode.apply(self, *datas)
        single = not isinstance(outs, tuple)
        out_list = [NDArray(o) for o in ((outs,) if single else outs)]
        for o in out_list:
            _imperative.record_output(o)
        return out_list[0] if single else tuple(out_list)

    def forward(self, *inputs):
        raise NotImplementedError

    def backward(self, *output_grads):
        raise NotImplementedError
