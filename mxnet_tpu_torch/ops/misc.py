"""The symbolic API's loss and gradient-shaping ops (counterparts of
``mxnet_tpu/ops/misc.py:79-341`` and ``ops/ref_compat.py:314-333``).

Each op whose gradient is not the derivative of its forward is a
``torch.autograd.Function``, as the JAX package's are ``custom_vjp``s:

- ``SoftmaxOutput``/``softmax_output``: softmax forward; the backward is
  ``(softmax - onehot(label)) * scale`` and ignores the head gradient
  (``use_ignore`` zeroes the rows of ``ignore_label``; ``normalization=
  'batch'`` divides the scale by N). The label gets no gradient;
- ``MakeLoss``/``make_loss``: identity forward, ``grad_scale`` (divided
  by N under 'batch', by the count above ``valid_thresh`` under 'valid')
  broadcast as the backward;
- ``gradient_multiplier``: identity forward, the head gradient times
  ``scalar`` backward;
- the three regression outputs: the link (identity or sigmoid) forward,
  ``grad(link(x), label) * grad_scale`` backward.

``SliceChannel``/``slice_channel`` split along an axis (``split``'s
arithmetic), registered with a count of outputs its arguments set.
The JAX package registers ``softmax_output`` twice (``ops/nn.py:443``
and ``ops/misc.py:324``); the later one, with the custom gradient, wins
there, and it is the one mirrored here.
"""
from __future__ import annotations

import torch

from ..base import register_op

__all__ = ['gradient_multiplier', 'MakeLoss', 'make_loss', 'SoftmaxOutput',
           'softmax_output', 'SliceChannel', 'slice_channel',
           'linear_regression_output', 'mae_regression_output',
           'logistic_regression_output']


def _reg(fn, num_outputs=1):
    register_op(fn.__name__, num_outputs=num_outputs)(fn)
    return fn


class _GradMult(torch.autograd.Function):
    @staticmethod
    def forward(ctx, data, scalar):
        ctx.scalar = scalar
        return data.view_as(data)

    @staticmethod
    def backward(ctx, ct):
        return ct * ctx.scalar, None


@_reg
def gradient_multiplier(data, scalar=1.0):
    """Identity forward, gradient scaled by ``scalar`` (ref:
    src/operator/contrib/gradient_multiplier_op.cc)."""
    return _GradMult.apply(data, float(scalar))


class _MakeLoss(torch.autograd.Function):
    @staticmethod
    def forward(ctx, data, scale):
        ctx.scale = scale
        return data.view_as(data)

    @staticmethod
    def backward(ctx, ct):
        return torch.full_like(ct, ctx.scale), None


@_reg
def MakeLoss(data, grad_scale=1.0, valid_thresh=0.0, normalization='null'):
    """Identity forward, constant ``grad_scale`` backward whatever the
    head gradient (ref: src/operator/make_loss.cc)."""
    scale = grad_scale
    if normalization == 'batch':
        scale = scale / data.shape[0]
    elif normalization == 'valid':
        with torch.no_grad():
            valid = float((data > valid_thresh).sum().clamp_min(1))
        scale = scale / valid
    # the JAX op carries the scale as an array of the data's dtype
    return _MakeLoss.apply(data, float(torch.tensor(scale,
                                                    dtype=data.dtype)))


@_reg
def make_loss(data, grad_scale=1.0, valid_thresh=0.0, normalization='null'):
    return MakeLoss(data, grad_scale, valid_thresh, normalization)


def _softmax_axis(out, multi_output):
    return 1 if multi_output and out.dim() > 2 else -1


class _SoftmaxOutput(torch.autograd.Function):
    @staticmethod
    def forward(ctx, data, label, scale, ignore_label, use_ignore,
                multi_output):
        out = torch.softmax(data, dim=_softmax_axis(data, multi_output))
        ctx.save_for_backward(out, label)
        ctx.args = (scale, ignore_label, use_ignore, multi_output)
        return out

    @staticmethod
    def backward(ctx, ct):
        out, label = ctx.saved_tensors
        scale, ignore_label, use_ignore, multi_output = ctx.args
        axis = _softmax_axis(out, multi_output)
        lab = label.to(torch.int64)
        onehot = torch.nn.functional.one_hot(
            lab.clamp(0, out.shape[axis] - 1), out.shape[axis]).to(out.dtype)
        # an out-of-range label (ignore_label = -1) has no class, as
        # jax.nn.one_hot gives it a zero row
        onehot = onehot * ((lab >= 0) & (lab < out.shape[axis])) \
            .unsqueeze(-1).to(out.dtype)
        if axis == 1:
            onehot = torch.movedim(onehot, -1, 1)
        g = (out - onehot) * scale
        if use_ignore:
            keep = (lab != ignore_label).to(out.dtype)
            g = g * (keep.unsqueeze(1) if axis == 1 else keep.unsqueeze(-1))
        return g, None, None, None, None, None


@_reg
def SoftmaxOutput(data, label, grad_scale=1.0, ignore_label=-1,
                  use_ignore=False, multi_output=False,
                  normalization='null', **kwargs):
    """Softmax forward with the cross-entropy gradient as its backward
    (ref: src/operator/softmax_output.cc)."""
    scale = grad_scale
    if normalization == 'batch':
        scale = scale / data.shape[0]
    # the JAX op carries the scale as an array of the data's dtype
    scale = float(torch.tensor(scale, dtype=data.dtype))
    return _SoftmaxOutput.apply(data, label, scale, ignore_label,
                                bool(use_ignore), bool(multi_output))


@_reg
def softmax_output(data, label, **kwargs):
    return SoftmaxOutput(data, label, **kwargs)


def SliceChannel(data, num_outputs, axis=1, squeeze_axis=False):
    """Split along an axis into ``num_outputs`` parts (ref:
    src/operator/slice_channel.cc)."""
    parts = torch.split(data, data.shape[axis] // int(num_outputs),
                        dim=axis)
    if squeeze_axis:
        parts = [p.squeeze(axis) for p in parts]
    return tuple(parts)


def slice_channel(data, num_outputs, axis=1, squeeze_axis=False):
    return SliceChannel(data, num_outputs, axis=axis,
                        squeeze_axis=squeeze_axis)


_reg(SliceChannel, num_outputs=-1)
_reg(slice_channel, num_outputs=-1)


def _regression(link, grad_fn):
    class _Regression(torch.autograd.Function):
        @staticmethod
        def forward(ctx, data, label, grad_scale):
            out = link(data)
            ctx.save_for_backward(out, label)
            ctx.grad_scale = grad_scale
            return out

        @staticmethod
        def backward(ctx, _ct):
            out, label = ctx.saved_tensors
            g = grad_fn(out, label.reshape(out.shape).to(out.dtype))
            return (g * ctx.grad_scale, torch.zeros_like(label), None)

    def op(data, label, grad_scale=1.0):
        return _Regression.apply(data, label.to(data.dtype),
                                 float(grad_scale))
    return op


_linear = _regression(lambda x: x.view_as(x), lambda out, lab: out - lab)
_mae = _regression(lambda x: x.view_as(x),
                   lambda out, lab: torch.sign(out - lab))
_logistic = _regression(torch.sigmoid, lambda out, lab: out - lab)


@_reg
def linear_regression_output(data, label, grad_scale=1.0):
    """Identity forward; backward (pred - label) * grad_scale (ref:
    regression_output.cc LinearRegressionOutput)."""
    return _linear(data, label, grad_scale)


@_reg
def mae_regression_output(data, label, grad_scale=1.0):
    """Identity forward; backward sign(pred - label) * grad_scale."""
    return _mae(data, label, grad_scale)


@_reg
def logistic_regression_output(data, label, grad_scale=1.0):
    """Sigmoid forward; backward (sigmoid(x) - label) * grad_scale."""
    return _logistic(data, label, grad_scale)
