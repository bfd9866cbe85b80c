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

``round_ste``/``sign_ste`` round or take the sign forward and pass the
head gradient straight through.

The contrib long tail (ref: contrib/{fft,ifft,count_sketch,quadratic_op,
hawkes_ll,nnz,allclose_op}.cc, l2_normalization.cc, instance_norm.cc):
``fft``/``ifft`` (the interleaved [re, im] layout), ``count_sketch``,
``quadratic``, ``hawkes_ll`` (a Python loop over the T steps, each step
batched), ``nnz``, ``allclose``, ``L2Normalization`` and
``InstanceNorm``.

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
           'logistic_regression_output', 'fft', 'ifft', 'count_sketch',
           'quadratic', 'round_ste', 'sign_ste', 'hawkes_ll', 'nnz',
           'allclose', 'L2Normalization', 'l2_normalization',
           'InstanceNorm']


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


@_reg
def fft(data, compute_size=128):
    """FFT of the last axis; real input, interleaved [re, im] output of
    width 2d (ref: contrib/fft.cc)."""
    out = torch.fft.fft(data.to(torch.complex64), dim=-1)
    inter = torch.stack([out.real, out.imag], dim=-1)
    return inter.reshape(*data.shape[:-1], data.shape[-1] * 2)


@_reg
def ifft(data, compute_size=128):
    """Inverse of ``fft``, unnormalised as the reference's: scale by 1/d
    to recover the signal (ref: contrib/ifft.cc)."""
    d = data.shape[-1] // 2
    c = data.reshape(*data.shape[:-1], d, 2).to(torch.float32)
    comp = torch.complex(c[..., 0], c[..., 1])
    return torch.fft.ifft(comp, dim=-1).real.to(data.dtype) * d


@_reg
def count_sketch(data, h, s, out_dim):
    """out[:, h[i]] += s[i] * data[:, i] (ref: contrib/count_sketch.cc)."""
    n, in_dim = data.shape
    hh = h.reshape(-1)[:in_dim].to(torch.int64)
    ss = s.reshape(-1)[:in_dim].to(data.dtype)
    out = torch.zeros((n, int(out_dim)), dtype=data.dtype,
                      device=data.device)
    return out.index_add(1, hh, data * ss[None, :])


@_reg
def quadratic(data, a=0.0, b=0.0, c=0.0):
    """a*x^2 + b*x + c (ref: contrib/quadratic_op.cc)."""
    return a * data * data + b * data + c


class _StraightThrough(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, fn):
        return fn(x)

    @staticmethod
    def backward(ctx, g):
        return g, None


@_reg
def round_ste(data):
    """Straight-through rounding (ref: contrib/stes_op.cc)."""
    return _StraightThrough.apply(data, torch.round)


@_reg
def sign_ste(data):
    """Straight-through sign (ref: contrib/stes_op.cc)."""
    return _StraightThrough.apply(data, torch.sign)


@_reg
def hawkes_ll(lda, alpha, beta, state, lags, marks, valid_length,
              max_time):
    """Log-likelihood of a marked self-exciting Hawkes process, one
    sample per row (ref: contrib/hawkes_ll.cc): lda (N, K), alpha/beta
    (K,), state (N, K), lags/marks (N, T), valid_length/max_time (N,).
    Returns (ll (N,), new_state (N, K))."""
    N, T = lags.shape
    K = lda.shape[1]
    marks_i = marks.to(torch.int64)
    ll = torch.zeros((N,), dtype=lda.dtype, device=lda.device)
    rem = state
    elapsed = torch.zeros((N,), dtype=lda.dtype, device=lda.device)
    for t in range(T):
        lag = lags[:, t]
        mark = marks_i[:, t]
        valid = (t < valid_length).to(lda.dtype)
        elapsed_new = elapsed + lag
        decay = torch.exp(-beta[None, :] * lag[:, None])
        rem_decayed = rem * decay
        intensity = lda + alpha[None, :] * rem_decayed
        lam = intensity.gather(1, mark[:, None])[:, 0]
        ll_t = torch.log(torch.clamp(lam, min=1e-20))
        comp = (lda * lag[:, None]
                + (alpha / beta)[None, :] * rem * (1.0 - decay)).sum(1)
        ll = ll + valid * (ll_t - comp)
        rem_new = rem_decayed + torch.nn.functional.one_hot(
            mark, K).to(lda.dtype)
        rem = torch.where(valid[:, None] > 0, rem_new, rem)
        elapsed = torch.where(valid > 0, elapsed_new, elapsed)
    tail = torch.clamp(max_time - elapsed, min=0.0)
    decay_tail = 1.0 - torch.exp(-beta[None, :] * tail[:, None])
    comp_tail = (lda * tail[:, None]
                 + (alpha / beta)[None, :] * rem * decay_tail).sum(1)
    ll = ll - comp_tail
    new_state = rem * torch.exp(-beta[None, :] * tail[:, None])
    return ll, new_state


@_reg
def nnz(data, axis=None):
    """Number of non-zeros, int32 as the JAX op gives with x64 off (ref:
    contrib/nnz.cc)."""
    return torch.count_nonzero(data, dim=axis).to(torch.int32)


@_reg
def allclose(a, b, rtol=1e-05, atol=1e-08, equal_nan=True):
    """Scalar 0/1 (ref: contrib/allclose_op.cc)."""
    return torch.as_tensor(torch.allclose(a, b, rtol=rtol, atol=atol,
                                          equal_nan=equal_nan),
                           dtype=torch.float32, device=a.device)


@_reg
def L2Normalization(data, eps=1e-10, mode='instance'):
    """x / sqrt(sum(x^2) + eps) over all but the batch axis ('instance'),
    the channel axis ('channel') or the spatial axes ('spatial') (ref:
    src/operator/l2_normalization.cc)."""
    if mode == 'instance':
        axes = tuple(range(1, data.dim()))
    elif mode == 'channel':
        axes = (1,)
    elif mode == 'spatial':
        axes = tuple(range(2, data.dim()))
    else:
        raise ValueError(f"unknown L2Normalization mode {mode!r}")
    norm = torch.sqrt(torch.sum(data * data, dim=axes, keepdim=True) + eps)
    return data / norm


@_reg
def l2_normalization(data, eps=1e-10, mode='instance'):
    return L2Normalization(data, eps=eps, mode=mode)


@_reg
def InstanceNorm(data, gamma, beta, eps=1e-3):
    """Per-sample, per-channel normalisation over the spatial axes (ref:
    src/operator/instance_norm.cc)."""
    axes = tuple(range(2, data.dim()))
    mean = data.mean(dim=axes, keepdim=True)
    var = data.var(dim=axes, keepdim=True, unbiased=False)
    xhat = (data - mean) / torch.sqrt(var + eps)
    shape = (1, -1) + (1,) * (data.dim() - 2)
    return xhat * gamma.reshape(shape) + beta.reshape(shape)
