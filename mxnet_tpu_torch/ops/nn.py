"""Neural-network ops (counterpart of ``mxnet_tpu/ops/nn.py``), with the
JAX package's arithmetic:

- ``fully_connected`` accumulates in f32 and casts to the input dtype
  before the bias is added;
- ``layer_norm`` takes its statistics in f32, casts the normalised value
  to the data dtype and only then applies gamma and beta;
- ``add_layer_norm`` and ``dense_gelu`` are the two seams the fused
  kernels take: the kernel runs when its knob is on and the tensors are
  on CUDA, the plain math otherwise. The kernels take any C (LayerNorm)
  and any M, N, K (FFN1), so the TPU's ``C % 128`` lane rule is dropped;
  their own checks (dtype, contiguity) raise rather than fall back;
- ``dropout`` is active only in training (the module's ``training`` flag
  stands in for the JAX package's autograd train mode) and computes
  ``x * mask / keep`` with the mask drawn on x's device.

The NDArray-level ops (``mx.nd.<name>``) are registered under the JAX
package's names and signatures. Where Gluon's tensor-level function has
another signature, the registered op is a separate function:
``dropout_op`` is ``nd.dropout(data, p, mode, axes)``, active in autograd
train mode or with ``mode='always'``, its mask drawn from the generator
of the input's device (``random.generator``).

The vision ops (``convolution``, ``deconvolution``, ``pooling``,
``batch_norm``, ``instance_norm``, ``group_norm``), which the JAX package
leaves to XLA, are stock PyTorch ops here (cuDNN on the card):

- ``convolution``/``deconvolution`` accumulate in f32 and return the data
  dtype (cuDNN and the CPU kernels do so for bf16); the bias is added in
  the same kernel, before that rounding, where the JAX package rounds
  first and adds the bias in the data dtype (the same in f32);
- ``pooling``: the 'full' (ceil) convention by explicit right padding, as
  the JAX package pads, so a last window that starts in the padding is
  kept (torch's ``ceil_mode`` drops it); 'avg' divides by the whole
  window with ``count_include_pad``, else by the cells inside the input;
- ``batch_norm`` normalises with the batch's biased variance in training
  mode and returns the new running statistics, updated with the biased
  batch variance and ``momentum`` the share of the old value, in the
  statistics' dtype, as ``mxnet_tpu/ops/nn.py:282-293`` does (torch's
  own update uses the unbiased variance and ``1 - momentum``). One
  ``torch.native_batch_norm`` call normalises and returns the batch's
  mean and 1/sqrt(var + eps), taken in f32 (the JAX package takes them
  in the data's dtype); the variance for the update is recovered from
  the latter, so the data is read once;
- ``sync_batch_norm_op`` (SyncBatchNorm's op) takes the batch's moments
  over the data axis of the world, ``psum`` of the per-channel sum and
  sum of squares and the count, the JAX op's arithmetic (biased variance
  as E[x^2] - mean^2, in f32). Its backward all-reduces the two
  per-channel gradient sums the normalisation needs (in JAX, autodiff
  through ``psum`` gives that); gamma's and beta's gradients are the
  rank's own rows' (the step's or Trainer's reduction sums them).

The sequence ops, plain PyTorch as the JAX package computes them outside
any Pallas kernel:

- ``rnn`` (``nd.rnn``, MXNet's fused RNN op): a Python loop over time
  per layer and direction, the inputs projected once per layer;
- ``ctc_loss`` (``nd.ctc_loss``): the log-alpha recursion over time, its
  gradient from autograd through the loop. Labels are padded as MXNet
  documents, which the JAX op does not follow (see its docstring).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..base import MXNetError, register_op, state, torch_dtype
from .. import config as _config
from .. import random as _random
from . import rowsparse as _rowsparse

__all__ = ['fully_connected', 'activation', 'layer_norm', 'add_layer_norm',
           'dense_gelu', 'embedding', 'softmax', 'log_softmax', 'dropout',
           'dropout_op', 'one_hot', 'blockgrad', 'identity', 'convolution',
           'deconvolution', 'pooling', 'leaky_relu', 'batch_norm',
           'instance_norm', 'group_norm', 'softmax_cross_entropy',
           'sync_batch_norm_op', 'rnn', 'ctc_loss']


def _tensor(x):
    # a Gluon Parameter passed where a tensor is expected (models/bert.py
    # hands its layers' parameters to the fused seams)
    return getattr(x, 'tensor', x)


@register_op()
def fully_connected(data, weight, bias=None, num_hidden=None, no_bias=False,
                    flatten=True):
    """y = x W^T + b; weight is (num_hidden, in_dim). The product
    accumulates in f32 (full-precision f32 matmul, f32 accumulation for
    bf16) and comes back in the data dtype."""
    if flatten and data.dim() > 2:
        data = data.reshape(data.shape[0], -1)
    out = torch.matmul(data, weight.t())
    if bias is not None and not no_bias:
        out = out + bias
    return out


_ACTS = {
    'relu': torch.relu,
    'sigmoid': torch.sigmoid,
    'tanh': torch.tanh,
    'softrelu': F.softplus,
    'softsign': lambda x: x / (1 + torch.abs(x)),
    'gelu': lambda x: F.gelu(x, approximate='none'),
    'gelu_tanh': lambda x: F.gelu(x, approximate='tanh'),
    'silu': F.silu,
}


@register_op()
def activation(data, act_type='relu'):
    if act_type not in _ACTS:
        raise MXNetError(f"unknown act_type {act_type}")
    return _ACTS[act_type](data)


@register_op()
def layer_norm(data, gamma, beta, axis=-1, eps=1e-5):
    """Normalises over ``axis`` only: f32 statistics, cast, then affine."""
    f32 = data.to(torch.float32)
    mean = f32.mean(axis, keepdim=True)
    var = f32.var(axis, unbiased=False, keepdim=True)
    out = ((f32 - mean) * torch.rsqrt(var + eps)).to(data.dtype)
    shape = [1] * data.dim()
    shape[axis % data.dim()] = data.shape[axis % data.dim()]
    return out * gamma.reshape(shape) + beta.reshape(shape)


def add_layer_norm(x, res, gamma, beta, eps=1e-5):
    """LN(x + res), the transformer residual epilogue. With
    ``MXTPU_PALLAS_LN=1`` and CUDA tensors it is the fused Triton kernel
    (ops/fused_layernorm.py); otherwise the plain path."""
    gamma, beta = _tensor(gamma), _tensor(beta)
    if _config.get('MXTPU_PALLAS_LN') and x.is_cuda:
        from .fused_layernorm import fused_add_layer_norm
        return fused_add_layer_norm(x, res, gamma, beta, eps)
    return layer_norm(x + res, gamma, beta, eps=eps)


def dense_gelu(x, weight, bias):
    """FFN1: gelu(x @ W.T + b). With ``MXTPU_PALLAS_FFN=1`` and CUDA
    tensors it is the fused CUDA kernel (ops/fused_ffn.py); otherwise the
    plain Dense-then-GELU path."""
    weight, bias = _tensor(weight), _tensor(bias)
    if _config.get('MXTPU_PALLAS_FFN') and x.is_cuda:
        from .fused_ffn import fused_dense_gelu
        return fused_dense_gelu(x, weight, bias)
    return activation(fully_connected(x, weight, bias,
                                      num_hidden=weight.shape[0],
                                      flatten=False), act_type='gelu')


@register_op()
def embedding(data, weight, input_dim=0, output_dim=0, dtype='float32',
              sparse_grad=False):
    """Row gather; out-of-range ids clamp to the table, as ``jnp.take``
    with mode='clip' does (ref: src/operator/tensor/indexing_op.cc
    Embedding). Routed as the JAX op routes it: a table the compiled
    step has armed a RowSparse capture for (``sparse_grad``, matched by
    identity) records its live rows and takes the row tangent; any other
    2-D table goes through the dedup-first lookup, whose backward
    segment-sums repeated ids before the table-shaped write
    (``ops/rowsparse.py``). ``input_dim``, ``output_dim``, ``dtype`` and
    ``sparse_grad`` are MXNet's: the gradient's storage type is the
    parameter's (``grad_stype``)."""
    slot = _rowsparse.lookup_capture(weight)
    if slot is not None:
        return slot.lookup(data)
    if weight.dim() == 2 and data.numel() > 0:
        return _rowsparse.dedup_take(weight, data)
    idx = data.to(torch.int64).clamp(0, weight.shape[0] - 1)
    return weight[idx]


@register_op()
def softmax(data, axis=-1, temperature=None, length=None):
    """Softmax over ``axis``; ``length`` (one valid length per row) masks
    the positions past it to 0 (ref: src/operator/nn/softmax.cc)."""
    if temperature is not None and temperature != 1.0:
        data = data / temperature
    if length is None:
        return torch.softmax(data, dim=axis)
    axis = axis % data.dim()
    shape = [1] * data.dim()
    shape[axis] = data.shape[axis]
    pos = torch.arange(data.shape[axis], device=data.device).reshape(shape)
    mask = pos < length.reshape(length.shape + (1,) * (data.dim() -
                                                        length.dim()))
    out = torch.softmax(data.masked_fill(~mask, float('-inf')), dim=axis)
    return out.masked_fill(~mask, 0.0)


@register_op()
def log_softmax(data, axis=-1, temperature=None):
    if temperature is not None and temperature != 1.0:
        data = data / temperature
    return torch.log_softmax(data, dim=axis)


def dropout(data, p=0.5, training=False, generator=None, axes=()):
    """Zero each element with probability ``p`` and scale the rest by
    1/(1-p), active only when ``training``; ``axes`` share one mask value
    along each listed axis. The keep mask is drawn from ``generator``,
    which must live on data's device (None draws from that device's
    default generator)."""
    if not training or p <= 0.0:
        return data
    if generator is not None and generator.device.type != data.device.type:
        raise MXNetError(f"dropout: generator on {generator.device} for a "
                         f"tensor on {data.device}; the noise is drawn on "
                         f"the tensor's device")
    keep = 1.0 - p
    shape = list(data.shape)
    for a in axes:
        shape[a] = 1
    mask = (torch.rand(shape, generator=generator, device=data.device)
            < keep).to(data.dtype)
    return data * mask / keep


def dropout_op(data, p=0.5, mode='training', axes=(), cudnn_off=False):
    """``nd.dropout`` (ref: src/operator/nn/dropout.cc): active only in
    autograd train mode or with ``mode='always'``, drawing from the port's
    generator of the input's device."""
    return dropout(data, p, state.is_training or mode == 'always',
                   _random.generator(data.device), axes)


register_op('dropout')(dropout_op)


@register_op()
def one_hot(indices, depth=0, on_value=1.0, off_value=0.0, dtype='float32'):
    """Rows of ``depth`` values; an index outside [0, depth) gives a row
    of ``off_value``, as ``jax.nn.one_hot`` does."""
    idx = indices.to(torch.int64)
    oh = (idx.unsqueeze(-1) == torch.arange(depth, device=idx.device)
          ).to(torch_dtype(dtype))
    return oh * (on_value - off_value) + off_value


@register_op()
def blockgrad(data):
    return data.detach()


@register_op()
def identity(data):
    return data


def _tup(v, n):
    if v is None:
        return (0,) * n
    if isinstance(v, int):
        return (v,) * n
    v = tuple(int(x) for x in v)
    return v * n if len(v) == 1 else v


_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}
_CONV_T = {1: F.conv_transpose1d, 2: F.conv_transpose2d,
           3: F.conv_transpose3d}


@register_op()
def convolution(data, weight, bias=None, kernel=None, stride=None,
                dilate=None, pad=None, num_filter=0, num_group=1,
                no_bias=False, layout='NCHW'):
    """1D/2D/3D convolution over (N, C, *spatial), weight (O, C/g, *k)
    (ref: src/operator/nn/convolution.cc)."""
    nd = data.dim() - 2
    stride = _tup(stride, nd) if stride is not None else (1,) * nd
    dilate = _tup(dilate, nd) if dilate is not None else (1,) * nd
    b = None if no_bias or bias is None else bias
    return _CONV[nd](data, weight, b, stride=stride, padding=_tup(pad, nd),
                     dilation=dilate, groups=num_group)


@register_op()
def deconvolution(data, weight, bias=None, kernel=None, stride=None,
                  dilate=None, pad=None, adj=None, num_filter=0,
                  num_group=1, no_bias=False, target_shape=None,
                  layout='NCHW'):
    """Transposed convolution, weight (C_in, O/g, *k), ``adj`` extra rows
    on the right (ref: src/operator/nn/deconvolution.cc)."""
    nd = data.dim() - 2
    stride = _tup(stride, nd) if stride is not None else (1,) * nd
    dilate = _tup(dilate, nd) if dilate is not None else (1,) * nd
    adj = _tup(adj, nd) if adj is not None else (0,) * nd
    b = None if no_bias or bias is None else bias
    return _CONV_T[nd](data, weight, b, stride=stride,
                       padding=_tup(pad, nd), output_padding=adj,
                       groups=num_group, dilation=dilate)


_MAX_POOL = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}
_AVG_POOL = {1: F.avg_pool1d, 2: F.avg_pool2d, 3: F.avg_pool3d}


@register_op()
def pooling(data, kernel=None, pool_type='max', global_pool=False,
            stride=None, pad=None, pooling_convention='valid',
            count_include_pad=True, layout='NCHW'):
    """Max/avg/sum/lp pooling over (N, C, *spatial) (ref:
    src/operator/nn/pooling.cc); see the module docstring for the edges."""
    nd = data.dim() - 2
    axes = tuple(range(2, 2 + nd))
    if global_pool:
        if pool_type == 'max':
            return data.amax(dim=axes, keepdim=True)
        return data.mean(dim=axes, keepdim=True)
    kernel = _tup(kernel, nd)
    stride = _tup(stride, nd) if stride is not None else (1,) * nd
    pad = _tup(pad, nd)
    extra = [0] * nd
    if pooling_convention == 'full':
        for i in range(nd):
            size = data.shape[2 + i] + 2 * pad[i]
            out = -(-(size - kernel[i]) // stride[i]) + 1
            extra[i] = max(0, (out - 1) * stride[i] + kernel[i] - size)
    if pool_type == 'max':
        if not any(extra) and all(2 * p <= k for p, k in zip(pad, kernel)):
            return _MAX_POOL[nd](data, kernel, stride, padding=pad)
        fill = float('-inf') if data.is_floating_point() else \
            torch.iinfo(data.dtype).min
        return _MAX_POOL[nd](_pad_right(data, pad, extra, fill), kernel,
                             stride)
    if pool_type not in ('avg', 'sum', 'lp'):
        raise MXNetError(f"unknown pool_type {pool_type}")
    window = math.prod(kernel)
    src = data.abs() ** 2 if pool_type == 'lp' else data
    summed = _AVG_POOL[nd](_pad_right(src, pad, extra, 0.0), kernel,
                           stride) * window
    if pool_type == 'sum':
        return summed
    if pool_type == 'lp':
        return summed ** 0.5
    if count_include_pad:
        return summed / window
    ones = torch.ones((1, 1) + tuple(data.shape[2:]), dtype=data.dtype,
                      device=data.device)
    counts = _AVG_POOL[nd](_pad_right(ones, pad, extra, 0.0), kernel,
                           stride) * window
    return summed / counts


def _pad_right(x, pad, extra, value):
    """x padded by ``pad`` on both sides of each spatial axis and
    ``extra`` more on the right."""
    flat = []
    for p, e in zip(reversed(pad), reversed(extra)):
        flat += [p, p + e]
    if not any(flat):
        return x
    return F.pad(x, flat, mode='constant', value=value)


_SELU_ALPHA, _SELU_SCALE = 1.6732632423543772, 1.0507009873554805


@register_op()
def leaky_relu(data, gamma=None, act_type='leaky', slope=0.25,
               lower_bound=0.125, upper_bound=0.334):
    """leaky/prelu/elu/selu/gelu/rrelu (ref: src/operator/leaky_relu.cc);
    rrelu draws its slopes from the input device's generator in autograd
    train mode."""
    if act_type == 'leaky':
        return torch.where(data >= 0, data, slope * data)
    if act_type == 'prelu':
        g = gamma
        if g.dim() == 1 and data.dim() > 1:
            g = g.reshape((1, -1) + (1,) * (data.dim() - 2))
        return torch.where(data >= 0, data, g * data)
    if act_type == 'elu':
        return torch.where(data >= 0, data, slope * torch.expm1(data))
    if act_type == 'selu':
        return _SELU_SCALE * torch.where(data >= 0, data,
                                         _SELU_ALPHA * torch.expm1(data))
    if act_type == 'gelu':
        return F.gelu(data, approximate='none')
    if act_type == 'rrelu':
        if state.is_training:
            s = torch.rand(data.shape, generator=_random.generator(
                data.device), device=data.device, dtype=data.dtype)
            s = s * (upper_bound - lower_bound) + lower_bound
        else:
            s = (lower_bound + upper_bound) / 2.0
        return torch.where(data >= 0, data, s * data)
    raise MXNetError(f"unknown act_type {act_type}")


@register_op(num_outputs=3)
def batch_norm(data, gamma, beta, moving_mean, moving_var, eps=1e-3,
               momentum=0.9, fix_gamma=True, use_global_stats=False,
               output_mean_var=False, axis=1, training=None):
    """(out, new moving mean, new moving var) (ref:
    src/operator/nn/batch_norm.cc). ``training`` (default: autograd train
    mode) normalises with the batch's statistics and updates the moving
    ones; otherwise the moving ones normalise and come back unchanged.
    The new statistics carry no gradient."""
    if training is None:
        training = state.is_training
    axis = axis % data.dim()
    if axis != 1:
        out, m, v = batch_norm(data.movedim(axis, 1), gamma, beta,
                               moving_mean, moving_var, eps, momentum,
                               fix_gamma, use_global_stats, output_mean_var,
                               1, training)
        return out.movedim(1, axis), m, v
    # fix_gamma: gamma is 1 (and gets no gradient); a ones weight rather
    # than none, which the CUDA backward does not take
    weight = torch.ones_like(gamma).detach() if fix_gamma else gamma
    if not training or use_global_stats:
        out = torch.batch_norm(data, weight, beta, moving_mean, moving_var,
                               False, 0.0, eps, False)
        return out, moving_mean, moving_var
    out, mean, invstd = torch.native_batch_norm(data, weight, beta, None,
                                                None, True, 0.0, eps)
    with torch.no_grad():
        var = invstd.detach().double().pow(-2).sub(eps).clamp_min(0)
        mean = mean.detach().to(moving_mean.dtype)
        var = var.to(moving_var.dtype)
        new_mean = momentum * moving_mean + (1 - momentum) * mean
        new_var = momentum * moving_var + (1 - momentum) * var
    return out, new_mean, new_var


class _SyncBatchNorm(torch.autograd.Function):
    """Normalisation by the world's batch moments over channel dim 1;
    returns (out, mean, biased var), the last two without gradient."""

    @staticmethod
    def forward(ctx, x, gamma, beta, eps):
        from ..parallel import collectives as _coll
        dims = [0] + list(range(2, x.dim()))
        x32 = x.float()
        n_local = x.numel() // x.shape[1]
        stats = torch.cat([x32.sum(dims), x32.square().sum(dims),
                           x32.new_full((1,), float(n_local))])
        _coll.all_reduce_(stats)
        c = x.shape[1]
        n = stats[2 * c]
        mean = stats[:c] / n
        var = stats[c:2 * c] / n - mean.square()
        invstd = torch.rsqrt(var + eps)
        shape = (1, c) + (1,) * (x.dim() - 2)
        xhat = (x32 - mean.reshape(shape)) * invstd.reshape(shape)
        out = xhat * gamma.float().reshape(shape) + \
            beta.float().reshape(shape)
        ctx.save_for_backward(xhat, invstd, gamma, n)
        ctx.mark_non_differentiable(mean, var)
        return out.to(x.dtype), mean, var

    @staticmethod
    def backward(ctx, dout, _dmean, _dvar):
        from ..parallel import collectives as _coll
        xhat, invstd, gamma, n = ctx.saved_tensors
        dims = [0] + list(range(2, xhat.dim()))
        dy = dout.float()
        c = xhat.shape[1]
        local = torch.cat([dy.sum(dims), (dy * xhat).sum(dims)])
        dbeta, dgamma = local[:c].clone(), local[c:].clone()
        _coll.all_reduce_(local)
        shape = (1, c) + (1,) * (xhat.dim() - 2)
        dx = (gamma.float() * invstd).reshape(shape) / n * (
            n * dy - local[:c].reshape(shape) -
            xhat * local[c:].reshape(shape))
        return (dx.to(dout.dtype), dgamma.to(gamma.dtype),
                dbeta.to(gamma.dtype), None)


@register_op(num_outputs=3)
def sync_batch_norm_op(data, gamma, beta, moving_mean, moving_var,
                       axis_name=None, eps=1e-3, momentum=0.9,
                       fix_gamma=False, use_global_stats=False, axis=1,
                       training=None):
    """Cross-device BatchNorm (ref: src/operator/contrib/sync_batch_norm.cc;
    ``mxnet_tpu/ops/nn.py`` ``sync_batch_norm_op``): in training the batch
    statistics are the world's, reduced over ``axis_name``; with no axis
    or a world of one it is ``batch_norm``. Returns (out, new moving mean,
    new moving var)."""
    from ..parallel import collectives as _coll
    if training is None:
        training = state.is_training
    if axis_name is None or _coll.axis_size(axis_name) == 1 or \
            not training or use_global_stats:
        return batch_norm(data, gamma, beta, moving_mean, moving_var, eps,
                          momentum, fix_gamma, use_global_stats, False, axis,
                          training)
    axis = axis % data.dim()
    x = data.movedim(axis, 1) if axis != 1 else data
    if fix_gamma:
        gamma = torch.ones_like(gamma)
    out, mean, var = _SyncBatchNorm.apply(x, gamma, beta, float(eps))
    with torch.no_grad():
        new_mean = momentum * moving_mean + \
            (1 - momentum) * mean.to(moving_mean.dtype)
        new_var = momentum * moving_var + \
            (1 - momentum) * var.to(moving_var.dtype)
    return (out.movedim(1, axis) if axis != 1 else out), new_mean, new_var


@register_op()
def instance_norm(data, gamma, beta, eps=1e-3):
    """Normalise each (sample, channel) over its spatial axes (ref:
    src/operator/instance_norm.cc)."""
    axes = tuple(range(2, data.dim()))
    mean = data.mean(dim=axes, keepdim=True)
    var = data.var(dim=axes, correction=0, keepdim=True)
    out = (data - mean) * torch.rsqrt(var + eps)
    shape = (1, data.shape[1]) + (1,) * (data.dim() - 2)
    return out * gamma.reshape(shape) + beta.reshape(shape)


@register_op()
def group_norm(data, gamma, beta, num_groups=1, eps=1e-5):
    """Normalise each group of channels of a sample (ref:
    src/operator/nn/group_norm.cc)."""
    n, c = data.shape[:2]
    x = data.reshape((n, num_groups, c // num_groups) + data.shape[2:])
    axes = tuple(range(2, x.dim()))
    mean = x.mean(dim=axes, keepdim=True)
    var = x.var(dim=axes, correction=0, keepdim=True)
    x = ((x - mean) * torch.rsqrt(var + eps)).reshape(data.shape)
    shape = (1, c) + (1,) * (data.dim() - 2)
    return x * gamma.reshape(shape) + beta.reshape(shape)


@register_op()
def softmax_cross_entropy(data, label):
    """Summed cross entropy of softmax(data) against integer labels (ref:
    src/operator/softmax_output.cc)."""
    logp = torch.log_softmax(data, dim=-1)
    return -logp.gather(-1, label.to(torch.int64)[..., None]).sum()


_RNN_GATES = {'rnn_relu': 1, 'rnn_tanh': 1, 'lstm': 4, 'gru': 3}


def _rnn_step(mode, xp, h, c, w_h2h, b_h2h, clip):
    """One time step of one layer and direction: ``xp`` is the step's
    input projection with the i2h bias, (N, G*H)."""
    hh = torch.addmm(b_h2h, h, w_h2h.t())
    if mode == 'lstm':
        i, f, g, o = (xp + hh).chunk(4, dim=-1)
        new_c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        if clip is not None:
            new_c = new_c.clamp(*clip)
        return torch.sigmoid(o) * torch.tanh(new_c), new_c
    if mode == 'gru':
        # MXNet's gate order r, z, n; r scales the h2h part of n only
        xr, xz, xn = xp.chunk(3, dim=-1)
        hr, hz, hn = hh.chunk(3, dim=-1)
        r = torch.sigmoid(xr + hr)
        z = torch.sigmoid(xz + hz)
        n = torch.tanh(xn + r * hn)
        return (1 - z) * n + z * h, c
    gates = xp + hh
    return (torch.tanh(gates) if mode == 'rnn_tanh' else
            torch.relu(gates)), c


@register_op()
def rnn(data, params, state, state_cell=None, state_size=0, num_layers=1,
        mode='lstm', bidirectional=False, p=0.0, projection_size=None,
        lstm_state_clip_min=None, lstm_state_clip_max=None,
        use_sequence_length=False, sequence_length=None):
    """Fused multi-layer RNN (ref: src/operator/rnn.cc; the JAX package's
    ``ops/nn.py`` ``rnn``). Returns (out, h) or, for 'lstm', (out, h, c).

    data: (T, N, I). params: one flat vector, all weights first
    (layer-major, direction-minor, i2h then h2h, each (G*H, in)), then all
    biases in the same order. state and state_cell: (L*D, N, H).

    Each layer projects its whole input once, then loops over time (the
    second direction backwards, its outputs in the input's order); the
    next layer reads the directions' outputs side by side. Between layers,
    in autograd train mode, dropout ``p`` draws from the port's generator
    of the data's device. ``projection_size``, ``use_sequence_length`` and
    ``sequence_length`` are accepted and ignored, as in the JAX op."""
    from ..base import state as flags
    T, N, I = data.shape
    H, L = state_size, num_layers
    D = 2 if bidirectional else 1
    G = _RNN_GATES[mode]
    clip = None if lstm_state_clip_min is None else (lstm_state_clip_min,
                                                     lstm_state_clip_max)
    sizes = []
    for layer in range(L):
        n_in = I if layer == 0 else H * D
        sizes += [(G * H, n_in), (G * H, H)] * D
    sizes += [(G * H,)] * (2 * L * D)
    pieces = params.split([math.prod(s) for s in sizes])
    pieces = [t.reshape(s) for t, s in zip(pieces, sizes)]
    weights, biases = pieces[:2 * L * D], pieces[2 * L * D:]
    x = data
    hs, cs = [], []
    for layer in range(L):
        outs = []
        for d in range(D):
            idx = layer * D + d
            w_i2h, w_h2h = weights[2 * idx:2 * idx + 2]
            b_i2h, b_h2h = biases[2 * idx:2 * idx + 2]
            xp = torch.matmul(x, w_i2h.t()) + b_i2h
            h = state[idx]
            c = state_cell[idx] if state_cell is not None else \
                torch.zeros_like(h)
            ys = [None] * T
            for t in (range(T - 1, -1, -1) if d == 1 else range(T)):
                h, c = _rnn_step(mode, xp[t], h, c, w_h2h, b_h2h, clip)
                ys[t] = h
            outs.append(torch.stack(ys))
            hs.append(h)
            cs.append(c)
        x = outs[0] if D == 1 else torch.cat(outs, dim=-1)
        if p > 0 and layer < L - 1 and flags.is_training:
            x = dropout(x, p, True, _random.generator(x.device))
    if mode == 'lstm':
        return x, torch.stack(hs), torch.stack(cs)
    return x, torch.stack(hs)


_CTC_NEG = -1e30


@register_op()
def ctc_loss(data, label, data_lengths=None, label_lengths=None,
             use_data_lengths=False, use_label_lengths=False,
             blank_label='first'):
    """CTC loss (ref: src/operator/nn/ctc_loss.cc; the JAX package's
    ``ops/nn.py`` ``ctc_loss``): one -log p(label | data) per sequence.
    data: (T, N, C) logits (softmax inside), label: (N, L).

    Padding follows MXNet's documentation: with ``blank_label='first'``
    the blank is 0 and a label counts when it is > 0 (0 and -1 pad); with
    ``'last'`` the blank is C - 1 and a label counts when it is >= 0 and
    not the blank (-1 pads, 0 is a class). The JAX op swaps the two rules
    (>= 0 under 'first', > 0 under 'last'), so under 'last' it drops
    every label 0; the port does not copy that.

    The log-alpha recursion over the extended sequence (blank, l1, blank,
    l2, ..., blank) runs as a loop over time; with ``use_data_lengths``
    a sequence's alphas stop moving after its length."""
    T, N, C = data.shape
    L = label.shape[1]
    lab = label.to(device=data.device, dtype=torch.int64)
    if blank_label == 'first':
        blank = 0
        lab_valid = lab > 0
    else:
        blank = C - 1
        lab_valid = (lab >= 0) & (lab != blank)
    if use_label_lengths and label_lengths is not None:
        lab_len = label_lengths.to(device=data.device, dtype=torch.int64)
    else:
        lab_len = lab_valid.sum(1)
    lab = torch.where(lab_valid, lab, blank)
    logp = torch.log_softmax(data, dim=-1)
    S = 2 * L + 1
    ext = torch.full((N, S), blank, dtype=torch.int64, device=data.device)
    ext[:, 1::2] = lab
    neg = data.new_full((N, 2), _CTC_NEG)
    alpha = torch.cat([logp[0, :, blank:blank + 1],
                       logp[0].gather(1, ext[:, 1:2]),
                       data.new_full((N, S - 2), _CTC_NEG)], dim=1)
    same_as_prev2 = torch.cat([torch.ones((N, 2), dtype=torch.bool,
                                          device=data.device),
                               ext[:, 2:] == ext[:, :-2]], dim=1)
    dlen = data_lengths.to(device=data.device, dtype=torch.int64) \
        if use_data_lengths and data_lengths is not None else None
    for t in range(1, T):
        a1 = torch.cat([neg[:, :1], alpha[:, :-1]], dim=1)
        a2 = torch.cat([neg, alpha[:, :-2]], dim=1).masked_fill(
            same_as_prev2, _CTC_NEG)
        m = torch.maximum(torch.maximum(alpha, a1), a2)
        new = m + torch.log(torch.exp(alpha - m) + torch.exp(a1 - m) +
                            torch.exp(a2 - m)) + logp[t].gather(1, ext)
        alpha = new if dlen is None else \
            torch.where((t < dlen)[:, None], new, alpha)
    ext_len = 2 * lab_len + 1
    a1 = alpha.gather(1, (ext_len - 1)[:, None])[:, 0]
    a2 = alpha.gather(1, (ext_len - 2).clamp_min(0)[:, None])[:, 0]
    m = torch.maximum(a1, a2)
    return -(m + torch.log(torch.exp(a1 - m) + torch.exp(a2 - m)))
