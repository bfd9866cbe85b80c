"""Neural-network ops on the BERT serving and training paths (counterpart
of ``mxnet_tpu/ops/nn.py``), with the JAX package's arithmetic:

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
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..base import MXNetError, register_op, state, torch_dtype
from .. import config as _config
from .. import random as _random

__all__ = ['fully_connected', 'activation', 'layer_norm', 'add_layer_norm',
           'dense_gelu', 'embedding', 'softmax', 'log_softmax', 'dropout',
           'dropout_op', 'one_hot', 'blockgrad']


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
    if _config.get('MXTPU_PALLAS_LN') and x.is_cuda:
        from .fused_layernorm import fused_add_layer_norm
        return fused_add_layer_norm(x, res, gamma, beta, eps)
    return layer_norm(x + res, gamma, beta, eps=eps)


def dense_gelu(x, weight, bias):
    """FFN1: gelu(x @ W.T + b). With ``MXTPU_PALLAS_FFN=1`` and CUDA
    tensors it is the fused CUDA kernel (ops/fused_ffn.py); otherwise the
    plain Dense-then-GELU path."""
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
    with mode='clip' does. ``input_dim``, ``output_dim``, ``dtype`` and
    ``sparse_grad`` are MXNet's and change nothing here."""
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


def dropout(data, p=0.5, training=False, generator=None):
    """Zero each element with probability ``p`` and scale the rest by
    1/(1-p), active only when ``training``. The keep mask is drawn from
    ``generator``, which must live on data's device (None draws from that
    device's default generator)."""
    if not training or p <= 0.0:
        return data
    if generator is not None and generator.device.type != data.device.type:
        raise MXNetError(f"dropout: generator on {generator.device} for a "
                         f"tensor on {data.device}; the noise is drawn on "
                         f"the tensor's device")
    keep = 1.0 - p
    mask = (torch.rand(data.shape, generator=generator, device=data.device)
            < keep).to(data.dtype)
    return data * mask / keep


def dropout_op(data, p=0.5, mode='training', axes=(), cudnn_off=False):
    """``nd.dropout`` (ref: src/operator/nn/dropout.cc): active only in
    autograd train mode or with ``mode='always'``; ``axes`` share one mask
    value along each listed axis."""
    if not (state.is_training or mode == 'always') or p <= 0.0:
        return data
    keep = 1.0 - p
    shape = list(data.shape)
    for a in axes:
        shape[a] = 1
    mask = (torch.rand(shape, generator=_random.generator(data.device),
                       device=data.device) < keep).to(data.dtype)
    return data * mask / keep


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
