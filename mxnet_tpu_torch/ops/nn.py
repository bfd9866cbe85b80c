"""Neural-network ops on the BERT serving path (counterpart of
``mxnet_tpu/ops/nn.py``), with the JAX package's arithmetic:

- ``fully_connected`` accumulates in f32 and casts to the input dtype
  before the bias is added;
- ``layer_norm`` takes its statistics in f32, casts the normalised value
  to the data dtype and only then applies gamma and beta;
- ``add_layer_norm`` and ``dense_gelu`` are the two seams the fused
  kernels take: the kernel runs when its knob is on and the tensors are
  on CUDA, the plain math otherwise. The kernels take any C (LayerNorm)
  and any M, N, K (FFN1), so the TPU's ``C % 128`` lane rule is dropped;
  their own checks (dtype, contiguity) raise rather than fall back.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..base import MXNetError
from .. import config as _config

__all__ = ['fully_connected', 'activation', 'layer_norm', 'add_layer_norm',
           'dense_gelu', 'embedding']


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


def activation(data, act_type='relu'):
    if act_type not in _ACTS:
        raise MXNetError(f"unknown act_type {act_type}")
    return _ACTS[act_type](data)


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


def embedding(data, weight):
    """Row gather; out-of-range ids clamp to the table, as ``jnp.take``
    with mode='clip' does."""
    idx = data.to(torch.int64).clamp(0, weight.shape[0] - 1)
    return weight[idx]
