"""User kernels and the NDArray program shared by the port's tests and
``chip_smoke.py`` (the JAX package keeps its helpers in
``mxnet_tpu/test_utils.py``).

- ``USER_KERNELS``: CUDA C sources of the user kernels that exercise
  ``mx.rtc`` (the counterparts of the Pallas kernels in
  ``tests/test_rtc.py``), each with its signature, launch geometry and
  plain PyTorch version;
- ``ffn_sgd``: MXNet's imperative API end to end, an FFN block
  ``dot(gelu(dot(x, w1) + b1), w2) + b2`` with a squared-error loss,
  trained by SGD written in NDArrays, its GELU an ``autograd.Function``.
"""
from __future__ import annotations

import math

import numpy as onp
import torch

from . import autograd, nd

__all__ = ['USER_KERNELS', 'RTC_SOURCE', 'launch_user_kernel',
           'rtc_gelu_function', 'PlainGelu', 'FfnSgd', 'ffn_sgd', 'ffn_arrays',
           'gelu_reference', 'gelu_grad_reference']

RTC_SOURCE = r'''
extern "C" __global__ void scale_add(const float *x, const float *y,
                                     float *o, int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) o[i] = 2.0f * x[i] + y[i];
}

// one block per 64-row tile of a (rows, cols) array, as the Pallas
// kernel's BlockSpec((64, cols)) over grid (rows / 64,)
extern "C" __global__ void block_double(const float *x, float *o, int rows,
                                        int cols) {
  long base = (long)blockIdx.x * 64 * cols;
  long end = min((long)rows * cols, base + 64L * cols);
  for (long i = base + threadIdx.x; i < end; i += blockDim.x)
    o[i] = 2.0f * x[i];
}

// one block per row: a strided sum per thread, then a tree in shared
// memory; blockDim.x must be a power of two, at most 1024
extern "C" __global__ void rowsum(const float *x, float *o, int rows,
                                  int cols) {
  __shared__ float part[1024];
  const float *row = x + (long)blockIdx.x * cols;
  float s = 0.0f;
  for (int c = threadIdx.x; c < cols; c += blockDim.x) s += row[c];
  part[threadIdx.x] = s;
  __syncthreads();
  for (int w = blockDim.x / 2; w > 0; w /= 2) {
    if (threadIdx.x < w) part[threadIdx.x] += part[threadIdx.x + w];
    __syncthreads();
  }
  if (threadIdx.x == 0) o[blockIdx.x] = part[0];
}

// erf GELU, f32
extern "C" __global__ void gelu_fwd(const float *x, float *y, int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) {
    float v = x[i];
    y[i] = 0.5f * v * (1.0f + erff(v * 0.70710678118654752f));
  }
}

// d/dx gelu(x) = Phi(x) + x * phi(x)
extern "C" __global__ void gelu_bwd(const float *x, const float *dy,
                                    float *dx, int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) {
    float v = x[i];
    float cdf = 0.5f * (1.0f + erff(v * 0.70710678118654752f));
    float pdf = 0.39894228040143268f * expf(-0.5f * v * v);
    dx[i] = dy[i] * (cdf + v * pdf);
  }
}
'''

_SQRT1_2 = 1.0 / math.sqrt(2.0)
_INV_SQRT_2PI = 1.0 / math.sqrt(2.0 * math.pi)


def gelu_reference(x):
    return 0.5 * x * (1.0 + torch.erf(x * _SQRT1_2))


def gelu_grad_reference(x, dy):
    cdf = 0.5 * (1.0 + torch.erf(x * _SQRT1_2))
    return dy * (cdf + x * _INV_SQRT_2PI * torch.exp(-0.5 * x * x))


def _grid_1d(n, block=256):
    return ((n + block - 1) // block, 1, 1), (block, 1, 1)


# name -> (signature, inputs' count, output shape from the inputs' shapes,
#          launch geometry from the first input's shape, plain version);
# the launch arguments are the inputs, the output, then the ints
USER_KERNELS = {
    'scale_add': dict(
        signature='const float *x, const float *y, float *o, int n',
        n_in=2, out_shape=lambda s: s,
        ints=lambda s: (math.prod(s),),
        geometry=lambda s: _grid_1d(math.prod(s)),
        plain=lambda x, y: 2 * x + y),
    'block_double': dict(
        signature='const float *x, float *o, int rows, int cols',
        n_in=1, out_shape=lambda s: s,
        ints=lambda s: (s[0], s[1]),
        geometry=lambda s: (((s[0] + 63) // 64, 1, 1), (256, 1, 1)),
        plain=lambda x: 2 * x),
    'rowsum': dict(
        signature='const float *x, float *o, int rows, int cols',
        n_in=1, out_shape=lambda s: (s[0], 1),
        ints=lambda s: (s[0], s[1]),
        geometry=lambda s: ((s[0], 1, 1), (256, 1, 1)),
        plain=lambda x: x.sum(1, keepdim=True)),
    'gelu_fwd': dict(
        signature='const float *x, float *y, int n',
        n_in=1, out_shape=lambda s: s,
        ints=lambda s: (math.prod(s),),
        geometry=lambda s: _grid_1d(math.prod(s)),
        plain=gelu_reference),
    'gelu_bwd': dict(
        signature='const float *x, const float *dy, float *dx, int n',
        n_in=2, out_shape=lambda s: s,
        ints=lambda s: (math.prod(s),),
        geometry=lambda s: _grid_1d(math.prod(s)),
        plain=gelu_grad_reference),
}


def launch_user_kernel(kernel, name, inputs):
    """Launch one of USER_KERNELS on NDArrays ``inputs`` into a fresh
    zero output on their context; returns the output."""
    spec = USER_KERNELS[name]
    shape = inputs[0].shape
    out = nd.zeros(spec['out_shape'](shape), ctx=inputs[0].context)
    grid, block = spec['geometry'](shape)
    kernel.launch(list(inputs) + [out] + list(spec['ints'](shape)),
                  inputs[0].context, grid, block)
    return out


class PlainGelu(autograd.Function):
    """The GELU Function through registered ops (no user kernel)."""

    def forward(self, h):
        self.h = h
        return nd.gelu(h)

    def backward(self, dy):
        return nd.NDArray(gelu_grad_reference(self.h._data, dy._data))


def rtc_gelu_function(module):
    """The slice's GELU Function class: forward and backward are launches
    of ``gelu_fwd``/``gelu_bwd`` from ``module`` (a CudaModule of
    RTC_SOURCE)."""
    fwd = module.get_kernel('gelu_fwd', USER_KERNELS['gelu_fwd']['signature'])
    bwd = module.get_kernel('gelu_bwd', USER_KERNELS['gelu_bwd']['signature'])

    class Gelu(autograd.Function):
        def forward(self, h):
            self.h = h
            y = nd.zeros(h.shape, ctx=h.context)
            fwd.launch([h, y, h.size], h.context,
                       ((h.size + 255) // 256, 1, 1), (256, 1, 1))
            return y

        def backward(self, dy):
            dx = nd.zeros(dy.shape, ctx=dy.context)
            bwd.launch([self.h, dy, dx, dy.size], dy.context,
                       ((dy.size + 255) // 256, 1, 1), (256, 1, 1))
            return dx

    return Gelu


class FfnSgd:
    """y = dot(gelu(dot(x, w1) + b1), w2) + b2 with loss mean((y - t)^2),
    trained by SGD in NDArrays on ``ctx``. ``mx`` is the package whose
    ``nd`` and ``autograd`` run it (this port, or any package with
    MXNet's imperative API)."""

    def __init__(self, mx, ctx, x_np, t_np, params_np, gelu_cls, lr):
        self.nd, self.ag = mx.nd, mx.autograd
        self.x = self.nd.array(x_np, ctx=ctx)
        self.t = self.nd.array(t_np, ctx=ctx)
        self.params = [self.nd.array(a, ctx=ctx) for a in params_np]
        for p in self.params:
            p.attach_grad()
        self.gelu_cls, self.lr = gelu_cls, lr

    def step(self):
        """One recorded forward, backward and SGD update; returns the
        loss NDArray (not synchronised)."""
        nd = self.nd
        w1, b1, w2, b2 = self.params
        with self.ag.record():
            y = nd.dot(self.gelu_cls()(nd.dot(self.x, w1) + b1), w2) + b2
            loss = ((y - self.t) ** 2).mean()
        loss.backward()
        for p in self.params:
            p[:] = p - self.lr * p.grad
        return loss


def ffn_sgd(mx, ctx, x_np, t_np, params_np, gelu_cls, steps, lr):
    """``steps`` steps of FfnSgd. Returns (losses as floats, the first
    step's gradients as numpy arrays, the final parameters as numpy
    arrays)."""
    run = FfnSgd(mx, ctx, x_np, t_np, params_np, gelu_cls, lr)
    losses = [run.step()]
    grads = [p.grad.asnumpy() for p in run.params]
    losses += [run.step() for _ in range(steps - 1)]
    return ([float(v.asscalar()) for v in losses], grads,
            [p.asnumpy() for p in run.params])


def ffn_arrays(rows, hidden, ffn, seed):
    """Inputs, targets and parameters of ``ffn_sgd`` from a numpy seed:
    N(0, 1) inputs and targets, N(0, 0.02) weights, zero biases."""
    rng = onp.random.RandomState(seed)
    x = rng.standard_normal((rows, hidden)).astype(onp.float32)
    t = rng.standard_normal((rows, hidden)).astype(onp.float32)
    w1 = (rng.standard_normal((hidden, ffn)) * 0.02).astype(onp.float32)
    w2 = (rng.standard_normal((ffn, hidden)) * 0.02).astype(onp.float32)
    return x, t, [w1, onp.zeros(ffn, onp.float32), w2,
                  onp.zeros(hidden, onp.float32)]
