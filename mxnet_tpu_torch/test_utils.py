"""Test helpers: MXNet's (the JAX package's ``mxnet_tpu/test_utils.py``,
every public name of it) and the user kernels and the NDArray program
shared by the port's tests and ``chip_smoke.py``.

- MXNet's helpers: ``default_context`` (``MXNET_TEST_DEVICE``, else the
  current context: the card, where the JAX package's default is the
  CPU), tolerances, ``assert_almost_equal`` and its kin, random arrays
  and shapes, ``check_numeric_gradient``, ``numeric_grad``,
  ``check_symbolic_forward``/``_backward``, ``check_consistency``,
  ``check_speed``, the samplers' statistical checks, the sparse and
  matrix generators, ``get_mnist`` (local idx files, or the JAX
  package's synthetic set from the same numpy seed), ``DummyIter`` and
  ``EnvManager``;
- ``USER_KERNELS``: CUDA C sources of the user kernels that exercise
  ``mx.rtc`` (the counterparts of the Pallas kernels in
  ``tests/test_rtc.py``), each with its signature, launch geometry and
  plain PyTorch version;
- ``ffn_sgd``: MXNet's imperative API end to end, an FFN block
  ``dot(gelu(dot(x, w1) + b1), w2) + b2`` with a squared-error loss,
  trained by SGD written in NDArrays, its GELU an ``autograd.Function``;
- ``rand_ndarray`` (dense, ``csr`` or ``row_sparse``, at a ``density``)
  and ``compare_optimizer`` (two optimizers over one weight and gradient
  stream, the gradient row-sparse with ``g_stype='row_sparse'``), the JAX
  package's helpers of those names.
"""
from __future__ import annotations

import math
import os

import numpy as onp
import torch

from . import autograd, nd

__all__ = ['USER_KERNELS', 'RTC_SOURCE', 'launch_user_kernel',
           'rtc_gelu_function', 'PlainGelu', 'FfnSgd', 'ffn_sgd', 'ffn_arrays',
           'gelu_reference', 'gelu_grad_reference', 'rand_ndarray',
           'compare_optimizer',
           'DummyIter', 'EnvManager', 'almost_equal',
           'almost_equal_ignore_nan', 'assert_allclose',
           'assert_almost_equal', 'assert_almost_equal_ignore_nan',
           'assert_almost_equal_with_err', 'assert_exception', 'assign_each',
           'assign_each2', 'check_consistency',
           'check_gluon_hybridize_consistency', 'check_numeric_gradient',
           'check_shapes', 'check_speed', 'check_symbolic_backward',
           'check_symbolic_forward', 'chi_square_check', 'collapse_sum_like',
           'compare_ndarray_tuple', 'create_2d_tensor', 'create_sparse_array',
           'create_sparse_array_zd', 'create_vector', 'default_context',
           'default_dtype', 'discard_stderr', 'find_max_violation',
           'gen_buckets_probs_with_ppf', 'get_atol', 'get_bz2_data',
           'get_etol', 'get_mnist', 'get_mnist_iterator', 'get_rtol',
           'get_tolerance', 'get_zip_data', 'has_tvm_ops', 'is_cd_run',
           'is_op_runnable', 'list_gpus', 'location_error', 'mean_check',
           'new_matrix_with_real_eigvals_2d',
           'new_matrix_with_real_eigvals_nd', 'new_orthonormal_matrix_2d',
           'new_sym_matrix_with_real_eigvals_2d',
           'new_sym_matrix_with_real_eigvals_nd', 'np_reduce',
           'numeric_grad', 'rand_coord_2d', 'rand_shape_2d', 'rand_shape_3d',
           'rand_shape_nd', 'rand_sparse_ndarray', 'random_arrays',
           'random_sample', 'random_uniform_arrays', 'retry', 'same',
           'same_array', 'same_symbol_structure', 'set_default_context',
           'set_env_var', 'shuffle_csr_column_indices', 'simple_forward',
           'var_check', 'verify_generator']


def _sparsify(a, stype, density, rng):
    """Zero entries of ``a`` (whole rows for row_sparse) so that about a
    ``density`` fraction stays."""
    if density is None or stype == 'default':
        return a
    if stype == 'row_sparse':
        a[rng.uniform(0, 1, a.shape[0]) >= density] = 0
    else:
        a[rng.uniform(0, 1, a.shape) >= density] = 0
    return a


def rand_ndarray(shape, stype='default', density=None, dtype=None, ctx=None):
    """A uniform(-1, 1) NDArray of ``shape`` (numpy's global generator, as
    the JAX package draws it); for ``stype`` 'csr' or 'row_sparse' the
    sparse NDArray over it, with about a ``density`` fraction of its
    entries (rows, for row_sparse) kept when ``density`` is given."""
    data = onp.random.uniform(-1, 1, size=shape).astype(dtype or onp.float32)
    data = _sparsify(data, stype, density, onp.random)
    arr = nd.array(data, ctx=ctx)
    if stype != 'default':
        from .ndarray import sparse
        return sparse.cast_storage(arr, stype)
    return arr


def compare_optimizer(opt1, opt2, shapes, dtype, w_stype='default',
                      g_stype='default', rtol=1e-4, atol=1e-5, ntrials=3):
    """Run two optimizers over identical weight and gradient streams and
    require the same weights and states (ref: test_utils.py
    compare_optimizer). Weights are tensors on the current context's
    device, as the port's optimizers take them;
    ``w_stype`` is a storage tag the optimizers do not read (the weight's
    payload is dense in both packages); with ``g_stype='row_sparse'``
    each gradient has about half its rows zero and reaches ``update`` as
    a RowSparseNDArray, so a ``lazy_update`` optimizer skips those
    rows."""
    from .context import current_context
    from .ndarray.sparse import cast_storage
    dev = current_context().device
    for _ in range(ntrials):
        w1, w2, g1, g2, s1, s2 = [], [], [], [], [], []
        for i, shape in enumerate(shapes):
            w = onp.random.uniform(-1, 1, shape).astype(dtype)
            g = _sparsify(onp.random.uniform(-1, 1, shape).astype(dtype),
                          g_stype, 0.5 if g_stype != 'default' else None,
                          onp.random)
            w1.append(torch.tensor(w, device=dev))
            w2.append(torch.tensor(w, device=dev))
            for gs in (g1, g2):
                gt = torch.tensor(g, device=dev)
                gs.append(cast_storage(nd.NDArray(gt), g_stype)
                          if g_stype != 'default' else gt)
            s1.append(opt1.create_state_multi_precision(i, w1[-1]))
            s2.append(opt2.create_state_multi_precision(i, w2[-1]))
        for i in range(len(shapes)):
            opt1.update_multi_precision(i, w1[i], g1[i], s1[i])
            opt2.update_multi_precision(i, w2[i], g2[i], s2[i])
            for a, b in zip(_state_leaves(s1[i]), _state_leaves(s2[i])):
                onp.testing.assert_allclose(a.cpu().numpy(),
                                            b.cpu().numpy(), rtol=rtol,
                                            atol=atol)
            onp.testing.assert_allclose(w1[i].float().cpu().numpy(),
                                        w2[i].float().cpu().numpy(),
                                        rtol=rtol, atol=atol)


def _state_leaves(s):
    if s is None:
        return []
    if isinstance(s, torch.Tensor):
        return [s]
    return [t for x in s for t in _state_leaves(x)]

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


# ---------------------------------------------------------------------------
# MXNet's test helpers (the JAX package's ``mxnet_tpu/test_utils.py``,
# ref: python/mxnet/test_utils.py): contexts, tolerances, comparisons,
# random inputs and shapes, gradient and symbol checks, statistical
# checks of samplers, sparse generators, matrix generators, MNIST
# ---------------------------------------------------------------------------

def default_context():
    """The context under test: ``MXNET_TEST_DEVICE`` ('gpu...' the card,
    'cpu' the CPU) where set, else the current context, which is the card
    unless a ``with mx.cpu():`` scope (or ``set_default_context``) says
    otherwise. The JAX package's default is the CPU."""
    from .context import cpu, current_context, gpu
    dev = os.environ.get('MXNET_TEST_DEVICE')
    if dev is None:
        return current_context()
    if dev.startswith(('gpu', 'tpu')):
        return gpu(0)
    return cpu(0)


def set_default_context(ctx):
    """Make ``ctx`` the thread's current context (the stack ``with ctx:``
    pushes onto), until popped."""
    from .context import Context
    if not hasattr(Context._default_ctx, 'stack'):
        Context._default_ctx.stack = []
    Context._default_ctx.stack.append(ctx)


def default_dtype():
    return onp.float32


def _as_np(x):
    from .ndarray.ndarray import NDArray
    if isinstance(x, NDArray):
        return x.asnumpy()
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy() \
            if x.dtype == torch.bfloat16 else x.detach().cpu().numpy()
    return onp.asarray(x)


def assert_almost_equal(a, b, rtol=1e-5, atol=1e-20, names=('a', 'b'),
                        equal_nan=False):
    onp.testing.assert_allclose(_as_np(a), _as_np(b), rtol=rtol, atol=atol,
                                equal_nan=equal_nan,
                                err_msg=f"{names[0]} != {names[1]}")


def almost_equal(a, b, rtol=1e-5, atol=1e-20, equal_nan=False):
    try:
        assert_almost_equal(a, b, rtol, atol, equal_nan=equal_nan)
        return True
    except AssertionError:
        return False


def same(a, b):
    return onp.array_equal(_as_np(a), _as_np(b))


def rand_shape_2d(dim0=10, dim1=10):
    return (onp.random.randint(1, dim0 + 1), onp.random.randint(1, dim1 + 1))


def rand_shape_3d(dim0=10, dim1=10, dim2=10):
    return (onp.random.randint(1, dim0 + 1), onp.random.randint(1, dim1 + 1),
            onp.random.randint(1, dim2 + 1))


def rand_shape_nd(num_dim, dim=10):
    return tuple(onp.random.randint(1, dim + 1, size=num_dim))


def check_numeric_gradient(f, inputs, eps=1e-4, rtol=1e-2, atol=1e-4):
    """Central differences against autograd for a function of NDArrays
    returning a scalar NDArray (the JAX package's functional form)."""
    from .ndarray.ndarray import NDArray
    inputs = [x if isinstance(x, NDArray) else nd.array(x) for x in inputs]
    for x in inputs:
        x.attach_grad()
    with autograd.record():
        y = f(*inputs)
    y.backward()
    analytic = [x.grad.asnumpy().copy() for x in inputs]
    for xi, x in enumerate(inputs):
        xv = x.asnumpy().astype(onp.float64)
        num_grad = onp.zeros_like(xv)
        flat = xv.ravel()
        ng_flat = num_grad.ravel()
        for i in range(flat.size):
            orig = flat[i]
            values = []
            for v in (orig + eps, orig - eps):
                flat[i] = v
                xp = nd.array(xv.astype(onp.float32), ctx=x.context)
                values.append(f(*[xp if j == xi else inputs[j]
                                  for j in range(len(inputs))]).asscalar())
            flat[i] = orig
            ng_flat[i] = (values[0] - values[1]) / (2 * eps)
        onp.testing.assert_allclose(analytic[xi], num_grad, rtol=rtol,
                                    atol=atol,
                                    err_msg=f"gradient mismatch for input "
                                            f"{xi}")


def check_consistency(fn, inputs, ctx_list=None, rtol=1e-3, atol=1e-4):
    """``fn`` on each context of ``ctx_list`` (the CPU by default), the
    outputs held against the first's."""
    from .context import cpu
    if ctx_list is None:
        ctx_list = [cpu(0)]
    results = [_as_np(fn(*[x.as_in_context(ctx) for x in inputs]))
               for ctx in ctx_list]
    for r in results[1:]:
        onp.testing.assert_allclose(results[0], r, rtol=rtol, atol=atol)
    return results


def discard_stderr():
    import contextlib
    import sys

    @contextlib.contextmanager
    def _ctx():
        with open(os.devnull, 'w') as devnull:
            old = sys.stderr
            sys.stderr = devnull
            try:
                yield
            finally:
                sys.stderr = old
    return _ctx()


class EnvManager:
    """Sets one environment variable inside a ``with`` block."""

    def __init__(self, key, val):
        self._key = key
        self._next_val = val
        self._prev_val = None

    def __enter__(self):
        self._prev_val = os.environ.get(self._key)
        os.environ[self._key] = self._next_val

    def __exit__(self, *exc):
        if self._prev_val:
            os.environ[self._key] = self._prev_val
        elif self._key in os.environ:
            del os.environ[self._key]


_RTOLS = {onp.dtype('float16'): 1e-2, onp.dtype('float32'): 1e-4,
          onp.dtype('float64'): 1e-6}
_ATOLS = {onp.dtype('float16'): 1e-2, onp.dtype('float32'): 1e-5,
          onp.dtype('float64'): 1e-8}


def _dtype_key(dtype):
    """'bfloat16', or the numpy dtype of a numpy or torch dtype or name."""
    if dtype is None:
        return onp.dtype('float32')
    if isinstance(dtype, torch.dtype):
        if dtype == torch.bfloat16:
            return 'bfloat16'
        return torch.empty((), dtype=dtype).numpy().dtype
    if str(dtype) == 'bfloat16' or getattr(dtype, '__name__', '') == \
            'bfloat16':
        return 'bfloat16'
    return onp.dtype(dtype)


def get_rtol(dtype=None, rtol=None):
    """Per-dtype default relative tolerance; bfloat16 gets the loosest
    tier (an 8-bit significand)."""
    if rtol is not None:
        return rtol
    key = _dtype_key(dtype)
    return 2e-2 if key == 'bfloat16' else _RTOLS.get(key, 1e-4)


def get_atol(dtype=None, atol=None):
    if atol is not None:
        return atol
    key = _dtype_key(dtype)
    return 2e-2 if key == 'bfloat16' else _ATOLS.get(key, 1e-5)


def get_tolerance(arr, rtol=None, atol=None):
    dt = getattr(arr, 'dtype', onp.float32)
    return get_rtol(dt, rtol), get_atol(dt, atol)


def get_etol(etol=None):
    """The share of elements allowed past the tolerance."""
    return 0.0 if etol is None else etol


def random_arrays(*shapes):
    """Random float32 numpy arrays (a scalar for a () shape); one array
    for one shape."""
    arrays = [onp.random.randn(*s).astype(onp.float32) if s else
              onp.float32(onp.random.randn()) for s in shapes]
    return arrays if len(arrays) > 1 else arrays[0]


def random_uniform_arrays(*shapes, low=0.0, high=1.0, dtype='float32'):
    return [onp.random.uniform(low, high, size=s).astype(dtype)
            for s in shapes]


def random_sample(population, k):
    """``k`` items without replacement, in the population's order."""
    idx = sorted(onp.random.permutation(len(population))[:k].tolist())
    return [population[i] for i in idx]


def rand_coord_2d(x_low, x_high, y_low, y_high):
    return onp.random.randint(x_low, x_high), onp.random.randint(y_low,
                                                                 y_high)


def create_2d_tensor(rows, columns, dtype=onp.int64):
    return onp.arange(rows * columns, dtype=dtype).reshape(rows, columns)


def create_vector(size, dtype=onp.int64):
    return onp.arange(size, dtype=dtype)


def assign_each(input_, fn):
    return onp.vectorize(fn)(input_) if fn is not None else input_.copy()


def assign_each2(input1, input2, fn):
    return onp.vectorize(fn)(input1, input2) if fn is not None \
        else input1.copy()


def np_reduce(dat, axis, keepdims, numpy_reduce_func):
    """A numpy reduction over an axis or tuple of axes, with keepdims."""
    if isinstance(axis, int):
        axis = (axis,)
    axes = axis if axis is not None else tuple(range(dat.ndim))
    ret = dat
    for a in reversed(sorted(axes)):
        ret = numpy_reduce_func(ret, axis=a)
    if keepdims:
        shape = list(dat.shape)
        for a in axes:
            shape[a] = 1
        ret = ret.reshape(tuple(shape))
    return ret


def find_max_violation(a, b, rtol=1e-5, atol=1e-8):
    """Where |a - b| passes its tolerance the most, and |a - b| there."""
    a, b = _as_np(a), _as_np(b)
    diff = onp.abs(a - b)
    violation = diff - (atol + rtol * onp.abs(b))
    idx = onp.unravel_index(onp.argmax(violation), violation.shape) \
        if violation.ndim else ()
    return idx, float(diff[idx] if violation.ndim else diff)


def assert_allclose(a, b, rtol=1e-5, atol=1e-8, equal_nan=False):
    assert_almost_equal(a, b, rtol=rtol, atol=atol, equal_nan=equal_nan)


def assert_almost_equal_with_err(a, b, rtol=1e-5, atol=1e-8, etol=0.0,
                                 names=('a', 'b')):
    """Allow a share ``etol`` of the elements past the tolerance."""
    a, b = _as_np(a), _as_np(b)
    bad = onp.abs(a - b) > atol + rtol * onp.abs(b)
    frac = float(onp.mean(bad)) if bad.size else 0.0
    if frac > etol:
        idx, worst = find_max_violation(a, b, rtol, atol)
        raise AssertionError(
            f"{names[0]} != {names[1]}: {frac * 100:.2f}% elements exceed "
            f"tol (allowed {etol * 100:.2f}%); worst at {idx}: {worst}")


def almost_equal_ignore_nan(a, b, rtol=1e-5, atol=1e-8):
    a, b = _as_np(a).copy(), _as_np(b).copy()
    nan_mask = onp.logical_or(onp.isnan(a), onp.isnan(b))
    a[nan_mask] = 0
    b[nan_mask] = 0
    return almost_equal(a, b, rtol, atol)


def assert_almost_equal_ignore_nan(a, b, rtol=1e-5, atol=1e-8,
                                   names=('a', 'b')):
    if not almost_equal_ignore_nan(a, b, rtol, atol):
        raise AssertionError(f"{names[0]} != {names[1]} (ignoring NaN)")


def assert_exception(f, exception_type, *args, **kwargs):
    """``f(*args, **kwargs)`` must raise ``exception_type``."""
    try:
        f(*args, **kwargs)
    except exception_type:
        return
    raise AssertionError(f"did not raise {exception_type.__name__}")


def retry(n):
    """Retry a probabilistic test up to ``n`` times."""
    if n <= 0:
        raise ValueError("retry needs n > 0")

    def decorate(f):
        import functools

        @functools.wraps(f)
        def wrapper(*args, **kwargs):
            for i in range(n):
                try:
                    return f(*args, **kwargs)
                except AssertionError:
                    if i == n - 1:
                        raise
            return None
        return wrapper
    return decorate


def simple_forward(sym, ctx=None, is_train=False, **inputs):
    """A symbol's outputs as numpy arrays for numpy inputs."""
    ctx = ctx or default_context()
    exe = sym.bind(ctx, {k: nd.array(v, ctx=ctx) for k, v in inputs.items()})
    outputs = [o.asnumpy() for o in exe.forward(is_train=is_train)]
    return outputs[0] if len(outputs) == 1 else outputs


def numeric_grad(f, inputs, eps=1e-4):
    """Central differences of a scalar function of numpy arrays."""
    base = [onp.asarray(a, onp.float64).copy() for a in inputs]
    grads = []
    for x in base:
        g = onp.zeros_like(x)
        it = onp.nditer(x, flags=['multi_index'])
        while not it.finished:
            idx = it.multi_index
            orig = x[idx]
            x[idx] = orig + eps
            fp = float(f(*base))
            x[idx] = orig - eps
            fm = float(f(*base))
            x[idx] = orig
            g[idx] = (fp - fm) / (2 * eps)
            it.iternext()
        grads.append(g)
    return grads


def check_symbolic_forward(sym, location, expected, rtol=1e-4, atol=1e-5,
                           ctx=None):
    """Bind a symbol, run its forward, hold each output against
    ``expected``; the outputs as numpy arrays."""
    ctx = ctx or default_context()
    args = _parse_location(sym, location, ctx)
    outs = sym.bind(ctx, args).forward(is_train=False)
    if not isinstance(expected, (list, tuple)):
        expected = [expected]
    for o, e in zip(outs, expected):
        assert_almost_equal(o, e, rtol=rtol, atol=atol)
    return [o.asnumpy() for o in outs]


def check_symbolic_backward(sym, location, out_grads, expected,
                            rtol=1e-4, atol=1e-5, ctx=None):
    """Bind with gradient buffers, run forward and backward, hold the
    inputs' gradients against ``expected``; the gradients as numpy."""
    ctx = ctx or default_context()
    names = sym.list_arguments()
    args = _parse_location(sym, location, ctx)
    grad_bufs = {k: nd.array(onp.zeros_like(_as_np(v)), ctx=ctx)
                 for k, v in args.items()}
    exe = sym.bind(ctx, args, args_grad=grad_bufs)
    exe.forward(is_train=True)
    exe.backward([nd.array(g, ctx=ctx) for g in (
        out_grads if isinstance(out_grads, (list, tuple)) else [out_grads])])
    exp = expected if isinstance(expected, dict) else \
        dict(zip(names, expected))
    for k, e in exp.items():
        assert_almost_equal(grad_bufs[k], e, rtol=rtol, atol=atol,
                            names=(f'grad({k})', 'expected'))
    return {k: v.asnumpy() for k, v in grad_bufs.items()}


def check_speed(f, n=20, warmup=3):
    """Median host seconds per call of ``f`` after ``warmup`` calls, each
    call ended by a synchronize of the card where it is in use."""
    import time
    for _ in range(warmup):
        f()
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        f()
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return float(onp.median(times))


def same_array(a, b):
    """Whether two arrays are over the same memory."""
    da = getattr(a, '_data', a)
    db = getattr(b, '_data', b)
    return da.device == db.device and da.data_ptr() == db.data_ptr()


class DummyIter:
    """Repeats one batch for ever."""

    def __init__(self, batch):
        self.batch = batch

    def __iter__(self):
        return self

    def __next__(self):
        return self.batch


def gen_buckets_probs_with_ppf(ppf, nbuckets):
    """Equal-probability buckets from a percent-point function."""
    probs = [1.0 / nbuckets] * nbuckets
    buckets = [(ppf(i / nbuckets), ppf((i + 1) / nbuckets))
               for i in range(nbuckets)]
    return buckets, probs


def mean_check(generator, mu, sigma, nsamples=1000000, nrepeat=5):
    """z-test of the sample mean of ``generator(n)`` against ``mu``."""
    ok = 0
    for _ in range(nrepeat):
        samples = onp.asarray(_as_np(generator(nsamples)), onp.float64)
        z = (samples.mean() - mu) / (sigma / onp.sqrt(nsamples))
        ok += abs(z) < 3.0
    return ok >= nrepeat - 1


def var_check(generator, sigma, nsamples=1000000, nrepeat=5):
    ok = 0
    for _ in range(nrepeat):
        samples = onp.asarray(_as_np(generator(nsamples)), onp.float64)
        ok += 0.9 < samples.var() / (sigma ** 2) < 1.1
    return ok >= nrepeat - 1


def verify_generator(generator, buckets, probs, nsamples=100000,
                     nrepeat=3, success_rate=0.25):
    """Chi-square bucket test of a sampler."""
    successes = 0
    for _ in range(nrepeat):
        samples = onp.asarray(_as_np(generator(nsamples)),
                              onp.float64).ravel()
        counts = onp.array([onp.sum((samples >= lo) & (samples < hi))
                            for lo, hi in buckets], onp.float64)
        expected = onp.array(probs, onp.float64) * samples.size
        chi2 = onp.sum((counts - expected) ** 2 / onp.maximum(expected, 1))
        # dof = nbuckets - 1; its 99.9th percentile by Wilson-Hilferty
        dof = len(buckets) - 1
        crit = dof * (1 - 2 / (9 * dof) + 3.09 * onp.sqrt(2 / (9 * dof))) ** 3
        successes += chi2 < crit
    return successes >= max(1, int(nrepeat * success_rate))


def chi_square_check(generator, buckets, probs, nsamples=1000000):
    """(chi-square statistic, bucket counts) of ``generator(n)`` against
    the bucket probabilities; buckets are intervals or values."""
    samples = _as_np(generator(nsamples)).reshape(-1)
    expected = onp.asarray(probs, onp.float64) * len(samples)
    counts = onp.zeros(len(buckets))
    if isinstance(buckets[0], (list, tuple)):
        for i, (lo, hi) in enumerate(buckets):
            counts[i] = onp.sum((samples >= lo) & (samples < hi))
    else:
        for i, v in enumerate(buckets):
            counts[i] = onp.sum(samples == v)
    chi2 = onp.sum((counts - expected) ** 2 / onp.maximum(expected, 1e-9))
    return float(chi2), counts


def compare_ndarray_tuple(t1, t2, rtol=1e-5, atol=1e-8):
    """Elementwise comparison of (nested) tuples of arrays."""
    if t1 is None or t2 is None:
        return
    if isinstance(t1, tuple):
        for a, b in zip(t1, t2):
            compare_ndarray_tuple(a, b, rtol, atol)
    else:
        assert_almost_equal(t1, t2, rtol=rtol, atol=atol)


def collapse_sum_like(a, shape):
    """Sum ``a`` down to ``shape`` by the broadcast rules."""
    a = _as_np(a)
    if len(a.shape) < len(shape):
        raise ValueError(f"cannot collapse {a.shape} to {shape}")
    if onp.prod(shape) == 0 or a.size == 0:
        return onp.zeros(shape, a.dtype)
    axes = list(range(len(a.shape) - len(shape)))
    for i, s in enumerate(shape):
        if s != a.shape[len(a.shape) - len(shape) + i]:
            if s != 1:
                raise ValueError(f"cannot collapse {a.shape} to {shape}")
            axes.append(len(a.shape) - len(shape) + i)
    return a.sum(axis=tuple(axes), keepdims=True).reshape(shape) \
        if axes else a.reshape(shape)


def check_gluon_hybridize_consistency(net_builder, data_l, numpy_func=None,
                                      test_grad=True, rtol=1e-4, atol=1e-5):
    """A Gluon block's output (and its inputs' gradients) eager against
    hybridized, and against ``numpy_func`` where given."""
    saved_out = saved_grads = None
    for hybridize in (False, True):
        net = net_builder()
        net.initialize()
        if hybridize:
            net.hybridize()
        in_data = [nd.array(_as_np(x)) for x in data_l]
        grads = None
        if test_grad:
            for x in in_data:
                x.attach_grad()
            with autograd.record():
                out = net(*in_data)
            out.backward()
            grads = [x.grad.asnumpy() for x in in_data]
        else:
            out = net(*in_data)
        out_np = out.asnumpy()
        if saved_out is None:
            saved_out, saved_grads = out_np, grads
            continue
        assert_almost_equal(out_np, saved_out, rtol=rtol, atol=atol)
        if test_grad:
            for g, sg in zip(grads, saved_grads):
                assert_almost_equal(g, sg, rtol=rtol, atol=atol)
    if numpy_func is not None:
        assert_almost_equal(saved_out,
                            numpy_func(*[_as_np(x) for x in data_l]),
                            rtol=rtol, atol=atol)


def new_sym_matrix_with_real_eigvals_nd(n):
    """A random symmetric n x n matrix."""
    a = onp.random.randn(n, n).astype(onp.float32)
    return (a + a.T) / 2


def new_matrix_with_real_eigvals_2d(n):
    """Q D Q^T with D in [1, 2] on its diagonal and Q orthonormal."""
    d = onp.diag(onp.random.uniform(1.0, 2.0, n))
    q, _ = onp.linalg.qr(onp.random.randn(n, n))
    return (q @ d @ q.T).astype(onp.float32)


def new_matrix_with_real_eigvals_nd(n, ndim=3):
    return onp.stack([new_matrix_with_real_eigvals_2d(n)
                      for _ in range(ndim)])


def new_orthonormal_matrix_2d(n):
    q, _ = onp.linalg.qr(onp.random.randn(n, n))
    return q.astype(onp.float32)


def new_sym_matrix_with_real_eigvals_2d(n):
    a = onp.random.randn(n, n).astype(onp.float32)
    return (a + a.T) / 2


def _validate_csr_generation_inputs(num_rows, num_cols, density,
                                    distribution="uniform"):
    if density < 0 or density > 1:
        raise ValueError("density must be in [0, 1]")
    if num_rows * num_cols < 10:
        raise ValueError("matrix is too small; csr generators need >= 10 "
                         "elements")
    if distribution == "powerlaw" and int(density * num_cols) < 1:
        raise ValueError("powerlaw distribution needs at least one "
                         "nonzero per row; raise density")


def shuffle_csr_column_indices(csr):
    """The array as it is: the port's CSRNDArray keeps its column indices
    in one canonical order, so there is no other order to exercise (the
    JAX package's does the same)."""
    return csr


def _get_uniform_dataset_csr(num_rows, num_cols, density=0.1, dtype=None,
                             data_init=None, shuffle_csr_indices=False):
    from .ndarray import sparse
    dtype = dtype or default_dtype()
    _validate_csr_generation_inputs(num_rows, num_cols, density)
    dense = (onp.random.rand(num_rows, num_cols) < density).astype(dtype)
    if data_init is not None:
        dense *= data_init
    else:
        dense *= onp.random.rand(num_rows, num_cols).astype(dtype)
    csr = sparse.csr_matrix(dense, dtype=dtype)
    return shuffle_csr_column_indices(csr) if shuffle_csr_indices else csr


def _get_powerlaw_dataset_csr(num_rows, num_cols, density=0.1, dtype=None):
    """Row i holds about twice the nonzeros of row i - 1 until the budget
    runs out."""
    from .ndarray import sparse
    dtype = dtype or default_dtype()
    _validate_csr_generation_inputs(num_rows, num_cols, density, "powerlaw")
    unused = int(num_rows * num_cols * density)
    dense = onp.zeros((num_rows, num_cols), dtype)
    nnz_row = 1
    for i in range(num_rows):
        n = min(unused, nnz_row, num_cols)
        if n <= 0:
            break
        cols = onp.random.choice(num_cols, n, replace=False)
        dense[i, cols] = onp.random.rand(n).astype(dtype) + 0.1
        unused -= n
        nnz_row *= 2
    return sparse.csr_matrix(dense, dtype=dtype)


def rand_sparse_ndarray(shape, stype, density=None, dtype=None,
                        distribution=None, data_init=None,
                        rsp_indices=None, shuffle_csr_indices=False):
    """(a random sparse NDArray, its dense numpy value)."""
    from .ndarray import sparse
    density = onp.random.rand() if density is None else density
    dtype = dtype or default_dtype()
    distribution = distribution or "uniform"
    if stype == 'row_sparse':
        dense = onp.zeros(shape, dtype)
        if rsp_indices is not None:
            idx = onp.asarray(rsp_indices, onp.int64)
        else:
            n = max(1, int(shape[0] * density))
            idx = onp.sort(onp.random.choice(shape[0], n, replace=False))
        dense[idx] = onp.random.rand(len(idx), *shape[1:]).astype(dtype) \
            if len(shape) > 1 else onp.random.rand(len(idx)).astype(dtype)
        return sparse.row_sparse_array(dense, dtype=dtype), dense
    if stype == 'csr':
        if len(shape) != 2:
            raise ValueError(f"csr needs a 2-d shape, got {shape}")
        if distribution == "powerlaw":
            csr = _get_powerlaw_dataset_csr(shape[0], shape[1],
                                            density=density, dtype=dtype)
        else:
            csr = _get_uniform_dataset_csr(
                shape[0], shape[1], density=density, dtype=dtype,
                data_init=data_init,
                shuffle_csr_indices=shuffle_csr_indices)
        return csr, csr.asnumpy()
    raise ValueError(f"unknown sparse stype {stype!r}")


def create_sparse_array(shape, stype, data_init=None, rsp_indices=None,
                        dtype=None, modifier_func=None, density=0.5,
                        shuffle_csr_indices=False):
    """A random sparse array, ``modifier_func`` applied to its nonzeros."""
    from .ndarray import sparse
    arr, dense = rand_sparse_ndarray(
        shape, stype, density=density, dtype=dtype, data_init=data_init,
        rsp_indices=rsp_indices, shuffle_csr_indices=shuffle_csr_indices)
    if modifier_func is not None:
        vec = onp.vectorize(modifier_func)
        dense = onp.where(dense != 0, vec(dense).astype(dense.dtype), dense)
        arr = (sparse.csr_matrix(dense, dtype=dense.dtype) if stype == 'csr'
               else sparse.row_sparse_array(dense, dtype=dense.dtype))
    return arr


def create_sparse_array_zd(shape, stype, density, data_init=None,
                           rsp_indices=None, dtype=None,
                           modifier_func=None, shuffle_csr_indices=False):
    """``create_sparse_array``, an all-zero array at density 0."""
    if density == 0:
        from .ndarray import sparse
        dense = onp.zeros(shape, dtype or default_dtype())
        return (sparse.csr_matrix(dense, dtype=dense.dtype) if stype == 'csr'
                else sparse.row_sparse_array(dense, dtype=dense.dtype))
    return create_sparse_array(shape, stype, data_init=data_init,
                               rsp_indices=rsp_indices, dtype=dtype,
                               modifier_func=modifier_func, density=density,
                               shuffle_csr_indices=shuffle_csr_indices)


def _parse_location(sym, location, ctx=None, dtype=None):
    """{argument name: NDArray} from a list or dict of a symbol's
    inputs."""
    if not isinstance(location, (dict, list, tuple)):
        raise ValueError("location must be a dict, list or tuple")
    names = sym.list_arguments() if hasattr(sym, 'list_arguments') else None
    if isinstance(location, dict):
        if names is not None:
            missing = set(location) - set(names)
            if missing:
                raise ValueError(f"location keys {sorted(missing)} not in "
                                 f"symbol arguments {names}")
        return {k: nd.array(_as_np(v), ctx=ctx) for k, v in location.items()}
    if names is None:
        names = [f"arg{i}" for i in range(len(location))]
    if len(names) != len(location):
        raise ValueError(
            f"expected {len(names)} inputs for arguments {names}, "
            f"got {len(location)}")
    return {n: nd.array(_as_np(v), ctx=ctx) for n, v in zip(names, location)}


def check_shapes(expected, actual):
    if tuple(expected) != tuple(actual):
        raise AssertionError(f"shape mismatch: expected {expected}, "
                             f"got {actual}")


def location_error(expected, got, name):
    return f"location {name!r}: expected {expected}, got {got}"


def list_gpus():
    """The indices of the visible cards."""
    return list(range(torch.cuda.device_count()))


def set_env_var(key, val, default_val=""):
    """Set an environment variable; its previous value."""
    prev = os.environ.get(key, default_val)
    os.environ[key] = val
    return prev


def _read_idx(path):
    import struct
    with open(path, 'rb') as f:
        magic = struct.unpack('>I', f.read(4))[0]
        ndim = magic & 0xFF
        dims = struct.unpack('>' + 'I' * ndim, f.read(4 * ndim))
        return onp.frombuffer(f.read(), onp.uint8).reshape(dims)


def get_mnist(path=None):
    """MNIST as numpy arrays: the idx files in ``path`` (or
    ``MXNET_TPU_MNIST_DIR``) where they are, else the JAX package's
    synthetic set, drawn from the same numpy seed (the same arrays);
    nothing is downloaded. float32 images in [0, 1], int32 labels."""
    from . import config
    path = path or config.get('MXNET_TPU_MNIST_DIR')
    if path and os.path.exists(os.path.join(path,
                                            'train-images-idx3-ubyte')):
        def images(name):
            return (_read_idx(os.path.join(path, name))[:, None]
                    / onp.float32(255.0)).astype(onp.float32)

        def labels(name):
            return _read_idx(os.path.join(path, name)).astype(onp.int32)
        return {'train_data': images('train-images-idx3-ubyte'),
                'train_label': labels('train-labels-idx1-ubyte'),
                'test_data': images('t10k-images-idx3-ubyte'),
                'test_label': labels('t10k-labels-idx1-ubyte')}
    rng = onp.random.RandomState(42)

    def synth(n):
        labels = rng.randint(0, 10, n).astype(onp.int32)
        imgs = rng.rand(n, 1, 28, 28).astype(onp.float32) * 0.1
        for i, label in enumerate(labels):  # a blob by class
            imgs[i, 0, label:label + 10, label:label + 10] += 0.8
        return imgs, labels
    td, tl = synth(1024)
    vd, vl = synth(256)
    return {'train_data': td, 'train_label': tl,
            'test_data': vd, 'test_label': vl}


def get_mnist_iterator(batch_size, input_shape=(1, 28, 28), num_parts=1,
                       part_index=0):
    """(train, val) NDArrayIters over ``get_mnist``; ``num_parts`` and
    ``part_index`` give each data-parallel worker its own contiguous
    shard of the training set."""
    from .io import NDArrayIter
    m = get_mnist()
    shape = (-1,) + tuple(input_shape)
    td, tl = m['train_data'].reshape(shape), m['train_label']
    if num_parts > 1:
        n = len(td) // num_parts
        td = td[part_index * n:(part_index + 1) * n]
        tl = tl[part_index * n:(part_index + 1) * n]
    train = NDArrayIter(td, tl, batch_size, shuffle=True)
    val = NDArrayIter(m['test_data'].reshape(shape), m['test_label'],
                      batch_size)
    return train, val


def get_zip_data(data_dir, url, data_origin_name):
    """Unpack a local zip file (nothing is downloaded)."""
    import zipfile
    path = os.path.join(data_dir, data_origin_name)
    if os.path.exists(path):
        with zipfile.ZipFile(path) as z:
            z.extractall(data_dir)


def get_bz2_data(data_dir, data_name, url, data_origin_name):
    """Unpack a local .bz2 file (nothing is downloaded)."""
    import bz2
    import shutil
    out = os.path.join(data_dir, data_name)
    src = os.path.join(data_dir, data_origin_name)
    if not os.path.exists(out) and os.path.exists(src):
        with bz2.BZ2File(src) as fin, open(out, 'wb') as fout:
            shutil.copyfileobj(fin, fout)


def same_symbol_structure(sym1, sym2):
    """Whether two Symbols run the same ops with the same arities."""
    import json

    def sig(sym):
        return [(n.get('op'), len(n.get('inputs', [])))
                for n in json.loads(sym.tojson()).get('nodes', [])]
    return sig(sym1) == sig(sym2)


def is_cd_run():
    return os.environ.get("CD_JOB", "0") == "1"


def has_tvm_ops():
    """The port has no TVM-compiled operators."""
    return False


def is_op_runnable():
    return True
