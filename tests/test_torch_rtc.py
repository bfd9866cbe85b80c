"""``mx.rtc`` of the port: user CUDA kernels compiled by NVRTC, the
counterpart of the JAX package's ``pallas_op``.

On the CPU: the signature parser, every launch check (each raises
``MXNetError`` before anything is launched), the refusals without a
card, and each user kernel's plain version against the JAX package's
``pallas_op`` kernel of tests/test_rtc.py in interpret mode, on the same
inputs (rtol 1e-6 for the elementwise kernels, 1e-5 for the row sum:
another summation order).

The ``cuda``-marked tests compile and launch the user kernels on the
card; without one they skip. On the card, from the root of the checkout:

    python -m pytest --noconftest -m cuda tests/test_torch_rtc.py
"""
import threading

import numpy as onp
import pytest
import torch

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import nd, rtc
from mxnet_tpu_torch.test_utils import (RTC_SOURCE, USER_KERNELS,
                                        launch_user_kernel)
from test_torch_jax_globals import jax_globals  # noqa: F401


def _inputs(seed):
    rng = onp.random.RandomState(seed)
    return {'scale_add': [rng.rand(8, 128).astype('f'),
                          rng.rand(8, 128).astype('f')],
            'block_double': [rng.rand(128, 128).astype('f')],
            'rowsum': [rng.rand(8, 16).astype('f')]}


# ---- the signature parser ------------------------------------------------

@pytest.mark.parametrize('ctype,dtype', [
    ('float', torch.float32), ('double', torch.float64),
    ('__half', torch.float16), ('__nv_bfloat16', torch.bfloat16),
    ('uint8_t', torch.uint8), ('int', torch.int32),
    ('int32_t', torch.int32), ('int8_t', torch.int8), ('char', torch.int8),
    ('int64_t', torch.int64)])
def test_signature_types(ctype, dtype):
    args = rtc.parse_signature(f'const {ctype} *a, {ctype}* b, {ctype} c, '
                               f'{ctype}')
    assert [a.dtype for a in args] == [dtype] * 4
    assert [a.is_const for a in args] == [True, False, False, False]
    assert [a.is_array for a in args] == [True, True, False, False]
    assert [a.name for a in args] == ['a', 'b', 'c', '']


def test_signature_forms():
    assert rtc.parse_signature('') == []
    args = rtc.parse_signature('const  float\n*x,float*y ,  int n')
    assert [(a.is_const, a.is_array, a.name) for a in args] == [
        (True, True, 'x'), (False, True, 'y'), (False, False, 'n')]


@pytest.mark.parametrize('bad', [
    'unsigned int n', 'float16 *x', 'bool flag', 'size_t n', 'const *x',
    'float **x', 'float x y', 'float *x,', 'constfloat *x'])
def test_signature_refuses(bad):
    with pytest.raises(mt.MXNetError):
        rtc.parse_signature(bad)


# ---- launch checks, all before any launch -----------------------------------

def _kernel():
    """A kernel with no compiled function behind it: reaching the CUDA driver
    would fail, so each check must raise before that."""
    return rtc.CudaKernel(None, 'check_only',
                          rtc.parse_signature('const float *x, float *y, '
                                              'int n'))


@pytest.mark.parametrize('args,ctx,grid,match', [
    ('short', 'gpu', (1, 1, 1), 'arguments for a kernel'),
    ('number_for_array', 'gpu', (1, 1, 1), 'is an array'),
    ('array_for_number', 'gpu', (1, 1, 1), 'is a number'),
    ('wrong_dtype', 'gpu', (1, 1, 1), 'must be torch.float32'),
    ('ok', 'gpu', (1, 1), 'three values'),
    ('ok', 'cpu', (1, 1, 1), 'GPU context'),
    ('ok', 'gpu', (1, 1, 1), 'no CUDA device|is on cpu'),
])
def test_launch_checks_raise_before_launching(args, ctx, grid, match):
    k = _kernel()
    x, y = nd.ones((4,), ctx=mt.cpu()), nd.zeros((4,), ctx=mt.cpu())
    before = y._data
    cases = {
        'short': [x, y],
        'number_for_array': [x, 1.0, 4],
        'array_for_number': [x, y, x],
        'wrong_dtype': [x, nd.zeros((4,), ctx=mt.cpu(), dtype='float64'), 4],
        'ok': [x, y, 4]}
    ctx = mt.gpu(0) if ctx == 'gpu' else mt.cpu()
    if args == 'ok' and match.startswith('no CUDA') and \
            torch.cuda.is_available():
        match = 'is on cpu'
    with pytest.raises(mt.MXNetError, match=match):
        k.launch(cases[args], ctx, grid, (32, 1, 1))
    assert rtc.launch_counts['check_only'] == 0
    assert not k._fns and y._data is before


def test_without_a_card_compiling_refuses():
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present: nothing to refuse')
    with pytest.raises(mt.MXNetError, match='no CUDA device'):
        rtc.CudaModule(RTC_SOURCE)


def test_pallas_op_points_to_cuda_module():
    with pytest.raises(mt.MXNetError, match='CudaModule'):
        rtc.pallas_op(lambda x_ref, o_ref: None, out_like=0)


# ---- plain versions against the JAX package's pallas_op kernels ------------

def _jax_pallas(name, inputs):
    """The Pallas kernels of tests/test_rtc.py, run in interpret mode."""
    import jax
    import mxnet_tpu as mj
    from jax.experimental import pallas as pl
    xs = [mj.nd.array(a) for a in inputs]
    if name == 'scale_add':
        def k(x_ref, y_ref, o_ref):
            o_ref[...] = x_ref[...] * 2.0 + y_ref[...]
        op = mj.rtc.pallas_op(k, out_like=0, interpret=True)
    elif name == 'block_double':
        def k(x_ref, o_ref):
            o_ref[...] = x_ref[...] * 2.0
        op = mj.rtc.pallas_op(
            k, out_like=0, grid=(2,), interpret=True,
            in_specs=[pl.BlockSpec((64, 128), lambda i: (i, 0))],
            out_specs=pl.BlockSpec((64, 128), lambda i: (i, 0)))
    else:
        def k(x_ref, o_ref):
            o_ref[...] = x_ref[...].sum(axis=1, keepdims=True)
        op = mj.rtc.pallas_op(
            k, out_shape=jax.ShapeDtypeStruct((8, 1), onp.float32),
            interpret=True)
    return op(*xs).asnumpy()


@pytest.mark.parametrize('name', ['scale_add', 'block_double', 'rowsum'])
def test_plain_versions_match_the_pallas_kernels(name):
    inputs = _inputs(0)[name]
    want = _jax_pallas(name, inputs)
    got = USER_KERNELS[name]['plain'](
        *[torch.from_numpy(a) for a in inputs]).numpy()
    assert got.shape == want.shape
    onp.testing.assert_allclose(got, want,
                                rtol=1e-5 if name == 'rowsum' else 1e-6)
    if name == 'scale_add':                 # the second shape of the test
        swapped = _jax_pallas(name, inputs[::-1])
        onp.testing.assert_allclose(
            USER_KERNELS[name]['plain'](*[torch.from_numpy(a) for a in
                                          inputs[::-1]]).numpy(),
            swapped, rtol=1e-6)


def test_gelu_plain_versions_match_jax():
    import jax
    import jax.numpy as jnp
    from mxnet_tpu_torch.test_utils import (gelu_grad_reference,
                                            gelu_reference)
    x = onp.random.RandomState(3).randn(64).astype('f') * 3
    dy = onp.random.RandomState(4).randn(64).astype('f')
    want = jax.nn.gelu(jnp.asarray(x), approximate=False)
    _, vjp = jax.vjp(lambda v: jax.nn.gelu(v, approximate=False),
                     jnp.asarray(x))
    onp.testing.assert_allclose(gelu_reference(torch.from_numpy(x)).numpy(),
                                onp.asarray(want), rtol=1e-5, atol=1e-6)
    onp.testing.assert_allclose(
        gelu_grad_reference(torch.from_numpy(x), torch.from_numpy(dy)).numpy(),
        onp.asarray(vjp(jnp.asarray(dy))[0]), rtol=1e-5, atol=1e-6)


# ---- on the card ------------------------------------------------------------

@pytest.fixture
def module():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    return rtc.CudaModule(RTC_SOURCE)


@pytest.mark.cuda
@pytest.mark.parametrize('name', ['scale_add', 'block_double', 'rowsum'])
def test_user_kernels_on_the_card(module, name):
    """The kernels of tests/test_rtc.py on their inputs; scale_add at two
    shapes through one CudaKernel, as the Pallas test reuses its op."""
    k = module.get_kernel(name, USER_KERNELS[name]['signature'])
    shapes = [_inputs(0)[name]]
    if name == 'scale_add':
        shapes.append([a[:, :100].copy() for a in shapes[0]])
    for inputs in shapes:
        xs = [nd.array(a, ctx=mt.gpu(0)) for a in inputs]
        out = launch_user_kernel(k, name, xs)
        want = USER_KERNELS[name]['plain'](*[x._data for x in xs])
        torch.testing.assert_close(out._data, want,
                                   rtol=1e-5 if name == 'rowsum' else 0,
                                   atol=1e-6 if name == 'rowsum' else 0)


@pytest.mark.cuda
def test_gelu_kernels_on_the_card(module):
    x = nd.array(onp.random.RandomState(0).randn(1000).astype('f') * 3,
                 ctx=mt.gpu(0))
    dy = nd.array(onp.random.RandomState(1).randn(1000).astype('f'),
                  ctx=mt.gpu(0))
    for name, ins in (('gelu_fwd', [x]), ('gelu_bwd', [x, dy])):
        k = module.get_kernel(name, USER_KERNELS[name]['signature'])
        out = launch_user_kernel(k, name, ins)
        torch.testing.assert_close(
            out._data, USER_KERNELS[name]['plain'](*[a._data for a in ins]),
            rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
def test_launch_into_a_view_leaves_the_source_unchanged(module):
    k = module.get_kernel('scale_add', USER_KERNELS['scale_add']['signature'])
    a = nd.array(onp.arange(8.0, dtype='f'), ctx=mt.gpu(0))
    b = a.reshape((2, 4))
    x = nd.ones((2, 4), ctx=mt.gpu(0))
    k.launch([x, x, b, 8], mt.gpu(0), (1, 1, 1), (32, 1, 1))
    onp.testing.assert_array_equal(b.asnumpy(), onp.full((2, 4), 3.0))
    onp.testing.assert_array_equal(a.asnumpy(), onp.arange(8.0))
    t = nd.array(onp.arange(8.0, dtype='f').reshape(2, 4), ctx=mt.gpu(0)).T
    k.launch([t, x.T, t, 8], mt.gpu(0), (1, 1, 1), (32, 1, 1))
    onp.testing.assert_array_equal(
        t.asnumpy(), onp.arange(8.0).reshape(2, 4).T * 2 + 1)


@pytest.mark.cuda
def test_launch_from_a_second_thread(module):
    k = module.get_kernel('scale_add', USER_KERNELS['scale_add']['signature'])
    x = nd.ones((4, 64), ctx=mt.gpu(0))
    out, errors = [], []

    def work():
        try:
            out.append(launch_user_kernel(k, 'scale_add', [x, x]).asnumpy())
            mod2 = rtc.CudaModule(RTC_SOURCE)
            k2 = mod2.get_kernel('rowsum', USER_KERNELS['rowsum']['signature'])
            out.append(launch_user_kernel(k2, 'rowsum', [x]).asnumpy())
        except Exception as e:                      # noqa: BLE001
            errors.append(e)
    t = threading.Thread(target=work)
    t.start()
    t.join(timeout=120)
    assert not t.is_alive() and not errors, errors
    onp.testing.assert_array_equal(out[0], onp.full((4, 64), 3.0))
    onp.testing.assert_array_equal(out[1], onp.full((4, 1), 64.0))


@pytest.mark.cuda
def test_launch_inside_a_recorded_graph(module):
    """A launch into an array that a recorded graph saved leaves the graph
    intact (torch's version counter would raise on an in-place write)."""
    k = module.get_kernel('scale_add', USER_KERNELS['scale_add']['signature'])
    w = nd.array(onp.ones(4, 'f'), ctx=mt.gpu(0))
    w.attach_grad()
    with mt.autograd.record():
        h = w * 3
        y = (h * h).sum()
    k.launch([h, h, h, 4], mt.gpu(0), (1, 1, 1), (32, 1, 1))
    y.backward()
    onp.testing.assert_array_equal(w.grad.asnumpy(), onp.full(4, 18.0))
    onp.testing.assert_array_equal(h.asnumpy(), onp.full(4, 9.0))


@pytest.mark.cuda
def test_exports_fp16_and_dynamic_shared_memory():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    src = r'''
#include <cuda_fp16.h>
template <typename T> __global__ void twice(const T *x, T *y, int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) y[i] = x[i] + x[i];
}
extern "C" __global__ void stage(const float *x, float *y, int n) {
  extern __shared__ float buf[];
  for (int i = threadIdx.x; i < n; i += blockDim.x) buf[i] = x[i];
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += blockDim.x) y[i] = buf[n - 1 - i];
}
'''
    mod = rtc.CudaModule(src, exports=['twice<__half>', 'twice<float>'])
    h = nd.array(onp.arange(5, dtype='f'), ctx=mt.gpu(0)).astype('float16')
    out = nd.zeros((5,), ctx=mt.gpu(0), dtype='float16')
    mod.get_kernel('twice<__half>', 'const __half *x, __half *y, int n') \
        .launch([h, out, 5], mt.gpu(0), (1, 1, 1), (32, 1, 1))
    onp.testing.assert_array_equal(out.asnumpy(), onp.arange(5) * 2.0)
    n = 16384                                   # 64 KB of shared memory
    x = nd.array(onp.arange(n, dtype='f'), ctx=mt.gpu(0))
    y = nd.zeros((n,), ctx=mt.gpu(0))
    mod.get_kernel('stage', 'const float *x, float *y, int n').launch(
        [x, y, n], mt.gpu(0), (1, 1, 1), (256, 1, 1), shared_mem=4 * n)
    onp.testing.assert_array_equal(y.asnumpy(), onp.arange(n)[::-1])
    with pytest.raises(mt.MXNetError, match='not found'):
        mod.get_kernel('twice', 'const float *x, float *y, int n')


@pytest.mark.cuda
def test_compile_errors_carry_the_log():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    with pytest.raises(mt.MXNetError, match='undefined_name'):
        rtc.CudaModule('extern "C" __global__ void k(float *x) '
                       '{ x[0] = undefined_name; }')
