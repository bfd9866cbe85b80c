"""``nd.linalg`` and the quantized ops of the port against the JAX
package's, on the CPU, and the registered updates' in-place writes.

- The ``linalg_*`` family by value (f32, rtol 1e-5, atol 1e-5 on
  products of 4x4 inputs) in both packages, batched and not, and by
  invariants where the result has sign or order freedoms: gelqf
  (Q·Qᵀ = I, L·Q = A, L lower triangular), syevd (U·A·Uᵀ diagonal,
  eigenvalues ascending, U orthonormal), potrf (L·Lᵀ = A).
- The quantized ops against the JAX ones exactly (integer outputs bit for
  bit, float ranges at rtol 1e-6), including an int8 product with
  K = 8192 whose int32 sums pass 2^24, where an f32 route would round.
- ``nd.<update>(..., out=w)`` writes the weight and every state in
  place, as MXNet's updates do; ``nd.reset_arrays`` zeroes every input.
"""
import numpy as onp
import pytest
import torch

import mxnet_tpu as mj
import mxnet_tpu_torch as mt
from mxnet_tpu.base import get_op as jget
from mxnet_tpu_torch.base import get_op as tget
from test_torch_jax_globals import jax_globals  # noqa: F401

R = onp.random.RandomState(17)


@pytest.fixture(autouse=True)
def _port_on_cpu():
    with mt.cpu():
        yield


def _spd(n, batch=()):
    a = R.randn(*batch, n, n).astype(onp.float32)
    return (a @ onp.swapaxes(a, -1, -2) + n * onp.eye(n, dtype=onp.float32))


def _pair(name, *args, **kwargs):
    want = getattr(mj.nd.linalg, name)(*[mj.nd.array(a) for a in args],
                                       **kwargs)
    got = getattr(mt.nd.linalg, name)(*[mt.nd.array(a) for a in args],
                                      **kwargs)
    return got, want


def _close(got, want, rtol=1e-5, atol=1e-5):
    if isinstance(want, (tuple, list)):
        for g, w in zip(got, want):
            _close(g, w, rtol, atol)
        return
    assert got.shape == want.shape and got.dtype == want.dtype
    onp.testing.assert_allclose(got.asnumpy(), want.asnumpy(), rtol=rtol,
                                atol=atol)


A34, B43 = R.randn(3, 4).astype(onp.float32), R.randn(4, 3).astype(
    onp.float32)


@pytest.mark.parametrize('name,args,kwargs', [
    ('gemm', (A34, B43, R.randn(3, 3).astype(onp.float32)),
     dict(alpha=0.5, beta=2.0)),
    ('gemm', (A34.T.copy(), B43.T.copy(), R.randn(3, 3).astype(onp.float32)),
     dict(transpose_a=True, transpose_b=True)),
    ('gemm2', (A34, B43), dict(alpha=2.0)),
    ('gemm2', (R.randn(2, 3, 4).astype(onp.float32),
               R.randn(2, 5, 4).astype(onp.float32)),
     dict(transpose_b=True)),
    ('potrf', (_spd(4),), {}), ('potri', (_spd(4),), {}),
    ('potrf', (_spd(3, (2,)),), {}),
    ('trsm', (onp.tril(_spd(4)), R.randn(4, 3).astype(onp.float32)), {}),
    ('trsm', (onp.tril(_spd(4)), R.randn(3, 4).astype(onp.float32)),
     dict(rightside=True, alpha=2.0)),
    ('trsm', (onp.tril(_spd(4)), R.randn(4, 3).astype(onp.float32)),
     dict(transpose=True)),
    ('trmm', (_spd(4), R.randn(4, 3).astype(onp.float32)), {}),
    ('trmm', (_spd(4), R.randn(3, 4).astype(onp.float32)),
     dict(rightside=True, lower=False, transpose=True)),
    ('syrk', (A34,), {}), ('syrk', (A34,), dict(transpose=True,
                                                alpha=0.5)),
    ('sumlogdiag', (_spd(4),), {}), ('extractdiag', (_spd(4),),
                                     dict(offset=1)),
    ('makediag', (R.randn(2, 3).astype(onp.float32),), dict(offset=-1)),
    ('det', (_spd(3, (2,)),), {}), ('inverse', (_spd(4),), {}),
    ('slogdet', (_spd(4),), {}),
    ('linalg_extracttrian', (_spd(4),), {}),
    ('linalg_extracttrian', (_spd(4),), dict(offset=1, lower=False)),
    ('linalg_maketrian', (R.randn(2, 6).astype(onp.float32),), {}),
    ('linalg_maketrian', (R.randn(6).astype(onp.float32),),
     dict(offset=-1)),
])
def test_linalg_matches_jax(name, args, kwargs):
    if name.startswith('linalg_'):      # nd.linalg_<name>, as in JAX
        want = getattr(mj.nd, name)(*[mj.nd.array(a) for a in args],
                                    **kwargs)
        got = getattr(mt.nd, name)(*[mt.nd.array(a) for a in args],
                                   **kwargs)
    else:
        got, want = _pair(name, *args, **kwargs)
    _close(got, want, atol=1e-4 if name in ('potri', 'inverse', 'det')
           else 1e-5)


def test_gelqf_by_invariants():
    a = R.randn(3, 5).astype(onp.float32)
    L, Q = [x.asnumpy().astype(onp.float64) for x in
            mt.nd.linalg_gelqf(mt.nd.array(a))]
    onp.testing.assert_allclose(Q @ Q.T, onp.eye(3), atol=1e-5)
    onp.testing.assert_allclose(L @ Q, a, atol=1e-5)
    assert onp.allclose(L, onp.tril(L)) and (onp.diag(L) >= 0).all()
    jl, jq = mj.nd.linalg_gelqf(mj.nd.array(a))
    onp.testing.assert_allclose(L, jl.asnumpy(), atol=1e-5)
    onp.testing.assert_allclose(Q, jq.asnumpy(), atol=1e-5)


def test_syevd_by_invariants():
    a = _spd(5)
    U, lam = [x.asnumpy().astype(onp.float64) for x in
              mt.nd.linalg_syevd(mt.nd.array(a))]
    onp.testing.assert_allclose(U @ U.T, onp.eye(5), atol=1e-5)
    d = U @ a @ U.T
    onp.testing.assert_allclose(d, onp.diag(onp.diag(d)), atol=1e-4)
    onp.testing.assert_allclose(onp.diag(d), lam, rtol=1e-5)
    assert (onp.diff(lam) >= 0).all()
    _, jlam = mj.nd.linalg_syevd(mj.nd.array(a))
    onp.testing.assert_allclose(lam, jlam.asnumpy(), rtol=1e-5)


def test_potrf_reconstructs():
    a = _spd(6)
    L = mt.nd.linalg.potrf(mt.nd.array(a)).asnumpy().astype(onp.float64)
    onp.testing.assert_allclose(L @ L.T, a, rtol=1e-5, atol=1e-5)


def test_potri_takes_the_matrix_as_in_jax():
    """MXNet's potri takes the Cholesky factor L and returns (L·Lᵀ)⁻¹; the
    JAX op factors its input first, so it takes the SPD matrix itself.
    The port mirrors it (ROADMAP queue 3)."""
    a = _spd(4)
    inv = mt.nd.linalg.potri(mt.nd.array(a)).asnumpy()
    onp.testing.assert_allclose(inv @ a, onp.eye(4), atol=1e-4)


# --- quantized ops ---------------------------------------------------------

def _q(*shape):
    return R.randint(-127, 128, shape).astype(onp.int8)


def _run_both(name, *args, **kwargs):
    want = jget(name).fn(*[mj.nd.array(a)._data if isinstance(
        a, onp.ndarray) else a for a in args], **kwargs)
    got = tget(name).fn(*[torch.tensor(a) if isinstance(a, onp.ndarray)
                          else a for a in args], **kwargs)
    return got, want


def _exact(got, want):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g = g.numpy() if isinstance(g, torch.Tensor) else onp.asarray(g)
        w = onp.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape
        if w.dtype.kind == 'f':
            onp.testing.assert_allclose(g, w, rtol=1e-6)
        else:
            onp.testing.assert_array_equal(g, w)


def test_int8_product_is_exact_past_two_to_the_24():
    K = 8192
    data = onp.full((4, K), 127, onp.int8)
    data[1] = -127
    data[2:] = _q(2, K)
    weight = onp.full((3, K), 127, onp.int8)
    weight[2] = _q(K)
    got, want = _run_both('quantized_fully_connected', data, weight,
                          min_data=-1.0, max_data=1.0, min_weight=-1.0,
                          max_weight=1.0, no_bias=True)
    _exact(got, want)
    exact = data.astype(onp.int64) @ weight.astype(onp.int64).T
    assert abs(exact).max() > 2 ** 24
    onp.testing.assert_array_equal(got[0].numpy(), exact)
    # an f32 product rounds these sums
    f32 = (data.astype(onp.float32) @ weight.astype(onp.float32).T)
    assert (f32.astype(onp.int64) != exact).any() or \
        abs(exact).max() > 2 ** 24


def test_quantized_conv_is_exact_and_matches_jax():
    data, weight = _q(2, 64, 9, 9), _q(8, 64, 3, 3)
    bias = _q(8)
    got, want = _run_both('quantized_conv', data, weight, bias,
                          min_data=-2.0, max_data=2.0, min_weight=-0.5,
                          max_weight=0.5, min_bias=-1.0, max_bias=1.0,
                          kernel=(3, 3), pad=(1, 1), num_filter=8)
    _exact(got, want)


@pytest.mark.parametrize('name,args,kwargs', [
    ('quantize', ('F', -1.0, 1.0), dict(out_type='int8')),
    ('quantize', ('F', -1.0, 1.0), dict(out_type='uint8')),
    ('quantize_v2', ('F',), {}),
    ('quantize_v2', ('F',), dict(min_calib_range=-0.5,
                                 max_calib_range=0.5)),
    ('dequantize', ('Q', -2.0, 2.0), {}),
    ('requantize', ('I', -50.0, 50.0), {}),
    ('requantize', ('I', -50.0, 50.0), dict(min_calib_range=-1.0,
                                            max_calib_range=1.0)),
    ('quantized_pooling', ('Q4', -1.0, 1.0), dict(kernel=(2, 2),
                                                  stride=(2, 2))),
    ('quantized_pooling', ('Q4', -1.0, 1.0), dict(kernel=(3, 3),
                                                  pad=(1, 1),
                                                  pool_type='avg')),
    ('quantized_pooling', ('Q4', -1.0, 1.0), dict(global_pool=True,
                                                  pool_type='avg')),
    ('quantized_flatten', ('Q4', -1.0, 1.0), {}),
    ('quantized_elemwise_add', ('Q', 'Q', -1.0, 1.0, -3.0, 3.0), {}),
    ('quantized_concat', ('Q', -1.0, 1.0, 'Q', -3.0, 3.0), dict(dim=0)),
    ('quantized_act', ('Q', -1.0, 1.0), {}),
    ('quantized_act', ('Q', -1.0, 1.0), dict(act_type='tanh')),
    ('quantized_elemwise_mul', ('Q', 'Q', -1.0, 1.0, -2.0, 2.0), {}),
])
def test_quantized_op_matches_jax_exactly(name, args, kwargs):
    make = {'F': lambda: R.randn(4, 6).astype(onp.float32),
            'Q': lambda: _q(4, 6), 'Q4': lambda: _q(2, 3, 6, 6),
            'I': lambda: R.randint(-2 ** 30, 2 ** 30, (4, 6)).astype(
                onp.int32)}
    args = tuple(make[a]() if isinstance(a, str) else a for a in args)
    got, want = _run_both(name, *args, **kwargs)
    _exact(got, want)


def test_quantized_batch_norm_and_embedding_match_jax():
    got, want = _run_both('quantized_batch_norm', _q(2, 3, 4, 4),
                          onp.ones(3, onp.float32),
                          onp.zeros(3, onp.float32),
                          R.randn(3).astype(onp.float32) * 0.1,
                          onp.ones(3, onp.float32) * 1.5, -1.0, 1.0)
    _exact(got, want)
    got, want = _run_both('quantized_embedding',
                          R.randint(0, 5, (3,)).astype(onp.int32), _q(5, 4),
                          -1.0, 1.0)
    _exact(got, want)


# --- in-place updates -------------------------------------------------------

def test_update_with_out_writes_weight_and_states_in_place():
    w0 = R.randn(3, 4).astype(onp.float32)
    g = R.randn(3, 4).astype(onp.float32)
    w, m, v = mt.nd.array(w0), mt.nd.zeros((3, 4)), mt.nd.zeros((3, 4))
    out = mt.nd.adamw_update(w, mt.nd.array(g), m, v, out=w, lr=0.1,
                             wd=0.01)
    assert out is w
    jw, jm, jv = mj.nd.adamw_update(mj.nd.array(w0), mj.nd.array(g),
                                    mj.nd.zeros((3, 4)),
                                    mj.nd.zeros((3, 4)), lr=0.1, wd=0.01)
    for a, b in ((w, jw), (m, jm), (v, jv)):
        onp.testing.assert_allclose(a.asnumpy(), b.asnumpy(), rtol=1e-6)
    # without out= the weight is left alone, the states still move
    w2 = mt.nd.array(w0)
    res = mt.nd.sgd_mom_update(w2, mt.nd.array(g), m, lr=0.1, momentum=0.9)
    onp.testing.assert_array_equal(w2.asnumpy(), w0)
    assert isinstance(res, tuple) and len(res) == 2
    onp.testing.assert_array_equal(m.asnumpy(), res[1].asnumpy())


def test_multi_update_writes_lists_in_place():
    ws = [mt.nd.array(R.randn(3).astype(onp.float32)) for _ in range(2)]
    gs = [mt.nd.array(R.randn(3).astype(onp.float32)) for _ in range(2)]
    ms = [mt.nd.zeros((3,)) for _ in range(2)]
    vs = [mt.nd.zeros((3,)) for _ in range(2)]
    before = [w.asnumpy() for w in ws]
    new_ws, new_ms, new_vs = tget('multi_adamw_update').fn(
        [w._data for w in ws], [g._data for g in gs],
        [m._data for m in ms], [v._data for v in vs], torch.tensor(1.0),
        [0.1, 0.1], [1.0, 1.0], [0.0, 0.0])
    mt.nd.multi_adamw_update(ws, gs, ms, vs, mt.nd.array([1.0]),
                             [0.1, 0.1], [1.0, 1.0], [0.0, 0.0], out=ws)
    for w, b, nw, m, nm in zip(ws, before, new_ws, ms, new_ms):
        assert not onp.array_equal(w.asnumpy(), b)
        onp.testing.assert_array_equal(w.asnumpy(), nw.numpy())
        onp.testing.assert_array_equal(m.asnumpy(), nm.numpy())


def test_reset_arrays_zeroes_every_input():
    a, b = mt.nd.ones((2, 2)), mt.nd.ones((3,))
    mt.nd.reset_arrays(a, b)
    assert not a.asnumpy().any() and not b.asnumpy().any()
    assert tget('reset_arrays').mutate_inputs == 'all'
