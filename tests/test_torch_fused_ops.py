"""The port's fused residual+LayerNorm and FFN1 (plain versions, as they
run on the CPU) against the JAX package's Pallas kernels in interpret
mode, and the port's ops.nn seams against the JAX package's ops.nn.
Inputs come from numpy with a fixed seed and go to both packages."""
import jax.numpy as jnp
import numpy as onp
import pytest
import torch

from mxnet_tpu.ops import nn as jnn
from mxnet_tpu.ops.pallas_ffn import fused_dense_gelu as j_fused_ffn
from mxnet_tpu.ops.pallas_layernorm import fused_add_layer_norm as j_fused_ln
from mxnet_tpu_torch.ops import nn as tnn
from mxnet_tpu_torch.ops.fused_ffn import fused_dense_gelu
from mxnet_tpu_torch.ops.fused_layernorm import fused_add_layer_norm


def _ln_inputs(shape, seed):
    rng = onp.random.RandomState(seed)
    C = shape[-1]
    return (rng.randn(*shape).astype(onp.float32),
            rng.randn(*shape).astype(onp.float32),
            (rng.rand(C) + 0.5).astype(onp.float32),
            rng.randn(C).astype(onp.float32))


def test_fused_layernorm_f32_matches_pallas():
    x, r, g, b = _ln_inputs((2, 16, 256), 0)
    want = j_fused_ln(jnp.asarray(x), jnp.asarray(r), jnp.asarray(g),
                      jnp.asarray(b), 1e-5, 8, True)
    got = fused_add_layer_norm(*(torch.from_numpy(a) for a in (x, r, g, b)),
                               1e-5)
    # the f32 bound of tests/test_rtc.py:58
    onp.testing.assert_allclose(got.numpy(), onp.asarray(want), atol=2e-5)


def test_fused_layernorm_bf16_matches_pallas():
    x, r, _, _ = _ln_inputs((4, 128), 1)
    g = onp.ones(128, onp.float32)
    b = onp.zeros(128, onp.float32)
    want = j_fused_ln(jnp.asarray(x).astype(jnp.bfloat16),
                      jnp.asarray(r).astype(jnp.bfloat16), jnp.asarray(g),
                      jnp.asarray(b), 1e-5, 8, True)
    got = fused_add_layer_norm(torch.from_numpy(x).to(torch.bfloat16),
                               torch.from_numpy(r).to(torch.bfloat16),
                               torch.from_numpy(g), torch.from_numpy(b), 1e-5)
    assert got.dtype == torch.bfloat16
    # the bf16 bound of tests/test_rtc.py:95
    onp.testing.assert_allclose(got.float().numpy(),
                                onp.asarray(want.astype(jnp.float32)),
                                atol=0.05)


def _ffn_inputs(M, K, N, seed):
    rng = onp.random.RandomState(seed)
    return (rng.randn(M, K).astype(onp.float32),
            (rng.randn(N, K) * 0.05).astype(onp.float32),
            (rng.randn(N) * 0.1).astype(onp.float32))


@pytest.mark.parametrize('M,K,N', [(8, 128, 256), (20, 96, 200)])
def test_fused_ffn_matches_pallas(M, K, N):
    x, w, b = _ffn_inputs(M, K, N, 3)
    want = j_fused_ffn(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                       256, 256, True)
    got = fused_dense_gelu(torch.from_numpy(x), torch.from_numpy(w),
                           torch.from_numpy(b))
    # the forward bound of tests/test_autotune.py:280
    onp.testing.assert_allclose(got.numpy(), onp.asarray(want),
                                rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize('knob', ['0', '1'])
def test_add_layer_norm_seam_matches_jax(monkeypatch, knob):
    # on the CPU the knob routes nothing: both packages take the plain path
    monkeypatch.setenv('MXTPU_PALLAS_LN', knob)
    x, r, g, b = _ln_inputs((3, 5, 48), 4)
    want = jnn.add_layer_norm(jnp.asarray(x), jnp.asarray(r), jnp.asarray(g),
                              jnp.asarray(b), eps=1e-5)
    got = tnn.add_layer_norm(*(torch.from_numpy(a) for a in (x, r, g, b)),
                             eps=1e-5)
    onp.testing.assert_allclose(got.numpy(), onp.asarray(want),
                                rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize('knob', ['0', '1'])
def test_dense_gelu_seam_matches_jax(monkeypatch, knob):
    monkeypatch.setenv('MXTPU_PALLAS_FFN', knob)
    x, w, b = _ffn_inputs(12, 32, 64, 5)
    x = x.reshape(3, 4, 32)
    want = jnn.dense_gelu(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    got = tnn.dense_gelu(torch.from_numpy(x), torch.from_numpy(w),
                         torch.from_numpy(b))
    assert got.shape == (3, 4, 64)
    onp.testing.assert_allclose(got.numpy(), onp.asarray(want),
                                rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize('flatten', [False, True])
def test_fully_connected_matches_jax(flatten):
    rng = onp.random.RandomState(6)
    x = rng.randn(2, 3, 8).astype(onp.float32)
    in_dim = 24 if flatten else 8
    w = rng.randn(5, in_dim).astype(onp.float32)
    b = rng.randn(5).astype(onp.float32)
    want = jnn.fully_connected(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                               num_hidden=5, flatten=flatten)
    got = tnn.fully_connected(torch.from_numpy(x), torch.from_numpy(w),
                              torch.from_numpy(b), num_hidden=5,
                              flatten=flatten)
    onp.testing.assert_allclose(got.numpy(), onp.asarray(want),
                                rtol=1e-5, atol=1e-5)


def test_layer_norm_bf16_casts_before_affine_as_jax():
    x, _, g, b = _ln_inputs((4, 64), 7)
    want = jnn.layer_norm(jnp.asarray(x).astype(jnp.bfloat16),
                          jnp.asarray(g).astype(jnp.bfloat16),
                          jnp.asarray(b).astype(jnp.bfloat16), eps=1e-5)
    got = tnn.layer_norm(torch.from_numpy(x).to(torch.bfloat16),
                         torch.from_numpy(g).to(torch.bfloat16),
                         torch.from_numpy(b).to(torch.bfloat16), eps=1e-5)
    assert got.dtype == torch.bfloat16
    # one bf16 rounding of the normalised value and one of the affine:
    # at most a few bf16 ulps of values of magnitude ~3
    onp.testing.assert_allclose(got.float().numpy(),
                                onp.asarray(want.astype(jnp.float32)),
                                atol=0.05)


@pytest.mark.parametrize('act', ['relu', 'sigmoid', 'tanh', 'softrelu',
                                 'softsign', 'gelu', 'gelu_tanh', 'silu'])
def test_activation_matches_jax(act):
    x = onp.random.RandomState(8).randn(4, 9).astype(onp.float32) * 3
    want = jnn.activation(jnp.asarray(x), act_type=act)
    got = tnn.activation(torch.from_numpy(x), act_type=act)
    onp.testing.assert_allclose(got.numpy(), onp.asarray(want),
                                rtol=1e-5, atol=1e-6)


def test_embedding_clamps_like_jax():
    rng = onp.random.RandomState(9)
    w = rng.randn(10, 4).astype(onp.float32)
    ids = onp.array([[0, 3, 9], [12, -2, 5]], onp.int32)
    want = jnn.embedding(jnp.asarray(ids), jnp.asarray(w))
    got = tnn.embedding(torch.from_numpy(ids), torch.from_numpy(w))
    onp.testing.assert_array_equal(got.numpy(), onp.asarray(want))
