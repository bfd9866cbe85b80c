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
from test_torch_jax_globals import jax_globals  # noqa: F401


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


@pytest.mark.parametrize('M,K,N', [(8, 128, 256), (20, 96, 200),
                                   (200, 72, 100)])
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


# ---- gradients through the autograd Functions, against jax.grad of the
# ---- JAX custom_vjps (interpret mode), with one numpy cotangent

def _jax_grads(fn, args, cot):
    import jax
    return jax.grad(lambda *a: jnp.sum(fn(*a).astype(jnp.float32) *
                                       jnp.asarray(cot)),
                    argnums=tuple(range(len(args))))(*args)


def _torch_grads(fn, args, cot):
    ts = [a.requires_grad_() for a in args]
    out = fn(*ts)
    return torch.autograd.grad(out, ts, torch.from_numpy(cot).to(out.dtype))


def test_fused_layernorm_f32_gradients_match_pallas():
    x, r, g, b = _ln_inputs((2, 16, 256), 10)
    cot = onp.random.RandomState(11).randn(2, 16, 256).astype(onp.float32)
    want = _jax_grads(lambda *a: j_fused_ln(*a, 1e-5, 8, True),
                      [jnp.asarray(a) for a in (x, r, g, b)], cot)
    got = _torch_grads(lambda *a: fused_add_layer_norm(*a, 1e-5),
                       [torch.from_numpy(a) for a in (x, r, g, b)], cot)
    for name, t, j in zip(('x', 'res', 'gamma', 'beta'), got, want):
        # the f32 bound of tests/test_rtc.py:58
        onp.testing.assert_allclose(t.numpy(), onp.asarray(j), atol=3e-5,
                                    err_msg=f'd{name}')


def test_fused_layernorm_bf16_backward_uses_the_bf16_sum():
    """JAX saves x + res summed in x's dtype: in bf16 the backward takes its
    statistics from the rounded sum. The port saves the same sum, so dx
    agrees with JAX to bf16 rounding, and an f32 sum would not."""
    from mxnet_tpu_torch.ops.fused_layernorm import add_layer_norm_backward
    rng = onp.random.RandomState(12)
    x, r = rng.randn(2, 8, 128) * 4, rng.randn(2, 8, 128) * 4
    g = (rng.rand(128) + 0.5).astype(onp.float32)
    b = rng.randn(128).astype(onp.float32)
    cot = rng.randn(2, 8, 128).astype(onp.float32)
    jb = [jnp.asarray(a, jnp.float32).astype(jnp.bfloat16) for a in (x, r)]
    want = _jax_grads(lambda x_, r_, g_, b_: j_fused_ln(x_, r_, g_, b_,
                                                        1e-5, 8, True),
                      jb + [jnp.asarray(g), jnp.asarray(b)], cot)
    tb = [torch.tensor(a, dtype=torch.float32).to(torch.bfloat16)
          for a in (x, r)]
    got = _torch_grads(lambda *a: fused_add_layer_norm(*a, 1e-5),
                       tb + [torch.from_numpy(g), torch.from_numpy(b)], cot)
    assert got[0].dtype == torch.bfloat16 and got[2].dtype == torch.float32
    want_dx = onp.asarray(want[0].astype(jnp.float32))
    # the same bf16 dx up to one bf16 rounding of values of size ~1
    onp.testing.assert_allclose(got[0].float().numpy(), want_dx, atol=2e-2)
    onp.testing.assert_array_equal(got[0].float().numpy(),
                                   got[1].float().numpy())
    onp.testing.assert_allclose(got[2].numpy(), onp.asarray(want[2]),
                                rtol=1e-4, atol=1e-4)
    onp.testing.assert_allclose(got[3].numpy(), onp.asarray(want[3]),
                                rtol=1e-4, atol=1e-4)
    # the saved sum is the bf16 one: the Function's dx is the backward of
    # the bf16 sum exactly, and the backward of the f32 sum strays from
    # JAX's dx at more places
    xb, rb = (t.detach() for t in tb)
    s_bf16 = xb + rb
    s_f32 = xb.float() + rb.float()
    assert not torch.equal(s_bf16.float(), s_f32)
    gt = torch.from_numpy(cot).to(torch.bfloat16)
    gm = torch.from_numpy(g)
    dx_bf16 = add_layer_norm_backward(s_bf16, gm, gt)[0]
    torch.testing.assert_close(dx_bf16, got[0], rtol=0, atol=0)
    dx_f32 = add_layer_norm_backward(s_f32, gm, gt)[0].to(torch.bfloat16)
    off_bf16 = int((dx_bf16.float().numpy() != want_dx).sum())
    off_f32 = int((dx_f32.float().numpy() != want_dx).sum())
    assert off_f32 > off_bf16, (off_f32, off_bf16)


@pytest.mark.parametrize('M,K,N', [(8, 128, 256), (20, 96, 200),
                                   (200, 72, 100)])
def test_fused_ffn_gradients_match_pallas(M, K, N):
    x, w, b = _ffn_inputs(M, K, N, 13)
    cot = onp.random.RandomState(14).randn(M, N).astype(onp.float32)
    want = _jax_grads(lambda *a: j_fused_ffn(*a, 256, 256, True),
                      [jnp.asarray(a) for a in (x, w, b)], cot)
    got = _torch_grads(fused_dense_gelu,
                       [torch.from_numpy(a) for a in (x, w, b)], cot)
    for name, t, j in zip('xwb', got, want):
        # the grad bound of tests/test_autotune.py:280
        onp.testing.assert_allclose(t.numpy(), onp.asarray(j), rtol=2e-5,
                                    atol=2e-5, err_msg=f'd{name}')


# ---- FFN1's kernel routing, decided from dtype and K on any device

@pytest.mark.parametrize('dtype,K,variant', [
    (torch.bfloat16, 768, 'tc'), (torch.bfloat16, 72, 'tc'),
    (torch.bfloat16, 8, 'tc'), (torch.bfloat16, 70, 'wmma'),
    (torch.bfloat16, 100, 'wmma'), (torch.float16, 768, 'tc'),
    (torch.float16, 70, 'wmma'), (torch.float32, 768, 'simt'),
    (torch.float32, 72, 'simt')])
def test_ffn_kernel_variant_routes_by_dtype_and_k(dtype, K, variant):
    from mxnet_tpu_torch.ops.fused_ffn import kernel_variant
    assert kernel_variant(dtype, K) == variant


@pytest.mark.parametrize('dtype,K,forced,want', [
    (torch.bfloat16, 768, None, 'tc'), (torch.bfloat16, 768, 'wmma', 'wmma'),
    (torch.bfloat16, 768, 'tc', 'tc'), (torch.bfloat16, 70, None, 'wmma'),
    (torch.bfloat16, 70, 'tc', 'refused'), (torch.bfloat16, 768, 'simt',
                                            'refused'),
    (torch.float32, 768, 'wmma', 'refused'), (torch.float32, 768, None,
                                              'simt'),
    (torch.float16, 768, None, 'tc'), (torch.float16, 768, 'wmma', 'wmma'),
    (torch.float16, 768, 'simt', 'refused'),
    (torch.bfloat16, 768, 'mma', 'unknown')])
def test_ffn_private_variant_is_checked(dtype, K, forced, want):
    """``_variant`` may name only a kernel that takes the inputs: 'wmma' at
    bf16 (for timing the first design beside the new one), never 'tc' at a
    K that is no multiple of 8 nor a bf16 kernel for f32."""
    from mxnet_tpu_torch.base import MXNetError
    from mxnet_tpu_torch.ops.fused_ffn import _pick_variant
    x = torch.zeros(4, K, dtype=dtype)
    w = torch.zeros(6, K, dtype=dtype)
    if want in ('refused', 'unknown'):
        with pytest.raises(MXNetError, match='does not take' if
                           want == 'refused' else 'unknown kernel variant'):
            _pick_variant(x, w, forced)
    else:
        assert _pick_variant(x, w, forced) == want


def test_ffn_tensor_core_kernel_refuses_an_offset_view():
    """The tc kernel's tensor maps need x and w on 16-byte aligned
    addresses: a view that starts 2 bytes into its buffer is refused; the
    first bf16 design takes it."""
    from mxnet_tpu_torch.base import MXNetError
    from mxnet_tpu_torch.ops.fused_ffn import _pick_variant
    M, K, N = 4, 72, 6
    buf = torch.zeros(N * K + 8, dtype=torch.bfloat16)
    x_off = buf[1:M * K + 1].view(M, K)
    w = torch.zeros(N, K, dtype=torch.bfloat16)
    with pytest.raises(MXNetError, match='x is not 16-byte aligned'):
        _pick_variant(x_off, w, None)
    with pytest.raises(MXNetError, match='w is not 16-byte aligned'):
        _pick_variant(w, buf[1:N * K + 1].view(N, K), None)
    assert _pick_variant(x_off, w, 'wmma') == 'wmma'
    assert _pick_variant(buf[8:M * K + 8].view(M, K), w, None) == 'tc'


def test_ffn_private_variant_changes_nothing_on_the_cpu():
    x, w, b = (torch.from_numpy(a).to(torch.bfloat16)
               for a in _ffn_inputs(20, 72, 100, 15))
    want = fused_dense_gelu(x, w, b)
    for variant in ('tc', 'wmma'):
        assert torch.equal(fused_dense_gelu(x, w, b, _variant=variant), want)


# ---- float16 (AMP's GPU target) and mixed dtypes


@pytest.mark.parametrize('M,K,N', [(8, 128, 256), (20, 96, 200)])
def test_fused_ffn_float16_matches_pallas(M, K, N):
    """C's plain version in float16 against the Pallas kernel in interpret
    mode on the same float16 inputs: f32 products and GELU on both sides,
    the output rounded to float16 (twice float16's epsilon)."""
    x, w, b = (a.astype(onp.float16) for a in _ffn_inputs(M, K, N, 21))
    want = j_fused_ffn(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                       interpret=True)
    got = fused_dense_gelu(*(torch.from_numpy(a) for a in (x, w, b)))
    assert want.dtype == jnp.float16 and got.dtype == torch.float16
    onp.testing.assert_allclose(got.float().numpy(),
                                onp.asarray(want).astype(onp.float32),
                                rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize('knob', ['0', '1'])
@pytest.mark.parametrize('low', ['float16', 'bfloat16'])
def test_add_layer_norm_promotes_mixed_dtypes_as_jax(monkeypatch, knob, low):
    """AMP's residual seam: an f32 x and a low-precision res (a Dense
    output under amp.init). Both packages compute LN(x + res) on the
    promoted sum, in f32, on either route of the port (the fused wrapper
    promotes before its kernel, the plain path by x + res); the result is
    f32. The sum of an f32 and a rounded value is exact in both, so the
    f32 bound holds."""
    monkeypatch.setenv('MXTPU_PALLAS_LN', knob)
    x, r, g, b = _ln_inputs((3, 10, 64), 22)
    want = jnn.add_layer_norm(jnp.asarray(x), jnp.asarray(r).astype(low),
                              jnp.asarray(g), jnp.asarray(b))
    rt = torch.from_numpy(r).to(getattr(torch, low))
    got = tnn.add_layer_norm(torch.from_numpy(x), rt, torch.from_numpy(g),
                             torch.from_numpy(b))
    direct = fused_add_layer_norm(torch.from_numpy(x), rt,
                                  torch.from_numpy(g), torch.from_numpy(b))
    assert want.dtype == jnp.float32
    assert got.dtype == direct.dtype == torch.float32
    onp.testing.assert_allclose(got.numpy(), onp.asarray(want), atol=2e-5)
    onp.testing.assert_allclose(direct.numpy(), onp.asarray(want), atol=2e-5)
