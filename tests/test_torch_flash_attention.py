"""The port's flash-attention forward (mxnet_tpu_torch/ops/flash_attention.py)
against the JAX package's Pallas kernel run through the Pallas
interpreter on the CPU.

On the CPU the port's wrapper runs its plain version, which does the
kernel's arithmetic in torch f32; the CUDA kernel itself is held against
that plain version on the card by chip_smoke.py. Inputs are made with
numpy from a seed and handed to both packages.

Every row here keeps at least one key. A row whose keys are all masked
gets the average of the values its tiles saw (every score is -1e30, so
p = 1 everywhere); that depends on the tiling and is not asserted.
"""
import jax.numpy as jnp
import numpy as onp
import pytest
import torch

from mxnet_tpu.ops import pallas_attention as pa
from mxnet_tpu_torch.ops import flash_attention as fa
from test_torch_jax_globals import jax_globals  # noqa: F401

B, H, T, D = 2, 2, 20, 8     # T = 20 is not a block multiple
RTOL, ATOL = 1e-4, 1e-5      # the bound of tests/test_operator.py:312


def _qkv(seed=0):
    rng = onp.random.RandomState(seed)
    return [rng.randn(B, H, T, D).astype(onp.float32) for _ in range(3)]


def _mask(kind, seed=1):
    """(B, T) key mask: None, additive f32, or boolean keep."""
    if kind is None:
        return None
    valid = onp.array([T, 13])
    keep = onp.arange(T)[None, :] < valid[:, None]
    if kind == 'bool':
        return keep
    rng = onp.random.RandomState(seed)
    return onp.where(keep, rng.randn(B, T) * 0.5, -1e30).astype(onp.float32)


@pytest.mark.parametrize('causal', [False, True])
@pytest.mark.parametrize('mask_kind', [None, 'additive', 'bool'])
def test_forward_matches_pallas_kernel(causal, mask_kind):
    q, k, v = _qkv()
    m = _mask(mask_kind)
    j_out = pa.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        key_mask=None if m is None else jnp.asarray(m), causal=causal,
        interpret=True)
    t_out, t_lse = fa.flash_attention_forward(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        key_mask=None if m is None else torch.from_numpy(m), causal=causal)
    onp.testing.assert_allclose(t_out.numpy(), onp.asarray(j_out),
                                rtol=RTOL, atol=ATOL)

    # lse against the JAX forward's second output, on (B*H, T)
    km = None
    if m is not None:
        add = onp.where(m, 0.0, -1e30) if m.dtype == bool else m
        km = jnp.asarray(onp.repeat(add.astype(onp.float32), H, axis=0))
    _, j_lse = pa._fa_forward(
        jnp.asarray(q.reshape(B * H, T, D)), jnp.asarray(k.reshape(B * H, T, D)),
        jnp.asarray(v.reshape(B * H, T, D)), km,
        jnp.zeros((1, 1), jnp.uint32), causal, 0.0, True)
    onp.testing.assert_allclose(t_lse.reshape(B * H, T).numpy(),
                                onp.asarray(j_lse), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize('trial', range(4))
def test_counter_keep_bit_for_bit(trial):
    rng = onp.random.RandomState(100 + trial)
    seed = int(rng.randint(0, 2 ** 32, dtype=onp.uint64))
    rate = float(rng.choice([0.1, 0.3, 0.5, 0.9]))
    bh = rng.randint(0, 2 ** 32, (5, 1, 1), dtype=onp.uint64).astype(onp.uint32)
    rows = rng.randint(0, 2 ** 32, (1, 7, 1), dtype=onp.uint64).astype(onp.uint32)
    cols = rng.randint(0, 2 ** 32, (1, 1, 9), dtype=onp.uint64).astype(onp.uint32)
    j = onp.asarray(pa._counter_keep(jnp.uint32(seed), jnp.asarray(bh),
                                     jnp.asarray(rows), jnp.asarray(cols),
                                     rate))
    t = fa.counter_keep(seed, torch.from_numpy(bh.astype(onp.int64)),
                        torch.from_numpy(rows.astype(onp.int64)),
                        torch.from_numpy(cols.astype(onp.int64)), rate)
    assert j.dtype == onp.float32 and t.dtype == torch.float32
    onp.testing.assert_array_equal(t.numpy(), j)


def test_dropout_forward_matches_pallas_kernel():
    q, k, v = _qkv(3)
    j_out = pa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               dropout_p=0.3, dropout_seed=42, interpret=True)
    t_out = fa.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), dropout_p=0.3,
                               dropout_seed=42)
    onp.testing.assert_allclose(t_out.numpy(), onp.asarray(j_out),
                                rtol=RTOL, atol=ATOL)
    # dropout really dropped something: the output differs from p = 0
    plain = fa.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v))
    assert not torch.allclose(plain, t_out)


# float16 (AMP's GPU target): outputs rounded to float16 by both sides may
# differ by an ulp, so twice float16's epsilon
F16_RTOL, F16_ATOL = 2e-3, 2e-3


@pytest.mark.parametrize('causal', [False, True])
@pytest.mark.parametrize('mask_kind', [None, 'additive', 'bool'])
@pytest.mark.parametrize('dropout_p', [0.0, 0.3])
def test_float16_forward_matches_pallas_kernel(causal, mask_kind, dropout_p):
    """float16 q, k, v through the Pallas kernel in interpret mode and the
    port's plain version: P cast to float16 before P.V on both sides, the
    output in float16, lse in f32."""
    q, k, v = (a.astype(onp.float16) for a in _qkv(7))
    m = _mask(mask_kind)
    seed = 42 if dropout_p else None
    j_out = pa.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        key_mask=None if m is None else jnp.asarray(m), causal=causal,
        dropout_p=dropout_p, dropout_seed=seed, interpret=True)
    t_out, t_lse = fa.flash_attention_forward(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        key_mask=None if m is None else torch.from_numpy(m), causal=causal,
        dropout_p=dropout_p, dropout_seed=seed)
    assert j_out.dtype == jnp.float16 and t_out.dtype == torch.float16
    assert t_lse.dtype == torch.float32
    onp.testing.assert_allclose(t_out.float().numpy(),
                                onp.asarray(j_out).astype(onp.float32),
                                rtol=F16_RTOL, atol=F16_ATOL)


def test_wrapper_argument_errors():
    q, k, v = (torch.from_numpy(a) for a in _qkv())
    with pytest.raises(ValueError, match='dropout_seed'):
        fa.flash_attention(q, k, v, dropout_p=0.1)
    with pytest.raises(ValueError, match='neither'):
        fa.flash_attention(q, k, v, key_mask=torch.zeros(3, T))


def test_per_head_mask_matches_per_batch_mask():
    q, k, v = (torch.from_numpy(a) for a in _qkv(5))
    m = torch.from_numpy(_mask('additive'))
    a = fa.flash_attention(q, k, v, key_mask=m)
    b = fa.flash_attention(q, k, v, key_mask=m.repeat_interleave(H, dim=0))
    torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize('dtype,D,variant', [
    (torch.bfloat16, 16, 'tc'), (torch.bfloat16, 32, 'tc'),
    (torch.bfloat16, 64, 'tc'), (torch.bfloat16, 128, 'tc'),
    (torch.bfloat16, 8, 'simt'), (torch.float16, 16, 'tc'),
    (torch.float16, 64, 'tc'), (torch.float16, 128, 'tc'),
    (torch.float16, 8, 'simt'), (torch.float32, 64, 'simt'),
    (torch.float32, 8, 'simt')])
def test_kernel_variant_routes_by_dtype_and_head_dim(dtype, D, variant):
    assert fa.kernel_variant(dtype, D) == variant


def test_tensor_core_alignment_check():
    """The tensor-core kernels copy 16 bytes at a time: every (B, H, T) row
    must start on 16 bytes; dims of length 1 do not count."""
    n = 2 * 3 * 20 * 64
    buf = torch.zeros(n + 8, dtype=torch.bfloat16)
    assert fa._tc_aligned(buf[:n].view(2, 3, 20, 64))
    assert not fa._tc_aligned(buf[1:n + 1].view(2, 3, 20, 64))
    # the head views of a (B, T, 3*H*D) projection are aligned
    qkv = torch.zeros(2, 20, 3 * 3 * 64, dtype=torch.bfloat16)
    for part in qkv.chunk(3, dim=-1):
        assert fa._tc_aligned(part.reshape(2, 20, 3, 64).permute(0, 2, 1, 3))
    assert not fa._tc_aligned(torch.zeros(2, 3, 20, 68,
                                          dtype=torch.bfloat16)[..., :64])
    assert fa._tc_aligned(torch.zeros(64 * 21, dtype=torch.bfloat16)
                          .as_strided((1, 1, 20, 64), (3, 5, 64, 1)))


def test_private_variant_changes_nothing_on_the_cpu():
    q, k, v = (torch.from_numpy(a) for a in _qkv())
    want = fa.flash_attention_forward(q, k, v)
    for variant in ('simt', 'tc'):
        got = fa.flash_attention_forward(q, k, v, _variant=variant)
        for g, w in zip(got, want):
            assert torch.equal(g, w)


@pytest.mark.parametrize('seed', [42, 2 ** 32 - 5])
def test_seed_as_tensor_equals_seed_as_int(seed):
    """The seed lives on the device as a one-element int64 (or int32)
    tensor, the kernels' operand; an int is put in such a tensor. Both
    give the same keep mask, so the same output and gradients, and the
    Pallas kernel given the same seed agrees."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(7))
    as_int = fa.flash_attention(q, k, v, dropout_p=0.3, dropout_seed=seed)
    as_i64 = fa.flash_attention(q, k, v, dropout_p=0.3,
                                dropout_seed=torch.tensor([seed]))
    torch.testing.assert_close(as_i64, as_int, rtol=0, atol=0)
    low32 = torch.tensor([seed], dtype=torch.int64).to(torch.int32)
    as_i32 = fa.flash_attention(q, k, v, dropout_p=0.3, dropout_seed=low32)
    torch.testing.assert_close(as_i32, as_int, rtol=0, atol=0)
    keep_t = fa._keep_multipliers(torch.tensor([seed]), B, H, T, T, 0.3,
                                  torch.device('cpu'))
    keep_i = fa._keep_multipliers(seed, B, H, T, T, 0.3, torch.device('cpu'))
    torch.testing.assert_close(keep_t, keep_i, rtol=0, atol=0)
    j_out = pa.flash_attention(*(jnp.asarray(a) for a in _qkv(7)),
                               dropout_p=0.3, dropout_seed=seed,
                               interpret=True)
    onp.testing.assert_allclose(as_i64.numpy(), onp.asarray(j_out),
                                rtol=RTOL, atol=ATOL)


def test_seed_tensor_checks_its_argument():
    dev = torch.device('cpu')
    t = torch.tensor([7, 8])
    assert fa.seed_tensor(t, dev).tolist() == [7]
    assert fa.seed_tensor(5, dev).dtype == torch.int64
    assert fa.seed_tensor(2 ** 33 + 3, dev).tolist() == [3]
    from mxnet_tpu_torch.base import MXNetError
    with pytest.raises(MXNetError, match='int64 or int32'):
        fa.seed_tensor(torch.tensor([1.0]), dev)


def test_dropout_seed_is_drawn_with_no_host_sync(monkeypatch):
    """``_dropout_seed`` draws the seed on the generator's device and
    leaves it there: nothing reads a tensor back to the host (which
    would be a sync on the card, illegal in a CUDA-graph capture), and the
    attention op hands the tensor to the flash route as it is."""
    from mxnet_tpu_torch.ops import attention as attn

    def refuse(*a, **k):
        raise AssertionError('host sync')
    gen = torch.Generator().manual_seed(3)
    monkeypatch.setattr(torch.Tensor, 'item', refuse)
    monkeypatch.setattr(torch.Tensor, 'tolist', refuse)
    monkeypatch.setattr(torch.Tensor, '__int__', refuse)
    s1 = attn._dropout_seed(gen, torch.device('cpu'))
    s2 = attn._dropout_seed(gen, torch.device('cpu'))
    assert s1.shape == (1,) and s1.dtype == torch.int64
    assert not torch.equal(s1, s2)
    assert bool(((s1 >= 0) & (s1 < 2 ** 32)).all())
    q, k, v = (torch.from_numpy(a) for a in _qkv(9))
    dropped = fa.flash_attention(q, k, v, dropout_p=0.2, dropout_seed=s1)
    monkeypatch.undo()
    torch.testing.assert_close(dropped, fa.flash_attention(
        q, k, v, dropout_p=0.2, dropout_seed=int(s1)), rtol=0, atol=0)
