"""The port's flash-attention backward against the JAX package's Pallas
backward kernels (``_fa_backward``: ``_fa_dq_kernel`` and
``_fa_dkv_kernel``) run through the Pallas interpreter on the CPU.

On the CPU the port runs its plain backward, which does the kernels'
arithmetic in torch f32; the CUDA kernels are held against that plain
version on the card by chip_smoke.py and the ``cuda``-marked tests. The
second test differentiates the port's ``flash_attention`` (its autograd
Function) and the JAX ``flash_attention`` (its custom_vjp) with the same
cotangent. Inputs come from numpy with a seed. Every row keeps at least
one key.
"""
import math

import jax
import jax.numpy as jnp
import numpy as onp
import pytest
import torch

from mxnet_tpu.ops import pallas_attention as pa
from mxnet_tpu_torch.ops import flash_attention as fa
from test_torch_jax_globals import jax_globals  # noqa: F401

B, H, D = 2, 2, 8
RTOL, ATOL = 1e-4, 2e-5      # the grad bound of tests/test_operator.py:342
SEED = 42


def _inputs(T, seed=0):
    rng = onp.random.RandomState(seed)
    q, k, v, do = (rng.randn(B, H, T, D).astype(onp.float32)
                   for _ in range(4))
    return q, k, v, do


def _mask(kind, T, seed=1):
    """(B, T) key mask: None, additive f32, or boolean keep; row 1 keeps
    its first 13 keys."""
    if kind is None:
        return None
    keep = onp.arange(T)[None, :] < onp.array([T, 13])[:, None]
    if kind == 'bool':
        return keep
    rng = onp.random.RandomState(seed)
    return onp.where(keep, rng.randn(B, T) * 0.5, -1e30).astype(onp.float32)


def _additive_bh(m):
    """The (B*H, Tk) additive f32 mask the JAX wrapper builds."""
    if m is None:
        return None
    add = onp.where(m, 0.0, -1e30) if m.dtype == bool else m
    return onp.repeat(add.astype(onp.float32), H, axis=0)


CASES = [(T, causal, mask, p) for T in (20, 33) for causal in (False, True)
         for mask in (None, 'additive', 'bool') for p in (0.0, 0.3)]


@pytest.mark.parametrize('T,causal,mask_kind,dropout_p', CASES)
def test_backward_reference_matches_pallas_kernels(T, causal, mask_kind,
                                                   dropout_p):
    q, k, v, do = _inputs(T)
    m = _mask(mask_kind, T)
    tm = None if m is None else torch.from_numpy(m)
    seed = SEED if dropout_p else None
    # out and lse from the port's forward (held against the Pallas forward
    # by test_torch_flash_attention.py) feed both backwards
    out, lse = fa.flash_attention_forward(
        *(torch.from_numpy(a) for a in (q, k, v)), key_mask=tm,
        causal=causal, dropout_p=dropout_p, dropout_seed=seed)
    km = _additive_bh(m)
    flat = [jnp.asarray(a.reshape(B * H, T, D))
            for a in (q, k, v, out.numpy(), do)]
    j_grads = pa._fa_backward(
        flat[0], flat[1], flat[2], None if km is None else jnp.asarray(km),
        jnp.full((1, 1), SEED, jnp.uint32), causal, dropout_p, True,
        flat[3], jnp.asarray(lse.numpy().reshape(B * H, T)), flat[4])
    t_grads = fa.flash_attention_backward(
        *(torch.from_numpy(a) for a in (q, k, v)), tm, causal, dropout_p,
        seed, out, lse, torch.from_numpy(do))
    for name, t, j in zip('qkv', t_grads, j_grads):
        onp.testing.assert_allclose(
            t.numpy(), onp.asarray(j).reshape(B, H, T, D), rtol=RTOL,
            atol=ATOL, err_msg=f'd{name}')


@pytest.mark.parametrize('T,causal,mask_kind,dropout_p', [
    (20, False, None, 0.0), (33, True, 'additive', 0.3),
    (33, False, 'bool', 0.0), (20, True, 'bool', 0.3)])
def test_function_gradients_match_jax_grad(T, causal, mask_kind, dropout_p):
    q, k, v, do = _inputs(T, seed=3)
    m = _mask(mask_kind, T)
    seed = SEED if dropout_p else None

    def j_loss(q, k, v):
        out = pa.flash_attention(q, k, v,
                                 key_mask=None if m is None else
                                 jnp.asarray(m), causal=causal,
                                 dropout_p=dropout_p, dropout_seed=seed,
                                 interpret=True)
        return jnp.sum(out * jnp.asarray(do))

    j_grads = jax.grad(j_loss, argnums=(0, 1, 2))(
        *(jnp.asarray(a) for a in (q, k, v)))

    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = fa.flash_attention(tq, tk, tv,
                             key_mask=None if m is None else
                             torch.from_numpy(m), causal=causal,
                             dropout_p=dropout_p, dropout_seed=seed)
    t_grads = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(do))
    for name, t, j in zip('qkv', t_grads, j_grads):
        onp.testing.assert_allclose(t.numpy(), onp.asarray(j), rtol=RTOL,
                                    atol=ATOL, err_msg=f'd{name}')


def test_function_saves_what_the_backward_needs():
    """The forward output carries a grad_fn; the mask and the seed get no
    gradient, and the kernels' launch counters stay at zero on the CPU."""
    from mxnet_tpu_torch.ops import _build
    _build.reset_launch_counts()
    q, k, v, do = (torch.from_numpy(a).requires_grad_()
                   for a in _inputs(20))
    m = torch.from_numpy(_mask('additive', 20)).requires_grad_()
    out = fa.flash_attention(q, k, v, key_mask=m, dropout_p=0.3,
                             dropout_seed=SEED)
    assert out.grad_fn is not None
    out.backward(do.detach())
    assert all(t.grad is not None for t in (q, k, v))
    assert m.grad is None
    assert set(_build.launch_counts.values()) == {0}


def test_split_bf16_represents_x_to_2_pow_minus_16():
    """hi + lo (two bf16 terms) is within 2**-16 |x| of an f32 x over a
    wide range of magnitudes, and hi is x rounded to bf16."""
    rng = onp.random.RandomState(7)
    x = torch.from_numpy((rng.randn(4096) * 10.0 ** rng.uniform(
        -30, 30, 4096)).astype(onp.float32))
    hi, lo = fa.split_bf16(x)
    assert hi.dtype == lo.dtype == torch.bfloat16
    assert torch.equal(hi, x.to(torch.bfloat16))
    err = (hi.double() + lo.double() - x.double()).abs()
    assert bool((err <= 2.0 ** -16 * x.double().abs()).all())


def _bf16_exact(a):
    """numpy f32 values rounded to bf16, kept in f32"""
    return torch.from_numpy(a).to(torch.bfloat16).float().numpy()


def _dkv_split_emulation(q, k, v, km, causal, dropout_p, seed, out, lse, do):
    """The tensor-core dk/dv kernel's arithmetic in plain PyTorch: p, dp and
    ds in f32 as the plain backward computes them; dv and dk from the
    two-term bf16 split of p*keep and of ds, each term multiplied in f32
    against the bf16-exact dO or q (an mma with bf16 operands and f32
    sums). Returns (dk, dv) in f32."""
    Bq, Hq, Tq, Dq = q.shape
    Tk = k.shape[2]
    p = torch.exp(fa._scores(q, k, km, causal) - lse[..., None])
    dp = torch.einsum('bhqd,bhkd->bhqk', do, v)
    pv = p
    if dropout_p > 0.0:
        keep = fa._keep_multipliers(seed, Bq, Hq, Tq, Tk, dropout_p,
                                    q.device)
        pv, dp = p * keep, dp * keep
    delta = (do * out).sum(-1, keepdim=True)
    ds = p * (dp - delta) * (1.0 / math.sqrt(Dq))

    def split_product(x, y):           # sum over q rows of x^T y
        return sum(torch.einsum('bhqk,bhqd->bhkd', term.float(), y)
                   for term in fa.split_bf16(x))
    return split_product(ds, q), split_product(pv, do)


@pytest.mark.parametrize('T,causal,mask_kind,dropout_p', CASES)
def test_dkv_split_arithmetic_matches_pallas_kernel(T, causal, mask_kind,
                                                    dropout_p):
    """The precision decision of the tensor-core dk/dv kernel, held on the
    CPU: with inputs that bf16 represents exactly, the JAX kernel's f32
    products are the products the card computes, and the split's error
    (about 2**-17 relative) stays inside the file's grad bound."""
    q, k, v, do = (_bf16_exact(a) for a in _inputs(T, seed=5))
    m = _mask(mask_kind, T)
    tm = None if m is None else torch.from_numpy(m)
    seed = SEED if dropout_p else None
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    out, lse = fa.flash_attention_forward(tq, tk, tv, key_mask=tm,
                                          causal=causal, dropout_p=dropout_p,
                                          dropout_seed=seed)
    km_t, _ = fa._normalize_mask(tm, B, H, T)
    dk, dv = _dkv_split_emulation(tq, tk, tv, km_t, causal, dropout_p, seed,
                                  out, lse, tdo)
    km = _additive_bh(m)
    flat = [jnp.asarray(a.reshape(B * H, T, D))
            for a in (q, k, v, out.numpy(), do)]
    _, j_dk, j_dv = pa._fa_backward(
        flat[0], flat[1], flat[2], None if km is None else jnp.asarray(km),
        jnp.full((1, 1), SEED, jnp.uint32), causal, dropout_p, True,
        flat[3], jnp.asarray(lse.numpy().reshape(B * H, T)), flat[4])
    for name, t, j in (('dk', dk, j_dk), ('dv', dv, j_dv)):
        onp.testing.assert_allclose(
            t.numpy(), onp.asarray(j).reshape(B, H, T, D), rtol=RTOL,
            atol=ATOL, err_msg=name)


def _dq_split_emulation(q, k, v, km, causal, dropout_p, seed, out, lse, do):
    """The tensor-core dq kernel's arithmetic in plain PyTorch: p, dp and ds
    in f32 as the plain backward computes them; dq from the two-term bf16
    split of ds, each term multiplied in f32 against the bf16-exact k (an
    mma with bf16 operands and f32 sums). Returns dq in f32."""
    Bq, Hq, Tq, Dq = q.shape
    Tk = k.shape[2]
    p = torch.exp(fa._scores(q, k, km, causal) - lse[..., None])
    dp = torch.einsum('bhqd,bhkd->bhqk', do, v)
    if dropout_p > 0.0:
        dp = dp * fa._keep_multipliers(seed, Bq, Hq, Tq, Tk, dropout_p,
                                       q.device)
    delta = (do * out).sum(-1, keepdim=True)
    ds = p * (dp - delta) * (1.0 / math.sqrt(Dq))
    return sum(torch.einsum('bhqk,bhkd->bhqd', term.float(), k)
               for term in fa.split_bf16(ds))


@pytest.mark.parametrize('T,causal,mask_kind,dropout_p', CASES)
def test_dq_split_arithmetic_matches_pallas_kernel(T, causal, mask_kind,
                                                   dropout_p):
    """The precision decision of the tensor-core dq kernel, held on the CPU:
    with inputs that bf16 represents exactly, the JAX kernel's f32 products
    are the products the card computes, and splitting the f32 ds into two
    bf16 terms stays inside the file's grad bound."""
    q, k, v, do = (_bf16_exact(a) for a in _inputs(T, seed=6))
    m = _mask(mask_kind, T)
    tm = None if m is None else torch.from_numpy(m)
    seed = SEED if dropout_p else None
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    out, lse = fa.flash_attention_forward(tq, tk, tv, key_mask=tm,
                                          causal=causal, dropout_p=dropout_p,
                                          dropout_seed=seed)
    km_t, _ = fa._normalize_mask(tm, B, H, T)
    dq = _dq_split_emulation(tq, tk, tv, km_t, causal, dropout_p, seed, out,
                             lse, tdo)
    km = _additive_bh(m)
    flat = [jnp.asarray(a.reshape(B * H, T, D))
            for a in (q, k, v, out.numpy(), do)]
    j_dq, _, _ = pa._fa_backward(
        flat[0], flat[1], flat[2], None if km is None else jnp.asarray(km),
        jnp.full((1, 1), SEED, jnp.uint32), causal, dropout_p, True,
        flat[3], jnp.asarray(lse.numpy().reshape(B * H, T)), flat[4])
    onp.testing.assert_allclose(
        dq.numpy(), onp.asarray(j_dq).reshape(B, H, T, D), rtol=RTOL,
        atol=ATOL, err_msg='dq')


def test_backward_refuses_an_unaligned_dO_for_the_tensor_cores():
    """One variant serves both backward kernels: the tensor-core dq and
    dk/dv kernels copy dO 16 bytes at a time, so a dO view whose rows start
    off 16 bytes is refused before either launches; the SIMT kernels take
    it."""
    from mxnet_tpu_torch.base import MXNetError
    Bq, Hq, T, Dq = 1, 2, 16, 64
    n = Bq * Hq * T * Dq
    q = torch.zeros(Bq, Hq, T, Dq, dtype=torch.bfloat16)
    buf = torch.zeros(n + 8, dtype=torch.bfloat16)
    do = buf[1:n + 1].view(Bq, Hq, T, Dq)
    named = (('q', q), ('k', q), ('v', q), ('dO', do))
    with pytest.raises(MXNetError, match='dO rows are not 16-byte aligned'):
        fa._pick_variant(q, named, None)
    assert fa._pick_variant(q, named, 'simt') == 'simt'
    assert fa._pick_variant(q, named[:3] + (('dO', buf[:n].view(
        Bq, Hq, T, Dq)),), None) == 'tc'


# ---- float16 (AMP's GPU target)

F16_RTOL, F16_ATOL = 2e-3, 2e-3     # twice float16's epsilon


def _f16(a):
    return a.astype(onp.float16)


@pytest.mark.parametrize('T,causal,mask_kind,dropout_p', [
    (20, False, None, 0.0), (33, True, 'additive', 0.3),
    (33, False, 'bool', 0.0), (20, True, 'bool', 0.3)])
def test_float16_backward_matches_pallas_kernels(T, causal, mask_kind,
                                                  dropout_p):
    """float16 q, k, v, dO through the JAX backward kernels in interpret
    mode and the port's plain backward, each from the same forward's out
    and lse: f32 arithmetic on both sides, dq, dk and dv in float16."""
    q, k, v, do = (_f16(a) for a in _inputs(T, seed=8))
    m = _mask(mask_kind, T)
    tm = None if m is None else torch.from_numpy(m)
    seed = SEED if dropout_p else None
    out, lse = fa.flash_attention_forward(
        *(torch.from_numpy(a) for a in (q, k, v)), key_mask=tm,
        causal=causal, dropout_p=dropout_p, dropout_seed=seed)
    assert out.dtype == torch.float16
    km = _additive_bh(m)
    flat = [jnp.asarray(a.reshape(B * H, T, D))
            for a in (q, k, v, out.numpy(), do)]
    j_grads = pa._fa_backward(
        flat[0], flat[1], flat[2], None if km is None else jnp.asarray(km),
        jnp.full((1, 1), SEED, jnp.uint32), causal, dropout_p, True,
        flat[3], jnp.asarray(lse.numpy().reshape(B * H, T)), flat[4])
    t_grads = fa.flash_attention_backward(
        *(torch.from_numpy(a) for a in (q, k, v)), tm, causal, dropout_p,
        seed, out, lse, torch.from_numpy(do))
    for name, t, j in zip('qkv', t_grads, j_grads):
        assert t.dtype == torch.float16 and j.dtype == jnp.float16
        onp.testing.assert_allclose(
            t.float().numpy(),
            onp.asarray(j).astype(onp.float32).reshape(B, H, T, D),
            rtol=F16_RTOL, atol=F16_ATOL, err_msg=f'd{name}')


def test_split_f16_represents_x_to_2_pow_minus_22():
    """Each row scaled by 2**(14 - e) has magnitudes below 2**15 (no
    float16 overflow, whatever the row's range), and (hi + lo) scaled
    back is within 2**-22 |x| plus 2**-25 of the scale, over rows whose
    largest values span 1e-30 to 1e30."""
    rng = onp.random.RandomState(9)
    x = rng.randn(64, 80) * 10.0 ** rng.uniform(-30, 30, (64, 1))
    x[3] = 0.0
    x = torch.from_numpy(x.astype(onp.float32))
    hi, lo, e = fa.split_f16(x)
    assert hi.dtype == lo.dtype == torch.float16 and e.dtype == torch.int32
    assert bool(torch.isfinite(hi).all()) and bool(torch.isfinite(lo).all())
    assert float(hi.float().abs().max()) <= 2.0 ** 15
    unit = torch.exp2((e - fa.F16_TOP).double())[:, None]
    err = ((hi.double() + lo.double()) * unit - x.double()).abs()
    assert bool((err <= 2.0 ** -22 * x.double().abs() +
                 2.0 ** -25 * unit).all())
    assert not bool(hi[3].any()) and not bool(lo[3].any())


def _f16_dq_dk_emulation(q, k, v, km, causal, dropout_p, seed, out, lse, do):
    """The float16 tensor-core dq and dk kernels' arithmetic in plain
    PyTorch: ds in f32 as the plain backward computes it, each A row
    (q rows for dq, keys for dk) split by ``split_f16`` into two float16
    terms, each multiplied in f32 against the float16-exact k or q, the
    sum scaled back by the row's 2**(e - 14). With T <= 64 the kernels
    see one tile per row, as here. Returns (dq, dk) in f32."""
    Bq, Hq, Tq, Dq = q.shape
    Tk = k.shape[2]
    p = torch.exp(fa._scores(q, k, km, causal) - lse[..., None])
    dp = torch.einsum('bhqd,bhkd->bhqk', do.float(), v.float())
    if dropout_p > 0.0:
        dp = dp * fa._keep_multipliers(seed, Bq, Hq, Tq, Tk, dropout_p,
                                       q.device)
    delta = (do.float() * out.float()).sum(-1, keepdim=True)
    ds = p * (dp - delta) * (1.0 / math.sqrt(Dq))

    def split_product(x, y):            # x (rows, n) split by row, times y
        hi, lo, e = fa.split_f16(x)
        prod = sum(torch.einsum('bhrn,bhnd->bhrd', t.float(), y.float())
                   for t in (hi, lo))
        return prod * torch.exp2((e - fa.F16_TOP).float())[..., None]
    return split_product(ds, k), split_product(ds.transpose(-1, -2), q)


@pytest.mark.parametrize('do_scale', [1.0, 8192.0])
@pytest.mark.parametrize('T,causal,mask_kind,dropout_p', [
    (20, False, None, 0.0), (33, True, 'additive', 0.3),
    (33, False, 'bool', 0.3)])
def test_f16_split_arithmetic_matches_pallas_kernel(T, causal, mask_kind,
                                                    dropout_p, do_scale):
    """The precision decision of the float16 tensor-core dq and dk
    kernels, held on the CPU against the JAX kernels in interpret mode on
    the same float16 inputs (which multiply ds by k and q in f32). With
    dO scaled by 8192 (a loss scale) and v by 300, ds passes float16's
    65504 by far, and k and q of order 1e-3 keep dq and dk finite: the
    JAX kernel's gradients are finite and the emulation matches them.
    Tolerance: twice float16's epsilon, and an absolute part for the
    split's 2**-22 on each f32 term, over T terms of random sign."""
    q, k, v, do = _inputs(T, seed=10)
    if do_scale > 1.0:
        q, k, v = q * 1e-3, k * 1e-3, v * 300
        do = do * do_scale
    q, k, v, do = (_f16(a) for a in (q, k, v, do))
    m = _mask(mask_kind, T)
    tm = None if m is None else torch.from_numpy(m)
    seed = SEED if dropout_p else None
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    out, lse = fa.flash_attention_forward(tq, tk, tv, key_mask=tm,
                                          causal=causal, dropout_p=dropout_p,
                                          dropout_seed=seed)
    km_t, _ = fa._normalize_mask(tm, B, H, T)
    dq, dk = _f16_dq_dk_emulation(tq, tk, tv, km_t, causal, dropout_p, seed,
                                  out, lse, tdo)
    km = _additive_bh(m)
    flat = [jnp.asarray(a.reshape(B * H, T, D))
            for a in (q, k, v, out.numpy(), do)]
    j_dq, j_dk, _ = pa._fa_backward(
        flat[0], flat[1], flat[2], None if km is None else jnp.asarray(km),
        jnp.full((1, 1), SEED, jnp.uint32), causal, dropout_p, True,
        flat[3], jnp.asarray(lse.numpy().reshape(B * H, T)), flat[4])
    p = torch.exp(fa._scores(tq, tk, km_t, causal) - lse[..., None])
    dp = torch.einsum('bhqd,bhkd->bhqk', tdo.float(), tv.float())
    big = float((p * dp).abs().max()) * 2 / math.sqrt(D)
    if do_scale > 1.0:
        assert big > 65504
    for name, t, j, other in (('dq', dq, j_dq, tk), ('dk', dk, j_dk, tq)):
        j = onp.asarray(j).astype(onp.float32).reshape(B, H, T, D)
        assert onp.isfinite(j).all(), name
        atol = big * float(other.float().abs().max()) * 2 ** -22 * T ** 0.5
        onp.testing.assert_allclose(t.numpy(), j, rtol=F16_RTOL,
                                    atol=max(atol, F16_ATOL), err_msg=name)
