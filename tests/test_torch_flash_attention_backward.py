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
import jax
import jax.numpy as jnp
import numpy as onp
import pytest
import torch

from mxnet_tpu.ops import pallas_attention as pa
from mxnet_tpu_torch.ops import flash_attention as fa

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
