"""The port's Hopper kernels (flash-attention forward, dq and dk/dv;
residual+LayerNorm; FFN1) against their plain PyTorch versions, on the
card, at small and ragged shapes that chip_smoke.py does not reach (head
dims 8 to 128, sequence lengths and widths that divide no tile), in f32,
bf16 and float16, and the gradients of their autograd Functions against
plain autograd. The flash forward, dq and dk/dv kernels come in two
variants (tensor cores for bf16 and float16 at D a multiple of 16, SIMT
otherwise), FFN1 in three (wgmma + TMA for bf16 and float16 with K a
multiple of 8, the first WMMA design for other K, SIMT for f32); the tests
pin which one each dtype and shape takes, hold each against the plain
versions, and check that the tensor-core kernels refuse a view that is
not 16-byte aligned. The float16 backward is also held where ds exceeds
float16's range (a large dO, as the float16 AMP recipe's loss scale
gives).

These tests need a CUDA device and carry the ``cuda`` marker; without a
card they skip. On the card, from the root of the checkout (the file
imports only torch and the port, so the JAX conftest is left out):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py
"""
import pytest
import torch

from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import _build, fused_ffn, fused_layernorm
from mxnet_tpu_torch.ops import flash_attention as fa

pytestmark = pytest.mark.cuda

# kernel vs plain version on the same inputs: f32 differs by summation
# order only; bf16 and float16 outputs may differ by an ulp or two of their
# type (float16: twice its epsilon, 2**-9)
TOL = {torch.float32: dict(atol=1e-4, rtol=1e-4),
       torch.bfloat16: dict(atol=1e-2, rtol=1.6e-2),
       torch.float16: dict(atol=2e-3, rtol=2e-3)}
DTYPES = [torch.float32, torch.bfloat16, torch.float16]


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device='cuda').manual_seed(0)


@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('D', [8, 32, 64, 128])
@pytest.mark.parametrize('causal', [False, True])
def test_flash_attention_kernel(gen, dtype, D, causal):
    B, H, Tq, Tk = 2, 3, 20, 70
    q = torch.randn(B, H, Tq, D, generator=gen, device='cuda').to(dtype)
    k = torch.randn(B, H, Tk, D, generator=gen, device='cuda').to(dtype)
    v = torch.randn(B, H, Tk, D, generator=gen, device='cuda').to(dtype)
    # per-head additive mask; every row keeps key 0
    m = torch.randn(B * H, Tk, generator=gen, device='cuda')
    m[:, 1::3] = -1e30
    if causal:
        k, v, Tk, m = k[:, :, :Tq], v[:, :, :Tq], Tq, m[:, :Tq].contiguous()
    out, lse = fa.flash_attention_forward(q, k, v, key_mask=m, causal=causal,
                                          dropout_p=0.2, dropout_seed=7)
    torch.cuda.synchronize()
    ref_out, ref_lse = fa.flash_attention_reference(q, k, v, m, causal, 0.2,
                                                    7)
    torch.testing.assert_close(out, ref_out, **TOL[dtype])
    torch.testing.assert_close(lse, ref_lse, **TOL[torch.float32])


@pytest.mark.parametrize('dtype', DTYPES)
def test_fused_layernorm_kernel(gen, dtype):
    x = torch.randn(7, 100, generator=gen, device='cuda').to(dtype)
    r = torch.randn(7, 100, generator=gen, device='cuda').to(dtype)
    g = torch.rand(100, generator=gen, device='cuda') + 0.5
    b = torch.randn(100, generator=gen, device='cuda')
    out = fused_layernorm.fused_add_layer_norm(x, r, g, b)
    torch.cuda.synchronize()
    ref = fused_layernorm.add_layer_norm_reference(x, r, g, b)
    torch.testing.assert_close(
        out, ref, atol=1e-4 if dtype == torch.float32 else 0.05, rtol=0)


@pytest.mark.parametrize('dtype', DTYPES)
def test_fused_ffn_kernel(gen, dtype):
    x = torch.randn(3, 11, 40, generator=gen, device='cuda').to(dtype)
    w = (torch.randn(70, 40, generator=gen, device='cuda') * 0.1).to(dtype)
    b = (torch.randn(70, generator=gen, device='cuda') * 0.1).to(dtype)
    out = fused_ffn.fused_dense_gelu(x, w, b)
    torch.cuda.synchronize()
    assert out.shape == (3, 11, 70)
    torch.testing.assert_close(out, fused_ffn.dense_gelu_reference(x, w, b),
                               **TOL[dtype])


def test_wrappers_refuse_what_the_kernels_do_not_take(gen):
    from mxnet_tpu_torch.base import MXNetError
    x = torch.randn(4, 16, generator=gen, device='cuda')
    with pytest.raises(MXNetError, match='contiguous'):
        fused_layernorm.fused_add_layer_norm(x.t(), x.t(), torch.ones(
            4, device='cuda'), torch.zeros(4, device='cuda'))
    with pytest.raises(MXNetError, match='dtype'):
        fused_ffn.fused_dense_gelu(x.double(), x.double(),
                                   torch.zeros(4, device='cuda').double())
    q = torch.randn(1, 1, 4, 12, generator=gen, device='cuda')
    with pytest.raises(MXNetError, match='head dim'):
        fa.flash_attention(q, q, q)


def _attn_inputs(gen, B, H, Tq, Tk, D, dtype):
    q = torch.randn(B, H, Tq, D, generator=gen, device='cuda').to(dtype)
    k = torch.randn(B, H, Tk, D, generator=gen, device='cuda').to(dtype)
    v = torch.randn(B, H, Tk, D, generator=gen, device='cuda').to(dtype)
    do = torch.randn(B, H, Tq, D, generator=gen, device='cuda').to(dtype)
    # per-head additive mask; every row keeps key 0
    m = torch.randn(B * H, Tk, generator=gen, device='cuda')
    m[:, 1::3] = -1e30
    return q, k, v, do, m


@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('D', [8, 32, 64, 128])
@pytest.mark.parametrize('causal,dropout_p', [(False, 0.0), (True, 0.2),
                                              (False, 0.2)])
def test_flash_attention_backward_kernels(gen, dtype, D, causal, dropout_p):
    B, H, Tq, Tk = 2, 3, 70, 100          # ragged: neither divides 64
    q, k, v, do, m = _attn_inputs(gen, B, H, Tq, Tk, D, dtype)
    if causal:
        k, v, Tk, m = k[:, :, :Tq], v[:, :, :Tq], Tq, m[:, :Tq].contiguous()
    seed = 11 if dropout_p else None
    out, lse = fa.flash_attention_forward(q, k, v, key_mask=m, causal=causal,
                                          dropout_p=dropout_p,
                                          dropout_seed=seed)
    got = fa.flash_attention_backward(q, k, v, m, causal, dropout_p, seed,
                                      out, lse, do)
    torch.cuda.synchronize()
    want = fa.flash_attention_backward_reference(q, k, v, m, causal,
                                                 dropout_p, seed, out, lse, do)
    for name, g, w in zip('qkv', got, want):
        assert g.dtype == dtype and g.shape == w.shape, name
        torch.testing.assert_close(g, w, **TOL[dtype], msg=f'd{name}')


def test_flash_attention_backward_is_deterministic(gen):
    B, H, T, D = 2, 12, 200, 64
    q, k, v, do, m = _attn_inputs(gen, B, H, T, T, D, torch.bfloat16)
    out, lse = fa.flash_attention_forward(q, k, v, key_mask=m,
                                          dropout_p=0.1, dropout_seed=5)
    _build.reset_launch_counts()
    runs = [fa.flash_attention_backward(q, k, v, m, False, 0.1, 5, out, lse,
                                        do) for _ in range(2)]
    assert _build.variant_counts['flash_attn_bwd_dq.tc'] == 2
    assert _build.variant_counts['flash_attn_bwd_dkv.tc'] == 2
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def test_function_gradients_on_the_card_match_plain_autograd(gen):
    """loss.backward() through each kernel's autograd Function on CUDA gives
    the gradient of plain torch autograd through its plain version."""
    # flash attention: views of one (B, T, 3*H*D) projection, as the model
    B, H, T, D = 2, 4, 90, 32
    qkv = torch.randn(B, T, 3 * H * D, generator=gen, device='cuda')
    do = torch.randn(B, H, T, D, generator=gen, device='cuda')
    vl = torch.tensor([90, 41], device='cuda')
    mask = torch.arange(T, device='cuda')[None, :] < vl[:, None]

    def attn(fn, x):
        q, k, v = (t.reshape(B, T, H, D).permute(0, 2, 1, 3)
                   for t in x.chunk(3, dim=-1))
        return fn(q, k, v)

    x1 = qkv.clone().requires_grad_()
    attn(lambda q, k, v: fa.flash_attention(q, k, v, key_mask=mask,
                                            causal=True), x1).backward(do)
    x2 = qkv.clone().requires_grad_()
    km, _ = fa._normalize_mask(mask, B, H, T)
    attn(lambda q, k, v: fa.flash_attention_reference(q, k, v, km, True)[0],
         x2).backward(do)
    torch.testing.assert_close(x1.grad, x2.grad, **TOL[torch.float32])

    # residual + LayerNorm and FFN1, f32
    xs = [torch.randn(6, 100, generator=gen, device='cuda') for _ in range(2)]
    g = torch.rand(100, generator=gen, device='cuda') + 0.5
    bt = torch.randn(100, generator=gen, device='cuda')
    w = torch.randn(70, 100, generator=gen, device='cuda') * 0.1
    b = torch.randn(70, generator=gen, device='cuda') * 0.1
    cot_ln = torch.randn(6, 100, generator=gen, device='cuda')
    cot_ffn = torch.randn(6, 70, generator=gen, device='cuda')
    for fused, plain, args, cot in (
            (fused_layernorm.fused_add_layer_norm,
             fused_layernorm.add_layer_norm_reference, xs + [g, bt], cot_ln),
            (fused_ffn.fused_dense_gelu, fused_ffn.dense_gelu_reference,
             [xs[0], w, b], cot_ffn)):
        a1 = [t.clone().requires_grad_() for t in args]
        a2 = [t.clone().requires_grad_() for t in args]
        fused(*a1).backward(cot)
        plain(*a2).backward(cot)
        for t1, t2 in zip(a1, a2):
            torch.testing.assert_close(t1.grad, t2.grad, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('D', [8, 32, 64, 128])
@pytest.mark.parametrize('causal', [False, True])
def test_flash_attention_dkv_kernel(gen, dtype, D, causal):
    """The dk/dv kernel that routing picks, ragged and masked, with
    dropout, against the plain backward."""
    B, H, Tq, Tk = 2, 3, 20, 70
    q, k, v, do, m = _attn_inputs(gen, B, H, Tq, Tk, D, dtype)
    if causal:
        k, v, Tk, m = k[:, :, :Tq], v[:, :, :Tq], Tq, m[:, :Tq].contiguous()
    out, lse = fa.flash_attention_forward(q, k, v, key_mask=m, causal=causal,
                                          dropout_p=0.2, dropout_seed=7)
    _build.reset_launch_counts()
    _, dk, dv = fa.flash_attention_backward(q, k, v, m, causal, 0.2, 7, out,
                                            lse, do)
    torch.cuda.synchronize()
    variant = fa.kernel_variant(dtype, D)
    assert _build.variant_counts[f'flash_attn_bwd_dkv.{variant}'] == 1
    _, want_dk, want_dv = fa.flash_attention_backward_reference(
        q, k, v, m, causal, 0.2, 7, out, lse, do)
    torch.testing.assert_close(dk, want_dk, **TOL[dtype], msg='dk')
    torch.testing.assert_close(dv, want_dv, **TOL[dtype], msg='dv')


@pytest.mark.parametrize('dtype,D,variant', [
    (torch.bfloat16, 16, 'tc'), (torch.bfloat16, 64, 'tc'),
    (torch.bfloat16, 128, 'tc'), (torch.bfloat16, 8, 'simt'),
    (torch.float16, 64, 'tc'), (torch.float16, 8, 'simt'),
    (torch.float32, 64, 'simt'), (torch.float32, 128, 'simt')])
def test_each_dtype_and_head_dim_takes_its_variant(gen, dtype, D, variant):
    q, k, v, do, _ = _attn_inputs(gen, 1, 2, 40, 40, D, dtype)
    _build.reset_launch_counts()
    out, lse = fa.flash_attention_forward(q, k, v)
    fa.flash_attention_backward(q, k, v, None, False, 0.0, None, out, lse, do)
    torch.cuda.synchronize()
    assert _build.variant_counts == {
        k: int(k in (f'flash_attn_fwd.{variant}',
                     f'flash_attn_bwd_dq.{variant}',
                     f'flash_attn_bwd_dkv.{variant}'))
        for k in _build.variant_counts}
    assert _build.launch_counts['flash_attn_fwd'] == 1
    assert _build.launch_counts['flash_attn_bwd_dq'] == 1
    assert _build.launch_counts['flash_attn_bwd_dkv'] == 1


@pytest.mark.parametrize('dtype,K,variant', [
    (torch.bfloat16, 768, 'tc'), (torch.bfloat16, 72, 'tc'),
    (torch.bfloat16, 70, 'wmma'), (torch.float16, 768, 'tc'),
    (torch.float16, 70, 'wmma'), (torch.float32, 768, 'simt')])
def test_each_dtype_and_k_takes_its_ffn_variant(gen, dtype, K, variant):
    x = torch.randn(30, K, generator=gen, device='cuda').to(dtype)
    w = (torch.randn(50, K, generator=gen, device='cuda') * 0.05).to(dtype)
    b = torch.zeros(50, device='cuda').to(dtype)
    _build.reset_launch_counts()
    fused_ffn.fused_dense_gelu(x, w, b)
    torch.cuda.synchronize()
    assert _build.variant_counts == {
        k: int(k == f'dense_gelu.{variant}') for k in _build.variant_counts}
    assert _build.launch_counts['dense_gelu'] == 1


@pytest.mark.parametrize('D', [64, 128])
def test_simt_variant_at_bf16_matches_plain(gen, D):
    """The first design stays reachable at bf16 (for timing it beside the
    tensor-core kernel) and stays right."""
    B, H, T = 2, 3, 70
    q, k, v, do, m = _attn_inputs(gen, B, H, T, T, D, torch.bfloat16)
    out, lse = fa.flash_attention_forward(q, k, v, key_mask=m, dropout_p=0.1,
                                          dropout_seed=3, _variant='simt')
    dq, dk, dv = fa.flash_attention_backward(q, k, v, m, False, 0.1, 3, out,
                                             lse, do, _variant='simt')
    torch.cuda.synchronize()
    ref_out, ref_lse = fa.flash_attention_reference(q, k, v, m, False, 0.1, 3)
    torch.testing.assert_close(out, ref_out, **TOL[torch.bfloat16])
    want_dq, want_dk, want_dv = fa.flash_attention_backward_reference(
        q, k, v, m, False, 0.1, 3, out, lse, do)
    torch.testing.assert_close(dq, want_dq, **TOL[torch.bfloat16])
    torch.testing.assert_close(dk, want_dk, **TOL[torch.bfloat16])
    torch.testing.assert_close(dv, want_dv, **TOL[torch.bfloat16])


def test_tensor_core_kernels_refuse_unaligned_views(gen):
    B, H, T, D = 1, 2, 16, 64
    n = B * H * T * D
    buf = torch.randn(n + 8, generator=gen, device='cuda').to(torch.bfloat16)
    q = buf[1:n + 1].view(B, H, T, D)           # rows start 2 bytes off
    k = buf[8:n + 8].view(B, H, T, D)
    with pytest.raises(MXNetError, match='16-byte aligned'):
        fa.flash_attention_forward(q, k, k)
    # a row stride that is no multiple of 8 elements
    wide = torch.randn(B, H, T, D + 4, generator=gen,
                       device='cuda').to(torch.bfloat16)
    with pytest.raises(MXNetError, match='16-byte aligned'):
        fa.flash_attention_forward(wide[..., :D], k, k)
    out, lse = fa.flash_attention_forward(k, k, k)
    with pytest.raises(MXNetError, match='16-byte aligned'):
        fa.flash_attention_backward(k, k, k, None, False, 0.0, None, out,
                                    lse, q)
    # the SIMT kernels take them
    fa.flash_attention_forward(q, k, k, _variant='simt')
    fa.flash_attention_backward(k, k, k, None, False, 0.0, None, out, lse, q,
                                _variant='simt')
    # FFN1: x or w 2 bytes off a 16-byte address; the WMMA kernel takes them
    K = 64
    x = buf[1:16 * K + 1].view(16, K)
    w = buf[8:32 * K + 8].view(32, K)
    b = torch.zeros(32, device='cuda', dtype=torch.bfloat16)
    with pytest.raises(MXNetError, match='x is not 16-byte aligned'):
        fused_ffn.fused_dense_gelu(x, w, b)
    with pytest.raises(MXNetError, match='w is not 16-byte aligned'):
        fused_ffn.fused_dense_gelu(w[:16], x, b[:16])
    fused_ffn.fused_dense_gelu(x, w, b, _variant='wmma')
    torch.cuda.synchronize()


@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float16])
@pytest.mark.parametrize('D', [16, 32, 64, 128])
@pytest.mark.parametrize('causal', [False, True])
def test_flash_attention_dq_kernel(gen, dtype, D, causal):
    """The tensor-core dq kernel, ragged and masked, with dropout 0.2,
    against the plain backward."""
    B, H, Tq, Tk = 2, 3, 70, 100
    q, k, v, do, m = _attn_inputs(gen, B, H, Tq, Tk, D, dtype)
    if causal:
        k, v, Tk, m = k[:, :, :Tq], v[:, :, :Tq], Tq, m[:, :Tq].contiguous()
    out, lse = fa.flash_attention_forward(q, k, v, key_mask=m, causal=causal,
                                          dropout_p=0.2, dropout_seed=9)
    _build.reset_launch_counts()
    dq, _, _ = fa.flash_attention_backward(q, k, v, m, causal, 0.2, 9, out,
                                           lse, do)
    torch.cuda.synchronize()
    assert _build.variant_counts['flash_attn_bwd_dq.tc'] == 1
    want_dq, _, _ = fa.flash_attention_backward_reference(
        q, k, v, m, causal, 0.2, 9, out, lse, do)
    torch.testing.assert_close(dq, want_dq, **TOL[dtype], msg='dq')


@pytest.mark.parametrize('D', [64, 128])
@pytest.mark.parametrize('causal,dropout_p', [(False, 0.0), (True, 0.1)])
def test_float16_backward_takes_a_large_ds(gen, D, causal, dropout_p):
    """ds above float16's 65504: dO of order 2**13 (a loss scale) times v
    of order 300 makes dp, and with it ds, reach 1e5 or more, while k and q
    of order 1e-3 keep dq and dk finite in float16. The float16
    tensor-core kernels (their per-row power-of-two scale before the split)
    give finite gradients that match the plain version."""
    B, H, Tq, Tk = 2, 3, 70, 100
    q, k, v, do, m = _attn_inputs(gen, B, H, Tq, Tk, D, torch.float32)
    if causal:
        k, v, Tk, m = k[:, :, :Tq], v[:, :, :Tq], Tq, m[:, :Tq].contiguous()
    q, k = (q * 1e-3).half(), (k * 1e-3).half()
    v, do = (v * 300).half(), (do * 8192).half()
    seed = 5 if dropout_p else None
    out, lse = fa.flash_attention_forward(q, k, v, key_mask=m, causal=causal,
                                          dropout_p=dropout_p,
                                          dropout_seed=seed)
    got = fa.flash_attention_backward(q, k, v, m, causal, dropout_p, seed,
                                      out, lse, do)
    torch.cuda.synchronize()
    want = fa.flash_attention_backward_reference(q, k, v, m, causal,
                                                 dropout_p, seed, out, lse, do)
    delta = (do.float() * out.float()).sum(-1, keepdim=True)
    p = torch.exp(fa._scores(q, k, m, causal) - lse[..., None])
    dp = torch.einsum('bhqd,bhkd->bhqk', do.float(), v.float())
    ds = p * (dp - delta) / D ** 0.5
    big = float(ds.abs().max())
    assert big > 65504
    # each f32 term ds*k (ds*q) carries the split's 2**-22 of itself, and
    # Tk (Tq) of them add with random signs: that, beside float16's
    # rounding of the result
    for name, g, w, other, n in (('q', got[0], want[0], k, Tk),
                                 ('k', got[1], want[1], q, Tq)):
        assert bool(torch.isfinite(w).all()), name
        assert bool(torch.isfinite(g).all()), name
        atol = big * float(other.float().abs().max()) * 2 ** -22 * n ** 0.5
        torch.testing.assert_close(g, w, atol=max(atol, 2e-3), rtol=2e-3,
                                   msg=f'd{name}')


def test_fused_layernorm_promotes_mixed_dtypes(gen):
    """An f32 residual stream and a float16 (or bf16) sublayer output, as
    AMP gives: the kernel runs on both promoted to f32 and returns f32,
    as LN(x + res) does."""
    x = torch.randn(6, 96, generator=gen, device='cuda')
    g = torch.rand(96, generator=gen, device='cuda') + 0.5
    b = torch.randn(96, generator=gen, device='cuda')
    for low in (torch.float16, torch.bfloat16):
        r = torch.randn(6, 96, generator=gen, device='cuda').to(low)
        _build.reset_launch_counts()
        out = fused_layernorm.fused_add_layer_norm(x, r, g, b)
        torch.cuda.synchronize()
        assert out.dtype == torch.float32
        assert _build.dtype_counts == {'fused_add_layernorm.float32': 1}
        torch.testing.assert_close(
            out, fused_layernorm.add_layer_norm_reference(x, r.float(), g, b),
            atol=1e-4, rtol=0)


@pytest.mark.parametrize('M,K,N,dtype,variant', [
    (64, 768, 3072, torch.bfloat16, None),
    (200, 768, 3072, torch.bfloat16, None),
    (1024, 768, 3072, torch.bfloat16, None),
    (200, 72, 100, torch.bfloat16, None),
    (300, 768, 1000, torch.bfloat16, None),
    (130, 8, 9, torch.bfloat16, None),
    (130, 70, 100, torch.bfloat16, None),
    (200, 768, 3072, torch.bfloat16, 'wmma'),
    (1024, 768, 3072, torch.float16, None),
    (130, 70, 100, torch.float16, None),
    (300, 768, 1000, torch.float16, None),
    (200, 768, 3072, torch.float16, 'wmma'),
    (200, 72, 100, torch.float32, None)])
def test_fused_ffn_kernel_variants(gen, M, K, N, dtype, variant):
    """Each FFN1 kernel against the plain version: serving's and training's
    widths at several M; ragged M, N and K (the tc kernel's TMA zero-fills
    past the edges, and an N that is no multiple of 8 is stored from the
    registers); the WMMA kernel by routing (K = 70) and forced."""
    x = torch.randn(M, K, generator=gen, device='cuda').to(dtype)
    w = (torch.randn(N, K, generator=gen, device='cuda') * 0.05).to(dtype)
    b = (torch.randn(N, generator=gen, device='cuda') * 0.1).to(dtype)
    _build.reset_launch_counts()
    out = fused_ffn.fused_dense_gelu(x, w, b, _variant=variant)
    torch.cuda.synchronize()
    want = variant or fused_ffn.kernel_variant(dtype, K)
    assert _build.variant_counts[f'dense_gelu.{want}'] == 1
    torch.testing.assert_close(out, fused_ffn.dense_gelu_reference(x, w, b),
                               **TOL[dtype])


@pytest.mark.parametrize('dtype', DTYPES)
def test_kernels_read_their_seed_from_the_device(gen, dtype):
    """The forward, dq and dk/dv kernels take the dropout seed by device
    pointer: a seed drawn on the card (int64, or its low word as int32)
    and the same seed given as an int give bit-identical outputs, and the
    kernels hold against the plain versions with that tensor."""
    B, H, T, D = 2, 3, 70, 64
    q, k, v, do = (torch.randn(B, H, T, D, generator=gen,
                               device='cuda').to(dtype) for _ in range(4))
    seed = torch.randint(0, 2 ** 32, (1,), generator=gen, device='cuda',
                         dtype=torch.int64)
    as_int = int(seed.item())
    for s in (seed, seed.to(torch.int32)):
        out, lse = fa.flash_attention_forward(q, k, v, None, False, 0.1, s)
        out_i, lse_i = fa.flash_attention_forward(q, k, v, None, False, 0.1,
                                                  as_int)
        torch.testing.assert_close(out, out_i, rtol=0, atol=0)
        grads = fa.flash_attention_backward(q, k, v, None, False, 0.1, s,
                                            out, lse, do)
        grads_i = fa.flash_attention_backward(q, k, v, None, False, 0.1,
                                              as_int, out, lse, do)
        for g, gi in zip(grads, grads_i):
            torch.testing.assert_close(g, gi, rtol=0, atol=0)
    torch.cuda.synchronize()
    ref, ref_lse = fa.flash_attention_reference(q, k, v, None, False, 0.1,
                                                seed)
    torch.testing.assert_close(out, ref, **TOL[dtype])
    want = fa.flash_attention_backward_reference(q, k, v, None, False, 0.1,
                                                 seed, out, lse, do)
    for g, w in zip(grads, want):
        torch.testing.assert_close(g, w, **TOL[dtype])


def _small_bert(gen_seed, **kw):
    import numpy as onp
    from mxnet_tpu_torch.models.bert import BertForPretraining
    cfg = dict(vocab_size=512, hidden=128, layers=2, heads=2,
               intermediate=512, max_len=128, type_vocab=2, dropout=0.0)
    net = BertForPretraining(cfg, device='cuda', **kw)
    rng = onp.random.RandomState(gen_seed)
    with torch.no_grad():
        for _, p in sorted(net.named_parameters()):
            p.copy_(torch.from_numpy(
                (rng.randn(*p.shape) * 0.02).astype('float32')))
    rng = onp.random.RandomState(gen_seed + 1)
    B, T, M = 4, 64, 8
    ins = [rng.randint(0, 512, (B, T)), onp.zeros((B, T), 'int64'),
           rng.randint(T // 2, T + 1, B).astype('float32'),
           onp.stack([rng.choice(T, M, replace=False) for _ in range(B)])]
    labs = [rng.randint(0, 512, (B, M)), rng.randint(0, 2, B)]
    return net, [torch.from_numpy(a).cuda() for a in ins], \
        [torch.from_numpy(a).cuda() for a in labs]


def _rel_fro(a, b):
    a, b = [x.detach().float() for x in a], [y.detach().float() for y in b]
    num = sum(float((x - y).square().sum()) for x, y in zip(a, b))
    return (num / sum(float(y.square().sum()) for y in b)) ** 0.5


def test_compiled_step_replay_matches_the_eager_trainer(gen):
    """ShardedTrainStep on the card (f32, TF32 off, dropout 0): call 1 runs
    eagerly and captures, call 2 replays the graph. Both hold against the
    Trainer's per-parameter loop on the same card: loss rel 1e-5, the
    parameters' rel Frobenius 1e-4."""
    from mxnet_tpu_torch import gluon, parallel
    from mxnet_tpu_torch.models.bert import bert_pretrain_loss
    net_s, ins, labs = _small_bert(0)
    net_t, _, _ = _small_bert(0)
    step = parallel.ShardedTrainStep(net_s, bert_pretrain_loss, 'adamw',
                                     {'learning_rate': 1e-3, 'wd': 0.01})
    trainer = gluon.Trainer(gluon.collect_params(net_t), 'adamw',
                            {'learning_rate': 1e-3, 'wd': 0.01})
    trainer.optimizer.fused_update = False
    net_t.train()
    for i in range(3):
        ls = float(step(ins, labs))
        net_t.zero_grad(set_to_none=False)
        loss = bert_pretrain_loss(*net_t(*ins), *labs)
        loss.backward()
        trainer.step(1)
        lt = float(loss.detach())
        assert abs(ls - lt) <= 1e-5 * abs(lt), (i, ls, lt)
    assert len(step._graphs) == 1
    assert _rel_fro(list(net_s.parameters()),
                    list(net_t.parameters())) <= 1e-4


def test_trainer_fused_update_replay_matches_the_loop(gen):
    """The Trainer's fused AdamW (multi_precision, bf16 weights): step 1
    runs eagerly and captures, steps 2-3 replay; the per-parameter loop on
    the same gradients gives the same masters (rel Frobenius 1e-6)."""
    from mxnet_tpu_torch import gluon
    ps = [torch.nn.Parameter(torch.randn(*s, generator=gen, device='cuda')
                             .to(torch.bfloat16)) for s in ((7, 5), (5,))]
    qs = [torch.nn.Parameter(p.detach().clone()) for p in ps]
    kw = {'learning_rate': 1e-2, 'wd': 0.01, 'multi_precision': True}
    fused, loop = gluon.Trainer(ps, 'adamw', kw), gluon.Trainer(qs, 'adamw',
                                                                kw)
    loop.optimizer.fused_update = False
    for _ in range(3):
        for p, q in zip(ps, qs):
            g = torch.randn(p.shape, generator=gen, device='cuda').to(
                torch.bfloat16)
            p.grad, q.grad = g, g.clone()
        fused.step(2)
        loop.step(2)
    assert fused._fused[1] is not None
    a = [st[0] for _, st in sorted(fused._updater.states.items())]
    b = [st[0] for _, st in sorted(loop._updater.states.items())]
    assert _rel_fro(a, b) <= 1e-6


def test_amp_loss_scale_change_recaptures_nothing(gen):
    """Under amp.init('float16') the Trainer's fused update is captured
    once: rescale_grad (original scale over the loss scale) is an entry of
    its scalar vector, so three loss scales replay one graph, and their
    scaled gradients give the unscaled run's weights; a non-finite
    gradient skips the replay and halves the scale."""
    from mxnet_tpu_torch import amp, gluon
    from mxnet_tpu_torch.amp import amp as amp_mod
    amp.init('float16')
    try:
        p = torch.nn.Parameter(torch.ones(64, device='cuda'))
        ref = torch.nn.Parameter(torch.ones(64))
        tr = amp.init_trainer(gluon.Trainer([p], 'adamw',
                                            {'learning_rate': 0.1}))
        ref_tr = gluon.Trainer([ref], 'adamw', {'learning_rate': 0.1})
        captures = []
        capture = tr._capture
        tr._capture = lambda *a: captures.append(1) or capture(*a)
        for scale in (2.0 ** 16, 2.0 ** 15, 2.0 ** 14):
            tr._amp_loss_scaler.loss_scale = scale
            with amp.scale_loss(torch.ones((), device='cuda'), tr):
                pass
            p.grad = torch.full((64,), 0.5 * scale, device='cuda')
            tr.step(1)
            ref.grad = torch.full((64,), 0.5)
            ref_tr.step(1)
        torch.cuda.synchronize()
        assert len(captures) == 1
        torch.testing.assert_close(p.detach().cpu(), ref.detach(),
                                   rtol=1e-6, atol=1e-7)
        before = p.detach().clone()
        p.grad = torch.full((64,), float('inf'), device='cuda')
        tr.step(1)
        torch.cuda.synchronize()
        assert torch.equal(p.detach(), before)
        assert tr._amp_loss_scaler.loss_scale == 2.0 ** 13
        assert tr.optimizer.num_update == 3
    finally:
        amp_mod._deinit()
