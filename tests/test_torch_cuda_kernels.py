"""The port's three Hopper kernels against their plain PyTorch versions, on
the card, at small and ragged shapes that chip_smoke.py does not reach
(head dims 8 to 128, sequence lengths and widths that divide no tile).

These tests need a CUDA device and carry the ``cuda`` marker; without a
card they skip. On the card, from the root of the checkout (the file
imports only torch and the port, so the JAX conftest is left out):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py
"""
import pytest
import torch

from mxnet_tpu_torch.ops import flash_attention as fa
from mxnet_tpu_torch.ops import fused_ffn, fused_layernorm

pytestmark = pytest.mark.cuda

# kernel vs plain version on the same inputs: f32 differs by summation
# order only; bf16 outputs may differ by a bf16 ulp or two
TOL = {torch.float32: dict(atol=1e-4, rtol=1e-4),
       torch.bfloat16: dict(atol=1e-2, rtol=1.6e-2)}


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device='cuda').manual_seed(0)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('D', [8, 32, 128])
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


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
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


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
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
        fused_ffn.fused_dense_gelu(x.half(), x.half(),
                                   torch.zeros(4, device='cuda').half())
    q = torch.randn(1, 1, 4, 12, generator=gen, device='cuda')
    with pytest.raises(MXNetError, match='head dim'):
        fa.flash_attention(q, q, q)
