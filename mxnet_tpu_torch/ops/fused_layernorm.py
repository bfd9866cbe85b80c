"""Fused residual-add + LayerNorm: a Triton forward kernel, its plain
PyTorch version, and the autograd Function around them (counterpart of
``mxnet_tpu/ops/pallas_layernorm.py`` and its ``custom_vjp``).

Replaces ``_ln_kernel`` (launched by ``_fwd_impl``): out = LN(x + r) *
gamma + beta with f32 statistics and the output in x's dtype.

What bounds it on the H100: no matrix work, one read of x and r and one
write of the output: at the BERT-base serving shape (N = B*T = 4096 rows,
C = 768, bf16) that is 18.9 MB, 5.6 us at 3.35 TB/s. Design: one program
per block of rows with C held whole (``BLOCK_C`` = next power of two,
masked), so each element is read once and the sum never goes back to
device memory; Triton's masked row loads and ``tl.sum`` reach the memory
rate without hand-written shuffles, which is why this kernel is Triton.

The backward is ``_bwd``'s math in plain PyTorch, as the JAX package's is
plain ``jnp`` outside any Pallas kernel. As there, the forward saves the
sum ``x + res`` in x's dtype (bf16 in training), and the backward takes
its statistics from that rounded sum, not from the f32 sum the kernel
normalised; dx is returned for both x and res.

``triton`` is imported, and the kernel defined, at the first launch.
(No ``from __future__ import annotations`` here: Triton reads the
``tl.constexpr`` annotations of the kernel's parameters.)
"""
import torch

from ..base import MXNetError
from . import _build

__all__ = ['fused_add_layer_norm', 'add_layer_norm_reference',
           'add_layer_norm_backward']

_ROWS = 4
_kernel = []


def _triton_kernel():
    if not _kernel:
        import triton
        global tl
        import triton.language as tl

        @triton.jit
        def _add_ln_fwd(X, R, G, Bt, O, n_rows, C, eps,
                        BLOCK_C: tl.constexpr, ROWS: tl.constexpr):
            rows = tl.program_id(0) * ROWS + tl.arange(0, ROWS)
            cols = tl.arange(0, BLOCK_C)
            rmask = rows < n_rows
            cmask = cols < C
            mask = rmask[:, None] & cmask[None, :]
            offs = rows.to(tl.int64)[:, None] * C + cols[None, :]
            x = tl.load(X + offs, mask=mask, other=0.0).to(tl.float32) \
                + tl.load(R + offs, mask=mask, other=0.0).to(tl.float32)
            mean = tl.sum(x, axis=1) / C
            xc = tl.where(mask, x - mean[:, None], 0.0)
            var = tl.sum(xc * xc, axis=1) / C
            inv = 1.0 / tl.sqrt(var + eps)
            g = tl.load(G + cols, mask=cmask, other=0.0).to(tl.float32)
            b = tl.load(Bt + cols, mask=cmask, other=0.0).to(tl.float32)
            out = xc * inv[:, None] * g[None, :] + b[None, :]
            tl.store(O + offs, out.to(O.dtype.element_ty), mask=mask)

        _kernel.append((triton, _add_ln_fwd))
    return _kernel[0]


def add_layer_norm_reference(x, res, gamma, beta, eps=1e-5):
    """Plain version of ``_ln_kernel``: f32 add, mean, centred variance,
    rsqrt, gamma/beta in f32, then the cast to x's dtype."""
    s = x.to(torch.float32) + res.to(torch.float32)
    mean = s.mean(-1, keepdim=True)
    xc = s - mean
    var = (xc * xc).mean(-1, keepdim=True)
    out = xc * torch.rsqrt(var + eps) * gamma.to(torch.float32) \
        + beta.to(torch.float32)
    return out.to(x.dtype)


def _launch(x, res, gamma, beta, eps):
    if not (res.is_cuda and gamma.is_cuda and beta.is_cuda):
        raise MXNetError("fused_add_layer_norm: all inputs must be on CUDA")
    if res.shape != x.shape or res.dtype != x.dtype:
        raise MXNetError(f"fused_add_layer_norm: residual {tuple(res.shape)}"
                         f" {res.dtype} does not match x {tuple(x.shape)} "
                         f"{x.dtype}")
    if x.dtype not in (torch.float32, torch.bfloat16, torch.float16):
        raise MXNetError(f"fused_add_layer_norm: unsupported dtype {x.dtype}")
    C = x.shape[-1]
    if gamma.shape != (C,) or beta.shape != (C,):
        raise MXNetError(f"fused_add_layer_norm: gamma/beta must be ({C},)")
    for name, t in (('x', x), ('res', res), ('gamma', gamma),
                    ('beta', beta)):
        if not t.is_contiguous():
            raise MXNetError(f"fused_add_layer_norm: {name} must be "
                             f"contiguous")
    triton, kernel = _triton_kernel()
    out = torch.empty_like(x)
    n_rows = x.numel() // C
    block_c = triton.next_power_of_2(C)
    grid = (triton.cdiv(n_rows, _ROWS),)
    # Triton specializes on the dtypes, the constexprs, and each integer
    # argument's being 1 or a multiple of 16
    key = (x.dtype, block_c, n_rows == 1, n_rows % 16 == 0, C % 16 == 0)
    _build.triton_first_launch(
        'fused_add_layernorm', key, lambda: kernel[grid](
            x, res, gamma, beta, out, n_rows, C, float(eps),
            BLOCK_C=block_c, ROWS=_ROWS, num_warps=4))
    _build.count_launch('fused_add_layernorm', None, x.dtype)
    return out


def add_layer_norm_backward(s_in, gamma, g, eps=1e-5):
    """``_bwd`` of the JAX package: (dx, dgamma, dbeta) from the saved sum
    ``s_in`` (in x's dtype), gamma and the output gradient ``g``. dx comes
    back in s_in's dtype, dgamma and dbeta, summed in f32, in gamma's."""
    s = s_in.to(torch.float32)
    mean = s.mean(-1, keepdim=True)
    xc = s - mean
    var = (xc * xc).mean(-1, keepdim=True)
    inv = torch.rsqrt(var + eps)
    xhat = xc * inv
    gf = g.to(torch.float32)
    lead = tuple(range(g.dim() - 1))
    dgamma = (gf * xhat).sum(lead)
    dbeta = gf.sum(lead)
    gg = gf * gamma.to(torch.float32)
    dx = inv * (gg - gg.mean(-1, keepdim=True)
                - xhat * (gg * xhat).mean(-1, keepdim=True))
    return (dx.to(s_in.dtype), dgamma.to(gamma.dtype),
            dbeta.to(gamma.dtype))


class _FusedAddLayerNorm(torch.autograd.Function):
    """Forward: the Triton kernel for CUDA tensors, the plain version for
    CPU tensors. Backward: ``add_layer_norm_backward`` on both."""

    @staticmethod
    def forward(ctx, x, res, gamma, beta, eps):
        if x.is_cuda:
            out = _launch(x, res, gamma, beta, eps)
        else:
            out = add_layer_norm_reference(x, res, gamma, beta, eps)
        if any(ctx.needs_input_grad[:4]):
            ctx.save_for_backward(x + res, gamma)
        ctx.eps = eps
        return out

    @staticmethod
    def backward(ctx, g):
        s_in, gamma = ctx.saved_tensors
        dx, dgamma, dbeta = add_layer_norm_backward(s_in, gamma, g, ctx.eps)
        return dx, dx, dgamma, dbeta, None


def fused_add_layer_norm(x, res, gamma, beta, eps=1e-5):
    """LN(x + res) * gamma + beta in one pass over the rows, differentiable
    in x, res, gamma and beta: the Triton kernel for a CUDA tensor, the
    plain version for a CPU tensor. x and res are first promoted to
    ``torch.result_type(x, res)``, as ``x + res`` is (under AMP the f32
    residual stream meets a low-precision sublayer output), and the
    output has that dtype."""
    if not x.is_cuda and x.device.type != 'cpu':
        raise MXNetError(f"fused_add_layer_norm: unsupported device "
                         f"{x.device}")
    dt = torch.result_type(x, res)
    return _FusedAddLayerNorm.apply(x.to(dt), res.to(dt), gamma, beta,
                                    float(eps))
