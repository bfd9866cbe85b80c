"""Reference-parity ops that close the long tail of MXNet's op inventory
(counterpart of ``mxnet_tpu/ops/ref_compat.py``): each under the JAX
op's name, signature and output dtypes, plain PyTorch as the JAX package
left them to XLA. ``calibrate_entropy`` and ``sample_unique_zipfian``
run on the host, as the JAX ops do; the random ones draw from
``random.generator`` of their device (``ops/random_ops.py``). The
regression outputs of the JAX module live in ``ops/misc.py``.

This module also registers ``custom`` (``operator.py``'s CustomOp
dispatch) and the control-flow ops ``cond``, ``foreach`` and
``while_loop``, as the JAX module does, so that the reference aliases
(``ops/ref_aliases.py``) find them.
"""
from __future__ import annotations

import numpy as onp
import torch
import torch.nn.functional as F

from ..base import register_op
from ..context import context_of, current_context
from .. import random as _random
from . import random_ops as _rops

__all__ = []


def _reg(fn=None, *, name=None, nograd=False, num_outputs=1,
         mutate_inputs=()):
    def deco(f):
        register_op(name or f.__name__, nograd=nograd,
                    num_outputs=num_outputs, mutate_inputs=mutate_inputs)(f)
        __all__.append(f.__name__)
        return f
    return deco(fn) if fn is not None else deco


# --- small tensor ops (ref: src/operator/tensor/) --------------------------

@_reg
def stop_gradient(data):
    """Identity forward, no gradient (ref: BlockGrad)."""
    return data.detach()


@_reg(name='round')
def round_op(data):
    """Round half away from zero, the reference's ::round (numpy's
    half-to-even is ``_npi_around``)."""
    return torch.sign(data) * torch.floor(torch.abs(data) + 0.5)


@_reg
def reshape_like(lhs, rhs, lhs_begin=None, lhs_end=None, rhs_begin=None,
                 rhs_end=None):
    """lhs in rhs's shape, or over an axis range of each."""
    lshape, rshape = list(lhs.shape), list(rhs.shape)
    if lhs_begin is None and lhs_end is None and rhs_begin is None \
            and rhs_end is None:
        return lhs.reshape(rhs.shape)
    lb = 0 if lhs_begin is None else lhs_begin % (len(lshape) + 1)
    le = len(lshape) if lhs_end is None else lhs_end % (len(lshape) + 1)
    rb = 0 if rhs_begin is None else rhs_begin % (len(rshape) + 1)
    re_ = len(rshape) if rhs_end is None else rhs_end % (len(rshape) + 1)
    return lhs.reshape(lshape[:lb] + rshape[rb:re_] + lshape[le:])


@_reg
def argmax_channel(data):
    """Argmax over axis 1, in data's dtype."""
    return torch.argmax(data, dim=1).to(data.dtype)


@_reg
def square_sum(data, axis=None, keepdims=False):
    if axis is None:
        out = torch.sum(torch.square(data))
        return out.reshape((1,) * data.dim()) if keepdims else out
    return torch.sum(torch.square(data), dim=axis, keepdim=keepdims)


@_reg
def identity_with_attr_like_rhs(lhs, rhs):
    return lhs


@_reg
def split_v2(data, indices=(), axis=0, squeeze_axis=False, sections=0):
    """Split at explicit indices or into equal sections."""
    if sections:
        if data.shape[axis] % sections:
            raise ValueError("array split does not result in an equal "
                             "division")
        pieces = torch.tensor_split(data, sections, dim=axis)
    else:
        pieces = torch.tensor_split(data, list(indices), dim=axis)
    if squeeze_axis:
        pieces = [p.squeeze(axis) for p in pieces]
    return tuple(pieces)


def _slices(shape, begin, end, step=None):
    ndim = len(shape)
    begin = list(begin) + [None] * (ndim - len(begin))
    end = list(end) + [None] * (ndim - len(end))
    step = list(step or []) + [None] * (ndim - len(step or []))
    return tuple(slice(b, e, s) for b, e, s in zip(begin, end, step))


def _set(base, idx, value):
    out = base.clone()
    out[idx] = value
    return out


@_reg
def slice_assign(lhs, rhs, begin=(), end=(), step=None):
    """lhs with lhs[begin:end:step] = rhs."""
    return _set(lhs, _slices(lhs.shape, begin, end, step), rhs)


@_reg
def slice_assign_scalar(data, scalar=0.0, begin=(), end=(), step=None):
    return _set(data, _slices(data.shape, begin, end, step),
                torch.as_tensor(scalar, dtype=data.dtype))


@_reg
def scatter_set_nd(lhs, rhs, indices, shape=None):
    """lhs with lhs[indices] = rhs."""
    idx = tuple(indices[i].to(torch.int64) for i in range(indices.shape[0]))
    return _set(lhs, idx, rhs)


@_reg
def scatter_plus_scalar(data, scalar=0.0):
    return data + torch.as_tensor(scalar, dtype=data.dtype,
                                  device=data.device)


@_reg
def scatter_minus_scalar(data, scalar=0.0):
    return data - torch.as_tensor(scalar, dtype=data.dtype,
                                  device=data.device)


@_reg
def scatter_elemwise_div(lhs, rhs):
    return lhs / rhs


# --- im2col / col2im (ref: src/operator/nn/im2col.cc) ----------------------

def _tuple2(v):
    if v is None:
        return (1, 1)
    if isinstance(v, int):
        return (v, v)
    t = tuple(int(x) for x in v)
    return t * 2 if len(t) == 1 else t


@_reg
def im2col(data, kernel, stride=(1, 1), dilate=(1, 1), pad=(0, 0)):
    """NCHW blocks as columns: (N, C*kh*kw, L)."""
    return F.unfold(data, _tuple2(kernel), dilation=_tuple2(dilate),
                    padding=_tuple2(pad), stride=_tuple2(stride))


@_reg
def col2im(data, output_size, kernel, stride=(1, 1), dilate=(1, 1),
           pad=(0, 0)):
    """Inverse of im2col: the columns summed back into (N, C, H, W)."""
    kh, kw = _tuple2(kernel)
    sh, sw = _tuple2(stride)
    dh, dw = _tuple2(dilate)
    ph, pw = _tuple2(pad)
    oh, ow = _tuple2(output_size)
    n = data.shape[0]
    c = data.shape[1] // (kh * kw)
    l_h = (oh + 2 * ph - (dh * (kh - 1) + 1)) // sh + 1
    l_w = (ow + 2 * pw - (dw * (kw - 1) + 1)) // sw + 1
    cols = data.reshape(n, c, kh, kw, l_h, l_w)
    out = torch.zeros((n, c, oh + 2 * ph, ow + 2 * pw), dtype=data.dtype,
                      device=data.device)
    for i in range(kh):
        for j in range(kw):
            out[:, :, i * dh:i * dh + l_h * sh:sh,
                j * dw:j * dw + l_w * sw:sw] += cols[:, :, i, j]
    return out[:, :, ph:ph + oh, pw:pw + ow]


# --- linalg long tail (ref: src/operator/tensor/la_op.cc) ------------------

@_reg
def linalg_gelqf(a):
    """A = L·Q with Q's rows orthonormal (m <= n), through the QR of Aᵀ;
    L's diagonal is made non-negative, as in the JAX op."""
    q, r = torch.linalg.qr(a.transpose(-1, -2), mode='reduced')
    d = torch.sign(torch.diagonal(r, dim1=-2, dim2=-1))
    d = torch.where(d == 0, torch.ones_like(d), d).to(a.dtype)
    l_mat = (r * d[..., :, None]).transpose(-1, -2)
    q_mat = (q * d[..., None, :]).transpose(-1, -2)
    return l_mat, q_mat


@_reg
def linalg_syevd(a):
    """A = Uᵀ·diag(L)·U with the eigenvectors in U's rows, eigenvalues
    ascending."""
    w, v = torch.linalg.eigh(a)
    return v.transpose(-1, -2), w


def _tri_indices(n, offset, lower):
    return onp.tril_indices(n, k=offset) if lower \
        else onp.triu_indices(n, k=offset)


@_reg
def linalg_extracttrian(a, offset=0, lower=True):
    """A triangle of each square matrix, packed into a vector."""
    rows, cols = _tri_indices(a.shape[-1], offset, lower)
    return a[..., torch.as_tensor(rows, device=a.device),
             torch.as_tensor(cols, device=a.device)]


@_reg
def linalg_maketrian(a, offset=0, lower=True):
    """Inverse of extracttrian."""
    k = a.shape[-1]
    n = 1
    while True:
        rows, cols = _tri_indices(n, offset, lower)
        if len(rows) == k:
            break
        if len(rows) > k or n > 16384:
            raise ValueError(
                f"maketrian: packed length {k} does not correspond to a "
                f"triangle with offset {offset}")
        n += 1
    out = torch.zeros(a.shape[:-1] + (n, n), dtype=a.dtype, device=a.device)
    out[..., torch.as_tensor(rows, device=a.device),
        torch.as_tensor(cols, device=a.device)] = a
    return out


@_reg
def softmax_activation(data, mode='instance'):
    """Softmax over channels (axis 1) or over all non-batch axes."""
    if mode == 'channel':
        return torch.softmax(data, dim=1)
    flat = data.reshape(data.shape[0], -1)
    return torch.softmax(flat, dim=-1).reshape(data.shape)


class _KLSparseReg(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, target, penalty):
        rho_hat = torch.clamp(x.mean(0), 1e-6, 1 - 1e-6)
        ctx.save_for_backward(rho_hat)
        ctx.n, ctx.target, ctx.penalty = x.shape[0], target, penalty
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        rho_hat, = ctx.saved_tensors
        rho = torch.as_tensor(ctx.target, dtype=rho_hat.dtype,
                              device=rho_hat.device)
        kl = ctx.penalty * (-rho / rho_hat + (1 - rho) / (1 - rho_hat))
        return g + (torch.zeros_like(g) + kl) / ctx.n, None, None


@_reg
def identity_attach_kl_sparse_reg(data, sparseness_target=0.1,
                                  penalty=0.001, momentum=0.9):
    """Identity forward; backward adds the KL sparsity penalty on the
    batch-mean activation (the current batch's, as in the JAX op)."""
    return _KLSparseReg.apply(data, sparseness_target, penalty)


# --- ROI pooling and rotated ROI align -------------------------------------

@_reg
def roi_pooling(data, rois, pooled_size=(7, 7), spatial_scale=1.0):
    """Max-pool each ROI (R, 5) [batch, x1, y1, x2, y2] into a (ph, pw)
    grid; an empty bin gives 0 (ref: roi_pooling.cc)."""
    ph, pw = _tuple2(pooled_size)
    n, c, h, w = data.shape
    dev, dt = data.device, data.dtype
    batch_idx = rois[:, 0].to(torch.int64)
    x1 = torch.floor(rois[:, 1] * spatial_scale + 0.5)
    y1 = torch.floor(rois[:, 2] * spatial_scale + 0.5)
    x2 = torch.floor(rois[:, 3] * spatial_scale + 0.5)
    y2 = torch.floor(rois[:, 4] * spatial_scale + 0.5)
    bin_h = torch.clamp(y2 - y1 + 1, min=1.0) / ph
    bin_w = torch.clamp(x2 - x1 + 1, min=1.0) / pw
    ys = torch.arange(h, dtype=dt, device=dev)
    xs = torch.arange(w, dtype=dt, device=dev)
    py = torch.arange(ph, dtype=dt, device=dev)
    px = torch.arange(pw, dtype=dt, device=dev)
    hstart = torch.floor(py[None, :] * bin_h[:, None]) + y1[:, None]
    hend = torch.ceil((py[None, :] + 1) * bin_h[:, None]) + y1[:, None]
    ymask = (ys[None, None, :] >= hstart[..., None]) & \
        (ys[None, None, :] < hend[..., None])
    wstart = torch.floor(px[None, :] * bin_w[:, None]) + x1[:, None]
    wend = torch.ceil((px[None, :] + 1) * bin_w[:, None]) + x1[:, None]
    xmask = (xs[None, None, :] >= wstart[..., None]) & \
        (xs[None, None, :] < wend[..., None])
    feat = data[batch_idx]
    mask = ymask[:, None, :, None, :, None] & xmask[:, None, None, :, None, :]
    vals = torch.where(mask, feat[:, :, None, None, :, :],
                       torch.tensor(float('-inf'), dtype=dt, device=dev))
    out = vals.amax(dim=(-2, -1))
    return torch.where(torch.isfinite(out), out, torch.zeros_like(out))


@_reg
def rroi_align(data, rois, pooled_size=(7, 7), spatial_scale=1.0,
               sampling_ratio=2):
    """Rotated ROI align, rois (R, 6) [batch, cx, cy, w, h, angle_deg]
    (ref: contrib/rroi_align.cc)."""
    ph, pw = _tuple2(pooled_size)
    n, c, h, w = data.shape
    dev = data.device
    s = max(int(sampling_ratio), 1)
    batch_idx = rois[:, 0].to(torch.int64)
    cx = rois[:, 1] * spatial_scale
    cy = rois[:, 2] * spatial_scale
    rw = torch.clamp(rois[:, 3] * spatial_scale, min=1.0)
    rh = torch.clamp(rois[:, 4] * spatial_scale, min=1.0)
    theta = rois[:, 5] * onp.pi / 180.0
    gy = (torch.arange(ph * s, device=dev) + 0.5) / (ph * s) - 0.5
    gx = (torch.arange(pw * s, device=dev) + 0.5) / (pw * s) - 0.5
    yy = gy[None, :, None] * rh[:, None, None]
    xx = gx[None, None, :] * rw[:, None, None]
    cos_t, sin_t = torch.cos(theta), torch.sin(theta)
    sx = cx[:, None, None] + xx * cos_t[:, None, None] \
        - yy * sin_t[:, None, None]
    sy = cy[:, None, None] + xx * sin_t[:, None, None] \
        + yy * cos_t[:, None, None]
    x0 = torch.floor(sx)
    y0 = torch.floor(sy)
    fx = (sx - x0).to(data.dtype)[..., None]
    fy = (sy - y0).to(data.dtype)[..., None]
    feat = data[batch_idx].permute(0, 2, 3, 1)        # (R, H, W, C)
    r = torch.arange(rois.shape[0], device=dev)[:, None, None]

    def gather(yi, xi):
        yi = torch.clamp(yi.to(torch.int64), 0, h - 1)
        xi = torch.clamp(xi.to(torch.int64), 0, w - 1)
        return feat[r, yi, xi]                         # (R, ph*s, pw*s, C)

    val = (gather(y0, x0) * (1 - fx) * (1 - fy) +
           gather(y0, x0 + 1) * fx * (1 - fy) +
           gather(y0 + 1, x0) * (1 - fx) * fy +
           gather(y0 + 1, x0 + 1) * fx * fy)
    inb = ((sx >= -1) & (sx <= w) & (sy >= -1) & (sy <= h))[..., None]
    val = torch.where(inb, val, torch.zeros_like(val))
    out = val.reshape(val.shape[0], ph, s, pw, s, -1).mean(dim=(2, 4))
    return out.movedim(-1, 1)


# --- contrib utilities -----------------------------------------------------

@_reg(nograd=True)
def index_array(data, axes=None):
    """The index grid of data: data.shape + (len(axes),), int32."""
    nd = data.dim()
    axes = tuple(range(nd)) if axes is None else tuple(axes)
    grids = torch.meshgrid(*[torch.arange(s, device=data.device)
                             for s in data.shape], indexing='ij')
    return torch.stack([grids[a % nd] for a in axes], dim=-1).to(torch.int32)


@_reg(nograd=True)
def getnnz(data, axis=None):
    """Count of non-zero values, int32."""
    return torch.count_nonzero(data, dim=axis).to(torch.int32)


@_reg(nograd=True)
def bipartite_matching(data, is_ascend=False, threshold=0.0, topk=-1):
    """Greedy bipartite matching over a (..., N, M) score matrix: (row
    assignment (..., N), column assignment (..., M)), -1 unmatched."""
    n, m = data.shape[-2], data.shape[-1]
    steps = n if topk < 0 else min(topk, n)
    sign = 1.0 if is_ascend else -1.0
    work = data * sign
    thresh = threshold * sign
    big = torch.tensor(float('inf'), dtype=data.dtype, device=data.device)
    rows = torch.arange(n, device=data.device)
    cols = torch.arange(m, device=data.device)
    row_asg = torch.full(data.shape[:-1], -1.0, dtype=data.dtype,
                         device=data.device)
    col_asg = torch.full(data.shape[:-2] + (m,), -1.0, dtype=data.dtype,
                         device=data.device)
    for _ in range(steps):
        flat = work.reshape(work.shape[:-2] + (n * m,))
        idx = torch.argmin(flat, dim=-1)
        best = flat.gather(-1, idx[..., None])[..., 0]
        r, c = idx // m, idx % m
        ok = best <= thresh
        row_asg = torch.where(ok[..., None] & (rows == r[..., None]),
                              c[..., None].to(row_asg.dtype), row_asg)
        col_asg = torch.where(ok[..., None] & (cols == c[..., None]),
                              r[..., None].to(col_asg.dtype), col_asg)
        rowmask = (rows == r[..., None])[..., None]
        colmask = (cols == c[..., None])[..., None, :]
        work = torch.where(ok[..., None, None] & (rowmask | colmask), big,
                           work)
    return row_asg, col_asg


@_reg(nograd=True)
def calibrate_entropy(hist, hist_edges, num_quantized_bins=255):
    """KL-divergence threshold calibration for INT8 quantization, on the
    host in numpy as in the JAX op (ref: calibrate.cc). Returns
    (threshold, divergence) as float32 scalars on hist's device."""
    dev = hist.device if isinstance(hist, torch.Tensor) else None
    hist = onp.asarray(torch.as_tensor(hist).cpu(), dtype=onp.float64)
    edges = onp.asarray(torch.as_tensor(hist_edges).cpu(),
                        dtype=onp.float64)
    num_bins = hist.size
    assert num_bins + 1 == edges.size
    zero_bin = onp.argmax(edges >= 0) - 1 if (edges < 0).any() else 0

    def kl(p, q):
        p = p / max(p.sum(), 1e-12)
        q = q / max(q.sum(), 1e-12)
        mask = p > 0
        qq = onp.where(q > 0, q, 1e-12)
        return float((p[mask] * onp.log(p[mask] / qq[mask])).sum())

    best_t, best_d = float(edges[-1]), onp.inf
    for i in range(max(num_quantized_bins // 2, 1), num_bins + 1):
        lo = max(zero_bin - i, 0)
        hi = min(zero_bin + i, num_bins)
        p = hist[lo:hi].copy()
        if p.sum() == 0:
            continue
        p[0] += hist[:lo].sum()
        p[-1] += hist[hi:].sum()
        chunks = onp.array_split(p, num_quantized_bins)
        q = onp.concatenate([
            onp.full(len(ch), (ch.sum() / max((ch > 0).sum(), 1)))
            * (ch > 0) for ch in chunks])
        d = kl(p, q)
        t = float(max(abs(edges[lo]), abs(edges[hi])))
        if d < best_d:
            best_d, best_t = d, t
    return (torch.tensor(best_t, dtype=torch.float32, device=dev),
            torch.tensor(best_d if onp.isfinite(best_d) else 0.0,
                         dtype=torch.float32, device=dev))


# --- quantized op variants (ref: src/operator/quantization/) ---------------

def _dequant(x, mn, mx):
    scale = torch.clamp(torch.maximum(torch.abs(torch.as_tensor(mn)),
                                      torch.abs(torch.as_tensor(mx))),
                        min=1e-12) / 127.0
    return x.to(torch.float32) * scale


def _requant(x):
    mx = torch.clamp(torch.max(torch.abs(x)), min=1e-12)
    q = torch.clamp(torch.round(x / mx * 127.0), -127, 127).to(torch.int8)
    return q, -mx, mx


@_reg(num_outputs=3)
def quantized_act(data, min_data, max_data, act_type='relu'):
    """relu passes quantized values through with the range clipped at
    zero; the others dequantize, apply and requantize."""
    if act_type != 'relu':
        x = _dequant(data, min_data, max_data)
        y = {'sigmoid': torch.sigmoid, 'tanh': torch.tanh,
             'softrelu': F.softplus}[act_type](x)
        return _requant(y)
    zero = torch.zeros((), dtype=data.dtype, device=data.device)
    return (torch.maximum(data, zero),
            torch.clamp(torch.as_tensor(min_data, dtype=torch.float32),
                        min=0.0),
            torch.clamp(torch.as_tensor(max_data, dtype=torch.float32),
                        min=0.0))


@_reg(num_outputs=3)
def quantized_batch_norm(data, gamma, beta, moving_mean, moving_var,
                         min_data, max_data, eps=1e-3, **_ignored):
    """INT8 inference batch norm: dequantize, normalise, requantize."""
    x = _dequant(data, min_data, max_data)
    inv = gamma / torch.sqrt(moving_var + eps)
    y = (x - moving_mean[None, :, None, None]) * inv[None, :, None, None] \
        + beta[None, :, None, None]
    return _requant(y)


@_reg(num_outputs=3)
def quantized_elemwise_mul(lhs, rhs, lhs_min, lhs_max, rhs_min, rhs_max):
    y = _dequant(lhs, lhs_min, lhs_max) * _dequant(rhs, rhs_min, rhs_max)
    return _requant(y)


@_reg(num_outputs=3)
def quantized_embedding(data, weight, min_weight, max_weight,
                        input_dim=None, output_dim=None, dtype='int8'):
    """Rows stay quantized; the range passes through."""
    return weight[data.to(torch.int64)], min_weight, max_weight


# --- AMP / multi-tensor utilities ------------------------------------------

@_reg
def amp_multicast(*data, num_outputs=None, cast_narrow=False):
    """All inputs cast to the widest (or, with cast_narrow, narrowest)
    of their dtypes."""
    pick = min if cast_narrow else max
    target = pick([d.dtype for d in data], key=lambda t: t.itemsize)
    return tuple(d.to(target) for d in data)


@_reg(nograd=True)
def multi_all_finite(*arrays, num_arrays=None, init_output=True):
    """[1.0] iff every element of every input is finite."""
    ok = torch.ones((), dtype=torch.bool, device=arrays[0].device)
    for a in arrays:
        ok = ok & torch.isfinite(a).all()
    return ok.to(torch.float32).reshape(1)


@_reg(nograd=True, mutate_inputs='all')
def reset_arrays(*arrays, num_arrays=None):
    """Every input zeroed; ``nd.reset_arrays`` writes the zeros back into
    every input."""
    return tuple(torch.zeros_like(a) for a in arrays)


@_reg(nograd=True)
def multi_lars(lrs, weights_sum_sq, grads_sum_sq, wds, eta=0.001,
               eps=1e-8, rescale_grad=1.0):
    """LARS learning-rate coefficients from each layer's |w|² and |g|²."""
    w_norm = torch.sqrt(weights_sum_sq)
    g_norm = torch.sqrt(grads_sum_sq) * rescale_grad
    trust = eta * w_norm / (g_norm + wds * w_norm + eps)
    return torch.where((w_norm > 0) & (g_norm > 0), lrs * trust, lrs)


# --- optimizer long tail (ref: optimizer_op.cc, contrib/adamw.cc) ----------

def _prep(grad, rescale_grad, clip_gradient, wd=0.0, weight=None):
    g = grad * rescale_grad
    if clip_gradient is not None and clip_gradient > 0:
        g = torch.clamp(g, -clip_gradient, clip_gradient)
    if wd and weight is not None:
        g = g + wd * weight
    return g


@_reg(mutate_inputs=(0, 2, 3))
def mp_nag_mom_update(weight, grad, mom, weight32, lr=0.01, momentum=0.0,
                      wd=0.0, rescale_grad=1.0, clip_gradient=-1.0):
    """Mixed-precision NAG on the f32 master copy."""
    g = _prep(grad.to(torch.float32), rescale_grad, clip_gradient, wd,
              weight32)
    new_mom = momentum * mom + g
    w32 = weight32 - lr * (g + momentum * new_mom)
    return w32.to(weight.dtype), new_mom, w32


@_reg(mutate_inputs=(0, 2, 3))
def mp_lamb_update_phase1(weight, grad, mean, var, weight32, beta1=0.9,
                          beta2=0.999, epsilon=1e-6, t=1,
                          bias_correction=True, wd=0.0, rescale_grad=1.0,
                          clip_gradient=-1.0):
    g = _prep(grad.to(torch.float32), rescale_grad, clip_gradient)
    m = beta1 * mean + (1 - beta1) * g
    v = beta2 * var + (1 - beta2) * torch.square(g)
    gh = m / (torch.sqrt(v) + epsilon)
    if bias_correction:
        gh = (m / (1 - beta1 ** t)) / \
            (torch.sqrt(v / (1 - beta2 ** t)) + epsilon)
    return gh + wd * weight32, m, v


@_reg(mutate_inputs=(0, 4))
def mp_lamb_update_phase2(weight, g_update, r1, r2, weight32, lr=0.01,
                          lower_bound=-1.0, upper_bound=-1.0):
    r1c = r1
    if lower_bound > 0:
        r1c = torch.clamp(r1c, min=lower_bound)
    if upper_bound > 0:
        r1c = torch.clamp(r1c, max=upper_bound)
    one = torch.ones_like(r1c)
    ratio = torch.where(r2 > 0, torch.where(r1c > 0, r1c / r2, one), one)
    w32 = weight32 - lr * ratio * g_update
    return w32.to(weight.dtype), w32


@_reg(mutate_inputs=(0, 2, 3, 4))
def mp_adamw_update(weight, grad, mean, var, weight32, rescale_grad=1.0,
                    lr=0.001, eta=1.0, beta1=0.9, beta2=0.999, epsilon=1e-8,
                    wd=0.0, clip_gradient=-1.0):
    """Mixed-precision AdamW (ref: contrib/adamw.cc _mp_adamw_update)."""
    g = _prep(grad.to(torch.float32), rescale_grad, clip_gradient)
    m = beta1 * mean + (1 - beta1) * g
    v = beta2 * var + (1 - beta2) * torch.square(g)
    w32 = weight32 - eta * (lr * m / (torch.sqrt(v) + epsilon)
                            + lr * wd * weight32)
    return w32.to(weight.dtype), m, v, w32


@_reg
def multi_mp_adamw_update(weights, grads, means, vars_, weights32,
                          rescale_grad=1.0, lrs=(), etas=(), wds=(),
                          beta1=0.9, beta2=0.999, epsilon=1e-8,
                          clip_gradient=-1.0):
    """One mp_adamw_update per tensor: a tuple of their 4-tuples."""
    return tuple(
        mp_adamw_update(w, g, m, v, w32, rescale_grad=rescale_grad, lr=lr,
                        eta=eta, beta1=beta1, beta2=beta2, epsilon=epsilon,
                        wd=wd, clip_gradient=clip_gradient)
        for w, g, m, v, w32, lr, eta, wd in zip(weights, grads, means, vars_,
                                                weights32, lrs, etas, wds))


@_reg
def multi_mp_lamb_update(weights, grads, means, vars_, weights32, lrs=(),
                         wds=(), step_count=(), beta1=0.9, beta2=0.999,
                         epsilon=1e-6, bias_correction=True,
                         rescale_grad=1.0, lower_bound=-1.0,
                         upper_bound=-1.0, clip_gradient=-1.0):
    """Mixed-precision LAMB per tensor: a tuple of (w, m, v, w32)."""
    outs = []
    for w, g, m, v, w32, lr, wd, t in zip(weights, grads, means, vars_,
                                          weights32, lrs, wds, step_count):
        gh, m2, v2 = mp_lamb_update_phase1(
            w, g, m, v, w32, beta1=beta1, beta2=beta2, epsilon=epsilon,
            t=t, bias_correction=bias_correction, wd=wd,
            rescale_grad=rescale_grad, clip_gradient=clip_gradient)
        wnew, w32n = mp_lamb_update_phase2(
            w, gh, torch.linalg.vector_norm(w32), torch.linalg.vector_norm(gh),
            w32, lr=lr, lower_bound=lower_bound, upper_bound=upper_bound)
        outs.append((wnew, m2, v2, w32n))
    return tuple(outs)


@_reg(mutate_inputs=(0, 2))
def sparse_adagrad_update(weight, grad, history, lr=0.01, epsilon=1e-7,
                          wd=0.0, rescale_grad=1.0, clip_gradient=-1.0):
    """AdaGrad that leaves rows with an all-zero gradient untouched."""
    g = _prep(grad, rescale_grad, clip_gradient, wd, weight)
    if grad.dim() > 1:
        row_nz = (grad != 0).flatten(1).any(1).reshape(
            (-1,) + (1,) * (grad.dim() - 1))
    else:
        row_nz = grad != 0
    new_hist = torch.where(row_nz, history + torch.square(g), history)
    new_w = torch.where(row_nz,
                        weight - lr * g / (torch.sqrt(new_hist) + epsilon),
                        weight)
    return new_w, new_hist


@_reg(mutate_inputs=(0, 2))
def group_adagrad_update(weight, grad, history, lr=0.01, rescale_grad=1.0,
                         clip_gradient=-1.0, epsilon=1e-5):
    """Per-row AdaGrad, history (rows, 1)."""
    g = _prep(grad, rescale_grad, clip_gradient)
    axes = tuple(range(1, g.dim()))
    msq = torch.mean(torch.square(g), dim=axes, keepdim=True)
    h = history + msq.reshape((history.shape[0],) +
                              (1,) * (history.dim() - 1))
    hb = h.reshape((h.shape[0],) + (1,) * (g.dim() - 1)) if h.dim() == 1 \
        else h
    return weight - lr * g / (torch.sqrt(hb) + epsilon), h


# --- the random *_like family and the unique Zipfian sampler ---------------

def _make_like(base_fn, name):
    def op(data, **kwargs):
        kwargs.pop('shape', None)
        return base_fn(shape=tuple(data.shape), dtype=data.dtype,
                       ctx=context_of(data.device), **kwargs)
    op.__name__ = name
    op.__doc__ = (f"{base_fn.__name__} in the shape and dtype of its input "
                  "(ref: random/sample_op.cc:62).")
    return op


for _base in (_rops.random_uniform, _rops.random_normal, _rops.random_gamma,
              _rops.random_exponential, _rops.random_poisson,
              _rops.random_negative_binomial,
              _rops.random_generalized_negative_binomial):
    _name = _base.__name__ + '_like'
    globals()[_name] = _make_like(_base, _name)
    register_op(_name, nograd=True)(globals()[_name])
    __all__.append(_name)


@_reg(nograd=True, num_outputs=2)
def sample_unique_zipfian(range_max, shape=(), ctx=None):
    """Distinct samples of a Zipfian(range_max) and the number of draws it
    took, on the host as in the JAX op; numpy's stream is seeded from the
    port's CPU generator."""
    n = int(onp.prod(shape)) if shape else 1
    seed = int(torch.randint(0, 2 ** 31 - 1, (),
                             generator=_random.generator('cpu')))
    rng = onp.random.default_rng(seed)
    seen, out, tries = set(), [], 0
    log_range = onp.log(range_max + 1)
    while len(out) < n:
        v = min(int(onp.exp(rng.random() * log_range)) - 1, range_max - 1)
        tries += 1
        if v not in seen:
            seen.add(v)
            out.append(v)
    dev = (ctx or current_context()).device
    arr = onp.asarray(out, dtype=onp.int32).reshape(shape if shape else (1,))
    return (torch.as_tensor(arr, device=dev),
            torch.tensor([tries], dtype=torch.int32, device=dev))


# --- image random augmentation (ref: src/operator/image/image_random.cc) ---

def _u(low, high, device):
    return float(low + (high - low) * _rops.uniform((), device))


def _blend(a, b, alpha):
    return a * alpha + b * (1.0 - alpha)


def _gray(img):
    r, g, b = img[..., 0:1], img[..., 1:2], img[..., 2:3]
    return 0.299 * r + 0.587 * g + 0.114 * b


def _back(out, data):
    if not data.is_floating_point():
        out = torch.clamp(out, 0, 255)
    return out.to(data.dtype)


@_reg(nograd=True)
def image_adjust_lighting(data, alpha=(0.0, 0.0, 0.0)):
    """AlexNet-style PCA lighting with an explicit alpha."""
    dev = data.device
    eigval = torch.tensor([55.46, 4.794, 1.148], device=dev)
    eigvec = torch.tensor([[-0.5675, 0.7192, 0.4009],
                           [-0.5808, -0.0045, -0.814],
                           [-0.5836, -0.6948, 0.4203]], device=dev)
    delta = eigvec @ (torch.tensor(alpha, dtype=torch.float32, device=dev)
                      * eigval)
    return _back(data.to(torch.float32) + delta, data)


@_reg(nograd=True)
def image_random_lighting(data, alpha_std=0.05):
    a = _rops.normal((3,), data.device) * alpha_std
    return image_adjust_lighting(data, tuple(float(x) for x in a.cpu()))


@_reg(nograd=True)
def image_random_brightness(data, min_factor=0.5, max_factor=1.5):
    f = _u(min_factor, max_factor, data.device)
    return _back(data.to(torch.float32) * f, data)


@_reg(nograd=True)
def image_random_contrast(data, min_factor=0.5, max_factor=1.5):
    f = _u(min_factor, max_factor, data.device)
    x = data.to(torch.float32)
    return _back(_blend(x, torch.mean(_gray(x)), f), data)


@_reg(nograd=True)
def image_random_saturation(data, min_factor=0.5, max_factor=1.5):
    f = _u(min_factor, max_factor, data.device)
    x = data.to(torch.float32)
    return _back(_blend(x, _gray(x), f), data)


@_reg(nograd=True)
def image_random_hue(data, min_factor=0.5, max_factor=1.5):
    """Rotate the hue in YIQ space by an angle drawn from [min, max]·π."""
    f = _u(min_factor, max_factor, data.device)
    x = data.to(torch.float32)
    t_yiq = torch.tensor([[0.299, 0.587, 0.114],
                          [0.596, -0.274, -0.321],
                          [0.211, -0.523, 0.311]], device=data.device)
    t_rgb = torch.linalg.inv(t_yiq)
    u, w_ = onp.cos(f * onp.pi), onp.sin(f * onp.pi)
    rot = torch.tensor([[1, 0, 0], [0, u, -w_], [0, w_, u]],
                       dtype=torch.float32, device=data.device)
    m = t_rgb @ rot @ t_yiq
    return _back(torch.einsum('...c,dc->...d', x, m), data)


@_reg(nograd=True)
def image_random_color_jitter(data, brightness=0.0, contrast=0.0,
                              saturation=0.0, hue=0.0):
    """Brightness, contrast, saturation and hue jitters in a random order
    (numpy's stream picks the order, as in the JAX op)."""
    jitters = []
    if brightness > 0:
        jitters.append(lambda d: image_random_brightness(
            d, 1 - brightness, 1 + brightness))
    if contrast > 0:
        jitters.append(lambda d: image_random_contrast(
            d, 1 - contrast, 1 + contrast))
    if saturation > 0:
        jitters.append(lambda d: image_random_saturation(
            d, 1 - saturation, 1 + saturation))
    if hue > 0:
        jitters.append(lambda d: image_random_hue(d, -hue, hue))
    for i in onp.random.permutation(len(jitters)):
        data = jitters[int(i)](data)
    return data


@_reg(nograd=True)
def image_random_flip_left_right(data, p=0.5):
    return data.flip(-2) if _u(0.0, 1.0, data.device) < p else data


@_reg(nograd=True)
def image_random_flip_top_bottom(data, p=0.5):
    return data.flip(-3) if _u(0.0, 1.0, data.device) < p else data


# --- custom-op dispatch and control flow as registered ops -----------------

@_reg
def custom(*data, op_type=None, **kwargs):
    """``operator.py``'s CustomOp dispatch (it registers itself over this
    entry when imported)."""
    from .. import operator as _operator
    return _operator.custom(*data, op_type=op_type, **kwargs)


def _register_control_flow():
    from . import control_flow as cf
    register_op('cond')(cf.cond)
    register_op('foreach')(cf.foreach)
    register_op('while_loop')(cf.while_loop)


_register_control_flow()
