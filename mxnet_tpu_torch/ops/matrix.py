"""Shape manipulation, matrix products and ordering (counterpart of
``mxnet_tpu/ops/matrix.py``, ref: src/operator/tensor/{matrix_op.cc,
dot.cc,ordering_op.cc}).

``reshape``, ``transpose`` and slices return torch views. That is safe
because no NDArray is ever written in place: writes rebind an NDArray to
a new tensor (see ``ndarray/ndarray.py``). ``dot`` and ``batch_dot`` are
torch products, as the JAX package left them to XLA. The ``linalg_*``
ops (ref: la_op.cc) are ``torch.matmul`` and ``torch.linalg`` (cuBLAS
and cuSOLVER on the card), as the JAX package left them to XLA.
"""
from __future__ import annotations

import builtins

import torch
import torch.nn.functional as F

from ..base import register_op, MXNetError, torch_dtype

__all__ = []

builtins_slice = builtins.slice


def _reg(fn):
    register_op(fn.__name__)(fn)
    __all__.append(fn.__name__)
    return fn


def reshape_shape(src, shape, reverse=False):
    """The target shape of MXNet's reshape with its special codes 0
    (keep), -1 (infer), -2 (copy the rest), -3 (merge two), -4 (split
    one into the next two) (ref: matrix_op.cc Reshape)."""
    shape = tuple(int(s) for s in shape)
    if not any(s in (0, -2, -3, -4) for s in shape):
        return shape
    src = list(src)
    if reverse:
        src = src[::-1]
        shape = tuple(reversed(shape))
    out = []
    i = 0  # index into src
    j = 0
    while j < len(shape):
        s = shape[j]
        if s == 0:
            out.append(src[i]); i += 1
        elif s == -1:
            out.append(-1); i += 1
        elif s == -2:
            out.extend(src[i:]); i = len(src)
        elif s == -3:
            out.append(src[i] * src[i + 1]); i += 2
        elif s == -4:
            a, b = shape[j + 1], shape[j + 2]
            if a == -1:
                a = src[i] // b
            if b == -1:
                b = src[i] // a
            out.extend([a, b]); i += 1; j += 2
        else:
            out.append(s); i += 1
        j += 1
    if reverse:
        out = out[::-1]
    return tuple(out)


@_reg
def reshape(data, shape=None, reverse=False):
    if shape is None:
        raise MXNetError("reshape needs a target shape")
    return torch.reshape(data, reshape_shape(data.shape, shape, reverse))


@_reg
def flatten(data):
    return torch.reshape(data, (data.shape[0], -1))


@_reg
def transpose(data, axes=None):
    if not axes:
        axes = tuple(reversed(range(data.dim())))
    return data.permute(*axes)


@_reg
def expand_dims(data, axis=0):
    return torch.unsqueeze(data, axis)


@_reg
def squeeze(data, axis=None):
    if axis is None:
        return torch.squeeze(data)
    return torch.squeeze(data, tuple(axis) if isinstance(axis, (list, tuple))
                         else axis)


@_reg
def swapaxes(data, dim1=0, dim2=1):
    return torch.swapaxes(data, dim1, dim2)


@_reg
def slice(data, begin=None, end=None, step=None):
    """General strided slice (ref: matrix_op.cc Slice); None entries mean
    the full range. A negative step flips first, as torch slices take no
    negative step."""
    ndim = data.dim()
    begin = list(begin) + [None] * (ndim - len(begin))
    end = list(end) + [None] * (ndim - len(end))
    step = list(step or []) + [None] * (ndim - len(step or []))
    out = data
    for ax, (b, e, s) in enumerate(zip(begin, end, step)):
        if s is not None and s < 0:
            n = out.shape[ax]
            rng = range(n)[builtins_slice(b, e, s)]
            idx = torch.tensor(list(rng), dtype=torch.int64,
                               device=data.device)
            out = torch.index_select(out, ax, idx)
        else:
            idx = [builtins_slice(None)] * ndim
            idx[ax] = builtins_slice(b, e, s)
            out = out[tuple(idx)]
    return out


@_reg
def slice_axis(data, axis=0, begin=0, end=None):
    idx = [builtins_slice(None)] * data.dim()
    idx[axis] = builtins_slice(begin, end)
    return data[tuple(idx)]


@_reg
def slice_like(data, shape_like, axes=()):
    axes = tuple(axes) or tuple(range(builtins.min(data.dim(),
                                                   shape_like.dim())))
    idx = [builtins_slice(None)] * data.dim()
    for a in axes:
        idx[a] = builtins_slice(0, shape_like.shape[a])
    return data[tuple(idx)]


@_reg
def concat(*args, dim=1):
    return torch.cat(args, dim=dim)


@_reg
def stack(*args, axis=0):
    return torch.stack(args, dim=axis)


def split(data, num_outputs=None, axis=1, squeeze_axis=False):
    """Ref: slice_channel.cc (SliceChannel); the axis must divide evenly."""
    n = data.shape[axis]
    if n % num_outputs:
        raise MXNetError(f"split: axis {axis} of size {n} does not divide "
                         f"into {num_outputs} outputs")
    parts = torch.split(data, n // num_outputs, dim=axis)
    if squeeze_axis:
        parts = [torch.squeeze(p, axis) for p in parts]
    return tuple(parts)


register_op("split", num_outputs=-1)(split)
__all__.append("split")


@_reg
def tile(data, reps=()):
    return torch.tile(data, tuple(reps))


@_reg
def repeat(data, repeats=1, axis=None):
    if axis is None:
        return torch.repeat_interleave(data.reshape(-1), repeats)
    return torch.repeat_interleave(data, repeats, dim=axis)


def _flip_axes(axis):
    return tuple(axis) if isinstance(axis, (list, tuple)) else (axis,)


@_reg
def flip(data, axis=()):
    return torch.flip(data, _flip_axes(axis))


@_reg
def reverse(data, axis=()):
    return torch.flip(data, _flip_axes(axis))


@_reg
def pad(data, mode='constant', pad_width=(), constant_value=0.0):
    pw = [(pad_width[2 * i], pad_width[2 * i + 1])
          for i in range(len(pad_width) // 2)]
    if mode == 'constant':
        flat = [p for pair in reversed(pw) for p in pair]
        return F.pad(data, flat, mode='constant', value=constant_value)
    tmode = {'edge': 'replicate', 'reflect': 'reflect'}[mode]
    # torch pads the trailing dims of an (N, C, ...) tensor; MXNet leaves
    # the first two unpadded in these modes
    flat = [p for pair in reversed(pw[2:]) for p in pair]
    return F.pad(data, flat, mode=tmode)


@_reg
def depth_to_space(data, block_size=2):
    n, c, h, w = data.shape
    b = block_size
    x = data.reshape(n, b, b, c // (b * b), h, w)
    x = x.permute(0, 3, 4, 1, 5, 2)
    return x.reshape(n, c // (b * b), h * b, w * b)


@_reg
def space_to_depth(data, block_size=2):
    n, c, h, w = data.shape
    b = block_size
    x = data.reshape(n, c, h // b, b, w // b, b)
    x = x.permute(0, 3, 5, 1, 2, 4)
    return x.reshape(n, c * b * b, h // b, w // b)


# --- matmul family ---------------------------------------------------------

@_reg
def dot(lhs, rhs, transpose_a=False, transpose_b=False):
    """MXNet dot: contracts the last axis of lhs with the first axis of
    rhs (ref: src/operator/tensor/dot.cc); transposing reverses all axes."""
    if transpose_a:
        lhs = transpose(lhs)
    if transpose_b:
        rhs = transpose(rhs)
    if lhs.dim() == 1 and rhs.dim() == 1:
        return torch.dot(lhs, rhs)
    if lhs.dim() == 2 and rhs.dim() == 2:
        return torch.matmul(lhs, rhs)
    return torch.tensordot(lhs, rhs, dims=([lhs.dim() - 1], [0]))


@_reg
def batch_dot(lhs, rhs, transpose_a=False, transpose_b=False):
    """Batched product over leading dims (ref: dot.cc batch_dot)."""
    if transpose_a:
        lhs = torch.swapaxes(lhs, -1, -2)
    if transpose_b:
        rhs = torch.swapaxes(rhs, -1, -2)
    return torch.matmul(lhs, rhs)


@_reg
def khatri_rao(*args):
    """Column-wise Khatri-Rao product (ref: src/operator/contrib/krprod.cc)."""
    out = args[0]
    for m in args[1:]:
        out = torch.einsum('ik,jk->ijk', out, m).reshape(-1, out.shape[1])
    return out


# --- ordering (ref: src/operator/tensor/ordering_op.cc) --------------------

@_reg
def sort(data, axis=-1, is_ascend=True):
    out = torch.sort(data, dim=axis, stable=True).values
    if not is_ascend:
        out = torch.flip(out, (axis,))
    return out


@_reg
def argsort(data, axis=-1, is_ascend=True, dtype='float32'):
    out = torch.argsort(data, dim=axis, stable=True)
    if not is_ascend:
        out = torch.flip(out, (axis,))
    return out.to(torch_dtype(dtype))


def topk(data, axis=-1, k=1, ret_typ='indices', is_ascend=False,
         dtype='float32'):
    """Ref: ordering_op.cc TopK. ret_typ in {value, indices, mask, both}.
    Ties keep the lower index first, as ``lax.top_k`` does."""
    src = -data if is_ascend else data
    axis = axis % data.dim()
    src_m = torch.movedim(src, axis, -1)
    vals, idxs = torch.sort(src_m, dim=-1, descending=True, stable=True)
    vals, idxs = vals[..., :k], idxs[..., :k]
    if is_ascend:
        vals = -vals
    vals = torch.movedim(vals, -1, axis)
    idxs_m = idxs
    idxs = torch.movedim(idxs, -1, axis)
    if ret_typ == 'value':
        return vals
    if ret_typ == 'indices':
        return idxs.to(torch_dtype(dtype))
    if ret_typ == 'mask':
        mask = F.one_hot(idxs_m, data.shape[axis]).sum(-2).to(data.dtype)
        return torch.movedim(mask, -1, axis)
    return vals, idxs.to(torch_dtype(dtype))


register_op("topk", num_outputs=-1)(topk)
__all__.append("topk")


@_reg
def shape_array(data):
    return torch.tensor(data.shape, dtype=torch.int64, device=data.device)


@_reg
def size_array(data):
    return torch.tensor([data.numel()], dtype=torch.int64,
                        device=data.device)


@_reg
def zeros_like(data):
    return torch.zeros_like(data)


@_reg
def ones_like(data):
    return torch.ones_like(data)


@_reg
def diag(data, k=0):
    if data.dim() == 1:
        return torch.diag(data, k)
    return torch.diagonal(data, offset=k, dim1=-2, dim2=-1)


@_reg
def tril(data, k=0):
    return torch.tril(data, k)


@_reg
def triu(data, k=0):
    return torch.triu(data, k)


@_reg
def einsum(*args, subscripts=''):
    return torch.einsum(subscripts, *args)


@_reg
def histogram(data, bin_cnt=10, range=None):
    """Counts in ``bin_cnt`` equal bins over ``range`` (the data's min and
    max when None), in the data's dtype as ``jnp.histogram`` gives them;
    the last bin is closed, as numpy's."""
    x = data.reshape(-1).to(torch.float32)
    lo, hi = (x.min(), x.max()) if range is None else (
        torch.tensor(float(range[0])), torch.tensor(float(range[1])))
    edges = torch.linspace(float(lo), float(hi), bin_cnt + 1,
                           device=data.device)
    idx = torch.bucketize(x, edges, right=True) - 1
    idx = torch.where(x == edges[-1], bin_cnt - 1, idx)
    keep = (idx >= 0) & (idx < bin_cnt)
    hist = torch.bincount(idx[keep], minlength=bin_cnt).to(data.dtype)
    return hist, edges.to(data.dtype)


# --- linalg (ref: src/operator/tensor/la_op.cc) ----------------------------

def _t(x):
    return x.transpose(-1, -2)


@_reg
def linalg_gemm(A, B, C, transpose_a=False, transpose_b=False, alpha=1.0,
                beta=1.0):
    a = _t(A) if transpose_a else A
    b = _t(B) if transpose_b else B
    return alpha * torch.matmul(a, b) + beta * C


@_reg
def linalg_gemm2(A, B, transpose_a=False, transpose_b=False, alpha=1.0):
    a = _t(A) if transpose_a else A
    b = _t(B) if transpose_b else B
    return alpha * torch.matmul(a, b)


@_reg
def linalg_potrf(A):
    return torch.linalg.cholesky(A)


@_reg
def linalg_potri(A):
    """A's inverse through its Cholesky factor. As in the JAX op, ``A`` is
    the SPD matrix itself, where MXNet takes its factor L (ROADMAP
    queue 3)."""
    L = torch.linalg.cholesky(A)
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
    inv_l = torch.linalg.solve_triangular(L, eye.expand(A.shape),
                                          upper=False)
    return torch.matmul(_t(inv_l), inv_l)


@_reg
def linalg_trsm(A, B, transpose=False, rightside=False, lower=True,
                alpha=1.0):
    a = _t(A) if transpose else A
    low = lower != transpose
    if rightside:
        x = _t(torch.linalg.solve_triangular(_t(a), _t(B), upper=low))
    else:
        x = torch.linalg.solve_triangular(a, B, upper=not low)
    return alpha * x


@_reg
def linalg_trmm(A, B, transpose=False, rightside=False, lower=True,
                alpha=1.0):
    tri = torch.tril(A) if lower else torch.triu(A)
    if transpose:
        tri = _t(tri)
    out = torch.matmul(B, tri) if rightside else torch.matmul(tri, B)
    return alpha * out


@_reg
def linalg_syrk(A, transpose=False, alpha=1.0):
    a = _t(A) if transpose else A
    return alpha * torch.matmul(a, _t(a))


@_reg
def linalg_sumlogdiag(A):
    return torch.log(torch.diagonal(A, dim1=-2, dim2=-1)).sum(-1)


@_reg
def linalg_extractdiag(A, offset=0):
    return torch.diagonal(A, offset=offset, dim1=-2, dim2=-1)


@_reg
def linalg_makediag(A, offset=0):
    return torch.diag_embed(A, offset=offset)


@_reg
def linalg_det(A):
    return torch.linalg.det(A)


@_reg
def linalg_inverse(A):
    return torch.linalg.inv(A)


@_reg
def linalg_slogdet(A):
    sign, logdet = torch.linalg.slogdet(A)
    return sign, logdet
