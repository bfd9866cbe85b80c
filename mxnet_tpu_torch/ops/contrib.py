"""The box ops that detection needs (counterpart of part of
``mxnet_tpu/ops/contrib.py``; ref: src/operator/contrib/bounding_box.cc,
multibox_prior.cc): ``box_iou``, ``box_nms`` and ``multibox_prior``,
plain PyTorch as the JAX package leaves them to XLA; and the rest of the
JAX module: resizing (``bilinear_resize2d``, ``image_resize``, which
weighs as ``jax.image.resize`` does, antialiased when it shrinks), ROI
align, adaptive pooling, the spatial transformer and grid sampler, and
the image ops (HWC or NHWC; ``image_normalize`` CHW or NCHW).

``box_nms`` keeps the JAX op's result but not its cost. The JAX op builds
the (B, N, N) IoU matrix of the score-sorted boxes and sweeps all N rows;
only the first ``topk`` rows can suppress anything, so the port builds
(B, keep_n, N) and sweeps ``keep_n`` rows (keep_n = min(topk, N), or N
when topk <= 0). At SSD-512's 24572 anchors and topk 400 that is 39 MB a
batch row instead of 2.4 GB. The sort is stable, as ``jnp.argsort`` is:
every invalid score ties at -inf.
"""
from __future__ import annotations

import math

import torch

from ..base import register_op

__all__ = []


def _reg(fn):
    register_op(fn.__name__)(fn)
    __all__.append(fn.__name__)
    return fn


def _iou_corner(a, b):
    """a: (..., M, 4), b: (..., K, 4) corner boxes -> (..., M, K). Each
    coordinate's overlap is its own (..., M, K) tensor, so nothing of
    shape (..., M, K, 2) is formed; the arithmetic is the JAX op's."""
    a, b = a[..., :, None, :], b[..., None, :, :]
    iw = (torch.minimum(a[..., 2], b[..., 2]) -
          torch.maximum(a[..., 0], b[..., 0])).clamp_min(0.0)
    ih = (torch.minimum(a[..., 3], b[..., 3]) -
          torch.maximum(a[..., 1], b[..., 1])).clamp_min(0.0)
    inter = iw * ih
    del iw, ih
    area_a = (a[..., 2] - a[..., 0]).clamp_min(0) * \
        (a[..., 3] - a[..., 1]).clamp_min(0)
    area_b = (b[..., 2] - b[..., 0]).clamp_min(0) * \
        (b[..., 3] - b[..., 1]).clamp_min(0)
    union = area_a + area_b - inter
    return torch.where(union > 0, inter / union, 0.0)


def _center_to_corner(x):
    xy, half = x[..., :2], x[..., 2:4] / 2
    return torch.cat([xy - half, xy + half], dim=-1)


@_reg
def box_iou(lhs, rhs, format='corner'):
    """IoU of every lhs box with every rhs box (ref: bounding_box.cc
    box_iou)."""
    if format == 'center':
        lhs, rhs = _center_to_corner(lhs), _center_to_corner(rhs)
    return _iou_corner(lhs, rhs)


@_reg
def box_nms(data, overlap_thresh=0.5, valid_thresh=0.0, topk=-1,
            coord_start=2, score_index=1, id_index=-1, background_id=-1,
            force_suppress=False, in_format='corner', out_format='corner'):
    """Greedy NMS over (..., N, K >= 6) rows (ref: bounding_box.cc
    box_nms): rows sorted by score, highest first; a kept row among the
    first ``topk`` suppresses every later row of its class (any class with
    ``force_suppress`` or no ``id_index``) whose IoU with it passes
    ``overlap_thresh``. Suppressed, invalid and rows past ``topk`` get
    score -1."""
    orig_shape = data.shape
    x = data.reshape((-1,) + tuple(orig_shape[-2:]))
    B, N, _ = x.shape
    scores = x[..., score_index]
    boxes = x[..., coord_start:coord_start + 4]
    if in_format == 'center':
        boxes = _center_to_corner(boxes)
    cls_id = x[..., id_index] if id_index >= 0 else None
    valid = scores > valid_thresh
    if background_id >= 0 and cls_id is not None:
        valid = valid & (cls_id != background_id)
    order = torch.argsort(-torch.where(valid, scores, float('-inf')),
                          dim=-1, stable=True)
    keep_n = min(topk, N) if topk > 0 else N
    sorted_boxes = boxes.gather(1, order[..., None].expand(B, N, 4))
    sorted_valid = valid.gather(1, order)
    iou = _iou_corner(sorted_boxes[:, :keep_n], sorted_boxes)
    sup = iou > overlap_thresh
    if not force_suppress and cls_id is not None:
        sorted_cls = cls_id.gather(1, order)
        sup &= sorted_cls[:, :keep_n, None] == sorted_cls[:, None, :]
    pos = torch.arange(N, device=x.device)
    sup &= pos[None, None, :] > pos[:keep_n, None]
    keep = sorted_valid & (pos < keep_n)
    for i in range(keep_n):
        keep = keep & ~(sup[:, i] & keep[:, i:i + 1])
    sorted_x = x.gather(1, order[..., None].expand(x.shape))
    new_scores = torch.where(keep, sorted_x[..., score_index], -1.0)
    out = torch.cat([sorted_x[..., :score_index], new_scores[..., None],
                     sorted_x[..., score_index + 1:]], dim=-1)
    return out.reshape(orig_shape)


@_reg
def multibox_prior(data, sizes=(1.0,), ratios=(1.0,), clip=False,
                   steps=(-1.0, -1.0), offsets=(0.5, 0.5)):
    """SSD anchors over a (B, C, H, W) feature map (ref:
    multibox_prior.cc): (1, H*W*A, 4) corner boxes in [0, 1] units,
    A = len(sizes) + len(ratios) - 1 per cell, in f32 on data's
    device."""
    h, w = data.shape[2], data.shape[3]
    dev = data.device
    f32 = torch.float32
    step_y = steps[0] if steps[0] > 0 else 1.0 / h
    step_x = steps[1] if steps[1] > 0 else 1.0 / w
    cy = (torch.arange(h, dtype=f32, device=dev) + offsets[0]) * step_y
    cx = (torch.arange(w, dtype=f32, device=dev) + offsets[1]) * step_x
    cyg, cxg = torch.meshgrid(cy, cx, indexing='ij')
    sizes, ratios = list(sizes), list(ratios)
    anchors = []
    for i in range(len(sizes) + len(ratios) - 1):
        s, r = (sizes[i], ratios[0]) if i < len(sizes) else \
            (sizes[0], ratios[i - len(sizes) + 1])
        sr = torch.sqrt(torch.tensor(float(r), dtype=f32, device=dev))
        hw, hh = s * sr / 2, s / sr / 2
        anchors.append(torch.stack([cxg - hw, cyg - hh, cxg + hw, cyg + hh],
                                   dim=-1))
    out = torch.stack(anchors, dim=2).reshape(1, -1, 4)
    return out.clamp(0.0, 1.0) if clip else out


@_reg
def bilinear_resize2d(data, height=None, width=None, scale_height=None,
                      scale_width=None, mode='size', align_corners=True):
    """NCHW bilinear resize (ref: contrib/bilinear_resize.cc)."""
    n, c, h, w = data.shape
    if height is None:
        height = int(h * scale_height)
        width = int(w * scale_width)
    dev = data.device
    if align_corners and height > 1 and width > 1:
        ys = torch.linspace(0, h - 1, height, device=dev)
        xs = torch.linspace(0, w - 1, width, device=dev)
    else:
        ys = (torch.arange(height, device=dev) + 0.5) * h / height - 0.5
        xs = (torch.arange(width, device=dev) + 0.5) * w / width - 0.5
    y0 = torch.clamp(torch.floor(ys), 0, h - 1).to(torch.int64)
    x0 = torch.clamp(torch.floor(xs), 0, w - 1).to(torch.int64)
    y1 = torch.clamp(y0 + 1, 0, h - 1)
    x1 = torch.clamp(x0 + 1, 0, w - 1)
    wy = torch.clamp(ys - y0, 0, 1)
    wx = torch.clamp(xs - x0, 0, 1)
    top = data[:, :, y0][:, :, :, x0] * (1 - wx) + \
        data[:, :, y0][:, :, :, x1] * wx
    bot = data[:, :, y1][:, :, :, x0] * (1 - wx) + \
        data[:, :, y1][:, :, :, x1] * wx
    return top * (1 - wy[:, None]) + bot * wy[:, None]


@_reg
def adaptive_avg_pooling2d(data, output_size=(1, 1)):
    """Ref: contrib/adaptive_avg_pooling.cc."""
    if isinstance(output_size, int):
        output_size = (output_size, output_size)
    oh, ow = output_size
    n, c, h, w = data.shape
    if h % oh == 0 and w % ow == 0:
        return data.reshape(n, c, oh, h // oh, ow, w // ow).mean(dim=(3, 5))
    ys = torch.linspace(0, h, oh + 1).tolist()
    xs = torch.linspace(0, w, ow + 1).tolist()
    rows = []
    for i in range(oh):
        y0, y1 = int(ys[i]), int(math.ceil(ys[i + 1]))
        cols = [data[:, :, y0:y1, int(xs[j]):int(math.ceil(xs[j + 1]))]
                .mean(dim=(2, 3)) for j in range(ow)]
        rows.append(torch.stack(cols, dim=-1))
    return torch.stack(rows, dim=-2)


def _bilinear_taps(img, gy, gx, h, w):
    """Bilinear samples of img (C, H, W) on the grid gy x gx, with the
    taps clamped to the image (roi_align's rule)."""
    y0 = torch.clamp(torch.floor(gy), 0, h - 1).to(torch.int64)
    x0 = torch.clamp(torch.floor(gx), 0, w - 1).to(torch.int64)
    y1 = torch.clamp(y0 + 1, 0, h - 1)
    x1 = torch.clamp(x0 + 1, 0, w - 1)
    wy = torch.clamp(gy - y0, 0, 1)
    wx = torch.clamp(gx - x0, 0, 1)
    top = img[:, y0][:, :, x0] * (1 - wx) + img[:, y0][:, :, x1] * wx
    bot = img[:, y1][:, :, x0] * (1 - wx) + img[:, y1][:, :, x1] * wx
    return top * (1 - wy[:, None]) + bot * wy[:, None]


@_reg
def roi_align(data, rois, pooled_size=(7, 7), spatial_scale=1.0,
              sample_ratio=-1, position_sensitive=False, aligned=False):
    """data NCHW; rois (R, 5) = [b, x1, y1, x2, y2] (ref:
    contrib/roi_align.cc)."""
    ph, pw = pooled_size
    n, c, h, w = data.shape
    offset = 0.5 if aligned else 0.0
    sr = sample_ratio if sample_ratio > 0 else 2
    floor = 1e-6 if aligned else 1.0
    outs = []
    for r in range(rois.shape[0]):
        roi = rois[r]
        x1, y1, x2, y2 = (roi[1:5] * spatial_scale - offset).unbind()
        rw = torch.clamp(x2 - x1, min=floor)
        rh = torch.clamp(y2 - y1, min=floor)
        bh, bw = rh / ph, rw / pw
        gy = y1 + (torch.arange(ph * sr, device=data.device) + 0.5) * bh / sr
        gx = x1 + (torch.arange(pw * sr, device=data.device) + 0.5) * bw / sr
        img = data[roi[0].to(torch.int64)]
        samples = _bilinear_taps(img, gy, gx, h, w)
        outs.append(samples.reshape(c, ph, sr, pw, sr).mean(dim=(2, 4)))
    return torch.stack(outs)


@_reg
def smooth_l1(data, scalar=1.0):
    """Ref: tensor/elemwise_unary_op_basic.cc smooth_l1."""
    s2 = scalar * scalar
    return torch.where(torch.abs(data) < 1.0 / s2,
                       0.5 * s2 * torch.square(data),
                       torch.abs(data) - 0.5 / s2)


@_reg
def arange_like(data, start=0.0, step=1.0, repeat=1, axis=None):
    """float32 ramps of data's size (or of one axis's length)."""
    n = data.numel() if axis is None else data.shape[axis]
    out = start + step * torch.arange(n, dtype=torch.float32,
                                      device=data.device)
    return out.reshape(data.shape) if axis is None else out


@_reg
def image_normalize(data, mean=(0, 0, 0), std=(1, 1, 1)):
    """(x - mean) / std per channel, CHW or NCHW (ref:
    image/image_random.cc Normalize)."""
    mean = torch.as_tensor(mean, dtype=data.dtype, device=data.device)
    std = torch.as_tensor(std, dtype=data.dtype, device=data.device)
    if data.dim() == 3:
        return (data - mean[:, None, None]) / std[:, None, None]
    return (data - mean[None, :, None, None]) / std[None, :, None, None]


@_reg
def image_to_tensor(data):
    """HWC (or NHWC) in [0, 255] to CHW (NCHW) float32 in [0, 1]."""
    perm = (2, 0, 1) if data.dim() == 3 else (0, 3, 1, 2)
    return data.permute(perm).to(torch.float32) / 255.0


def _resize_weights(m, n, device):
    """(m, n) weights of ``jax.image.resize``'s triangle kernel from m
    input to n output samples, antialiased when n < m."""
    inv_scale = m / n
    kernel_scale = max(inv_scale, 1.0)
    sample_f = (torch.arange(n, dtype=torch.float32, device=device) + 0.5) \
        * inv_scale - 0.5
    x = torch.abs(sample_f[None, :] - torch.arange(
        m, dtype=torch.float32, device=device)[:, None]) / kernel_scale
    wts = torch.clamp(1 - torch.abs(x), min=0)
    total = wts.sum(0, keepdim=True)
    wts = torch.where(torch.abs(total) > 1000. * 1.1920929e-07,
                      wts / torch.where(total != 0, total, 1), 0)
    inside = (sample_f >= -0.5) & (sample_f <= m - 0.5)
    return torch.where(inside[None, :], wts, 0)


def _resize_axis(x, axis, n, method):
    m = x.shape[axis]
    if m == n:
        return x
    if method == 'nearest':
        idx = torch.floor((torch.arange(n, dtype=torch.float32,
                                        device=x.device) + 0.5) * m / n)
        return x.index_select(axis, idx.to(torch.int64))
    wts = _resize_weights(m, n, x.device)
    return torch.tensordot(x, wts, dims=([axis], [0])).movedim(-1, axis)


@_reg
def image_resize(data, size=(224, 224), keep_ratio=False, interp=1):
    """HWC / NHWC resize to ``size`` = (w, h), nearest for ``interp=0``,
    else bilinear as ``jax.image.resize`` weighs it (ref:
    image/resize.cc)."""
    if isinstance(size, int):
        size = (size, size)
    w, h = size
    method = 'nearest' if interp == 0 else 'bilinear'
    x = data if method == 'nearest' else data.to(
        data.dtype if data.is_floating_point() else torch.float32)
    hax = data.dim() - 3
    x = _resize_axis(x, hax, h, method)
    return _resize_axis(x, hax + 1, w, method)


@_reg
def image_crop(data, x=0, y=0, width=1, height=1):
    if data.dim() == 3:
        return data[y:y + height, x:x + width, :]
    return data[:, y:y + height, x:x + width, :]


@_reg
def image_flip_left_right(data):
    return data.flip(-2)


@_reg
def image_flip_top_bottom(data):
    return data.flip(-3)


def _affine_grid(theta, th, tw):
    """(n, 2, th*tw) source coordinates of the target grid in [-1, 1]."""
    dev = theta.device
    ys = torch.linspace(-1, 1, th, device=dev)
    xs = torch.linspace(-1, 1, tw, device=dev)
    gy, gx = torch.meshgrid(ys, xs, indexing='ij')
    grid = torch.stack([gx.reshape(-1), gy.reshape(-1),
                        torch.ones(th * tw, device=dev)], dim=0)
    return torch.einsum('nij,jk->nik', theta, grid.to(theta.dtype))


@_reg
def spatial_transformer(data, loc, target_shape=None, transform_type='affine',
                        sampler_type='bilinear'):
    """Affine grid and bilinear sampling (ref:
    src/operator/spatial_transformer.cc)."""
    n, c, h, w = data.shape
    th, tw = target_shape if target_shape else (h, w)
    src = _affine_grid(loc.reshape(n, 2, 3), th, tw)
    sx = (src[:, 0] + 1) * (w - 1) / 2
    sy = (src[:, 1] + 1) * (h - 1) / 2
    outs = []
    for i in range(n):
        x0 = torch.clamp(torch.floor(sx[i]), 0, w - 1).to(torch.int64)
        y0 = torch.clamp(torch.floor(sy[i]), 0, h - 1).to(torch.int64)
        x1 = torch.clamp(x0 + 1, 0, w - 1)
        y1 = torch.clamp(y0 + 1, 0, h - 1)
        wx = torch.clamp(sx[i] - x0, 0, 1)
        wy = torch.clamp(sy[i] - y0, 0, 1)
        img = data[i]
        out = (img[:, y0, x0] * (1 - wx) * (1 - wy)
               + img[:, y0, x1] * wx * (1 - wy)
               + img[:, y1, x0] * (1 - wx) * wy + img[:, y1, x1] * wx * wy)
        outs.append(out.reshape(c, th, tw))
    return torch.stack(outs)


@_reg
def grid_generator(data, transform_type='affine', target_shape=None):
    n = data.shape[0]
    th, tw = target_shape
    return _affine_grid(data.reshape(n, 2, 3), th, tw).reshape(n, 2, th, tw)


@_reg
def bilinear_sampler(data, grid):
    """Sample data NCHW at grid (N, 2, H', W') in [-1, 1]; taps outside
    the image read 0 (ref: src/operator/bilinear_sampler.cc)."""
    n, c, h, w = data.shape
    sx = (grid[:, 0] + 1) * (w - 1) / 2
    sy = (grid[:, 1] + 1) * (h - 1) / 2
    outs = []
    for i in range(n):
        x0 = torch.floor(sx[i]).to(torch.int64)
        y0 = torch.floor(sy[i]).to(torch.int64)
        x1, y1 = x0 + 1, y0 + 1
        wx = sx[i] - x0
        wy = sy[i] - y0
        img = data[i]

        def at(yy, xx):
            valid = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
            return img[:, yy.clamp(0, h - 1), xx.clamp(0, w - 1)] * valid

        outs.append(at(y0, x0) * (1 - wx) * (1 - wy)
                    + at(y0, x1) * wx * (1 - wy)
                    + at(y1, x0) * (1 - wx) * wy + at(y1, x1) * wx * wy)
    return torch.stack(outs)
