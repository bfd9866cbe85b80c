"""The box ops that detection needs (counterpart of part of
``mxnet_tpu/ops/contrib.py``; ref: src/operator/contrib/bounding_box.cc,
multibox_prior.cc): ``box_iou``, ``box_nms`` and ``multibox_prior``,
plain PyTorch as the JAX package leaves them to XLA. The rest of the JAX
module (resizing, ROI align, adaptive pooling and the long tail) waits
for ROADMAP queue 1 item 16.

``box_nms`` keeps the JAX op's result but not its cost. The JAX op builds
the (B, N, N) IoU matrix of the score-sorted boxes and sweeps all N rows;
only the first ``topk`` rows can suppress anything, so the port builds
(B, keep_n, N) and sweeps ``keep_n`` rows (keep_n = min(topk, N), or N
when topk <= 0). At SSD-512's 24572 anchors and topk 400 that is 39 MB a
batch row instead of 2.4 GB. The sort is stable, as ``jnp.argsort`` is:
every invalid score ties at -inf.
"""
from __future__ import annotations

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
