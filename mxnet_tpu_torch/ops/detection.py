"""Detection ops: the SSD training and inference heads and the R-CNN
family's ops (counterpart of ``mxnet_tpu/ops/detection.py``; ref:
src/operator/contrib/multibox_target.cc, multibox_detection.cc,
proposal.cc, psroi_pooling.cc, deformable_convolution.cc, correlation.cc,
bounding_box.cc), plain PyTorch as the JAX package leaves them to XLA.

The JAX ops ``vmap`` over the batch; these batch over it with the same
arithmetic. Where the JAX op meets a tie or a duplicate, the winner is
made explicit so the card gives what the CPU gives:

- ``multibox_target``'s force match: when two ground-truth boxes share
  their best anchor, the anchor takes the higher gt index, as the JAX
  scatter on the CPU gives (a ``scatter_reduce('amax')``; ``index_put_``
  with duplicate indices is not deterministic on the card);
- the hard-negative rank is a stable sort; ``argmax`` ties take the first
  index in both packages;
- ``proposal``'s top-k is a stable sort by score, ties in index order.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..base import register_op
from .contrib import _iou_corner, box_nms

__all__ = []


def _reg(fn):
    register_op(fn.__name__)(fn)
    __all__.append(fn.__name__)
    return fn


def _center(box):
    """corner (x0, y0, x1, y1) -> center (cx, cy, w, h)."""
    wh = box[..., 2:4] - box[..., 0:2]
    return torch.cat([box[..., 0:2] + 0.5 * wh, wh], dim=-1)


def _corner(box):
    half = 0.5 * box[..., 2:4]
    return torch.cat([box[..., 0:2] - half, box[..., 0:2] + half], dim=-1)


@_reg
def box_encode(samples, matches, anchors, refs, means=(0., 0., 0., 0.),
               stds=(0.1, 0.1, 0.2, 0.2)):
    """Regression targets of the matched boxes (ref: bounding_box.cc
    BoxEncode). samples: (B, A), 1 for a positive; matches: (B, A) gt
    index; anchors: (B or 1, A, 4) corner; refs: (B, M, 4) corner.
    Returns (targets (B, A, 4), masks (B, A, 4))."""
    means = torch.tensor(means, dtype=anchors.dtype, device=anchors.device)
    stds = torch.tensor(stds, dtype=anchors.dtype, device=anchors.device)
    idx = matches.to(torch.int64).clamp_min(0)
    g = refs.gather(1, idx[..., None].expand(idx.shape + (4,)))
    a_c, g_c = _center(anchors), _center(g)
    eps = 1e-8
    t_xy = (g_c[..., :2] - a_c[..., :2]) / a_c[..., 2:4].clamp_min(eps)
    t_wh = torch.log(g_c[..., 2:4].clamp_min(eps) /
                     a_c[..., 2:4].clamp_min(eps))
    targets = (torch.cat([t_xy, t_wh], dim=-1) - means) / stds
    masks = (samples > 0.5)[..., None].expand(targets.shape)
    return torch.where(masks, targets, 0.0), masks.to(targets.dtype)


@_reg
def box_decode(data, anchors, std0=0.1, std1=0.1, std2=0.2, std3=0.2,
               clip=-1.0, format='corner'):
    """Boxes from regression deltas against anchors (ref:
    bounding_box.cc BoxDecode), corner boxes out, clipped to [0, clip]
    when clip > 0."""
    stds = torch.tensor([std0, std1, std2, std3], dtype=data.dtype,
                        device=data.device)
    a = _center(anchors) if format == 'corner' else anchors
    d = data * stds
    xy = d[..., :2] * a[..., 2:4] + a[..., :2]
    wh = torch.exp(d[..., 2:4]) * a[..., 2:4]
    out = _corner(torch.cat([xy, wh], dim=-1))
    return out.clamp(0.0, clip) if clip > 0 else out


@_reg
def multibox_target(anchor, label, cls_pred, overlap_threshold=0.5,
                    ignore_label=-1.0, negative_mining_ratio=-1.0,
                    negative_mining_thresh=0.5, minimum_negative_samples=0,
                    variances=(0.1, 0.1, 0.2, 0.2)):
    """SSD training targets (ref: multibox_target.cc). anchor: (1, A, 4)
    corner; label: (B, M, 5) rows [cls x0 y0 x1 y1], -1-padded; cls_pred:
    (B, num_cls + 1, A), read only for hard-negative mining. Returns
    (box_target (B, A*4), box_mask (B, A*4), cls_target (B, A)).

    Each valid gt's best anchor is matched to it (on a shared best anchor
    the higher gt index wins); every other anchor takes its best gt at IoU
    >= ``overlap_threshold``. With ``negative_mining_ratio`` > 0 the
    unmatched anchors under ``negative_mining_thresh`` with the lowest
    background log-probability, ratio times the positives (at least
    ``minimum_negative_samples``), are class 0 and the rest
    ``ignore_label``."""
    A = anchor.shape[1]
    B, M = label.shape[:2]
    anc = anchor.reshape(A, 4)
    dev = anchor.device
    valid = label[..., 0] >= 0                             # (B, M)
    gt = label[..., 1:5]
    ious = _iou_corner(anc[None], gt)                      # (B, A, M)
    ious = torch.where(valid[:, None, :], ious, -1.0)
    best_anchor = ious.argmax(dim=1)                       # (B, M)
    slot = torch.where(valid, best_anchor, A)
    forced = torch.full((B, A + 1), -1, dtype=torch.int64, device=dev)
    forced.scatter_reduce_(1, slot, torch.arange(M, device=dev).expand(B, M),
                           reduce='amax')
    forced = forced[:, :A]
    best_gt = ious.argmax(dim=2)                           # (B, A)
    best_iou = ious.gather(2, best_gt[..., None])[..., 0]
    matched = torch.where(forced >= 0, forced,
                          torch.where(best_iou >= overlap_threshold,
                                      best_gt, -1))
    pos = matched >= 0
    cls_target = torch.where(
        pos, label[..., 0].gather(1, matched.clamp_min(0)) + 1.0, 0.0)
    if negative_mining_ratio > 0:
        with torch.no_grad():
            bg_score = torch.log_softmax(cls_pred.detach(), dim=1)[:, 0]
            neg_cand = ~pos & (best_iou < negative_mining_thresh)
            n_neg = (pos.sum(1).to(torch.float32) * negative_mining_ratio
                     ).to(torch.int64).clamp_min(minimum_negative_samples)
            order = torch.argsort(
                torch.where(neg_cand, bg_score, float('inf')), dim=1,
                stable=True)
            rank = torch.empty_like(order).scatter_(
                1, order, torch.arange(A, device=dev).expand(B, A))
            keep_neg = neg_cand & (rank < n_neg[:, None])
        cls_target = torch.where(pos, cls_target,
                                 torch.where(keep_neg, 0.0, ignore_label))
    targets, masks = box_encode(pos.to(anchor.dtype), matched, anc[None], gt,
                                (0., 0., 0., 0.), tuple(variances))
    return targets.reshape(B, -1), masks.reshape(B, -1), cls_target


@_reg
def multibox_detection(cls_prob, loc_pred, anchor, clip=True, threshold=0.01,
                       background_id=0, nms_threshold=0.5,
                       force_suppress=False, variances=(0.1, 0.1, 0.2, 0.2),
                       nms_topk=-1):
    """SSD inference: decode, confidence filter and NMS (ref:
    multibox_detection.cc). cls_prob: (B, num_cls + 1, A), loc_pred:
    (B, A*4), anchor: (1, A, 4). Returns (B, A, 6) rows [cls_id, score,
    x0, y0, x1, y1], score-sorted, id -1 where suppressed or invalid."""
    B, _, A = cls_prob.shape
    boxes = box_decode(loc_pred.reshape(B, A, 4), anchor.reshape(A, 4)[None],
                       *[float(v) for v in variances],
                       clip=1.0 if clip else -1.0)
    scores = cls_prob.movedim(1, 2).clone()                # (B, A, C+1)
    scores[..., background_id] = -1.0
    score, cls_id = scores.max(dim=-1)
    cls_id = cls_id.to(loc_pred.dtype)
    keep = score > threshold
    cls_out = torch.where(keep, cls_id - (cls_id > background_id).to(
        cls_id.dtype), -1.0)
    score = torch.where(keep, score, -1.0)
    det = torch.cat([cls_out[..., None], score[..., None], boxes], dim=-1)
    out = box_nms(det, overlap_thresh=nms_threshold, valid_thresh=0.0,
                  topk=nms_topk, coord_start=2, score_index=1, id_index=0,
                  force_suppress=force_suppress)
    ids = torch.where(out[..., 1] < 0, -1.0, out[..., 0])
    return torch.cat([ids[..., None], out[..., 1:]], dim=-1)


@_reg
def proposal(cls_prob, bbox_pred, im_info, rpn_pre_nms_top_n=6000,
             rpn_post_nms_top_n=300, threshold=0.7, rpn_min_size=16,
             scales=(4, 8, 16, 32), ratios=(0.5, 1, 2), feature_stride=16):
    """RPN proposals (ref: proposal.cc). cls_prob: (B, 2K, H, W),
    bbox_pred: (B, 4K, H, W), im_info: (B, 3) [height, width, scale].
    Returns (B, rpn_post_nms_top_n, 5) [batch index, x0, y0, x1, y1]."""
    B, _, H, W = cls_prob.shape
    K = len(scales) * len(ratios)
    dt, dev = cls_prob.dtype, cls_prob.device
    base = float(feature_stride)
    anchors = []
    for r in ratios:
        for s in scales:
            w = torch.sqrt(torch.tensor(base * base / r, dtype=dt,
                                        device=dev)) * s
            h = w * r
            anchors.append(torch.stack([(base - w) / 2, (base - h) / 2,
                                        (base + w) / 2, (base + h) / 2]))
    base_anchors = torch.stack(anchors)                    # (K, 4)
    sy, sx = torch.meshgrid(torch.arange(H, device=dev) * feature_stride,
                            torch.arange(W, device=dev) * feature_stride,
                            indexing='ij')
    shifts = torch.stack([sx.reshape(-1), sy.reshape(-1), sx.reshape(-1),
                          sy.reshape(-1)], dim=1).to(dt)
    all_anchors = (base_anchors[None] + shifts[:, None]).reshape(-1, 4)
    widths = all_anchors[:, 2] - all_anchors[:, 0] + 1.0
    heights = all_anchors[:, 3] - all_anchors[:, 1] + 1.0
    ctr_x = all_anchors[:, 0] + 0.5 * (widths - 1)
    ctr_y = all_anchors[:, 1] + 0.5 * (heights - 1)
    rois = []
    for b in range(B):
        info = im_info[b]
        fg = cls_prob[b, K:].reshape(K, -1).t().reshape(-1)
        d = bbox_pred[b].reshape(K, 4, -1).permute(2, 0, 1).reshape(-1, 4)
        px = d[:, 0] * widths + ctr_x
        py = d[:, 1] * heights + ctr_y
        pw = torch.exp(d[:, 2].clamp(-10, 10)) * widths
        ph = torch.exp(d[:, 3].clamp(-10, 10)) * heights
        boxes = torch.stack([
            (px - 0.5 * (pw - 1)).clamp(torch.zeros_like(info[1]),
                                        info[1] - 1),
            (py - 0.5 * (ph - 1)).clamp(torch.zeros_like(info[0]),
                                        info[0] - 1),
            (px + 0.5 * (pw - 1)).clamp(torch.zeros_like(info[1]),
                                        info[1] - 1),
            (py + 0.5 * (ph - 1)).clamp(torch.zeros_like(info[0]),
                                        info[0] - 1)], dim=1)
        ws = boxes[:, 2] - boxes[:, 0] + 1
        hs = boxes[:, 3] - boxes[:, 1] + 1
        min_size = rpn_min_size * info[2]
        fg = torch.where((ws >= min_size) & (hs >= min_size), fg, -1.0)
        n_pre = min(rpn_pre_nms_top_n, fg.shape[0])
        top_idx = torch.argsort(-fg, stable=True)[:n_pre]
        det = torch.cat([torch.zeros((n_pre, 1), dtype=dt, device=dev),
                         fg[top_idx, None], boxes[top_idx]], dim=1)
        kept = box_nms(det[None], overlap_thresh=threshold, valid_thresh=0.0,
                       topk=-1, coord_start=2, score_index=1,
                       id_index=0)[0][:rpn_post_nms_top_n]
        pad = rpn_post_nms_top_n - kept.shape[0]
        out = F.pad(kept[:, 2:6], (0, 0, 0, max(pad, 0)))
        mask = F.pad(kept[:, 1] >= 0, (0, max(pad, 0)))
        rois.append(torch.where(mask[:, None], out, 0.0))
    rois = torch.stack(rois)
    bidx = torch.arange(B, dtype=dt, device=dev)[:, None, None].expand(
        B, rois.shape[1], 1)
    return torch.cat([bidx, rois], dim=-1)


@_reg
def psroi_pooling(data, rois, spatial_scale, output_dim, pooled_size,
                  group_size=0):
    """Position-sensitive ROI pooling, the R-FCN head (ref:
    psroi_pooling.cc): each bin averages a fixed 2 x 2 grid of samples.
    data: (B, output_dim * group^2, H, W), rois: (R, 5) [b x0 y0 x1 y1].
    Returns (R, output_dim, pooled, pooled)."""
    if group_size == 0:
        group_size = pooled_size
    _, _, H, W = data.shape
    P, G = pooled_size, group_size
    dev = data.device
    py, px = torch.meshgrid(torch.arange(P, device=dev),
                            torch.arange(P, device=dev), indexing='ij')
    cidx = (torch.arange(output_dim, device=dev)[:, None, None] * G * G +
            ((py * G) // P)[None] * G + ((px * G) // P)[None])
    outs = []
    for roi in rois:
        img = data[int(roi[0])]
        x0, y0 = roi[1] * spatial_scale, roi[2] * spatial_scale
        x1, y1 = roi[3] * spatial_scale, roi[4] * spatial_scale
        bin_w = (x1 - x0).clamp_min(0.1) / P
        bin_h = (y1 - y0).clamp_min(0.1) / P
        out = torch.zeros((output_dim, P, P), dtype=data.dtype, device=dev)
        for oy, ox in ((0.25, 0.25), (0.25, 0.75), (0.75, 0.25),
                       (0.75, 0.75)):
            sy = (y0 + (py + oy) * bin_h).clamp(0, H - 1)
            sx = (x0 + (px + ox) * bin_w).clamp(0, W - 1)
            iy = sy.to(torch.int64)[None].expand_as(cidx)
            ix = sx.to(torch.int64)[None].expand_as(cidx)
            out = out + img[cidx, iy, ix]
        outs.append(out / 4)
    return torch.stack(outs)


@_reg
def deformable_convolution(data, offset, weight, bias=None, kernel=(3, 3),
                           stride=(1, 1), pad=(1, 1), dilate=(1, 1),
                           num_filter=None, num_deformable_group=1,
                           num_group=1, no_bias=False):
    """Deformable convolution v1 (ref: deformable_convolution.cc):
    offset-shifted bilinear samples (zero outside the image) gathered
    into columns, then one product per group. data: (B, C, H, W); offset:
    (B, 2*KH*KW*dg, OH, OW) laid out [dg, KH, KW, (y, x)]; weight:
    (F, C/num_group, KH, KW)."""
    B, C, H, W = data.shape
    KH, KW = kernel
    Fo = weight.shape[0]
    OH = (H + 2 * pad[0] - (dilate[0] * (KH - 1) + 1)) // stride[0] + 1
    OW = (W + 2 * pad[1] - (dilate[1] * (KW - 1) + 1)) // stride[1] + 1
    dg = num_deformable_group
    Cg = C // dg
    dev, dt = data.device, data.dtype
    oy, ox = torch.meshgrid(torch.arange(OH, device=dev),
                            torch.arange(OW, device=dev), indexing='ij')
    ky, kx = torch.meshgrid(torch.arange(KH, device=dev),
                            torch.arange(KW, device=dev), indexing='ij')
    base_y = (oy[None, None] * stride[0] - pad[0] +
              ky[:, :, None, None] * dilate[0]).to(dt)
    base_x = (ox[None, None] * stride[1] - pad[1] +
              kx[:, :, None, None] * dilate[1]).to(dt)
    outs = []
    for img, off in zip(data, offset):
        off = off.reshape(dg, KH, KW, 2, OH, OW)
        cols = []
        for g in range(dg):
            sy = base_y + off[g, :, :, 0]
            sx = base_x + off[g, :, :, 1]
            y0, x0 = torch.floor(sy), torch.floor(sx)
            wy, wx = sy - y0, sx - x0
            piece = 0
            for dy, wyy in ((0, 1 - wy), (1, wy)):
                for dx, wxx in ((0, 1 - wx), (1, wx)):
                    yf, xf = y0 + dy, x0 + dx
                    inb = ((yf >= 0) & (yf <= H - 1) & (xf >= 0) &
                           (xf <= W - 1))
                    yy = yf.clamp(0, H - 1).to(torch.int64)
                    xx = xf.clamp(0, W - 1).to(torch.int64)
                    v = img[g * Cg:(g + 1) * Cg][:, yy, xx]
                    piece = piece + v * (wyy * wxx * inb)[None]
            cols.append(piece)
        col = torch.cat(cols, 0)                           # (C,KH,KW,OH,OW)
        Cpg, Fpg = C // num_group, Fo // num_group
        outs.append(torch.cat([
            (weight[gi * Fpg:(gi + 1) * Fpg].reshape(Fpg, -1) @
             col[gi * Cpg:(gi + 1) * Cpg].reshape(Cpg * KH * KW, OH * OW)
             ).reshape(Fpg, OH, OW) for gi in range(num_group)], 0))
    out = torch.stack(outs)
    if bias is not None and not no_bias:
        out = out + bias[None, :, None, None]
    return out


@_reg
def correlation(data1, data2, kernel_size=1, max_displacement=1, stride1=1,
                stride2=1, pad_size=0, is_multiply=True):
    """FlowNet's correlation cost volume (ref: correlation.cc): (B, D*D,
    OH, OW), D = 2 * (max_displacement // stride2) + 1, each map the
    channel mean of the product (or -|difference|) at one displacement,
    averaged over a kernel_size patch."""
    B, C, H, W = data1.shape
    p, md, K = pad_size, max_displacement, kernel_size
    d1 = F.pad(data1, (p, p, p, p))
    d2 = F.pad(data2, (p, p, p, p))
    n_disp = md // stride2
    disps = [i * stride2 for i in range(-n_disp, n_disp + 1)]
    Hp, Wp = H + 2 * p, W + 2 * p
    OH = (Hp - K - 2 * md) // stride1 + 1
    OW = (Wp - K - 2 * md) // stride1 + 1
    hh, ww = Hp - 2 * md, Wp - 2 * md
    box = torch.ones((1, 1, K, K), dtype=data1.dtype,
                     device=data1.device) / (K * K)
    a = d1[:, :, md:md + hh, md:md + ww]
    maps = []
    for dy in disps:
        for dx in disps:
            b = d2[:, :, md + dy:md + dy + hh, md + dx:md + dx + ww]
            m = (a * b).mean(1, keepdim=True) if is_multiply else \
                -(a - b).abs().mean(1, keepdim=True)
            if K > 1:
                m = F.conv2d(m, box)
            maps.append(m[:, 0, ::stride1, ::stride1][:, :OH, :OW])
    return torch.stack(maps, dim=1)
