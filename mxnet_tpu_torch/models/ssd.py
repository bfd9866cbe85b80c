"""SSD, the single-shot detector: the SSD-512 verification config
(counterpart of ``mxnet_tpu/models/ssd.py``; ref:
example/ssd/symbol/symbol_builder.py and the multibox ops,
src/operator/contrib/multibox_{prior,target,detection}.cc).

The backbone, stages and heads keep the JAX package's prefixes
(``backbone_``, ``stages_``, ``cls_``, ``loc_``) and structured names, so
weights carry across. The anchors are a constant for a given input size:
each forward reads them from a cache keyed by the feature maps' sizes and
the device, built by ``multibox_prior`` on the first forward at that
size. Training labels are a fixed (B, M, 5) padded tensor.
"""
from __future__ import annotations

import torch

from ..gluon import nn
from ..gluon.block import HybridBlock
from .. import ndarray as nd
from ..ndarray.ndarray import _invoke
from ..ops.contrib import multibox_prior
from ..ops.detection import multibox_detection, multibox_target

__all__ = ['SSD', 'ssd_512', 'ssd_300', 'ssd_train_loss']


def _feature_block(channels, repeats, pool=True):
    blk = nn.HybridSequential()
    for _ in range(repeats):
        blk.add(nn.Conv2D(channels, 3, padding=1))
        blk.add(nn.BatchNorm())
        blk.add(nn.Activation('relu'))
    if pool:
        blk.add(nn.MaxPool2D(2, strides=2))
    return blk


def _down_block(channels):
    """Extra feature layer: 1x1 squeeze, then 3x3 stride 2 (SSD's
    extras)."""
    blk = nn.HybridSequential()
    blk.add(nn.Conv2D(channels // 2, 1))
    blk.add(nn.BatchNorm())
    blk.add(nn.Activation('relu'))
    blk.add(nn.Conv2D(channels, 3, strides=2, padding=1))
    blk.add(nn.BatchNorm())
    blk.add(nn.Activation('relu'))
    return blk


# per-scale anchor sizes and ratios of the 512 config (ref:
# example/ssd/symbol/legacy_vgg16_ssd_512.py get_symbol)
_SSD512_SIZES = [(.07, .1025), (.15, .2121), (.3, .3674), (.45, .5196),
                 (.6, .6708), (.75, .8216), (.9, .9721)]
_SSD512_RATIOS = [[1, 2, .5]] + [[1, 2, .5, 3, 1. / 3]] * 5 + [[1, 2, .5]]


class SSD(HybridBlock):
    """Backbone and multi-scale heads. ``num_classes`` excludes the
    background (VOC: 20); the class predictions carry num_classes + 1
    channels. The backbone is the JAX package's compact VGG-style stack;
    the scales halve the feature map down to 1 x 1 as the reference's 512
    config does."""

    def __init__(self, num_classes=20, image_size=512, sizes=None,
                 ratios=None, **kwargs):
        super().__init__(**kwargs)
        self.num_classes = num_classes
        self.image_size = image_size
        self._sizes = sizes or _SSD512_SIZES
        self._ratios = ratios or _SSD512_RATIOS
        self._anchors = {}
        n_scales = len(self._sizes)
        with self.name_scope():
            self.features = nn.HybridSequential(prefix='backbone_')
            with self.features.name_scope():
                self.features.add(_feature_block(32, 1))
                self.features.add(_feature_block(64, 1))
                self.features.add(_feature_block(128, 2))
            self.stages = nn.HybridSequential(prefix='stages_')
            self.cls_heads = nn.HybridSequential(prefix='cls_')
            self.loc_heads = nn.HybridSequential(prefix='loc_')
            with self.stages.name_scope():
                self.stages.add(_feature_block(256, 2, pool=False))
                for _ in range(n_scales - 1):
                    self.stages.add(_down_block(256))
            for i in range(n_scales):
                n_anchor = len(self._sizes[i]) + len(self._ratios[i]) - 1
                with self.cls_heads.name_scope():
                    self.cls_heads.add(nn.Conv2D(
                        n_anchor * (num_classes + 1), 3, padding=1))
                with self.loc_heads.name_scope():
                    self.loc_heads.add(nn.Conv2D(n_anchor * 4, 3, padding=1))

    def forward(self, x):
        """x: (B, 3, S, S) -> (anchors (1, A, 4) corner, cls_preds
        (B, num_classes + 1, A), loc_preds (B, A*4))."""
        x = self.features(x)
        B = x.shape[0]
        C1 = self.num_classes + 1
        maps, cls_preds, loc_preds = [], [], []
        for i, stage in enumerate(self.stages):
            x = stage(x)
            maps.append(x)
            # (B, a*C1, h, w) -> (B, h*w*a, C1)
            cls_preds.append(self.cls_heads[i](x).permute(0, 2, 3, 1)
                             .reshape(B, -1, C1))
            loc_preds.append(self.loc_heads[i](x).permute(0, 2, 3, 1)
                             .reshape(B, -1))
        return (self._anchor(maps),
                torch.cat(cls_preds, dim=1).permute(0, 2, 1),
                torch.cat(loc_preds, dim=1))

    def _anchor(self, maps):
        key = (tuple(tuple(m.shape[2:]) for m in maps), maps[0].device)
        anchor = self._anchors.get(key)
        if anchor is None:
            anchor = self._anchors[key] = torch.cat([
                multibox_prior(m, sizes=tuple(self._sizes[i]),
                               ratios=tuple(self._ratios[i]))
                for i, m in enumerate(maps)], dim=1)
        return anchor

    def detect(self, x, nms_threshold=0.45, threshold=0.01, nms_topk=400):
        """Decoded detections (B, A, 6) [cls, score, x0, y0, x1, y1]."""
        anchor, cls_pred, loc_pred = self(x)
        prob = nd.softmax(cls_pred, axis=1)
        return _invoke(multibox_detection, prob, loc_pred, anchor,
                       nms_threshold=nms_threshold, threshold=threshold,
                       nms_topk=nms_topk)


def ssd_512(num_classes=20, **kwargs):
    """SSD-512 (BASELINE.json's verification config)."""
    return SSD(num_classes=num_classes, image_size=512, **kwargs)


def ssd_300(num_classes=20, **kwargs):
    """A 300-input variant: the 512 head layout less one scale."""
    return SSD(num_classes=num_classes, image_size=300,
               sizes=_SSD512_SIZES[:6], ratios=_SSD512_RATIOS[:6], **kwargs)


def _loss_of_targets(cls_pred, loc_pred, box_t, box_m, cls_t):
    """The MultiBox loss of predictions against ``multibox_target``'s
    outputs."""
    logp = torch.log_softmax(cls_pred.permute(0, 2, 1), dim=-1)
    keep = cls_t >= 0
    safe = torch.where(keep, cls_t, 0.0).to(torch.int64)
    cls_loss = -logp.gather(-1, safe[..., None])[..., 0] * keep
    diff = ((loc_pred - box_t) * box_m).abs()
    loc_loss = torch.where(diff < 1.0, 0.5 * diff * diff, diff - 0.5)
    n_pos = box_m.sum() / 4.0 + 1e-6
    return (cls_loss.sum() + loc_loss.sum()) / n_pos


def _multibox_loss(anchor, cls_pred, loc_pred, label, negative_mining_ratio):
    targets = multibox_target(anchor, label, cls_pred,
                              negative_mining_ratio=negative_mining_ratio)
    return _loss_of_targets(cls_pred, loc_pred, *targets)


def ssd_train_loss(anchor, cls_pred, loc_pred, label,
                   negative_mining_ratio=3.0):
    """MultiBox training loss: cross entropy over the mined classes plus
    smooth L1 on the positive boxes, over the number of positives (ref:
    example/ssd/train/metric.py and multibox_target.cc). label: (B, M, 5)
    rows [cls x0 y0 x1 y1], -1-padded. NDArrays or tensors."""
    return _invoke(_multibox_loss, anchor, cls_pred, loc_pred, label,
                   negative_mining_ratio)
