"""Losses (counterpart of ``mxnet_tpu/gluon/loss.py``, ref:
python/mxnet/gluon/loss.py), each a HybridBlock whose forward takes
``(pred, label[, sample_weight])`` and returns one value per sample (the
mean over every axis but ``batch_axis``); ``CTCLoss`` returns one loss
per sequence."""
from __future__ import annotations

import math

import torch

from .block import HybridBlock

__all__ = ['Loss', 'L2Loss', 'L1Loss', 'SigmoidBinaryCrossEntropyLoss',
           'SigmoidBCELoss', 'SoftmaxCrossEntropyLoss', 'SoftmaxCELoss',
           'KLDivLoss', 'CTCLoss', 'HuberLoss', 'HingeLoss',
           'SquaredHingeLoss', 'LogisticLoss', 'TripletLoss',
           'PoissonNLLLoss', 'CosineEmbeddingLoss']


def _apply_weighting(loss, weight=None, sample_weight=None):
    if sample_weight is not None:
        loss = loss * sample_weight
    if weight is not None:
        loss = loss * weight
    return loss


def _batch_mean(loss, batch_axis):
    axes = [a for a in range(loss.dim()) if a != batch_axis % loss.dim()]
    return loss.mean(dim=axes) if axes else loss


def _softplus_neg_abs(pred):
    return torch.log(1 + torch.exp(-pred.abs()))


class Loss(HybridBlock):
    """Base loss (ref: loss.py Loss)."""

    def __init__(self, weight, batch_axis, **kwargs):
        super().__init__(**kwargs)
        self._weight = weight
        self._batch_axis = batch_axis

    def __repr__(self):
        return (f"{type(self).__name__}(batch_axis={self._batch_axis}, "
                f"w={self._weight})")


class L2Loss(Loss):
    """weight/2 * (label - pred)^2."""

    def __init__(self, weight=1., batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        loss = (label.reshape(pred.shape) - pred) ** 2
        loss = _apply_weighting(loss, self._weight / 2, sample_weight)
        return _batch_mean(loss, self._batch_axis)


class L1Loss(Loss):
    def __init__(self, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        loss = (label.reshape(pred.shape) - pred).abs()
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return _batch_mean(loss, self._batch_axis)


class SigmoidBinaryCrossEntropyLoss(Loss):
    """Binary cross entropy of sigmoid(pred) (or of pred, from_sigmoid),
    ``pos_weight`` scaling the positive term."""

    def __init__(self, from_sigmoid=False, weight=None, batch_axis=0,
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._from_sigmoid = from_sigmoid

    def hybrid_forward(self, F, pred, label, sample_weight=None,
                       pos_weight=None):
        label = label.reshape(pred.shape)
        if not self._from_sigmoid:
            if pos_weight is None:
                loss = torch.relu(pred) - pred * label + \
                    _softplus_neg_abs(pred)
            else:
                log_weight = 1 + (pos_weight - 1) * label
                loss = pred - pred * label + log_weight * (
                    _softplus_neg_abs(pred) + torch.relu(-pred))
        else:
            eps = 1e-12
            pos = torch.log(pred + eps) * label
            if pos_weight is not None:
                pos = pos * pos_weight
            loss = -(pos + torch.log(1. - pred + eps) * (1. - label))
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return _batch_mean(loss, self._batch_axis)


SigmoidBCELoss = SigmoidBinaryCrossEntropyLoss


class SoftmaxCrossEntropyLoss(Loss):
    """-log softmax(pred)[label] (sparse_label) or -sum(label * log
    softmax(pred)) (ref: loss.py SoftmaxCrossEntropyLoss)."""

    def __init__(self, axis=-1, sparse_label=True, from_logits=False,
                 weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._axis = axis
        self._sparse_label = sparse_label
        self._from_logits = from_logits

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        if not self._from_logits:
            pred = torch.log_softmax(pred, dim=self._axis)
        if self._sparse_label:
            loss = -F.pick(pred, label, axis=self._axis, keepdims=True)
        else:
            loss = -(pred * label.reshape(pred.shape)).sum(
                dim=self._axis, keepdim=True)
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return _batch_mean(loss, self._batch_axis)


SoftmaxCELoss = SoftmaxCrossEntropyLoss


class KLDivLoss(Loss):
    def __init__(self, from_logits=True, axis=-1, weight=None, batch_axis=0,
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._from_logits = from_logits
        self._axis = axis

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        if not self._from_logits:
            pred = torch.log_softmax(pred, dim=self._axis)
        loss = label * (torch.log(label + 1e-12) - pred)
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return _batch_mean(loss, self._batch_axis)


class CTCLoss(Loss):
    """Connectionist temporal classification loss over the ``ctc_loss``
    op, blank the last class, labels padded with -1 (ref: loss.py
    CTCLoss). ``layout`` 'NTC' or 'TNC' for ``pred``, ``label_layout`` 'NT'
    or 'TN'; ``pred_lengths`` and ``label_lengths`` optional. One loss per
    sequence, not averaged."""

    def __init__(self, layout='NTC', label_layout='NT', weight=None,
                 **kwargs):
        assert layout in ('NTC', 'TNC')
        assert label_layout in ('NT', 'TN')
        self._layout = layout
        self._label_layout = label_layout
        super().__init__(weight, label_layout.find('N'), **kwargs)

    def hybrid_forward(self, F, pred, label, pred_lengths=None,
                       label_lengths=None, sample_weight=None):
        if self._layout == 'NTC':
            pred = pred.swapaxes(0, 1)
        if self._batch_axis == 1:
            label = label.swapaxes(0, 1)
        loss = F.ctc_loss(pred, label, pred_lengths, label_lengths,
                          use_data_lengths=pred_lengths is not None,
                          use_label_lengths=label_lengths is not None,
                          blank_label='last')
        return _apply_weighting(loss, self._weight, sample_weight)


class HuberLoss(Loss):
    def __init__(self, rho=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._rho = rho

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        loss = (label.reshape(pred.shape) - pred).abs()
        loss = torch.where(loss > self._rho, loss - 0.5 * self._rho,
                           (0.5 / self._rho) * loss ** 2)
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return _batch_mean(loss, self._batch_axis)


class HingeLoss(Loss):
    def __init__(self, margin=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        loss = torch.relu(self._margin - pred * label.reshape(pred.shape))
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return _batch_mean(loss, self._batch_axis)


class SquaredHingeLoss(Loss):
    def __init__(self, margin=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        loss = torch.relu(self._margin - pred * label.reshape(pred.shape)) \
            ** 2
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return _batch_mean(loss, self._batch_axis)


class LogisticLoss(Loss):
    def __init__(self, weight=None, batch_axis=0, label_format='signed',
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._label_format = label_format

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        label = label.reshape(pred.shape)
        if self._label_format == 'signed':
            label = (label + 1.0) / 2.0
        loss = torch.relu(pred) - pred * label + _softplus_neg_abs(pred)
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return _batch_mean(loss, self._batch_axis)


class TripletLoss(Loss):
    def __init__(self, margin=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def hybrid_forward(self, F, pred, positive, negative, sample_weight=None):
        positive = positive.reshape(pred.shape)
        negative = negative.reshape(pred.shape)
        diff = (positive - pred) ** 2 - (negative - pred) ** 2
        axes = [a for a in range(diff.dim())
                if a != self._batch_axis % diff.dim()]
        loss = torch.relu(diff.sum(dim=axes) + self._margin)
        return _apply_weighting(loss, self._weight, sample_weight)


class PoissonNLLLoss(Loss):
    def __init__(self, weight=None, from_logits=True, batch_axis=0,
                 compute_full=False, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._from_logits = from_logits
        self._compute_full = compute_full

    def hybrid_forward(self, F, pred, target, sample_weight=None,
                       epsilon=1e-08):
        target = target.reshape(pred.shape)
        if self._from_logits:
            loss = torch.exp(pred) - target * pred
        else:
            loss = pred - target * torch.log(pred + epsilon)
        if self._compute_full:
            stirling = (target * torch.log(target + 1e-12) - target
                        + 0.5 * torch.log(2 * math.pi * (target + 1e-12)))
            loss = loss + stirling * (target > 1)
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return loss.mean()


class CosineEmbeddingLoss(Loss):
    """1 - cos(x1, x2) for label 1, max(0, cos - margin) otherwise."""

    def __init__(self, weight=None, batch_axis=0, margin=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def hybrid_forward(self, F, input1, input2, label, sample_weight=None):
        input1 = input1.reshape(input2.shape)
        x_norm = input1.norm(dim=-1).reshape(-1, 1)
        y_norm = input2.norm(dim=-1).reshape(-1, 1)
        xy = (input1 * input2).sum(dim=-1).reshape(-1, 1)
        cos = xy / (x_norm * y_norm).clamp_min(1e-12)
        label = label.reshape(-1, 1)
        loss = torch.where(label == 1, 1 - cos,
                           torch.relu(cos - self._margin))
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return _batch_mean(loss, self._batch_axis)
