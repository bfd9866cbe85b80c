"""Evaluation metrics (counterpart of ``mxnet_tpu/metric.py``, ref:
python/mxnet/metric.py): ``EvalMetric`` with its local and global
statistics, ``CompositeEvalMetric``, ``Accuracy``, ``TopKAccuracy``,
``F1``, ``MCC``, ``Perplexity``, ``MAE``, ``MSE``, ``RMSE``,
``CrossEntropy``, ``NegativeLogLikelihood``, ``PearsonCorrelation``,
``PCC``, ``Loss`` (and its ``Torch``/``Caffe`` names), ``CustomMetric``,
``np``, ``create`` by name, instance, callable or list, and
``check_label_shapes``.

As in the JAX package, a metric reads its inputs on the host: an
NDArray, a torch tensor (on the card or not; bfloat16 read as float32)
or anything numpy takes, so an update syncs with the card. The registry
is the port's own copy of the JAX package's ``base.Registry``.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional

import numpy as onp
import torch

from .base import MXNetError
from .ndarray.ndarray import NDArray


class Registry:
    """Names to classes, lower-cased (the JAX package's ``base.Registry``)."""

    def __init__(self, kind: str):
        self.kind = kind
        self._store: Dict[str, Any] = {}

    def register(self, obj: Any = None, name: Optional[str] = None):
        def deco(o):
            self._store[(name or o.__name__).lower()] = o
            return o
        if obj is None:
            return deco
        return deco(obj)

    def get(self, name: str):
        key = name.lower()
        if key not in self._store:
            raise MXNetError(f"Unknown {self.kind} {name!r}. "
                             f"Registered: {sorted(self._store)}")
        return self._store[key]

    def create(self, name, *args, **kwargs):
        if isinstance(name, str):
            return self.get(name)(*args, **kwargs)
        return name

    def list(self):
        return sorted(self._store)


_REG = Registry('metric')
register = _REG.register


def create(metric, *args, **kwargs):
    if callable(metric):
        return CustomMetric(metric, *args, **kwargs)
    if isinstance(metric, EvalMetric):
        return metric
    if isinstance(metric, list):
        composite = CompositeEvalMetric()
        for m in metric:
            composite.add(create(m, *args, **kwargs))
        return composite
    return _REG.create(metric, *args, **kwargs)


def _as_numpy(x):
    if isinstance(x, NDArray):
        return x.asnumpy()
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.cpu().numpy()
    return onp.asarray(x)


_ARRAYS = (NDArray, torch.Tensor, onp.ndarray)


def check_label_shapes(labels, preds, shape=False):
    if not shape:
        label_shape, pred_shape = len(labels), len(preds)
    else:
        label_shape, pred_shape = labels.shape, preds.shape
    if label_shape != pred_shape:
        raise ValueError(f"Shape of labels {label_shape} does not match "
                         f"shape of predictions {pred_shape}")


class EvalMetric:
    """Ref: metric.py:67."""

    def __init__(self, name, output_names=None, label_names=None, **kwargs):
        self.name = str(name)
        self.output_names = output_names
        self.label_names = label_names
        self._kwargs = kwargs
        self.reset()

    def __str__(self):
        return f"EvalMetric: {dict(self.get_name_value())}"

    def get_config(self):
        config = self._kwargs.copy()
        config.update({'metric': self.__class__.__name__, 'name': self.name,
                       'output_names': self.output_names,
                       'label_names': self.label_names})
        return config

    def update_dict(self, label, pred):
        if self.output_names is not None:
            pred = [pred[name] for name in self.output_names if name in pred]
        else:
            pred = list(pred.values())
        if self.label_names is not None:
            label = [label[name] for name in self.label_names if name in label]
        else:
            label = list(label.values())
        self.update(label, pred)

    def update(self, labels, preds):
        raise NotImplementedError

    def reset(self):
        self.num_inst = 0
        self.sum_metric = 0.0
        self.global_num_inst = 0
        self.global_sum_metric = 0.0

    def reset_local(self):
        self.num_inst = 0
        self.sum_metric = 0.0

    def get(self):
        if self.num_inst == 0:
            return (self.name, float('nan'))
        return (self.name, self.sum_metric / self.num_inst)

    def get_global(self):
        if self.global_num_inst == 0:
            return (self.name, float('nan'))
        return (self.name, self.global_sum_metric / self.global_num_inst)

    def get_name_value(self):
        name, value = self.get()
        if not isinstance(name, list):
            name = [name]
        if not isinstance(value, list):
            value = [value]
        return list(zip(name, value))

    def _update(self, metric, inst):
        self.sum_metric += metric
        self.num_inst += inst
        self.global_sum_metric += metric
        self.global_num_inst += inst


class CompositeEvalMetric(EvalMetric):
    def __init__(self, metrics=None, name='composite', **kwargs):
        super().__init__(name, **kwargs)
        self.metrics = [create(m) for m in (metrics or [])]

    def add(self, metric):
        self.metrics.append(create(metric))

    def get_metric(self, index):
        return self.metrics[index]

    def update(self, labels, preds):
        for metric in self.metrics:
            metric.update(labels, preds)

    def reset(self):
        for metric in getattr(self, 'metrics', []):
            metric.reset()

    def get(self):
        names = []
        values = []
        for metric in self.metrics:
            name, value = metric.get()
            if isinstance(name, str):
                name = [name]
            if isinstance(value, (float, int)):
                value = [value]
            names.extend(name)
            values.extend(value)
        return (names, values)


@register(name='acc')
@register
class Accuracy(EvalMetric):
    """Ref: metric.py:437 (registered under 'accuracy' and the
    reference's 'acc' alias)."""

    def __init__(self, axis=1, name='accuracy', **kwargs):
        super().__init__(name, axis=axis, **kwargs)
        self.axis = axis

    def update(self, labels, preds):
        if isinstance(labels, _ARRAYS):
            labels = [labels]
        if isinstance(preds, _ARRAYS):
            preds = [preds]
        check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            label = _as_numpy(label)
            pred = _as_numpy(pred)
            if pred.ndim > label.ndim:
                pred = onp.argmax(pred, axis=self.axis)
            pred = pred.astype(onp.int32).ravel()
            label = label.astype(onp.int32).ravel()
            check_label_shapes(label, pred, shape=True)
            correct = (pred == label).sum()
            self._update(float(correct), len(label))


@register(name='top_k_acc')
@register(name='top_k_accuracy')
class TopKAccuracy(EvalMetric):
    """Ref: metric.py:510 (+ 'top_k_acc' alias)."""

    def __init__(self, top_k=1, name='top_k_accuracy', **kwargs):
        super().__init__(name, top_k=top_k, **kwargs)
        self.top_k = top_k
        self.name += f'_{top_k}'

    def update(self, labels, preds):
        for label, pred in zip(labels, preds):
            label = _as_numpy(label).astype(onp.int32).ravel()
            pred = _as_numpy(pred)
            topk = onp.argsort(-pred, axis=-1)[:, :self.top_k]
            correct = (topk == label[:, None]).any(axis=1).sum()
            self._update(float(correct), len(label))


class _BinaryClassificationMetrics:
    def __init__(self):
        self.reset_stats()

    def reset_stats(self):
        self.tp = self.fp = self.tn = self.fn = 0

    def update(self, label, pred):
        pred_label = onp.argmax(pred, axis=1) if pred.ndim > 1 else (pred > 0.5)
        label = label.astype(onp.int32).ravel()
        pred_label = pred_label.astype(onp.int32).ravel()
        self.tp += int(((pred_label == 1) & (label == 1)).sum())
        self.fp += int(((pred_label == 1) & (label == 0)).sum())
        self.tn += int(((pred_label == 0) & (label == 0)).sum())
        self.fn += int(((pred_label == 0) & (label == 1)).sum())

    @property
    def precision(self):
        d = self.tp + self.fp
        return self.tp / d if d else 0.0

    @property
    def recall(self):
        d = self.tp + self.fn
        return self.tp / d if d else 0.0

    @property
    def fscore(self):
        d = self.precision + self.recall
        return 2 * self.precision * self.recall / d if d else 0.0

    @property
    def matthewscc(self):
        terms = [(self.tp + self.fp), (self.tp + self.fn), (self.tn + self.fp),
                 (self.tn + self.fn)]
        denom = 1.0
        for t in terms:
            denom *= t if t else 1.0
        return ((self.tp * self.tn - self.fp * self.fn) / math.sqrt(denom))

    @property
    def total_examples(self):
        return self.tp + self.fp + self.tn + self.fn


@register
class F1(EvalMetric):
    """Ref: metric.py:744."""

    def __init__(self, name='f1', average='macro', **kwargs):
        super().__init__(name, **kwargs)
        self.average = average
        self.metrics = _BinaryClassificationMetrics()

    def update(self, labels, preds):
        for label, pred in zip(labels, preds):
            self.metrics.update(_as_numpy(label), _as_numpy(pred))
        self.sum_metric = self.metrics.fscore * self.metrics.total_examples
        self.global_sum_metric = self.sum_metric
        self.num_inst = self.metrics.total_examples
        self.global_num_inst = self.num_inst

    def reset(self):
        super().reset()
        if hasattr(self, 'metrics'):
            self.metrics.reset_stats()


@register
class MCC(EvalMetric):
    """Ref: metric.py:838."""

    def __init__(self, name='mcc', **kwargs):
        super().__init__(name, **kwargs)
        self.metrics = _BinaryClassificationMetrics()

    def update(self, labels, preds):
        for label, pred in zip(labels, preds):
            self.metrics.update(_as_numpy(label), _as_numpy(pred))
        self.sum_metric = self.metrics.matthewscc * self.metrics.total_examples
        self.num_inst = self.metrics.total_examples

    def reset(self):
        super().reset()
        if hasattr(self, 'metrics'):
            self.metrics.reset_stats()


@register
class Perplexity(EvalMetric):
    """Ref: metric.py:953."""

    def __init__(self, ignore_label=None, axis=-1, name='perplexity', **kwargs):
        super().__init__(name, ignore_label=ignore_label, axis=axis, **kwargs)
        self.ignore_label = ignore_label
        self.axis = axis

    def update(self, labels, preds):
        loss = 0.0
        num = 0
        for label, pred in zip(labels, preds):
            label = _as_numpy(label)
            pred = _as_numpy(pred)
            flat_label = label.astype(onp.int64).ravel()
            pred2d = pred.reshape(-1, pred.shape[-1])
            probs = pred2d[onp.arange(flat_label.size), flat_label]
            if self.ignore_label is not None:
                ignore = (flat_label == self.ignore_label)
                probs = onp.where(ignore, 1.0, probs)
                num -= int(ignore.sum())
            loss -= onp.sum(onp.log(onp.maximum(1e-10, probs)))
            num += flat_label.size
        self._update(loss, num)

    def get(self):
        if self.num_inst == 0:
            return (self.name, float('nan'))
        return (self.name, math.exp(self.sum_metric / self.num_inst))


@register
class MAE(EvalMetric):
    def __init__(self, name='mae', **kwargs):
        super().__init__(name, **kwargs)

    def update(self, labels, preds):
        for label, pred in zip(labels, preds):
            label = _as_numpy(label)
            pred = _as_numpy(pred)
            if label.ndim == 1:
                label = label.reshape(label.shape[0], 1)
            if pred.ndim == 1:
                pred = pred.reshape(pred.shape[0], 1)
            self._update(float(onp.abs(label - pred).mean()), 1)


@register
class MSE(EvalMetric):
    def __init__(self, name='mse', **kwargs):
        super().__init__(name, **kwargs)

    def update(self, labels, preds):
        for label, pred in zip(labels, preds):
            label = _as_numpy(label)
            pred = _as_numpy(pred)
            if label.ndim == 1:
                label = label.reshape(label.shape[0], 1)
            if pred.ndim == 1:
                pred = pred.reshape(pred.shape[0], 1)
            self._update(float(((label - pred) ** 2).mean()), 1)


@register
class RMSE(MSE):
    def __init__(self, name='rmse', **kwargs):
        EvalMetric.__init__(self, name, **kwargs)

    def get(self):
        if self.num_inst == 0:
            return (self.name, float('nan'))
        return (self.name, math.sqrt(self.sum_metric / self.num_inst))


@register(name='ce')
@register
class CrossEntropy(EvalMetric):
    """Ref: metric.py:1271."""

    def __init__(self, eps=1e-12, name='cross-entropy', **kwargs):
        super().__init__(name, eps=eps, **kwargs)
        self.eps = eps

    def update(self, labels, preds):
        for label, pred in zip(labels, preds):
            label = _as_numpy(label).ravel()
            pred = _as_numpy(pred)
            assert label.shape[0] == pred.shape[0]
            prob = pred[onp.arange(label.shape[0]), label.astype(onp.int64)]
            ce = (-onp.log(prob + self.eps)).sum()
            self._update(float(ce), label.shape[0])


@register(name='nll_loss')
class NegativeLogLikelihood(CrossEntropy):
    def __init__(self, eps=1e-12, name='nll-loss', **kwargs):
        EvalMetric.__init__(self, name, eps=eps, **kwargs)
        self.eps = eps


@register(name='pearsonr')
class PearsonCorrelation(EvalMetric):
    def __init__(self, name='pearsonr', **kwargs):
        super().__init__(name, **kwargs)

    def update(self, labels, preds):
        for label, pred in zip(labels, preds):
            label = _as_numpy(label).ravel()
            pred = _as_numpy(pred).ravel()
            corr = onp.corrcoef(pred, label)[0, 1]
            self._update(float(corr), 1)


@register
class PCC(EvalMetric):
    """Multiclass Pearson correlation via confusion matrix (ref: metric.py:1527)."""

    def __init__(self, name='pcc', **kwargs):
        self.k = 2
        super().__init__(name, **kwargs)

    def _grow(self, inc):
        self.lcm = onp.pad(self.lcm, ((0, inc), (0, inc)))
        self.k += inc

    def update(self, labels, preds):
        for label, pred in zip(labels, preds):
            label = _as_numpy(label).astype(onp.int32).ravel()
            pred = _as_numpy(pred)
            if pred.ndim > 1:
                pred = onp.argmax(pred, axis=1)
            pred = pred.astype(onp.int32).ravel()
            n = int(max(pred.max(), label.max())) + 1
            if n > self.k:
                self._grow(n - self.k)
            for i, j in zip(pred, label):
                self.lcm[i, j] += 1
        self.num_inst = 1
        self.sum_metric = self._calc_mcc(self.lcm)

    def _calc_mcc(self, cmat):
        n = cmat.sum()
        x = cmat.sum(axis=1)
        y = cmat.sum(axis=0)
        cov_xx = onp.sum(x * (n - x))
        cov_yy = onp.sum(y * (n - y))
        i = cmat.diagonal()
        cov_xy = onp.sum(i * n - x * y)
        if cov_xx == 0 or cov_yy == 0:
            return float('nan')
        return cov_xy / (cov_xx * cov_yy) ** 0.5

    def reset(self):
        self.lcm = onp.zeros((getattr(self, 'k', 2), getattr(self, 'k', 2)))
        super().reset()


@register
class Loss(EvalMetric):
    def __init__(self, name='loss', **kwargs):
        super().__init__(name, **kwargs)

    def update(self, _, preds):
        if isinstance(preds, (NDArray, torch.Tensor)):
            preds = [preds]
        for pred in preds:
            loss = float(_as_numpy(pred).sum())
            self._update(loss, _as_numpy(pred).size)


@register
class Torch(Loss):
    def __init__(self, name='torch', **kwargs):
        super().__init__(name, **kwargs)


@register
class Caffe(Loss):
    def __init__(self, name='caffe', **kwargs):
        super().__init__(name, **kwargs)


class CustomMetric(EvalMetric):
    def __init__(self, feval, name='custom', allow_extra_outputs=False, **kwargs):
        super().__init__(f'custom({name})', feval=feval,
                         allow_extra_outputs=allow_extra_outputs)
        self._feval = feval
        self._allow_extra_outputs = allow_extra_outputs

    def update(self, labels, preds):
        if not self._allow_extra_outputs:
            check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            label = _as_numpy(label)
            pred = _as_numpy(pred)
            reval = self._feval(label, pred)
            if isinstance(reval, tuple):
                sum_metric, num_inst = reval
                self._update(sum_metric, num_inst)
            else:
                self._update(reval, 1)


def np(numpy_feval, name=None, allow_extra_outputs=False):
    def feval(label, pred):
        return numpy_feval(label, pred)
    feval.__name__ = name if name else numpy_feval.__name__
    return CustomMetric(feval, feval.__name__, allow_extra_outputs)
