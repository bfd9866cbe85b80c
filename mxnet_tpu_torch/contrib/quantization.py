"""INT8 model quantization: calibration and network conversion
(counterpart of ``mxnet_tpu/contrib/quantization.py``, ref:
python/mxnet/contrib/quantization.py quantize_model / quantize_net,
src/operator/quantization/calibrate.cc).

The JAX package's design: conversion walks the Gluon block tree and
swaps Dense and Conv2D for Quantized* blocks whose forward runs the
int8 ops (``ops/quantization.py``: int8 x int8 products accumulated to
int32 exactly, in float64 on the card), with the weights quantized by
numpy and kept as Constant parameters (``weight``, ``wrange``, ``bias``,
``calib``), so ``save_parameters``/``load_parameters`` carry a quantized
net, and the JAX package's quantized ``.params`` load into the port's.
Calibration modes: 'naive' (min/max), 'entropy' (the KL-optimal
threshold, numpy) and 'none' (ranges from each batch at inference). A
quantized block lives on the device of the layer it replaces.
"""
from __future__ import annotations

import copy
import logging

import numpy as onp

from ..gluon.block import Block, HybridBlock, _structure_changed
from ..gluon import nn as _nn
from ..ndarray.ndarray import NDArray
from ..ndarray import array as _array

__all__ = ['quantize_net', 'quantize_model', 'QuantizedDense',
           'QuantizedConv2D', '_get_optimal_threshold']


# ---------------------------------------------------------------------------
# Entropy (KL-divergence) calibration — ref: calibrate.cc GetOptimalThreshold
# ---------------------------------------------------------------------------

def _smooth_distribution(p, eps=0.0001):
    is_zeros = (p == 0).astype(onp.float32)
    is_nonzeros = (p != 0).astype(onp.float32)
    n_zeros = is_zeros.sum()
    n_nonzeros = p.size - n_zeros
    if not n_nonzeros:
        return None
    eps1 = eps * float(n_zeros) / float(n_nonzeros)
    if eps1 >= 1.0:
        return None
    hist = p.astype(onp.float32)
    return hist + eps * is_zeros - eps1 * hist * is_nonzeros


def _kl_divergence(p, q):
    mask = p > 0
    if not mask.any():
        return onp.inf
    pm = p[mask] / p.sum()
    qm = onp.maximum(q[mask] / max(q.sum(), 1e-30), 1e-30)
    return float((pm * onp.log(pm / qm)).sum())


def _get_optimal_threshold(arr, num_bins=8001, num_quantized_bins=255):
    """KL-optimal symmetric threshold for int8 quantization of ``arr``.

    Returns (min_val, max_val, min_divergence_threshold, divergence) like the
    reference's GetOptimalThresholds output tuple.
    """
    arr = onp.asarray(arr).ravel().astype(onp.float32)
    min_val = float(arr.min())
    max_val = float(arr.max())
    th = max(abs(min_val), abs(max_val))
    if th == 0.0:
        return min_val, max_val, 1e-30, 0.0
    hist, edges = onp.histogram(arr, bins=num_bins, range=(-th, th))
    zero_bin = num_bins // 2
    half_q = num_quantized_bins // 2

    best_div = onp.inf
    best_th = th
    for i in range(half_q, zero_bin + 1):
        start, stop = zero_bin - i, zero_bin + i + 1
        sliced = hist[start:stop].astype(onp.float64)
        p = sliced.copy()
        p[0] += hist[:start].sum()
        p[-1] += hist[stop:].sum()
        threshold = float(edges[stop])

        # quantize the sliced distribution into num_quantized_bins
        nbins = sliced.size
        m = nbins // num_quantized_bins
        trimmed = sliced[:m * num_quantized_bins]
        q_merged = trimmed.reshape(num_quantized_bins, m).sum(axis=1)
        q_merged[-1] += sliced[m * num_quantized_bins:].sum()
        # expand back, distributing each merged bin over its nonzero members
        nz = (trimmed != 0).reshape(num_quantized_bins, m)
        counts = onp.maximum(nz.sum(axis=1), 1)
        expanded = onp.where(nz, (q_merged / counts)[:, None], 0.0).ravel()
        q = onp.zeros(nbins)
        q[:m * num_quantized_bins] = expanded

        sp = _smooth_distribution(p)
        sq = _smooth_distribution(q)
        if sp is None or sq is None:
            continue
        div = _kl_divergence(sp, sq)
        if div < best_div:
            best_div = div
            best_th = threshold
    return min_val, max_val, best_th, float(best_div)


# ---------------------------------------------------------------------------
# Quantized layers
# ---------------------------------------------------------------------------

def _quantize_weight(w, channel_wise=False):
    """Symmetric int8 weight quantization (ref: the quantize pass marks
    weights 'quantize offline' with min/max from the array). channel_wise
    uses one scale per output channel (axis 0) — the reference's
    'channel-wise' quantize_granularity — which typically recovers accuracy
    on convs with uneven filter magnitudes."""
    w = onp.asarray(w)
    if channel_wise:
        amax = onp.abs(w).reshape(w.shape[0], -1).max(axis=1)
        amax = onp.maximum(amax, 1e-30).astype('float32')
        scale = 127.0 / amax
        q = onp.round(w * scale.reshape((-1,) + (1,) * (w.ndim - 1)))
    else:
        amax = onp.float32(float(onp.abs(w).max()) or 1e-30)
        q = onp.round(w * (127.0 / amax))
    return onp.clip(q, -127, 127).astype(onp.int8), -amax, amax


class _QuantizedBase(HybridBlock):
    """Shared plumbing: int8 weight, its range, bias and the calibrated
    activation range are all registered as Constant parameters so
    save_parameters / load_parameters round-trip quantized nets."""

    def __init__(self, weight, bias, act_type, min_calib, max_calib,
                 channel_wise=False, ctx=None, **kw):
        super().__init__(**kw)
        qw, wlo, whi = _quantize_weight(weight, channel_wise)
        with self.name_scope():
            self.weight = self.params.get_constant('weight', qw)
            self.wrange = self.params.get_constant(
                'wrange', onp.array([wlo, whi], 'float32'))
            if bias is not None:
                self.bias = self.params.get_constant(
                    'bias', onp.asarray(bias, 'float32'))
            else:
                self.bias = None
            if min_calib is not None:
                self.calib = self.params.get_constant(
                    'calib', onp.array([min_calib, max_calib], 'float32'))
            else:
                self.calib = None   # dynamic range, computed in-graph
        self._act_type = act_type
        self.collect_params().initialize(ctx=ctx)

    @staticmethod
    def _quantize_input(F, x, calib):
        if calib is None:
            return F.quantize_v2(x, out_type='int8')
        return F.quantize_v2(x, out_type='int8', min_calib_range=calib[0],
                             max_calib_range=calib[1])


class QuantizedDense(_QuantizedBase):
    """int8 inference replacement for gluon.nn.Dense
    (ref: quantized_fully_connected.cc path of the quantize pass)."""

    def __init__(self, dense, min_calib=None, max_calib=None,
                 channel_wise=False, **kw):
        w = dense.weight.data().asnumpy()
        b = dense.bias.data().asnumpy() if dense.bias is not None else None
        super().__init__(w, b, dense._act_type, min_calib, max_calib,
                         channel_wise, ctx=dense.weight.data().context, **kw)
        self._units = dense._units
        self._flatten = dense._flatten

    def hybrid_forward(self, F, x, weight, wrange, bias=None, calib=None):
        q, lo, hi = self._quantize_input(F, x, calib)
        out32, olo, ohi = F.quantized_fully_connected(
            q, weight, None, lo, hi, wrange[0], wrange[1],
            num_hidden=self._units, no_bias=True, flatten=self._flatten)
        out = F.dequantize(out32, olo, ohi)
        if bias is not None:
            out = out + bias
        if self._act_type is not None:
            out = F.activation(out, act_type=self._act_type)
        return out

    def __repr__(self):
        return (f"QuantizedDense(-> {self._units}, int8, "
                f"calib={self.calib is not None})")


class QuantizedConv2D(_QuantizedBase):
    """int8 inference replacement for gluon.nn.Conv2D
    (ref: quantized_conv.cc path of the quantize pass)."""

    def __init__(self, conv, min_calib=None, max_calib=None,
                 channel_wise=False, **kw):
        w = conv.weight.data().asnumpy()
        b = conv.bias.data().asnumpy() if conv.bias is not None else None
        super().__init__(w, b, conv._act_type, min_calib, max_calib,
                         channel_wise, ctx=conv.weight.data().context, **kw)
        self._kwargs = dict(conv._kwargs)

    def hybrid_forward(self, F, x, weight, wrange, bias=None, calib=None):
        q, lo, hi = self._quantize_input(F, x, calib)
        kw = self._kwargs
        out32, olo, ohi = F.quantized_conv(
            q, weight, None, lo, hi, wrange[0], wrange[1],
            kernel=kw['kernel'], stride=kw['stride'], dilate=kw['dilate'],
            pad=kw['pad'], num_filter=kw['num_filter'],
            num_group=kw['num_group'], no_bias=True)
        out = F.dequantize(out32, olo, ohi)
        if bias is not None:
            out = out + bias.reshape((1, -1, 1, 1))
        if self._act_type is not None:
            out = F.activation(out, act_type=self._act_type)
        return out

    def __repr__(self):
        return (f"QuantizedConv2D({self._kwargs['num_filter']}ch, int8, "
                f"calib={self.calib is not None})")


_QUANTIZABLE = {}


def _register_quantizable():
    _QUANTIZABLE[_nn.Dense] = QuantizedDense
    _QUANTIZABLE[_nn.Conv2D] = QuantizedConv2D


_register_quantizable()


# ---------------------------------------------------------------------------
# Block-tree walking, observation, conversion
# ---------------------------------------------------------------------------

class _Observer(Block):
    """Wraps a layer during calibration, keeping a running min/max and (for
    entropy mode) a bounded random subsample of inputs — never the full
    calibration set (the reference's collectors likewise keep only
    min/max or histograms, calibrate.cc)."""

    MAX_KEPT = 1 << 22   # per-layer cap on retained float32 samples (16 MiB)

    def __init__(self, inner, stat, keep_samples):
        super().__init__()
        self._inner = inner
        self._stat = stat
        self._keep = keep_samples
        self._rs = onp.random.RandomState(0)

    def forward(self, x, *args):
        a = x.asnumpy() if isinstance(x, NDArray) else \
            x.detach().float().cpu().numpy()
        st = self._stat
        st['min'] = min(st['min'], float(a.min()))
        st['max'] = max(st['max'], float(a.max()))
        if self._keep:
            budget = self.MAX_KEPT - st['nkept']
            if budget > 0:
                flat = a.ravel().astype(onp.float32)
                if flat.size > budget:
                    flat = flat[self._rs.choice(flat.size, budget,
                                                replace=False)]
                st['samples'].append(flat)
                st['nkept'] += flat.size
        return self._inner(x, *args)


def _walk(block, path=''):
    for name, child in list(block._children.items()):
        cpath = f"{path}.{name}" if path else name
        yield block, name, cpath, child
        yield from _walk(child, cpath)


def _set_child(parent, name, new):
    """Put ``new`` in ``parent``'s child slot ``name`` (torch keeps the
    children in ``_modules``)."""
    parent._modules[name] = new
    _structure_changed()
    if isinstance(parent, HybridBlock):
        parent._cached_op = None


def _clear_caches(net):
    """Drop every compiled trace in the tree: a cached op anywhere above a
    replaced child still closes over the old float layers."""
    if isinstance(net, HybridBlock):
        net._cached_op = None
    for _, _, _, child in _walk(net):
        if isinstance(child, HybridBlock):
            child._cached_op = None


def _deactivate_hybrid(net):
    saved = []
    for _, _, _, child in _walk(net):
        if isinstance(child, HybridBlock):
            saved.append((child, child._active))
            child._active = False
    if isinstance(net, HybridBlock):
        saved.append((net, net._active))
        net._active = False
    return saved


def _iter_calib_batches(calib_data, num_calib_batches):
    if isinstance(calib_data, NDArray):
        yield calib_data
        return
    for i, item in enumerate(calib_data):
        if num_calib_batches is not None and i >= num_calib_batches:
            return
        if isinstance(item, (tuple, list)):
            item = item[0]
        if not isinstance(item, NDArray):
            item = _array(onp.asarray(item))
        yield item


def quantize_net(network, quantized_dtype='int8', exclude_layers=None,
                 calib_data=None, calib_mode='naive', num_calib_batches=None,
                 quantize_granularity='tensor-wise', logger=None,
                 num_bins=8001):
    """Quantize a Gluon network to int8 (ref: contrib/quantization.py
    quantize_net_v2). Returns a new network with Dense/Conv2D replaced by
    int8 blocks; original is left untouched.

    calib_mode: 'naive' (min/max of observed inputs), 'entropy' (KL-optimal
    thresholds), 'none' (dynamic quantization — ranges computed in-graph).
    quantize_granularity: 'tensor-wise' (one weight scale per layer) or
    'channel-wise' (one per output channel).
    """
    log = logger or logging.getLogger(__name__)
    if quantized_dtype not in ('int8', 'auto'):
        raise ValueError(f"quantized_dtype {quantized_dtype!r}: TPU build "
                         "supports symmetric int8 ('int8'/'auto')")
    if quantize_granularity not in ('tensor-wise', 'channel-wise'):
        raise ValueError(
            f"quantize_granularity {quantize_granularity!r}: expected "
            "'tensor-wise' or 'channel-wise'")
    try:
        net = copy.deepcopy(network)
    except Exception:  # un-deepcopyable custom blocks: convert in place
        log.warning("quantize_net: deepcopy failed; converting in place")
        net = network

    exclude = set(exclude_layers or ())
    targets = [(parent, name, path, child)
               for parent, name, path, child in _walk(net)
               if type(child) in _QUANTIZABLE and path not in exclude]
    if not targets:
        return net

    ranges = {path: None for _, _, path, _ in targets}
    if calib_mode != 'none':
        if calib_mode not in ('naive', 'entropy'):
            raise ValueError(f"unknown calib_mode {calib_mode!r}")
        if calib_data is None:
            raise ValueError(f"calib_mode={calib_mode!r} requires calib_data")
        saved = _deactivate_hybrid(net)
        stats = {}
        for parent, name, path, child in targets:
            stats[path] = {'min': onp.inf, 'max': -onp.inf,
                           'samples': [], 'nkept': 0}
            _set_child(parent, name,
                       _Observer(child, stats[path],
                                 keep_samples=(calib_mode == 'entropy')))
        try:
            for batch in _iter_calib_batches(calib_data, num_calib_batches):
                net(batch)
        finally:
            for parent, name, path, child in targets:
                _set_child(parent, name, child)
            for blk, active in saved:
                blk._active = active
        for path, st in stats.items():
            if not onp.isfinite(st['min']):
                continue
            if calib_mode == 'naive':
                th = max(abs(st['min']), abs(st['max']))
            else:
                flat = onp.concatenate(st['samples'])
                _, _, th, div = _get_optimal_threshold(flat, num_bins=num_bins)
                log.debug("entropy calib %s: threshold=%g kl=%g",
                          path, th, div)
            ranges[path] = (-th, th)

    cw = quantize_granularity == 'channel-wise'
    for parent, name, path, child in targets:
        rng = ranges.get(path)
        lo, hi = rng if rng is not None else (None, None)
        qcls = _QUANTIZABLE[type(child)]
        _set_child(parent, name, qcls(child, min_calib=lo, max_calib=hi,
                                      channel_wise=cw))
    _clear_caches(net)
    return net


def quantize_model(network, **kwargs):
    """Alias kept for reference-API parity (ref: quantize_model works on
    Module/symbol; the TPU build's primary path is the Gluon one)."""
    return quantize_net(network, **kwargs)
