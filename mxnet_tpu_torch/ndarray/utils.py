"""Data-parallel helpers (counterpart of ``mxnet_tpu/ndarray/utils.py``,
ref: python/mxnet/gluon/utils.py split_and_load): a batch cut along its
batch axis and each slice placed on one context. The port keeps one
copy of a parameter, so more than one context is for the helpers'
callers (the Estimator takes a one-context list)."""
from __future__ import annotations

from ..base import MXNetError
from .ndarray import NDArray, array

__all__ = ['split_data', 'split_and_load']


def split_data(data, num_slice, batch_axis=0, even_split=True):
    size = data.shape[batch_axis]
    if even_split and size % num_slice != 0:
        raise MXNetError(
            f"batch size {size} not divisible by {num_slice} slices")
    step = size // num_slice
    slices = []
    for i in range(num_slice):
        begin = i * step
        end = (i + 1) * step if i < num_slice - 1 else size
        slices.append(data.slice_axis(batch_axis, begin, end))
    return slices


def split_and_load(data, ctx_list, batch_axis=0, even_split=True):
    if not isinstance(data, NDArray):
        data = array(data)
    if len(ctx_list) == 1:
        return [data.as_in_context(ctx_list[0])]
    slices = split_data(data, len(ctx_list), batch_axis, even_split)
    return [s.as_in_context(ctx) for s, ctx in zip(slices, ctx_list)]
