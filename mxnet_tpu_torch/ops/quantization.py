"""INT8 quantization ops (counterpart of ``mxnet_tpu/ops/quantization.py``,
ref: src/operator/quantization/).

The scheme is the JAX package's: int8 symmetric (scale = 127 /
max(|min|, |max|), q = round(x * scale)), uint8 affine (scale = 255 /
(max - min)), and an int8 x int8 product that accumulates to int32
exactly, with the float range of the int32 output following
quantization_range_for_multiplication (quantization_utils.h).

The exact int32 accumulation: CUDA's ``torch.matmul`` and ``conv2d``
have no integer kernels, and an f32 sum stops being exact past 2^24. The
products here run in float64 (cuBLAS DGEMM and cuDNN's double
convolution on the card): every partial sum of int8 products is an
integer below 2^53, so any order of summation is exact, and the cast to
int32 gives the JAX ops' ``preferred_element_type=int32`` result bit for
bit, on the card as on the CPU (PERF.md has the route's time).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..base import register_op, torch_dtype
from .nn import _tup

__all__ = []

INT8_RANGE = 127.0
UINT8_RANGE = 255.0
INT32_RANGE = float(2 ** 31 - 1)


def _reg(fn, num_outputs=1):
    register_op(fn.__name__, num_outputs=num_outputs, nograd=True)(fn)
    __all__.append(fn.__name__)
    return fn


def _regn(n):
    return lambda fn: _reg(fn, num_outputs=n)


def _over(c, t):
    """c / t, rounded once as a float32 division: torch computes a Python
    number over a tensor as c * (1 / t), which rounds twice. The constant
    is filled on t's device (no host copy, so a CUDA graph captures it)."""
    return torch.div(torch.full_like(t, c), t)


def _rng(x, device=None):
    """A range argument (a number, a scalar tensor or a per-channel
    vector) as float32."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32)
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def _scalar(x, device=None):
    return _rng(x, device).reshape(())


def int8_scale(min_range, max_range):
    amax = torch.maximum(torch.abs(_rng(min_range)),
                         torch.abs(_rng(max_range)))
    return _over(INT8_RANGE, torch.clamp(amax, min=1e-30))


@_regn(3)
def quantize(data, min_range, max_range, out_type='uint8'):
    """Affine (uint8) or symmetric (int8) quantize with an explicit range
    (ref: quantize.cc)."""
    lo, hi = _scalar(min_range, data.device), _scalar(max_range, data.device)
    x = data.to(torch.float32)
    if out_type == 'uint8':
        scale = _over(UINT8_RANGE, torch.clamp(hi - lo, min=1e-30))
        q = torch.clamp(torch.round((x - lo) * scale), 0, 255)
        return q.to(torch.uint8), lo, hi
    scale = int8_scale(lo, hi)
    q = torch.clamp(torch.round(x * scale), -127, 127).to(torch.int8)
    amax = _over(INT8_RANGE, scale)
    return q, -amax, amax


@_regn(3)
def quantize_v2(data, out_type='int8', min_calib_range=None,
                max_calib_range=None):
    """Quantize with a calibrated range, or the data's own (ref:
    quantize_v2.cc)."""
    if out_type == 'auto':
        out_type = 'int8'
    if min_calib_range is None or max_calib_range is None:
        lo = torch.min(data).to(torch.float32)
        hi = torch.max(data).to(torch.float32)
    else:
        lo = _scalar(min_calib_range, data.device)
        hi = _scalar(max_calib_range, data.device)
    return quantize(data, lo, hi, out_type=out_type)


@_reg
def dequantize(data, min_range, max_range, out_type='float32'):
    """Ref: dequantize.cc. Ranges broadcast against ``data``, so
    per-channel int32 ranges dequantize correctly."""
    lo, hi = _rng(min_range, data.device), _rng(max_range, data.device)
    x = data.to(torch.float32)
    if data.dtype == torch.uint8:
        scale = _over(UINT8_RANGE, torch.clamp(hi - lo, min=1e-30))
        out = x / scale + lo
    elif data.dtype == torch.int32:
        scale = _over(INT32_RANGE,
                      torch.maximum(torch.abs(lo), torch.abs(hi)))
        out = x / scale
    else:
        out = x / int8_scale(lo, hi)
    return out.to(torch_dtype(out_type))


@_regn(3)
def requantize(data, min_range, max_range, min_calib_range=None,
               max_calib_range=None):
    """int32 to int8 (ref: requantize.cc)."""
    f = dequantize(data, min_range, max_range)
    if min_calib_range is not None and max_calib_range is not None:
        lo = torch.min(_rng(min_calib_range, data.device))
        hi = torch.max(_rng(max_calib_range, data.device))
    else:
        lo, hi = torch.min(f), torch.max(f)
    return quantize(f, lo, hi, out_type='int8')


def _mul_out_range(min_d, max_d, min_w, max_w):
    sd = int8_scale(min_d, max_d)
    sw = int8_scale(min_w, max_w)
    amax = _over(INT32_RANGE, sd * sw)
    return -amax, amax, sd, sw


def int8_matmul(a, b):
    """a (M, K) x b (K, N), int8 in, int32 out, exact (float64 products,
    see the module docstring)."""
    return torch.matmul(a.to(torch.float64), b.to(torch.float64)).to(
        torch.int32)


def _bias32(bias, min_bias, max_bias, sd, sw):
    sb = int8_scale(min_bias, max_bias)
    return torch.round(bias.to(torch.float32) / sb * (sd * sw)).to(
        torch.int32)


@_regn(3)
def quantized_fully_connected(data, weight, bias=None, min_data=None,
                              max_data=None, min_weight=None,
                              max_weight=None, min_bias=None, max_bias=None,
                              num_hidden=None, no_bias=False, flatten=True):
    """int8 x int8 -> int32 FC (ref: quantized_fully_connected.cc); an
    int8 bias is rescaled into the accumulator's scale."""
    if flatten and data.dim() > 2:
        data = data.reshape(data.shape[0], -1)
    lead = data.shape[:-1]
    out = int8_matmul(data.reshape(-1, data.shape[-1]), weight.t())
    out = out.reshape(tuple(lead) + (weight.shape[0],))
    lo, hi, sd, sw = _mul_out_range(min_data, max_data, min_weight,
                                    max_weight)
    if bias is not None and not no_bias:
        out = out + _bias32(bias, min_bias, max_bias, sd, sw)
    return out, lo, hi


_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}


@_regn(3)
def quantized_conv(data, weight, bias=None, min_data=None, max_data=None,
                   min_weight=None, max_weight=None, min_bias=None,
                   max_bias=None, kernel=None, stride=None, dilate=None,
                   pad=None, num_filter=0, num_group=1, no_bias=False,
                   layout='NCHW'):
    """int8 convolution with int32 accumulation (ref: quantized_conv.cc)."""
    nd = data.dim() - 2
    stride = _tup(stride, nd) if stride is not None else (1,) * nd
    dilate = _tup(dilate, nd) if dilate is not None else (1,) * nd
    out = _CONV[nd](data.to(torch.float64), weight.to(torch.float64),
                    stride=stride, padding=_tup(pad, nd), dilation=dilate,
                    groups=num_group).to(torch.int32)
    lo, hi, sd, sw = _mul_out_range(min_data, max_data, min_weight,
                                    max_weight)
    if lo.dim():
        lo = lo.reshape((-1,) + (1,) * nd)
        hi = hi.reshape((-1,) + (1,) * nd)
    if bias is not None and not no_bias:
        out = out + _bias32(bias, min_bias, max_bias, sd, sw).reshape(
            (1, -1) + (1,) * nd)
    return out, lo, hi


_MAX_POOL = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}
_AVG_POOL = {1: F.avg_pool1d, 2: F.avg_pool2d, 3: F.avg_pool3d}


@_regn(3)
def quantized_pooling(data, min_data, max_data, kernel=None, stride=None,
                      pad=None, pool_type='max', global_pool=False):
    """Pooling in the integer domain (ref: quantized_pooling.cc): max is
    exact, avg sums exactly, divides in float32 and rounds back; padding
    counts in the average, as the JAX op's zero-padded window sum does."""
    nd = data.dim() - 2
    if global_pool:
        kernel = tuple(data.shape[2:])
        stride = (1,) * nd
        pad = (0,) * nd
    kernel = _tup(kernel, nd)
    stride = _tup(stride, nd) if stride is not None else (1,) * nd
    pad = _tup(pad, nd)
    info = torch.iinfo(data.dtype)
    if pool_type == 'max':
        out = _MAX_POOL[nd](data.to(torch.float32), kernel, stride, pad)
        out = out.to(data.dtype)
    else:
        n = 1
        for k in kernel:
            n *= k
        s = _AVG_POOL[nd](data.to(torch.float64), kernel, stride, pad,
                          count_include_pad=True) * n
        out = torch.clamp(torch.round(torch.round(s).to(torch.float32) / n),
                          info.min, info.max).to(data.dtype)
    return out, _rng(min_data, data.device), _rng(max_data, data.device)


@_regn(3)
def quantized_flatten(data, min_data, max_data):
    """Ref: quantized_flatten.cc; a per-channel range becomes one."""
    lo, hi = _rng(min_data, data.device), _rng(max_data, data.device)
    return data.reshape(data.shape[0], -1), torch.min(lo), torch.max(hi)


def _abs_max(lo, hi):
    return torch.maximum(torch.abs(_rng(lo)), torch.abs(_rng(hi))).max()


@_regn(3)
def quantized_concat(*args, dim=1):
    """Concat int8 inputs rescaled to a shared range (ref:
    quantized_concat.cc). Args: d0, min0, max0, d1, min1, max1, ..."""
    n = len(args) // 3
    datas = args[0::3][:n]
    mins = list(args[1::3][:n])
    maxs = list(args[2::3][:n])
    amax = torch.stack([_abs_max(lo, hi).to(datas[0].device)
                        for lo, hi in zip(mins, maxs)]).max()
    s_out = _over(INT8_RANGE, amax)
    parts = [torch.clamp(torch.round(d.to(torch.float32) / int8_scale(lo, hi)
                                     * s_out), -127, 127).to(torch.int8)
             for d, lo, hi in zip(datas, mins, maxs)]
    return torch.cat(parts, dim=dim), -amax, amax


@_regn(3)
def quantized_elemwise_add(lhs, rhs, min_lhs, max_lhs, min_rhs, max_rhs):
    """Add in the dequantized domain, requantize to the combined range
    (ref: quantized_elemwise_add.cc)."""
    out = dequantize(lhs, min_lhs, max_lhs) + dequantize(rhs, min_rhs,
                                                         max_rhs)
    amax = _abs_max(min_lhs, max_lhs) + _abs_max(min_rhs, max_rhs)
    s = _over(INT8_RANGE, torch.clamp(amax, min=1e-30))
    q = torch.clamp(torch.round(out * s), -127, 127).to(torch.int8)
    return q, -amax, amax
