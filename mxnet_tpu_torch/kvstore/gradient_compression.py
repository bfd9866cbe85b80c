"""Gradient compression with an error-feedback residual, the kvstore's
codec (counterpart of ``mxnet_tpu/kvstore/gradient_compression.py``).

Ref: src/kvstore/gradient_compression.h:52-121: quantize to
{-threshold, 0, +threshold} and carry the quantization error into the
next push (compute_expected_2bit_quantization in
tests/python/unittest/test_kvstore.py). The codecs are
``parallel/compression.py``'s ``encode_decode``: ``2bit`` (an absolute
threshold with ``block_size=0``, the default here), ``fp16`` and ``int8``
(a per-block scale with a positive ``block_size``, one per-tensor scale
with 0). Plain torch ops on the gradient's device.
"""
from __future__ import annotations

import torch

from ..ndarray.ndarray import NDArray
from ..parallel import compression as _codecs


class GradientCompression:
    def __init__(self, ctype='2bit', threshold=0.5, block_size=None):
        # one validator (codec names, threshold > 0, block >= 0):
        # parallel/compression.resolve
        spec = _codecs.resolve({'type': ctype, 'threshold': threshold,
                                'block_size': int(block_size or 0)})
        if spec is None:
            self.type, self.threshold, self.block = 'none', \
                float(threshold), 0
        else:
            self.type = spec['type']
            self.threshold = spec['threshold']
            self.block = spec['block']
        self._residual = {}

    def get_params(self):
        return {'type': self.type, 'threshold': self.threshold,
                'block_size': self.block}

    def wire_bytes(self, shape):
        """Encoded bytes of one pushed gradient of ``shape``."""
        return _codecs.wire_bytes(tuple(shape), self.type, self.block)

    def compress_decompress(self, grad: NDArray, key) -> NDArray:
        """The error-feedback round trip of one push: quantize
        ``grad + residual[key]``, carry the quantization error forward,
        return the decoded value the pull side would see."""
        if self.type == 'none':
            return grad
        g = grad._data.to(torch.float32)
        r = self._residual.get(key)
        if r is None:
            r = torch.zeros_like(g)
        acc = r + g
        q = _codecs.encode_decode(acc, self.type, self.threshold,
                                  self.block)
        # the residual is written back only when the sum is finite (on
        # the device, no host sync): a transient Inf/NaN gradient reaches
        # the decoded value, so a guard or loss scaler sees it, but never
        # outlives this push in the carried error
        self._residual[key] = torch.where(torch.isfinite(acc).all(),
                                          acc - q, r)
        return NDArray(q.to(grad._data.dtype))

    def reset(self):
        """Drop the carried residuals (a restore rewinds the weights, and
        the old error no longer describes the trajectory)."""
        self._residual.clear()
