"""Image transforms (counterpart of
``mxnet_tpu/gluon/data/vision/transforms.py``; ref:
python/mxnet/gluon/data/vision/transforms.py).

``ToTensor``, ``Normalize`` and ``Cast`` are HybridBlocks; the random
transforms are Blocks (a hybridized block on the card replays one CUDA
graph, which would freeze a random draw). The random transforms draw
from numpy's global generator as the JAX package's do. ``Resize`` runs
torch's antialiased interpolation where the JAX package runs
``jax.image.resize``: the shapes agree, the values to interpolation
rounding.
"""
from __future__ import annotations

import math

import numpy as onp
import torch
import torch.nn.functional as F_

from ...block import Block, HybridBlock
from ...nn import Sequential, HybridSequential
from ....ndarray.ndarray import NDArray, _invoke

__all__ = ['Compose', 'Cast', 'ToTensor', 'Normalize', 'Resize',
           'CenterCrop', 'RandomResizedCrop', 'RandomFlipLeftRight',
           'RandomFlipTopBottom', 'RandomCrop', 'RandomBrightness',
           'RandomContrast', 'RandomSaturation', 'RandomColorJitter']


# ---- the image ops (ref: src/operator/image/), on HWC or NHWC ---------------

def _to_tensor(data):
    """HWC uint8 -> CHW float32 in [0, 1]."""
    perm = (2, 0, 1) if data.dim() == 3 else (0, 3, 1, 2)
    return data.permute(*perm).to(torch.float32) / 255.0


def _normalize(data, mean=(0, 0, 0), std=(1, 1, 1)):
    """(x - mean) / std over the channels of CHW or NCHW data."""
    m = torch.tensor(mean, dtype=data.dtype, device=data.device)
    s = torch.tensor(std, dtype=data.dtype, device=data.device)
    shape = (-1, 1, 1) if data.dim() == 3 else (1, -1, 1, 1)
    return (data - m.reshape(shape)) / s.reshape(shape)


def _resize(data, size=(224, 224), keep_ratio=False, interp=1):
    if isinstance(size, int):
        size = (size, size)
    w, h = size
    x = data.unsqueeze(0) if data.dim() == 3 else data
    x = x.permute(0, 3, 1, 2).to(torch.float32)
    if interp == 0:
        y = F_.interpolate(x, size=(h, w), mode='nearest')
    else:
        y = F_.interpolate(x, size=(h, w), mode='bilinear',
                           align_corners=False, antialias=True)
    y = y.permute(0, 2, 3, 1)
    if not data.dtype.is_floating_point:
        y = y.round().clamp(0, 255)
    y = y.to(data.dtype)
    return y[0] if data.dim() == 3 else y


def _crop(data, x=0, y=0, width=1, height=1):
    if data.dim() == 3:
        return data[y:y + height, x:x + width, :]
    return data[:, y:y + height, x:x + width, :]


def _flip_left_right(data):
    return torch.flip(data, dims=(-2,))


def _flip_top_bottom(data):
    return torch.flip(data, dims=(-3,))


class Compose(Sequential):
    """Ref: transforms.py Compose: consecutive HybridBlocks are grouped
    into one HybridSequential."""

    def __init__(self, transforms):
        super().__init__()
        with self.name_scope():
            hybrid = []
            for i in transforms:
                if isinstance(i, HybridBlock):
                    hybrid.append(i)
                    continue
                elif len(hybrid) == 1:
                    self.add(hybrid[0])
                    hybrid = []
                elif len(hybrid) > 1:
                    hblock = HybridSequential()
                    with hblock.name_scope():
                        for j in hybrid:
                            hblock.add(j)
                    self.add(hblock)
                    hybrid = []
                self.add(i)
            if len(hybrid) == 1:
                self.add(hybrid[0])
            elif len(hybrid) > 1:
                hblock = HybridSequential()
                with hblock.name_scope():
                    for j in hybrid:
                        hblock.add(j)
                self.add(hblock)


class Cast(HybridBlock):
    def __init__(self, dtype='float32'):
        super().__init__()
        self._dtype = dtype

    def hybrid_forward(self, F, x):
        return F.cast(x, dtype=self._dtype)


class ToTensor(HybridBlock):
    """HWC uint8 -> CHW float32 [0,1] (ref: transforms.py ToTensor)."""

    def hybrid_forward(self, F, x):
        return _invoke(_to_tensor, x)


class Normalize(HybridBlock):
    def __init__(self, mean=0.0, std=1.0):
        super().__init__()
        self._mean = mean if isinstance(mean, (tuple, list)) else (mean,) * 3
        self._std = std if isinstance(std, (tuple, list)) else (std,) * 3

    def hybrid_forward(self, F, x):
        return _invoke(_normalize, x, mean=self._mean, std=self._std)


class Resize(Block):
    def __init__(self, size, keep_ratio=False, interpolation=1):
        super().__init__()
        self._size = size
        self._keep = keep_ratio
        self._interpolation = interpolation

    def forward(self, x):
        return _invoke(_resize, x, size=self._size, keep_ratio=self._keep,
                       interp=self._interpolation)


class CenterCrop(Block):
    def __init__(self, size, interpolation=1):
        super().__init__()
        self._size = size if isinstance(size, (tuple, list)) else (size, size)

    def forward(self, x):
        w, h = self._size
        ih, iw = x.shape[-3], x.shape[-2]
        y0 = max(0, (ih - h) // 2)
        x0 = max(0, (iw - w) // 2)
        return _invoke(_crop, x, x=x0, y=y0, width=w, height=h)


class RandomResizedCrop(Block):
    def __init__(self, size, scale=(0.08, 1.0), ratio=(3 / 4., 4 / 3.),
                 interpolation=1):
        super().__init__()
        self._size = size if isinstance(size, (tuple, list)) else (size, size)
        self._scale = scale
        self._ratio = ratio

    def forward(self, x):
        ih, iw = x.shape[-3], x.shape[-2]
        area = ih * iw
        for _ in range(10):
            target_area = onp.random.uniform(*self._scale) * area
            aspect = math.exp(onp.random.uniform(math.log(self._ratio[0]),
                                                 math.log(self._ratio[1])))
            w = int(round(math.sqrt(target_area * aspect)))
            h = int(round(math.sqrt(target_area / aspect)))
            if w <= iw and h <= ih:
                x0 = onp.random.randint(0, iw - w + 1)
                y0 = onp.random.randint(0, ih - h + 1)
                out = _invoke(_crop, x, x=x0, y=y0, width=w, height=h)
                return _invoke(_resize, out, size=self._size)
        return _invoke(_resize, x, size=self._size)


class RandomFlipLeftRight(Block):
    def forward(self, x):
        if onp.random.rand() < 0.5:
            return _invoke(_flip_left_right, x)
        return x


class RandomFlipTopBottom(Block):
    def forward(self, x):
        if onp.random.rand() < 0.5:
            return _invoke(_flip_top_bottom, x)
        return x


class RandomCrop(Block):
    def __init__(self, size, pad=None, interpolation=1):
        super().__init__()
        self._size = size if isinstance(size, (tuple, list)) else (size, size)
        self._pad = pad

    def forward(self, x):
        w, h = self._size
        data = x
        if self._pad:
            p = self._pad
            data = NDArray(F_.pad(x._data, (0, 0, p, p, p, p)))
        ih, iw = data.shape[-3], data.shape[-2]
        y0 = onp.random.randint(0, max(1, ih - h + 1))
        x0 = onp.random.randint(0, max(1, iw - w + 1))
        return _invoke(_crop, data, x=x0, y=y0, width=w, height=h)


class RandomBrightness(Block):
    def __init__(self, brightness):
        super().__init__()
        self._brightness = brightness

    def forward(self, x):
        alpha = 1.0 + onp.random.uniform(-self._brightness, self._brightness)
        return x * alpha


class RandomContrast(Block):
    def __init__(self, contrast):
        super().__init__()
        self._contrast = contrast

    def forward(self, x):
        alpha = 1.0 + onp.random.uniform(-self._contrast, self._contrast)
        gray = x.mean()
        return x * alpha + gray * (1 - alpha)


class RandomSaturation(Block):
    def __init__(self, saturation):
        super().__init__()
        self._saturation = saturation

    def forward(self, x):
        alpha = 1.0 + onp.random.uniform(-self._saturation, self._saturation)
        t = x._data
        coef = torch.tensor([[[0.299]], [[0.587]], [[0.114]]],
                            dtype=t.dtype, device=t.device)
        if x.ndim == 3 and x.shape[-1] == 3:
            coef = coef.reshape(1, 1, 3)
        gray = NDArray((t * coef).sum(dim=-1 if x.shape[-1] == 3 else 0,
                                      keepdim=True))
        return x * alpha + gray * (1 - alpha)


class RandomColorJitter(Sequential):
    def __init__(self, brightness=0, contrast=0, saturation=0, hue=0):
        super().__init__()
        with self.name_scope():
            if brightness:
                self.add(RandomBrightness(brightness))
            if contrast:
                self.add(RandomContrast(contrast))
            if saturation:
                self.add(RandomSaturation(saturation))
