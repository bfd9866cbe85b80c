"""Image IO + augmentation pipeline (counterpart of
``mxnet_tpu/image/image.py``; ref: python/mxnet/image/image.py).

Decode and augmentation run on the host, with PIL and numpy, as in the
JAX package: augmentation is branchy, per-image and shape-changing. The
random augmenters draw from Python's ``random`` and numpy's global
generator exactly as the JAX package's do, so both packages make the same
draws from the same seeds. The helpers return host NDArrays (the CPU
context: an augmenter chain stays on the host); ``ImageIter`` puts each
batch on its context, the card by default, as one contiguous array.

Augmenter classes keep the reference's names and call signature
(`aug(src) -> NDArray` with HWC float32 data); the detection augmenters
and ``ImageDetIter`` are in ``image/detection.py``.
"""
from __future__ import annotations

import io as _pyio
import os
import random as pyrandom

import numpy as onp

from ..context import cpu as _cpu, current_context
from ..ndarray.ndarray import NDArray, array as _array


def _nd_array(a):
    return _array(a, _cpu())

__all__ = [
    'imread', 'imdecode', 'imresize', 'scale_down', 'resize_short',
    'fixed_crop', 'random_crop', 'center_crop', 'random_size_crop',
    'color_normalize',
    'Augmenter', 'SequentialAug', 'RandomOrderAug', 'CastAug', 'ResizeAug',
    'ForceResizeAug', 'RandomCropAug', 'RandomSizedCropAug', 'CenterCropAug',
    'BrightnessJitterAug', 'ContrastJitterAug', 'SaturationJitterAug',
    'HueJitterAug', 'ColorJitterAug', 'LightingAug', 'ColorNormalizeAug',
    'RandomGrayAug', 'HorizontalFlipAug', 'CreateAugmenter', 'ImageIter',
]


def _to_np(img):
    if isinstance(img, NDArray):
        return img.asnumpy()
    return onp.asarray(img)


def imdecode(buf, flag=1, to_rgb=True, **kwargs):
    """Decode an image byte buffer to an HWC NDArray
    (ref: python/mxnet/image/image.py imdecode; decode backend is PIL
    instead of OpenCV)."""
    from PIL import Image
    if isinstance(buf, NDArray):
        buf = buf.asnumpy().tobytes()
    img = Image.open(_pyio.BytesIO(bytes(buf)))
    if flag == 0:
        img = img.convert('L')
        arr = onp.asarray(img)[:, :, None]
    else:
        img = img.convert('RGB')
        arr = onp.asarray(img)
        if not to_rgb:
            arr = arr[:, :, ::-1]
    return _nd_array(onp.ascontiguousarray(arr))


def imread(filename, flag=1, to_rgb=True, **kwargs):
    """Read an image file into an HWC NDArray (ref: image.py imread)."""
    with open(filename, 'rb') as f:
        return imdecode(f.read(), flag=flag, to_rgb=to_rgb)


def imresize(src, w, h, interp=1):
    """Resize to (w, h), preserving dtype (ref: image.py imresize)."""
    arr = _to_np(src)
    if arr.dtype == onp.uint8:
        from PIL import Image
        squeeze = arr.shape[2] == 1
        mode_arr = arr[:, :, 0] if squeeze else arr
        resample = {0: Image.NEAREST, 1: Image.BILINEAR, 2: Image.BICUBIC,
                    3: Image.NEAREST, 4: Image.LANCZOS}.get(
                        interp, Image.BILINEAR)
        out = onp.asarray(Image.fromarray(mode_arr).resize((w, h), resample))
        if squeeze:
            out = out[:, :, None]
        return _nd_array(out)
    # float data: interpolate without quantizing (reference cv2.resize
    # keeps dtype); torch's antialiased interpolation stands in for
    # jax.image.resize
    import torch
    import torch.nn.functional as F
    mode = {0: 'nearest', 1: 'bilinear', 2: 'bicubic', 3: 'nearest',
            4: 'bicubic'}.get(interp, 'bilinear')
    t = torch.from_numpy(onp.ascontiguousarray(arr, onp.float32))
    t = t.permute(2, 0, 1)[None]
    kw = {} if mode == 'nearest' else dict(align_corners=False,
                                           antialias=True)
    out = F.interpolate(t, size=(h, w), mode=mode, **kw)[0].permute(1, 2, 0)
    return _nd_array(out.numpy().astype(arr.dtype, copy=False))


def scale_down(src_size, size):
    """Scale target size down so a crop fits inside src (ref: scale_down)."""
    w, h = size
    sw, sh = src_size
    if sh < h:
        w, h = float(w * sh) / h, sh
    if sw < w:
        w, h = sw, float(h * sw) / w
    return int(w), int(h)


def resize_short(src, size, interp=2):
    """Resize so the shorter edge == size, keeping aspect (ref: resize_short)."""
    arr = _to_np(src)
    h, w = arr.shape[:2]
    if h > w:
        new_w, new_h = size, int(h * size / w)
    else:
        new_w, new_h = int(w * size / h), size
    return imresize(arr, new_w, new_h, interp)


def fixed_crop(src, x0, y0, w, h, size=None, interp=2):
    """Crop at (x0, y0, w, h), optionally resizing to `size` (ref: fixed_crop)."""
    arr = _to_np(src)
    out = arr[y0:y0 + h, x0:x0 + w]
    if size is not None and (w, h) != size:
        return imresize(out, size[0], size[1], interp)
    return _nd_array(onp.ascontiguousarray(out))


def random_crop(src, size, interp=2):
    """Random crop of `size`, scaled down to fit (ref: random_crop)."""
    arr = _to_np(src)
    h, w = arr.shape[:2]
    new_w, new_h = scale_down((w, h), size)
    x0 = pyrandom.randint(0, w - new_w)
    y0 = pyrandom.randint(0, h - new_h)
    out = fixed_crop(arr, x0, y0, new_w, new_h, size, interp)
    return out, (x0, y0, new_w, new_h)


def center_crop(src, size, interp=2):
    """Center crop of `size` (ref: center_crop)."""
    arr = _to_np(src)
    h, w = arr.shape[:2]
    new_w, new_h = scale_down((w, h), size)
    x0 = (w - new_w) // 2
    y0 = (h - new_h) // 2
    out = fixed_crop(arr, x0, y0, new_w, new_h, size, interp)
    return out, (x0, y0, new_w, new_h)


def random_size_crop(src, size, area, ratio, interp=2, **kwargs):
    """Random crop with area/aspect jitter, as in Inception training
    (ref: random_size_crop)."""
    arr = _to_np(src)
    h, w = arr.shape[:2]
    src_area = h * w
    if 'min_area' in kwargs:
        area = (kwargs.pop('min_area'), 1.0)
    if not isinstance(area, (tuple, list)):
        area = (area, 1.0)

    for _ in range(10):
        target_area = pyrandom.uniform(area[0], area[1]) * src_area
        log_ratio = (onp.log(ratio[0]), onp.log(ratio[1]))
        new_ratio = onp.exp(pyrandom.uniform(*log_ratio))
        new_w = int(round(onp.sqrt(target_area * new_ratio)))
        new_h = int(round(onp.sqrt(target_area / new_ratio)))
        if new_w <= w and new_h <= h:
            x0 = pyrandom.randint(0, w - new_w)
            y0 = pyrandom.randint(0, h - new_h)
            out = fixed_crop(arr, x0, y0, new_w, new_h, size, interp)
            return out, (x0, y0, new_w, new_h)
    return center_crop(arr, size, interp)


def color_normalize(src, mean, std=None):
    """(src - mean) / std on HWC float data (ref: color_normalize)."""
    arr = _to_np(src).astype(onp.float32)
    mean = _to_np(mean) if mean is not None else None
    std = _to_np(std) if std is not None else None
    if mean is not None:
        arr = arr - mean
    if std is not None:
        arr = arr / std
    return _nd_array(arr)


class Augmenter:
    """Image augmenter base (ref: image.py Augmenter)."""

    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def dumps(self):
        import json
        return json.dumps([self.__class__.__name__.lower(), self._kwargs])

    def __call__(self, src):
        raise NotImplementedError


class SequentialAug(Augmenter):
    def __init__(self, ts):
        super().__init__()
        self.ts = ts

    def __call__(self, src):
        for t in self.ts:
            src = t(src)
        return src


class RandomOrderAug(Augmenter):
    def __init__(self, ts):
        super().__init__()
        self.ts = ts

    def __call__(self, src):
        ts = list(self.ts)
        pyrandom.shuffle(ts)
        for t in ts:
            src = t(src)
        return src


class CastAug(Augmenter):
    def __init__(self, typ='float32'):
        super().__init__(type=typ)
        self.typ = typ

    def __call__(self, src):
        return _nd_array(_to_np(src).astype(self.typ))


class ResizeAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size = size
        self.interp = interp

    def __call__(self, src):
        return resize_short(src, self.size, self.interp)


class ForceResizeAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size = size
        self.interp = interp

    def __call__(self, src):
        return imresize(src, self.size[0], self.size[1], self.interp)


class RandomCropAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size = size
        self.interp = interp

    def __call__(self, src):
        return random_crop(src, self.size, self.interp)[0]


class RandomSizedCropAug(Augmenter):
    def __init__(self, size, area, ratio, interp=2, **kwargs):
        super().__init__(size=size, area=area, ratio=ratio, interp=interp)
        self.size = size
        self.area = area
        self.ratio = ratio
        self.interp = interp

    def __call__(self, src):
        return random_size_crop(src, self.size, self.area, self.ratio,
                                self.interp)[0]


class CenterCropAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size = size
        self.interp = interp

    def __call__(self, src):
        return center_crop(src, self.size, self.interp)[0]


class BrightnessJitterAug(Augmenter):
    def __init__(self, brightness):
        super().__init__(brightness=brightness)
        self.brightness = brightness

    def __call__(self, src):
        alpha = 1.0 + pyrandom.uniform(-self.brightness, self.brightness)
        return _nd_array(_to_np(src).astype(onp.float32) * alpha)


class ContrastJitterAug(Augmenter):
    _coef = onp.array([[[0.299, 0.587, 0.114]]], onp.float32)

    def __init__(self, contrast):
        super().__init__(contrast=contrast)
        self.contrast = contrast

    def __call__(self, src):
        arr = _to_np(src).astype(onp.float32)
        alpha = 1.0 + pyrandom.uniform(-self.contrast, self.contrast)
        gray = (arr * self._coef[..., :arr.shape[2]]).sum() * (
            3.0 / arr.size)
        return _nd_array(arr * alpha + gray * (1.0 - alpha))


class SaturationJitterAug(Augmenter):
    _coef = onp.array([[[0.299, 0.587, 0.114]]], onp.float32)

    def __init__(self, saturation):
        super().__init__(saturation=saturation)
        self.saturation = saturation

    def __call__(self, src):
        arr = _to_np(src).astype(onp.float32)
        alpha = 1.0 + pyrandom.uniform(-self.saturation, self.saturation)
        gray = (arr * self._coef).sum(axis=2, keepdims=True)
        return _nd_array(arr * alpha + gray * (1.0 - alpha))


class HueJitterAug(Augmenter):
    """Hue jitter in YIQ space (ref: image.py HueJitterAug)."""
    _tyiq = onp.array([[0.299, 0.587, 0.114],
                       [0.596, -0.274, -0.321],
                       [0.211, -0.523, 0.311]], onp.float32)
    _ityiq = onp.array([[1.0, 0.956, 0.621],
                        [1.0, -0.272, -0.647],
                        [1.0, -1.107, 1.705]], onp.float32)

    def __init__(self, hue):
        super().__init__(hue=hue)
        self.hue = hue

    def __call__(self, src):
        arr = _to_np(src).astype(onp.float32)
        alpha = pyrandom.uniform(-self.hue, self.hue)
        u = onp.cos(alpha * onp.pi)
        w = onp.sin(alpha * onp.pi)
        bt = onp.array([[1.0, 0.0, 0.0],
                        [0.0, u, -w],
                        [0.0, w, u]], onp.float32)
        t = onp.dot(onp.dot(self._ityiq, bt), self._tyiq).T
        return _nd_array(onp.dot(arr, t))


class ColorJitterAug(RandomOrderAug):
    def __init__(self, brightness, contrast, saturation):
        ts = []
        if brightness > 0:
            ts.append(BrightnessJitterAug(brightness))
        if contrast > 0:
            ts.append(ContrastJitterAug(contrast))
        if saturation > 0:
            ts.append(SaturationJitterAug(saturation))
        super().__init__(ts)


class LightingAug(Augmenter):
    """PCA-based lighting jitter (AlexNet-style) (ref: LightingAug)."""

    def __init__(self, alphastd, eigval, eigvec):
        super().__init__(alphastd=alphastd)
        self.alphastd = alphastd
        self.eigval = _to_np(eigval)
        self.eigvec = _to_np(eigvec)

    def __call__(self, src):
        arr = _to_np(src).astype(onp.float32)
        alpha = onp.random.normal(0, self.alphastd, size=(3,))
        rgb = onp.dot(self.eigvec * alpha, self.eigval)
        return _nd_array(arr + rgb)


class ColorNormalizeAug(Augmenter):
    def __init__(self, mean, std):
        super().__init__()
        self.mean = _to_np(mean) if mean is not None else None
        self.std = _to_np(std) if std is not None else None

    def __call__(self, src):
        return color_normalize(src, self.mean, self.std)


class RandomGrayAug(Augmenter):
    _coef = onp.array([[[0.299, 0.587, 0.114]]], onp.float32)

    def __init__(self, p):
        super().__init__(p=p)
        self.p = p

    def __call__(self, src):
        if pyrandom.random() < self.p:
            arr = _to_np(src).astype(onp.float32)
            gray = (arr * self._coef).sum(axis=2, keepdims=True)
            return _nd_array(onp.broadcast_to(gray, arr.shape).copy())
        return src if isinstance(src, NDArray) else _nd_array(src)


class HorizontalFlipAug(Augmenter):
    def __init__(self, p):
        super().__init__(p=p)
        self.p = p

    def __call__(self, src):
        if pyrandom.random() < self.p:
            return _nd_array(onp.ascontiguousarray(_to_np(src)[:, ::-1]))
        return src if isinstance(src, NDArray) else _nd_array(src)


def CreateAugmenter(data_shape, resize=0, rand_crop=False, rand_resize=False,
                    rand_mirror=False, mean=None, std=None, brightness=0,
                    contrast=0, saturation=0, hue=0, pca_noise=0,
                    rand_gray=0, inter_method=2):
    """Build the standard augmenter list (ref: image.py CreateAugmenter)."""
    auglist = []
    if resize > 0:
        auglist.append(ResizeAug(resize, inter_method))
    crop_size = (data_shape[2], data_shape[1])
    if rand_resize:
        assert rand_crop
        auglist.append(RandomSizedCropAug(crop_size, (0.08, 1.0),
                                          (3.0 / 4.0, 4.0 / 3.0),
                                          inter_method))
    elif rand_crop:
        auglist.append(RandomCropAug(crop_size, inter_method))
    else:
        auglist.append(CenterCropAug(crop_size, inter_method))
    if rand_mirror:
        auglist.append(HorizontalFlipAug(0.5))
    auglist.append(CastAug())
    if brightness or contrast or saturation:
        auglist.append(ColorJitterAug(brightness, contrast, saturation))
    if hue:
        auglist.append(HueJitterAug(hue))
    if pca_noise > 0:
        eigval = onp.array([55.46, 4.794, 1.148])
        eigvec = onp.array([[-0.5675, 0.7192, 0.4009],
                            [-0.5808, -0.0045, -0.8140],
                            [-0.5836, -0.6948, 0.4203]])
        auglist.append(LightingAug(pca_noise, eigval, eigvec))
    if rand_gray > 0:
        auglist.append(RandomGrayAug(rand_gray))
    if mean is True:
        mean = onp.array([123.68, 116.28, 103.53])
    if std is True:
        std = onp.array([58.395, 57.12, 57.375])
    if mean is not None or std is not None:
        auglist.append(ColorNormalizeAug(mean, std))
    return auglist


class ImageIter:
    """Image data iterator over RecordIO packs or image lists with python
    augmenters (ref: python/mxnet/image/image.py ImageIter). Yields
    `DataBatch` of NCHW float32 data.
    """

    def __init__(self, batch_size, data_shape, label_width=1,
                 path_imgrec=None, path_imglist=None, path_root='',
                 path_imgidx=None, shuffle=False, part_index=0, num_parts=1,
                 aug_list=None, imglist=None, dtype='float32',
                 last_batch_handle='pad', **kwargs):
        from ..io.io import DataDesc
        self.ctx = kwargs.pop('ctx', None) or current_context()
        assert len(data_shape) == 3 and data_shape[0] in (1, 3)
        self.batch_size = batch_size
        self.data_shape = tuple(data_shape)
        self.label_width = label_width
        self.path_root = path_root
        self.shuffle = shuffle
        self.dtype = dtype
        self.last_batch_handle = last_batch_handle

        self.imgrec = None
        self.imglist = None
        self.seq = None
        if path_imgrec:
            from ..recordio import MXIndexedRecordIO, MXRecordIO
            if path_imgidx is None:
                guess = os.path.splitext(path_imgrec)[0] + '.idx'
                path_imgidx = guess if os.path.exists(guess) else None
            if path_imgidx:
                self.imgrec = MXIndexedRecordIO(path_imgidx, path_imgrec, 'r')
                self.seq = list(self.imgrec.keys)
            else:
                if shuffle or num_parts > 1:
                    raise ValueError(
                        "shuffle/num_parts on a .rec file require a .idx "
                        "index (pass path_imgidx); sequential readers "
                        "cannot shuffle or shard")
                self.imgrec = MXRecordIO(path_imgrec, 'r')
        elif path_imglist:
            imglist_d = {}
            with open(path_imglist) as fin:
                for line in fin:
                    parts = line.strip().split('\t')
                    label = onp.array(parts[1:-1], dtype=onp.float32)
                    imglist_d[int(parts[0])] = (label, parts[-1])
            self.imglist = imglist_d
            self.seq = sorted(imglist_d.keys())
        elif imglist is not None:
            imglist_d = {}
            for i, item in enumerate(imglist):
                label = onp.array(item[0], dtype=onp.float32).reshape(-1)
                imglist_d[i] = (label, item[1])
            self.imglist = imglist_d
            self.seq = sorted(imglist_d.keys())
        else:
            raise ValueError(
                "ImageIter needs path_imgrec, path_imglist, or imglist")

        if self.seq is not None and num_parts > 1:
            n = len(self.seq) // num_parts
            self.seq = self.seq[part_index * n:(part_index + 1) * n]

        aug_keys = ('resize', 'rand_crop', 'rand_resize', 'rand_mirror',
                    'mean', 'std', 'brightness', 'contrast', 'saturation',
                    'hue', 'pca_noise', 'rand_gray', 'inter_method')
        unknown = set(kwargs) - set(aug_keys)
        if unknown:
            raise TypeError(f"ImageIter got unknown kwargs: {sorted(unknown)}")
        if aug_list is None:
            aug_list = CreateAugmenter(data_shape, **kwargs)
        self.auglist = aug_list

        label_shape = (batch_size,) if label_width == 1 \
            else (batch_size, label_width)
        self.provide_data = [DataDesc('data',
                                      (batch_size,) + self.data_shape, dtype)]
        self.provide_label = [DataDesc('softmax_label', label_shape,
                                       onp.float32)]
        self._cursor = 0
        self.reset()

    def reset(self):
        if self.shuffle and self.seq is not None:
            pyrandom.shuffle(self.seq)
        if self.imgrec is not None and self.seq is None:
            self.imgrec.reset()
        self._cursor = 0
        self._exhausted = False

    def next_sample(self):
        """Returns (label, decoded HWC image array)."""
        from ..recordio import unpack
        if self.seq is not None:
            if self._cursor >= len(self.seq):
                raise StopIteration
            idx = self.seq[self._cursor]
            self._cursor += 1
            if self.imgrec is not None:
                header, img_bytes = unpack(self.imgrec.read_idx(idx))
                label = header.label
                return label, imdecode(img_bytes)
            label, fname = self.imglist[idx]
            return label, imread(os.path.join(self.path_root, fname))
        s = self.imgrec.read()
        if s is None:
            raise StopIteration
        header, img_bytes = unpack(s)
        return header.label, imdecode(img_bytes)

    def next(self):
        from ..io.io import DataBatch
        if getattr(self, '_exhausted', False):
            # the previous batch consumed the tail and pad-wrapped; the
            # epoch is over even though the cursor sits mid-sequence
            self._exhausted = False
            raise StopIteration
        c, h, w = self.data_shape
        batch_data = onp.zeros((self.batch_size, c, h, w), self.dtype)
        batch_label = onp.zeros((self.batch_size, self.label_width),
                                onp.float32)
        i = 0
        try:
            while i < self.batch_size:
                label, img = self.next_sample()
                for aug in self.auglist:
                    img = aug(img)
                arr = _to_np(img)
                if arr.shape[:2] != (h, w):
                    raise ValueError(
                        f"augmented image shape {arr.shape[:2]} != "
                        f"data_shape {(h, w)}; add a crop/resize augmenter")
                batch_data[i] = arr.astype(self.dtype).transpose(2, 0, 1)
                label = onp.asarray(label, onp.float32).reshape(-1)
                batch_label[i, :self.label_width] = label[:self.label_width]
                i += 1
        except StopIteration:
            if i == 0:
                raise
            if self.last_batch_handle == 'discard':
                raise
        pad = self.batch_size - i
        if pad and self.last_batch_handle == 'pad':
            # reference semantics: the padded tail wraps around with real
            # samples from the start of the (re-shuffled) sequence, so
            # consumers that ignore DataBatch.pad never see fabricated
            # zero-image/label-0 rows. Datasets smaller than the pad wrap
            # repeatedly.
            self.reset()
            start_i = i
            while i < self.batch_size:
                try:
                    label, img = self.next_sample()
                except StopIteration:
                    if i == start_i:  # empty dataset: cannot pad
                        break
                    self.reset()
                    start_i = i
                    continue
                for aug in self.auglist:
                    img = aug(img)
                arr = _to_np(img)
                batch_data[i] = arr.astype(self.dtype).transpose(2, 0, 1)
                label = onp.asarray(label, onp.float32).reshape(-1)
                batch_label[i, :self.label_width] = label[:self.label_width]
                i += 1
            self._exhausted = True
        if self.label_width == 1:
            batch_label = batch_label[:, 0]
        return DataBatch(data=[_array(batch_data, self.ctx)],
                         label=[_array(batch_label, self.ctx)], pad=pad)

    def __next__(self):
        return self.next()

    def __iter__(self):
        return self
