"""Detection image iterator and augmenters (counterpart of
``mxnet_tpu/image/detection.py``; ref: python/mxnet/image/detection.py).

Labels follow the reference's packed format: per image [header_width,
object_width, (extra header...), obj0, obj1, ...], each object [class_id,
xmin, ymin, xmax, ymax, ...] with coordinates normalized to [0, 1].

The augmenters run on the host with numpy and draw from Python's
``random`` as the JAX package's do, so both packages make the same draws
from the same seed; the boxes move with the image (mirror, crop, pad).
``ImageDetIter`` yields (B, C, H, W) data and (B, max_objects,
object_width) labels padded with -1, both on the iterator's context (the
card by default).
"""
from __future__ import annotations

import random as pyrandom

import numpy as onp

from ..ndarray.ndarray import NDArray, array as _array
from .image import ImageIter, _nd_array, _to_np, fixed_crop

__all__ = ['DetAugmenter', 'DetBorrowAug', 'DetRandomSelectAug',
           'DetHorizontalFlipAug', 'DetRandomCropAug', 'DetRandomPadAug',
           'CreateDetAugmenter', 'ImageDetIter']


class DetAugmenter:
    """Detection augmenter: __call__(src, label) -> (src, label)
    (ref: detection.py DetAugmenter)."""

    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def __call__(self, src, label):
        raise NotImplementedError


class DetBorrowAug(DetAugmenter):
    """Wrap an image-only Augmenter for detection (ref: DetBorrowAug)."""

    def __init__(self, augmenter):
        super().__init__(augmenter=augmenter.__class__.__name__)
        self.augmenter = augmenter

    def __call__(self, src, label):
        return self.augmenter(src), label


class DetRandomSelectAug(DetAugmenter):
    """Randomly select one augmenter to apply (ref: DetRandomSelectAug)."""

    def __init__(self, aug_list, skip_prob=0.0):
        super().__init__(skip_prob=skip_prob)
        self.aug_list = aug_list
        self.skip_prob = skip_prob

    def __call__(self, src, label):
        if pyrandom.random() < self.skip_prob or not self.aug_list:
            return src, label
        return pyrandom.choice(self.aug_list)(src, label)


class DetHorizontalFlipAug(DetAugmenter):
    """Flip image and mirror box x-coords (ref: DetHorizontalFlipAug)."""

    def __init__(self, p):
        super().__init__(p=p)
        self.p = p

    def __call__(self, src, label):
        if pyrandom.random() < self.p:
            src = _nd_array(onp.ascontiguousarray(_to_np(src)[:, ::-1]))
            label = label.copy()
            tmp = 1.0 - label[:, 1]
            label[:, 1] = 1.0 - label[:, 3]
            label[:, 3] = tmp
        return src, label


class DetRandomCropAug(DetAugmenter):
    """SSD-style random crop constrained by min IOU with objects
    (ref: DetRandomCropAug)."""

    def __init__(self, min_object_covered=0.1, aspect_ratio_range=(0.75, 1.33),
                 area_range=(0.05, 1.0), min_eject_coverage=0.3,
                 max_attempts=50):
        super().__init__()
        self.min_object_covered = min_object_covered
        self.aspect_ratio_range = aspect_ratio_range
        self.area_range = area_range
        self.min_eject_coverage = min_eject_coverage
        self.max_attempts = max_attempts

    def __call__(self, src, label):
        arr = _to_np(src)
        h, w = arr.shape[:2]
        for _ in range(self.max_attempts):
            ratio = pyrandom.uniform(*self.aspect_ratio_range)
            area = pyrandom.uniform(*self.area_range)
            cw = min(1.0, onp.sqrt(area * ratio))
            ch = min(1.0, onp.sqrt(area / ratio))
            x0 = pyrandom.uniform(0, 1 - cw)
            y0 = pyrandom.uniform(0, 1 - ch)
            crop = onp.array([x0, y0, x0 + cw, y0 + ch])
            if label.shape[0]:
                # acceptance gate: every object the crop intersects must be
                # covered at least min_object_covered (reference semantics)
                ix = onp.maximum(0, onp.minimum(crop[2], label[:, 3])
                                 - onp.maximum(crop[0], label[:, 1]))
                iy = onp.maximum(0, onp.minimum(crop[3], label[:, 4])
                                 - onp.maximum(crop[1], label[:, 2]))
                obj_area = onp.maximum(
                    (label[:, 3] - label[:, 1]) * (label[:, 4] - label[:, 2]),
                    1e-12)
                coverage = (ix * iy) / obj_area
                touched = coverage > 0
                if not touched.any():
                    continue
                if coverage[touched].min() < self.min_object_covered:
                    continue
            new_label = self._update_labels(label, crop)
            if label.shape[0] and new_label.shape[0] == 0:
                continue
            px0, py0 = int(x0 * w), int(y0 * h)
            pw, ph = max(1, int(cw * w)), max(1, int(ch * h))
            out = fixed_crop(arr, px0, py0, pw, ph)
            return out, new_label
        return (src if isinstance(src, NDArray) else _nd_array(arr)), label

    def _update_labels(self, label, crop):
        if label.shape[0] == 0:
            return label
        x0, y0, x1, y1 = crop
        cw, ch = x1 - x0, y1 - y0
        out = label.copy()
        # clip boxes to crop, re-normalize to crop frame
        out[:, 1] = onp.clip((label[:, 1] - x0) / cw, 0, 1)
        out[:, 2] = onp.clip((label[:, 2] - y0) / ch, 0, 1)
        out[:, 3] = onp.clip((label[:, 3] - x0) / cw, 0, 1)
        out[:, 4] = onp.clip((label[:, 4] - y0) / ch, 0, 1)
        # eject boxes whose visible area in the crop is too small
        orig_area = onp.maximum(
            (label[:, 3] - label[:, 1]) * (label[:, 4] - label[:, 2]), 1e-12)
        new_area = (out[:, 3] - out[:, 1]) * (out[:, 4] - out[:, 2]) * cw * ch
        keep = (new_area / orig_area) >= self.min_eject_coverage
        keep &= (out[:, 3] > out[:, 1]) & (out[:, 4] > out[:, 2])
        return out[keep]


class DetRandomPadAug(DetAugmenter):
    """Random expand/pad with fill value, shrinking boxes
    (ref: DetRandomPadAug)."""

    def __init__(self, aspect_ratio_range=(0.75, 1.33), area_range=(1.0, 3.0),
                 max_attempts=50, pad_val=(127, 127, 127)):
        super().__init__()
        self.aspect_ratio_range = aspect_ratio_range
        self.area_range = area_range
        self.max_attempts = max_attempts
        self.pad_val = pad_val

    def __call__(self, src, label):
        arr = _to_np(src)
        h, w = arr.shape[:2]
        for _ in range(self.max_attempts):
            ratio = pyrandom.uniform(*self.aspect_ratio_range)
            area = pyrandom.uniform(*self.area_range)
            if area < 1.0:
                continue
            nw = int(w * onp.sqrt(area * ratio))
            nh = int(h * onp.sqrt(area / ratio))
            if nw < w or nh < h:
                continue
            x0 = pyrandom.randint(0, nw - w)
            y0 = pyrandom.randint(0, nh - h)
            out = onp.empty((nh, nw, arr.shape[2]), arr.dtype)
            out[...] = onp.asarray(self.pad_val, arr.dtype)[:arr.shape[2]]
            out[y0:y0 + h, x0:x0 + w] = arr
            new_label = label.copy()
            if label.shape[0]:
                new_label[:, 1] = (label[:, 1] * w + x0) / nw
                new_label[:, 2] = (label[:, 2] * h + y0) / nh
                new_label[:, 3] = (label[:, 3] * w + x0) / nw
                new_label[:, 4] = (label[:, 4] * h + y0) / nh
            return _nd_array(out), new_label
        return (src if isinstance(src, NDArray) else _nd_array(arr)), label


def CreateDetAugmenter(data_shape, resize=0, rand_crop=0, rand_pad=0,
                       rand_gray=0, rand_mirror=False, mean=None, std=None,
                       brightness=0, contrast=0, saturation=0, pca_noise=0,
                       hue=0, inter_method=2, min_object_covered=0.1,
                       aspect_ratio_range=(0.75, 1.33),
                       area_range=(0.05, 3.0), min_eject_coverage=0.3,
                       max_attempts=50, pad_val=(127, 127, 127)):
    """Build the standard detection augmenter list
    (ref: detection.py CreateDetAugmenter)."""
    from .image import (CastAug, ColorJitterAug, ColorNormalizeAug,
                        ForceResizeAug, HueJitterAug, LightingAug,
                        RandomGrayAug, ResizeAug)
    auglist = []
    if resize > 0:
        auglist.append(DetBorrowAug(ResizeAug(resize, inter_method)))
    if rand_crop > 0:
        crop_augs = [DetRandomCropAug(min_object_covered, aspect_ratio_range,
                                      (area_range[0], min(1.0, area_range[1])),
                                      min_eject_coverage, max_attempts)]
        auglist.append(DetRandomSelectAug(crop_augs, 1 - rand_crop))
    if rand_pad > 0:
        pad_aug = DetRandomPadAug(aspect_ratio_range,
                                  (1.0, max(1.0, area_range[1])),
                                  max_attempts, pad_val)
        auglist.append(DetRandomSelectAug([pad_aug], 1 - rand_pad))
    if rand_mirror:
        auglist.append(DetHorizontalFlipAug(0.5))
    auglist.append(DetBorrowAug(ForceResizeAug(
        (data_shape[2], data_shape[1]), inter_method)))
    auglist.append(DetBorrowAug(CastAug()))
    if brightness or contrast or saturation:
        auglist.append(DetBorrowAug(
            ColorJitterAug(brightness, contrast, saturation)))
    if hue:
        auglist.append(DetBorrowAug(HueJitterAug(hue)))
    if pca_noise > 0:
        eigval = onp.array([55.46, 4.794, 1.148])
        eigvec = onp.array([[-0.5675, 0.7192, 0.4009],
                            [-0.5808, -0.0045, -0.8140],
                            [-0.5836, -0.6948, 0.4203]])
        auglist.append(DetBorrowAug(LightingAug(pca_noise, eigval, eigvec)))
    if rand_gray > 0:
        auglist.append(DetBorrowAug(RandomGrayAug(rand_gray)))
    if mean is True:
        mean = onp.array([123.68, 116.28, 103.53])
    if std is True:
        std = onp.array([58.395, 57.12, 57.375])
    if mean is not None or std is not None:
        auglist.append(DetBorrowAug(ColorNormalizeAug(mean, std)))
    return auglist


class ImageDetIter(ImageIter):
    """Detection iterator: yields (NCHW data, padded [B, max_objs, obj_width]
    labels) (ref: detection.py ImageDetIter)."""

    def __init__(self, batch_size, data_shape, path_imgrec=None,
                 path_imglist=None, path_root='', path_imgidx=None,
                 shuffle=False, part_index=0, num_parts=1, aug_list=None,
                 imglist=None, object_width=5, max_objects=50,
                 dtype='float32', last_batch_handle='pad', **kwargs):
        aug_keys = ('resize', 'rand_crop', 'rand_pad', 'rand_gray',
                    'rand_mirror', 'mean', 'std', 'brightness', 'contrast',
                    'saturation', 'pca_noise', 'hue', 'inter_method',
                    'min_object_covered', 'aspect_ratio_range', 'area_range',
                    'min_eject_coverage', 'max_attempts', 'pad_val')
        ctx = kwargs.pop('ctx', None)
        unknown = set(kwargs) - set(aug_keys)
        if unknown:
            raise TypeError(
                f"ImageDetIter got unknown kwargs: {sorted(unknown)}")
        if aug_list is None:
            aug_list = CreateDetAugmenter(data_shape, **kwargs)
        self.object_width = object_width
        self.max_objects = max_objects
        super().__init__(batch_size, data_shape, label_width=1,
                         path_imgrec=path_imgrec, path_imglist=path_imglist,
                         path_root=path_root, path_imgidx=path_imgidx,
                         shuffle=shuffle, part_index=part_index,
                         num_parts=num_parts, aug_list=aug_list,
                         imglist=imglist, dtype=dtype,
                         last_batch_handle=last_batch_handle, ctx=ctx)
        from ..io.io import DataDesc
        self.provide_label = [DataDesc(
            'label', (batch_size, max_objects, object_width), onp.float32)]

    def _parse_label(self, label):
        """Decode the packed header format into an [N, object_width] array
        (ref: detection.py ImageDetIter._parse_label)."""
        raw = onp.asarray(label, onp.float32).reshape(-1)
        if raw.size < 2:
            return onp.zeros((0, self.object_width), onp.float32)
        header_width = int(raw[0])
        obj_width = int(raw[1])
        objs = raw[header_width:]
        n = objs.size // obj_width
        objs = objs[:n * obj_width].reshape(n, obj_width)
        return objs[:, :self.object_width].astype(onp.float32)

    def next(self):
        from ..io.io import DataBatch
        c, h, w = self.data_shape
        batch_data = onp.zeros((self.batch_size, c, h, w), self.dtype)
        batch_label = onp.full(
            (self.batch_size, self.max_objects, self.object_width), -1.0,
            onp.float32)
        i = 0
        try:
            while i < self.batch_size:
                label, img = self.next_sample()
                objs = self._parse_label(label)
                for aug in self.auglist:
                    img, objs = aug(img, objs)
                arr = _to_np(img)
                if arr.shape[:2] != (h, w):
                    raise ValueError(
                        f"augmented image shape {arr.shape[:2]} != "
                        f"data_shape {(h, w)}")
                batch_data[i] = arr.astype(self.dtype).transpose(2, 0, 1)
                n = min(objs.shape[0], self.max_objects)
                batch_label[i, :n] = objs[:n]
                i += 1
        except StopIteration:
            if i == 0 or self.last_batch_handle == 'discard':
                raise
        pad = self.batch_size - i
        return DataBatch(data=[_array(batch_data, self.ctx)],
                         label=[_array(batch_label, self.ctx)], pad=pad)
