"""The port's detection augmenters and ``ImageDetIter``
(``image/detection.py``) against the JAX package's, on the CPU (mirrors
and extends the two detection cases of tests/test_image.py).

Both packages' augmenters draw from Python's ``random`` in the same
order, so from the same seed they make the same crops, pads and flips:
the boxes they return are compared exactly and the images bitwise (both
compute in numpy and PIL). ``ImageDetIter`` over one RecordIO file with
the random augmenters off gives the JAX iterator's batches: labels
exactly, data bitwise; with ``rand_crop``, ``rand_pad`` and ``rand_mirror``
on, the same batches from the same seed, every kept box inside [0, 1].
"""
import random as pyrandom

import numpy as onp
import pytest

import mxnet_tpu as jmx
from mxnet_tpu import image as jimage
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import image, recordio
from test_torch_jax_globals import jax_globals  # noqa: F401

CPU = mx.cpu()


def _seed(s):
    pyrandom.seed(s)
    onp.random.seed(s)


@pytest.fixture(scope='module')
def det_rec(tmp_path_factory):
    """8 images 60 x 60 with two boxes each (the reference test's), and
    4 images 48 x 64 with one to three boxes, packed with the port's
    ``recordio.pack_img``."""
    tmp = tmp_path_factory.mktemp('det')
    rec, idx = str(tmp / 'det.rec'), str(tmp / 'det.idx')
    w = recordio.MXIndexedRecordIO(idx, rec, 'w')
    rng = onp.random.RandomState(1)
    for i in range(12):
        if i < 8:
            img = (rng.rand(60, 60, 3) * 255).astype(onp.uint8)
            objs = [[1.0, 0.1, 0.1, 0.6, 0.6], [2.0, 0.3, 0.3, 0.9, 0.9]]
        else:
            img = (rng.rand(48, 64, 3) * 255).astype(onp.uint8)
            objs = []
            for _ in range(1 + i % 3):
                x0, y0 = rng.rand(2) * 0.6
                objs.append([float(rng.randint(3)), x0, y0,
                             x0 + 0.1 + rng.rand() * 0.3,
                             y0 + 0.1 + rng.rand() * 0.3])
        label = onp.array([2, 5] + sum(objs, []), onp.float32)
        w.write_idx(i, recordio.pack_img((0, label, i, 0), img))
    w.close()
    return rec, idx


def _batches(mod, rec, idx, seed, **kw):
    _seed(seed)
    it = mod.ImageDetIter(batch_size=4, data_shape=(3, 32, 32),
                          path_imgrec=rec, path_imgidx=idx, **kw)
    out = []
    for b in it:
        out.append((b.data[0].asnumpy(), b.label[0].asnumpy(), b.pad))
    return out


def test_det_iter_matches_jax_with_the_random_augmenters_off(det_rec):
    rec, idx = det_rec
    got = _batches(image, rec, idx, 0, ctx=CPU, max_objects=6)
    want = _batches(jimage, rec, idx, 0, max_objects=6)
    assert len(got) == len(want) == 3
    for (gd, gl, gp), (wd, wl, wp) in zip(got, want):
        assert gd.shape == (4, 3, 32, 32) and gl.shape == (4, 6, 5)
        onp.testing.assert_array_equal(gl, wl)
        onp.testing.assert_array_equal(gd, wd)
        assert gp == wp == 0


def test_det_iter_matches_jax_with_crop_pad_and_mirror(det_rec):
    rec, idx = det_rec
    kw = dict(rand_crop=0.5, rand_pad=0.5, rand_mirror=True, shuffle=True)
    got = _batches(image, rec, idx, 3, ctx=CPU, **kw)
    want = _batches(jimage, rec, idx, 3, **kw)
    for (gd, gl, _), (wd, wl, _) in zip(got, want):
        onp.testing.assert_array_equal(gl, wl)
        onp.testing.assert_array_equal(gd, wd)
    lab = onp.concatenate([g[1] for g in got])
    assert lab.shape[1:] == (50, 5)
    valid = lab[lab[:, :, 0] >= 0]
    assert len(valid) >= 12
    assert (valid[:, 1:5] >= -1e-5).all() and (valid[:, 1:5] <= 1 + 1e-5
                                               ).all()


def test_det_iter_puts_batches_on_its_context(det_rec):
    rec, idx = det_rec
    b = next(image.ImageDetIter(2, (3, 16, 16), path_imgrec=rec,
                                path_imgidx=idx, ctx=CPU))
    assert b.data[0].context == CPU and b.label[0].context == CPU
    assert b.label[0].shape == (2, 50, 5)
    with pytest.raises(TypeError, match='unknown kwargs'):
        image.ImageDetIter(2, (3, 16, 16), path_imgrec=rec, ctx=CPU,
                           rand_resize=True)


def _img(seed, h=40, w=50):
    return (onp.random.RandomState(seed).rand(h, w, 3) * 255).astype(
        onp.uint8)


LABEL = onp.array([[1.0, 0.1, 0.2, 0.4, 0.6], [0.0, 0.5, 0.1, 0.95, 0.5],
                   [2.0, 0.3, 0.6, 0.45, 0.9]], onp.float32)


def _apply(mod, make, seed, img, label):
    _seed(seed)
    src = (mx if mod is image else jmx).nd.array(img, **(
        {'ctx': CPU} if mod is image else {}))
    out, lab = make(mod)(src, label)
    return (out.asnumpy() if hasattr(out, 'asnumpy') else onp.asarray(out),
            lab)


AUGS = {
    'flip': lambda m: m.DetHorizontalFlipAug(0.5),
    'crop': lambda m: m.DetRandomCropAug(min_object_covered=0.3),
    'crop_strict': lambda m: m.DetRandomCropAug(
        min_object_covered=0.9, area_range=(0.3, 0.8),
        min_eject_coverage=0.6),
    'pad': lambda m: m.DetRandomPadAug(area_range=(1.0, 2.5)),
    'select': lambda m: m.DetRandomSelectAug(
        [m.DetRandomCropAug(), m.DetRandomPadAug()], skip_prob=0.3),
}


@pytest.mark.parametrize('name', sorted(AUGS))
def test_det_augmenter_box_arithmetic_matches_jax(name):
    for seed in range(6):
        img = _img(seed)
        got = _apply(image, AUGS[name], seed, img, LABEL)
        want = _apply(jimage, AUGS[name], seed, img, LABEL)
        onp.testing.assert_array_equal(got[1], want[1])
        onp.testing.assert_array_equal(got[0], want[0])


def test_det_flip_mirrors_boxes():
    img = mx.nd.array(_img(0, 10, 10), ctx=CPU)
    label = onp.array([[1.0, 0.1, 0.2, 0.4, 0.6]], onp.float32)
    _, out = image.DetHorizontalFlipAug(p=1.1)(img, label)
    onp.testing.assert_allclose(out, [[1.0, 0.6, 0.2, 0.9, 0.6]], rtol=1e-6)


def test_pad_shrinks_boxes_into_the_canvas():
    _seed(5)
    img = mx.nd.array(_img(1), ctx=CPU)
    out, lab = image.DetRandomPadAug(area_range=(2.0, 3.0))(img, LABEL)
    h, w = out.shape[:2]
    assert h >= 40 and w >= 50 and (h, w) != (40, 50)
    widths = (lab[:, 3] - lab[:, 1]) * w
    onp.testing.assert_allclose(widths, (LABEL[:, 3] - LABEL[:, 1]) * 50,
                                rtol=1e-5)


def test_create_det_augmenter_matches_jax():
    kw = dict(resize=40, rand_crop=0.5, rand_pad=0.5, rand_mirror=True,
              mean=True, std=True, brightness=0.1, hue=0.1, pca_noise=0.1,
              rand_gray=0.2)
    got = [type(a).__name__ for a in image.CreateDetAugmenter((3, 32, 32),
                                                              **kw)]
    want = [type(a).__name__ for a in jimage.CreateDetAugmenter((3, 32, 32),
                                                                **kw)]
    assert got == want
    inner = [type(a.augmenter).__name__ for a in
             image.CreateDetAugmenter((3, 32, 32), **kw)
             if isinstance(a, image.DetBorrowAug)]
    assert inner == [type(a.augmenter).__name__ for a in
                     jimage.CreateDetAugmenter((3, 32, 32), **kw)
                     if isinstance(a, jimage.DetBorrowAug)]
    # the whole chain on one image, from one seed, in both packages
    for seed in range(3):
        outs = []
        for mod, nd_mod in ((image, mx), (jimage, jmx)):
            _seed(seed)
            src = nd_mod.nd.array(_img(seed), **({'ctx': CPU}
                                                 if mod is image else {}))
            lab = LABEL
            for aug in mod.CreateDetAugmenter((3, 32, 32), **kw):
                src, lab = aug(src, lab)
            outs.append((src.asnumpy(), lab))
        onp.testing.assert_array_equal(outs[0][1], outs[1][1])
        onp.testing.assert_allclose(outs[0][0], outs[1][0], rtol=1e-6,
                                    atol=1e-6)
