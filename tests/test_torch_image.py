"""The port's ``image`` module against the JAX package's (mirrors the five
non-detection cases of tests/test_image.py).

Decode, resize and crop helpers, ``color_normalize``, every augmenter of
``CreateAugmenter`` and ``ImageIter`` (RecordIO with an index, and image
lists) run in both packages from the same Python and numpy seeds: the
augmenters draw from the same generators in the same order, so uint8
outputs and labels are bitwise equal and float outputs equal (both
compute in numpy). The two detection cases are in
tests/test_torch_image_det.py.
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
def rec_dataset(tmp_path_factory):
    tmp = tmp_path_factory.mktemp('imgs')
    rec = str(tmp / 'data.rec')
    idx = str(tmp / 'data.idx')
    rng = onp.random.RandomState(0)
    w = recordio.MXIndexedRecordIO(idx, rec, 'w')
    for i in range(10):
        img = (rng.rand(40, 50, 3) * 255).astype(onp.uint8)
        w.write_idx(i, recordio.pack_img((0, float(i % 3), i, 0), img))
    w.close()
    return rec, idx


def test_imdecode_imresize_roundtrip():
    img = (onp.random.RandomState(1).rand(24, 32, 3) * 255).astype(onp.uint8)
    buf = recordio.pack_img((0, 0.0, 0, 0), img, img_fmt='.png')
    _, payload = recordio.unpack(buf)
    dec = image.imdecode(payload)
    assert dec.shape == (24, 32, 3) and dec.context == CPU
    onp.testing.assert_array_equal(dec.asnumpy(), img)     # png: lossless
    jdec = jimage.imdecode(payload)
    for flag, rgb in ((1, True), (1, False), (0, True)):
        onp.testing.assert_array_equal(
            image.imdecode(payload, flag=flag, to_rgb=rgb).asnumpy(),
            jimage.imdecode(payload, flag=flag, to_rgb=rgb).asnumpy())
    for interp in (0, 1, 2, 4):
        small = image.imresize(dec, 16, 12, interp)
        assert small.shape == (12, 16, 3)
        onp.testing.assert_array_equal(
            small.asnumpy(), jimage.imresize(jdec, 16, 12, interp).asnumpy())
    # float data keeps its dtype (the interpolation is torch's)
    f = image.imresize(dec.asnumpy().astype(onp.float32), 16, 12)
    assert f.shape == (12, 16, 3) and f.dtype == onp.float32


def test_imread_matches(tmp_path):
    from PIL import Image
    img = (onp.random.RandomState(2).rand(9, 11, 3) * 255).astype(onp.uint8)
    path = str(tmp_path / 'a.png')
    Image.fromarray(img).save(path)
    onp.testing.assert_array_equal(image.imread(path).asnumpy(),
                                   jimage.imread(path).asnumpy())


def test_crop_helpers_match():
    arr = (onp.random.RandomState(3).rand(30, 40, 3) * 255).astype(onp.uint8)
    img, jimg = mx.nd.array(arr, ctx=CPU), jmx.nd.array(arr)
    out = image.resize_short(img, 20)
    assert min(out.shape[:2]) == 20
    onp.testing.assert_array_equal(out.asnumpy(),
                                   jimage.resize_short(jimg, 20).asnumpy())
    out, box = image.center_crop(img, (10, 12))
    jout, jbox = jimage.center_crop(jimg, (10, 12))
    assert out.shape == (12, 10, 3) and box == jbox
    onp.testing.assert_array_equal(out.asnumpy(), jout.asnumpy())
    for fn, args in ((image.random_crop, ((10, 10),)),
                     (image.random_size_crop, ((8, 8), (0.1, 1.0),
                                               (0.5, 2.0)))):
        jfn = getattr(jimage, fn.__name__)
        _seed(4)
        out, box = fn(img, *args)
        _seed(4)
        jout, jbox = jfn(jimg, *args)
        assert box == jbox
        onp.testing.assert_array_equal(out.asnumpy(), jout.asnumpy())
    assert out.shape == (8, 8, 3)
    assert image.scale_down((5, 5), (10, 10)) == (5, 5)
    onp.testing.assert_array_equal(
        image.fixed_crop(img, 2, 3, 7, 5).asnumpy(),
        jimage.fixed_crop(jimg, 2, 3, 7, 5).asnumpy())


def test_color_normalize_and_augmenters_draw_for_draw():
    img = onp.full((4, 4, 3), 100.0, onp.float32)
    out = image.color_normalize(mx.nd.array(img, ctx=CPU),
                                mx.nd.array([100.0] * 3, ctx=CPU),
                                mx.nd.array([2.0] * 3, ctx=CPU))
    onp.testing.assert_array_equal(out.asnumpy(), onp.zeros((4, 4, 3)))
    u8 = (onp.random.RandomState(5).rand(12, 14, 3) * 255).astype(onp.uint8)
    kw = dict(resize=10, rand_crop=True, rand_mirror=True, brightness=0.1,
              contrast=0.1, saturation=0.1, hue=0.1, pca_noise=0.1,
              rand_gray=0.5, mean=True, std=True)
    for rand_resize in (False, True):
        for s in range(4):
            _seed(s)
            x = mx.nd.array(u8, ctx=CPU)
            augs = image.CreateAugmenter((3, 8, 8), rand_resize=rand_resize,
                                         **kw)
            for aug in augs:
                x = aug(x)
            _seed(s)
            jx = jmx.nd.array(u8)
            jaugs = jimage.CreateAugmenter((3, 8, 8),
                                           rand_resize=rand_resize, **kw)
            for aug in jaugs:
                jx = aug(jx)
            assert [type(a).__name__ for a in augs] == \
                [type(a).__name__ for a in jaugs]
            assert [a.dumps() for a in augs if not isinstance(
                a, (image.LightingAug, image.ColorNormalizeAug,
                    image.RandomOrderAug))] == [a.dumps() for a in jaugs if
                                                not isinstance(a, (
                                                    jimage.LightingAug,
                                                    jimage.ColorNormalizeAug,
                                                    jimage.RandomOrderAug))]
            assert x.shape == (8, 8, 3) and str(x.dtype) == 'float32'
            onp.testing.assert_allclose(x.asnumpy(), jx.asnumpy(),
                                        rtol=1e-6, atol=1e-5)


def test_public_names_match():
    assert image.image.__all__ == jimage.image.__all__
    for name in jimage.image.__all__:
        assert hasattr(image, name), name


@pytest.mark.parametrize('shuffle', [False, True])
def test_image_iter_rec_matches_jax(rec_dataset, shuffle):
    rec, idx = rec_dataset
    out = []
    for mod, kw in ((image, {'ctx': CPU}), (jimage, {})):
        _seed(7)
        it = mod.ImageIter(batch_size=4, data_shape=(3, 32, 32),
                           path_imgrec=rec, path_imgidx=idx,
                           shuffle=shuffle, rand_crop=True,
                           rand_mirror=True, **kw)
        batches = list(it)
        it.reset()
        batches.append(next(it))
        out.append([(b.data[0].asnumpy(), b.label[0].asnumpy(), b.pad)
                    for b in batches])
    port, ref = out
    assert len(port) == len(ref) == 4
    assert port[0][0].shape == (4, 3, 32, 32) and port[0][1].shape == (4,)
    assert port[2][2] == 2       # 10 = 4 + 4 + 2, the tail wraps around
    for (a, la, pa), (b, lb, pb) in zip(port, ref):
        assert pa == pb
        onp.testing.assert_array_equal(a, b)
        onp.testing.assert_array_equal(la, lb)


def test_image_iter_sequential_rec_and_refusal(rec_dataset, tmp_path):
    rec, _ = rec_dataset
    import shutil
    plain = str(tmp_path / 'plain.rec')    # no .idx beside it
    shutil.copy(rec, plain)
    it = image.ImageIter(batch_size=3, data_shape=(3, 20, 20),
                         path_imgrec=plain, ctx=CPU,
                         last_batch_handle='discard')
    jt = jimage.ImageIter(batch_size=3, data_shape=(3, 20, 20),
                          path_imgrec=plain, last_batch_handle='discard')
    a, b = list(it), list(jt)
    assert len(a) == len(b) == 3
    for x, y in zip(a, b):
        onp.testing.assert_array_equal(x.data[0].asnumpy(),
                                       y.data[0].asnumpy())
    with pytest.raises(ValueError, match='require a .idx'):
        image.ImageIter(batch_size=3, data_shape=(3, 20, 20),
                        path_imgrec=plain, shuffle=True, ctx=CPU)
    with pytest.raises(TypeError, match='unknown kwargs'):
        image.ImageIter(batch_size=3, data_shape=(3, 20, 20),
                        path_imgrec=plain, bogus=1, ctx=CPU)


def test_image_iter_imglist_matches_jax(tmp_path):
    from PIL import Image
    fnames = []
    rng = onp.random.RandomState(6)
    for i in range(5):
        arr = (rng.rand(20, 20, 3) * 255).astype(onp.uint8)
        Image.fromarray(arr).save(str(tmp_path / f'im{i}.png'))
        fnames.append((float(i), f'im{i}.png'))
    lst = str(tmp_path / 'list.lst')
    with open(lst, 'w') as f:
        for i, (lab, name) in enumerate(fnames):
            f.write(f'{i}\t{lab}\t{name}\n')
    for src in ({'imglist': fnames}, {'path_imglist': lst}):
        it = image.ImageIter(batch_size=2, data_shape=(3, 16, 16),
                             path_root=str(tmp_path), ctx=CPU, **src)
        jt = jimage.ImageIter(batch_size=2, data_shape=(3, 16, 16),
                              path_root=str(tmp_path), **src)
        b = next(it)
        assert b.data[0].shape == (2, 3, 16, 16)
        assert b.label[0].asnumpy().tolist() == [0.0, 1.0]
        it.reset()
        for x, y in zip(it, jt):
            assert x.pad == y.pad
            onp.testing.assert_array_equal(x.data[0].asnumpy(),
                                           y.data[0].asnumpy())
            onp.testing.assert_array_equal(x.label[0].asnumpy(),
                                           y.label[0].asnumpy())


def test_image_iter_batches_land_on_its_context(rec_dataset):
    rec, idx = rec_dataset
    with mx.cpu():
        it = image.ImageIter(batch_size=4, data_shape=(3, 32, 32),
                             path_imgrec=rec, path_imgidx=idx)
    assert it.ctx == CPU
    assert next(it).data[0].context == CPU
