"""The port's ImageRecordIter over the native decode runtime and the PIL
path, against the JAX package's (mirrors tests/test_io_native.py).

Every case of tests/test_io_native.py runs on the port with
``ctx=mx.cpu()``; the parity cases run both packages on the same .rec
file and the same seed and hold the batches and labels bitwise equal:
the native path (u8 lease and f32 copy-out), the PIL path (u8 and f32,
shuffle drawn from numpy's global generator), a partial last batch with
zeroed pad rows, multi-label records, and the decode cache. Each test
writes at most 64 small JPEGs to ``tmp_path``.
"""
import ctypes
import io as pyio
import os

import numpy as onp
import pytest

import mxnet_tpu as jmx
from mxnet_tpu import recordio as jrec
from mxnet_tpu.io import io as jio_mod
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import recordio, telemetry
from mxnet_tpu_torch.io import io as io_mod
from mxnet_tpu_torch.io import DevicePrefetchIter, ImageRecordIter
from test_torch_jax_globals import jax_globals  # noqa: F401

CPU = mx.cpu()
MEANSTD = dict(mean_r=123.68, mean_g=116.78, mean_b=103.94,
               std_r=58.4, std_g=57.1, std_b=57.4)


def _write_rec(tmp_path, n=32, size=(32, 24), label_width=1, name='data'):
    """A small JPEG .rec written by the port; returns (path, labels)."""
    from PIL import Image
    rec_path = str(tmp_path / f"{name}.rec")
    rec = recordio.MXRecordIO(rec_path, 'w')
    rng = onp.random.RandomState(7)
    labels = []
    for i in range(n):
        img = (rng.rand(size[0], size[1], 3) * 255).astype(onp.uint8)
        buf = pyio.BytesIO()
        Image.fromarray(img).save(buf, format='JPEG', quality=95)
        if label_width == 1:
            header = recordio.IRHeader(0, float(i % 10), i, 0)
            labels.append(float(i % 10))
        else:
            lab = onp.arange(label_width, dtype=onp.float32) + i
            header = recordio.IRHeader(label_width, lab, i, 0)
            labels.append(lab)
        rec.write(recordio.pack(header, buf.getvalue()))
    rec.close()
    return rec_path, labels


def _force_fallback(mp, *mods):
    for m in mods:
        mp.setattr(m._NativePipeline, 'try_create',
                   classmethod(lambda cls, *a, **k: None))


def _epoch(it):
    return [(b.data[0].asnumpy(), b.label[0].asnumpy(), b.pad) for b in it]


def _same(a, b, maxulp=0):
    """Batches and labels bitwise equal; with ``maxulp``, float data
    within that many float32 ulps (the named case below)."""
    assert len(a) == len(b)
    for (da, la, pa), (db, lb, pb) in zip(a, b):
        assert pa == pb
        assert da.dtype == db.dtype and da.shape == db.shape
        if maxulp:
            onp.testing.assert_array_max_ulp(da, db, maxulp=maxulp)
        else:
            onp.testing.assert_array_equal(da, db)
        onp.testing.assert_array_equal(la, lb)


def test_native_lib_loads():
    from mxnet_tpu_torch import _native
    assert _native.native_available(), _native.build_error()


@pytest.mark.parametrize('native', [True, False])
@pytest.mark.parametrize('transport', ['u8', 'f32'])
def test_batches_match_jax(tmp_path, monkeypatch, native, transport):
    """Same .rec, same seed: bitwise equal batches and labels, with
    shuffle, random crop, mirror, resize and a partial last batch. The
    native pipeline draws its crops from one generator per decode thread
    (seeded by the thread's index, as in the reference), so which batch
    a thread takes changes the draws: one thread makes them repeatable."""
    rec_path, _ = _write_rec(tmp_path, n=22, size=(40, 36))
    kw = dict(path_imgrec=rec_path, data_shape=(3, 24, 24), batch_size=8,
              shuffle=True, rand_crop=True, rand_mirror=True, resize=30,
              seed=5, transport=transport,
              preprocess_threads=1 if native else 2, **MEANSTD)
    with monkeypatch.context() as mp:
        if not native:
            _force_fallback(mp, jio_mod, io_mod)
        onp.random.seed(3)
        j = jmx.io.ImageRecordIter(**kw)
        a = [_epoch(j)]
        j.reset()
        a.append(_epoch(j))
        onp.random.seed(3)
        p = ImageRecordIter(ctx=CPU, **kw)
        assert p.native == native
        b = [_epoch(p)]
        p.reset()
        b.append(_epoch(p))
    # the one named case off bitwise: the PIL path's f32 transport, where
    # the JAX package divides by std on the host and the port multiplies
    # by the reciprocal, as both native runtimes and both u8 normalizes do
    # (at most one float32 ulp)
    maxulp = 1 if (not native and transport == 'f32') else 0
    for ea, eb in zip(a, b):
        _same(ea, eb, maxulp)
    assert [x[2] for x in b[0]] == [0, 0, 2]
    assert b[0][-1][0][6:].max() == 0.0 and b[0][-1][0][6:].min() == 0.0


def test_bfloat16_batches_match_jax(tmp_path):
    import torch
    rec_path, _ = _write_rec(tmp_path, n=10, size=(20, 20))
    kw = dict(path_imgrec=rec_path, data_shape=(3, 16, 16), batch_size=4,
              transport='u8', dtype='bfloat16', **MEANSTD)
    j = [b.data[0] for b in jmx.io.ImageRecordIter(**kw)]
    p = [b.data[0] for b in ImageRecordIter(ctx=CPU, **kw)]
    assert len(j) == len(p) == 3
    for x, y in zip(j, p):
        assert y._data.dtype == torch.bfloat16
        onp.testing.assert_array_equal(
            onp.asarray(x._data.astype('float32')), y.asnumpy())
    with pytest.raises(mx.MXNetError, match='requires transport'):
        ImageRecordIter(ctx=CPU, **dict(kw, transport='f32'))


def test_image_record_iter_native(tmp_path):
    rec_path, labels = _write_rec(tmp_path, n=20, size=(32, 24))
    it = ImageRecordIter(path_imgrec=rec_path, data_shape=(3, 16, 16),
                         batch_size=8, shuffle=False, ctx=CPU)
    assert it.native, "native pipeline not used"
    seen = 0
    got_labels = []
    for batch in it:
        data = batch.data[0]
        assert data.shape == (8, 3, 16, 16)
        assert str(data.dtype) == 'float32'
        assert data.context == CPU
        n = 8 - batch.pad
        got_labels.extend(batch.label[0].asnumpy()[:n].tolist())
        seen += n
    assert seen == 20
    onp.testing.assert_allclose(got_labels, labels)
    assert 0 <= float(data.asnumpy()[:1].min()) <= 255
    it.reset()
    assert sum(8 - b.pad for b in it) == 20


def test_image_record_iter_decode_correct(tmp_path):
    """Native decode + center crop matches PIL within JPEG tolerance."""
    from PIL import Image
    rec_path = str(tmp_path / "one.rec")
    rec = recordio.MXRecordIO(rec_path, 'w')
    rng = onp.random.RandomState(3)
    img = (rng.rand(20, 20, 3) * 255).astype(onp.uint8)
    buf = pyio.BytesIO()
    Image.fromarray(img).save(buf, format='JPEG', quality=100)
    rec.write(recordio.pack(recordio.IRHeader(0, 1.0, 0, 0), buf.getvalue()))
    rec.close()
    decoded = onp.asarray(Image.open(pyio.BytesIO(buf.getvalue())))
    it = ImageRecordIter(path_imgrec=rec_path, data_shape=(3, 20, 20),
                         batch_size=1, ctx=CPU)
    native = next(iter(it)).data[0].asnumpy()[0].transpose(1, 2, 0)
    onp.testing.assert_allclose(native, decoded.astype(onp.float32), atol=2)


def test_image_record_iter_shuffle_and_aug(tmp_path):
    rec_path, _ = _write_rec(tmp_path, n=30, size=(40, 40))
    it = ImageRecordIter(path_imgrec=rec_path, data_shape=(3, 24, 24),
                         batch_size=10, shuffle=True, rand_crop=True,
                         rand_mirror=True, mean_r=127.0, mean_g=127.0,
                         mean_b=127.0, std_r=58.0, std_g=58.0, std_b=58.0,
                         seed=5, ctx=CPU)
    e1 = [b.label[0].asnumpy().copy() for b in it]
    it.reset()
    e2 = [b.label[0].asnumpy().copy() for b in it]
    assert not all(onp.array_equal(a, b) for a, b in zip(e1, e2))
    it.reset()
    d = next(iter(it)).data[0].asnumpy()
    assert abs(float(d.mean())) < 1.0


def test_multi_label_matches_jax(tmp_path):
    rec_path, labels = _write_rec(tmp_path, n=12, label_width=4)
    kw = dict(path_imgrec=rec_path, data_shape=(3, 8, 8), batch_size=5,
              label_width=4)
    a = _epoch(jmx.io.ImageRecordIter(**kw))
    b = _epoch(ImageRecordIter(ctx=CPU, **kw))
    _same(a, b)
    got = onp.concatenate([lab[:5 - pad] for _, lab, pad in b])
    onp.testing.assert_allclose(got, onp.stack(labels))


@pytest.mark.parametrize('transport', ['u8', 'f32'])
def test_partial_batch_parity(tmp_path, monkeypatch, transport):
    """Native and PIL paths agree on epoch size, padding and exact-zero
    pad rows, on both transports."""
    rec_path, _ = _write_rec(tmp_path, n=10, size=(16, 16))

    def epoch_stats(force_fallback):
        with monkeypatch.context() as mp:
            if force_fallback:
                _force_fallback(mp, io_mod)
            it = ImageRecordIter(path_imgrec=rec_path, data_shape=(3, 8, 8),
                                 batch_size=4, transport=transport,
                                 mean_r=10.0, mean_g=20.0, mean_b=30.0,
                                 ctx=CPU)
            assert it.native != force_fallback
            return [(b.data[0].shape, b.pad, b.data[0].asnumpy()[4 - b.pad:])
                    for b in it]

    native = epoch_stats(False)
    fallback = epoch_stats(True)
    assert [(s, p) for s, p, _ in native] \
        == [(s, p) for s, p, _ in fallback] \
        == [((4, 3, 8, 8), 0), ((4, 3, 8, 8), 0), ((4, 3, 8, 8), 2)]
    for _, pad, tail in native + fallback:
        if pad:
            assert onp.all(tail == 0.0)


@pytest.mark.parametrize('native', [True, False])
def test_u8_f32_transport_parity(tmp_path, monkeypatch, native):
    """The u8 transport normalized where the batch lands gives the f32
    host-normalized batches bitwise, on the native and the PIL path (each
    multiplies by the reciprocal of std)."""
    rec_path, _ = _write_rec(tmp_path, n=13, size=(24, 20))
    kw = dict(path_imgrec=rec_path, data_shape=(3, 16, 16), batch_size=4,
              ctx=CPU, **MEANSTD)
    with monkeypatch.context() as mp:
        if not native:
            _force_fallback(mp, io_mod)
        it_f = ImageRecordIter(transport='f32', **kw)
        it_u = ImageRecordIter(transport='u8', **kw)
        assert it_f.native == native
        n = 0
        for bf, bu in zip(it_f, it_u):
            df = bf.data[0].asnumpy()
            du = bu.data[0].asnumpy()
            assert du.dtype == onp.float32 and bf.pad == bu.pad
            onp.testing.assert_array_equal(df, du)
            onp.testing.assert_array_equal(bf.label[0].asnumpy(),
                                           bu.label[0].asnumpy())
            n += 1
        assert n == 4


def test_lease_lifecycle(tmp_path):
    """Exactly one lease outstanding while iterating, none at epoch end,
    and a mid-epoch reset returns it."""
    rec_path, _ = _write_rec(tmp_path, n=16, size=(16, 16))
    it = ImageRecordIter(path_imgrec=rec_path, data_shape=(3, 8, 8),
                         batch_size=4, transport='u8', ctx=CPU)
    assert it.native
    depths = []
    for batch in it:
        batch.data[0].asnumpy()
        depths.append(it._pipe.leased_depth())
    assert depths == [1, 1, 1, 1]
    assert it._pipe.leased_depth() == 0
    it.reset()
    next(iter(it))
    assert it._pipe.leased_depth() == 1
    it.reset()
    assert it._pipe.leased_depth() == 0
    assert sum(4 - b.pad for b in it) == 16


def test_lease_buffer_valid_across_next(tmp_path):
    """The previous batch stays correct after the next one is taken (the
    normalize copied out of the lease before it went back)."""
    rec_path, _ = _write_rec(tmp_path, n=12, size=(16, 16))
    it = ImageRecordIter(path_imgrec=rec_path, data_shape=(3, 8, 8),
                         batch_size=4, transport='u8', ctx=CPU)
    it2 = ImageRecordIter(path_imgrec=rec_path, data_shape=(3, 8, 8),
                          batch_size=4, transport='u8', ctx=CPU)
    prev = None
    for b, ref in zip(it, it2):
        if prev is not None:
            onp.testing.assert_array_equal(prev[0], prev[1].data[0].asnumpy())
        prev = (b.data[0].asnumpy().copy(), b)
        onp.testing.assert_array_equal(prev[0], ref.data[0].asnumpy())


def test_decode_cache_reuse_matches_jax(tmp_path):
    """Epoch 2 serves decodes from the cache: the same hits, misses and
    batches as the JAX package's pipeline."""
    rec_path, _ = _write_rec(tmp_path, n=12, size=(16, 16))
    kw = dict(path_imgrec=rec_path, data_shape=(3, 8, 8), batch_size=4,
              transport='u8', decode_cache_mb=64)
    it = ImageRecordIter(ctx=CPU, **kw)
    jt = jmx.io.ImageRecordIter(**kw)
    e1 = _epoch(it)
    _same(_epoch(jt), e1)
    hits1, misses1, nbytes = it._pipe.cache_stats()
    assert hits1 == 0 and misses1 == 12 and nbytes > 0
    assert jt._pipe.cache_stats() == (hits1, misses1, nbytes)
    it.reset()
    e2 = _epoch(it)
    hits2, misses2, _ = it._pipe.cache_stats()
    assert hits2 == 12 and misses2 == 12
    _same(e1, e2)
    it0 = ImageRecordIter(ctx=CPU, **dict(kw, decode_cache_mb=0))
    list(it0)
    it0.reset()
    list(it0)
    assert it0._pipe.cache_stats() == (0, 24, 0)


def test_device_prefetch_iter(tmp_path):
    """DevicePrefetchIter yields the backing iterator's batches in order,
    across epochs, through both halves of the DataIter protocol."""
    rec_path, _ = _write_rec(tmp_path, n=14, size=(16, 16))
    kw = dict(path_imgrec=rec_path, data_shape=(3, 8, 8), batch_size=4,
              transport='u8', ctx=CPU)
    ref = _epoch(ImageRecordIter(**kw))
    pre = DevicePrefetchIter(ImageRecordIter(**kw), depth=2, ctx=CPU)
    for _ in range(2):
        got = _epoch(pre)
        assert [g[2] for g in got] == [0, 0, 0, 2]
        _same(ref, got)
        pre.reset()
    got = []
    while pre.iter_next():
        got.append((pre.getdata()[0].asnumpy().copy(),
                    pre.getlabel()[0].asnumpy(), pre.getpad()))
        assert pre.getlabel()[0].shape == (4,)
    _same(ref, got)


def test_host_bytes_telemetry(tmp_path):
    """mxnet_tpu_io_host_bytes_total: the u8 path moves 4x less than
    f32 for the same batches."""
    rec_path, _ = _write_rec(tmp_path, n=8, size=(16, 16))
    kw = dict(path_imgrec=rec_path, data_shape=(3, 8, 8), batch_size=4,
              ctx=CPU)

    def run(transport):
        before = telemetry.counter(
            'mxnet_tpu_io_host_bytes_total').value() or 0
        list(ImageRecordIter(transport=transport, **kw))
        return (telemetry.counter(
            'mxnet_tpu_io_host_bytes_total').value() or 0) - before

    was_on = telemetry.enabled()
    telemetry.enable()
    try:
        u8_bytes = run('u8')
        f32_bytes = run('f32')
        assert telemetry.value('mxnet_tpu_io_decode_cache_misses_total') \
            == 16
    finally:
        if not was_on:
            telemetry.disable()
        telemetry.reset()
    assert u8_bytes == 2 * 4 * 3 * 8 * 8
    assert f32_bytes == 4 * u8_bytes


def test_png_dataset_falls_back(tmp_path):
    """PNG payloads cannot use the native decoder: the PIL path serves
    every record, and says so."""
    from PIL import Image
    rec_path = str(tmp_path / "png.rec")
    rec = recordio.MXRecordIO(rec_path, 'w')
    rng = onp.random.RandomState(0)
    for i in range(6):
        img = (rng.rand(12, 12, 3) * 255).astype(onp.uint8)
        buf = pyio.BytesIO()
        Image.fromarray(img).save(buf, format='PNG')
        rec.write(recordio.pack(recordio.IRHeader(0, float(i), i, 0),
                                buf.getvalue()))
    rec.close()
    kw = dict(path_imgrec=rec_path, data_shape=(3, 12, 12), batch_size=4)
    it = ImageRecordIter(ctx=CPU, **kw)
    assert not it.native
    _same(_epoch(jmx.io.ImageRecordIter(**kw)), _epoch(it))
    it.reset()
    labels = []
    for b in it:
        labels.extend(b.label[0].asnumpy()[:4 - b.pad].tolist())
    assert labels == [0.0, 1.0, 2.0, 3.0, 4.0, 5.0]


def test_records_written_by_jax_read_by_the_port(tmp_path):
    """A .rec packed by the JAX package feeds the port's iterator and
    gives the JAX iterator's batches."""
    rng = onp.random.RandomState(4)
    rec_path = str(tmp_path / 'j.rec')
    w = jrec.MXRecordIO(rec_path, 'w')
    for i in range(9):
        img = (rng.rand(18, 22, 3) * 255).astype(onp.uint8)
        w.write(jrec.pack_img((0, float(i), i, 0), img, quality=90))
    w.close()
    kw = dict(path_imgrec=rec_path, data_shape=(3, 16, 16), batch_size=4,
              rand_crop=True, seed=2, preprocess_threads=1, **MEANSTD)
    _same(_epoch(jmx.io.ImageRecordIter(**kw)),
          _epoch(ImageRecordIter(ctx=CPU, **kw)))


def test_native_build_failure_is_logged_and_exposed(tmp_path, monkeypatch,
                                                   caplog):
    """A failed build falls back to the PIL path with the compiler's
    stderr logged and ``native`` False: the choice is never hidden."""
    from mxnet_tpu_torch import _native
    monkeypatch.setattr(_native, '_lib', None)
    monkeypatch.setattr(_native, '_lib_tried', False)
    monkeypatch.setattr(_native, '_error', None)
    monkeypatch.setattr(_native, '_route', None)
    monkeypatch.setenv('MXTPU_COMPILE_CACHE_DIR', str(tmp_path / 'build'))
    monkeypatch.setattr(_native, 'CXX_FLAGS',
                        ['-O3', '-std=c++17', '-fno-such-flag'])
    with caplog.at_level('WARNING', logger='mxnet_tpu_torch.io'):
        assert _native.get_lib() is None
    assert 'no-such-flag' in _native.build_error()
    assert 'build failed' in caplog.text
    rec_path, _ = _write_rec(tmp_path, n=4, size=(16, 16))
    it = ImageRecordIter(path_imgrec=rec_path, data_shape=(3, 8, 8),
                         batch_size=4, ctx=CPU)
    assert not it.native
    assert next(iter(it)).data[0].shape == (4, 3, 8, 8)
    monkeypatch.setenv('MXNET_TPU_NO_NATIVE_BUILD', '1')
    monkeypatch.setattr(_native, '_lib_tried', False)
    assert _native.get_lib() is None
    assert 'MXNET_TPU_NO_NATIVE_BUILD' in _native.build_error()


def _fresh_loader(_native, tmp_path, monkeypatch):
    """The loader as a new process finds it, building into tmp_path."""
    monkeypatch.setattr(_native, '_lib', None)
    monkeypatch.setattr(_native, '_lib_tried', False)
    monkeypatch.setattr(_native, '_error', None)
    monkeypatch.setattr(_native, '_route', None)
    monkeypatch.setenv('MXTPU_COMPILE_CACHE_DIR', str(tmp_path / 'build'))


def _no_system_libjpeg(_native, tmp_path, monkeypatch):
    """A machine without the libjpeg headers: the system route's build
    fails as g++ fails there."""
    if _native.pillow_libjpeg() is None:
        pytest.skip('this Pillow bundles no libjpeg')
    build = _native._build

    def no_system(out, cmd):
        if '-ljpeg' in cmd:
            return 'fatal error: jpeglib.h: No such file or directory'
        return build(out, cmd)

    monkeypatch.setattr(_native, '_build', no_system)
    _fresh_loader(_native, tmp_path, monkeypatch)


@pytest.mark.parametrize('system', [True, False])
def test_native_library_that_cannot_load_is_rebuilt(tmp_path, monkeypatch,
                                                    system):
    """A library in the build directory that does not load (built on a
    machine with another libjpeg) is rebuilt; where its route cannot
    build, the next route's library, under a name of its own, is
    loaded. The route is part of the name."""
    from mxnet_tpu_torch import _native
    if system:
        _fresh_loader(_native, tmp_path, monkeypatch)
    else:
        _no_system_libjpeg(_native, tmp_path, monkeypatch)
    from mxnet_tpu_torch.telemetry import compile as _compile
    misses = _compile.persistent_cache_stats()['misses']
    planted = _native.lib_path('system')
    assert planted.startswith(str(tmp_path / 'build'))
    assert planted != _native.lib_path('/elsewhere/libjpeg.so.62')
    os.makedirs(os.path.dirname(planted))
    with open(planted, 'wb') as f:
        f.write(b'built elsewhere, links a libjpeg this machine lacks')
    assert _native.get_lib() is not None, _native.build_error()
    route = 'system' if system else _native.pillow_libjpeg()
    assert _native.jpeg_route() == route
    assert _native.lib_path() == _native.lib_path(route)
    assert (_native.lib_path() == planted) == system
    ctypes.CDLL(_native.lib_path())
    # each build counts as a miss of the build directory, as nvcc's do
    assert _compile.persistent_cache_stats()['misses'] == misses + 1
    with open(planted, 'rb') as f:
        assert (f.read(4) == b'\x7fELF') == system


def test_native_build_links_pillows_libjpeg_without_a_system_one(
        tmp_path, monkeypatch):
    """With no system libjpeg, the build links the libjpeg-turbo bundled
    in Pillow's wheel through the port's ABI-62 headers, says so, and
    decodes as the JAX package's native pipeline does."""
    from mxnet_tpu_torch import _native
    _no_system_libjpeg(_native, tmp_path, monkeypatch)
    assert _native.get_lib() is not None, _native.build_error()
    assert _native.jpeg_route() == _native.pillow_libjpeg()
    assert _native.lib_path() == _native.lib_path(_native.pillow_libjpeg())
    rec_path, _ = _write_rec(tmp_path, n=10, size=(30, 26))
    kw = dict(path_imgrec=rec_path, data_shape=(3, 16, 16), batch_size=4,
              shuffle=True, seed=2, preprocess_threads=1, rand_crop=True,
              rand_mirror=True, **MEANSTD)
    for transport in ('u8', 'f32'):
        it = ImageRecordIter(ctx=CPU, transport=transport, **kw)
        assert it.native
        _same(_epoch(jmx.io.ImageRecordIter(transport=transport, **kw)),
              _epoch(it))


def test_io_spans_and_gauges_match_jax(tmp_path):
    """The io spans (io.batch, io.lease, h2d.normalize, h2d.device_put,
    sync.lease_drain) and the lease-depth gauge, under the JAX package's
    names, in both packages on the same native u8 pipeline."""
    from mxnet_tpu import telemetry as jtelemetry
    rec_path, _ = _write_rec(tmp_path, n=8, size=(16, 16))
    kw = dict(path_imgrec=rec_path, data_shape=(3, 8, 8), batch_size=4,
              transport='u8')
    names = []
    for tel, make, pre in (
            (telemetry, lambda: ImageRecordIter(ctx=CPU, **kw),
             lambda it: DevicePrefetchIter(it, ctx=CPU)),
            (jtelemetry, lambda: jmx.io.ImageRecordIter(**kw),
             lambda it: jmx.io.DevicePrefetchIter(it))):
        tel.reset()
        tel.enable()
        tel.trace.clear()
        tel.trace.enable()
        try:
            it = make()
            assert it._pipe is not None
            got = [b.pad for b in pre(it)]
            assert got == [0, 0]
            depth = tel.value('mxnet_tpu_io_lease_depth')
            events = tel.trace.chrome_events()
        finally:
            tel.trace.disable()
            tel.trace.clear()
            tel.disable()
            tel.reset()
        assert depth == 0            # the last lease went back at the end
        names.append({e['name'] for e in events if e.get('ph') == 'B'})
    want = {'io.batch', 'io.lease', 'h2d.normalize', 'h2d.device_put',
            'sync.lease_drain'}
    assert want <= names[0], names[0]
    assert names[0] & want == names[1] & want

