"""The port's RecordIO (``mxnet_tpu_torch.recordio``) against the JAX
package's (mirrors the RecordIO cases of tests/test_io_native.py and
tests/test_resilience.py).

Files written by either package, through the native writer or the
pure-Python one, are byte-equal and read back by the other; ``pack``,
``pack_img`` and ``unpack`` give the same bytes and headers; truncation
raises in both (the record-and-offset cases of tests/test_resilience.py
are in tests/test_torch_resilience.py). The port builds its copy of
``src/io/mxtpu_io.cc`` (``mxnet_tpu_torch/csrc/io/``) itself into
``build/mxnet_tpu_torch/``.
"""
import os
import struct

import numpy as onp
import pytest

import mxnet_tpu as jmx
from mxnet_tpu import recordio as jrec, _native as jnative
from mxnet_tpu_torch import recordio as prec, _native as pnative
from mxnet_tpu_torch.base import DataError, MXNetError
from test_torch_jax_globals import jax_globals  # noqa: F401

PAYLOADS = [b"hello", b"x" * 13, b"", b"0123456789abcdef", bytes(range(7))]


def _framing(payloads):
    """An independent encoding of the dmlc framing."""
    out = b""
    for s in payloads:
        out += struct.pack('<II', 0xced7230a, len(s)) + s
        out += b"\x00" * ((4 - len(s) % 4) % 4)
    return out


def _write(mod, path, payloads):
    rec = mod.MXRecordIO(path, 'w')
    for s in payloads:
        rec.write(s)
    rec.close()
    with open(path, 'rb') as f:
        return f.read()


def _read_all(mod, path):
    rec = mod.MXRecordIO(path, 'r')
    got = []
    while True:
        s = rec.read()
        if s is None:
            break
        got.append(s)
    rec.close()
    return got


def test_port_builds_its_own_native_library():
    assert pnative.native_available(), pnative.build_error()
    path = pnative.lib_path()
    assert os.path.isfile(path)
    assert os.sep + os.path.join('build', 'mxnet_tpu_torch') + os.sep \
        in path
    assert os.path.join('mxnet_tpu', '_lib') not in path


@pytest.mark.parametrize('writer', ['jax', 'port'])
@pytest.mark.parametrize('native', [True, False])
def test_rec_bytes_equal_and_read_back_by_the_other(tmp_path, monkeypatch,
                                                     writer, native):
    """Each package writes the same bytes (native or pure-Python writer)
    and the other package reads them back."""
    if not native:
        monkeypatch.setattr(jnative, 'get_lib', lambda: None)
        monkeypatch.setattr(pnative, 'get_lib', lambda: None)
    w, r = (jrec, prec) if writer == 'jax' else (prec, jrec)
    path = str(tmp_path / 'a.rec')
    data = _write(w, path, PAYLOADS)
    assert data == _framing(PAYLOADS)
    assert _read_all(r, path) == PAYLOADS
    assert _read_all(w, path) == PAYLOADS
    other = str(tmp_path / 'b.rec')
    assert _write(r, other, PAYLOADS) == data


def test_native_and_python_writers_agree(tmp_path, monkeypatch):
    native = _write(prec, str(tmp_path / 'n.rec'), PAYLOADS)
    monkeypatch.setattr(pnative, 'get_lib', lambda: None)
    py = _write(prec, str(tmp_path / 'p.rec'), PAYLOADS)
    assert native == py == _framing(PAYLOADS)


@pytest.mark.parametrize('native', [True, False])
def test_indexed_recordio_both_ways(tmp_path, monkeypatch, native):
    if not native:
        monkeypatch.setattr(jnative, 'get_lib', lambda: None)
        monkeypatch.setattr(pnative, 'get_lib', lambda: None)
    files = {}
    for name, mod in (('jax', jrec), ('port', prec)):
        idx, rec = str(tmp_path / f'{name}.idx'), str(tmp_path / f'{name}.rec')
        w = mod.MXIndexedRecordIO(idx, rec, 'w')
        for i in range(10):
            w.write_idx(i, f"record-{i}".encode() * (i + 1))
        w.close()
        files[name] = (idx, rec)
    for a, b in (('jax', 'port'), ('port', 'jax')):
        for k in (0, 1):
            with open(files[a][k], 'rb') as fa, open(files[b][k], 'rb') as fb:
                assert fa.read() == fb.read()
    for name, mod in (('jax', prec), ('port', jrec)):
        r = mod.MXIndexedRecordIO(*files[name], 'r')
        assert r.keys == list(range(10))
        assert r.read_idx(7) == b"record-7" * 8
        assert r.read_idx(2) == b"record-2" * 3
        r.close()


def test_pack_unpack_match_the_jax_package():
    for header, payload in (((0, 3.0, 7, 0), b'abc'),
                            ((0, 1, 2, 3), b''),
                            ((4, onp.arange(4, dtype=onp.float32), 5, 6),
                             b'payload')):
        a, b = jrec.pack(header, payload), prec.pack(header, payload)
        assert a == b
        ha, pa = jrec.unpack(a)
        hb, pb = prec.unpack(b)
        assert pa == pb == payload
        assert ha.flag == hb.flag and ha.id == hb.id and ha.id2 == hb.id2
        onp.testing.assert_array_equal(ha.label, hb.label)
    # a float label list of width > 1 rides as f32 after the header
    s = prec.pack(prec.IRHeader(0, [1.5, 2.5], 9, 0), b'z')
    h, p = jrec.unpack(s)
    assert h.flag == 2 and p == b'z'
    onp.testing.assert_array_equal(h.label, [1.5, 2.5])


@pytest.mark.parametrize('fmt', ['.jpg', '.png'])
def test_pack_img_bytes_equal(fmt):
    rng = onp.random.RandomState(3)
    img = (rng.rand(20, 24, 3) * 255).astype(onp.uint8)
    a = jrec.pack_img((0, 2.0, 1, 0), img, quality=90, img_fmt=fmt)
    b = prec.pack_img((0, 2.0, 1, 0), img, quality=90, img_fmt=fmt)
    assert a == b
    ha, ia = jrec.unpack_img(a)
    hb, ib = prec.unpack_img(b)
    assert ha == hb
    onp.testing.assert_array_equal(ia, ib)
    if fmt == '.png':
        onp.testing.assert_array_equal(ib, img)


@pytest.mark.parametrize('native', [True, False])
def test_truncated_record_raises_in_both(tmp_path, monkeypatch, native):
    """Truncation raises, not a silent end of the dataset."""
    if not native:
        monkeypatch.setattr(jnative, 'get_lib', lambda: None)
        monkeypatch.setattr(pnative, 'get_lib', lambda: None)
    path = str(tmp_path / 'c.rec')
    _write(prec, path, [b"a" * 100, b"b" * 100])
    size = os.path.getsize(path)
    with open(path, 'r+b') as f:
        f.truncate(size - 30)   # cut into the second record's payload
    for mod, err in ((jrec, jmx.MXNetError), (prec, MXNetError)):
        r = mod.MXRecordIO(path, 'r')
        assert r.read() == b"a" * 100
        with pytest.raises(err):
            r.read()
        r.close()


def test_native_reader_raises_data_error_on_bad_magic(tmp_path):
    path = str(tmp_path / 'm.rec')
    _write(prec, path, [b'first', b'second'])
    with open(path, 'r+b') as f:
        f.seek(16)                           # the second record's magic
        f.write(b'\x00\x00\x00\x00')
    r = prec.MXRecordIO(path, 'r')
    assert r._native is not None
    assert r.read() == b'first'
    with pytest.raises(DataError, match='invalid record magic'):
        r.read()
    r.close()


def test_recordio_reopen_and_pickle(tmp_path):
    import pickle
    path = str(tmp_path / 'r.rec')
    _write(prec, path, PAYLOADS)
    r = prec.MXRecordIO(path, 'r')
    assert r.read() == PAYLOADS[0]
    r2 = pickle.loads(pickle.dumps(r))    # reopens from the start
    assert _read_all(prec, path) == PAYLOADS
    assert r2.read() == PAYLOADS[0]
    r.reset()
    assert r.read() == PAYLOADS[0]
    r.close()
    r2.close()
    with pytest.raises(MXNetError):
        prec.MXRecordIO(path, 'x')
