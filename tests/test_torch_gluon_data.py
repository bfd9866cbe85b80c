"""The port's ``gluon.data`` against the JAX package's (mirrors
tests/test_gluon_data_loader.py and the sampler cases of
tests/test_resharding.py).

Every DataLoader case of tests/test_gluon_data_loader.py runs on the port
under ``with mx.cpu():``; the parity cases run both loaders on the same
datasets and numpy seed (0 and 2 workers, each ``last_batch`` mode,
shuffle) and hold batches bitwise equal. The datasets (``transform``,
``transform_first``, ``filter``, ``shard``, ``take``,
``RecordFileDataset``), the samplers (``ElasticSampler``,
``IntervalSampler``), the vision datasets (the JAX package's synthetic
data, local MNIST and CIFAR files, ``ImageRecordDataset``,
``ImageFolderDataset``) and the transforms run in both packages.
"""
import struct
import threading
import time

import numpy as onp
import pytest

import mxnet_tpu as jmx
from mxnet_tpu.gluon import data as jdata
from mxnet_tpu.gluon.data.vision import transforms as jtf
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import nd
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon import data as pdata
from mxnet_tpu_torch.gluon.data import (ArrayDataset, DataLoader, Dataset,
                                        ElasticSampler)
from mxnet_tpu_torch.gluon.data.vision import transforms as ptf
from test_torch_jax_globals import jax_globals  # noqa: F401

CPU = mx.cpu()


@pytest.fixture(autouse=True)
def on_cpu():
    with mx.cpu():
        yield


def _data(n=37, d=5):
    rng = onp.random.RandomState(0)
    return rng.randn(n, d).astype(onp.float32), \
        rng.randint(0, 3, n).astype(onp.float32)


def _flat(batches):
    out = []
    for b in batches:
        if isinstance(b, (list, tuple)):
            out.append([x.asnumpy() for x in b])
        else:
            out.append([b.asnumpy()])
    return out


def _same(a, b):
    assert len(a) == len(b)
    for xa, xb in zip(a, b):
        assert len(xa) == len(xb)
        for u, v in zip(xa, xb):
            assert u.dtype == v.dtype
            onp.testing.assert_array_equal(u, v)


def test_multiworker_matches_single_worker_order():
    x, y = _data()
    batches0 = list(DataLoader(ArrayDataset(x, y), batch_size=8))
    for workers in (1, 2, 4):
        batches = list(DataLoader(ArrayDataset(x, y), batch_size=8,
                                  num_workers=workers))
        _same(_flat(batches0), _flat(batches))
    assert batches0[0][0].context == CPU


@pytest.mark.parametrize('workers', [0, 2])
@pytest.mark.parametrize('last_batch', ['keep', 'discard', 'rollover'])
@pytest.mark.parametrize('shuffle', [False, True])
def test_loader_matches_jax(workers, last_batch, shuffle):
    x, y = _data()
    out = []
    for mod in (jdata, pdata):
        onp.random.seed(9)
        loader = mod.DataLoader(mod.ArrayDataset(x, y), batch_size=8,
                                shuffle=shuffle, last_batch=last_batch,
                                num_workers=workers)
        out.append(_flat(list(loader)) + _flat(list(loader)))
        assert len(loader) == {'keep': 5, 'discard': 4,
                               'rollover': 4}[last_batch]
    _same(*out)


def test_multiworker_slow_transform_keeps_order():
    class SlowDataset(Dataset):
        def __init__(self, n):
            self._n = n

        def __len__(self):
            return self._n

        def __getitem__(self, idx):
            # earlier items are SLOWER: a completion-order yield would
            # return batches reversed
            time.sleep(0.02 if idx < 8 else 0.0)
            return onp.float32(idx)

    out = list(DataLoader(SlowDataset(16), batch_size=4, num_workers=4))
    flat = onp.concatenate([b.asnumpy().reshape(-1) for b in out])
    onp.testing.assert_array_equal(flat, onp.arange(16, dtype=onp.float32))


def test_multiworker_exception_propagates():
    class BrokenDataset(Dataset):
        def __len__(self):
            return 12

        def __getitem__(self, idx):
            if idx == 7:
                raise RuntimeError("corrupt record 7")
            return onp.float32(idx)

    with pytest.raises(RuntimeError, match="corrupt record 7"):
        for _ in DataLoader(BrokenDataset(), batch_size=4, num_workers=2):
            pass


@pytest.mark.parametrize('last_batch,expected_batches,expected_total', [
    ('keep', 5, 37), ('discard', 4, 32), ('rollover', 4, 32)])
def test_last_batch_modes_with_workers(last_batch, expected_batches,
                                       expected_total):
    x, y = _data(37)
    loader = DataLoader(ArrayDataset(x, y), batch_size=8,
                        last_batch=last_batch, num_workers=2)
    batches = list(loader)
    assert len(batches) == expected_batches
    assert sum(b[0].shape[0] for b in batches) == expected_total
    if last_batch == 'rollover':
        again = list(loader)
        assert again[0][0].shape[0] == 8


def test_shuffle_covers_dataset_each_epoch():
    _, y = _data(32)
    loader = DataLoader(ArrayDataset(onp.arange(32, dtype=onp.float32), y),
                        batch_size=8, shuffle=True, num_workers=2)
    for _ in range(2):
        seen = onp.concatenate([b[0].asnumpy() for b in loader])
        onp.testing.assert_array_equal(onp.sort(seen), onp.arange(32))


def test_persistent_worker_pool_across_epochs():
    """One executor for the loader's lifetime."""
    x, y = _data(32)
    loader = DataLoader(ArrayDataset(x, y), batch_size=8, num_workers=2)
    list(loader)
    pool1 = loader._pool
    assert pool1 is not None
    names1 = {t.name for t in threading.enumerate()
              if t.name.startswith('mxtpu-dataloader')}
    list(loader)
    assert loader._pool is pool1
    names2 = {t.name for t in threading.enumerate()
              if t.name.startswith('mxtpu-dataloader')}
    assert names1 == names2 and len(names1) <= 2
    loader.close()
    assert loader._pool is None
    assert len(list(loader)) == 4


def test_pin_memory_batches_match():
    """pin_memory=True (on a CPU context: nothing to pin for) changes
    neither values nor order; the card's side-stream copy is held by
    tests/test_torch_io_cuda.py."""
    x, y = _data(24)
    plain = list(DataLoader(ArrayDataset(x, y), batch_size=8))
    pinned = DataLoader(ArrayDataset(x, y), batch_size=8, num_workers=2,
                        pin_memory=True)
    assert pinned._pin_to is None
    _same(_flat(plain), _flat(list(pinned)))


def test_dataloader_used_from_training_thread():
    """A loader iterated from a worker thread while the main thread
    computes."""
    x, y = _data(64)
    loader = DataLoader(ArrayDataset(x, y), batch_size=16, num_workers=2)
    results = []
    errs = []

    def consume():
        try:
            for bx, by in loader:
                results.append(float(bx.asnumpy().sum()))
        except Exception as e:   # pragma: no cover
            errs.append(e)

    t = threading.Thread(target=consume)
    t.start()
    main_side = [float((nd.ones((8, 8)) * i).sum().asscalar())
                 for i in range(10)]
    t.join(timeout=60)
    assert not t.is_alive() and not errs
    assert len(results) == 4 and len(main_side) == 10


def test_dataset_methods_match_jax():
    x, y = _data(11)
    for mod in (jdata, pdata):
        ds = mod.ArrayDataset(x, y)
        t = ds.transform(lambda a, b: (a * 2, b + 1))
        tf = ds.transform_first(lambda a: a - 1, lazy=False)
        f = ds.filter(lambda s: s[1] > 0)
        sh = [ds.shard(3, i) for i in range(3)]
        tk = ds.take(4)
        sd = mod.SimpleDataset(list(range(5)))
        got = (onp.stack([t[i][0] for i in range(len(t))]),
               onp.stack([tf[i][0] for i in range(len(tf))]),
               [f[i][1] for i in range(len(f))],
               [len(s) for s in sh], [sh[2][0][1]], len(tk),
               sd[3], len(sd), len(ds.take(None)))
        if mod is jdata:
            want = got
    for a, b in zip(want, got):
        if isinstance(a, onp.ndarray):
            onp.testing.assert_array_equal(a, b)
        else:
            assert a == b
    with pytest.raises(IndexError):
        pdata.ArrayDataset(x).take(2)[3]


def test_samplers_match_jax():
    for args in ((10, 3), (10, 3, False), (7, 7)):
        assert list(jdata.IntervalSampler(*args)) == \
            list(pdata.IntervalSampler(*args))
    onp.random.seed(1)
    a = list(jdata.RandomSampler(12))
    onp.random.seed(1)
    assert a == list(pdata.RandomSampler(12))
    for last in ('keep', 'discard', 'rollover'):
        js = jdata.BatchSampler(jdata.SequentialSampler(10, start=2), 4, last)
        ps = pdata.BatchSampler(pdata.SequentialSampler(10, start=2), 4, last)
        assert list(js) + list(js) == list(ps) + list(ps)
        assert len(js) == len(ps)
    fs = pdata.FilterSampler(lambda v: v % 2, list(range(9)))
    assert list(fs) == [1, 3, 5, 7] and len(fs) == 4
    with pytest.raises(ValueError):
        list(pdata.BatchSampler(pdata.SequentialSampler(5), 2, 'bogus'))


def test_dataloader_elastic_sampler_round_trip():
    """DataLoader(batch_sampler=ElasticSampler): world-indexed batches,
    manifest state through data_state(), reshard() re-partitions, the
    same as the JAX loader."""
    G, N = 8, 32
    x = onp.arange(N, dtype=onp.float32).reshape(N, 1)
    out = []
    for mod in (jdata, pdata):
        smp = mod.ElasticSampler(N, G, rank=0, world=2, seed=0,
                                 shuffle=False)
        dl = mod.DataLoader(mod.ArrayDataset(x), batch_sampler=smp)
        batches = [b.asnumpy().ravel().tolist() for b in dl]
        st = dl.data_state()
        dl.reshard(1, 2)
        nxt = next(iter(dl)).asnumpy().ravel().tolist()
        back = mod.ElasticSampler.from_state(st, rank=1, world=4)
        out.append((batches, st, nxt, next(iter(back))))
    assert out[0] == out[1]
    assert out[1][0][0] == [0.0, 1.0, 2.0, 3.0]
    assert out[1][1]['position'] == N
    assert out[1][2] == [4.0, 5.0, 6.0, 7.0]
    with pytest.raises(MXNetError, match='not elastic'):
        DataLoader(ArrayDataset(x), batch_size=4).reshard(0, 1)
    assert DataLoader(ArrayDataset(x), batch_size=4).data_state() is None


def test_vision_datasets_synthetic_match_jax(tmp_path):
    root = str(tmp_path / 'none')
    for name in ('MNIST', 'FashionMNIST', 'CIFAR10', 'CIFAR100'):
        for train in (True, False):
            j = getattr(jdata.vision, name)(root=root, train=train)
            p = getattr(pdata.vision, name)(root=root, train=train)
            assert len(j) == len(p)
            for i in (0, 5, len(p) - 1):
                (ja, jl), (pa, pl) = j[i], p[i]
                assert pa.context == CPU and pa.dtype == onp.uint8
                onp.testing.assert_array_equal(ja.asnumpy(), pa.asnumpy())
                assert jl == pl


def test_vision_datasets_read_local_files(tmp_path):
    rng = onp.random.RandomState(8)
    imgs = (rng.rand(6, 28, 28) * 255).astype(onp.uint8)
    labs = rng.randint(0, 10, 6).astype(onp.uint8)
    with open(tmp_path / 'train-images-idx3-ubyte', 'wb') as f:
        f.write(struct.pack('>HBB', 0, 8, 3) + struct.pack('>III', 6, 28, 28)
                + imgs.tobytes())
    with open(tmp_path / 'train-labels-idx1-ubyte', 'wb') as f:
        f.write(struct.pack('>HBB', 0, 8, 1) + struct.pack('>I', 6)
                + labs.tobytes())
    rows = onp.concatenate([labs[:, None], (rng.rand(6, 3072) * 255).astype(
        onp.uint8)], axis=1)
    rows.tofile(str(tmp_path / 'test_batch.bin'))
    for name, kw in (('MNIST', dict(train=True)),
                     ('CIFAR10', dict(train=False))):
        j = getattr(jdata.vision, name)(root=str(tmp_path), **kw)
        p = getattr(pdata.vision, name)(
            root=str(tmp_path), transform=lambda d, l: (d, l + 1), **kw)
        assert len(p) == 6
        for i in range(6):
            onp.testing.assert_array_equal(j[i][0].asnumpy(),
                                           p[i][0].asnumpy())
            assert p[i][1] == j[i][1] + 1


def test_record_and_folder_datasets_match_jax(tmp_path):
    from PIL import Image
    from mxnet_tpu_torch import recordio
    rng = onp.random.RandomState(9)
    rec, idx = str(tmp_path / 'd.rec'), str(tmp_path / 'd.idx')
    w = recordio.MXIndexedRecordIO(idx, rec, 'w')
    for i in range(5):
        img = (rng.rand(10, 12, 3) * 255).astype(onp.uint8)
        w.write_idx(i, recordio.pack_img((0, float(i), i, 0), img,
                                         img_fmt='.png'))
        d = tmp_path / 'folder' / f'class{i % 2}'
        d.mkdir(parents=True, exist_ok=True)
        Image.fromarray(img).save(str(d / f'{i}.png'))
    w.close()
    pairs = ((jdata.vision.ImageRecordDataset(rec),
              pdata.vision.ImageRecordDataset(rec)),
             (jdata.vision.ImageFolderDataset(str(tmp_path / 'folder')),
              pdata.vision.ImageFolderDataset(str(tmp_path / 'folder'))))
    for j, p in pairs:
        assert len(j) == len(p) == 5
        for i in range(5):
            onp.testing.assert_array_equal(j[i][0].asnumpy(),
                                           p[i][0].asnumpy())
            onp.testing.assert_array_equal(j[i][1], p[i][1])
    assert pairs[1][1].synsets == ['class0', 'class1']
    jr, pr = jdata.RecordFileDataset(rec), pdata.RecordFileDataset(rec)
    assert len(pr) == 5 and all(jr[i] == pr[i] for i in range(5))
    # a loader over the record dataset with a transform, 2 workers
    tf = ptf.Compose([ptf.ToTensor(), ptf.Normalize(0.5, 0.25)])
    ds = pdata.vision.ImageRecordDataset(rec).transform_first(tf)
    batches = list(DataLoader(ds, batch_size=2, num_workers=2))
    assert batches[0][0].shape == (2, 3, 10, 12)


def test_transforms_match_jax():
    rng = onp.random.RandomState(10)
    u8 = (rng.rand(12, 10, 3) * 255).astype(onp.uint8)
    x, jx = mx.nd.array(u8, ctx=CPU, dtype='uint8'), jmx.nd.array(
        u8, dtype='uint8')
    t = ptf.ToTensor()(x)
    onp.testing.assert_array_equal(t.asnumpy(), jtf.ToTensor()(jx).asnumpy())
    n = ptf.Normalize((0.4, 0.5, 0.6), (0.2, 0.25, 0.3))(t)
    jn = jtf.Normalize((0.4, 0.5, 0.6), (0.2, 0.25, 0.3))(
        jtf.ToTensor()(jx))
    onp.testing.assert_array_equal(n.asnumpy(), jn.asnumpy())
    assert str(ptf.Cast('float16')(t).dtype) == 'float16'
    batch = mx.nd.array(onp.stack([u8, u8]), ctx=CPU, dtype='uint8')
    assert ptf.ToTensor()(batch).shape == (2, 3, 12, 10)
    onp.testing.assert_array_equal(
        ptf.CenterCrop((6, 4))(x).asnumpy(),
        jtf.CenterCrop((6, 4))(jx).asnumpy())
    for cls, args in ((ptf.RandomFlipLeftRight, ()),
                      (ptf.RandomFlipTopBottom, ()),
                      (ptf.RandomCrop, ((6, 5), 2)),
                      (ptf.RandomBrightness, (0.3,)),
                      (ptf.RandomContrast, (0.3,)),
                      (ptf.RandomSaturation, (0.3,))):
        src = x if cls in (ptf.RandomFlipLeftRight, ptf.RandomFlipTopBottom,
                           ptf.RandomCrop) else t
        jsrc = jx if src is x else jtf.ToTensor()(jx)
        for s in range(3):
            onp.random.seed(s)
            a = cls(*args)(src).asnumpy()
            onp.random.seed(s)
            b = getattr(jtf, cls.__name__)(*args)(jsrc).asnumpy()
            onp.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)
    onp.random.seed(0)
    assert ptf.RandomResizedCrop(8)(x).shape == (8, 8, 3)
    assert ptf.Resize((7, 5))(x).shape == (5, 7, 3)
    comp = ptf.Compose([ptf.RandomFlipLeftRight(), ptf.ToTensor(),
                        ptf.Normalize(0.5, 0.2)])
    assert comp(x).shape == (3, 12, 10)
    assert isinstance(ptf.ToTensor(), mx.gluon.HybridBlock)
    assert not isinstance(ptf.RandomFlipLeftRight(), mx.gluon.HybridBlock)


def test_public_names_match():
    for name in ('Dataset', 'SimpleDataset', 'ArrayDataset',
                 'RecordFileDataset', 'Sampler', 'SequentialSampler',
                 'RandomSampler', 'FilterSampler', 'BatchSampler',
                 'ElasticSampler', 'IntervalSampler', 'DataLoader'):
        assert hasattr(jdata, name) and hasattr(pdata, name), name
    for name in ('MNIST', 'FashionMNIST', 'CIFAR10', 'CIFAR100',
                 'ImageRecordDataset', 'ImageFolderDataset', 'transforms'):
        assert hasattr(pdata.vision, name), name
    for name in dir(jtf):
        if not name.startswith('_') and isinstance(getattr(jtf, name), type)\
                and name not in ('Block', 'HybridBlock', 'Sequential',
                                 'HybridSequential', 'NDArray'):
            assert hasattr(ptf, name), name
