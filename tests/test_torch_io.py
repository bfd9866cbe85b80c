"""The port's host iterators and host->device layer
(``mxnet_tpu_torch.io``) against the JAX package's ``mxnet_tpu.io``.

Every iterator runs in both packages on the same arrays and the same
numpy seed (the port with ``ctx=mx.cpu()``): ``NDArrayIter`` in each
``last_batch_handle`` mode with and without shuffle, ``ResizeIter``,
``PrefetchingIter`` (a worker's error reaches the consumer),
``DevicePrefetchIter`` (its ``next`` and ``iter_next/getdata``
protocols), ``CSVIter`` and ``MNISTIter``: data and labels bitwise
equal. The u8 normalize is held against the JAX program on the same
uint8 batch (bitwise in float32; bfloat16 after the same rounding). The
``ElasticShard`` cases of tests/test_resharding.py run on the port and
against the JAX shard, and the io telemetry cases of
tests/test_telemetry.py on the port.
"""
import gzip
import struct
import time

import numpy as onp
import pytest
import torch

from mxnet_tpu import io as jio
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import io as pio, telemetry
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.io import ElasticShard, NDArrayIter
from test_torch_jax_globals import jax_globals  # noqa: F401

CPU = mx.cpu()
G, N = 8, 32     # global batch / dataset size (4 batches per epoch)


def _np(x):
    return x.asnumpy() if hasattr(x, 'asnumpy') else onp.asarray(x)


def _epoch(it):
    return [([_np(d) for d in b.data], [_np(l) for l in (b.label or [])],
             b.pad) for b in it]


def _same(a, b):
    assert len(a) == len(b)
    for (da, la, pa), (db, lb, pb) in zip(a, b):
        assert pa == pb
        for x, y in zip(da + la, db + lb):
            assert x.dtype == y.dtype, (x.dtype, y.dtype)
            onp.testing.assert_array_equal(x, y)


def _arrays(n=23):
    rng = onp.random.RandomState(0)
    return (rng.randn(n, 3, 2).astype(onp.float32),
            rng.randint(0, 5, n).astype(onp.float32))


@pytest.mark.parametrize('handle', ['pad', 'discard', 'roll_over'])
@pytest.mark.parametrize('shuffle', [False, True])
def test_ndarrayiter_matches_jax(handle, shuffle):
    x, y = _arrays()
    onp.random.seed(11)
    a = _epoch(jio.NDArrayIter(x, y, batch_size=5, shuffle=shuffle,
                               last_batch_handle=handle))
    onp.random.seed(11)
    b = _epoch(NDArrayIter(x, y, batch_size=5, shuffle=shuffle,
                           last_batch_handle=handle, ctx=CPU))
    _same(a, b)
    assert len(b) == {'pad': 5, 'discard': 4, 'roll_over': 4}[handle]


def test_ndarrayiter_dict_inputs_dtypes_and_reset():
    rng = onp.random.RandomState(1)
    data = {'a': rng.randn(10, 2), 'b': rng.randint(0, 9, (10, 4))}
    label = {'y': rng.rand(10)}
    ja = jio.NDArrayIter(data, label, batch_size=4)
    pa = NDArrayIter(data, label, batch_size=4, ctx=CPU)
    assert [d.name for d in pa.provide_data] == ['a', 'b']
    assert pa.provide_label[0].shape == (4,)
    _same(_epoch(ja), _epoch(pa))
    ja.reset()
    pa.reset()
    _same(_epoch(ja), _epoch(pa))
    with pytest.raises(MXNetError):
        NDArrayIter(None, ctx=CPU)


def test_ndarrayiter_defaults_to_the_current_context():
    x, y = _arrays(8)
    with mx.cpu():
        it = NDArrayIter(x, y, batch_size=4)
    b = next(iter(it))
    assert b.data[0].context == CPU
    assert it.ctx == CPU


def test_resize_iter_matches_jax():
    x, y = _arrays(10)
    a = _epoch(jio.ResizeIter(jio.NDArrayIter(x, y, batch_size=4), 7))
    b = _epoch(pio.ResizeIter(NDArrayIter(x, y, batch_size=4, ctx=CPU), 7))
    _same(a, b)
    assert len(b) == 7


@pytest.mark.parametrize('device_prefetch', [False, True])
def test_prefetching_iter_matches_jax(device_prefetch):
    x, y = _arrays(17)
    a = _epoch(jio.PrefetchingIter(jio.NDArrayIter(x, y, batch_size=4),
                                   device_prefetch=device_prefetch))
    p = pio.PrefetchingIter(NDArrayIter(x, y, batch_size=4, ctx=CPU),
                            device_prefetch=device_prefetch, ctx=CPU)
    b = _epoch(p)
    _same(a, b)
    p.reset()
    got = []
    while p.iter_next():
        got.append(([_np(p.getdata()[0])], [_np(p.getlabel()[0])],
                    p.getpad()))
    _same(a, got)


def test_prefetching_iter_propagates_worker_error():
    """An exception in the prefetch worker surfaces in the consumer, not
    a deadlock on an empty queue."""

    class Broken(pio.DataIter):
        def __init__(self):
            super().__init__(batch_size=2)
            self.n = 0

        def next(self):
            self.n += 1
            if self.n >= 3:
                raise RuntimeError("corrupt record")
            return self.n

        def reset(self):
            self.n = 0

    pre = pio.PrefetchingIter(Broken(), ctx=CPU)
    assert pre.next() == 1
    assert pre.next() == 2
    with pytest.raises(RuntimeError, match="corrupt record"):
        pre.next()


def test_device_prefetch_iter_both_protocols_match_jax():
    x, y = _arrays(14)
    ref = _epoch(jio.DevicePrefetchIter(jio.NDArrayIter(x, y, batch_size=4),
                                        depth=2))
    pre = pio.DevicePrefetchIter(NDArrayIter(x, y, batch_size=4, ctx=CPU),
                                 depth=2, ctx=CPU)
    for _ in range(2):
        _same(ref, _epoch(pre))
        pre.reset()
    got = []
    while pre.iter_next():
        got.append(([_np(pre.getdata()[0])], [_np(pre.getlabel()[0])],
                    pre.getpad()))
    _same(ref, got)
    assert [g[2] for g in got] == [0, 0, 0, 2]
    # the in-flight batches are an 'io_leases' memory pool
    pre.reset()
    pre.iter_next()
    pools = pre.memory_pools()['io_leases']
    assert len(pools) == 2 * 2     # depth batches x (data, label)


def test_device_put_batch_fires_its_fault_site():
    from mxnet_tpu_torch.resilience import faults, InjectedFault
    x, y = _arrays(8)
    faults.arm('io.device_put', 'raise')
    try:
        pre = pio.DevicePrefetchIter(NDArrayIter(x, y, batch_size=4,
                                                 ctx=CPU), ctx=CPU)
        with pytest.raises(InjectedFault):
            next(iter(pre))
    finally:
        faults.disarm()


def test_csv_and_mnist_iters_match_jax(tmp_path):
    rng = onp.random.RandomState(2)
    data = rng.rand(9, 6).astype(onp.float32)
    label = rng.randint(0, 3, (9, 1)).astype(onp.float32)
    dpath, lpath = str(tmp_path / 'd.csv'), str(tmp_path / 'l.csv')
    onp.savetxt(dpath, data, delimiter=',')
    onp.savetxt(lpath, label, delimiter=',')
    a = _epoch(jio.CSVIter(dpath, (2, 3), lpath, (1,), batch_size=4))
    b = _epoch(pio.CSVIter(dpath, (2, 3), lpath, (1,), batch_size=4,
                           ctx=CPU))
    _same(a, b)

    imgs = (rng.rand(10, 5, 4) * 255).astype(onp.uint8)
    labs = rng.randint(0, 10, 10).astype(onp.uint8)
    ipath, lpath = str(tmp_path / 'img.gz'), str(tmp_path / 'lab')
    with gzip.open(ipath, 'wb') as f:
        f.write(struct.pack('>HBB', 0, 8, 3) +
                struct.pack('>III', 10, 5, 4) + imgs.tobytes())
    with open(lpath, 'wb') as f:
        f.write(struct.pack('>HBB', 0, 8, 1) + struct.pack('>I', 10) +
                labs.tobytes())
    for flat in (False, True):
        onp.random.seed(4)
        a = _epoch(jio.MNISTIter(ipath, lpath, batch_size=4, flat=flat))
        onp.random.seed(4)
        b = _epoch(pio.MNISTIter(ipath, lpath, batch_size=4, flat=flat,
                                 ctx=CPU))
        _same(a, b)


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_device_normalize_matches_the_jax_program(dtype):
    """(u8 - mean) * (1/std), NHWC->NCHW, the cast and the zeroed pad
    rows: bitwise the JAX program's on the same batch (bfloat16 compared
    after both round to it)."""
    import jax.numpy as jnp
    rng = onp.random.RandomState(5)
    u8 = (rng.rand(6, 7, 5, 3) * 255).astype(onp.uint8)
    mean = onp.array([123.68, 116.78, 103.94], onp.float32)
    std = onp.array([58.4, 0.0, 57.4], onp.float32)   # std 0: reciprocal 1
    want = jio.io._device_normalize_fn(mean, std, dtype)(u8, onp.int32(4))
    got = pio.io._device_normalize_fn(mean, std, dtype)(
        torch.from_numpy(u8), 4)
    assert got.shape == (6, 3, 7, 5) and got.is_contiguous()
    assert str(got.dtype) == f'torch.{dtype}'
    w = onp.asarray(want.astype(jnp.float32))
    g = got.to(torch.float32).numpy()
    onp.testing.assert_array_equal(g, w)
    assert not g[4:].any()


def test_elastic_shard_matches_jax_and_is_exactly_once():
    """dp=4 -> 2 -> 4 mid-epoch: concatenating every rank's block per
    step reproduces the fixed-world batches, and the JAX shard's."""
    seen = []

    def run(world, steps, state=None):
        shards = [ElasticShard.from_state(state, rank=r, world=world)
                  if state is not None else
                  ElasticShard(N, G, rank=r, world=world, seed=5)
                  for r in range(world)]
        for _ in range(steps):
            batch = []
            for sh in shards:
                batch.extend(sh.next_batch())
            seen.append(batch)
        return shards[0].state()

    st = run(4, 3)
    st = run(2, 3, st)
    run(4, 4, st)
    ref = jio.ElasticShard(N, G, rank=0, world=1, seed=5)
    want = [[ref.sample_at(s * G + j) for j in range(G)] for s in range(10)]
    assert seen == want
    js = jio.ElasticShard(N, G, rank=1, world=2, seed=9)
    ps = ElasticShard(N, G, rank=1, world=2, seed=9)
    for _ in range(6):
        assert js.next_batch() == ps.next_batch()
    assert js.state() == ps.state()


def test_elastic_shard_permutation_and_refusals():
    sh = ElasticShard(N, G, rank=0, world=1, seed=9)
    epoch0 = [x for _ in range(N // G) for x in sh.next_batch()]
    epoch1 = [x for _ in range(N // G) for x in sh.next_batch()]
    assert sorted(epoch0) == sorted(epoch1) == list(range(N))
    assert epoch0 != epoch1 and sh.epoch == 2
    with pytest.raises(MXNetError, match='not\\s+divisible'):
        ElasticShard(N, G, rank=0, world=3)
    sh = ElasticShard(N, G, rank=0, world=2)
    with pytest.raises(MXNetError, match='not\\s+divisible'):
        sh.reshard(0, 3)
    assert sh.world == 2 and sh.batch_size == G // 2
    with pytest.raises(MXNetError):
        ElasticShard(0, G)


def test_ndarrayiter_shard_stream_matches_jax():
    x = onp.arange(N, dtype=onp.float32).reshape(N, 1)
    its = [mod.NDArrayIter(x, shard=mod.ElasticShard(
        N, G, rank=1, world=2, seed=5, shuffle=False), **kw)
        for mod, kw in ((jio, {}), (pio, {'ctx': CPU}))]
    for it in its:
        assert it.batch_size == G // 2
    out = []
    for it in its:
        b1 = it.next().data[0].asnumpy().ravel().tolist()
        it.reset()
        b2 = it.next().data[0].asnumpy().ravel().tolist()
        st = it.data_state()
        it.reshard(0, 4)
        b3 = it.next().data[0].asnumpy().ravel().tolist()
        out.append((b1, b2, st, b3))
    assert out[0] == out[1]
    assert out[1][0] == [4.0, 5.0, 6.0, 7.0]
    assert out[1][1] == [12.0, 13.0, 14.0, 15.0]
    assert out[1][3] == [16.0, 17.0]
    with pytest.raises(MXNetError):
        NDArrayIter(x, ctx=CPU).reshard(0, 1)


@pytest.fixture
def telem():
    telemetry.reset()
    telemetry.enable()
    yield
    telemetry.disable()
    telemetry.reset()


def test_io_batch_latency_histogram(telem):
    X = onp.arange(32, dtype=onp.float32).reshape(16, 2)
    batches = list(NDArrayIter(X, None, batch_size=4, ctx=CPU))
    assert len(batches) == 4
    count, _ = telemetry.value('mxnet_tpu_io_batch_latency_seconds')
    assert count == 4
    assert telemetry.value('mxnet_tpu_io_batches_total') == 4


def test_prefetch_miss_and_stall_counters(telem):
    class SlowIter(pio.DataIter):
        def __init__(self):
            super().__init__(batch_size=1)
            self.n = 0

        def next(self):
            if self.n >= 3:
                raise StopIteration
            self.n += 1
            time.sleep(0.05)
            return pio.DataBatch(data=[mx.nd.ones((1, 2), ctx=CPU)])

    pf = pio.PrefetchingIter(SlowIter(), ctx=CPU)
    assert len(list(pf)) == 3
    assert telemetry.value('mxnet_tpu_io_prefetch_miss_total') >= 1
    assert telemetry.value(
        'mxnet_tpu_io_prefetch_stall_seconds_total') > 0


def test_device_prefetch_gauge_and_overlap_counter(telem):
    x, y = _arrays(12)
    pre = pio.DevicePrefetchIter(NDArrayIter(x, y, batch_size=4, ctx=CPU),
                                 depth=2, ctx=CPU)
    assert len(list(pre)) == 3
    assert telemetry.value('mxnet_tpu_io_device_prefetch_depth') == 0
    assert telemetry.value('mxnet_tpu_io_h2d_overlap_seconds_total') > 0


def test_disabled_leaves_zero_counters():
    telemetry.reset()
    telemetry.disable()
    list(NDArrayIter(onp.zeros((4, 2), onp.float32), None, batch_size=2,
                     ctx=CPU))
    assert telemetry.value('mxnet_tpu_io_batches_total') is None


def test_public_names_match_the_jax_package():
    assert pio.__all__ == jio.__all__
    for name in jio.__all__:
        assert hasattr(pio, name), name
