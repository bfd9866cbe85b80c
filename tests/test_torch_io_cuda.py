"""The input pipeline's copies to the card.

These tests need a CUDA device and carry the ``cuda`` marker; without a
card they skip. On the card, from the root of the checkout (the file
imports only torch, numpy and the port):

    python -m pytest --noconftest -m cuda tests/test_torch_io_cuda.py

They read the committed JPEG fixture (``tools/fixtures/io_smooth.rec``,
64 images of 360 x 480, written by ``tools/io_fixture.py``), so they need
no image encoder. Each plants a slow copy (``torch.cuda._sleep`` queued
on the copy's stream) so that a missing wait would show: the decode
pipeline's lease goes back only after the event behind the copy that
read it (and, with that wait taken out, the same check fails), a pinned
DataLoader batch is never read before its copy's event, DevicePrefetchIter serves both halves of the DataIter protocol,
and the u8 transport (normalized on the card) equals the f32 one
(normalized on the host) bitwise.
"""
import contextlib
import os

import numpy as onp
import pytest
import torch

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.gluon.data import ArrayDataset, DataLoader
from mxnet_tpu_torch.io import DevicePrefetchIter, ImageRecordIter, \
    NDArrayIter, PrefetchingIter

pytestmark = pytest.mark.cuda

ROOT = os.path.normpath(os.path.join(os.path.dirname(__file__), os.pardir))
FIXTURE = os.path.join(ROOT, 'tools', 'fixtures', 'io_smooth.rec')
MEANSTD = dict(mean_r=123.68, mean_g=116.78, mean_b=103.94,
               std_r=58.4, std_g=57.1, std_b=57.4)
SLOW = 50_000_000          # cycles of torch.cuda._sleep, ~25 ms


@pytest.fixture(autouse=True)
def card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    yield


def _iter(transport, **kw):
    args = dict(path_imgrec=FIXTURE, data_shape=(3, 224, 224),
                batch_size=16, resize=256, shuffle=True, seed=3,
                preprocess_threads=os.cpu_count() or 4,
                transport=transport, **MEANSTD)
    args.update(kw)
    return ImageRecordIter(**args)


def _lease_run(mutate_drain):
    """Two epochs of u8 batches with a delay planted on the copy stream
    between the copy that reads each lease and the event behind it, and
    no host sync on the consumer until the end. Returns (batches, the
    returns that found their lease's event unfinished, the drains that
    waited, whether every batch equalled its f32 twin)."""
    it = _iter('u8')
    twin = _iter('f32')
    assert it.native, 'the native decode runtime did not build'
    finish = it._h2d.finish
    events = {}

    def delayed_finish(tensors):
        with torch.cuda.stream(it._h2d.stream):
            torch.cuda._sleep(SLOW)           # the event waits behind this
        return finish(tensors)

    normalize = it._normalize_u8

    def capture(u8):
        out, ev = normalize(u8)
        events[it._lease] = ev
        return out, ev

    it._h2d.finish = delayed_finish
    it._normalize_u8 = capture
    returned = it._pipe.return_lease
    early = []

    def checked_return(lease_id):
        early.append(not events[lease_id].query())
        return returned(lease_id)

    it._pipe.return_lease = checked_return
    pairs = []
    with contextlib.ExitStack() as stack:
        if mutate_drain:
            stack.enter_context(pytest.MonkeyPatch.context()).setattr(
                torch.cuda.Event, 'synchronize', lambda self: None)
        for _ in range(2):
            for b, t in zip(it, twin):
                pairs.append((b, t))
            it.reset()
            twin.reset()
    torch.cuda.synchronize()
    same = all(torch.equal(b.data[0]._data, t.data[0]._data) and
               torch.equal(b.label[0]._data, t.label[0]._data)
               for b, t in pairs)
    return len(pairs), sum(early), it.lease_drain_waits, same


def test_lease_goes_back_only_after_its_copy():
    n, early, waits, same = _lease_run(mutate_drain=False)
    assert n == 8 and same
    # the planted delay was still pending when the drain came, and the
    # drain held every lease until its event had completed
    assert waits > 0, waits
    assert early == 0, early


def test_lease_check_sees_a_missing_drain():
    """The check above has teeth: with the drain's event sync taken out,
    leases go back while the work behind their copy is still queued. (A
    lease is pageable memory, so its copy stages the buffer before it
    returns and the values still agree; the order is what is checked.)"""
    n, early, waits, same = _lease_run(mutate_drain=True)
    assert n == 8 and same
    assert waits > 0 and early > 0, (waits, early)


def test_pinned_loader_batch_is_never_read_before_its_event():
    rng = onp.random.RandomState(0)
    x = rng.randn(64, 1024, 256).astype(onp.float32)
    y = onp.arange(64, dtype=onp.float32)
    loader = DataLoader(ArrayDataset(x, y), batch_size=8, num_workers=2,
                        pin_memory=True)
    assert loader._pin_to == mx.gpu(0)
    pin_and_copy = loader._pin_and_copy

    def slow(out):
        with torch.cuda.stream(loader._stream):
            torch.cuda._sleep(SLOW)
        return pin_and_copy(out)

    loader._pin_and_copy = slow
    for i, (bx, by) in enumerate(loader):
        assert bx._data.is_cuda and bx._data.device == torch.device('cuda', 0)
        # read on the card at once: the current stream waited for the copy
        s = bx._data.sum(dim=(1, 2))
        assert torch.equal(by._data, torch.arange(8 * i, 8 * i + 8,
                                                  dtype=torch.float32,
                                                  device='cuda'))
        onp.testing.assert_allclose(s.cpu().numpy(),
                                    x[8 * i:8 * i + 8].sum(axis=(1, 2)),
                                    rtol=1e-4, atol=1e-2)
    loader.close()


@pytest.mark.parametrize('wrapper', ['device', 'prefetching'])
def test_device_prefetch_protocols_on_the_card(wrapper):
    x = onp.random.RandomState(1).randn(22, 3, 8, 8).astype(onp.float32)
    y = onp.arange(22, dtype=onp.float32)
    ref = [(b.data[0].asnumpy(), b.label[0].asnumpy(), b.pad)
           for b in NDArrayIter(x, y, batch_size=4, ctx=mx.cpu())]

    def make():
        base = NDArrayIter(x, y, batch_size=4, ctx=mx.cpu())
        if wrapper == 'device':
            return DevicePrefetchIter(base, depth=2, ctx=mx.gpu(0))
        return PrefetchingIter(base, device_prefetch=True, ctx=mx.gpu(0))

    it = make()
    for _ in range(2):
        got = []
        for b in it:
            assert b.data[0]._data.is_cuda and b.label[0]._data.is_cuda
            got.append((b.data[0].asnumpy(), b.label[0].asnumpy(), b.pad))
        assert len(got) == len(ref) == 6
        for (a, la, pa), (c, lc, pc) in zip(ref, got):
            assert pa == pc
            onp.testing.assert_array_equal(a, c)
            onp.testing.assert_array_equal(la, lc)
        it.reset()
    got = []
    while it.iter_next():
        got.append((it.getdata()[0].asnumpy(), it.getpad()))
    assert [p for _, p in got] == [r[2] for r in ref]
    for (a, _, _), (c, _) in zip(ref, got):
        onp.testing.assert_array_equal(a, c)


def test_u8_and_f32_transports_agree_bitwise_on_the_card():
    kw = dict(rand_crop=False, rand_mirror=False)
    u8 = [(b.data[0]._data, b.label[0]._data, b.pad)
          for b in _iter('u8', **kw)]
    f32 = [(b.data[0]._data, b.label[0]._data, b.pad)
           for b in _iter('f32', **kw)]
    bf16 = [b.data[0]._data for b in _iter('u8', dtype='bfloat16', **kw)]
    assert len(u8) == len(f32) == len(bf16) == 4
    for (a, la, pa), (c, lc, pc), h in zip(u8, f32, bf16):
        assert a.is_cuda and a.dtype == torch.float32
        assert pa == pc and torch.equal(la, lc)
        assert torch.equal(a, c)
        assert h.dtype == torch.bfloat16 and torch.equal(h, a.to(h.dtype))


def test_image_record_iter_defaults_to_the_card():
    it = _iter('u8')
    b = next(iter(it))
    assert it.ctx == mx.gpu(0) and b.data[0]._data.is_cuda
    assert b.label[0]._data.is_cuda
