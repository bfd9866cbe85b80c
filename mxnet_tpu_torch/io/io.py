"""Data iterators (counterpart of ``mxnet_tpu/io/io.py``; ref:
python/mxnet/io/io.py and src/io/).

Batches are NDArrays on the iterator's context: ``ctx=`` where given,
else the context current when the iterator is made (the card by default;
``with mx.cpu():`` or ``ctx=mx.cpu()`` keeps them on the host). The
context is taken at construction because worker threads do not see the
caller's ``with`` scope.

Host to card: every copy an iterator makes runs on a side CUDA stream of
its own with ``non_blocking=True``, so the training thread never waits for
a copy on the host, and the training stream waits for the copy's event on
the card before it reads the batch (``record_stream`` keeps the caching
allocator from reusing the batch's memory while the training stream may
still read it). ``ImageRecordIter``'s ``u8`` transport copies straight
from the decode pipeline's leased buffer: the lease goes back to the
pipeline only after the event recorded behind the copy and the normalize
that read it has completed (``sync.lease_drain``), so the decode threads
never reuse a buffer under the copy. The lease is pageable memory, and
a copy from pageable memory stages the whole buffer before it returns,
so today the drain finds the buffer read already; it is what keeps the
order once the leases are pinned and the copy reads them on the card's
own time. A wrapper that prefetches an iterator (``DevicePrefetchIter``,
``PrefetchingIter(device_prefetch=True)``) calls it on its own stream, so
the waits an iterator queues for its copies land on that stream and the
consumer's stream waits only for the batch it takes.
"""
from __future__ import annotations

import collections
import contextlib
import os
import threading
import time as _time
import queue as _queue

import numpy as onp
import torch

from ..base import DataError, MXNetError, telem_flags as _telem, \
    torch_dtype
from ..context import current_context
from ..ndarray.ndarray import NDArray, array
from ..resilience import faults as _faults
from ..telemetry import trace as _trace, memory as _memory

__all__ = ['DataDesc', 'DataBatch', 'DataIter', 'ElasticShard',
           'NDArrayIter', 'ResizeIter', 'PrefetchingIter',
           'DevicePrefetchIter', 'CSVIter', 'MNISTIter', 'ImageRecordIter']


# ---------------------------------------------------------------------------
# Device-side normalization (u8 transport). The pipeline hands over raw
# uint8 NHWC (4x fewer bytes than normalized f32) and (x - mean) * (1/std),
# the NHWC->NCHW transpose and the output-dtype cast run where the batch
# lands. Pad rows (partial final batch) are zeroed so both transports
# produce identical batches. The JAX package leaves this to XLA outside
# any Pallas kernel; here it is torch ops.
# ---------------------------------------------------------------------------

_NORM_CACHE = {}


def _device_normalize_fn(mean, std, out_dtype):
    """Cached u8 NHWC -> normalized NCHW converter, one per (mean, std,
    out_dtype): ``fn(u8_nhwc_tensor, count)``."""
    key = (tuple(float(m) for m in mean), tuple(float(s) for s in std),
           str(out_dtype))
    fn = _NORM_CACHE.get(key)
    if fn is None:
        m_host = torch.tensor(key[0], dtype=torch.float32)
        # the native f32 path's arithmetic: multiply by a precomputed
        # reciprocal (std == 0 guarded as the C++ normalize loop does)
        inv_host = torch.tensor(
            onp.asarray([1.0 / s if s != 0.0 else 1.0 for s in key[1]],
                        onp.float32))
        dt = torch_dtype(out_dtype)
        consts = {}

        def fn(u8_nhwc, count):
            dev = u8_nhwc.device
            c = consts.get(dev)
            if c is None:
                c = consts[dev] = (m_host.to(dev), inv_host.to(dev))
            x = (u8_nhwc.to(torch.float32) - c[0]) * c[1]
            x = x.permute(0, 3, 1, 2).to(dt).contiguous()
            if count < x.shape[0]:
                x[count:] = 0
            return x
        _NORM_CACHE[key] = fn
    return fn


def _on(stream):
    """``torch.cuda.stream(stream)``, or nothing for no stream."""
    return (torch.cuda.stream(stream) if stream is not None
            else contextlib.nullcontext())


class _H2D:
    """Host->device copies for one iterator: on a CUDA device they run on
    a side stream with ``non_blocking=True``; ``finish`` records the
    copies' event, makes the caller's stream wait on it and marks the
    tensors as used there. On the CPU everything runs inline."""

    def __init__(self, device):
        self.device = device
        self.stream = (torch.cuda.Stream(device) if device.type == 'cuda'
                       else None)

    def run(self, fn, *host):
        """``fn(*device_copies)`` with the copies (and ``fn``'s work) on
        the side stream."""
        if self.stream is None:
            return fn(*host)
        with torch.cuda.stream(self.stream):
            return fn(*(h.to(self.device, non_blocking=True) for h in host))

    def finish(self, tensors):
        """The copies' event, with the current stream of this device made
        to wait on it (None on the CPU)."""
        if self.stream is None:
            return None
        ev = torch.cuda.Event()
        ev.record(self.stream)
        consumer = torch.cuda.current_stream(self.device)
        consumer.wait_event(ev)
        for t in tensors:
            t.record_stream(consumer)
        return ev


def _batch_tensors(batch):
    out = []
    for arrs in (batch.data or (), batch.label or ()):
        out.extend(a._data for a in arrs if isinstance(a, NDArray))
    return out


def _device_put_batch(batch, ctx=None, stream=None):
    """Stage a DataBatch's arrays on ``ctx``'s device. On a card, host
    arrays are pinned and copied with ``non_blocking=True`` on ``stream``
    (the current stream where None); the copies' event goes on the batch
    as ``_h2d_event`` for ``_await_batch``. Returns the same batch."""
    _faults.fire('io.device_put')
    dev = (ctx if ctx is not None else current_context()).device
    side = None
    if dev.type == 'cuda':
        side = stream if stream is not None \
            else torch.cuda.current_stream(dev)

    def put(x):
        if not isinstance(x, NDArray) or x._data.device == dev:
            return x
        t = x._data.detach()
        if side is not None and t.device.type == 'cpu':
            return NDArray(t.pin_memory().to(dev, non_blocking=True))
        return NDArray(t.to(dev))

    with _trace.span('h2d.device_put'), \
            _memory.oom_guard('io.device_put'), _on(side):
        if batch.data is not None:
            batch.data = [put(d) for d in batch.data]
        if batch.label is not None:
            batch.label = [put(l) for l in batch.label]
        if side is not None:
            ev = torch.cuda.Event()
            ev.record(side)
            batch._h2d_event = (ev, dev)
    return batch


def _await_batch(batch):
    """Make the current stream wait for the copies ``_device_put_batch``
    made for this batch, and mark its tensors as used there. Called on
    the thread that consumes the batch."""
    pending = getattr(batch, '_h2d_event', None)
    if pending is None:
        return batch
    ev, dev = pending
    consumer = torch.cuda.current_stream(dev)
    consumer.wait_event(ev)
    for t in _batch_tensors(batch):
        if t.device == dev:
            t.record_stream(consumer)
    batch._h2d_event = None
    return batch


class DataDesc(collections.namedtuple('DataDesc', ['name', 'shape', 'dtype', 'layout'])):
    def __new__(cls, name, shape, dtype=onp.float32, layout='NCHW'):
        return super().__new__(cls, name, tuple(shape), dtype, layout)

    @staticmethod
    def get_batch_axis(layout):
        if layout is None:
            return 0
        return layout.find('N')


class DataBatch:
    """Ref: python/mxnet/io/io.py DataBatch."""

    def __init__(self, data, label=None, pad=None, index=None,
                 bucket_key=None, provide_data=None, provide_label=None):
        self.data = data
        self.label = label
        self.pad = pad
        self.index = index
        self.bucket_key = bucket_key
        self.provide_data = provide_data
        self.provide_label = provide_label

    def __str__(self):
        data_shapes = [d.shape for d in self.data] if self.data else None
        label_shapes = [l.shape for l in self.label] if self.label else None
        return f"DataBatch: data shapes: {data_shapes} label shapes: {label_shapes}"


class DataIter:
    """Ref: io.py DataIter ABC."""

    def __init__(self, batch_size=0):
        self.batch_size = batch_size

    def __iter__(self):
        return self

    def reset(self):
        pass

    def next(self):
        if self.iter_next():
            return DataBatch(data=self.getdata(), label=self.getlabel(),
                             pad=self.getpad(), index=self.getindex())
        raise StopIteration

    def __next__(self):
        if not _telem['on']:
            # consumer-side input wait: the 'io.batch' span is the
            # input-bound bucket of telemetry.attribution
            with _trace.span('io.batch'):
                return self.next()
        # batch-latency histogram: the host side of producing one batch
        # (decode/augment/copy), the IO half of any input stall
        from .. import telemetry as _telemetry
        t0 = _time.perf_counter()
        with _trace.span('io.batch'):
            batch = self.next()
        _telemetry.observe('mxnet_tpu_io_batch_latency_seconds',
                           _time.perf_counter() - t0)
        _telemetry.inc('mxnet_tpu_io_batches_total')
        return batch

    def iter_next(self):
        raise NotImplementedError

    def getdata(self):
        raise NotImplementedError

    def getlabel(self):
        raise NotImplementedError

    def getindex(self):
        return None

    def getpad(self):
        raise NotImplementedError


class ElasticShard:
    """World-indexed deterministic sample assignment for elastic data
    parallelism, the data-plane half of scale-down/scale-up re-forms (the
    JAX package's class, unchanged).

    The GLOBAL batch is the unit of progress: every training step
    consumes exactly ``global_batch`` samples fleet-wide, and rank ``r``
    of world ``w`` owns the half-open block ``[r*G/w, (r+1)*G/w)`` of it.
    The global ``position`` advances by ``G`` per step on every rank, so
    ``reshard(rank, world)`` at a restored position re-partitions the same
    global sequence: across any shrink->grow chain no sample is dropped
    or double-seen.

    Sample order: epoch ``e`` (= ``position // num_samples``) draws a
    fresh ``RandomState(seed + e)`` permutation when ``shuffle`` is on
    (identity order otherwise); a batch crossing the epoch boundary takes
    the tail of one permutation and the head of the next.

    ``state()`` round-trips through the checkpoint manifest
    (``CheckpointManager.bind_data_state``)."""

    def __init__(self, num_samples, global_batch, rank=0, world=1,
                 seed=0, position=0, shuffle=True):
        num_samples = int(num_samples)
        global_batch = int(global_batch)
        if num_samples <= 0:
            raise MXNetError("ElasticShard: num_samples must be > 0")
        if global_batch <= 0:
            raise MXNetError("ElasticShard: global_batch must be > 0")
        self.num_samples = num_samples
        self.global_batch = global_batch
        self.seed = int(seed)
        self.shuffle = bool(shuffle)
        self.position = int(position)
        self.rank = 0
        self.world = 1
        self._perms = {}
        self.reshard(rank, world)

    def reshard(self, rank, world):
        """Re-partition the SAME global sequence across a new world:
        the position is untouched, only this rank's block changes."""
        rank, world = int(rank), int(world)
        if world <= 0 or not 0 <= rank < world:
            raise MXNetError(
                f"ElasticShard: rank {rank} not in world {world}")
        if self.global_batch % world:
            raise MXNetError(
                f"ElasticShard: global_batch {self.global_batch} not "
                f"divisible by world {world} — a re-form at that world "
                f"would drop or double samples")
        self.rank = rank
        self.world = world
        return self

    @property
    def epoch(self):
        return self.position // self.num_samples

    @property
    def batch_size(self):
        """Per-rank samples per step at the current world."""
        return self.global_batch // self.world

    def _perm(self, epoch):
        if not self.shuffle:
            return None
        p = self._perms.get(epoch)
        if p is None:
            rng = onp.random.RandomState((self.seed + epoch) & 0x7fffffff)
            p = rng.permutation(self.num_samples)
            self._perms[epoch] = p
            # keep only the two epochs a batch can straddle
            for k in list(self._perms):
                if k < epoch - 1:
                    del self._perms[k]
        return p

    def sample_at(self, g):
        """Global-order index -> dataset sample id."""
        e, slot = divmod(int(g), self.num_samples)
        p = self._perm(e)
        return int(slot if p is None else p[slot])

    def next_batch(self):
        """This rank's sample ids of the next global batch, advancing
        the global position by ``global_batch``."""
        per = self.global_batch // self.world
        base = self.position + self.rank * per
        ids = [self.sample_at(base + j) for j in range(per)]
        self.position += self.global_batch
        return ids

    def assignment(self):
        """{rank: [lo, hi)}: each rank's sample-offset block within
        every global batch at the current world."""
        per = self.global_batch // self.world
        return {str(r): [r * per, (r + 1) * per]
                for r in range(self.world)}

    def state(self):
        """Manifest-ready snapshot: epoch position + per-rank shard
        assignment (see ``CheckpointManager.bind_data_state``)."""
        return {'position': int(self.position),
                'epoch': int(self.epoch),
                'num_samples': int(self.num_samples),
                'global_batch': int(self.global_batch),
                'seed': int(self.seed),
                'shuffle': bool(self.shuffle),
                'world': int(self.world),
                'rank': int(self.rank),
                'assignment': self.assignment()}

    @classmethod
    def from_state(cls, state, rank=None, world=None):
        """Rebuild from a manifest-recorded state, optionally re-sharded
        for a new (rank, world)."""
        s = dict(state or {})
        return cls(num_samples=s['num_samples'],
                   global_batch=s['global_batch'],
                   rank=s.get('rank', 0) if rank is None else rank,
                   world=s.get('world', 1) if world is None else world,
                   seed=s.get('seed', 0),
                   position=s.get('position', 0),
                   shuffle=s.get('shuffle', True))


class NDArrayIter(DataIter):
    """Iterate over in-memory arrays (ref: io.py NDArrayIter).

    Pass an ``ElasticShard`` as ``shard`` for elastic data parallelism:
    the shard then owns the sample order and the per-rank batch size,
    and ``reset()`` starts a new pass WITHOUT rewinding the global
    position (checkpointed via ``data_state()``, re-partitioned via
    ``reshard()``). ``shuffle`` draws from numpy's global generator, as
    in the JAX package."""

    def __init__(self, data, label=None, batch_size=1, shuffle=False,
                 last_batch_handle='pad', data_name='data',
                 label_name='softmax_label', shard=None, ctx=None):
        super().__init__(batch_size)
        self.ctx = ctx if ctx is not None else current_context()
        self.data = _init_data(data, allow_empty=False, default_name=data_name)
        self.label = _init_data(label, allow_empty=True, default_name=label_name)
        self.idx = onp.arange(self.data[0][1].shape[0])
        self.shuffle = shuffle
        self.last_batch_handle = last_batch_handle
        self.num_data = self.idx.shape[0]
        if last_batch_handle == 'discard':
            self.num_data = (self.num_data // batch_size) * batch_size
        self.shard = shard
        if shard is not None:
            if shard.num_samples != self.idx.shape[0]:
                raise MXNetError(
                    f"NDArrayIter: shard covers {shard.num_samples} "
                    f"samples but the data has {self.idx.shape[0]}")
            self.batch_size = shard.batch_size
            self._shard_batches = max(
                1, self.num_data // shard.global_batch)
            self._shard_taken = 0
            self._shard_ids = None
        self.cursor = -batch_size
        self._cache = None
        self.reset()

    @property
    def provide_data(self):
        return [DataDesc(k, (self.batch_size,) + tuple(v.shape[1:]),
                         v.dtype if hasattr(v, 'dtype') else onp.float32)
                for k, v in self.data]

    @property
    def provide_label(self):
        return [DataDesc(k, (self.batch_size,) + tuple(v.shape[1:]),
                         v.dtype if hasattr(v, 'dtype') else onp.float32)
                for k, v in self.label]

    def reset(self):
        if self.shard is not None:
            # a new pass, not a rewind: the shard's global position is
            # the stream state and only a checkpoint restore moves it
            self._shard_taken = 0
            return
        if self.shuffle:
            onp.random.shuffle(self.idx)
        self.cursor = -self.batch_size

    def iter_next(self):
        if self.shard is not None:
            if self._shard_taken >= self._shard_batches:
                return False
            # draw once per batch: getdata/getlabel must see the same
            # sample ids, and the draw advances the global position
            self._shard_ids = onp.asarray(self.shard.next_batch())
            self._shard_taken += 1
            return True
        self.cursor += self.batch_size
        return self.cursor < self.num_data

    def _take(self, arrs):
        if self.shard is not None:
            return [array(v[self._shard_ids], self.ctx) for _, v in arrs]
        out = []
        end = self.cursor + self.batch_size
        for _, v in arrs:
            if end <= self.num_data:
                sel = self.idx[self.cursor:end]
            else:
                if self.last_batch_handle == 'roll_over':
                    raise StopIteration
                pad = end - self.num_data
                sel = onp.concatenate([self.idx[self.cursor:], self.idx[:pad]])
            out.append(array(v[sel], self.ctx))
        return out

    def getdata(self):
        return self._take(self.data)

    def getlabel(self):
        return self._take(self.label)

    def getpad(self):
        if self.shard is not None:
            return 0     # epoch wrap re-permutes instead of padding
        end = self.cursor + self.batch_size
        if end > self.num_data:
            return end - self.num_data
        return 0

    def data_state(self):
        """Manifest-ready data-position state (None without a shard):
        bind to a CheckpointManager via ``bind_data_state``."""
        return None if self.shard is None else self.shard.state()

    def reshard(self, rank, world):
        """Re-partition the sample stream after a re-form (shrink or
        grow): same global position, new per-rank block."""
        if self.shard is None:
            raise MXNetError("NDArrayIter: no ElasticShard attached")
        self.shard.reshard(rank, world)
        self.batch_size = self.shard.batch_size
        return self


def _init_data(data, allow_empty, default_name):
    if data is None:
        if not allow_empty:
            raise MXNetError("data cannot be None")
        return []
    if isinstance(data, (onp.ndarray, NDArray)):
        data = [data]
    if isinstance(data, (list, tuple)):
        data = collections.OrderedDict(
            [(default_name if len(data) == 1 else f"_{i}_{default_name}", d)
             for i, d in enumerate(data)])
    out = []
    for k, v in data.items():
        if isinstance(v, NDArray):
            v = v.asnumpy()
        out.append((k, onp.asarray(v)))
    return out


class ResizeIter(DataIter):
    """Resize (truncate/loop) another iterator (ref: io.py ResizeIter)."""

    def __init__(self, data_iter, size, reset_internal=True):
        super().__init__(data_iter.batch_size)
        self.data_iter = data_iter
        self.size = size
        self.reset_internal = reset_internal
        self.cur = 0
        self.current_batch = None

    @property
    def provide_data(self):
        return self.data_iter.provide_data

    @property
    def provide_label(self):
        return self.data_iter.provide_label

    def reset(self):
        self.cur = 0
        if self.reset_internal:
            self.data_iter.reset()

    def iter_next(self):
        if self.cur == self.size:
            return False
        try:
            self.current_batch = self.data_iter.next()
        except StopIteration:
            self.data_iter.reset()
            self.current_batch = self.data_iter.next()
        self.cur += 1
        return True

    def getdata(self):
        return self.current_batch.data

    def getlabel(self):
        return self.current_batch.label

    def getindex(self):
        return self.current_batch.index

    def getpad(self):
        return self.current_batch.pad


class PrefetchingIter(DataIter):
    """Background-thread prefetcher (ref: io.py PrefetchingIter /
    src/io/iter_prefetcher.h). A worker's exception is raised in the
    consumer. With ``device_prefetch`` the worker also stages each batch
    on ``ctx`` (a side stream on a card; the consumer's stream waits on
    the copy's event when it takes the batch)."""

    def __init__(self, iters, rename_data=None, rename_label=None, depth=2,
                 device_prefetch=False, ctx=None):
        if not isinstance(iters, (list, tuple)):
            iters = [iters]
        assert len(iters) == 1, "single backing iter supported"
        self.iter = iters[0]
        super().__init__(self.iter.batch_size)
        self._depth = depth
        self._device_prefetch = bool(device_prefetch)
        self._ctx = ctx if ctx is not None else current_context()
        self._stream = None
        if self._device_prefetch and self._ctx.device.type == 'cuda':
            self._stream = torch.cuda.Stream(self._ctx.device)
        self._queue = _queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._thread = None
        self._peek = None
        self._start()

    @property
    def provide_data(self):
        return self.iter.provide_data

    @property
    def provide_label(self):
        return self.iter.provide_label

    def _start(self):
        # the worker captures ITS OWN stop event and queue: after a
        # reset() whose join timed out, a stale worker must keep seeing
        # the set event (and feed the discarded queue), never the fresh
        # ones
        stop_evt, q, it = self._stop, self._queue, self.iter

        def worker():
            while not stop_evt.is_set():
                try:
                    with _on(self._stream):
                        batch = it.next()
                except StopIteration:
                    q.put(None)
                    return
                except BaseException as e:   # surface in the consumer,
                    q.put(e)                 # don't die into a deadlock
                    return
                if self._device_prefetch:
                    try:
                        batch = _device_put_batch(batch, self._ctx,
                                                  self._stream)
                    except BaseException as e:
                        q.put(e)
                        return
                q.put(batch)
        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def reset(self):
        self._stop.set()
        try:
            while True:
                self._queue.get_nowait()
        except _queue.Empty:
            pass
        if self._thread is not None:
            self._thread.join(timeout=5)
        self.iter.reset()
        self._stop = threading.Event()
        self._queue = _queue.Queue(maxsize=self._depth)
        self._peek = None
        self._start()

    def next(self):
        if self._peek is not None:
            batch, self._peek = self._peek, None
            return batch
        return self._fetch()

    def _fetch(self):
        if _telem['on'] and self._queue.empty():
            # prefetch miss: the background thread hasn't kept up.
            # Waiting for the end-of-epoch sentinel is not a miss.
            t0 = _time.perf_counter()
            with _trace.span('io.prefetch_wait'):
                batch = self._queue.get()
            if batch is not None:
                from .. import telemetry as _telemetry
                _telemetry.inc('mxnet_tpu_io_prefetch_miss_total')
                _telemetry.counter(
                    'mxnet_tpu_io_prefetch_stall_seconds_total').inc(
                    _time.perf_counter() - t0)
        else:
            with _trace.span('io.prefetch_wait'):
                batch = self._queue.get()
        if batch is None:
            raise StopIteration
        if isinstance(batch, BaseException):
            raise batch   # worker-thread failure, surfaced here
        return _await_batch(batch) if isinstance(batch, DataBatch) \
            else batch

    def iter_next(self):
        try:
            self._peek = self._fetch()
            return True
        except StopIteration:
            self._peek = None
            return False

    def getdata(self):
        return self._peek.data

    def getlabel(self):
        return self._peek.label

    def getindex(self):
        return self._peek.index

    def getpad(self):
        return self._peek.pad


class DevicePrefetchIter(DataIter):
    """Keeps ``depth`` batches in flight on the device ahead of the
    consumer.

    Wraps any DataIter: each batch is staged on ``ctx``'s device as soon
    as the backing iterator produces it. On a card, host arrays are
    pinned and copied with ``non_blocking=True`` on this iterator's side
    stream, so the copies overlap the consumer's step; each batch carries
    the copies' event, and the consumer's stream waits on it when the
    batch is handed out. Double-buffered by default (depth=2)."""

    def __init__(self, data_iter, depth=2, ctx=None):
        super().__init__(data_iter.batch_size)
        self.iter = data_iter
        self._depth = max(1, int(depth))
        self._ctx = ctx if ctx is not None else current_context()
        dev = self._ctx.device
        self._stream = (torch.cuda.Stream(dev) if dev.type == 'cuda'
                        else None)
        self._buf = collections.deque()   # (batch, dispatch timestamp)
        self._ended = False
        self._peek = None
        # the in-flight device batches are live device memory the step's
        # own pools never see: tracked as 'io_leases'
        _memory.register_provider(self)

    def memory_pools(self):
        """In-flight device-prefetched batches as the ``io_leases``
        residency pool (telemetry.memory fallback watermark)."""
        leases = {}
        for i, (batch, _t0) in enumerate(self._buf):
            for kind, arrs in (('data', batch.data or ()),
                               ('label', batch.label or ())):
                for j, a in enumerate(arrs):
                    if isinstance(a, NDArray):
                        leases[f'inflight{i}/{kind}{j}'] = a._data
        return {'io_leases': leases}

    @property
    def provide_data(self):
        return self.iter.provide_data

    @property
    def provide_label(self):
        return self.iter.provide_label

    def _fill(self):
        while not self._ended and len(self._buf) < self._depth:
            try:
                # the backing iterator's own copies (ImageRecordIter's)
                # are waited for on this stream, not the consumer's
                with _on(self._stream):
                    batch = self.iter.next()
            except StopIteration:
                self._ended = True
                break
            self._buf.append((_device_put_batch(batch, self._ctx,
                                                self._stream),
                              _time.perf_counter()))
        if _telem['on']:
            from .. import telemetry as _telemetry
            _telemetry.set_gauge('mxnet_tpu_io_device_prefetch_depth',
                                 len(self._buf))

    def next(self):
        if self._peek is not None:
            batch, self._peek = self._peek, None
            return batch
        return self._fetch()

    def _fetch(self):
        if not self._buf:
            self._fill()
        if not self._buf:
            raise StopIteration
        batch, t0 = self._buf.popleft()
        # start the replacement transfer BEFORE handing the batch to the
        # consumer, so `depth` copies overlap its compute
        self._fill()
        if _telem['on']:
            # the window the transfer had to complete in
            from .. import telemetry as _telemetry
            _telemetry.counter(
                'mxnet_tpu_io_h2d_overlap_seconds_total').inc(
                _time.perf_counter() - t0)
        return _await_batch(batch)

    def iter_next(self):
        try:
            self._peek = self._fetch()
            return True
        except StopIteration:
            self._peek = None
            return False

    def getdata(self):
        return self._peek.data

    def getlabel(self):
        return self._peek.label

    def getindex(self):
        return self._peek.index

    def getpad(self):
        return self._peek.pad

    def reset(self):
        self._buf.clear()
        self._ended = False
        self._peek = None
        self.iter.reset()


class CSVIter(NDArrayIter):
    """Ref: src/io/iter_csv.cc:218."""

    def __init__(self, data_csv, data_shape, label_csv=None, label_shape=(1,),
                 batch_size=1, **kwargs):
        data = onp.loadtxt(data_csv, delimiter=',', dtype=onp.float32)
        data = data.reshape((-1,) + tuple(data_shape))
        label = None
        if label_csv is not None:
            label = onp.loadtxt(label_csv, delimiter=',', dtype=onp.float32)
            label = label.reshape((-1,) + tuple(label_shape))
        super().__init__(data, label, batch_size, **kwargs)


class MNISTIter(NDArrayIter):
    """Ref: src/io/iter_mnist.cc:260; reads idx-format MNIST files."""

    def __init__(self, image, label, batch_size=128, shuffle=True,
                 flat=False, **kwargs):
        import gzip
        import struct

        def read_idx(path):
            opener = gzip.open if path.endswith('.gz') else open
            with opener(path, 'rb') as f:
                magic = struct.unpack('>HBB', f.read(4))
                dims = struct.unpack('>' + 'I' * magic[2], f.read(4 * magic[2]))
                return onp.frombuffer(f.read(), dtype=onp.uint8).reshape(dims)

        img = read_idx(image).astype(onp.float32) / 255.0
        lab = read_idx(label).astype(onp.float32)
        if flat:
            img = img.reshape(img.shape[0], -1)
        else:
            img = img.reshape(img.shape[0], 1, img.shape[1], img.shape[2])
        super().__init__(img, lab, batch_size, shuffle=shuffle, **kwargs)


class ImageRecordIter(DataIter):
    """RecordIO-backed image iterator (ref: src/io/iter_image_recordio_2.cc:880).

    Decodes JPEGs from a .rec file (the native pipeline of
    ``csrc/io/mxtpu_io.cc``, or PIL), applies the decode-side
    augmentations, batches and prefetches. Two transports over the host
    boundary:

    - ``transport='u8'`` (default): the pipeline hands over raw uint8
      NHWC batches in a leased buffer; the copy to the device reads the
      lease itself and mean/std normalization, the NHWC->NCHW transpose
      and the cast to ``dtype`` run on the device. The lease goes back
      at the next batch, after the event behind that copy and normalize
      has completed (``sync.lease_drain``; ``lease_drain_waits`` counts
      the drains that found it unfinished).
    - ``transport='f32'``: normalization on the host in the C++ workers,
      the batch copied out.

    ``native`` says whether the native pipeline serves this iterator
    (JPEG data with a buildable library and no per-record policy) or the
    PIL path does. Env override: ``MXNET_TPU_IO_TRANSPORT=f32|u8``.
    """

    def __init__(self, path_imgrec, data_shape, batch_size=1, label_width=1,
                 shuffle=False, rand_crop=False, rand_mirror=False,
                 mean_r=0.0, mean_g=0.0, mean_b=0.0, std_r=1.0, std_g=1.0,
                 std_b=1.0, resize=-1, path_imgidx=None,
                 preprocess_threads=4, prefetch_buffer=4, seed=0,
                 transport=None, dtype='float32', decode_cache_mb=None,
                 corrupt_policy=None, ctx=None, **kwargs):
        super().__init__(batch_size)
        from .. import config as _config
        self.ctx = ctx if ctx is not None else current_context()
        self._rec_path = path_imgrec
        self.data_shape = tuple(data_shape)
        self.label_width = label_width
        self.shuffle = shuffle
        self.rand_crop = rand_crop
        self.rand_mirror = rand_mirror
        self.mean = onp.array([mean_r, mean_g, mean_b], onp.float32).reshape(3, 1, 1)
        self.std = onp.array([std_r, std_g, std_b], onp.float32).reshape(3, 1, 1)
        self._inv_std = onp.asarray(
            [1.0 / s if s != 0.0 else 1.0
             for s in self.std.reshape(3).tolist()],
            onp.float32).reshape(3, 1, 1)
        self.resize = resize
        if transport is None:
            transport = _config.get('MXNET_TPU_IO_TRANSPORT')
        if transport not in ('u8', 'f32'):
            raise MXNetError(f"transport must be 'u8' or 'f32', "
                             f"got {transport!r}")
        if transport == 'f32' and torch_dtype(dtype) != torch.float32:
            # the host path materializes normalized float32; only the
            # device-side normalize can cast for free
            raise MXNetError("dtype=%r requires transport='u8' "
                             "(f32 transport emits float32)" % (dtype,))
        self.transport = transport
        self.dtype = dtype
        if decode_cache_mb is None:
            decode_cache_mb = float(
                _config.get('MXNET_TPU_IO_DECODE_CACHE_MB'))
        self.decode_cache_mb = decode_cache_mb
        if corrupt_policy is None:
            corrupt_policy = _config.get('MXNET_TPU_IO_CORRUPT_POLICY')
        if corrupt_policy not in ('error', 'skip'):
            raise MXNetError(f"corrupt_policy must be 'error' or 'skip', "
                             f"got {corrupt_policy!r}")
        self.corrupt_policy = corrupt_policy
        self._h2d = _H2D(self.ctx.device)
        self._lease = None
        self._lease_event = None      # the event behind the lease's reader
        self.lease_drains = 0
        self.lease_drain_waits = 0
        self._cache_emitted = (0, 0)  # (hits, misses) already counted
        self._pipe = None
        # the per-record skip policy and the io.decode fault site live in
        # the python decode path; the native pipeline surfaces a corrupt
        # record as a hard DataError. Honour the requested semantics by
        # taking the python path (warned: it costs throughput).
        want_python = corrupt_policy == 'skip' or \
            'io.decode' in _faults.active()
        if want_python and self.data_shape[0] == 3:
            import warnings
            warnings.warn(
                "ImageRecordIter: corrupt_policy='skip' (or an armed "
                "io.decode fault) uses the pure-Python decode path — "
                "the native pipeline cannot skip individual corrupt "
                "records. Expect lower decode throughput.",
                RuntimeWarning, stacklevel=2)
        if self.data_shape[0] == 3 and not want_python:
            self._pipe = _NativePipeline.try_create(
                path_imgrec, batch_size, self.data_shape, label_width,
                preprocess_threads, prefetch_buffer, resize, shuffle,
                rand_crop, rand_mirror, seed,
                (mean_r, mean_g, mean_b), (std_r, std_g, std_b),
                output_u8=(transport == 'u8'),
                cache_bytes=int(decode_cache_mb * 1024 * 1024))
        if self._pipe is not None:
            self._batch_data = None
            return
        # pure-Python path (non-JPEG data or no native library): a lazy
        # index of record offsets + positional reads per batch
        self._offsets = self._scan_offsets(path_imgrec)
        self._fd = os.open(path_imgrec, os.O_RDONLY)
        self._decode_workers = max(1, int(preprocess_threads))
        self._pool = None   # persistent decode pool, created on first use
        self._order = onp.arange(len(self._offsets))
        self.cursor = -batch_size

    @property
    def native(self):
        """True when the native C++ pipeline serves this iterator, False
        on the PIL path."""
        return self._pipe is not None

    @staticmethod
    def _scan_offsets(path):
        """One framing pass over the .rec recording (payload_pos, len)
        per record; payloads are seeked over, not read."""
        import struct
        offsets = []
        with open(path, 'rb') as f:
            f.seek(0, os.SEEK_END)
            fsize = f.tell()
            pos = 0
            while pos < fsize:
                f.seek(pos)
                head = f.read(8)
                if len(head) < 8:
                    raise MXNetError(f"truncated record header in {path}")
                magic, lrec = struct.unpack('<II', head)
                if magic != 0xced7230a:
                    raise MXNetError(f"invalid record magic in {path}")
                length = lrec & ((1 << 29) - 1)
                pad = (4 - length % 4) % 4
                if pos + 8 + length > fsize:
                    raise MXNetError(f"truncated record payload in {path}")
                offsets.append((pos + 8, length))
                pos += 8 + length + pad
        return offsets

    def _read_record(self, i):
        """(label, image bytes) for record i via positional read (thread-
        safe). A truncated or unpackable record raises DataError naming
        the record index and file offset."""
        from .. import recordio
        pos, length = self._offsets[i]
        buf = os.pread(self._fd, length, pos)
        if len(buf) != length:
            raise DataError(
                f"truncated record {i} at offset {pos} in "
                f"{self._rec_path}: read {len(buf)} of {length} bytes",
                index=i, offset=pos, path=self._rec_path)
        try:
            header, img_bytes = recordio.unpack(buf)
        except Exception as e:
            raise DataError(
                f"corrupt record {i} at offset {pos} in "
                f"{self._rec_path}: cannot unpack IRHeader: {e}",
                index=i, offset=pos, path=self._rec_path)
        return header.label, img_bytes

    def _load_and_decode(self, i):
        """(label, decoded HWC image) for record i; every record-shaped
        failure surfaces as DataError with the record index + offset."""
        label, buf = self._read_record(i)
        # keyed by record index, not call order: the decode thread pool
        # must corrupt the same records in every run
        if _faults.fire('io.decode', occurrence=i + 1) == 'corrupt':
            buf = _faults.corrupt_bytes(buf, occurrence=i)
        pos, _length = self._offsets[i]
        try:
            img = self._decode_image(buf)
        except MXNetError:
            raise        # environment problems (no PIL) are not DataErrors
        except Exception as e:
            raise DataError(
                f"corrupt image in record {i} at offset {pos} in "
                f"{self._rec_path}: {type(e).__name__}: {e}",
                index=i, offset=pos, path=self._rec_path)
        return label, img

    def _load_with_policy(self, i, rnd):
        """corrupt_policy='error': DataError propagates.
        corrupt_policy='skip': each corrupt record is counted
        (mxnet_tpu_io_corrupt_records_total) and the next readable record
        is substituted, at most 16 in a row."""
        j = i
        for attempt in range(16):
            try:
                label, img = self._load_and_decode(j)
                return label, self._augment(img, rnd)
            except DataError as e:
                if self.corrupt_policy != 'skip':
                    raise
                if _telem['on']:
                    from .. import telemetry as _telemetry
                    _telemetry.inc('mxnet_tpu_io_corrupt_records_total')
                import logging
                logging.getLogger('mxnet_tpu_torch.io').warning(
                    "skipping corrupt record (policy=skip): %s", e)
                j = (j + 1) % len(self._offsets)
        raise DataError(
            f"{self._rec_path}: 16 consecutive corrupt records starting "
            f"at index {i} — refusing to keep skipping "
            f"(corrupt_policy='skip')", index=i, path=self._rec_path)

    def _decode_image(self, buf):
        import io as _io
        try:
            from PIL import Image
        except ImportError:
            raise MXNetError("image decode requires PIL")
        return onp.asarray(Image.open(_io.BytesIO(buf)).convert('RGB'))

    @property
    def provide_data(self):
        return [DataDesc('data', (self.batch_size,) + self.data_shape,
                         self.dtype)]

    @property
    def provide_label(self):
        shape = (self.batch_size,) if self.label_width == 1 \
            else (self.batch_size, self.label_width)
        return [DataDesc('softmax_label', shape)]

    def _return_lease(self):
        if self._lease is None or self._pipe is None:
            return
        # the copy that reads the leased buffer, and the normalize after
        # it, were queued on the side stream: the buffer goes back to the
        # decode threads only once they have run. A CUDA error raises.
        ev, self._lease_event = self._lease_event, None
        with _trace.span('sync.lease_drain'):
            if ev is not None:
                self.lease_drains += 1
                if not ev.query():
                    self.lease_drain_waits += 1
                    ev.synchronize()
        self._pipe.return_lease(self._lease)
        self._lease = None

    def reset(self):
        if self._pipe is not None:
            self._return_lease()
            self._pipe.reset()
            self._batch_data = None
            return
        if self.shuffle:
            onp.random.shuffle(self._order)
        self.cursor = -self.batch_size

    def close(self):
        """Release native leases / the fallback file handle and pool."""
        if self._pipe is not None:
            self._return_lease()
            return
        if getattr(self, '_fd', None) is not None:
            os.close(self._fd)
            self._fd = None
        if self._pool is not None:
            self._pool.shutdown(wait=False)
            self._pool = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def _emit_cache_stats(self):
        if not _telem['on'] or self._pipe is None:
            return
        from .. import telemetry as _telemetry
        hits, misses, nbytes = self._pipe.cache_stats()
        h0, m0 = self._cache_emitted
        if hits > h0:
            _telemetry.inc('mxnet_tpu_io_decode_cache_hits_total',
                           hits - h0)
        if misses > m0:
            _telemetry.inc('mxnet_tpu_io_decode_cache_misses_total',
                           misses - m0)
        self._cache_emitted = (hits, misses)
        _telemetry.set_gauge('mxnet_tpu_io_decode_cache_bytes', nbytes)

    def iter_next(self):
        if self._pipe is not None:
            if not getattr(self, '_warned_native_fault', False) and \
                    _faults.is_armed('io.decode'):
                # armed after construction (construction-time arming
                # selects the python path): the native pipeline has no
                # per-record hook, so the fault cannot fire here
                self._warned_native_fault = True
                import warnings
                warnings.warn(
                    "ImageRecordIter: an io.decode fault was armed "
                    "after this iterator selected the native pipeline — "
                    "the fault cannot fire on this path. Arm MXTPU_FAULT "
                    "before constructing the iterator (it then uses the "
                    "python decode path).", RuntimeWarning)
            # the previous batch's lease goes back only now, after the
            # copy that read it has completed
            self._return_lease()
            if self.transport == 'u8':
                with _trace.span('io.lease'):
                    got = self._pipe.next_lease()
                if got is None:
                    self._batch_data = None
                    self._emit_cache_stats()
                    return False
                data, label, count, lease_id = got
                self._lease = lease_id
            else:
                with _trace.span('io.lease'):
                    got = self._pipe.next()
                if got is None:
                    self._batch_data = None
                    self._emit_cache_stats()
                    return False
                data, label, count = got
            self._pad = self.batch_size - count
            self._count = count
            self._batch_data = data
            self._labels = (label[:, 0] if self.label_width == 1 else label)
            return True
        self.cursor += self.batch_size
        # the final partial batch is padded (matching the native pipeline)
        # rather than dropped, so epoch size is identical on both paths
        return self.cursor < len(self._offsets)

    def _augment(self, img, rnd):
        """Decode-side augmentations -> HWC uint8 at target size. `rnd` is
        (crop_y_frac, crop_x_frac, mirror) drawn on the batch thread so
        pooled decoding stays deterministic for a given seed."""
        c, h, w = self.data_shape
        if self.resize > 0:
            from PIL import Image
            im = Image.fromarray(img)
            short = min(im.size)
            scale = self.resize / short
            im = im.resize((int(im.size[0] * scale), int(im.size[1] * scale)))
            img = onp.asarray(im)
        ih, iw = img.shape[:2]
        if self.rand_crop and (ih > h or iw > w):
            y = int(rnd[0] * (ih - h + 1))
            x = int(rnd[1] * (iw - w + 1))
        else:
            y = max(0, (ih - h) // 2)
            x = max(0, (iw - w) // 2)
        img = img[y:y + h, x:x + w]
        if img.shape[0] != h or img.shape[1] != w:
            from PIL import Image
            img = onp.asarray(Image.fromarray(img).resize((w, h)))
        if rnd[2]:
            img = img[:, ::-1]
        return img

    def _host_normalize(self, hwc):
        """(x - mean) * (1/std): the native runtime's arithmetic and the
        device normalize's, so the two transports agree bitwise on this
        path too (the JAX package's python path divides by std, within
        one float32 ulp of this)."""
        chw = hwc.transpose(2, 0, 1).astype(onp.float32)
        return (chw - self.mean) * self._inv_std

    def _count_host_bytes(self, nbytes):
        if _telem['on']:
            from .. import telemetry as _telemetry
            _telemetry.counter('mxnet_tpu_io_host_bytes_total').inc(nbytes)

    def _normalize_u8(self, u8_nhwc):
        """The u8 NHWC host batch normalized on the iterator's device;
        returns (tensor, event behind the copy and the normalize)."""
        fn = _device_normalize_fn(self.mean.reshape(3), self.std.reshape(3),
                                  self.dtype)
        count = self._count
        with _trace.span('h2d.normalize'), \
                _memory.oom_guard('io.device_put'):
            out = self._h2d.run(lambda d: fn(d, count), u8_nhwc)
            ev = self._h2d.finish([out])
        return out, ev

    def _to_ctx(self, host, pin=False):
        """A float32 host array as an NDArray on the iterator's device
        (on a card, copied on the side stream). A copy from pageable
        memory first waits on the host for the side stream's earlier
        work (the u8 normalize); ``pin`` stages small arrays in pinned
        memory so that their copy does not."""
        if self._h2d.stream is None:
            return array(host, self.ctx)
        t = torch.from_numpy(host)
        out = self._h2d.run(lambda d: d, t.pin_memory() if pin else t)
        self._h2d.finish([out])
        return NDArray(out)

    def getdata(self):
        if self._pipe is not None:
            self._count_host_bytes(self._batch_data.nbytes)
            if self.transport == 'u8':
                out, self._lease_event = self._normalize_u8(
                    torch.from_numpy(self._batch_data))
                return [NDArray(out)]
            return [self._to_ctx(self._batch_data)]
        # fallback: decode the batch on the persistent thread pool (PIL
        # and numpy release the GIL for the heavy parts)
        end = min(self.cursor + self.batch_size, len(self._offsets))
        idxs = [int(self._order[i]) for i in range(self.cursor, end)]
        rnds = [(onp.random.rand(), onp.random.rand(),
                 bool(self.rand_mirror and onp.random.rand() < 0.5))
                for _ in idxs]

        def work(args):
            i, rnd = args
            return self._load_with_policy(i, rnd)

        with _trace.span('io.decode', records=len(idxs)):
            if self._decode_workers > 1 and len(idxs) > 1:
                if self._pool is None:
                    from concurrent.futures import ThreadPoolExecutor
                    self._pool = ThreadPoolExecutor(
                        max_workers=self._decode_workers,
                        thread_name_prefix='mxtpu-io-decode')
                results = list(self._pool.map(work, zip(idxs, rnds)))
            else:
                results = [work(a) for a in zip(idxs, rnds)]

        labels = [lab for lab, _ in results]
        batch = [img for _, img in results]
        self._pad = self.batch_size - len(batch)
        self._count = len(batch)
        for _ in range(self._pad):
            batch.append(onp.zeros_like(batch[0]))
            labels.append(onp.zeros_like(onp.asarray(labels[0])))
        self._labels = onp.array(labels, onp.float32)
        stacked = onp.stack(batch)    # NHWC uint8
        if self.transport == 'u8':
            self._count_host_bytes(stacked.nbytes)
            out, _ev = self._normalize_u8(torch.from_numpy(stacked))
            return [NDArray(out)]
        out = onp.stack([self._host_normalize(im) for im in batch])
        # pad rows are exact zeros on every path (u8 zeroes them on device)
        if self._pad:
            out[self._count:] = 0.0
        self._count_host_bytes(out.nbytes)
        return [self._to_ctx(out)]

    def getlabel(self):
        return [self._to_ctx(onp.ascontiguousarray(self._labels,
                                                   onp.float32), pin=True)]

    def getpad(self):
        return getattr(self, '_pad', 0)


class _NativePipeline:
    """ctypes wrapper over the C++ threaded decode pipeline
    (csrc/io/mxtpu_io.cc mxt_pipeline_*)."""

    def __init__(self, lib, handle, batch_size, data_shape, label_width,
                 output_u8):
        self._lib = lib
        self._h = handle
        self._batch_size = batch_size
        self._shape = data_shape
        self._label_width = label_width
        self._u8 = bool(output_u8)

    @classmethod
    def try_create(cls, path, batch_size, data_shape, label_width,
                   threads, depth, resize, shuffle, rand_crop, rand_mirror,
                   seed, mean, std, output_u8=False, cache_bytes=0):
        import ctypes
        from .. import _native
        lib = _native.get_lib()
        if lib is None or not os.path.isfile(path):
            return None
        c, h, w = data_shape
        mean_arr = (ctypes.c_float * 3)(*mean)
        std_arr = (ctypes.c_float * 3)(*std)
        handle = lib.mxt_pipeline_create(
            path.encode(), batch_size, h, w, label_width, threads, depth,
            resize, int(bool(shuffle)), int(bool(rand_crop)),
            int(bool(rand_mirror)), seed, mean_arr, std_arr,
            int(bool(output_u8)), int(cache_bytes))
        if not handle:
            return None
        return cls(lib, handle, batch_size, data_shape, label_width,
                   output_u8)

    def _raise(self):
        msg = self._lib.mxt_pipeline_error(self._h).decode()
        low = msg.lower()
        if any(k in low for k in ('record', 'decode', 'truncat', 'magic',
                                  'corrupt')):
            # record-shaped failures surface as DataError: "this input
            # file is damaged", not a runtime bug
            raise DataError("native pipeline: " + msg)
        raise MXNetError("native pipeline: " + msg)

    def next(self):
        """Copy-out path (f32 mode): (data NCHW f32, label
        (N, label_width) f32, count) or None at epoch end."""
        import ctypes
        data_p = ctypes.POINTER(ctypes.c_float)()
        label_p = ctypes.POINTER(ctypes.c_float)()
        n = self._lib.mxt_pipeline_next(self._h, ctypes.byref(data_p),
                                        ctypes.byref(label_p))
        if n < 0:
            self._raise()
        if n == 0:
            return None
        c, h, w = self._shape
        full = self._batch_size
        data = onp.ctypeslib.as_array(
            data_p, shape=(full, c, h, w)).copy()
        label = onp.ctypeslib.as_array(
            label_p, shape=(full, self._label_width)).copy()
        return data, label, n

    def next_lease(self):
        """Zero-copy path: (data view, label f32 copy, count, lease_id) or
        None at epoch end. ``data`` is a numpy view over the pipeline's
        own buffer (NHWC u8 in u8 mode, NCHW f32 otherwise), valid until
        return_lease(lease_id)/reset()/free()."""
        import ctypes
        data_p = ctypes.c_void_p()
        label_p = ctypes.POINTER(ctypes.c_float)()
        lease_id = ctypes.c_uint64()
        n = self._lib.mxt_pipeline_next_lease(
            self._h, ctypes.byref(data_p), ctypes.byref(label_p),
            ctypes.byref(lease_id))
        if n < 0:
            self._raise()
        if n == 0:
            return None
        c, h, w = self._shape
        full = self._batch_size
        if self._u8:
            buf = ctypes.cast(data_p, ctypes.POINTER(ctypes.c_uint8))
            data = onp.ctypeslib.as_array(buf, shape=(full, h, w, c))
        else:
            buf = ctypes.cast(data_p, ctypes.POINTER(ctypes.c_float))
            data = onp.ctypeslib.as_array(buf, shape=(full, c, h, w))
        label = onp.ctypeslib.as_array(
            label_p, shape=(full, self._label_width)).copy()
        self._gauge_leases()
        return data, label, n, lease_id.value

    def return_lease(self, lease_id):
        self._lib.mxt_pipeline_return(self._h, lease_id)
        self._gauge_leases()

    def leased_depth(self):
        return int(self._lib.mxt_pipeline_leased(self._h))

    def cache_stats(self):
        """(hits, misses, bytes_held) of the decode cache."""
        import ctypes
        hits = ctypes.c_uint64()
        misses = ctypes.c_uint64()
        nbytes = ctypes.c_uint64()
        self._lib.mxt_pipeline_cache_stats(
            self._h, ctypes.byref(hits), ctypes.byref(misses),
            ctypes.byref(nbytes))
        return hits.value, misses.value, nbytes.value

    def _gauge_leases(self):
        if _telem['on']:
            from .. import telemetry as _telemetry
            _telemetry.set_gauge('mxnet_tpu_io_lease_depth',
                                 self.leased_depth())

    def num_records(self):
        return self._lib.mxt_pipeline_num_records(self._h)

    def reset(self):
        self._lib.mxt_pipeline_reset(self._h)

    def __del__(self):
        try:
            self._lib.mxt_pipeline_free(self._h)
        except Exception:
            pass
