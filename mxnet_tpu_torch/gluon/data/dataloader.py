"""DataLoader (counterpart of ``mxnet_tpu/gluon/data/dataloader.py``;
ref: python/mxnet/gluon/data/dataloader.py).

The reference uses multiprocessing workers with shared-memory NDArray
pickling (dataloader.py:121-186); as in the JAX package, num_workers maps
to a PERSISTENT thread pool (one executor for the loader's lifetime, not
one per epoch): decode and augmentation release the GIL in PIL/numpy.

Batches land on the context current when the loader is made (the card
by default; ``with mx.cpu():`` keeps them on the host). With
``pin_memory=True`` and a card context, workers batchify into pinned
host tensors and copy them to ``gpu(pin_device_id)`` with
``non_blocking=True`` on the loader's side stream, recording an event
behind the copies; the thread that takes the batch makes its own stream
wait on that event (and marks the tensors as used there) before the
batch is handed out, so the training step never reads a batch before its
copy lands and no worker ever synchronizes the card. On a CPU context
``pin_memory`` changes nothing.
"""
from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import numpy as onp

import torch

from ...base import DataError, MXNetError, telem_flags as _telem
from ...context import cpu, current_context, gpu
from ...ndarray.ndarray import NDArray, array
from ...resilience import faults as _faults
from ...telemetry import trace as _trace
from .sampler import SequentialSampler, RandomSampler, BatchSampler


def default_batchify_fn(data):
    """Stack samples into a batch (ref: dataloader.py default_batchify_fn)."""
    if isinstance(data[0], NDArray):
        return array(onp.stack([d.asnumpy() for d in data]))
    if isinstance(data[0], tuple):
        data = zip(*data)
        return [default_batchify_fn(i) for i in data]
    data = onp.asarray(data)
    return array(data)


def default_mp_batchify_fn(data):
    return default_batchify_fn(data)


class DataLoader:
    """Ref: dataloader.py DataLoader."""

    def __init__(self, dataset, batch_size=None, shuffle=False, sampler=None,
                 last_batch=None, batch_sampler=None, batchify_fn=None,
                 num_workers=0, pin_memory=False, pin_device_id=0,
                 prefetch=None, thread_pool=False, timeout=120,
                 worker_retries=None):
        self._dataset = dataset
        self._pin_memory = pin_memory
        self._ctx = current_context()
        # pinned staging and the side-stream copy need a card to copy to
        self._pin_to = (gpu(pin_device_id) if pin_memory and
                        self._ctx.device.type == 'cuda' else None)
        self._stream = (torch.cuda.Stream(self._pin_to.device)
                        if self._pin_to is not None else None)
        if worker_retries is None:
            from ... import config as _config
            worker_retries = _config.get('MXTPU_DATALOADER_WORKER_RETRIES')
        self._worker_retries = max(0, int(worker_retries))
        if batch_sampler is None:
            if batch_size is None:
                raise ValueError("batch_size must be specified unless "
                                 "batch_sampler is specified")
            if sampler is None:
                if shuffle:
                    sampler = RandomSampler(len(dataset))
                else:
                    sampler = SequentialSampler(len(dataset))
            elif shuffle:
                raise ValueError("shuffle must not be specified if sampler is "
                                 "specified")
            batch_sampler = BatchSampler(sampler, batch_size,
                                         last_batch or 'keep')
        elif batch_size is not None or shuffle or sampler is not None or \
                last_batch is not None:
            raise ValueError("batch_size, shuffle, sampler and last_batch must "
                             "not be specified if batch_sampler is specified.")
        self._batch_sampler = batch_sampler
        self._num_workers = num_workers if num_workers >= 0 else 0
        self._prefetch = max(0, int(prefetch) if prefetch is not None
                             else 2 * self._num_workers)
        if batchify_fn is None:
            batchify_fn = default_batchify_fn
        self._batchify_fn = batchify_fn
        # persistent worker pool: created on first multi-worker epoch and
        # reused for the loader's lifetime — per-epoch executor spin-up
        # (thread creation x num_workers, every epoch) was pure overhead
        self._pool = None

    def _worker_pool(self):
        if self._pool is None:
            self._pool = ThreadPoolExecutor(
                max_workers=self._num_workers,
                thread_name_prefix='mxtpu-dataloader')
        return self._pool

    def _fetch(self, batch):
        """(batchified batch, the event behind its copies or None)."""
        # worker-thread span: overlapped work, reported in the span
        # table but excluded from attribution's wall-time buckets
        with _trace.span('io.worker_fetch', batch_len=len(batch)):
            _faults.fire('dataloader.worker')
            with (cpu() if self._pin_to is not None else self._ctx):
                out = self._batchify_fn([self._dataset[idx]
                                         for idx in batch])
            ev = None
            if self._pin_to is not None:
                with _trace.span('h2d.pin'):
                    out, ev = self._pin_and_copy(out)
        return out, ev

    def _result_with_respawn(self, future, batch, batch_idx):
        """Surface a worker future's result; a crashed worker (any
        exception) gets the batch re-submitted to the pool — the shared
        ``resilience.retry_call`` bounded policy, counted in telemetry —
        before a clear error names the batch that kept failing.
        DataError (deterministic input corruption) propagates unchanged
        and unretried so callers keep the index/offset/path context (the
        iterator-level corrupt_policy stays the skip knob)."""
        from ...resilience import retry_call
        first = {'f': future}

        def fetch_result():
            f = first.pop('f', None)
            if f is None:           # respawn: re-submit the same batch
                if _telem['on']:
                    from ... import telemetry as _telemetry
                    _telemetry.inc(
                        'mxnet_tpu_resilience_worker_respawns_total')
                f = self._worker_pool().submit(self._fetch, batch)
            return f.result()

        try:
            # consumer-side wait on the worker future: input-bound time
            with _trace.span('io.wait'):
                return retry_call(fetch_result,
                                  retries=self._worker_retries,
                                  backoff_seconds=0, retry_on=(Exception,),
                                  give_up_on=(DataError,),
                                  site='dataloader.worker')
        except DataError:
            raise
        except Exception as e:
            raise MXNetError(
                f"DataLoader worker failed {self._worker_retries + 1}x "
                f"on batch {batch_idx} (respawn budget "
                f"{self._worker_retries} exhausted): "
                f"{type(e).__name__}: {e}") from e

    def _pin_and_copy(self, out):
        """Pin a host batch and copy it to the card on the loader's side
        stream; returns (batch on the card, the copies' event). Runs on
        a worker thread: it queues work and never waits for the card."""
        dev = self._pin_to.device
        stream = self._stream

        def put(o):
            if isinstance(o, NDArray):
                return NDArray(o._data.detach().pin_memory().to(
                    dev, non_blocking=True))
            if isinstance(o, (list, tuple)):
                return type(o)(put(x) for x in o)
            return o

        with torch.cuda.stream(stream):
            out = put(out)
            ev = torch.cuda.Event()
            ev.record(stream)
        return out, ev

    def _land(self, fetched):
        """The batch, with the current stream made to wait for its
        copies (called on the thread that takes the batch)."""
        out, ev = fetched
        if ev is None:
            return out
        consumer = torch.cuda.current_stream(self._pin_to.device)
        consumer.wait_event(ev)

        def mark(o):
            if isinstance(o, NDArray):
                o._data.record_stream(consumer)
            elif isinstance(o, (list, tuple)):
                for x in o:
                    mark(x)
        mark(out)
        return out

    def __iter__(self):
        if self._num_workers == 0:
            for batch in self._batch_sampler:
                # same fetch body as the worker path (incl. the
                # dataloader.worker fault site), minus pool + respawn
                yield self._land(self._fetch(batch))
            return

        pool = self._worker_pool()
        batches = list(self._batch_sampler)
        depth = max(1, self._prefetch)
        futures = []
        it = iter(enumerate(batches))
        for _ in range(depth):
            try:
                i, b = next(it)
                futures.append((pool.submit(self._fetch, b), b, i))
            except StopIteration:
                break
        while futures:
            f, b, i = futures.pop(0)
            try:
                j, nb = next(it)
                futures.append((pool.submit(self._fetch, nb), nb, j))
            except StopIteration:
                pass
            yield self._land(self._result_with_respawn(f, b, i))

    def data_state(self):
        """Manifest-ready data-position state when the batch sampler is
        elastic (``ElasticSampler`` / anything with ``state()``), else
        None. Bind to a CheckpointManager via ``bind_data_state`` so
        every commit records where the sample stream stood — the half
        of a re-form that makes resumes exactly-once."""
        st = getattr(self._batch_sampler, 'state', None)
        return st() if callable(st) else None

    def reshard(self, rank, world):
        """Re-partition an elastic batch sampler after a re-form
        (shrink or grow): same global position, new per-rank block."""
        rs = getattr(self._batch_sampler, 'reshard', None)
        if not callable(rs):
            raise MXNetError(
                "DataLoader: batch sampler is not elastic (pass "
                "batch_sampler=ElasticSampler(...) for world-indexed "
                "deterministic assignment)")
        rs(rank, world)
        return self

    def close(self):
        if self._pool is not None:
            self._pool.shutdown(wait=False)
            self._pool = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def __len__(self):
        return len(self._batch_sampler)
