"""Continuous-batching inference engine (counterpart of
``mxnet_tpu/serving/batcher.py``).

A serving replica sees single requests of ragged lengths; the card wants
large batches of a few fixed shapes. The engine reconciles the two with
the JAX package's formation rules:

- requests queue per **sequence bucket** (lengths round UP to a small
  fixed set, ``MXTPU_SERVE_BUCKETS``, padded with ``pad_value``);
- a worker forms a batch when a bucket reaches the largest batch bucket
  (**fill**) or when its oldest request has waited
  ``MXTPU_SERVE_BATCH_DEADLINE_MS`` (**deadline**);
- the formed batch pads its row count up to a **batch bucket**
  (``MXTPU_SERVE_BATCH_BUCKETS``), so the shapes the card sees are
  exactly ``len(seq_buckets) x len(batch_buckets)``, all visited by
  ``serving.warmup``;
- dispatch goes through ``BlockRunner``, which hybridizes its block, so
  on the card each bucket replays one captured CUDA graph, under the
  OOM guard: an allocator failure (``telemetry.memory.is_oom_error``)
  sheds that batch with ``RequestShed`` instead of killing the replica.

Padding is exact: batch-dim pad rows are dropped by the slicer, and a
per-position output is sliced back to the request's true length (each
request's result is its own copy).

Telemetry, as the JAX engine reports it: every dispatch runs under a
``serving.dispatch`` span (labels ``engine``, ``batch``, ``seq``,
``fill``) and ``memory.oom_guard('serving.dispatch')``; with telemetry
on, the queue-depth gauge, the shed counter (by reason) and, per
completed batch, the requests, batches and bucket-hit counters and the
fill-ratio and latency histograms; every shed is a ``serving.shed``
flight note. ``watchdog_seconds`` (or ``MXTPU_SERVE_WATCHDOG_SECONDS``)
arms a ``resilience.StepWatchdog`` over the batcher, beaten once per
completed batch: a dispatch that completes no batch for that long gets
one stall report (all-thread stacks, classified COMPILING while a
capture or a kernel build is open) and a ``serving.stuck`` flight note.
"""
from __future__ import annotations

import collections
import threading
import time as _time

import numpy as onp
import torch

from ..base import MXNetError, telem_flags as _telem
from .. import config as _config
from ..context import resolve_device
from ..telemetry import flight as _flight, memory as _memory, \
    metrics as _metrics, trace as _trace

__all__ = ['ServeError', 'RequestShed', 'RequestTooLarge',
           'parse_buckets', 'seq_bucket_for', 'batch_bucket_for',
           'BlockRunner', 'InferenceEngine']


class ServeError(MXNetError):
    """Base class for predict-path failures; ``status`` is the HTTP code
    a server maps it to."""
    status = 500


class RequestShed(ServeError):
    """Admission control refused the request (queue full, OOM mid-batch,
    draining): the client should retry on another replica."""
    status = 503


class RequestTooLarge(ServeError):
    """The request exceeds the largest sequence bucket."""
    status = 400


def parse_buckets(spec):
    """'32,64,128' -> (32, 64, 128) (sorted, deduplicated)."""
    if isinstance(spec, (list, tuple)):
        vals = [int(v) for v in spec]
    else:
        vals = [int(v) for v in str(spec).split(',') if v.strip()]
    if not vals or any(v <= 0 for v in vals):
        raise MXNetError(f"invalid bucket spec: {spec!r}")
    return tuple(sorted(set(vals)))


def seq_bucket_for(length, buckets):
    """Smallest bucket >= length, or None when the request is too long."""
    for b in buckets:
        if length <= b:
            return b
    return None


def batch_bucket_for(n, buckets):
    """Smallest batch bucket >= n (callers never exceed max(buckets))."""
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


class BlockRunner:
    """Serves one block on (batch, seq) token matrices under
    ``torch.inference_mode()``, on the card unless ``device='cpu'``, as
    the JAX runner does: it calls ``block.hybridize()`` (a Gluon block;
    a plain module runs as it is), so on the card every bucket shape is
    captured once as a CUDA graph and replayed afterwards (on the CPU
    hybridize changes nothing).

    Returns the first output as a float32 numpy array (bfloat16 is cast
    on the device). On the card the output comes back through a pinned
    host buffer kept per output shape: the device-side cast, one
    ``non_blocking`` copy into the buffer, then a wait on that copy's
    event alone. The values are bit for bit those of
    ``out.float().cpu().numpy()`` (the pageable copy, taken where
    ``pinned`` is False: on the CPU),
    and the array is a view of the buffer, valid until the next call
    with the same bucket shape (``InferenceEngine`` copies each
    request's rows out before its next dispatch)."""

    def __init__(self, block, dtype='int32', device=None):
        self.device = resolve_device(device)
        self.block = block.to(self.device).eval()
        self.dtype = dtype
        self.pinned = self.device.type == 'cuda'
        self._host = {}        # (shape, dtype) -> (pinned buffer, event)
        hybridize = getattr(block, 'hybridize', None)
        if hybridize is not None:
            hybridize()

    def __call__(self, mat):
        tokens = torch.from_numpy(onp.asarray(mat, self.dtype)).to(
            self.device)
        with torch.inference_mode():
            out = self.block(tokens)
            if isinstance(out, (list, tuple)):
                out = out[0]
            if out.dtype in (torch.bfloat16, torch.float16):
                out = out.float()
            if not self.pinned:
                return out.cpu().numpy()
            buf, copied = self._host_buffer(out)
            buf.copy_(out, non_blocking=True)
            copied.record()
        copied.synchronize()
        return buf.numpy()

    def _host_buffer(self, out):
        key = (tuple(out.shape), out.dtype)
        entry = self._host.get(key)
        if entry is None:
            entry = self._host[key] = (
                torch.empty(out.shape, dtype=out.dtype, pin_memory=True),
                torch.cuda.Event())
        return entry


class _Request:
    __slots__ = ('data', 'length', 'enqueued', 'event', 'result', 'error')

    def __init__(self, data):
        self.data = data
        self.length = int(data.shape[0])
        self.enqueued = _time.monotonic()
        self.event = threading.Event()
        self.result = None
        self.error = None


class InferenceEngine:
    """The continuous batcher: ``submit()`` blocks the calling thread
    until its request's batch has been formed, dispatched and sliced; one
    worker thread owns batch formation, and so every dispatch (and any
    capture of a bucket warmup did not see): client threads never touch
    the card. ``watchdog_seconds`` (or ``MXTPU_SERVE_WATCHDOG_SECONDS``),
    when nonzero, arms the stall watchdog (``watchdog``; see the module
    docstring)."""

    def __init__(self, runner, seq_buckets=None, batch_buckets=None,
                 deadline_ms=None, queue_limit=None, admission=None,
                 pad_value=0, dtype='int32', name='serve',
                 watchdog_seconds=None):
        self.runner = runner
        self.name = name
        self.dtype = onp.dtype(dtype)
        self.seq_buckets = parse_buckets(
            seq_buckets if seq_buckets is not None
            else _config.get('MXTPU_SERVE_BUCKETS'))
        self.batch_buckets = parse_buckets(
            batch_buckets if batch_buckets is not None
            else _config.get('MXTPU_SERVE_BATCH_BUCKETS'))
        self.max_batch = self.batch_buckets[-1]
        self.deadline_s = (float(
            _config.get('MXTPU_SERVE_BATCH_DEADLINE_MS'))
            if deadline_ms is None else float(deadline_ms)) / 1000.0
        self.queue_limit = int(
            _config.get('MXTPU_SERVE_QUEUE_LIMIT')
            if queue_limit is None else queue_limit)
        self.admission = admission
        self.pad_value = pad_value
        self._cv = threading.Condition()
        self._pending = {s: collections.deque() for s in self.seq_buckets}
        self._n_pending = 0
        self._running = True
        self._latencies = collections.deque(maxlen=4096)
        self.requests = 0
        self.batches = 0
        self.shed = 0
        self.watchdog = None
        if watchdog_seconds is None:
            watchdog_seconds = _config.get('MXTPU_SERVE_WATCHDOG_SECONDS')
        if watchdog_seconds and float(watchdog_seconds) > 0:
            from ..resilience.watchdog import StepWatchdog

            def _stuck(report):
                _flight.note('serving.stuck', engine=self.name)

            self.watchdog = StepWatchdog(
                deadline_seconds=float(watchdog_seconds), on_stall=_stuck)
            self.watchdog.start()
        self._worker = threading.Thread(
            target=self._loop, daemon=True,
            name=f'mxtt-serve-batcher-{name}')
        self._worker.start()

    # -- client side -------------------------------------------------------

    def submit(self, seq, timeout=30.0):
        """One request in, its (sliced) output out. Raises
        ``RequestShed``/``RequestTooLarge`` per the admission rules."""
        return self.result(self.submit_async(seq), timeout)

    def submit_async(self, seq):
        """Enqueue one request and return its handle (``result()``
        collects)."""
        data = onp.asarray(seq, self.dtype)
        if data.ndim != 1:
            raise MXNetError(f"predict request must be one 1-D sequence, "
                             f"got shape {data.shape}")
        s = seq_bucket_for(data.shape[0], self.seq_buckets)
        if s is None:
            raise RequestTooLarge(
                f"request length {data.shape[0]} exceeds the largest "
                f"bucket {self.seq_buckets[-1]}")
        if self.admission is not None:
            reason = self.admission()
            if reason:
                self._shed(1, reason)
                raise RequestShed(f"admission refused: {reason}")
        req = _Request(data)
        with self._cv:
            if not self._running:
                self._shed(1, 'draining')
                raise RequestShed("replica draining")
            if self._n_pending >= self.queue_limit:
                self._shed(1, 'queue_full')
                raise RequestShed(f"queue full ({self.queue_limit} pending)")
            self._pending[s].append(req)
            self._n_pending += 1
            self.requests += 1
            if _telem['on']:
                self._gauge_depth()
            self._cv.notify()
        return req

    def result(self, req, timeout=30.0):
        if not req.event.wait(timeout):
            raise RequestShed(f"request timed out after {timeout:.1f}s")
        if req.error is not None:
            raise req.error
        return req.result

    # -- warmup / drain ----------------------------------------------------

    def bucket_grid(self):
        """Every shape the steady state can draw, largest first."""
        return [(b, s) for s in reversed(self.seq_buckets)
                for b in reversed(self.batch_buckets)]

    def run_bucket(self, batch, seq):
        """Dispatch one dummy batch of an exact bucket shape straight
        through the runner (the warmup path — no queue)."""
        mat = onp.full((batch, seq), self.pad_value, self.dtype)
        with _trace.span('serving.dispatch', engine=self.name,
                         batch=batch, seq=seq, warmup=True), \
                _memory.oom_guard('serving.dispatch'):
            self.runner(mat)

    def drain(self, timeout=None):
        """Stop admitting, finish every in-flight request, park the
        worker. Returns the number of requests flushed."""
        if timeout is None:
            timeout = float(_config.get('MXTPU_SERVE_DRAIN_SECONDS'))
        with self._cv:
            if not self._running:
                return 0
            flushed = self._n_pending
            self._running = False
            self._cv.notify_all()
        self._worker.join(timeout=timeout)
        if self.watchdog is not None:
            self.watchdog.stop()
        return flushed

    close = drain

    # -- stats -------------------------------------------------------------

    def stats(self):
        with self._cv:
            lat = sorted(self._latencies)
            depth = self._n_pending
            requests, batches, shed = self.requests, self.batches, self.shed

        def pct(p):
            return round(lat[min(len(lat) - 1,
                                 int(p / 100.0 * len(lat)))] * 1e3, 3) \
                if lat else None
        return {'requests': requests, 'batches': batches,
                'shed': shed, 'queue_depth': depth,
                'p50_ms': pct(50), 'p99_ms': pct(99),
                'seq_buckets': list(self.seq_buckets),
                'batch_buckets': list(self.batch_buckets),
                'deadline_ms': round(self.deadline_s * 1e3, 3)}

    # -- worker ------------------------------------------------------------

    def _gauge_depth(self):
        _metrics.set_gauge('mxnet_tpu_serving_queue_depth',
                           self._n_pending, engine=self.name)

    def _shed(self, n, reason):
        with self._cv:              # re-entrant: some callers hold it
            self.shed += n
        _flight.note('serving.shed', engine=self.name, count=n,
                     reason=reason)
        if _telem['on']:
            _metrics.counter('mxnet_tpu_serving_shed_total').inc(
                n, engine=self.name, reason=reason)

    def _pick_locked(self, now):
        """The bucket to dispatch now, or (None, wait_seconds)."""
        wait = None
        for s, dq in self._pending.items():
            if not dq:
                continue
            if len(dq) >= self.max_batch:
                return s, None                       # fill wins
            remaining = self.deadline_s - (now - dq[0].enqueued)
            if remaining <= 0 or not self._running:
                return s, None                       # deadline (or drain)
            wait = remaining if wait is None else min(wait, remaining)
        return None, wait

    def _loop(self):
        while True:
            with self._cv:
                while True:
                    s, wait = self._pick_locked(_time.monotonic())
                    if s is not None:
                        break
                    if not self._running and self._n_pending == 0:
                        return
                    self._cv.wait(timeout=wait if wait is not None
                                  else 0.2)
                reqs = []
                dq = self._pending[s]
                while dq and len(reqs) < self.max_batch:
                    reqs.append(dq.popleft())
                self._n_pending -= len(reqs)
                if _telem['on']:
                    self._gauge_depth()
            self._dispatch(s, reqs)

    def _dispatch(self, s, reqs):
        b = batch_bucket_for(len(reqs), self.batch_buckets)
        mat = onp.full((b, s), self.pad_value, self.dtype)
        for i, r in enumerate(reqs):
            mat[i, :r.length] = r.data
        try:
            with _trace.span('serving.dispatch', engine=self.name,
                             batch=b, seq=s, fill=len(reqs)), \
                    _memory.oom_guard('serving.dispatch'):
                out = onp.asarray(self.runner(mat))
        except BaseException as e:                  # noqa: BLE001
            if _memory.is_oom_error(e):
                # the replica survives allocator exhaustion: the dump
                # was written by the guard; the batch sheds
                self._shed(len(reqs), 'oom')
                err = RequestShed(f"out of device memory: {e!r}")
            else:
                # the worker must keep serving: the error goes to the
                # callers
                err = e if isinstance(e, Exception) else ServeError(repr(e))
            for r in reqs:
                r.error = err
                r.event.set()
            if not isinstance(e, Exception):
                raise
            return
        now = _time.monotonic()
        per_position = out.ndim >= 2 and out.shape[1] == s
        for i, r in enumerate(reqs):
            # a copy: the runner may hand back a buffer it reuses
            r.result = onp.array(out[i, :r.length] if per_position
                                 else out[i])
            r.event.set()
        with self._cv:
            for r in reqs:
                self._latencies.append(now - r.enqueued)
            self.batches += 1
        if self.watchdog is not None:
            self.watchdog.beat(self.batches)
        if _telem['on']:
            _metrics.counter('mxnet_tpu_serving_requests_total').inc(
                len(reqs), engine=self.name)
            _metrics.counter('mxnet_tpu_serving_batches_total').inc(
                1, engine=self.name)
            _metrics.counter('mxnet_tpu_serving_bucket_hits_total').inc(
                1, engine=self.name, batch=b, seq=s)
            _metrics.observe('mxnet_tpu_serving_batch_fill_ratio',
                             len(reqs) / float(b), engine=self.name)
            for r in reqs:
                _metrics.observe('mxnet_tpu_serving_latency_seconds',
                                 now - r.enqueued, engine=self.name)
