"""Span tracing: nested scopes over the step and dispatch lifecycle
(counterpart of ``mxnet_tpu/telemetry/trace.py``; pure Python).

The metrics registry (``telemetry.metrics``) answers "how much"; this
module answers "WHEN, and inside what". A ``span("name", **labels)``
context manager emits chrome-trace ``'B'``/``'E'`` events into a
lock-free per-thread ring buffer; ``chrome_events()`` merges every
thread's ring into one balanced, deterministic ``traceEvents`` stream
that chrome://tracing / Perfetto load directly.

- **Disarmed cost is one dict check.** ``span()`` reads the module gate
  and returns a shared no-op singleton; nothing is allocated, nothing
  is recorded (``MXTPU_TRACE=1`` arms it, or ``trace.enable()``).
- **Lock-free when armed.** Each thread appends to its own preallocated
  ring (only ring *creation* takes a lock). A full ring overwrites its
  oldest events and counts the spans it dropped
  (``mxnet_tpu_trace_dropped_spans_total``).
- **Dumps are always valid.** ``balance_events()`` repairs unbalanced
  B/E streams at export time (orphan ``E`` dropped, open ``B`` closed
  with a synthetic ``E`` marked ``{'flushed': True}``).
- **Stable pid/tid mapping.** Threads get small sequential tids in
  first-span order, plus ``'M'`` thread-name metadata.

Span timing: ``ts`` is ``time.time()`` microseconds (host time: a span
around an asynchronous CUDA launch measures the launch, not the kernel);
per-span durations also aggregate into a per-thread
``{name: [count, total_us, self_us]}`` table (*self* time excludes child
spans). ``drain_aggregates()`` (the flight recorder's per-step hook)
swaps those tables out.
"""
from __future__ import annotations

import contextlib
import json
import os
import threading
import time as _time

from ..base import telem_flags as _telem

__all__ = [
    'enable', 'disable', 'enabled', 'span', 'instant', 'complete',
    'chrome_events', 'thread_metadata', 'balance_events', 'dump',
    'drain_aggregates', 'open_spans', 'stats', 'clear',
    'set_ring_capacity', 'tid_for_current_thread',
]

_state = {'on': False}
_DEFAULT_RING = None          # resolved lazily from MXTPU_TRACE_RING

# thread registry: ring creation (rare) locks; appends never do.
# RLock: a fatal-signal dump interrupting THIS thread mid-registration
# must re-enter the registry, not self-deadlock on a plain Lock.
_rings_lock = threading.RLock()
_rings = []                   # every _Ring ever created, in tid order
_tids = {}                    # thread ident -> (tid, name)
_local = threading.local()
_gen = [0]                    # bumped by clear(): stale thread-local
                              # rings re-register on their next span
# telemetry sync state: last counter values already pushed to the
# metrics registry (counters must only ever move forward)
_synced = {'spans': 0, 'dropped': 0}


def enable():
    _state['on'] = True


def disable():
    _state['on'] = False


def enabled() -> bool:
    return _state['on']


def _ring_capacity() -> int:
    global _DEFAULT_RING
    if _DEFAULT_RING is None:
        from .. import config as _config
        with _rings_lock:
            if _DEFAULT_RING is None:
                _DEFAULT_RING = max(
                    16, int(_config.get('MXTPU_TRACE_RING')))
    return _DEFAULT_RING


def set_ring_capacity(n):
    """Events per thread ring for rings created AFTER this call (pass
    None to restore the MXTPU_TRACE_RING config default). clear() drops
    existing rings, so tests set capacity + clear to take effect."""
    global _DEFAULT_RING
    with _rings_lock:
        _DEFAULT_RING = None if n is None else max(16, int(n))


class _Ring:
    """One thread's event buffer. Owned exclusively by its thread:
    append() is plain list indexing, no lock. `stack` tracks the open
    spans (name, t0_us, child_us) for nesting/self-time; `agg` is the
    per-step aggregation table drain_aggregates() swaps out."""

    __slots__ = ('events', 'cap', 'n', 'tid', 'name', 'stack', 'agg',
                 'spans_total', 'dropped', 'gen')

    def __init__(self, cap, tid, name):
        self.gen = _gen[0]
        self.cap = cap
        self.events = [None] * cap
        self.n = 0
        self.tid = tid
        self.name = name
        self.stack = []
        self.agg = {}
        self.spans_total = 0
        self.dropped = 0

    def append(self, ev):
        slot = self.n % self.cap
        old = self.events[slot]
        if old is not None and old['ph'] == 'B':
            # overwriting a begin event drops that whole span from the
            # ring (balance_events drops that span's orphan 'E' at
            # export)
            self.dropped += 1
        self.events[slot] = ev
        self.n += 1

    def snapshot(self):
        if self.n <= self.cap:
            return list(self.events[:self.n])
        i = self.n % self.cap
        return self.events[i:] + self.events[:i]


def tid_for_current_thread() -> int:
    """Small sequential tid for this thread (assigned on first use,
    stable for the process lifetime). Registers only the tid: no ring is
    built until this thread records a span."""
    tid = getattr(_local, 'tid', None)
    if tid is None:
        t = threading.current_thread()
        with _rings_lock:
            ent = _tids.get(t.ident)
            if ent is None:
                tid = len(_tids) + 1
                _tids[t.ident] = (tid, t.name)
            else:
                tid = ent[0]
        _local.tid = tid
    return tid


def _ring() -> _Ring:
    r = getattr(_local, 'ring', None)
    if r is not None and r.gen != _gen[0]:
        r = None
    if r is None:
        tid = tid_for_current_thread()
        name = threading.current_thread().name
        with _rings_lock:
            r = _Ring(_ring_capacity(), tid, name)
            _rings.append(r)
        _local.ring = r
    return r


def _now_us() -> float:
    return _time.time() * 1e6


@contextlib.contextmanager
def _rings_locked(timeout=2.0):
    """Best-effort lock for the read/export paths. Same-thread signal
    re-entry is already safe (the registry lock is reentrant), but a
    crash-time dump must also survive a wedged holder on ANOTHER
    thread: after `timeout` we proceed lock-free — the holder that
    timed us out is interrupted or blocked, not mutating. Writers
    (_ring, tid assignment, clear) keep blocking acquires; their
    critical sections never block."""
    got = _rings_lock.acquire(timeout=timeout)
    try:
        yield
    finally:
        if got:
            _rings_lock.release()


class _NullSpan:
    """Shared disarmed span: enter/exit allocate nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _NullSpan()


class _Span:
    __slots__ = ('name', 'args', 'ring', 't0')

    def __init__(self, name, args):
        self.name = name
        self.args = args

    def __enter__(self):
        r = _ring()
        self.ring = r
        t0 = _now_us()
        self.t0 = t0
        ev = {'name': self.name, 'cat': 'span', 'ph': 'B', 'ts': t0,
              'tid': r.tid}
        if self.args:
            ev['args'] = self.args
        r.append(ev)
        r.stack.append([self.name, t0, 0.0])
        return self

    def __exit__(self, *exc):
        r = self.ring
        t1 = _now_us()
        r.append({'name': self.name, 'cat': 'span', 'ph': 'E', 'ts': t1,
                  'tid': r.tid})
        dur = max(0.0, t1 - self.t0)
        child = 0.0
        if r.stack and r.stack[-1][0] == self.name:
            child = r.stack.pop()[2]
        if r.stack:
            r.stack[-1][2] += dur          # credit the parent's child time
        st = r.agg.get(self.name)
        self_us = max(0.0, dur - child)
        if st is None:
            r.agg[self.name] = [1, dur, self_us]
        else:
            st[0] += 1
            st[1] += dur
            st[2] += self_us
        r.spans_total += 1
        return False


def span(name, **labels):
    """Nested timing scope. Armed: emits a chrome 'B'/'E' pair into
    this thread's ring and aggregates (count, total, self) time under
    `name`. Disarmed: returns a shared no-op (one dict check)."""
    if not _state['on']:
        return _NULL
    return _Span(name, labels or None)


def instant(name, **args):
    """One chrome instant event ('i'), e.g. a shed or a capture marker."""
    if not _state['on']:
        return
    r = _ring()
    ev = {'name': name, 'cat': 'span', 'ph': 'i', 'ts': _now_us(),
          'tid': r.tid, 's': 't'}
    if args:
        ev['args'] = args
    r.append(ev)


def complete(name, ts_us, dur_us, **args):
    """One chrome complete event ('X') for an externally measured
    interval (e.g. folding in durations from another trace source)."""
    if not _state['on']:
        return
    r = _ring()
    ev = {'name': name, 'cat': 'span', 'ph': 'X', 'ts': float(ts_us),
          'dur': max(0.0, float(dur_us)), 'tid': r.tid}
    if args:
        ev['args'] = args
    r.append(ev)


# ---------------------------------------------------------------------------
# export / merge
# ---------------------------------------------------------------------------

def balance_events(events, close_ts=None):
    """Repair a chrome event stream so every 'B' has a matching 'E':
    per (pid, tid), orphan 'E' events (their 'B' was overwritten or
    predates the stream) are dropped and still-open 'B' events get a
    synthetic closing 'E' at `close_ts` (default: the stream's max ts)
    tagged args={'flushed': True}. Non-B/E events pass through."""
    if close_ts is None:
        close_ts = max((e.get('ts', 0.0) for e in events), default=0.0)
    out = []
    stacks = {}
    for ev in events:
        ph = ev.get('ph')
        if ph == 'B':
            stacks.setdefault((ev.get('pid'), ev.get('tid')), []).append(ev)
            out.append(ev)
        elif ph == 'E':
            stack = stacks.get((ev.get('pid'), ev.get('tid')))
            if not stack:
                continue                   # orphan E: its B was dropped
            stack.pop()
            out.append(ev)
        else:
            out.append(ev)
    for (pid, tid), stack in sorted(
            stacks.items(), key=lambda kv: (str(kv[0][0]), str(kv[0][1]))):
        for ev in reversed(stack):         # close innermost first
            out.append({'name': ev['name'], 'cat': ev.get('cat', 'span'),
                        'ph': 'E', 'ts': max(close_ts, ev.get('ts', 0.0)),
                        'pid': pid, 'tid': tid, 'args': {'flushed': True}})
    return out


def thread_metadata(pid=None):
    """Chrome 'M' thread_name events for every registered thread (the
    stable small-int tid -> thread name mapping)."""
    pid = os.getpid() if pid is None else pid
    with _rings_locked():
        named = sorted(_tids.values())
    return [{'name': 'thread_name', 'ph': 'M', 'pid': pid, 'tid': tid,
             'args': {'name': name}} for tid, name in named]


def chrome_events(flush_open=True, metadata=False, sync=True):
    """Merged span events from every thread ring: balanced, pid/tid
    stamped, sorted by timestamp with a deterministic tie order (ring
    creation order — two exports of the same data are identical).
    `sync=False` skips the metrics-registry push — crash dumps from a
    signal handler must not touch the registry locks the interrupted
    frame may hold."""
    pid = os.getpid()
    with _rings_locked():
        rings = list(_rings)
    now = _now_us()
    events = []
    for r in rings:
        evs = [dict(e, pid=pid) for e in r.snapshot()]
        if flush_open:
            evs = balance_events(evs, close_ts=now)
        events.append(evs)
    merged = [e for evs in events for e in evs]
    # stable sort: per-ring order is already correct; ties across rings
    # resolve by ring (creation) order, which never changes
    merged.sort(key=lambda e: e.get('ts', 0.0))
    if sync:
        _sync_metrics()
    if metadata:
        return thread_metadata(pid) + merged
    return merged


def dump(path):
    """One standalone chrome://tracing JSON of every thread's spans
    (balanced + thread-name metadata), written atomically."""
    doc = {'traceEvents': chrome_events(flush_open=True, metadata=True),
           'displayTimeUnit': 'ms'}
    from ..serialization import atomic_write_file
    atomic_write_file(path, json.dumps(doc).encode())
    return path


# ---------------------------------------------------------------------------
# aggregation / introspection (flight recorder hooks)
# ---------------------------------------------------------------------------

def drain_aggregates(consumer_tid=None):
    """Merged {name: {'count', 'total_ms', 'self_ms',
    'consumer_self_ms'}} across every thread since the previous drain,
    clearing each ring's table (the per-step summary the flight
    recorder snapshots). `consumer_self_ms` is the self time recorded
    ON the `consumer_tid` thread — the step loop's own wall time; work
    on other threads overlaps the step and only counts in the totals.
    With `consumer_tid=None` every thread counts as the consumer."""
    with _rings_locked():
        rings = list(_rings)
    merged = {}
    for r in rings:
        agg, r.agg = r.agg, {}             # GIL-atomic swap
        on_consumer = consumer_tid is None or r.tid == consumer_tid
        for name, (count, total, self_us) in agg.items():
            st = merged.get(name)
            if st is None:
                st = merged[name] = {'count': 0, 'total_ms': 0.0,
                                     'self_ms': 0.0,
                                     'consumer_self_ms': 0.0}
            st['count'] += count
            st['total_ms'] += total / 1e3
            st['self_ms'] += self_us / 1e3
            if on_consumer:
                st['consumer_self_ms'] += self_us / 1e3
    return merged


def open_spans():
    """Currently open spans across all threads, outermost first:
    [{'name', 'thread', 'tid', 'age_ms'}] — the crash-time view of
    what every thread was inside when the process wedged."""
    now = _now_us()
    with _rings_locked():
        rings = list(_rings)
    out = []
    for r in rings:
        for name, t0, _child in list(r.stack):
            out.append({'name': name, 'thread': r.name, 'tid': r.tid,
                        'age_ms': round((now - t0) / 1e3, 3)})
    return out


def stats():
    """{'spans_total', 'dropped_spans_total', 'ring_depth', 'threads'}
    across every ring (ring_depth = events currently buffered)."""
    with _rings_locked():
        rings = list(_rings)
    return {
        'spans_total': sum(r.spans_total for r in rings),
        'dropped_spans_total': sum(r.dropped for r in rings),
        'ring_depth': sum(min(r.n, r.cap) for r in rings),
        'threads': len(rings),
    }


def _sync_metrics():
    """Push ring statistics into the metrics registry (counter deltas
    only — counters must be monotonic across repeated syncs)."""
    if not _telem['on']:
        return
    from . import metrics as _metrics
    st = stats()
    with _rings_locked():
        d_spans = st['spans_total'] - _synced['spans']
        d_dropped = st['dropped_spans_total'] - _synced['dropped']
        if d_spans > 0:
            _synced['spans'] = st['spans_total']
        if d_dropped > 0:
            _synced['dropped'] = st['dropped_spans_total']
    if d_spans > 0:
        _metrics.inc('mxnet_tpu_trace_spans_total', d_spans)
    if d_dropped > 0:
        _metrics.inc('mxnet_tpu_trace_dropped_spans_total', d_dropped)
    _metrics.set_gauge('mxnet_tpu_trace_ring_depth', st['ring_depth'])


def clear():
    """Drop every ring and aggregate. The tid map survives (tids stay
    stable for the process lifetime) and so does the enable state.
    Live threads holding a dropped ring re-register on their next span
    (generation check in _ring), so nothing records into limbo."""
    with _rings_lock:
        _gen[0] += 1
        _rings.clear()
        _synced['spans'] = 0
        _synced['dropped'] = 0


# config gate (read at import; declared in config.py)
from .. import config as _config_mod  # noqa: E402

if _config_mod.get('MXTPU_TRACE'):
    enable()
