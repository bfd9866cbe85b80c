"""Crash-time flight recorder: the last N steps, always ready to dump
(counterpart of ``mxnet_tpu/telemetry/flight.py``).

A bounded ring of per-step summaries (span self-times drained from
``telemetry.trace``, loss, guard flag, memory and compile fields) plus a
bounded log of notable events (sheds, OOM dumps, recompiles), dumped as
ONE atomic JSON:

- at interpreter exit (``atexit``) and on fatal signals
  (SIGTERM/SIGABRT, chaining any previously installed handler), once
  ``install_crash_hooks()`` ran (``MXTPU_TRACE=1`` runs it at import);
- on demand via ``flight.dump(reason=...)``.

The dump also embeds the balanced chrome ``traceEvents`` stream and
every thread's currently-OPEN spans, so a hang names the frame each
thread was inside.

Armed together with tracing (``MXTPU_TRACE=1``): ``record_step()`` is
a no-op while tracing is disarmed, so an untraced run pays one dict
check per step.

Losses are never read on the recording path. The JAX recorder reads
step N's device scalar when step N+1 is recorded; the port's compiled
step runs without a host sync (its loss is a CUDA tensor the graph
filled), so a recorded loss stays the tensor it was until a reader asks:
``steps()``, ``last_step_record()``, ``format_summary()`` and a dump
with ``resolve_loss=True`` read it then. A crash-time dump
(``resolve_loss=False``, the default of ``dump``) writes ``None`` for a
loss still on the device: reading it could block on a wedged card.
"""
from __future__ import annotations

import atexit
import collections
import contextlib
import json
import os
import signal as _signal
import threading
import time as _time

from ..base import telem_flags as _telem
from . import compile as _compile
from . import memory as _memory
from . import trace as _trace

__all__ = ['FlightRecorder', 'get', 'record_step', 'note',
           'annotate_last', 'dump', 'default_dump_path',
           'install_crash_hooks']


class FlightRecorder:
    """Bounded ring of step summaries + event log. One process-global
    instance (``flight.get()``); tests may build their own."""

    def __init__(self, capacity=None, event_capacity=256):
        if capacity is None:
            from .. import config as _config
            capacity = _config.get('MXTPU_FLIGHT_STEPS')
        self.capacity = max(1, int(capacity))
        self._steps = collections.deque(maxlen=self.capacity)
        self._events = collections.deque(maxlen=int(event_capacity))
        # RLock, same signal-safety rationale as the module-level
        # _recorder_lock: note() runs inside the atexit and fatal-signal
        # dumps — a signal landing while THIS thread holds the ring lock
        # (record_step's critical section) must re-enter, not deadlock.
        self._lock = threading.RLock()
        self._last_t = None          # perf_counter of the previous step
        self.dumps = 0

    # -- recording ---------------------------------------------------------

    def record_step(self, step, loss=None, guard_ok=None, extra=None):
        """One training step completed. `loss` may be a device tensor: it
        is NOT read here (no host sync); it stays in the record until a
        reader resolves it (see the module docstring). No-op while
        tracing is disarmed."""
        if not _trace._state['on']:
            return
        now = _time.perf_counter()
        # this thread runs the step loop: only ITS self-times may be
        # billed against step wall time (attribution); other threads'
        # spans overlap the step and count only in the totals
        rec = {'step': int(step), 'time': _time.time(), 'loss': loss,
               'spans_ms': _trace.drain_aggregates(
                   consumer_tid=_trace.tid_for_current_thread())}
        if self._last_t is not None:
            rec['interval_ms'] = round((now - self._last_t) * 1e3, 3)
        self._last_t = now
        if guard_ok is not None:
            rec['guard_ok'] = bool(guard_ok)
        # memory watermark fields (MXTPU_MEMORY): the newest sample's
        # prebuilt dict — disarmed this is one dict check returning the
        # shared None, same no-alloc discipline as the trace gate
        mem = _memory.step_fields()
        if mem is not None:
            rec['mem'] = mem
        # compile-ledger fields: only the first step after a compile
        # carries them (consume-on-read), same no-alloc discipline
        comp = _compile.step_fields()
        if comp is not None:
            rec['compile'] = comp
        if extra:
            rec.update(extra)
        with self._lock:
            self._steps.append(rec)
        _trace._sync_metrics()

    @staticmethod
    def _loss_value(loss, read_device=True):
        """A recorded loss as a float: a Python or numpy number as it is,
        a tensor (or NDArray) read now where `read_device` allows it, else
        None; a failed read gives None."""
        if loss is None or isinstance(loss, float):
            return loss
        data = getattr(loss, '_data', loss)
        if not read_device and getattr(getattr(data, 'device', None),
                                       'type', 'cpu') != 'cpu':
            return None
        try:
            return float(data)
        except Exception:
            return None

    def _resolved(self, records, read_device=True):
        """Copies of `records` with their losses as floats."""
        out = []
        for r in records:
            r = dict(r)
            r['loss'] = self._loss_value(r.get('loss'), read_device)
            out.append(r)
        return out

    def note(self, kind, /, **info):
        """One notable event (shed, OOM dump, recompile, ...). Bounded;
        no-op while tracing is disarmed."""
        if not _trace._state['on']:
            return
        ev = {'kind': kind, 'time': _time.time()}
        if info:
            ev.update(info)
        with self._lock:
            self._events.append(ev)

    def annotate_last(self, **fields):
        """Attach fields to the most recent step record (e.g. the
        guard's one-step-deferred verdict: annotate_last(guard_ok=False)
        lands on the step whose flag just drained bad)."""
        if not _trace._state['on']:
            return
        with self._lock:
            if self._steps:
                self._steps[-1].update(fields)

    # -- reading / dumping -------------------------------------------------

    @contextlib.contextmanager
    def _locked_for_dump(self, timeout=2.0):
        """Best-effort lock for the read/dump paths. A crash-time dump
        must never deadlock: same-thread signal re-entry is covered by
        the ring lock being an RLock, and a wedged holder on ANOTHER
        thread is waited for `timeout` seconds, then we proceed
        lock-free — safe, because a holder that timed us out is
        interrupted or blocked, not mutating."""
        got = self._lock.acquire(timeout=timeout)
        try:
            yield
        finally:
            if got:
                self._lock.release()

    def steps(self):
        """Copies of the step records, their losses read now."""
        with self._locked_for_dump():
            records = list(self._steps)
        return self._resolved(records)

    def last_step_record(self):
        """The newest step record (copy, its loss read now), or None;
        never drains the ring."""
        with self._locked_for_dump():
            last = self._steps[-1] if self._steps else None
        return None if last is None else self._resolved([last])[0]

    def events(self):
        with self._locked_for_dump():
            return [dict(e) for e in self._events]

    def snapshot(self, resolve_loss=False, signal_safe=False):
        """The full post-mortem document. `resolve_loss=False` at crash
        time: reading a loss still on the device could block on a wedged
        card, so those are written as None — the dump must never hang.
        `signal_safe=True` (fatal-signal handlers) additionally skips
        every metrics-registry touch: the interrupted frame may hold
        those locks."""
        with self._locked_for_dump():
            records = list(self._steps)
            events = [dict(e) for e in self._events]
        steps = self._resolved(records, read_device=resolve_loss)
        return {
            'pid': os.getpid(),
            'time': _time.time(),
            'steps': steps,
            'events': events,
            'open_spans': _trace.open_spans(),
            # the open compile window, when a capture or build is
            # mid-flight at crash time (which site, which phase, how long)
            'compile_in_flight': _compile.in_flight(),
            'trace_stats': _trace.stats(),
            'traceEvents': _trace.chrome_events(flush_open=True,
                                                metadata=True,
                                                sync=not signal_safe),
        }

    def dump(self, path=None, reason='', signal_safe=False):
        """Write the post-mortem JSON atomically. Returns the path, or
        None when there is nothing recorded (or tracing is disarmed) —
        an empty flight recorder never shadows a real dump.
        `signal_safe=True` (fatal-signal handlers) skips every
        metrics-registry touch: the interrupted frame may hold the
        registry's non-reentrant lock."""
        if not _trace._state['on']:
            return None
        with self._locked_for_dump():
            empty = not self._steps and not self._events
        if empty and not _trace.stats()['spans_total']:
            return None
        if path is None:
            path = default_dump_path()
        doc = self.snapshot(resolve_loss=False, signal_safe=signal_safe)
        doc['reason'] = reason or 'manual'
        # an on-demand dump and an atexit/SIGTERM dump can overlap; the
        # counter bump rides the same crash-tolerant lock as the ring
        # reads (timeout, then proceed — never wedge a dump)
        with self._locked_for_dump():
            self.dumps += 1
        if _telem['on'] and not signal_safe:
            from . import metrics as _metrics
            _metrics.inc('mxnet_tpu_trace_flight_dumps_total')
        d = os.path.dirname(path)
        if d:
            # a not-yet-created MXTPU_FLIGHT_DIR must not silently lose
            # the post-mortem
            os.makedirs(d, exist_ok=True)
        from ..serialization import atomic_write_file
        atomic_write_file(path, json.dumps(doc, default=str).encode())
        return path

    def format_summary(self, last=8):
        """Human-readable tail for log embedding."""
        steps = self.steps()[-last:]
        events = self.events()[-last:]
        lines = ['--- flight recorder (last %d steps) ---' % len(steps)]
        for r in steps:
            top = sorted(r['spans_ms'].items(),
                         key=lambda kv: -kv[1]['self_ms'])[:4]
            spans = ' '.join(f"{n}={st['self_ms']:.1f}ms" for n, st in top)
            lines.append(
                f"step {r['step']}: interval={r.get('interval_ms', '?')}ms "
                f"loss={r.get('loss')} guard_ok={r.get('guard_ok', '?')} "
                f"{spans}")
        for e in events:
            lines.append(f"event {e['kind']}: "
                         + ' '.join(f'{k}={v}' for k, v in e.items()
                                    if k not in ('kind', 'time')))
        for s in _trace.open_spans():
            lines.append(f"open span {s['name']} on thread {s['thread']} "
                         f"for {s['age_ms']:.0f}ms")
        return '\n'.join(lines)

    def clear(self):
        with self._lock:
            self._steps.clear()
            self._events.clear()
            self._last_t = None


def default_dump_path():
    """Where a dump with no explicit path lands: MXTPU_FLIGHT_PATH when
    set, else MXTPU_FLIGHT_DIR (default: the system temp directory —
    never the CWD) + mxtpu_flight-<pid>.json. The pid suffix keeps the
    ranks of a multi-process job from clobbering each other's black
    box."""
    from .. import config as _config
    explicit = _config.get('MXTPU_FLIGHT_PATH')
    if explicit:
        return explicit
    d = _config.get('MXTPU_FLIGHT_DIR')
    if not d:
        import tempfile
        d = tempfile.gettempdir()
    return os.path.join(d, f'mxtpu_flight-{os.getpid()}.json')


_recorder = None
# RLock: get() runs inside the fatal-signal dump hooks — a signal
# interrupting the first-construction critical section on this very
# thread must re-enter, not self-deadlock
_recorder_lock = threading.RLock()
_hooks = {'atexit': False, 'signals': False}


def get() -> FlightRecorder:
    global _recorder
    if _recorder is None:
        with _recorder_lock:
            if _recorder is None:
                _recorder = FlightRecorder()
    return _recorder


def record_step(step, loss=None, guard_ok=None, extra=None):
    get().record_step(step, loss=loss, guard_ok=guard_ok, extra=extra)


def note(kind, /, **info):
    get().note(kind, **info)


def annotate_last(**fields):
    get().annotate_last(**fields)


def dump(path=None, reason='', signal_safe=False):
    return get().dump(path=path, reason=reason, signal_safe=signal_safe)


def _atexit_dump():
    try:
        get().dump(reason='atexit')
    except Exception:
        pass


def _make_signal_handler(signum, prev):
    def handler(sig, frame):
        try:
            get().dump(reason=f'signal:{_signal.Signals(sig).name}',
                       signal_safe=True)
        except Exception:
            pass
        if callable(prev):
            prev(sig, frame)             # chain the previous handler
        elif prev == _signal.SIG_DFL:
            _signal.signal(sig, _signal.SIG_DFL)
            _signal.raise_signal(sig)
    return handler


def install_crash_hooks(signals=(getattr(_signal, 'SIGTERM', None),
                                 getattr(_signal, 'SIGABRT', None))):
    """Register the atexit dump and chain fatal-signal handlers so any
    crash leaves the post-mortem artifact. Idempotent; signal hooks are
    skipped quietly off the main thread (signal.signal would raise)."""
    if not _hooks['atexit']:
        _hooks['atexit'] = True
        atexit.register(_atexit_dump)
    if not _hooks['signals']:
        try:
            for sig in signals:
                if sig is None:
                    continue
                prev = _signal.getsignal(sig)
                _signal.signal(sig, _make_signal_handler(sig, prev))
            _hooks['signals'] = True
        except ValueError:
            pass                         # not the main thread


# armed together with tracing: MXTPU_TRACE=1 runs always leave a black
# box behind (an explicit trace.enable() mid-run can call
# install_crash_hooks itself)
from .. import config as _config_mod  # noqa: E402

if _config_mod.get('MXTPU_TRACE'):
    install_crash_hooks()
