"""Profiler: per-op rows, scopes and counters as one chrome trace, and the
card's own trace (counterpart of ``mxnet_tpu/profiler.py``, ref:
python/mxnet/profiler.py, src/profiler/profiler.h:79,251-299).

MXNet's API: ``set_config`` (the JAX package's keys, unknown ones
refused), ``start``/``stop``/``pause``/``resume``/``set_state``,
``dump`` (one chrome-trace JSON), ``dumps`` (the aggregate table, or the
JSON), ``get_summary``, and ``Domain``, ``Task``, ``Frame``, ``Event``,
``Counter``, ``Marker``, ``scope``.

- Per-op rows (``profile_imperative`` or ``profile_all``) come from
  ``_imperative.invoke``: one row per NDArray op; with ``profile_sync``
  (or ``aggregate_stats``) the card's queue is drained before and after
  the op, so the row is the op's time to completion rather than its
  launch.
- ``dump()`` writes the op rows, the scopes and counters, the telemetry
  counters (``telemetry.chrome_events``) and the spans of
  ``telemetry.trace`` in one stream, in one tid space
  (``trace.tid_for_current_thread``), balanced.
- The device trace. Where ``jax_trace_dir`` (or
  ``MXNET_TPU_JAX_TRACE_DIR``) names a directory, ``start()`` starts a
  ``torch.profiler`` session over the CPU and, with a card, CUDA, and
  ``stop()`` writes its chrome trace there (``<host>_<pid>.pt.trace.json``,
  ``device_trace_file()``). The key keeps the JAX package's name, so a
  ``set_config`` call written for it works unchanged. torch runs one
  profiler at a time: ``start()`` with a trace directory raises
  ``MXNetError`` while another ``torch.profiler`` session is active,
  rather than leave the device trace out.
- ``annotate`` and ``StepTraceAnnotation`` are
  ``torch.profiler.record_function`` ranges, which both traces show.
"""
from __future__ import annotations

import json
import os
import socket
import threading
import time

import torch

from .base import MXNetError, prof_flags as _prof_flags
from .telemetry import trace as _trace_mod

__all__ = ['set_config', 'profiler_set_config', 'set_state', 'start', 'stop',
           'pause', 'resume', 'dump', 'dumps', 'get_summary', 'record_op',
           'device_trace_file', 'Domain', 'Task', 'Frame', 'Event',
           'Counter', 'Marker', 'scope', 'annotate', 'StepTraceAnnotation']

_config = {
    'filename': 'profile.json',
    'profile_all': False,
    'profile_symbolic': False,
    'profile_imperative': False,
    'profile_memory': False,
    'profile_api': False,
    'aggregate_stats': False,
    'continuous_dump': False,
    # each profiled op timed to completion on the card, not its launch
    'profile_sync': False,
    # the directory of the device trace (torch.profiler) that start()
    # takes; the JAX package's name for its XLA trace directory
    'jax_trace_dir': None,
}
_state = {'running': False, 'session': None, 'trace_dir': None,
          'trace_file': None,
          # whether THIS run has already dumped to the configured file:
          # continuous_dump only extends a file this run wrote
          'dumped_in_run': False}
_events = []
_events_lock = threading.Lock()
# op name -> [count, total_us, min_us, max_us] (aggregate_stats)
_op_stats = {}


def record_op(name, dur_us):
    """One per-op row (called by ``_imperative.invoke`` while op rows are
    on)."""
    now = time.time() * 1e6
    ev = {'name': name, 'cat': 'operator', 'ph': 'X',
          'ts': now - dur_us, 'dur': dur_us,
          'pid': os.getpid(), 'tid': _trace_mod.tid_for_current_thread()}
    with _events_lock:
        _events.append(ev)
        st = _op_stats.get(name)
        if st is None:
            _op_stats[name] = [1, dur_us, dur_us, dur_us]
        else:
            st[0] += 1
            st[1] += dur_us
            st[2] = min(st[2], dur_us)
            st[3] = max(st[3], dur_us)


def get_summary(reset=False):
    """The aggregate per-op table: name, calls, total, min, max and mean
    in ms (ref: profiler.py dumps with aggregate_stats)."""
    with _events_lock:
        rows = sorted(_op_stats.items(), key=lambda kv: -kv[1][1])
        if reset:
            _op_stats.clear()
    lines = [f"{'Name':<40s}{'Total Count':>12s}{'Time (ms)':>12s}"
             f"{'Min (ms)':>12s}{'Max (ms)':>12s}{'Avg (ms)':>12s}"]
    for name, (cnt, tot, mn, mx) in rows:
        lines.append(f"{name[:39]:<40s}{cnt:>12d}{tot / 1e3:>12.4f}"
                     f"{mn / 1e3:>12.4f}{mx / 1e3:>12.4f}"
                     f"{tot / cnt / 1e3:>12.4f}")
    return '\n'.join(lines)


def set_config(**kwargs):
    """Ref: python/mxnet/profiler.py set_config; takes effect at once if
    the profiler is running."""
    unknown = [k for k in kwargs if k not in _config]
    if unknown:
        raise MXNetError(f"profiler.set_config: unknown keys {unknown!r}")
    _config.update(kwargs)
    _sync_flags()


def _sync_flags():
    _prof_flags['op'] = bool(_state['running'] and (
        _config['profile_imperative'] or _config['profile_all']))
    _prof_flags['sync'] = bool(_config['profile_sync']
                               or _config['aggregate_stats'])


def profiler_set_config(mode='symbolic', filename='profile.json'):
    _config['filename'] = filename


def set_state(state='stop', profile_process='worker'):
    if state == 'run':
        start()
    else:
        stop()


def _trace_dir():
    from . import config as _envcfg
    return _config['jax_trace_dir'] or \
        _envcfg.get('MXNET_TPU_JAX_TRACE_DIR') or None


def _start_device_trace(tdir):
    """A torch.profiler session over the CPU and, with a card, CUDA."""
    from torch.profiler import ProfilerActivity, profile
    if _state['session'] is not None:
        raise MXNetError("profiler.start: the profiler is already running "
                         "with a device trace; stop() it first")
    if torch._C._autograd._profiler_enabled():
        raise MXNetError(
            "profiler.start: another torch.profiler session is active in "
            "this process, and torch runs one profiler at a time; stop it "
            f"before starting mx.profiler with a device trace ({tdir})")
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    session = profile(activities=acts)
    session.start()
    _state['session'] = session
    _state['trace_dir'] = tdir


def start(profile_process='worker'):
    tdir = _trace_dir()
    if tdir:
        _start_device_trace(tdir)
    _state['running'] = True
    with _events_lock:
        _events.clear()
        _op_stats.clear()
    _state['dumped_in_run'] = False
    _sync_flags()


def stop(profile_process='worker'):
    """Stop; with a device trace, write its chrome trace into the trace
    directory (``device_trace_file()`` names it)."""
    _state['running'] = False
    _sync_flags()
    session, tdir = _state['session'], _state['trace_dir']
    if session is None:
        return
    _state['session'] = _state['trace_dir'] = None
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    session.stop()
    os.makedirs(tdir, exist_ok=True)
    path = os.path.join(tdir, f'{socket.gethostname()}_{os.getpid()}'
                              f'.pt.trace.json')
    session.export_chrome_trace(path)
    _state['trace_file'] = path


def device_trace_file():
    """The chrome trace that the last ``stop()`` wrote, or None."""
    return _state['trace_file']


def pause(profile_process='worker'):
    _state['running'] = False
    _sync_flags()


def resume(profile_process='worker'):
    _state['running'] = True
    _sync_flags()


def _extra_events():
    """Telemetry counters as chrome 'C' events (when telemetry is on) and
    the step tracer's balanced spans with thread-name metadata."""
    from . import telemetry
    evs = telemetry.chrome_events() if telemetry.enabled() else []
    spans = _trace_mod.chrome_events(flush_open=True)
    if spans:
        evs = evs + _trace_mod.thread_metadata() + spans
    return evs


def dump(finished=True, profile_process='worker'):
    """Write one chrome-trace JSON (ref: profiler.h:79): op rows, scopes,
    counters, telemetry counters and spans. With continuous_dump, events
    already written leave memory and the file this run wrote is extended
    in place, nothing written twice."""
    continuous = _config['continuous_dump']
    with _events_lock:
        new_events = list(_events)
        if continuous:
            _events.clear()
    events = new_events + _extra_events()
    if continuous and _state['dumped_in_run'] \
            and os.path.exists(_config['filename']):
        try:
            with open(_config['filename']) as f:
                prev = json.load(f).get('traceEvents', [])
        except (OSError, ValueError):
            prev = []
        seen = {(e.get('name'), e.get('ph'), e.get('ts'), e.get('tid'))
                for e in prev}
        events = prev + [e for e in events
                         if (e.get('name'), e.get('ph'), e.get('ts'),
                             e.get('tid')) not in seen]
    events = _trace_mod.balance_events(events)
    with open(_config['filename'], 'w') as f:
        json.dump({'traceEvents': events, 'displayTimeUnit': 'ms'}, f)
    _state['dumped_in_run'] = True


def dumps(reset=False, format='table'):
    """The aggregate table when aggregate_stats is set (ref: profiler.py
    dumps), else the chrome-trace JSON of what was collected."""
    if _config['aggregate_stats'] and format == 'table':
        out = get_summary(reset=reset)
        if reset:
            with _events_lock:
                _events.clear()
        return out
    with _events_lock:
        evs = list(_events)
        if reset:
            _events.clear()
            _op_stats.clear()
    return json.dumps({'traceEvents': _trace_mod.balance_events(
        evs + _extra_events())})


def _emit(name, cat, ph, ts=None, args=None):
    ev = {'name': name, 'cat': cat, 'ph': ph,
          'ts': (ts if ts is not None else time.time() * 1e6),
          'pid': os.getpid(), 'tid': _trace_mod.tid_for_current_thread()}
    if args:
        ev['args'] = args
    with _events_lock:
        _events.append(ev)


class _Scope:
    def __init__(self, name, cat):
        self.name = name
        self.cat = cat

    def start(self):
        if _state['running']:
            _emit(self.name, self.cat, 'B')
        return self

    def stop(self):
        if _state['running']:
            _emit(self.name, self.cat, 'E')

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()


class Domain:
    def __init__(self, name):
        self.name = name

    def new_task(self, name):
        return Task(self, name)

    def new_counter(self, name, value=None):
        return Counter(self, name, value)

    def new_marker(self, name):
        return Marker(self, name)


class Task(_Scope):
    def __init__(self, domain, name):
        super().__init__(name, f'task/{domain.name}')


class Frame(_Scope):
    def __init__(self, domain, name):
        super().__init__(name, f'frame/{domain.name}')


class Event(_Scope):
    def __init__(self, name):
        super().__init__(name, 'event')


class Counter:
    def __init__(self, domain, name, value=None):
        self.domain = domain
        self.name = name
        self.value = value if value is not None else 0
        if value is not None:
            self._record()

    def _record(self):
        if _state['running']:
            _emit(self.name, f'counter/{self.domain.name}', 'C',
                  args={self.name: self.value})

    def set_value(self, value):
        self.value = value
        self._record()

    def increment(self, delta=1):
        self.value += delta
        self._record()

    def decrement(self, delta=1):
        self.value -= delta
        self._record()

    def __iadd__(self, v):
        self.increment(v)
        return self

    def __isub__(self, v):
        self.decrement(v)
        return self


class Marker:
    def __init__(self, domain, name):
        self.domain = domain
        self.name = name

    def mark(self, scope='process'):
        if _state['running']:
            _emit(self.name, f'marker/{self.domain.name}', 'I')


def scope(name='<unk>:'):
    return _Scope(name, 'scope')


def annotate(name):
    """A named range in the device trace (a context manager and a
    decorator): ``torch.profiler.record_function``."""
    return torch.profiler.record_function(name)


class StepTraceAnnotation:
    """Marks one training step in the device trace, as torch's profiler
    names its steps (``ProfilerStep#<n>``)."""

    def __init__(self, step_num):
        self._ctx = torch.profiler.record_function(f'ProfilerStep#{step_num}')

    def __enter__(self):
        return self._ctx.__enter__()

    def __exit__(self, *exc):
        return self._ctx.__exit__(*exc)
