"""Runtime telemetry: process-global metrics registry + recompile detector
(counterpart of ``mxnet_tpu/telemetry/metrics.py``; pure Python, the same
names, labels and exports, so one dashboard reads both packages).

Every instrumented path of the port (the CachedOp graph cache, the
compiled step and the Trainer's fused update, the serving engine) reports
into this registry.

- Near-zero cost when disabled: every instrumentation site checks the
  process-wide ``base.telem_flags['on']`` dict flag first, so a disabled
  run pays one dict lookup per site and records nothing.
- Three exports: ``prometheus()`` (text exposition format), ``dump(path)``
  (structured JSON), and ``chrome_events()`` (chrome-trace ``'C'``
  counter events).
- A recompile detector: compile sites (a CUDA-graph capture per
  hybridized block and input signature, the Trainer's fused update, ...)
  report every (re)compile with the signature that caused it; when one
  site compiles more than N times in one churn episode a
  ``RecompileWarning`` names the site and the churning signature.

Enable with ``MXNET_TPU_TELEMETRY=1`` (read at import) or
``telemetry.enable()``; read with ``report()`` / ``dump(path)`` /
``prometheus()``; zero with ``reset()``.
"""
from __future__ import annotations

import json
import re
import threading
import time as _time
import warnings
from typing import Any, Dict, Optional, Tuple

from ..base import MXNetError, telem_flags as _telem

__all__ = [
    'enable', 'disable', 'enabled', 'reset', 'report', 'dump', 'prometheus',
    'chrome_events', 'counter', 'gauge', 'histogram', 'inc', 'set_gauge',
    'observe', 'value', 'series', 'remove_series', 'record_compile',
    'record_cache_hit', 'record_step',
    'recent_samples_per_second', 'set_step_flops',
    'set_recompile_threshold', 'RecompileWarning',
    'Counter', 'Gauge', 'Histogram',
]

# every metric is namespaced + lowercase_snake (enforced here and by
# tools/check_telemetry_names.py over the whole tree)
_NAME_RE = re.compile(r'^mxnet_tpu_[a-z][a-z0-9_]*$')

_lock = threading.RLock()
_metrics: Dict[str, 'Metric'] = {}


class RecompileWarning(RuntimeWarning):
    """One compile site produced more than N distinct compilations."""


def _label_key(labels: Dict[str, Any]) -> Tuple:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


class Metric:
    kind = 'metric'

    def __init__(self, name: str, help: str = ''):
        if not _NAME_RE.match(name):
            raise MXNetError(
                f"telemetry metric name {name!r} must be lowercase_snake "
                f"and namespaced mxnet_tpu_*")
        self.name = name
        self.help = help
        # RLock: instrumented paths (checkpoint save gauges/histograms)
        # run inside the SIGTERM preemption save — a signal landing
        # while this thread is mid-inc() must re-enter, not deadlock.
        # A reentrant update can at worst lose one increment; a plain
        # Lock loses the whole preemption grace window.
        self._lock = threading.RLock()
        self._values: Dict[Tuple, Any] = {}

    def labelsets(self):
        with self._lock:
            return list(self._values)

    def remove_matching(self, **labels):
        """Drop every recorded labelset whose labels are a superset of
        ``labels`` (``remove_matching(rank=3)`` retires all of a departed
        rank's series whatever their other labels). Returns the number of
        series removed."""
        want = set(_label_key(labels))
        with self._lock:
            gone = [key for key in self._values if want <= set(key)]
            for key in gone:
                del self._values[key]
        return len(gone)

    def _fmt_labels(self, key: Tuple) -> str:
        if not key:
            return ''
        # Prometheus exposition format requires \\, \" and \n escaped in
        # label values (kvstore label values come from user-chosen keys)
        def esc(v):
            return str(v).replace('\\', r'\\').replace('"', r'\"') \
                .replace('\n', r'\n')
        return '{' + ','.join(f'{k}="{esc(v)}"' for k, v in key) + '}'


class Counter(Metric):
    kind = 'counter'

    def inc(self, amount: float = 1, **labels):
        key = _label_key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0) + amount

    def value(self, **labels):
        with self._lock:
            return self._values.get(_label_key(labels))


class Gauge(Metric):
    kind = 'gauge'

    def set(self, val: float, **labels):
        with self._lock:
            self._values[_label_key(labels)] = val

    def value(self, **labels):
        with self._lock:
            return self._values.get(_label_key(labels))


# Prometheus-style default latency buckets (seconds), upper bounds
DEFAULT_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                   0.25, 0.5, 1.0, 2.5, 5.0, 10.0)


class Histogram(Metric):
    kind = 'histogram'

    def __init__(self, name, help='', buckets=None):
        super().__init__(name, help)
        self.buckets = tuple(sorted(buckets or DEFAULT_BUCKETS))

    def observe(self, val: float, **labels):
        key = _label_key(labels)
        with self._lock:
            st = self._values.get(key)
            if st is None:
                st = {'buckets': [0] * (len(self.buckets) + 1),
                      'sum': 0.0, 'count': 0, 'min': val, 'max': val}
                self._values[key] = st
            for i, ub in enumerate(self.buckets):
                if val <= ub:
                    st['buckets'][i] += 1
                    break
            else:
                st['buckets'][-1] += 1          # +Inf bucket
            st['sum'] += val
            st['count'] += 1
            st['min'] = min(st['min'], val)
            st['max'] = max(st['max'], val)

    def value(self, **labels):
        """(count, sum) for the labelset, or None if never observed."""
        with self._lock:
            st = self._values.get(_label_key(labels))
            return None if st is None else (st['count'], st['sum'])


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

def _get_or_create(name, cls, help='', **kwargs):
    with _lock:
        m = _metrics.get(name)
        if m is None:
            m = cls(name, help, **kwargs)
            _metrics[name] = m
        elif not isinstance(m, cls):
            raise MXNetError(
                f"telemetry metric {name!r} already registered as "
                f"{m.kind}, not {cls.kind}")
        return m


def counter(name: str, help: str = '') -> Counter:
    return _get_or_create(name, Counter, help)


def gauge(name: str, help: str = '') -> Gauge:
    return _get_or_create(name, Gauge, help)


def histogram(name: str, help: str = '', buckets=None) -> Histogram:
    return _get_or_create(name, Histogram, help, buckets=buckets)


# one-liner helpers for instrumentation sites (get-or-create + record)
def inc(name: str, amount: float = 1, **labels):
    counter(name).inc(amount, **labels)


def set_gauge(name: str, val: float, **labels):
    gauge(name).set(val, **labels)


def observe(name: str, val: float, **labels):
    histogram(name).observe(val, **labels)


def value(name: str, **labels):
    """Current value of a metric/labelset, or None if never recorded."""
    with _lock:
        m = _metrics.get(name)
    return None if m is None else m.value(**labels)


def remove_series(name: str, **labels):
    """Retire every labelset of ``name`` matching the ``labels`` subset
    (no-op for an unregistered metric): the fleet monitor evicts a
    departed rank's gauge rows with it."""
    with _lock:
        m = _metrics.get(name)
    return 0 if m is None else m.remove_matching(**labels)


def series(name: str):
    """[(labels dict, raw value)] for every recorded labelset of a
    metric (e.g. every bucket's hits). Empty when the metric was never
    recorded."""
    with _lock:
        m = _metrics.get(name)
    if m is None:
        return []
    with m._lock:
        items = sorted(m._values.items())
    return [(dict(key), v) for key, v in items]


# ---------------------------------------------------------------------------
# enable / disable / reset
# ---------------------------------------------------------------------------

def enable():
    _telem['on'] = True


def disable():
    _telem['on'] = False


def enabled() -> bool:
    return _telem['on']


def reset():
    """Zero every metric and the recompile/step detectors (registrations
    and enable state are kept)."""
    with _lock:
        for m in _metrics.values():
            with m._lock:
                m._values.clear()
        _compile_sites.clear()
        _step_state['flops'] = None
        _step_state['peak_flops'] = None
        _step_state['last_step_monotonic'] = None


# ---------------------------------------------------------------------------
# recompile detector
# ---------------------------------------------------------------------------

# site -> {'compiles': total, 'episode': compiles this churn episode,
#          'warned': bool, 'mark': _step_mark at the last compile}
_compile_sites: Dict[str, Dict[str, Any]] = {}
_recompile_threshold: Optional[int] = None   # None -> read config lazily
_step_mark = [0]   # bumped by record_step; the recompile detector's clock


def set_recompile_threshold(n: Optional[int]):
    """Warn when one compile site exceeds `n` compiles (None restores the
    MXNET_TPU_RECOMPILE_WARN_THRESHOLD config default)."""
    global _recompile_threshold
    _recompile_threshold = n


def _threshold() -> int:
    if _recompile_threshold is not None:
        return _recompile_threshold
    from .. import config as _config
    return _config.get('MXNET_TPU_RECOMPILE_WARN_THRESHOLD')


def record_compile(site: str, signature: str, seconds: float,
                   detail: str = ''):
    """One (re)compilation (a CUDA-graph capture or a kernel build) at
    `site` for input `signature`.

    Feeds the compile counters and the recompile detector: when a site's
    compile count within one churn episode exceeds the threshold, a
    RecompileWarning names the churning signature (and, when the compile
    ledger supplies one, the exact churning axis via `detail`) so the
    shape/dtype instability is actionable.  The latch clears per
    episode, matching the memory-leak detector's discipline: a site
    that goes quiet for more than the threshold's worth of training
    steps (record_step marks) starts a fresh episode and re-fires.
    """
    inc('mxnet_tpu_compile_total', site=site)
    counter('mxnet_tpu_compile_seconds_total').inc(seconds, site=site)
    with _lock:
        mark = _step_mark[0]
        st = _compile_sites.setdefault(
            site, {'compiles': 0, 'episode': 0, 'warned': False,
                   'mark': mark})
        if mark - st.get('mark', mark) > _threshold():
            # quiet for > threshold steps since this site's last
            # compile: the churn episode ended — clear the latch
            st['warned'] = False
            st['episode'] = 0
        st['compiles'] += 1
        st['episode'] = st.get('episode', st['compiles'] - 1) + 1
        st['mark'] = mark
        fire = st['episode'] > _threshold() and not st['warned']
        if fire:
            st['warned'] = True
            n = st['compiles']
    if fire:
        inc('mxnet_tpu_recompile_warnings_total', site=site)
        axis = f" Churning axis: {detail}." if detail else ""
        warnings.warn(
            f"telemetry: {site} has compiled {n} times "
            f"(> threshold {_threshold()}); latest signature: {signature}."
            f"{axis} "
            f"Churning input shapes/dtypes force a new capture every "
            f"step — pad or bucket inputs to a fixed signature.",
            RecompileWarning, stacklevel=3)


def record_cache_hit(site: str):
    inc('mxnet_tpu_compile_cache_hits_total', site=site)


# ---------------------------------------------------------------------------
# step instrumentation (trainer / executor)
# ---------------------------------------------------------------------------

_step_state: Dict[str, Optional[float]] = {
    'flops': None, 'peak_flops': None, 'last_step_monotonic': None}


_UNSET = object()


def set_step_flops(flops_per_step: Optional[float],
                   peak_flops: Any = _UNSET):
    """Supply the model FLOPs of one optimization step (and optionally the
    accelerator peak FLOP/s) so record_step can publish an MFU gauge.
    Omitting peak_flops keeps the current peak; passing None clears it."""
    _step_state['flops'] = flops_per_step
    if peak_flops is not _UNSET:
        _step_state['peak_flops'] = peak_flops


def record_step(seconds: float, samples: int):
    """One full training iteration: step-time histogram, samples/sec
    gauge, and — when set_step_flops was called with both numbers — an
    MFU estimate."""
    observe('mxnet_tpu_step_time_seconds', seconds)
    inc('mxnet_tpu_steps_total')
    _step_mark[0] += 1
    _step_state['last_step_monotonic'] = _time.monotonic()
    if seconds > 0:
        set_gauge('mxnet_tpu_samples_per_second', samples / seconds)
        flops, peak = _step_state['flops'], _step_state['peak_flops']
        if flops and peak:
            set_gauge('mxnet_tpu_mfu_percent',
                      100.0 * flops / (seconds * peak))


def recent_samples_per_second(max_age_seconds: float):
    """The step samples/sec gauge, but only when a step was recorded
    within the last `max_age_seconds` — a stale gauge from an earlier
    training phase must not masquerade as a current rate (e.g. during an
    eval loop where no Trainer is stepping). None otherwise."""
    last = _step_state['last_step_monotonic']
    if last is None or _time.monotonic() - last > max_age_seconds:
        return None
    return value('mxnet_tpu_samples_per_second')


# ---------------------------------------------------------------------------
# exports
# ---------------------------------------------------------------------------

def _snapshot():
    """[(metric, [(labelkey, value-or-histstate), ...]), ...] — metrics
    with at least one recorded value, sorted by name."""
    with _lock:
        metrics = sorted(_metrics.values(), key=lambda m: m.name)
    out = []
    for m in metrics:
        with m._lock:
            vals = sorted(m._values.items())
        if vals:
            out.append((m, vals))
    return out


def report() -> str:
    """Human-readable summary of every recorded metric; empty string when
    nothing has been recorded (e.g. telemetry disabled)."""
    lines = []
    for m, vals in _snapshot():
        for key, v in vals:
            label = m.name + m._fmt_labels(key)
            if m.kind == 'histogram':
                avg = v['sum'] / v['count'] if v['count'] else 0.0
                lines.append(
                    f"histogram  {label}  count={v['count']} "
                    f"sum={v['sum']:.6f} avg={avg:.6f} "
                    f"min={v['min']:.6f} max={v['max']:.6f}")
            else:
                vv = f"{v:.6f}".rstrip('0').rstrip('.') \
                    if isinstance(v, float) else str(v)
                lines.append(f"{m.kind:<9s}  {label}  {vv}")
    if not lines:
        return ''
    return '=== mxnet_tpu telemetry ===\n' + '\n'.join(lines)


def dump(path: str):
    """Structured JSON dump of every recorded metric."""
    doc = {}
    for m, vals in _snapshot():
        series = []
        for key, v in vals:
            entry = {'labels': dict(key)}
            if m.kind == 'histogram':
                entry.update(
                    buckets=dict(zip([str(b) for b in m.buckets] + ['+Inf'],
                                     v['buckets'])),
                    sum=v['sum'], count=v['count'],
                    min=v['min'], max=v['max'])
            else:
                entry['value'] = v
            series.append(entry)
        doc[m.name] = {'type': m.kind, 'help': m.help, 'series': series}
    with open(path, 'w') as f:
        json.dump(doc, f, indent=2, sort_keys=True)
    return path


def prometheus() -> str:
    """Prometheus text exposition format (0.0.4) of the registry."""
    lines = []
    for m, vals in _snapshot():
        if m.help:
            lines.append(f"# HELP {m.name} {m.help}")
        lines.append(f"# TYPE {m.name} {m.kind}")
        for key, v in vals:
            if m.kind == 'histogram':
                cum = 0
                for ub, n in zip(m.buckets, v['buckets']):
                    cum += n
                    le = dict(key); le['le'] = repr(float(ub))
                    lines.append(f"{m.name}_bucket"
                                 + m._fmt_labels(_label_key(le)) + f" {cum}")
                le = dict(key); le['le'] = '+Inf'
                lines.append(f"{m.name}_bucket"
                             + m._fmt_labels(_label_key(le))
                             + f" {v['count']}")
                lines.append(f"{m.name}_sum" + m._fmt_labels(key)
                             + f" {v['sum']}")
                lines.append(f"{m.name}_count" + m._fmt_labels(key)
                             + f" {v['count']}")
            else:
                lines.append(f"{m.name}{m._fmt_labels(key)} {v}")
    return '\n'.join(lines) + ('\n' if lines else '')


def chrome_events():
    """Current counter/gauge values as chrome-trace 'C' events (one
    snapshot row per metric series at dump time), to merge into a trace
    stream."""
    import os
    import time
    now = time.time() * 1e6
    pid = os.getpid()
    evs = []
    for m, vals in _snapshot():
        if m.kind == 'histogram':
            continue
        for key, v in vals:
            evs.append({'name': m.name + m._fmt_labels(key),
                        'cat': 'telemetry', 'ph': 'C', 'ts': now,
                        'pid': pid, 'tid': 0, 'args': {m.name: v}})
    return evs


# config gate (read at import; see config.py for the declaration)
from .. import config as _config_mod  # noqa: E402

if _config_mod.get('MXNET_TPU_TELEMETRY'):
    enable()
