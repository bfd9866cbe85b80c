"""Fleet observability: cross-rank telemetry aggregation + anomaly
detection (counterpart of ``mxnet_tpu/telemetry/fleet.py``, its
in-process part).

- ``local_snapshot()`` builds a compact per-step telemetry snapshot
  (last step + wall interval, span-bucket self-times, cumulative comm
  bytes per mesh hop, guard/fault/rollback counters, memory and compile
  fields) from the flight recorder and the metrics registry. A disarmed
  run records and allocates nothing for it.
- ``FleetMonitor.ingest(rank, snap)`` merges snapshots into a fleet view
  with per-rank step skew, exports it as ``mxnet_tpu_fleet_*``
  gauges/histograms, and runs the streaming anomaly detectors:

  - **step-time regression** — a rank's step wall above
    ``MXTPU_FLEET_REGRESSION_FACTOR`` x its own rolling baseline;
  - **straggler skew** — a rank above
    ``MXTPU_FLEET_STRAGGLER_FACTOR`` x the fleet median, or whose
    newest snapshot is older than ``MXTPU_FLEET_STALE_SECONDS``;
  - **loss spike** — a reported loss beyond
    ``MXTPU_FLEET_LOSS_SPIKE_SIGMA`` rolling standard deviations;
  - **comm imbalance** — per-rank comm bytes/step whose max/min ratio
    exceeds ``MXTPU_FLEET_IMBALANCE_FACTOR``; **memory imbalance**
    likewise over live device bytes.

  Each firing emits a ``fleet.*`` flight note.
- ``dump_rank_trace()`` writes this rank's chrome trace stamped with
  its rank and clock offset (``tools/stitch_traces.py`` merges them).

The JAX package carries the snapshots on the membership heartbeat of
``parallel.dist`` (``attach``/``detach``), which is not ported (ROADMAP
queue 1 item 10): here ``attach`` and ``detach`` raise, and a caller
feeds a monitor with ``ingest`` itself.
"""
from __future__ import annotations

import collections
import json
import os
import statistics
import threading
import time as _time

from ..base import MXNetError, telem_flags as _telem
from . import compile as _compile
from . import flight as _flight
from . import memory as _memory
from . import metrics as _metrics
from . import trace as _trace
from .attribution import bucket_of

__all__ = ['local_snapshot', 'snapshot_bytes', 'comm_bytes_by_axis',
           'FleetMonitor', 'monitor', 'attach', 'detach',
           'dump_rank_trace', 'estimate_offset']

# resilience counters carried in each snapshot: {short key: metric}
_COUNTER_METRICS = {
    'faults': 'mxnet_tpu_resilience_faults_injected_total',
    'bad_steps': 'mxnet_tpu_resilience_bad_steps_total',
    'rollbacks': 'mxnet_tpu_resilience_rollbacks_total',
}


def comm_bytes_by_axis():
    """Cumulative analytic collective wire bytes by mesh hop axis
    ({'dp': ..., 'dph': ..., 'dpi': ...}) from the per-hop
    accounting counters. Empty when telemetry is off or no sharded
    step has run."""
    out = {}
    for labels, v in _metrics.series(
            'mxnet_tpu_comm_collective_bytes_total'):
        axis = labels.get('axis', '?')
        out[axis] = out.get(axis, 0) + int(v)
    return out


def _counter_sums():
    out = {}
    for key, name in _COUNTER_METRICS.items():
        total = sum(v for _l, v in _metrics.series(name))
        if total:
            out[key] = int(total)
    return out


def local_snapshot():
    """Compact per-rank telemetry snapshot dict, or None when both the
    metrics registry and the tracer are disarmed (nothing to report —
    the heartbeat then carries no payload at all)."""
    if not _telem['on'] and not _trace._state['on']:
        return None
    snap = {'time': round(_time.time(), 3)}
    rec = _flight.get().last_step_record()
    if rec is not None:
        snap['step'] = rec.get('step')
        if rec.get('interval_ms') is not None:
            snap['wall_ms'] = rec['interval_ms']
        if rec.get('loss') is not None:
            snap['loss'] = rec['loss']
        buckets = {}
        for name, st in (rec.get('spans_ms') or {}).items():
            b = bucket_of(name) or 'other'
            buckets[b] = round(buckets.get(b, 0.0) + st['self_ms'], 3)
        if buckets:
            snap['spans_ms'] = buckets
    comm = comm_bytes_by_axis()
    if comm:
        snap['comm_bytes'] = comm
    # memory watermark (MXTPU_MEMORY): a few tens of bytes so the
    # coordinator can flag per-rank memory imbalance before an OOM
    mem = _memory.snapshot_fields()
    if mem is not None:
        snap['mem'] = mem
    # compile plane (MXTPU_COMPILE_LEDGER): cumulative compile seconds
    # plus the in-flight window — a rank stuck in compile.backend shows
    # up in every peer's fleet table, not just its own logs
    comp = _compile.snapshot_fields()
    if comp is not None:
        snap['compile'] = comp
    counters = _counter_sums()
    if counters:
        snap['counters'] = counters
    step_val = _metrics.value('mxnet_tpu_steps_total')
    if 'step' not in snap and step_val is not None:
        snap['step'] = int(step_val)
    return snap


def snapshot_bytes(snap=None, membership=None):
    """Wire size of one snapshot as a heartbeat would carry it (JSON,
    including the clock-offset field the provider appends when
    ``membership`` has an estimate) — the bytes/beat number. With no
    explicit ``snap``, measures the provider output for ``membership``
    (any object with ``clock_offset()``), or ``local_snapshot()``."""
    if snap is None:
        snap = _provider_for(membership)() if membership is not None \
            else local_snapshot()
    if snap is None:
        return 0
    return len(json.dumps(snap).encode())


def estimate_offset(samples):
    """(offset_seconds, rtt_seconds) from ``(t_send, t_reply_received,
    remote_clock_at_handling[, rtt])`` round-trip samples — the
    minimum-RTT sample wins (its asymmetry error is bounded by rtt/2,
    the tightest available bound; NTP's core intuition). None for no
    samples.

    Supply the optional 4th element from a MONOTONIC clock pair when
    recording live: a wall-clock rtt (the 3-tuple fallback) is
    vulnerable to an NTP step between send and receive fabricating a
    near-zero rtt whose poisoned offset then wins the window. The JAX
    package's membership layer keeps this estimate per beat; this
    standalone form is what offline tools use on recorded samples."""
    best = None
    for sample in samples:
        t0, t1, remote = sample[0], sample[1], sample[2]
        rtt = float(sample[3]) if len(sample) > 3 else \
            float(t1) - float(t0)
        rtt = max(0.0, rtt)
        off = float(remote) - (float(t0) + float(t1)) / 2.0
        if best is None or rtt < best[1]:
            best = (off, rtt)
    return best


# ---------------------------------------------------------------------------
# coordinator-side fleet view + detectors
# ---------------------------------------------------------------------------

class _RankState:
    __slots__ = ('step', 'wall_ms', 'ewma_ms', 'loss', 'losses',
                 'comm_total', 'comm_rate', 'counters', 'offset',
                 'last_mono', 'last_time', 'snapshots', 'spans_ms',
                 'flags', 'mem_bytes', 'mem_peak', 'compile_seconds',
                 'compiling')

    def __init__(self):
        self.step = None
        self.wall_ms = None
        self.ewma_ms = None
        self.loss = None
        self.losses = None          # deque, sized by the monitor window
        self.comm_total = {}
        self.comm_rate = {}
        self.counters = {}
        self.offset = None
        self.last_mono = None
        self.last_time = None
        self.snapshots = 0
        self.spans_ms = {}
        self.flags = set()          # currently-raised anomaly kinds
        self.mem_bytes = None       # live device bytes (memory snapshot)
        self.mem_peak = None
        self.compile_seconds = None  # cumulative compile wall seconds
        self.compiling = None        # open compile window, or None


class FleetMonitor:
    """Merges per-rank snapshots into a fleet view and runs the
    streaming anomaly detectors. One process-global instance on the
    membership coordinator (``fleet.monitor()``); tests build their
    own. ``ingest(rank, snap)`` is the membership layer's
    ``on_snapshot`` hook — called outside the membership lock, takes
    only its own lock, and emits flight notes/metrics after releasing
    it (no cross-module lock nesting)."""

    def __init__(self, window=None, regression_factor=None,
                 straggler_factor=None, stale_seconds=None,
                 loss_spike_sigma=None, imbalance_factor=None,
                 heartbeat_seconds=None, memory_imbalance_factor=None):
        from .. import config as _config
        self.window = int(window if window is not None
                          else _config.get('MXTPU_FLEET_WINDOW'))
        self.regression_factor = float(
            regression_factor if regression_factor is not None
            else _config.get('MXTPU_FLEET_REGRESSION_FACTOR'))
        self.straggler_factor = float(
            straggler_factor if straggler_factor is not None
            else _config.get('MXTPU_FLEET_STRAGGLER_FACTOR'))
        if heartbeat_seconds is None:
            heartbeat_seconds = _config.get('MXTPU_HEARTBEAT_SECONDS')
        stale = (stale_seconds if stale_seconds is not None
                 else _config.get('MXTPU_FLEET_STALE_SECONDS'))
        # remembered so set_heartbeat (the attach() plumbing) can
        # re-derive the threshold for a membership whose heartbeat was
        # set by kwarg, not by the env knob
        self._stale_auto = not stale
        self.stale_seconds = float(stale) if stale else \
            3.0 * float(heartbeat_seconds)
        self.loss_spike_sigma = float(
            loss_spike_sigma if loss_spike_sigma is not None
            else _config.get('MXTPU_FLEET_LOSS_SPIKE_SIGMA'))
        self.imbalance_factor = float(
            imbalance_factor if imbalance_factor is not None
            else _config.get('MXTPU_FLEET_IMBALANCE_FACTOR'))
        self.memory_imbalance_factor = float(
            memory_imbalance_factor if memory_imbalance_factor is not None
            else _config.get('MXTPU_FLEET_MEMORY_IMBALANCE_FACTOR'))
        # RLock by the same signal-safety rationale as the flight
        # recorder: straggler()/view() are reachable from crash-time
        # reporting paths that may interrupt an ingest on this thread
        self._lock = threading.RLock()
        self.ranks = {}
        self.anomalies = collections.deque(maxlen=256)
        self.snapshots_total = 0

    def set_heartbeat(self, heartbeat_seconds):
        """Re-derive the auto stale threshold from the REAL heartbeat
        period (a membership built with ``heartbeat_seconds=10`` while
        the env knob sits at its 1.0 default would otherwise flag
        every healthy rank stale between beats). An explicit
        MXTPU_FLEET_STALE_SECONDS / stale_seconds wins unchanged."""
        if self._stale_auto:
            self.stale_seconds = 3.0 * float(heartbeat_seconds)
        return self

    # -- ingest ------------------------------------------------------------

    def ingest(self, rank, snap):
        """Merge one rank's snapshot; returns the anomaly firings
        ``[(kind, info), ...]`` of this round (also flight-noted)."""
        rank = int(rank)
        now = _time.monotonic()
        with self._lock:
            st = self.ranks.get(rank)
            if st is None:
                st = self.ranks[rank] = _RankState()
                st.losses = collections.deque(maxlen=self.window)
            stepped = (snap.get('step') is not None
                       and snap['step'] != st.step)
            st.last_mono = now
            st.last_time = snap.get('time')
            st.snapshots += 1
            self.snapshots_total += 1
            if snap.get('offset') is not None:
                st.offset = snap['offset']
            if snap.get('spans_ms'):
                st.spans_ms = dict(snap['spans_ms'])
            if snap.get('counters'):
                st.counters = dict(snap['counters'])
            fired = []
            mem = snap.get('mem')
            if mem and mem.get('live') is not None:
                st.mem_bytes = int(mem['live'])
                if mem.get('peak') is not None:
                    st.mem_peak = int(mem['peak'])
                fired += self._check_memory(now)
            comp = snap.get('compile')
            if comp:
                if comp.get('seconds') is not None:
                    st.compile_seconds = float(comp['seconds'])
                # in_flight present = the rank is mid-compile RIGHT NOW;
                # absent = clear the stale window from the last beat
                st.compiling = comp.get('in_flight')
            elif st.compiling is not None:
                st.compiling = None
            if stepped:
                dstep = snap['step'] - st.step if st.step is not None \
                    else None
                st.step = int(snap['step'])
                wall = snap.get('wall_ms')
                baseline = st.ewma_ms          # PRE-update: the rolling
                # baseline the regression detector compares against —
                # folding the current sample in first would raise the
                # effective trip point to 0.8f/(1-0.2f) x baseline and
                # make any factor >= 5 mathematically unfirable
                if wall is not None:
                    st.wall_ms = float(wall)
                    st.ewma_ms = wall if st.ewma_ms is None else \
                        0.8 * st.ewma_ms + 0.2 * wall
                if snap.get('comm_bytes'):
                    for axis, total in snap['comm_bytes'].items():
                        prev = st.comm_total.get(axis)
                        if prev is not None and dstep and total > prev:
                            st.comm_rate[axis] = \
                                (total - prev) / float(dstep)
                        st.comm_total[axis] = int(total)
                if snap.get('loss') is not None:
                    fired += self._check_loss(rank, st,
                                              float(snap['loss']))
                    st.loss = float(snap['loss'])
                    st.losses.append(st.loss)
                fired += self._check_step_time(rank, st, baseline)
                fired += self._check_imbalance()
            fired += self._check_stale(now)
            for kind, info in fired:
                self.anomalies.append(
                    {'kind': kind, 'time': _time.time(), **info})
        # notes + metrics OUTSIDE self._lock (flight recorder and
        # metrics registry take their own locks)
        for kind, info in fired:
            _flight.note(kind, **info)
        if _telem['on']:
            self._export(rank, snap.get('comm_bytes') or {}, fired,
                         stepped and snap.get('wall_ms') is not None)
        return fired

    # -- detectors (called with the lock held; pure state updates) ---------

    def _check_step_time(self, rank, st, baseline):
        fired = []
        if st.wall_ms is None:
            return fired
        # regression vs this rank's own rolling baseline — the EWMA as
        # it stood BEFORE this sample (the current excursion must not
        # contaminate the reference it is judged against)
        if baseline is not None and baseline > 0 and st.snapshots >= 4:
            if st.wall_ms > self.regression_factor * baseline:
                if 'fleet.step_regression' not in st.flags:
                    st.flags.add('fleet.step_regression')
                    fired.append(('fleet.step_regression', {
                        'rank': rank,
                        'wall_ms': round(st.wall_ms, 3),
                        'baseline_ms': round(baseline, 3),
                        'factor': round(st.wall_ms / baseline, 2)}))
            elif st.wall_ms < 1.1 * baseline:
                st.flags.discard('fleet.step_regression')
        # straggler skew vs the fleet median of the OTHER ranks
        others = [s.ewma_ms for r, s in self.ranks.items()
                  if r != rank and s.ewma_ms is not None]
        if others:
            med = _median(others)
            if med > 0 and st.wall_ms > self.straggler_factor * med:
                if 'fleet.straggler' not in st.flags:
                    st.flags.add('fleet.straggler')
                    fired.append(('fleet.straggler', {
                        'rank': rank, 'reason': 'slow',
                        'wall_ms': round(st.wall_ms, 3),
                        'fleet_median_ms': round(med, 3),
                        'skew': round(st.wall_ms / med, 2)}))
            elif st.wall_ms < 1.1 * med:
                st.flags.discard('fleet.straggler')
        return fired

    def _check_stale(self, now):
        """A rank whose snapshots stopped arriving is straggling even
        if its last reported step time was healthy (a wedged rank's
        heartbeat thread may still beat — but its step loop, and with
        it the advancing snapshot, is stuck)."""
        fired = []
        fresh = [s.last_mono for s in self.ranks.values()
                 if s.last_mono is not None]
        if len(fresh) < 2:
            return fired
        for rank, st in self.ranks.items():
            age = now - st.last_mono
            if age > self.stale_seconds:
                if 'fleet.stale' not in st.flags:
                    st.flags.add('fleet.stale')
                    fired.append(('fleet.straggler', {
                        'rank': rank, 'reason': 'stale',
                        'snapshot_age_seconds': round(age, 3),
                        'step': st.step}))
            else:
                st.flags.discard('fleet.stale')
        return fired

    def _check_loss(self, rank, st, loss):
        vals = list(st.losses)
        if len(vals) < 8:
            return []
        mean = sum(vals) / len(vals)
        var = sum((v - mean) ** 2 for v in vals) / len(vals)
        # epsilon floor: a perfectly flat window (std == 0) is the case
        # where ANY jump is most anomalous — a zero std must not make
        # the detector unfirable (and the missed spike would then
        # inflate the window and mask every later one too)
        std = max(var ** 0.5, abs(mean) * 1e-6, 1e-12)
        if loss <= mean + self.loss_spike_sigma * std:
            st.flags.discard('fleet.loss_spike')
            return []
        if 'fleet.loss_spike' in st.flags:
            return []
        st.flags.add('fleet.loss_spike')
        return [('fleet.loss_spike', {
            'rank': rank, 'loss': round(loss, 6),
            'mean': round(mean, 6), 'std': round(std, 6),
            'sigma': round((loss - mean) / std, 1)})]

    def _check_imbalance(self):
        rates = {r: sum(s.comm_rate.values())
                 for r, s in self.ranks.items() if s.comm_rate}
        live = {r: v for r, v in rates.items() if v > 0}
        if len(live) < 2:
            # fewer than 2 reporters is not "balanced" — it is
            # "uncomparable": clear any latched flag so a survivor
            # whose peer departed (or stopped reporting) is not stuck
            # flagged forever with its next offense latch-swallowed
            for st in self.ranks.values():
                st.flags.discard('fleet.comm_imbalance')
            return []
        hi_rank = max(live, key=live.get)
        ratio = live[hi_rank] / min(live.values())
        imbalanced = ratio > self.imbalance_factor
        fired = []
        # the flag lives ONLY on the current worst offender: a rank
        # that stops being the max must have its flag cleared, or its
        # next offense would be latch-swallowed forever
        for r, st in self.ranks.items():
            if r == hi_rank and imbalanced:
                if 'fleet.comm_imbalance' not in st.flags:
                    st.flags.add('fleet.comm_imbalance')
                    fired.append(('fleet.comm_imbalance', {
                        'rank': hi_rank, 'ratio': round(ratio, 2),
                        'bytes_per_step':
                            {r2: int(v) for r2, v in live.items()}}))
            else:
                st.flags.discard('fleet.comm_imbalance')
        return fired

    def _check_memory(self, _now):
        """Memory imbalance: per-rank live device bytes whose max/min
        ratio exceeds the factor flag the FATTEST rank — the one a
        shared-config fleet expects to OOM first (a rank quietly
        holding 1.5x its peers' memory is a layout bug or a leak, not
        load balancing). Same current-worst-offender flag discipline
        as the comm detector."""
        live = {r: s.mem_bytes for r, s in self.ranks.items()
                if s.mem_bytes}
        if len(live) < 2:
            # same unlatch-on-uncomparable rule as the comm detector:
            # a lone reporter must not keep a stale imbalance flag
            for st in self.ranks.values():
                st.flags.discard('fleet.memory_imbalance')
            return []
        hi_rank = max(live, key=live.get)
        ratio = live[hi_rank] / min(live.values())
        imbalanced = ratio > self.memory_imbalance_factor
        fired = []
        for r, st in self.ranks.items():
            if r == hi_rank and imbalanced:
                if 'fleet.memory_imbalance' not in st.flags:
                    st.flags.add('fleet.memory_imbalance')
                    fired.append(('fleet.memory_imbalance', {
                        'rank': hi_rank, 'ratio': round(ratio, 2),
                        'bytes': {r2: int(v) for r2, v in live.items()}}))
            else:
                st.flags.discard('fleet.memory_imbalance')
        return fired

    # -- exports -----------------------------------------------------------

    def _export(self, rank, comm_total, fired, stepped):
        """Gauge exports for ONE ingest. Only the ingesting rank's
        per-rank gauges are written (each rank refreshes its own row
        once per heartbeat — a fleet-wide rewrite here would be
        O(world^2) locked registry writes per heartbeat period, inside
        the coordinator's reply path); the fleet median for the skew
        gauge is a cheap O(world) read of in-memory state. Registry
        writes happen UNDER the monitor lock so a concurrent
        remove_ranks cannot interleave and resurrect a departed rank's
        rows after they were retired (the monitor->registry lock edge
        is one-directional — the registry never calls back)."""
        now = _time.monotonic()
        with self._lock:
            st = self.ranks.get(rank)
            if st is None:
                return
            n_ranks = len(self.ranks)
            walls = [s.wall_ms for s in self.ranks.values()
                     if s.wall_ms is not None]
            step, wall, loss = st.step, st.wall_ms, st.loss
            offset, mono = st.offset, st.last_mono
            med = _median(walls) if walls else None
            _metrics.set_gauge('mxnet_tpu_fleet_ranks', n_ranks)
            _metrics.inc('mxnet_tpu_fleet_snapshots_total', rank=rank)
            if step is not None:
                _metrics.set_gauge('mxnet_tpu_fleet_last_step', step,
                                   rank=rank)
            if wall is not None:
                _metrics.set_gauge('mxnet_tpu_fleet_step_ms', wall,
                                   rank=rank)
                if med is not None:
                    _metrics.set_gauge('mxnet_tpu_fleet_step_skew_ms',
                                       round(wall - med, 3), rank=rank)
                if stepped:
                    _metrics.observe('mxnet_tpu_fleet_step_seconds',
                                     wall / 1e3, rank=rank)
            if loss is not None:
                _metrics.set_gauge('mxnet_tpu_fleet_loss', loss,
                                   rank=rank)
            if offset:
                _metrics.set_gauge(
                    'mxnet_tpu_fleet_clock_offset_seconds', offset[0],
                    rank=rank)
            if mono is not None:
                _metrics.set_gauge(
                    'mxnet_tpu_fleet_snapshot_age_seconds',
                    round(now - mono, 3), rank=rank)
            if st.mem_bytes is not None:
                # mirrors the rank's own memory watermark (the same
                # exactly-agreeing-scrapes contract as the comm gauge)
                _metrics.set_gauge('mxnet_tpu_fleet_memory_bytes',
                                   st.mem_bytes, rank=rank)
            for axis, total in comm_total.items():
                # a gauge MIRRORING the rank's own cumulative per-hop
                # counter (not a local re-count): a fleet scrape of the
                # coordinator and a per-rank scrape of
                # mxnet_tpu_comm_collective_bytes_total must agree
                # exactly. Inside the lock like every _PER_RANK_METRICS
                # write — remove_ranks must not interleave and see
                # these rows resurrected.
                _metrics.set_gauge('mxnet_tpu_fleet_comm_bytes', total,
                                   rank=rank, axis=axis)
        for kind, info in fired:
            _metrics.inc('mxnet_tpu_fleet_anomalies_total', kind=kind,
                         rank=info.get('rank', rank))

    # -- queries -----------------------------------------------------------

    def view(self):
        """The merged fleet view: per-rank state + skew + the recent
        anomaly log — what /healthz embeds on the coordinator."""
        now = _time.monotonic()
        with self._lock:
            ranks = {}
            for r, st in self.ranks.items():
                ranks[r] = {
                    'step': st.step,
                    'wall_ms': st.wall_ms,
                    'ewma_ms': round(st.ewma_ms, 3)
                    if st.ewma_ms is not None else None,
                    'loss': st.loss,
                    'snapshot_age_seconds':
                        round(now - st.last_mono, 3)
                        if st.last_mono is not None else None,
                    'clock_offset': st.offset,
                    'comm_bytes_per_step':
                        {a: int(v) for a, v in st.comm_rate.items()},
                    'comm_bytes_total': dict(st.comm_total),
                    'memory_bytes': st.mem_bytes,
                    'memory_peak_bytes': st.mem_peak,
                    'counters': dict(st.counters),
                    'spans_ms': dict(st.spans_ms),
                    'snapshots': st.snapshots,
                    'flags': sorted(st.flags),
                }
            anomalies = list(self.anomalies)[-32:]
        walls = [v['wall_ms'] for v in ranks.values()
                 if v['wall_ms'] is not None]
        steps = [v['step'] for v in ranks.values()
                 if v['step'] is not None]
        med = _median(walls) if walls else None
        for v in ranks.values():
            v['skew_ms'] = round(v['wall_ms'] - med, 3) \
                if (med is not None and v['wall_ms'] is not None) \
                else None
        return {
            'ranks': ranks,
            'fleet': {
                'ranks': len(ranks),
                'max_step': max(steps) if steps else None,
                'min_step': min(steps) if steps else None,
                'median_wall_ms': round(med, 3)
                if med is not None else None,
                'snapshots_total': self.snapshots_total,
            },
            'anomalies': anomalies,
        }

    def straggler(self, worst=False):
        """The suspected straggler: the rank currently flagged by the
        skew/stale detectors (stale outranks slow — a silent rank is
        the stronger signal). With ``worst=True`` (the watchdog's stall
        path — SOMEBODY is suspect) falls back to the slowest/most-
        stale rank even when no detector threshold tripped. Returns
        ``{'rank', 'reason', 'snapshot_age_seconds', 'step',
        'max_step', 'wall_ms'}`` or None (fewer than 2 ranks)."""
        now = _time.monotonic()
        with self._lock:
            if len(self.ranks) < 2:
                return None
            items = list(self.ranks.items())
        steps = [st.step for _r, st in items if st.step is not None]
        max_step = max(steps) if steps else None

        def info(rank, st, reason, flagged):
            out = {
                'rank': rank, 'reason': reason, 'flagged': flagged,
                'snapshot_age_seconds': round(now - st.last_mono, 3)
                if st.last_mono is not None else None,
                'step': st.step, 'max_step': max_step,
                'wall_ms': st.wall_ms,
            }
            if st.compiling:
                # the rank's own heartbeat says it is mid-compile: the
                # verdict layer upgrades this straggler to COMPILING
                out['compiling'] = dict(st.compiling)
            return out

        stale = [(now - st.last_mono, r, st) for r, st in items
                 if 'fleet.stale' in st.flags]
        if stale:
            age, r, st = max(stale)
            return info(r, st, 'stale', True)
        slow = [(st.wall_ms, r, st) for r, st in items
                if 'fleet.straggler' in st.flags
                and st.wall_ms is not None]
        if slow:
            _w, r, st = max(slow)
            return info(r, st, 'slow', True)
        if not worst:
            return None
        # stall fallback (flagged=False: suspicion, not a tripped
        # detector): rank the fleet by staleness, then slowness
        aged = [(now - st.last_mono, r, st) for r, st in items
                if st.last_mono is not None]
        if aged:
            age, r, st = max(aged)
            med = _median([a for a, _r, _s in aged])
            if age > max(2.0 * med, 0.001):
                return info(r, st, 'stale', False)
        walls = [(st.wall_ms, r, st) for r, st in items
                 if st.wall_ms is not None]
        if walls:
            _w, r, st = max(walls)
            return info(r, st, 'slow', False)
        return None

    def refresh_gauges(self):
        """Re-export the staleness-sensitive gauges for EVERY rank —
        called at /metrics scrape time (O(world) per scrape). Ingest
        only writes the ingesting rank's row, so a rank that went
        SILENT would otherwise freeze at the ~0 age stamped by its own
        last beat — unalertable exactly when it matters."""
        if not _telem['on']:
            return
        now = _time.monotonic()
        # writes under the monitor lock: a concurrent remove_ranks
        # must not interleave between the state read and the gauge
        # write and have a departed rank's row resurrected
        with self._lock:
            _metrics.set_gauge('mxnet_tpu_fleet_ranks', len(self.ranks))
            for r, st in self.ranks.items():
                if st.last_mono is not None:
                    _metrics.set_gauge(
                        'mxnet_tpu_fleet_snapshot_age_seconds',
                        round(now - st.last_mono, 3), rank=r)

    # per-rank metric rows retired when their rank departs — a ghost
    # rank frozen at its last exported values would otherwise haunt
    # every /metrics scrape (and its never-growing snapshot age reads
    # as "perfectly fresh" to the very alert it should trip)
    _PER_RANK_METRICS = (
        'mxnet_tpu_fleet_last_step', 'mxnet_tpu_fleet_step_ms',
        'mxnet_tpu_fleet_step_skew_ms', 'mxnet_tpu_fleet_step_seconds',
        'mxnet_tpu_fleet_loss', 'mxnet_tpu_fleet_clock_offset_seconds',
        'mxnet_tpu_fleet_snapshot_age_seconds',
        'mxnet_tpu_fleet_comm_bytes', 'mxnet_tpu_fleet_memory_bytes',
    )

    def remove_ranks(self, ranks):
        """Evict departed ranks (the membership ``remove_peers``
        mirror, wired via ``on_peers_removed``): a preempted rank must
        not haunt the fleet view, skew the median, stay latched as the
        stale straggler in every future stall verdict, or linger as
        frozen gauge rows in the registry."""
        with self._lock:
            # registry retirement INSIDE the lock: an in-flight
            # _export/refresh_gauges serializes against this, so it
            # either finishes first (rows then removed here) or sees
            # the pruned rank dict (writes nothing) — never a
            # resurrected ghost row
            for r in ranks:
                self.ranks.pop(int(r), None)
                for name in self._PER_RANK_METRICS:
                    _metrics.remove_series(name, rank=int(r))
            if _telem['on']:
                _metrics.set_gauge('mxnet_tpu_fleet_ranks',
                                   len(self.ranks))

    def clear(self):
        with self._lock:
            self.ranks.clear()
            self.anomalies.clear()
            self.snapshots_total = 0


def _median(vals):
    return float(statistics.median(vals)) if vals else 0.0


# ---------------------------------------------------------------------------
# process-global wiring
# ---------------------------------------------------------------------------

_monitor = None
# RLock: monitor() is reachable from crash-time verdict paths (watchdog
# stall report via stall_verdict) — same re-entry rationale as
# flight._recorder_lock
_monitor_lock = threading.RLock()


def monitor(create=False):
    """The process-global FleetMonitor (the coordinator's merge +
    detector state). None until ``attach()`` — or ``create=True`` —
    built it."""
    global _monitor
    if _monitor is None and create:
        with _monitor_lock:
            if _monitor is None:
                _monitor = FleetMonitor()
    return _monitor


def _provider_for(ms):
    def provider():
        snap = local_snapshot()
        if snap is not None:
            off = ms.clock_offset()
            if off is not None:
                snap['offset'] = [round(off[0], 6), round(off[1], 6)]
        return snap
    return provider


def attach(membership=None):
    """Wire fleet telemetry onto the membership layer's heartbeats. The
    membership layer (``parallel.dist``) is not ported: raises."""
    raise MXNetError(
        "fleet.attach: the membership heartbeat (parallel.dist) is not "
        "ported (ROADMAP queue 1 item 10); feed a FleetMonitor with "
        "ingest(rank, snapshot) instead")


def detach(membership=None):
    """Symmetric with ``attach``: raises until the membership layer is
    ported (ROADMAP queue 1 item 10)."""
    raise MXNetError(
        "fleet.detach: the membership heartbeat (parallel.dist) is not "
        "ported (ROADMAP queue 1 item 10)")


def dump_rank_trace(path, membership=None):
    """One rank's chrome trace (balanced + thread metadata) stamped
    with ``rank`` and ``clock_offset_us`` — the per-rank input
    ``tools/stitch_traces.py`` merges into a fleet-wide timeline. With
    no ``membership`` (a lone process) the rank is 0 and the offset 0;
    a ``membership`` is any object with ``rank`` and
    ``clock_offset()``."""
    doc = {'traceEvents': _trace.chrome_events(flush_open=True,
                                               metadata=True),
           'displayTimeUnit': 'ms',
           'pid': os.getpid(),
           'rank': membership.rank if membership is not None else 0}
    off = membership.clock_offset() if membership is not None else (0.0,
                                                                    0.0)
    if off is not None:
        doc['clock_offset_us'] = round(off[0] * 1e6, 3)
        doc['clock_rtt_us'] = round(off[1] * 1e6, 3)
    from ..serialization import atomic_write_file
    atomic_write_file(path, json.dumps(doc).encode())
    return path
