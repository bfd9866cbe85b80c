"""The port's fleet observability and telemetry endpoint against the JAX
package's: the in-process cases of tests/test_fleet.py (clock-offset
estimation, local snapshots, the FleetMonitor's merge and detectors, the
gauge exports, the /metrics + /healthz + /flight endpoint with its
bounded handlers and per-request deadline, the disarmed zero-allocation
path, the per-rank trace dump) and the attribution cases of
tests/test_trace.py, each run once per package (``P``), plus direct
comparisons: one snapshot stream through both packages' monitors gives
the same anomaly sequence, the same step records give the same
attribution report (1e-9), and a lone process's /healthz has the JAX
document's keys.

Every server binds 127.0.0.1 on a free port and is stopped in a
``finally``; every client call has a deadline of 10 s or less.
"""
import importlib
import json
import socket
import threading
import time
import tracemalloc
import types
import urllib.error
import urllib.request

import numpy as onp
import pytest
from test_torch_jax_globals import jax_globals  # noqa: F401

PKGS = ('mxnet_tpu', 'mxnet_tpu_torch')


def _ns(name):
    tel = importlib.import_module(name + '.telemetry')
    return types.SimpleNamespace(
        name=name, telemetry=tel, fleet=tel.fleet, flight=tel.flight,
        server=tel.server, trace=tel.trace, attribution=tel.attribution,
        compile=tel.compile, memory=tel.memory,
        MXNetError=importlib.import_module(name + '.base').MXNetError,
        port=name == 'mxnet_tpu_torch')


def _clean(P):
    P.telemetry.disable()
    P.telemetry.reset()
    P.trace.disable()
    P.trace.clear()
    P.flight.get().clear()
    P.fleet._monitor = None
    P.server.stop()


@pytest.fixture(params=PKGS)
def P(request):
    ns = _ns(request.param)
    _clean(ns)
    yield ns
    _clean(ns)


def _free_port():
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def _get(url, timeout=5.0):
    try:
        with urllib.request.urlopen(url, timeout=timeout) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


# ---------------------------------------------------------------------------
# clock-offset estimation
# ---------------------------------------------------------------------------

def test_estimate_offset_prefers_min_rtt(P):
    off, rtt = P.fleet.estimate_offset(
        [(0.0, 0.10, 5.05), (1.0, 1.02, 6.013)])
    assert abs(off - 5.003) < 1e-9
    assert abs(rtt - 0.02) < 1e-9
    assert P.fleet.estimate_offset([]) is None


def test_estimate_offset_monotonic_rtt_beats_wallclock_step(P):
    honest = (10.0, 10.002, 15.001, 0.002)
    poisoned = (20.0, 19.951, 24.9755, 0.049)
    off, rtt = P.fleet.estimate_offset([poisoned, honest])
    assert abs(off - 5.0) < 1e-9 and rtt == 0.002
    assert P.fleet.estimate_offset([(0.0, 0.1, 5.05)]) is not None


# ---------------------------------------------------------------------------
# local snapshots
# ---------------------------------------------------------------------------

def test_local_snapshot_disarmed_is_none(P):
    assert P.fleet.local_snapshot() is None
    assert P.fleet.snapshot_bytes() == 0
    assert P.fleet.snapshot_bytes(snap=None, membership=_MS()) == 0


def test_local_snapshot_carries_step_spans_comm_counters(P):
    P.telemetry.enable()
    P.trace.enable()
    with P.trace.span('step.dispatch'):
        with P.trace.span('io.batch'):
            pass
    P.flight.get().record_step(1)
    time.sleep(0.005)
    with P.trace.span('h2d.device_put'):
        pass
    P.flight.get().record_step(2)
    P.telemetry.counter('mxnet_tpu_comm_collective_bytes_total').inc(
        1000, kind='all_reduce', axis='dp', stage='zero1')
    P.telemetry.counter('mxnet_tpu_comm_collective_bytes_total').inc(
        24, kind='all_gather', axis='dph', stage='zero1')
    P.telemetry.inc('mxnet_tpu_resilience_faults_injected_total',
                    site='io.decode', fault_kind='raise')
    snap = P.fleet.local_snapshot()
    assert snap['step'] == 2
    assert snap['wall_ms'] > 0
    assert 'h2d' in snap['spans_ms']
    assert snap['comm_bytes'] == {'dp': 1000, 'dph': 24}
    assert snap['counters'] == {'faults': 1}
    n = P.fleet.snapshot_bytes(snap)
    assert 0 < n < 1024, f"snapshot unexpectedly large: {n} bytes"


def test_local_snapshot_carries_memory_and_compile_fields(P):
    P.telemetry.enable()
    P.trace.enable()
    P.compile.enable()
    P.memory.enable()
    try:
        P.memory.sample(step=1)
        with P.trace.span('step.dispatch'):
            pass
        P.flight.get().record_step(1)
        snap = P.fleet.local_snapshot()
        assert set(snap['mem']) == {'live', 'peak', 'rss'}
        assert snap['compile'] == {'n': 0, 'seconds': 0.0}
    finally:
        P.compile.disable()
        P.memory.disable()
        P.memory.clear()


class _MS:
    rank = 0

    def clock_offset(self):
        return (0.000123, 0.0009)


def test_snapshot_bytes_includes_the_offset_field(P):
    P.telemetry.enable()
    P.trace.enable()
    with P.trace.span('step.dispatch'):
        pass
    P.flight.get().record_step(1)
    bare = P.fleet.snapshot_bytes(P.fleet.local_snapshot())
    wired = P.fleet.snapshot_bytes(membership=_MS())
    assert wired > bare, (wired, bare)


def test_comm_bytes_by_axis_aggregates_kinds(P):
    P.telemetry.enable()
    c = P.telemetry.counter('mxnet_tpu_comm_collective_bytes_total')
    c.inc(10, kind='all_gather', axis='dp', stage='zero1')
    c.inc(5, kind='reduce_scatter', axis='dp', stage='zero1')
    c.inc(7, kind='all_reduce', axis='dph', stage='off')
    assert P.fleet.comm_bytes_by_axis() == {'dp': 15, 'dph': 7}


# ---------------------------------------------------------------------------
# fleet view merge + detectors
# ---------------------------------------------------------------------------

def _mon(P, **kw):
    kw.setdefault('heartbeat_seconds', 0.1)
    kw.setdefault('stale_seconds', 30.0)
    return P.fleet.FleetMonitor(**kw)


def test_fleet_view_contains_ranks_and_skew(P):
    mon = _mon(P)
    for step in range(1, 4):
        mon.ingest(0, {'step': step, 'wall_ms': 100.0, 'loss': 1.0})
        mon.ingest(1, {'step': step, 'wall_ms': 300.0, 'loss': 1.1})
    v = mon.view()
    assert sorted(v['ranks']) == [0, 1]
    assert v['fleet']['ranks'] == 2
    assert v['fleet']['max_step'] == 3
    assert v['ranks'][0]['skew_ms'] == -100.0
    assert v['ranks'][1]['skew_ms'] == 100.0
    assert v['ranks'][1]['wall_ms'] == 300.0


def test_straggler_detector_flags_slow_rank(P):
    mon = _mon(P, straggler_factor=1.5)
    fired = []
    for step in range(1, 6):
        fired += mon.ingest(0, {'step': step, 'wall_ms': 100.0})
        fired += mon.ingest(2, {'step': step, 'wall_ms': 105.0})
        fired += mon.ingest(1, {'step': step, 'wall_ms': 400.0})
    kinds = [(k, i['rank']) for k, i in fired]
    assert ('fleet.straggler', 1) in kinds
    s = mon.straggler()
    assert s['rank'] == 1 and s['reason'] == 'slow' and s['flagged']
    assert s['wall_ms'] == 400.0


def test_straggler_detector_flags_stale_rank(P):
    mon = _mon(P, stale_seconds=0.05)
    mon.ingest(1, {'step': 1, 'wall_ms': 100.0})
    time.sleep(0.12)
    fired = mon.ingest(0, {'step': 1, 'wall_ms': 100.0})
    stale = [i for k, i in fired if k == 'fleet.straggler'
             and i['reason'] == 'stale']
    assert stale and stale[0]['rank'] == 1
    assert stale[0]['snapshot_age_seconds'] >= 0.05
    s = mon.straggler()
    assert s['rank'] == 1 and s['reason'] == 'stale'
    mon.ingest(1, {'step': 2, 'wall_ms': 100.0})
    assert mon.straggler() is None


def test_straggler_worst_fallback_names_the_slowest_unflagged(P):
    mon = _mon(P, straggler_factor=10.0)     # threshold never trips
    for step in range(1, 6):
        mon.ingest(0, {'step': step, 'wall_ms': 100.0})
        mon.ingest(1, {'step': step, 'wall_ms': 130.0})
    assert mon.straggler() is None
    s = mon.straggler(worst=True)
    assert s['rank'] == 1 and not s['flagged'] and s['reason'] == 'slow'


def test_step_time_regression_detector(P):
    mon = _mon(P, regression_factor=2.0)
    fired = []
    for step in range(1, 6):
        fired += mon.ingest(0, {'step': step, 'wall_ms': 100.0})
    assert not fired
    fired = mon.ingest(0, {'step': 6, 'wall_ms': 500.0})
    kinds = [k for k, _i in fired]
    assert 'fleet.step_regression' in kinds
    info = dict(fired)['fleet.step_regression']
    assert info['rank'] == 0 and info['factor'] >= 2.0
    again = mon.ingest(0, {'step': 7, 'wall_ms': 500.0})
    assert 'fleet.step_regression' not in [k for k, _ in again]


def test_regression_detector_uses_pre_update_baseline(P):
    mon = _mon(P, regression_factor=5.0)
    for step in range(1, 6):
        mon.ingest(0, {'step': step, 'wall_ms': 100.0})
    fired = mon.ingest(0, {'step': 6, 'wall_ms': 600.0})
    kinds = [k for k, _ in fired]
    assert 'fleet.step_regression' in kinds, fired
    info = dict(fired)['fleet.step_regression']
    assert info['baseline_ms'] == 100.0 and info['factor'] == 6.0


def test_comm_imbalance_flag_clears_when_offender_changes(P):
    mon = _mon(P, imbalance_factor=1.5)
    for step in range(1, 4):
        mon.ingest(0, {'step': step, 'wall_ms': 100.0,
                       'comm_bytes': {'dp': 1000 * step}})
        mon.ingest(1, {'step': step, 'wall_ms': 100.0,
                       'comm_bytes': {'dp': 5000 * step}})
    assert 'fleet.comm_imbalance' in mon.ranks[1].flags
    fired = []
    for step in range(4, 8):
        fired += mon.ingest(0, {'step': step, 'wall_ms': 100.0,
                                'comm_bytes': {'dp': 3000 + 50000 * step}})
        fired += mon.ingest(1, {'step': step, 'wall_ms': 100.0,
                                'comm_bytes': {'dp': 15000 + 1000 * step}})
    assert 'fleet.comm_imbalance' not in mon.ranks[1].flags
    hits = [i for k, i in fired if k == 'fleet.comm_imbalance']
    assert hits and hits[-1]['rank'] == 0


def test_memory_imbalance_detector(P):
    mon = _mon(P, memory_imbalance_factor=1.5)
    fired = mon.ingest(0, {'step': 1, 'mem': {'live': 1000, 'peak': 1200}})
    fired += mon.ingest(1, {'step': 1, 'mem': {'live': 4000, 'peak': 4100}})
    hits = [i for k, i in fired if k == 'fleet.memory_imbalance']
    assert hits and hits[0]['rank'] == 1 and hits[0]['ratio'] == 4.0
    assert mon.view()['ranks'][1]['memory_peak_bytes'] == 4100
    fired = mon.ingest(1, {'step': 2, 'mem': {'live': 1100}})
    assert 'fleet.memory_imbalance' not in mon.ranks[1].flags


def test_refresh_after_removal_does_not_resurrect_rows(P):
    P.telemetry.enable()
    mon = _mon(P)
    P.fleet._monitor = mon
    mon.ingest(0, {'step': 1, 'wall_ms': 100.0})
    mon.ingest(1, {'step': 1, 'wall_ms': 100.0})
    mon.remove_ranks([1])
    mon.refresh_gauges()
    assert P.telemetry.value('mxnet_tpu_fleet_snapshot_age_seconds',
                             rank=1) is None
    assert P.telemetry.value('mxnet_tpu_fleet_ranks') == 1


def test_loss_spike_detector(P):
    mon = _mon(P, loss_spike_sigma=6.0)
    fired = []
    for step in range(1, 13):
        fired += mon.ingest(0, {'step': step, 'wall_ms': 100.0,
                                'loss': 1.0 + 0.01 * (step % 3)})
    assert not [k for k, _ in fired if k == 'fleet.loss_spike']
    fired = mon.ingest(0, {'step': 13, 'wall_ms': 100.0, 'loss': 50.0})
    assert [k for k, _ in fired] == ['fleet.loss_spike']
    info = dict(fired)['fleet.loss_spike']
    assert info['rank'] == 0 and info['sigma'] >= 6.0


def test_loss_spike_fires_from_flat_baseline(P):
    mon = _mon(P, loss_spike_sigma=6.0)
    for step in range(1, 11):
        mon.ingest(0, {'step': step, 'wall_ms': 100.0, 'loss': 1.0})
    fired = mon.ingest(0, {'step': 11, 'wall_ms': 100.0, 'loss': 100.0})
    assert [k for k, _ in fired] == ['fleet.loss_spike'], fired


def test_comm_imbalance_detector(P):
    mon = _mon(P, imbalance_factor=1.5)
    fired = []
    for step in range(1, 4):
        fired += mon.ingest(0, {'step': step, 'wall_ms': 100.0,
                                'comm_bytes': {'dp': 1000 * step}})
        fired += mon.ingest(1, {'step': step, 'wall_ms': 100.0,
                                'comm_bytes': {'dp': 5000 * step}})
    hits = [i for k, i in fired if k == 'fleet.comm_imbalance']
    assert hits and hits[0]['rank'] == 1 and hits[0]['ratio'] >= 4.9


def test_anomalies_emit_flight_notes_and_metrics(P):
    P.telemetry.enable()
    P.trace.enable()
    mon = _mon(P, straggler_factor=1.5)
    for step in range(1, 6):
        mon.ingest(0, {'step': step, 'wall_ms': 100.0})
        mon.ingest(1, {'step': step, 'wall_ms': 400.0})
    notes = [e for e in P.flight.get().events()
             if e['kind'] == 'fleet.straggler']
    assert notes and notes[0]['rank'] == 1
    assert P.telemetry.value('mxnet_tpu_fleet_anomalies_total',
                             kind='fleet.straggler', rank=1) >= 1
    assert P.telemetry.value('mxnet_tpu_fleet_ranks') == 2
    assert P.telemetry.value('mxnet_tpu_fleet_step_ms', rank=1) == 400.0


def test_fleet_comm_gauge_mirrors_rank_totals(P):
    P.telemetry.enable()
    mon = _mon(P)
    mon.ingest(1, {'step': 1, 'wall_ms': 10.0,
                   'comm_bytes': {'dp': 1234}})
    mon.ingest(1, {'step': 2, 'wall_ms': 10.0,
                   'comm_bytes': {'dp': 2468}})
    assert P.telemetry.value('mxnet_tpu_fleet_comm_bytes',
                             rank=1, axis='dp') == 2468
    v = mon.view()
    assert v['ranks'][1]['comm_bytes_total'] == {'dp': 2468}
    assert v['ranks'][1]['comm_bytes_per_step'] == {'dp': 1234}


def test_removed_rank_gauge_rows_are_retired(P):
    P.telemetry.enable()
    mon = _mon(P)
    mon.ingest(0, {'step': 1, 'wall_ms': 100.0, 'loss': 1.0})
    mon.ingest(1, {'step': 1, 'wall_ms': 300.0, 'loss': 1.2,
                   'comm_bytes': {'dp': 10}})
    assert P.telemetry.value('mxnet_tpu_fleet_step_ms', rank=1) == 300.0
    mon.remove_ranks([1])
    for name in ('mxnet_tpu_fleet_step_ms', 'mxnet_tpu_fleet_last_step',
                 'mxnet_tpu_fleet_loss',
                 'mxnet_tpu_fleet_snapshot_age_seconds'):
        assert P.telemetry.value(name, rank=1) is None, name
    assert not [lb for lb, _v in
                P.telemetry.series('mxnet_tpu_fleet_comm_bytes')
                if lb.get('rank') == '1']
    assert P.telemetry.value('mxnet_tpu_fleet_step_ms', rank=0) == 100.0
    assert P.telemetry.value('mxnet_tpu_fleet_ranks') == 1


def test_removed_rank_is_evicted_not_latched_stale(P):
    mon = _mon(P, stale_seconds=0.05)
    mon.ingest(0, {'step': 1, 'wall_ms': 100.0})
    mon.ingest(1, {'step': 1, 'wall_ms': 100.0})
    time.sleep(0.12)
    mon.ingest(0, {'step': 2, 'wall_ms': 100.0})
    assert mon.straggler()['rank'] == 1
    mon.remove_ranks([1])
    assert mon.straggler() is None
    assert sorted(mon.view()['ranks']) == [0]


def test_export_writes_only_ingesting_ranks_gauges(P):
    P.telemetry.enable()
    mon = _mon(P)
    mon.ingest(0, {'step': 1, 'wall_ms': 100.0})
    mon.ingest(1, {'step': 1, 'wall_ms': 300.0})
    assert P.telemetry.value('mxnet_tpu_fleet_step_skew_ms', rank=0) == 0.0
    assert P.telemetry.value('mxnet_tpu_fleet_step_skew_ms',
                             rank=1) == 100.0
    mon.ingest(0, {'step': 2, 'wall_ms': 100.0})
    assert P.telemetry.value('mxnet_tpu_fleet_step_skew_ms',
                             rank=0) == -100.0


def test_set_heartbeat_rederives_the_auto_stale_threshold(P):
    mon = P.fleet.FleetMonitor(heartbeat_seconds=1.0, stale_seconds=0)
    assert mon.stale_seconds == 3.0
    assert mon.set_heartbeat(10.0).stale_seconds == 30.0
    fixed = P.fleet.FleetMonitor(stale_seconds=2.0)
    assert fixed.set_heartbeat(10.0).stale_seconds == 2.0


def test_monitor_knobs_and_process_global(P, monkeypatch):
    monkeypatch.setenv('MXTPU_FLEET_WINDOW', '7')
    monkeypatch.setenv('MXTPU_FLEET_STRAGGLER_FACTOR', '2.5')
    monkeypatch.setenv('MXTPU_HEARTBEAT_SECONDS', '2.0')
    mon = P.fleet.FleetMonitor()
    assert mon.window == 7 and mon.straggler_factor == 2.5
    assert mon.stale_seconds == 6.0
    assert P.fleet.monitor() is None
    assert P.fleet.monitor(create=True) is P.fleet.monitor()


# a seeded snapshot stream with a slow rank, a loss spike, a regression,
# a comm imbalance and a memory imbalance in it
def _stream(seed=3, steps=24):
    rng = onp.random.RandomState(seed)
    out = []
    comm = {0: 0, 1: 0, 2: 0}
    for step in range(1, steps + 1):
        for rank in (0, 1, 2):
            wall = float(100 + rng.randint(0, 10))
            if rank == 2 and step >= 10:
                wall *= 3.0
            if rank == 0 and step == 18:
                wall *= 8.0
            loss = round(2.0 - 0.01 * step + 0.001 * rng.randint(0, 5), 6)
            if rank == 1 and step == 15:
                loss = 40.0
            comm[rank] += 1000 * (4 if rank == 1 and step > 12 else 1)
            mem = 1000 + (3000 if rank == 0 and step > 20 else 0)
            out.append((rank, {'step': step, 'wall_ms': wall, 'loss': loss,
                               'comm_bytes': {'dp': comm[rank]},
                               'mem': {'live': mem, 'peak': mem}}))
    return out


def test_same_snapshot_stream_same_anomaly_sequence():
    got = {}
    for name in PKGS:
        P = _ns(name)
        _clean(P)
        try:
            mon = _mon(P)
            got[name] = [(rank, snap['step'], k, sorted(info.items()))
                         for rank, snap in _stream()
                         for k, info in mon.ingest(rank, snap)]
            view = mon.view()
            got[name + '.view'] = {r: {k: v for k, v in row.items()
                                       if k != 'snapshot_age_seconds'}
                                   for r, row in view['ranks'].items()}
        finally:
            _clean(P)
    kinds = {k for _r, _s, k, _i in got['mxnet_tpu']}
    assert kinds == {'fleet.straggler', 'fleet.loss_spike',
                     'fleet.step_regression', 'fleet.comm_imbalance',
                     'fleet.memory_imbalance'}, kinds
    assert got['mxnet_tpu_torch'] == got['mxnet_tpu']
    assert got['mxnet_tpu_torch.view'] == got['mxnet_tpu.view']


# ---------------------------------------------------------------------------
# the membership layer is not ported
# ---------------------------------------------------------------------------

def test_port_attach_and_detach_wait_for_the_membership_layer():
    P = _ns('mxnet_tpu_torch')
    for fn in (P.fleet.attach, P.fleet.detach):
        with pytest.raises(P.MXNetError, match='item 10'):
            fn()
        with pytest.raises(P.MXNetError, match='item 10'):
            fn(object())
    with pytest.raises(P.MXNetError, match='item 10'):
        P.server.TelemetryServer(port=0, membership=object(), start=False)
    with pytest.raises(P.MXNetError, match='item 10'):
        P.server.maybe_start(rank=0, membership=object())
    with pytest.raises(P.MXNetError, match='item 10'):
        P.server.stall_verdict(object())


# ---------------------------------------------------------------------------
# HTTP endpoints
# ---------------------------------------------------------------------------

def test_server_endpoints_and_404(P):
    P.telemetry.enable()
    P.trace.enable()
    P.telemetry.inc('mxnet_tpu_steps_total')
    with P.trace.span('step.dispatch'):
        pass
    P.flight.get().record_step(1)
    srv = P.server.TelemetryServer(port=0)
    base = f'http://127.0.0.1:{srv.port}'
    try:
        code, body = _get(base + '/metrics')
        assert code == 200 and 'mxnet_tpu_steps_total 1' in body
        code, body = _get(base + '/healthz')
        assert code == 200
        doc = json.loads(body)
        assert doc['status'] == 'ok' and doc['telemetry'] is True
        assert doc['last_step'] == 1
        code, body = _get(base + '/flight')
        assert code == 200
        doc = json.loads(body)
        assert doc['steps'][0]['step'] == 1
        assert 'traceEvents' in doc
        code, body = _get(base + '/nope')
        assert code == 404
    finally:
        srv.stop()


def test_lone_process_healthz_has_the_jax_documents_keys():
    docs = {}
    for name in PKGS:
        P = _ns(name)
        _clean(P)
        srv = P.server.TelemetryServer(port=0)
        try:
            code, body = _get(f'http://127.0.0.1:{srv.port}/healthz')
            assert code == 200
            docs[name] = json.loads(body)
        finally:
            srv.stop()
            _clean(P)
    j, t = docs['mxnet_tpu'], docs['mxnet_tpu_torch']
    assert set(t) == set(j), (set(t) ^ set(j))
    assert t['last_committed_step'] is None and j['last_committed_step'] \
        is None
    assert t['verdict'] is None and j['verdict'] is None
    assert t['status'] == j['status'] == 'ok'
    assert set(t['memory']) >= {'live_bytes', 'source', 'peak_bytes',
                                'host_rss_bytes', 'tracked_bytes'}
    assert set(t['compile']) >= {'enabled', 'compiles', 'seconds'}


def test_verdict_during_an_open_compile_window(P):
    """A lone process's stall verdict: 'compiling' while a compile window
    is open, else None (the JAX package's single-process branch)."""
    P.compile.enable()
    try:
        ctx = P.compile.begin('cachedop:probe')
        srv = P.server.TelemetryServer(port=0, start=False)
        v = srv.health()['verdict']
        assert v['verdict'] == 'compiling' and v['lost'] == []
        assert v['compiling']['site'] == 'cachedop:probe'
        assert v['compiling']['rank'] is None
        P.compile.abort(ctx)
        assert srv.health()['verdict'] is None
    finally:
        P.compile.disable()
        P.compile.clear(ledger='')


def test_healthz_embeds_the_fleet_view(P):
    mon = _mon(P)
    P.fleet._monitor = mon
    mon.ingest(0, {'step': 2, 'wall_ms': 50.0})
    srv = P.server.TelemetryServer(port=0)
    try:
        code, body = _get(f'http://127.0.0.1:{srv.port}/healthz')
        doc = json.loads(body)
        assert code == 200 and doc['fleet']['fleet']['max_step'] == 2
    finally:
        srv.stop()


def test_server_bounded_handlers_shed_load(P):
    srv = P.server.TelemetryServer(port=0, max_handlers=2)
    base = f'http://127.0.0.1:{srv.port}'
    results = []

    def hit():
        try:
            results.append(_get(base + '/metrics', timeout=5)[0])
        except Exception as e:
            results.append(repr(e))
    try:
        threads = [threading.Thread(target=hit) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=10)
        assert not any(t.is_alive() for t in threads)
        assert any(r == 200 for r in results), results
        assert _get(base + '/metrics')[0] == 200
    finally:
        srv.stop()


def test_trickling_client_cannot_hold_a_slot_past_deadline(P):
    srv = P.server.TelemetryServer(port=0, max_handlers=2)
    try:
        s = socket.create_connection(('127.0.0.1', srv.port), timeout=5)
        t0 = time.monotonic()
        s.sendall(b'G')
        closed = False
        while time.monotonic() - t0 < 10.0:
            time.sleep(0.3)
            try:
                s.sendall(b'X')
            except OSError:
                closed = True
                break
        assert closed, "trickling connection survived the deadline"
        assert time.monotonic() - t0 < 9.0
        s.close()
        assert _get(f'http://127.0.0.1:{srv.port}/metrics')[0] == 200
    finally:
        srv.stop()


def test_server_knob_gate(P, monkeypatch):
    monkeypatch.delenv('MXTPU_METRICS_PORT', raising=False)
    assert P.server.maybe_start(rank=0) is None
    port = _free_port()
    monkeypatch.setenv('MXTPU_METRICS_PORT', str(port))
    srv = P.server.maybe_start(rank=0)
    try:
        assert srv is not None and srv.port == port
        assert P.server.start(rank=0) is srv
        assert P.server.get() is srv
    finally:
        P.server.stop()
    assert P.server.get() is None


def test_scrape_refreshes_silent_ranks_age_gauge(P):
    P.telemetry.enable()
    mon = _mon(P)
    P.fleet._monitor = mon
    mon.ingest(0, {'step': 1, 'wall_ms': 100.0})
    mon.ingest(1, {'step': 1, 'wall_ms': 100.0})
    time.sleep(0.15)
    mon.ingest(0, {'step': 2, 'wall_ms': 100.0})
    frozen = P.telemetry.value('mxnet_tpu_fleet_snapshot_age_seconds',
                               rank=1)
    assert frozen is not None and frozen < 0.1
    srv = P.server.TelemetryServer(port=0)
    try:
        body = _get(f'http://127.0.0.1:{srv.port}/metrics')[1]
    finally:
        srv.stop()
    age = P.telemetry.value('mxnet_tpu_fleet_snapshot_age_seconds', rank=1)
    assert age >= 0.15, age
    assert 'mxnet_tpu_fleet_snapshot_age_seconds{rank="1"}' in body


def test_thread_exhaustion_releases_handler_slot(P, monkeypatch):
    srv = P.server.TelemetryServer(port=0, max_handlers=2)
    base = f'http://127.0.0.1:{srv.port}'
    try:
        assert _get(base + '/metrics')[0] == 200

        class _Unstartable:
            def __init__(self, *a, **kw):
                pass

            def start(self):
                raise RuntimeError("can't start new thread")
        monkeypatch.setattr(P.server.threading, 'Thread', _Unstartable)
        for _ in range(8):
            try:
                _get(base + '/metrics', timeout=2)
            except Exception:
                pass
        monkeypatch.undo()
        time.sleep(0.1)
        assert _get(base + '/metrics')[0] == 200
    finally:
        srv.stop()


def test_post_to_the_telemetry_endpoint_is_405(P):
    srv = P.server.TelemetryServer(port=0)
    try:
        req = urllib.request.Request(
            f'http://127.0.0.1:{srv.port}/metrics', data=b'',
            method='POST')
        try:
            with urllib.request.urlopen(req, timeout=5) as r:
                code = r.status
        except urllib.error.HTTPError as e:
            code = e.code
        assert code == 405
    finally:
        srv.stop()


# ---------------------------------------------------------------------------
# disarmed cost: zero-alloc on the step path
# ---------------------------------------------------------------------------

def test_disarmed_fleet_paths_allocate_nothing(P):
    assert not P.trace.enabled() and not P.telemetry.enabled()

    def hot_loop(n):
        for _ in range(n):
            with P.trace.span('step.dispatch'):
                pass
            P.flight.record_step(1)
            P.fleet.local_snapshot()
    hot_loop(64)
    tracemalloc.start()
    before = tracemalloc.take_snapshot()
    hot_loop(2000)
    after = tracemalloc.take_snapshot()
    tracemalloc.stop()
    grown = sum(d.size_diff for d in after.compare_to(before, 'filename')
                if d.size_diff > 0)
    assert grown < 4096, f"disarmed fleet path leaked {grown} bytes"
    assert P.flight.get().steps() == []


# ---------------------------------------------------------------------------
# per-rank trace dump
# ---------------------------------------------------------------------------

def test_dump_rank_trace_embeds_rank_and_offset(P, tmp_path):
    P.trace.enable()
    with P.trace.span('step.dispatch'):
        pass
    path = str(tmp_path / 'rank.json')
    P.fleet.dump_rank_trace(path, membership=None)
    doc = json.load(open(path))
    assert doc['rank'] == 0 and doc['clock_offset_us'] == 0.0
    assert any(e.get('name') == 'step.dispatch'
               for e in doc['traceEvents'])
    path2 = str(tmp_path / 'rank2.json')
    P.fleet.dump_rank_trace(path2, membership=_MS())
    doc2 = json.load(open(path2))
    assert doc2['clock_offset_us'] == 123.0 and doc2['clock_rtt_us'] == 900.0


# ---------------------------------------------------------------------------
# attribution (tests/test_trace.py's cases, then both packages at once)
# ---------------------------------------------------------------------------

def _mkstep(step, interval_ms, spans):
    return {'step': step, 'interval_ms': interval_ms,
            'spans_ms': {n: {'count': 1, 'total_ms': ms, 'self_ms': ms}
                         for n, ms in spans.items()}, 'loss': 2.0 - step}


def test_attribution_buckets_sum_to_wall(P):
    steps = [_mkstep(0, 100.0, {})] + [
        _mkstep(i, 40.0, {'io.batch': 6.0, 'io.prefetch_wait': 2.0,
                          'h2d.device_put': 4.0, 'comm.allreduce': 8.0,
                          'sync.lease_drain': 1.0,
                          'io.worker_fetch': 30.0,
                          'optimizer.fused': 15.0})
        for i in range(1, 5)]
    rep = P.attribution.report(steps, flops_per_step=1e9, peak_flops=1e12)
    assert rep['steps_used'] == 4
    assert rep['wall_ms_per_step'] == 40.0
    b = rep['buckets_ms']
    assert b['input'] == 8.0
    assert b['h2d'] == 4.0
    assert b['collective'] == 8.0
    assert b['host_sync'] == 1.0
    assert abs(sum(b.values()) - rep['wall_ms_per_step']) < 1e-6
    assert abs(sum(rep['bucket_fractions'].values()) - 1.0) < 1e-3
    assert rep['measured_fraction'] == round(21.0 / 40.0, 4)
    assert 'io.worker_fetch' in rep['spans_ms_per_step']
    assert rep['spans_ms_per_step']['io.batch']['count'] == 1.0
    assert rep['mfu_percent'] == round(100 * 1e9 / (0.040 * 1e12), 2)
    assert rep['loss_last'] == 2.0 - 4
    table = P.attribution.format_table(rep)
    for token in ('input', 'compute', 'honest MFU', 'io.batch'):
        assert token in table
    assert P.attribution.report([])['error']


def test_attribution_subsystem_coverage_helper(P):
    assert P.attribution.subsystems(
        ['io.batch', 'io.decode', 'h2d.pin', 'step.dispatch',
         'comm.all_gather', 'optimizer.fused', 'checkpoint.write',
         'nodot']) == ['checkpoint', 'comm', 'h2d', 'io', 'optimizer',
                       'step']


def _records(seed, n=12):
    rng = onp.random.RandomState(seed)
    names = ['io.batch', 'h2d.batch_put', 'comm.allreduce', 'sync.loss',
             'step.compiled', 'optimizer.fused', 'io.worker_fetch',
             'step.dispatch']
    out = []
    for i in range(n):
        spans = {}
        for name in names:
            if rng.rand() < 0.8:
                total = float(rng.uniform(0.1, 9.0))
                spans[name] = {'count': int(rng.randint(1, 4)),
                               'total_ms': total,
                               'self_ms': total * float(rng.uniform(0.3, 1))}
                if name == 'io.batch' and rng.rand() < 0.5:
                    spans[name]['consumer_self_ms'] = \
                        spans[name]['self_ms'] / 2
        rec = {'step': i, 'spans_ms': spans, 'loss': float(rng.randn())}
        if i:
            rec['interval_ms'] = float(rng.uniform(30.0, 60.0))
        out.append(rec)
    return out


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_attribution_reports_agree_between_packages(seed):
    from mxnet_tpu.telemetry import attribution as ja
    from mxnet_tpu_torch.telemetry import attribution as ta
    recs = _records(seed)
    kw = dict(flops_per_step=3.1e12, bytes_per_step=2.0e9,
              peak_flops=989e12, collective_bytes={'dp': 12345},
              gather_layers=[(0, 100, 1), ('enc1', 200, 2)])
    for skip in (1, 3):
        want = ja.report(recs, skip_first=skip, **kw)
        got = ta.report(recs, skip_first=skip, **kw)

        def flat(d, pre=''):
            for k, v in d.items():
                if isinstance(v, dict):
                    yield from flat(v, f'{pre}{k}.')
                else:
                    yield f'{pre}{k}', v
        fw, fg = dict(flat(want)), dict(flat(got))
        assert set(fw) == set(fg)
        for k, v in fw.items():
            if isinstance(v, float):
                assert abs(fg[k] - v) <= 1e-9, k
            else:
                assert fg[k] == v, k
        assert ta.format_table(got) == ja.format_table(want)


def test_memory_table_agrees_between_packages():
    from mxnet_tpu.telemetry import attribution as ja
    from mxnet_tpu_torch.telemetry import attribution as ta
    rep = {'peak_bytes_per_device': 9.5e8, 'source': 'memory_stats',
           'measured_fraction': 0.8, 'zero_stage': 1, 'dp': 1,
           'buckets_bytes': dict(zip(ja.MEMORY_BUCKETS,
                                     (4e8, 3e8, 1e8, 0.0, 1.5e8))),
           'bucket_fractions': dict(zip(ja.MEMORY_BUCKETS,
                                        (0.42, 0.32, 0.1, 0.0, 0.16))),
           'per_layer_bytes': {'enc0': 5e7, 'enc1': 6e7},
           'host_rss_bytes': 1.2e9}
    assert ta.MEMORY_BUCKETS == ja.MEMORY_BUCKETS
    assert ta.format_memory_table(rep) == ja.format_memory_table(rep)
    assert ta.format_memory_table(None) == ja.format_memory_table(None)
    assert not hasattr(ta, 'xla_cost')


def test_telemetry_exports_match_the_jax_package():
    j, t = _ns('mxnet_tpu'), _ns('mxnet_tpu_torch')
    for sub in ('server', 'fleet', 'attribution'):
        assert sub in t.telemetry.__all__
    assert set(t.fleet.__all__) == set(j.fleet.__all__)
    assert set(t.server.__all__) - {'stall_verdict'} == set(j.server.__all__)
    assert set(t.attribution.__all__) == set(j.attribution.__all__) - \
        {'xla_cost'}
