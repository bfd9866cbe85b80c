"""The port's telemetry package against the JAX package's.

Every case of tests/test_telemetry.py, tests/test_trace.py,
tests/test_memory.py and the ledger and signature cases of
tests/test_compile.py that reads no JAX object runs here once per package
(``P`` is ``mxnet_tpu`` or ``mxnet_tpu_torch``): the same calls, the same
inputs, the same assertions. Where the port's contract differs by design
(a recorded loss is read when a reader asks, never at the next step;
OOM detection by ``torch.cuda.OutOfMemoryError``; the ledger's phases
``build`` and ``capture``; the kernel build directory as the persistent
cache) the case says so and holds the port to its own contract, on the
same inputs. Cases on the port's instrumented paths (the CachedOp, the
Trainer and ShardedTrainStep on the CPU) run both packages' paths and
compare what each reports. Nothing here needs a card.
"""
import importlib
import json
import os
import subprocess
import sys
import threading
import time
import tracemalloc
import types
import warnings

import numpy as onp
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir,
                                'tools'))
import check_trace  # noqa: E402  (the standalone validator)

PKGS = ('mxnet_tpu', 'mxnet_tpu_torch')


def _ns(name):
    pkg = importlib.import_module(name)
    tel = importlib.import_module(name + '.telemetry')
    return types.SimpleNamespace(
        name=name, pkg=pkg, telemetry=tel, trace=tel.trace,
        flight=tel.flight, memory=tel.memory, compile=tel.compile,
        metrics=tel.metrics, config=importlib.import_module(name + '.config'),
        MXNetError=importlib.import_module(name + '.base').MXNetError,
        port=name == 'mxnet_tpu_torch')


def _clean(P):
    P.telemetry.disable()
    P.telemetry.reset()
    P.telemetry.set_recompile_threshold(None)
    P.telemetry.set_step_flops(None, None)
    P.trace.disable()
    P.trace.set_ring_capacity(None)
    P.trace.clear()
    P.flight.get().clear()
    P.memory.disable()
    P.memory.clear(pools=True)
    P.compile.disable()
    P.compile.clear(ledger='', cache_dir='')


@pytest.fixture(params=PKGS)
def P(request):
    ns = _ns(request.param)
    _clean(ns)
    yield ns
    _clean(ns)


@pytest.fixture()
def telem(P):
    P.telemetry.enable()
    return P


# ---------------------------------------------------------------------------
# metrics registry (tests/test_telemetry.py)
# ---------------------------------------------------------------------------

def test_counter_gauge_histogram_semantics(telem):
    t = telem.telemetry
    c = t.counter('mxnet_tpu_test_requests_total')
    c.inc()
    c.inc(4)
    c.inc(2, route='a')
    assert c.value() == 5
    assert c.value(route='a') == 2
    assert c.value(route='missing') is None
    g = t.gauge('mxnet_tpu_test_temperature')
    g.set(1.5)
    g.set(2.5)
    assert g.value() == 2.5
    h = t.histogram('mxnet_tpu_test_latency_seconds', buckets=(1.0, 10.0))
    for v in (0.5, 5.0, 50.0):
        h.observe(v)
    count, total = h.value()
    assert count == 3 and total == 55.5
    assert t.counter('mxnet_tpu_test_requests_total') is c
    with pytest.raises(telem.MXNetError):
        t.gauge('mxnet_tpu_test_requests_total')


def test_metric_name_validation(telem):
    for bad in ('requests_total', 'mxnet_tpu_CamelCase', 'mxnet_tpu_'):
        with pytest.raises(telem.MXNetError):
            telem.telemetry.counter(bad)


def test_reset_zeroes_values(telem):
    t = telem.telemetry
    t.inc('mxnet_tpu_test_requests_total', 7)
    t.set_gauge('mxnet_tpu_test_temperature', 3.0)
    t.observe('mxnet_tpu_test_latency_seconds', 0.1)
    assert t.report() != ''
    t.reset()
    assert t.value('mxnet_tpu_test_requests_total') is None
    assert t.value('mxnet_tpu_test_latency_seconds') is None
    assert t.report() == ''


def _golden_registry(t):
    t.counter('mxnet_tpu_test_golden_requests_total',
              help='requests').inc(3, route='a')
    t.set_gauge('mxnet_tpu_test_golden_temperature', 1.5)
    h = t.histogram('mxnet_tpu_test_golden_latency_seconds',
                    buckets=(1.0, 10.0))
    for v in (0.5, 5.0, 50.0):
        h.observe(v)


def test_prometheus_golden(telem):
    _golden_registry(telem.telemetry)
    expected = (
        '# TYPE mxnet_tpu_test_golden_latency_seconds histogram\n'
        'mxnet_tpu_test_golden_latency_seconds_bucket{le="1.0"} 1\n'
        'mxnet_tpu_test_golden_latency_seconds_bucket{le="10.0"} 2\n'
        'mxnet_tpu_test_golden_latency_seconds_bucket{le="+Inf"} 3\n'
        'mxnet_tpu_test_golden_latency_seconds_sum 55.5\n'
        'mxnet_tpu_test_golden_latency_seconds_count 3\n'
        '# HELP mxnet_tpu_test_golden_requests_total requests\n'
        '# TYPE mxnet_tpu_test_golden_requests_total counter\n'
        'mxnet_tpu_test_golden_requests_total{route="a"} 3\n'
        '# TYPE mxnet_tpu_test_golden_temperature gauge\n'
        'mxnet_tpu_test_golden_temperature 1.5\n'
    )
    assert telem.telemetry.prometheus() == expected


def test_json_dump_golden(telem, tmp_path):
    t = telem.telemetry
    t.counter('mxnet_tpu_test_golden_requests_total',
              help='requests').inc(3, route='a')
    t.histogram('mxnet_tpu_test_golden_latency_seconds',
                buckets=(1.0, 10.0)).observe(0.5)
    doc = json.load(open(t.dump(str(tmp_path / 'telemetry.json'))))
    assert doc['mxnet_tpu_test_golden_requests_total'] == {
        'type': 'counter', 'help': 'requests',
        'series': [{'labels': {'route': 'a'}, 'value': 3}]}
    (series,) = doc['mxnet_tpu_test_golden_latency_seconds']['series']
    assert series['count'] == 1 and series['sum'] == 0.5
    assert series['buckets'] == {'1.0': 1, '10.0': 0, '+Inf': 0}


def test_exports_identical_across_packages():
    """The same recordings give byte-identical Prometheus text and report
    lines in both packages."""
    out = []
    for name in PKGS:
        P = _ns(name)
        _clean(P)
        P.telemetry.enable()
        _golden_registry(P.telemetry)
        P.telemetry.record_compile('cachedop:net', 'sig', 0.25)
        P.telemetry.record_cache_hit('cachedop:net')
        out.append((P.telemetry.prometheus(), P.telemetry.report()))
        _clean(P)
    assert out[0] == out[1]


def test_prometheus_label_escaping(telem):
    telem.telemetry.inc('mxnet_tpu_test_escapes_total',
                        key='he said "hi"\nback\\slash')
    out = telem.telemetry.prometheus()
    assert (r'mxnet_tpu_test_escapes_total'
            r'{key="he said \"hi\"\nback\\slash"} 1') in out
    assert all(line.count('"') % 2 == 0 or line.startswith('#')
               for line in out.splitlines())


def test_set_step_flops_clear_semantics(telem):
    t = telem.telemetry
    t.set_step_flops(1e9, peak_flops=1e12)
    t.set_step_flops(2e9)
    t.record_step(0.01, 1)
    assert t.value('mxnet_tpu_mfu_percent') == pytest.approx(20.0)
    t.set_step_flops(2e9, peak_flops=None)
    t.set_gauge('mxnet_tpu_mfu_percent', -1.0)
    t.record_step(0.01, 1)
    assert t.value('mxnet_tpu_mfu_percent') == -1.0


def test_chrome_counter_events(telem):
    """The 'C' counter rows the JAX profiler merges (the port has no
    profiler yet; the rows are the same)."""
    t = telem.telemetry
    t.inc('mxnet_tpu_test_requests_total', 5)
    t.set_gauge('mxnet_tpu_test_temperature', 2.0)
    t.observe('mxnet_tpu_test_latency_seconds', 0.1)
    evs = t.chrome_events()
    assert all(e['ph'] == 'C' and e['cat'] == 'telemetry' for e in evs)
    assert {e['name'] for e in evs} == {'mxnet_tpu_test_requests_total',
                                        'mxnet_tpu_test_temperature'}


def test_recompile_detector_warns_exactly_once(telem):
    """Six distinct signatures at one site with threshold 2: one warning,
    six compiles; then a cache hit adds none."""
    t = telem.telemetry
    t.set_recompile_threshold(2)
    site = 'cachedop:dense0'
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter('always')
        for i in range(1, 7):
            t.record_compile(site, f'(({i}, 4), float32)', 0.01)
    rec = [x for x in w if issubclass(x.category, t.RecompileWarning)]
    assert len(rec) == 1
    assert site in str(rec[0].message) and 'float32' in str(rec[0].message)
    assert t.value('mxnet_tpu_compile_total', site=site) == 6
    assert t.value('mxnet_tpu_recompile_warnings_total', site=site) == 1
    t.record_cache_hit(site)
    assert t.value('mxnet_tpu_compile_total', site=site) == 6
    assert t.value('mxnet_tpu_compile_cache_hits_total', site=site) == 1


def test_compile_seconds_counter(telem):
    telem.telemetry.record_compile('cachedop:dense0', 'sig', 0.125)
    assert telem.telemetry.value('mxnet_tpu_compile_seconds_total',
                                 site='cachedop:dense0') == 0.125


def test_record_step_and_mfu_gauge(telem):
    t = telem.telemetry
    t.set_step_flops(1e9, peak_flops=1e12)
    t.record_step(0.01, 32)
    count, total = t.value('mxnet_tpu_step_time_seconds')
    assert count == 1 and total == pytest.approx(0.01)
    assert t.value('mxnet_tpu_samples_per_second') == pytest.approx(3200.0)
    assert t.value('mxnet_tpu_mfu_percent') == pytest.approx(10.0)


def test_recent_samples_per_second_ignores_stale_gauge(telem):
    """What the JAX Speedometer reads: a gauge with no recent step is
    not a current rate."""
    t = telem.telemetry
    t.set_gauge('mxnet_tpu_samples_per_second', 99999.0)
    assert t.recent_samples_per_second(60.0) is None
    t.record_step(0.1, 123.45)
    assert t.recent_samples_per_second(60.0) == pytest.approx(1234.5)
    assert t.recent_samples_per_second(-1.0) is None


def _dense_trainer(P):
    """A Dense(1) on 3 inputs and an SGD Trainer at lr 0, in package P,
    on the CPU."""
    mx = P.pkg
    with mx.cpu():
        net = mx.gluon.nn.Dense(1, in_units=3, prefix='trainer_dense_')
        net.initialize()
        trainer = mx.gluon.Trainer(net.collect_params(), 'sgd',
                                   {'learning_rate': 0.0}, kvstore=None)
        x = mx.nd.array(onp.ones((2, 3), onp.float32))

    def one_step():
        with mx.cpu():
            with mx.autograd.record():
                loss = net(x).sum()
            loss.backward()
            trainer.step(2)
    return trainer, one_step


def test_trainer_step_pause_guard(telem):
    t = telem.telemetry
    trainer, one_step = _dense_trainer(telem)
    one_step()
    assert t.value('mxnet_tpu_step_time_seconds') is None
    trainer._telem_step_ema = 0.1
    trainer._telem_last_step = time.perf_counter() - 10.0
    one_step()
    assert t.value('mxnet_tpu_step_time_seconds') is None
    trainer._telem_last_step = time.perf_counter() - 0.005
    one_step()
    count, total = t.value('mxnet_tpu_step_time_seconds')
    assert count == 1 and total < 2.0
    trainer.reset_step_timer()
    assert trainer._telem_last_step is None


def test_training_loop_populates_step_metrics(telem):
    """4 Trainer steps: 3 intervals, the first only seeds the filter."""
    t = telem.telemetry
    _trainer, one_step = _dense_trainer(telem)
    for _ in range(4):
        one_step()
    step_count, _ = t.value('mxnet_tpu_step_time_seconds')
    assert step_count == 2
    assert t.value('mxnet_tpu_samples_per_second') > 0
    assert 'mxnet_tpu_step_time_seconds' in t.report()


def test_disabled_leaves_zero_counters(P):
    _trainer, one_step = _dense_trainer(P)
    one_step()
    one_step()
    assert P.telemetry.value('mxnet_tpu_step_time_seconds') is None
    assert P.telemetry.report() == ''
    assert P.telemetry.prometheus() == ''
    assert not P.telemetry.enabled()


def test_env_gates_declared(P):
    for var in ('MXNET_TPU_TELEMETRY', 'MXNET_TPU_RECOMPILE_WARN_THRESHOLD',
                'MXTPU_TRACE', 'MXTPU_TRACE_RING', 'MXTPU_FLIGHT_STEPS',
                'MXTPU_FLIGHT_DIR', 'MXTPU_FLIGHT_PATH', 'MXTPU_MEMORY',
                'MXTPU_MEMORY_RING', 'MXTPU_MEMORY_EVERY',
                'MXTPU_MEMORY_LEAK_STEPS', 'MXTPU_MEMORY_LEAK_BYTES',
                'MXTPU_COMPILE_LEDGER', 'MXTPU_COMPILE_CACHE_DIR'):
        assert var in P.config.list_vars()
    assert P.config.get('MXNET_TPU_RECOMPILE_WARN_THRESHOLD') >= 1


def test_knob_defaults_match_the_reference():
    j, t = _ns('mxnet_tpu').config, _ns('mxnet_tpu_torch').config
    for var in ('MXNET_TPU_TELEMETRY', 'MXNET_TPU_RECOMPILE_WARN_THRESHOLD',
                'MXTPU_TRACE', 'MXTPU_TRACE_RING', 'MXTPU_FLIGHT_STEPS',
                'MXTPU_MEMORY', 'MXTPU_MEMORY_RING', 'MXTPU_MEMORY_EVERY',
                'MXTPU_MEMORY_LEAK_STEPS', 'MXTPU_MEMORY_LEAK_BYTES',
                'MXTPU_COMPILE_LEDGER', 'MXTPU_SERVE_WATCHDOG_SECONDS'):
        assert t.get(var) == j.get(var), var


def test_metric_names_lint_and_match_the_reference():
    """tools/check_telemetry_names.py's scanner over the port: every name
    it records is namespaced lowercase_snake under one kind, and is a
    name the JAX package records too (one dashboard reads both)."""
    import check_telemetry_names as lint
    root = os.path.join(os.path.dirname(__file__), os.pardir)
    port, errs = lint.scan(os.path.join(root, 'mxnet_tpu_torch'))
    # subsystems the port does not instrument yet (io, kvstore, ...) are
    # declared by the shared contract and never recorded here
    assert [e for e in errs if 'never recorded' not in e[3]] == []
    ref, _ = lint.scan(os.path.join(root, 'mxnet_tpu'))
    assert len(port) >= 30
    assert set(port) - set(ref) == set()
    for name, kinds in port.items():
        assert kinds == ref[name], name


# ---------------------------------------------------------------------------
# span tracing (tests/test_trace.py)
# ---------------------------------------------------------------------------

def test_nested_spans_export_balanced_chrome_events(P):
    P.trace.enable()
    with P.trace.span('io.batch'):
        with P.trace.span('io.decode', records=8):
            pass
        with P.trace.span('h2d.device_put'):
            pass
    evs = P.trace.chrome_events(metadata=True)
    assert check_trace.check_events(evs) == []
    bs = [e for e in evs if e['ph'] == 'B']
    assert [e['name'] for e in bs] == ['io.batch', 'io.decode',
                                       'h2d.device_put']
    assert bs[1]['args'] == {'records': 8}
    assert all(e['pid'] == os.getpid() for e in bs)
    assert len({e['tid'] for e in bs}) == 1
    meta = [e for e in evs if e['ph'] == 'M']
    assert any(m['args']['name'] == 'MainThread' for m in meta)


def test_instant_and_complete_events(P):
    P.trace.enable()
    P.trace.instant('comm.all_gather', bytes=4096, count=2)
    P.trace.complete('xprof.matmul', ts_us=10.0, dur_us=5.0)
    evs = P.trace.chrome_events()
    assert check_trace.check_events(evs) == []
    assert {e['name']: e['ph'] for e in evs} == {'comm.all_gather': 'i',
                                                 'xprof.matmul': 'X'}


def test_dump_is_loadable_standalone_trace(P, tmp_path):
    P.trace.enable()
    with P.trace.span('step.dispatch'):
        pass
    path = P.trace.dump(str(tmp_path / 'trace.json'))
    assert check_trace.check_file(path) == []
    assert isinstance(json.loads(open(path).read())['traceEvents'], list)


def _grown_bytes(fn):
    fn(64)
    tracemalloc.start()
    before = tracemalloc.take_snapshot()
    fn(2000)
    after = tracemalloc.take_snapshot()
    tracemalloc.stop()
    return sum(d.size_diff for d in after.compare_to(before, 'filename')
               if d.size_diff > 0)


def test_disarmed_span_is_shared_noop_without_allocation(P):
    assert not P.trace.enabled()
    assert P.trace.span('hot.path') is P.trace.span('other.name')

    def hot_loop(n):
        for _ in range(n):
            with P.trace.span('hot.path'):
                pass
    grown = _grown_bytes(hot_loop)
    assert grown < 4096, f"disarmed span path leaked {grown} bytes"
    assert P.trace.stats() == {'spans_total': 0, 'dropped_spans_total': 0,
                               'ring_depth': 0, 'threads': 0}
    assert P.trace.chrome_events() == []


def test_disarmed_flight_recorder_is_noop(P, tmp_path):
    P.flight.record_step(1, loss=3.0)
    P.flight.note('fault', site='io.decode')
    assert P.flight.get().steps() == []
    assert P.flight.dump(path=str(tmp_path / 'f.json')) is None
    assert not (tmp_path / 'f.json').exists()


def test_ring_overwrite_drops_spans_but_export_stays_balanced(P):
    P.trace.set_ring_capacity(16)
    P.trace.clear()
    P.trace.enable()
    for i in range(100):
        with P.trace.span('step.dispatch', step=i):
            pass
    st = P.trace.stats()
    assert st['spans_total'] == 100
    assert st['dropped_spans_total'] > 0
    assert st['ring_depth'] <= 16
    evs = P.trace.chrome_events()
    assert check_trace.check_events(evs) == []
    steps = [e['args']['step'] for e in evs if e['ph'] == 'B' and 'args' in e]
    assert steps and min(steps) > 80


def test_open_span_flushes_with_synthetic_close(P):
    P.trace.enable()
    span = P.trace.span('step.compiled')
    span.__enter__()
    evs = P.trace.chrome_events(flush_open=True)
    assert check_trace.check_events(evs) == []
    closes = [e for e in evs if e['ph'] == 'E'
              and e.get('args', {}).get('flushed')]
    assert len(closes) == 1 and closes[0]['name'] == 'step.compiled'
    assert P.trace.open_spans()[0]['name'] == 'step.compiled'
    span.__exit__(None, None, None)


def test_threads_interleave_into_one_balanced_stream(P):
    """Spans from worker threads and the main thread merge into one
    balanced, deterministic stream with a thread_name row per thread
    (the JAX case drives DataLoader workers and the checkpoint writer;
    here plain threads do the same spans)."""
    P.trace.enable()
    barrier = threading.Barrier(3)     # all alive at once: no ident reuse

    def work(k):
        barrier.wait(timeout=10)
        for i in range(20):
            with P.trace.span('io.worker_fetch', worker=k):
                with P.trace.span('io.decode'):
                    pass
    ts = [threading.Thread(target=work, args=(k,)) for k in range(3)]
    for t in ts:
        t.start()
    with P.trace.span('checkpoint.write'):
        for t in ts:
            t.join()
    evs = P.trace.chrome_events(metadata=True)
    assert check_trace.check_events(evs) == []
    by_thread = {}
    for e in evs:
        if e['ph'] in ('B', 'E'):
            by_thread.setdefault(e['tid'], []).append(e)
    assert len(by_thread) == 4
    for tevs in by_thread.values():
        assert check_trace.check_events(tevs) == []
    assert evs == P.trace.chrome_events(metadata=True)
    assert set(by_thread) <= {e['tid'] for e in evs if e['ph'] == 'M'}


def test_tids_are_small_sequential_and_stable(P):
    P.trace.enable()
    seen = {}
    barrier = threading.Barrier(4)

    def work(k):
        barrier.wait(timeout=10)
        with P.trace.span('t.span'):
            seen[k] = P.trace.tid_for_current_thread()
        barrier.wait(timeout=10)
    ts = [threading.Thread(target=work, args=(i,)) for i in range(4)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    with P.trace.span('t.span'):
        main_tid = P.trace.tid_for_current_thread()
    tids = set(seen.values()) | {main_tid}
    assert len(tids) == 5
    assert all(isinstance(t, int) and 0 < t < 10000 for t in tids)
    assert main_tid == P.trace.tid_for_current_thread()


def test_trace_metrics_contract(P, tmp_path):
    P.telemetry.enable()
    P.trace.set_ring_capacity(16)
    P.trace.clear()
    P.trace.enable()
    for _ in range(40):
        with P.trace.span('step.dispatch'):
            pass
    P.flight.record_step(1)
    P.flight.record_step(2)
    assert P.flight.dump(path=str(tmp_path / 'f.json')) is not None
    P.trace.chrome_events()
    t = P.telemetry
    assert t.value('mxnet_tpu_trace_spans_total') == 40
    assert t.value('mxnet_tpu_trace_dropped_spans_total') > 0
    assert t.value('mxnet_tpu_trace_ring_depth') <= 16
    assert t.value('mxnet_tpu_trace_flight_dumps_total') == 1
    P.trace.chrome_events()
    assert t.value('mxnet_tpu_trace_spans_total') == 40


def test_balance_events_repairs_crash_streams(P):
    raw = [{'name': 'outer', 'ph': 'B', 'ts': 1.0, 'pid': 1, 'tid': 1},
           {'name': 'gone', 'ph': 'E', 'ts': 1.5, 'pid': 1, 'tid': 2},
           {'name': 'inner', 'ph': 'B', 'ts': 2.0, 'pid': 1, 'tid': 1}]
    fixed = P.trace.balance_events(raw, close_ts=9.0)
    assert check_trace.check_events(fixed) == []
    closes = [e for e in fixed if e['ph'] == 'E']
    assert [e['name'] for e in closes] == ['inner', 'outer']
    assert all(e['ts'] == 9.0 and e['args']['flushed'] for e in closes)


def test_check_trace_cli_on_real_dump(P, tmp_path):
    P.trace.enable()
    with P.trace.span('io.batch'):
        pass
    path = P.trace.dump(str(tmp_path / 't.json'))
    tool = os.path.join(os.path.dirname(__file__), os.pardir, 'tools',
                        'check_trace.py')
    res = subprocess.run([sys.executable, tool, path], capture_output=True,
                         text=True)
    assert res.returncode == 0, res.stderr
    assert 'OK' in res.stdout


# ---------------------------------------------------------------------------
# flight recorder
# ---------------------------------------------------------------------------

def test_flight_records_spans_and_losses(P):
    """The JAX recorder reads step N's loss when step N+1 is recorded;
    the port's reads it when a reader asks (steps()), so its newest loss
    is already there. The rest of the record is the same."""
    P.trace.enable()
    with P.trace.span('step.dispatch'):
        pass
    P.flight.record_step(1, loss=onp.float32(2.5))
    with P.trace.span('step.dispatch'):
        pass
    P.flight.record_step(2, loss=onp.float32(1.5))
    steps = P.flight.get().steps()
    assert [r['step'] for r in steps] == [1, 2]
    assert steps[0]['loss'] == 2.5
    assert steps[1]['loss'] == (1.5 if P.port else None)
    assert 'step.dispatch' in steps[0]['spans_ms']
    assert steps[1]['interval_ms'] >= 0
    P.flight.annotate_last(guard_ok=False)
    assert P.flight.get().steps()[-1]['guard_ok'] is False


class _DeviceLoss:
    """A loss on a device: reading it (float) is a host sync, counted."""

    device = types.SimpleNamespace(type='cuda')

    def __init__(self, value):
        self.value = value
        self.reads = 0

    def __float__(self):
        self.reads += 1
        return self.value


def test_port_flight_never_reads_a_loss_while_recording():
    P = _ns('mxnet_tpu_torch')
    _clean(P)
    P.trace.enable()
    try:
        losses = [_DeviceLoss(v) for v in (3.0, 2.0, 1.0)]
        for i, loss in enumerate(losses):
            P.flight.record_step(i, loss=loss)
        assert [l.reads for l in losses] == [0, 0, 0]
        # a crash-time dump does not read a device loss either
        doc = P.flight.get().snapshot(resolve_loss=False)
        assert [r['loss'] for r in doc['steps']] == [None, None, None]
        assert [l.reads for l in losses] == [0, 0, 0]
        assert [r['loss'] for r in P.flight.get().steps()] == [3.0, 2.0,
                                                              1.0]
        assert P.flight.get().last_step_record()['loss'] == 1.0
        # a CPU tensor is read on the spot
        P.flight.record_step(9, loss=torch.tensor(0.5))
        doc = P.flight.get().snapshot(resolve_loss=False)
        assert doc['steps'][-1]['loss'] == 0.5
    finally:
        _clean(P)


def test_flight_dump_survives_a_held_lock(P):
    P.trace.enable()
    rec = P.flight.get()
    rec.record_step(1)
    rec._lock.acquire()
    try:
        t0 = time.monotonic()
        with rec._locked_for_dump(timeout=0.2):
            steps = [dict(r) for r in rec._steps]
        assert time.monotonic() - t0 < 2.0
        assert steps and steps[0]['step'] == 1
    finally:
        rec._lock.release()


def test_flight_ring_is_bounded(P):
    P.trace.enable()
    rec = P.flight.FlightRecorder(capacity=4)
    for i in range(10):
        rec.record_step(i)
    steps = rec.steps()
    assert len(steps) == 4 and steps[0]['step'] == 6


def test_flight_dump_document_shape(P, tmp_path, monkeypatch):
    monkeypatch.setenv('MXTPU_FLIGHT_PATH', str(tmp_path / 'black_box.json'))
    P.trace.enable()
    with P.trace.span('io.batch'):
        pass
    P.flight.record_step(7, guard_ok=True)
    P.flight.note('fault', site='io.decode', fault_kind='corrupt')
    path = P.flight.dump(reason='unit')
    assert path == str(tmp_path / 'black_box.json')
    doc = json.loads(open(path).read())
    assert doc['reason'] == 'unit'
    assert doc['steps'][0]['step'] == 7
    assert doc['events'][0]['kind'] == 'fault'
    assert doc['trace_stats']['spans_total'] == 1
    assert doc['compile_in_flight'] is None
    assert check_trace.check_doc(doc) == []


def test_install_crash_hooks_keeps_the_signals(P):
    """Both recorders chain SIGTERM and SIGABRT (the module default)."""
    import inspect
    import signal
    sig = inspect.signature(P.flight.install_crash_hooks)
    assert set(sig.parameters['signals'].default) == {signal.SIGTERM,
                                                      signal.SIGABRT}


# ---------------------------------------------------------------------------
# memory (tests/test_memory.py)
# ---------------------------------------------------------------------------

def test_watermark_ring_is_bounded(P):
    P.memory.clear(ring=8)
    P.memory.enable()
    for i in range(40):
        P.memory.sample(step=i)
    wm = P.memory.watermarks()
    assert len(wm) == 8
    assert [r['step'] for r in wm] == list(range(32, 40))
    assert P.memory.peak_bytes() == max(r['device_bytes'] for r in wm)


def test_disarmed_step_hook_allocates_nothing(P):
    P.memory.disable()

    def hot_loop(n):
        for i in range(n):
            P.memory.on_step(i)
            P.memory.step_fields()
    grown = _grown_bytes(hot_loop)
    assert grown < 4096, f"disarmed memory path leaked {grown} bytes"
    assert P.memory.watermarks() == []


def test_sampling_cadence_every_n_steps(P):
    P.memory.clear(every=3)
    P.memory.enable()
    for i in range(9):
        P.memory.on_step(i)
    assert len(P.memory.watermarks()) == 3


def test_flight_record_gains_watermark_fields(P):
    P.trace.enable()
    P.memory.enable()
    P.memory.sample(step=1)
    P.flight.get().clear()
    P.flight.record_step(1)
    rec = P.flight.get().last_step_record()
    assert rec['mem']['device_bytes'] >= 0
    assert rec['mem']['source'] in ('fallback', 'memory_stats')
    assert set(rec['mem']) == {'device_bytes', 'peak_bytes',
                               'host_rss_bytes', 'source'}
    P.memory.disable()
    P.flight.record_step(2)
    assert 'mem' not in P.flight.get().last_step_record()


def test_fallback_is_the_pool_sum_on_cpu(P):
    """No allocator stats on the CPU: the watermark is the tracked pools'
    byte sum, a tensor counted by its nbytes."""
    P.memory.enable()
    arr = onp.zeros((16, 8), onp.float32)
    t = torch.zeros(4, 4, dtype=torch.bfloat16)
    P.memory.register_pool('params', lambda: {'w': arr, 't': t, 'n': 100})
    rec = P.memory.sample(step=0)
    want = arr.nbytes + (t.nbytes if P.port else 0) + 100
    if P.port:
        assert rec['source'] == 'fallback'
        assert rec['device_bytes'] == want
        assert P.memory.live_bytes() == (want, {'params': want})


def test_memory_stats_source_wins_when_backend_exposes_it(P, monkeypatch):
    P.memory.enable()
    P.memory.register_pool('params', lambda: {'w': 4096})
    fake = {'bytes_in_use': 123456789, 'peak_bytes_in_use': 223456789,
            'bytes_limit': 16 * 2 ** 30}
    monkeypatch.setattr(P.memory, 'device_memory_stats',
                        lambda device=None: dict(fake))
    rec = P.memory.sample(step=99)
    assert rec['source'] == 'memory_stats'
    assert rec['device_bytes'] == fake['bytes_in_use']
    assert rec['fallback_bytes'] == 4096
    assert P.memory.peak_bytes() == fake['peak_bytes_in_use']


def test_port_device_memory_stats_without_a_card():
    """No card (or CUDA never used): None, and no CUDA context made."""
    P = _ns('mxnet_tpu_torch')
    assert P.memory.device_memory_stats() is None
    assert not torch.cuda.is_initialized()


def test_gauges_exported_when_telemetry_armed(P):
    P.telemetry.enable()
    P.memory.enable()
    P.memory.register_pool('params', lambda: {'w': 1000, 'b': 24})
    P.memory.sample(step=1)
    assert P.telemetry.value('mxnet_tpu_memory_device_bytes',
                             source='fallback') == 1024
    assert P.telemetry.value('mxnet_tpu_memory_pool_bytes',
                             pool='params') == 1024
    assert P.telemetry.value('mxnet_tpu_memory_samples_total') == 1
    assert P.telemetry.value('mxnet_tpu_memory_host_rss_bytes') > 0


def test_dead_owner_pools_retire(P):
    class Owner:
        def memory_pools(self):
            return {'params': {'w': 2048}}
    P.memory.enable()
    owner = Owner()
    P.memory.register_provider(owner)
    P.memory.register_pool('extra', lambda: {'x': 16}, owner=owner)
    assert P.memory.tracked_bytes()[0] if P.port else True
    assert P.memory.live_bytes()[0] == 2064
    del owner
    import gc
    gc.collect()
    assert P.memory.live_bytes()[0] == 0


def test_leak_detector_latches_and_clears(P):
    P.memory.clear(leak_steps=3, leak_bytes=1000)
    P.memory.enable()
    P.trace.enable()
    size = [0]
    P.memory.register_pool('grower', lambda: {'x': size[0]})

    def grow(vals):
        for i, v in enumerate(vals):
            size[0] = v
            P.memory.sample(step=i)

    def notes():
        return [e for e in P.flight.get().events()
                if e['kind'] == 'memory.leak_suspected']
    grow([1000, 2000, 3000, 4000])
    assert P.memory.leak_state()['latched']
    assert len(notes()) == 1 and notes()[0]['growth_bytes'] >= 3000
    grow([5000])
    assert P.memory.leak_state()['latched'] and len(notes()) == 1
    grow([5000])
    assert not P.memory.leak_state()['latched']
    grow([6000, 7000, 8000, 9000])
    assert P.memory.leak_state()['latched'] and len(notes()) == 2


def test_leak_detector_ignores_noise_below_threshold(P):
    P.memory.clear(leak_steps=3, leak_bytes=10 ** 6)
    P.memory.enable()
    size = [0]
    P.memory.register_pool('grower', lambda: {'x': size[0]})
    for i, v in enumerate([100, 200, 300, 400, 500]):
        size[0] = v
        P.memory.sample(step=i)
    assert not P.memory.leak_state()['latched']


def test_oom_guard_ignores_ordinary_errors(P, tmp_path, monkeypatch):
    monkeypatch.setenv('MXTPU_FLIGHT_DIR', str(tmp_path))
    with pytest.raises(ValueError):
        with P.memory.oom_guard('step.dispatch'):
            raise ValueError('not an oom')
    assert not os.path.exists(P.memory.default_oom_path())
    assert not P.memory.is_oom_error(ValueError('shape mismatch'))


def _oom_dump(P, tmp_path, monkeypatch, error):
    monkeypatch.setenv('MXTPU_FLIGHT_DIR', str(tmp_path))
    P.memory.enable()
    P.trace.enable()
    P.memory.register_pool('big', lambda: {'hog': 12345678, 'small': 10})
    P.memory.sample(step=1)
    with pytest.raises(type(error)):
        with P.memory.oom_guard('serving.dispatch'):
            raise error
    with open(P.memory.default_oom_path()) as f:
        doc = json.load(f)
    assert P.memory.validate_oom_dump(doc) == []
    assert doc['site'] == 'serving.dispatch'
    assert doc['top_arrays'][0]['name'] == 'hog'
    assert doc['pools_bytes']['big'] == 12345688
    assert doc['watermarks']
    assert any(e['kind'] == 'memory.oom' for e in P.flight.get().events())
    return doc


def test_oom_guard_dumps_on_resource_exhausted_text(P, tmp_path,
                                                    monkeypatch):
    _oom_dump(P, tmp_path, monkeypatch, RuntimeError(
        'RESOURCE_EXHAUSTED: Out of memory while trying to allocate '
        '17179869184 bytes.'))


def test_port_oom_guard_dumps_on_cuda_out_of_memory(tmp_path, monkeypatch):
    """The port's allocator failure: torch.cuda.OutOfMemoryError, and
    the allocator's text on a plain RuntimeError."""
    P = _ns('mxnet_tpu_torch')
    _clean(P)
    try:
        err = torch.cuda.OutOfMemoryError(
            'CUDA out of memory. Tried to allocate 20.00 GiB')
        assert P.memory.is_oom_error(err)
        assert P.memory.is_oom_error(RuntimeError(
            'CUDA error: out of memory'))
        doc = _oom_dump(P, tmp_path, monkeypatch, err)
        assert doc['error_type'] == 'OutOfMemoryError'
        assert doc['allocator_segments'] == []      # no card here
    finally:
        _clean(P)


class _DeletedArray:
    """A buffer whose every size access raises."""

    @property
    def addressable_shards(self):
        raise RuntimeError('Array has been deleted.')

    @property
    def nbytes(self):
        raise RuntimeError('Array has been deleted.')


def test_oom_dump_survives_deleted_arrays(P, tmp_path, monkeypatch):
    monkeypatch.setenv('MXTPU_FLIGHT_DIR', str(tmp_path))
    P.memory.enable()
    P.memory.register_pool('donated', lambda: {'dead': _DeletedArray(),
                                               'alive': 777})
    assert P.memory.entry_nbytes(_DeletedArray()) == 0
    assert P.memory.live_bytes()[0] == 777
    with pytest.raises(RuntimeError):
        with P.memory.oom_guard('step.dispatch'):
            raise RuntimeError('RESOURCE_EXHAUSTED: Out of memory while '
                               'trying to allocate 1 bytes.')
    with open(P.memory.default_oom_path()) as f:
        doc = json.load(f)
    assert P.memory.validate_oom_dump(doc) == []
    assert doc['pools_bytes']['donated'] == 777
    assert doc['top_arrays'][0]['name'] == 'alive'


def test_validate_oom_dump_rejects_malformed(P):
    assert P.memory.validate_oom_dump('nope')
    good = {k: 0 for k in ('schema', 'pid', 'time', 'site', 'error',
                           'error_type', 'device_bytes', 'source',
                           'peak_bytes', 'host_rss_bytes')}
    good.update(schema=P.memory.OOM_SCHEMA, pools_bytes={}, watermarks=[],
                hints=[], config={},
                top_arrays=[{'pool': 'p', 'name': 'a', 'nbytes': 1},
                            {'pool': 'p', 'name': 'b', 'nbytes': 2}])
    assert any('sorted' in p for p in P.memory.validate_oom_dump(good))
    good['top_arrays'].reverse()
    assert P.memory.validate_oom_dump(good) == []
    bad = dict(good)
    del bad['watermarks']
    assert any('watermarks' in p for p in P.memory.validate_oom_dump(bad))


def test_health_fields_report_memory_pressure(P):
    P.memory.register_pool('p', lambda: {'x': 5150})
    doc = P.memory.health_fields()
    assert doc['tracked_bytes'] == 5150
    assert doc['live_bytes'] >= 5150 or doc['source'] == 'memory_stats'
    assert doc['host_rss_bytes'] > 0
    assert doc['peak_bytes'] >= doc['tracked_bytes'] \
        or doc['source'] == 'memory_stats'


# ---------------------------------------------------------------------------
# compile ledger (tests/test_compile.py)
# ---------------------------------------------------------------------------

def _entry(P, site='t:site', shape=(2, 4), dtype='float32', sharding=None,
           donated=False, flags=None, name='data'):
    ctx = P.compile.begin(site, _span=False)
    P.compile.set_signature(ctx, P.compile.signature(
        [P.compile.arg_sig(name, shape, dtype, sharding, donated)], flags))
    return P.compile.end(ctx)


def test_ledger_ring_bounded(P):
    P.compile.enable()
    P.compile.clear(ring=8, ledger='')
    for i in range(30):
        _entry(P, shape=(i + 1, 4))
    ring = P.compile.ledger()
    assert len(ring) == 8
    assert ring[-1]['nth'] == 30
    assert [e['signature']['args'][0]['shape'][0] for e in ring] == \
        list(range(23, 31))


def test_disarmed_compile_paths_allocate_nothing(P):
    P.compile.disable()
    assert P.compile.begin('t:x', _span=False) is None
    assert P.compile.end(None) is None

    def hot_loop(n):
        for _ in range(n):
            P.compile.step_fields()
            P.compile.in_flight()
            with P.compile.watching('t:x'):
                pass
            if P.port:
                P.compile.report('capture', 0.001, 'capture')
    grown = _grown_bytes(hot_loop)
    assert grown < 4096, f"disarmed compile path leaked {grown} bytes"
    assert P.compile.ledger() == []


def _sig(P, shape=(32, 128), dtype='float32',
         sharding="PartitionSpec('dp',)", donated=False, flags=None,
         nargs=1):
    args = [P.compile.arg_sig('data', shape, dtype, sharding, donated)]
    for i in range(1, nargs):
        args.append(P.compile.arg_sig(f'extra{i}', (4,), 'int32'))
    return P.compile.signature(args, flags if flags is not None
                               else {'zero': 1})


@pytest.mark.parametrize('change,axis,detail', [
    (dict(shape=(32, 131)), 'shape',
     'arg 0 `data`: shape (32, 128)→(32, 131)'),
    (dict(dtype='bfloat16'), 'dtype', 'arg 0 `data`: dtype float32→bfloat16'),
    (dict(sharding='PartitionSpec(None,)'), 'sharding',
     "arg 0 `data`: sharding PartitionSpec('dp',)→PartitionSpec(None,)"),
    (dict(donated=True), 'donation', 'arg 0 `data`: donation False→True'),
    (dict(flags={'zero': 3}), 'flag', 'flag `zero`: 1→3'),
    (dict(nargs=2), 'arity', 'arg count 1→2'),
])
def test_diff_names_the_churning_axis(P, change, axis, detail):
    d = P.compile.diff_signatures(_sig(P), _sig(P, **change))
    assert d[0]['axis'] == axis and d[0]['detail'] == detail
    assert P.compile.diff_signatures(_sig(P), _sig(P)) == []


def test_port_array_sig_reads_tensors():
    """A tensor's row: shape, dtype without the torch. prefix, device in
    the sharding column; a torch dtype given by hand reads the same."""
    comp = _ns('mxnet_tpu_torch').compile
    jcomp = _ns('mxnet_tpu').compile
    t = torch.zeros(8, 512, dtype=torch.int32)
    row = comp.array_sig('in0', t)
    assert row == comp.arg_sig('in0', (8, 512), 'int32', 'cpu')
    assert comp.arg_sig('x', (2,), torch.bfloat16)['dtype'] == 'bfloat16'
    want = jcomp.array_sig('in0', onp.zeros((8, 512), onp.int32))
    assert {k: row[k] for k in ('name', 'shape', 'dtype', 'donated')} == \
        {k: want[k] for k in ('name', 'shape', 'dtype', 'donated')}


def test_recompile_forensics_names_axis_everywhere(P):
    P.telemetry.enable()
    P.telemetry.set_recompile_threshold(2)
    P.trace.enable()
    P.compile.enable()
    P.compile.clear(ledger='')
    site = 't:forensics'
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter('always')
        for i in range(4):
            _entry(P, site=site, shape=(32, 128 + i))
    rec = [x for x in w
           if issubclass(x.category, P.telemetry.RecompileWarning)]
    assert len(rec) == 1
    msg = str(rec[0].message)
    assert site in msg
    assert 'Churning axis: arg 0 `data`: shape (32, 129)→(32, 130).' in msg
    assert P.telemetry.value('mxnet_tpu_compile_churn_axes', site=site,
                             axis='shape') == 3
    notes = [e for e in P.flight.get().events()
             if e['kind'] == 'compile.recompiled']
    assert len(notes) == 3
    assert notes[-1]['site'] == site and notes[-1]['nth'] == 4
    assert notes[-1]['axes'] == ['arg 0 `data`: shape (32, 130)→(32, 131)']
    _entry(P, site=site, shape=(32, 131))
    notes = [e for e in P.flight.get().events()
             if e['kind'] == 'compile.recompiled']
    assert notes[-1]['axes'] == ['identical signature (new program instance)']
    assert P.compile.ledger()[-2]['churn_axes'] == \
        ['arg 0 `data`: shape (32, 130)→(32, 131)']


def test_recompile_warning_relatches_after_quiet_episode(P):
    P.telemetry.enable()
    P.telemetry.set_recompile_threshold(2)
    site = 't:relatch'

    def burst(tag):
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter('always')
            for i in range(4):
                P.metrics.record_compile(site, f'{tag}{i}', 0.01)
        return [x for x in w
                if issubclass(x.category, P.telemetry.RecompileWarning)]
    assert len(burst('a')) == 1
    assert burst('b') == []
    for _ in range(3):
        P.metrics.record_step(0.01, 1)
    assert len(burst('c')) == 1
    assert P.telemetry.value('mxnet_tpu_recompile_warnings_total',
                             site=site) == 2


def test_ledger_append_atomic_survives_kill(P, tmp_path, monkeypatch):
    led = tmp_path / 'ledger.jsonl'
    P.compile.enable()
    P.compile.clear(ledger=str(led))
    _entry(P, shape=(2, 4))
    before = led.read_bytes()
    assert before
    real_replace = os.replace

    def dying_replace(src, dst):
        if str(dst) == str(led):
            os.unlink(src)
            raise OSError('killed mid-replace')
        return real_replace(src, dst)
    monkeypatch.setattr(os, 'replace', dying_replace)
    # the flag is the package's, shared with every later test in the
    # process: restored when the monkeypatch is undone
    monkeypatch.setitem(P.compile._ledger_err, 'warned', False)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter('always')
        _entry(P, shape=(3, 4))
    assert any('ledger append' in str(x.message) for x in w)
    monkeypatch.undo()
    assert led.read_bytes() == before
    _entry(P, shape=(4, 4))
    entries = [json.loads(line) for line in led.read_text().splitlines()
               if line.strip()]
    assert len(entries) == 2
    assert P.compile.validate_ledger(entries) == []


def test_validator_catches_tampering(P):
    P.compile.enable()
    P.compile.clear(ledger='')
    a = _entry(P, shape=(2, 4))
    b = _entry(P, shape=(3, 4))
    assert P.compile.validate_ledger([a, b]) == []
    bad = dict(a, fingerprint='deadbeefdeadbeef')
    assert any('does not match its signature' in p
               for p in P.compile.validate_ledger([bad]))
    swapped = [dict(b, time=a['time'] + 10), dict(a, time=a['time'])]
    assert any('went backwards' in p
               for p in P.compile.validate_ledger(swapped))
    assert any('missing key' in p for p in P.compile.validate_ledger([{
        'schema': P.compile.LEDGER_SCHEMA}]))


def test_port_entry_seconds_are_build_and_capture():
    """The port's phases are build and capture (the JAX ledger's trace,
    lower and backend have no counterpart), and its validator holds
    entries to them."""
    P = _ns('mxnet_tpu_torch')
    _clean(P)
    try:
        P.compile.enable()
        e = _entry(P)
        assert set(e['seconds']) == {'build', 'capture', 'total'}
        assert P.compile.validate_ledger_entry(e) == []
        jax_like = dict(e, seconds={'trace': 0.0, 'lower': 0.0,
                                    'backend': 0.0, 'total': 0.0})
        assert any('seconds.build' in p
                   for p in P.compile.validate_ledger_entry(jax_like))
    finally:
        _clean(P)


def test_step_fields_consume_on_read_and_health(P):
    P.compile.enable()
    P.compile.clear(ledger='')
    assert P.compile.step_fields() is None
    _entry(P, site='t:plane', shape=(2, 4))
    f = P.compile.step_fields()
    assert f['site'] == 't:plane' and f['nth'] == 1
    assert P.compile.step_fields() is None
    h = P.compile.health_fields()
    assert h['enabled'] and h['compiles'] == 1
    assert h['last']['site'] == 't:plane'


def test_port_report_is_a_phase_of_the_open_window():
    """A capture or build reported inside a window is that window's
    phase (and, when the window closes inside another, the outer one's
    too); outside any window it is an entry of its own."""
    P = _ns('mxnet_tpu_torch')
    _clean(P)
    try:
        P.compile.enable()
        P.trace.enable()
        alone = P.compile.report('build', 0.25, 'kernel:dense_gelu.cu',
                                 lambda: P.compile.signature(
                                     flags={'nvcc': '-O3'}))
        assert alone['site'] == 'kernel:dense_gelu.cu'
        assert alone['seconds']['build'] == 0.25
        assert alone['seconds']['total'] >= 0.25
        with P.compile.watching('serving:warmup_b8_s512',
                                lambda: P.compile.signature(
                                    [P.compile.arg_sig('batch', (8, 512),
                                                       'int32')])):
            ctx = P.compile.begin('cachedop:bertmodel0')
            assert P.compile.in_flight()['site'] == 'cachedop:bertmodel0'
            assert P.compile.report('capture', 0.5, 'capture') is None
            assert P.compile.in_flight()['phase'] == 'capture'
            inner = P.compile.end(ctx)
        outer = P.compile.ledger()[-1]
        assert inner['site'] == 'cachedop:bertmodel0'
        assert inner['seconds']['capture'] == 0.5
        assert outer['site'] == 'serving:warmup_b8_s512'
        assert outer['seconds']['capture'] == 0.5
        assert outer['signature']['args'][0]['shape'] == [8, 512]
        assert P.compile.in_flight() is None
        # nothing compiled inside: no entry
        n = len(P.compile.ledger())
        with P.compile.watching('serving:warmup_b1_s64'):
            pass
        assert len(P.compile.ledger()) == n
        evs = P.trace.chrome_events()
        assert check_trace.check_events(evs) == []
        assert {'compile.build', 'compile.capture'} <= {e['name']
                                                        for e in evs}
    finally:
        _clean(P)


def test_port_build_directory_counts_hits_and_misses(tmp_path,
                                                     monkeypatch):
    """The kernel build directory is the persistent cache's counterpart:
    a library found there is a hit, an nvcc run a miss, and the stats
    read its files. MXTPU_COMPILE_CACHE_DIR names it for ops._build."""
    P = _ns('mxnet_tpu_torch')
    _clean(P)
    from mxnet_tpu_torch.ops import _build
    try:
        P.telemetry.enable()
        d = tmp_path / 'kernels'
        monkeypatch.setenv('MXTPU_COMPILE_CACHE_DIR', str(d))
        assert _build.build_dir() == str(d)
        assert _build._target('dense_gelu.cu').startswith(str(d))
        d.mkdir()
        (d / 'dense_gelu-0123.so').write_bytes(b'x' * 100)
        P.compile.cache_event(hit=False)
        P.compile.cache_event(hit=True)
        P.compile.cache_event(hit=True)
        st = P.compile.persistent_cache_stats()
        assert st == {'dir': str(d), 'hits': 2, 'misses': 1, 'bytes': 100,
                      'files': 1}
        assert P.telemetry.value(
            'mxnet_tpu_compile_persistent_cache_hits_total') == 2
        assert P.telemetry.value(
            'mxnet_tpu_compile_persistent_cache_misses_total') == 1
        P.compile.clear(cache_dir=str(tmp_path / 'other'))
        assert _build.build_dir() == str(tmp_path / 'other')
    finally:
        _clean(P)


def test_port_triton_first_launch_is_ledgered_once():
    P = _ns('mxnet_tpu_torch')
    _clean(P)
    from mxnet_tpu_torch.ops import _build
    try:
        P.compile.enable()
        calls = []
        key = ('unit-test', 1024)
        for _ in range(3):
            assert _build.triton_first_launch(
                'unit_kernel', key, lambda: calls.append(1) or 7) == 7
        assert len(calls) == 3
        (e,) = P.compile.ledger()
        assert e['site'] == 'kernel:unit_kernel'
        assert e['signature']['flags'] == {'triton': repr(key)}
    finally:
        _build._triton_seen.discard(('unit_kernel', ('unit-test', 1024)))
        _clean(P)


# ---------------------------------------------------------------------------
# the port's instrumented paths on the CPU, against the JAX package's
# ---------------------------------------------------------------------------

class _FakeGraph:
    """Stands in for a CUDA graph on the CPU: a replay runs the captured
    function again and writes its outputs into the static ones, as a
    replay writes the graph's output buffers."""

    def __init__(self, fn, out):
        self.fn, self.out = fn, out

    def replay(self):
        new = self.fn()
        for o, n in zip(self.out if isinstance(self.out, (list, tuple))
                        else [self.out],
                        new if isinstance(new, (list, tuple)) else [new]):
            o.copy_(n)

    def pool(self):
        return (0, id(self))


def cpu_capture(fn, device, generators=(), warm_up=False):
    """``_capture.capture`` on the CPU: the warm-up run, then the
    "capture" run whose outputs are the static ones; its seconds go to
    the ledger as the real capture's do."""
    from mxnet_tpu_torch.telemetry import compile as comp
    first = fn() if warm_up else None
    t0 = time.perf_counter()
    out = fn()
    comp.report('capture', time.perf_counter() - t0, 'capture')
    return _FakeGraph(fn, out), out, first


@pytest.fixture()
def cpu_graphs(monkeypatch):
    """Hybridized port blocks take their CachedOp path on the CPU, with
    ``cpu_capture`` for the capture."""
    from mxnet_tpu_torch.gluon import block
    monkeypatch.setattr(block, '_capturable', lambda args: any(
        isinstance(a, torch.Tensor) for a in args))
    monkeypatch.setattr(block, 'capture', cpu_capture)
    monkeypatch.setattr(block, 'graph_generators', lambda b, d: [])


def test_cachedop_compiles_land_in_ledger(cpu_graphs):
    """Both packages' CachedOp report through the plane: per-block site,
    seconds, churn on a second shape, the per-site counters fed once per
    build, a cache hit on a repeated shape."""
    got = {}
    for name in PKGS:
        P = _ns(name)
        _clean(P)
        try:
            P.telemetry.enable()
            P.compile.enable()
            mx = P.pkg
            with mx.cpu():
                net = mx.gluon.nn.Dense(3, in_units=5,
                                        prefix='cachedop_dense_')
                net.initialize()
            net.hybridize()
            for shape in ((2, 5), (4, 5), (2, 5)):
                x = onp.ones(shape, onp.float32)
                if P.port:
                    with torch.no_grad():
                        net(torch.from_numpy(x))
                else:
                    net(mx.nd.array(x))
            site = f'cachedop:{net.name}'
            ent = [e for e in P.compile.ledger() if e['site'] == site]
            got[name] = ent
            assert len(ent) == 2
            assert ent[0]['seconds']['total'] > 0
            assert ent[1]['nth'] == 2
            assert any(a.startswith('arg 0 `in0`: shape (2, 5)→(4, 5)')
                       for a in ent[1]['churn_axes'])
            assert P.telemetry.value('mxnet_tpu_compile_total',
                                     site=site) == 2
            assert P.telemetry.value('mxnet_tpu_compile_cache_hits_total',
                                     site=site) >= 1
            assert P.compile.validate_ledger(P.compile.ledger()) == []
        finally:
            _clean(P)
    assert got['mxnet_tpu_torch'][1]['seconds']['capture'] > 0


def test_port_cachedop_counts_compiles_with_the_ledger_disarmed(cpu_graphs):
    P = _ns('mxnet_tpu_torch')
    _clean(P)
    try:
        P.telemetry.enable()
        mx = P.pkg
        with mx.cpu():
            net = mx.gluon.nn.Dense(3, in_units=5, prefix='counted_dense_')
            net.initialize()
        net.hybridize()
        with torch.no_grad():
            for n in (1, 2, 2, 3):
                net(torch.ones(n, 5))
        site = f'cachedop:{net.name}'
        assert P.telemetry.value('mxnet_tpu_compile_total', site=site) == 3
        assert P.telemetry.value('mxnet_tpu_compile_cache_hits_total',
                                 site=site) == 1
        assert P.compile.ledger() == []
        assert net._cached_op.num_graphs == 3
    finally:
        _clean(P)


def test_port_cachedop_key_is_prefix_free():
    """Two blocks of one architecture under different prefixes key
    their calls alike (the JAX package's compiled-program key is
    prefix-free too: tests/test_serving.py)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon.block import CachedOp
    with mx.cpu():
        a = mx.gluon.nn.Dense(16, in_units=8, prefix='densea_')
        b = mx.gluon.nn.Dense(16, in_units=8, prefix='denseb_')
        a.initialize()
        b.initialize()
    assert a.name != b.name
    x = torch.randn(4, 8)
    assert CachedOp(a).key((x,)) == CachedOp(b).key((x,))
    assert CachedOp(a).key((x,)) != CachedOp(a).key((torch.randn(5, 8),))


def test_traced_step_and_trainer_lifecycle_spans():
    """One traced training step in each package (the compiled step, then
    a Trainer step, same net and data) records the lifecycle spans and
    flight records both have: step.dispatch, step.compiled and
    optimizer.*."""
    names = {}
    for name in PKGS:
        P = _ns(name)
        _clean(P)
        try:
            P.trace.enable()
            mx = P.pkg
            cpu = mx.cpu()
            cpu.__enter__()
            net = mx.gluon.nn.Dense(1, in_units=6, prefix='lifecycle_dense_')
            net.initialize()
            rng = onp.random.RandomState(0)
            x = rng.rand(8, 6).astype(onp.float32)
            y = rng.rand(8, 1).astype(onp.float32)
            kw = {}
            if not P.port:
                import jax
                kw['mesh'] = mx.parallel.make_mesh(
                    (1,), ('dp',), devices=jax.devices()[:1])
            step = mx.parallel.ShardedTrainStep(
                net, mx.gluon.loss.L2Loss(), 'adam',
                {'learning_rate': 0.01}, **kw)
            for _ in range(2):
                step(mx.nd.array(x), mx.nd.array(y))
            trainer = mx.gluon.Trainer(net.collect_params(), 'sgd',
                                       {'learning_rate': 0.01})
            with mx.autograd.record():
                loss = net(mx.nd.array(x)).sum()
            loss.backward()
            trainer.step(8)
            evs = P.trace.chrome_events(metadata=True)
            assert check_trace.check_events(evs) == []
            names[name] = {e['name'] for e in evs if e['ph'] == 'B'}
            steps = P.flight.get().steps()
            assert len(steps) == 3, (name, steps)
            # the JAX step records inside its step.dispatch span, so its
            # first record shows that span only at the next step
            assert any('step.dispatch' in r['spans_ms'] for r in steps), \
                (name, steps)
        finally:
            cpu.__exit__(None, None, None)
            _clean(P)
    common = names['mxnet_tpu'] & names['mxnet_tpu_torch']
    assert {'step.dispatch', 'step.compiled', 'optimizer.update'} <= common
    assert 'optimizer.fused' in names['mxnet_tpu_torch']
