"""The port's serving engine on a hybridized BERT against the JAX
package's (mirrors the engine cases of tests/test_serving.py).

One small BERT (2 layers, hidden 64, 4 heads, vocab 100) is initialised
in the JAX package; its weights cross to the port by structured name.
Each case runs once per package (``P``) on the same requests, or runs
both engines and compares what they serve. On the CPU the port's
``hybridize()`` changes nothing; the cases that exercise the capture
path (the compile ledger of warmup, zero captures in a storm, a late
capture on the worker thread) route the port's hybridized blocks
through their CachedOp with ``cpu_capture``, which runs the function
where the card would capture it and reports the capture's seconds to
the ledger as ``_capture.capture`` does. The served outputs are held to
the JAX engine's within rtol 1e-4, atol 1e-5 (tests/test_torch_bert_
serving.py's bound, f32 on the CPU). Nothing binds a socket.
"""
import importlib
import json
import os
import threading
import time
import types
import warnings

import numpy as onp
import pytest
import torch
from test_torch_jax_globals import jax_globals  # noqa: F401


PKGS = ('mxnet_tpu', 'mxnet_tpu_torch')
CFG = dict(vocab_size=100, hidden=64, layers=2, heads=4, intermediate=256,
           max_len=64)
RTOL, ATOL = 1e-4, 1e-5


def _ns(name):
    tel = importlib.import_module(name + '.telemetry')
    return types.SimpleNamespace(
        name=name, pkg=importlib.import_module(name),
        serving=importlib.import_module(name + '.serving'),
        bert=importlib.import_module(name + '.models.bert'),
        telemetry=tel, compile=tel.compile, metrics=tel.metrics,
        memory=tel.memory, trace=tel.trace, flight=tel.flight,
        MXNetError=importlib.import_module(name + '.base').MXNetError,
        port=name == 'mxnet_tpu_torch')


def _clean(P):
    P.metrics.set_recompile_threshold(None)
    P.compile.disable()
    P.compile.clear(ledger='', cache_dir='')
    P.telemetry.reset()
    P.telemetry.disable()
    P.trace.disable()
    P.trace.clear()
    P.flight.get().clear()
    P.memory.disable()
    P.memory.clear(pools=True)


@pytest.fixture(scope='module')
def arrays():
    """The JAX BERT's weights by structured name."""
    import mxnet_tpu as mx
    from mxnet_tpu.models.bert import BertModel
    mx.random.seed(0)
    net = BertModel(**CFG)
    net.initialize(mx.init.Normal(0.02))
    net(mx.nd.array(onp.zeros((1, 8), 'int32')))
    return {k: v.data().asnumpy()
            for k, v in net._collect_params_with_prefix().items()}


def _bert(P, arrays):
    if P.port:
        from mxnet_tpu_torch.weights import params_from_mxnet_tpu
        net = P.bert.BertModel(**CFG, device='cpu')
        net.load_state_dict(params_from_mxnet_tpu(arrays, net))
        return net
    mx = P.pkg
    net = P.bert.BertModel(**CFG)
    net.initialize()
    net(mx.nd.array(onp.zeros((1, 8), 'int32')))
    for k, p in net._collect_params_with_prefix().items():
        p.set_data(mx.nd.array(arrays[k]))
    return net


def _engine(P, arrays, **kw):
    net = _bert(P, arrays)
    kw.setdefault('seq_buckets', '8,16')
    kw.setdefault('batch_buckets', '1,2,4')
    kw.setdefault('deadline_ms', 2.0)
    runner = P.serving.BlockRunner(net, **({'device': 'cpu'} if P.port
                                           else {}))
    return net, P.serving.InferenceEngine(runner, **kw)


@pytest.fixture(params=PKGS)
def P(request):
    ns = _ns(request.param)
    _clean(ns)
    ns.telemetry.enable()
    ns.compile.enable()
    yield ns
    _clean(ns)


class _FakeGraph:
    """A CUDA graph's stand-in on the CPU: a replay runs the captured
    function again into the static outputs."""

    def __init__(self, fn, out):
        self.fn, self.out = fn, out

    def replay(self):
        new = self.fn()
        outs = self.out if isinstance(self.out, (list, tuple)) else [self.out]
        news = new if isinstance(new, (list, tuple)) else [new]
        for o, n in zip(outs, news):
            o.copy_(n)

    def pool(self):
        return (0, id(self))


CAPTURE_THREADS = []


def cpu_capture(fn, device, generators=(), warm_up=False):
    from mxnet_tpu_torch.telemetry import compile as comp
    CAPTURE_THREADS.append(threading.current_thread().name)
    first = fn() if warm_up else None
    t0 = time.perf_counter()
    out = fn()
    comp.report('capture', time.perf_counter() - t0, 'capture')
    return _FakeGraph(fn, out), out, first


@pytest.fixture()
def cpu_graphs(monkeypatch):
    from mxnet_tpu_torch.gluon import block
    monkeypatch.setattr(block, '_capturable', lambda args: any(
        isinstance(a, torch.Tensor) for a in args))
    monkeypatch.setattr(block, 'capture', cpu_capture)
    monkeypatch.setattr(block, 'graph_generators', lambda b, d: [])
    CAPTURE_THREADS.clear()


def _solo(P, net, padded):
    if P.port:
        with torch.inference_mode():
            return net(torch.from_numpy(padded))[0].numpy()
    return net(P.pkg.nd.array(padded))[0].asnumpy()


# ---------------------------------------------------------------------------
# the runner
# ---------------------------------------------------------------------------

def test_blockrunner_hybridizes_the_block(P, arrays):
    net = _bert(P, arrays)
    assert not net._active
    P.serving.BlockRunner(net, **({'device': 'cpu'} if P.port else {}))
    assert net._active
    assert all(layer._active for layer in net.encoder)


def test_port_runner_returns_float32_as_the_pageable_copy(arrays):
    """bf16 comes back as f32, bit for bit ``out.float().cpu().numpy()``
    (the pinned path exists only on the card)."""
    P = _ns('mxnet_tpu_torch')
    net = P.bert.BertModel(**CFG, device='cpu', dtype=torch.bfloat16)
    from mxnet_tpu_torch.weights import params_from_mxnet_tpu
    net.load_state_dict(params_from_mxnet_tpu(arrays, net))
    runner = P.serving.BlockRunner(net, device='cpu')
    assert not runner.pinned
    mat = onp.random.RandomState(0).randint(1, 100, (2, 8)).astype('int32')
    got = runner(mat)
    with torch.inference_mode():
        want = net(torch.from_numpy(mat))[0].float().cpu().numpy()
    assert got.dtype == onp.float32
    assert onp.array_equal(got, want)


def test_port_runner_on_the_card_needs_one(arrays):
    P = _ns('mxnet_tpu_torch')
    net = P.bert.BertModel(**CFG, device='cpu')
    if torch.cuda.is_available():
        pytest.skip('a card is present: the runner would use it')
    with pytest.raises(P.MXNetError, match='CUDA'):
        P.serving.BlockRunner(net)


# ---------------------------------------------------------------------------
# bucketing helpers and batch formation
# ---------------------------------------------------------------------------

def test_parse_buckets_sorts_and_dedupes(P):
    assert P.serving.parse_buckets('128, 32,64,32') == (32, 64, 128)
    for bad in ('', '0,8'):
        with pytest.raises(P.MXNetError):
            P.serving.parse_buckets(bad)


def test_bucket_selection_smallest_fit(P):
    s = P.serving
    assert s.seq_bucket_for(1, (32, 64)) == 32
    assert s.seq_bucket_for(32, (32, 64)) == 32
    assert s.seq_bucket_for(33, (32, 64)) == 64
    assert s.seq_bucket_for(65, (32, 64)) is None
    assert s.batch_bucket_for(3, (1, 2, 4)) == 4
    assert s.batch_bucket_for(4, (1, 2, 4)) == 4


def test_bucket_grid_is_the_full_universe_largest_first(P, arrays):
    _net, eng = _engine(P, arrays)
    try:
        grid = eng.bucket_grid()
        assert len(grid) == 6 and grid[0] == (4, 16)
        assert set(grid) == {(b, s) for s in (8, 16) for b in (1, 2, 4)}
    finally:
        eng.drain()


def test_fill_dispatches_before_deadline(P, arrays):
    _net, eng = _engine(P, arrays, deadline_ms=2000.0, batch_buckets='1,4')
    try:
        P.serving.warmup(eng)
        t0 = time.monotonic()
        handles = [eng.submit_async([1, 2, 3]) for _ in range(4)]
        outs = [eng.result(h, timeout=10.0) for h in handles]
        took = time.monotonic() - t0
        assert all(o.shape == (3, CFG['hidden']) for o in outs)
        assert took < 1.0, took
    finally:
        eng.drain()


def test_deadline_dispatches_a_lone_request(P, arrays):
    _net, eng = _engine(P, arrays, deadline_ms=300.0, batch_buckets='4')
    try:
        P.serving.warmup(eng)
        t0 = time.monotonic()
        out = eng.submit([1, 2, 3], timeout=10.0)
        took = time.monotonic() - t0
        assert out.shape == (3, CFG['hidden'])
        assert took >= 0.25, took
    finally:
        eng.drain()


def test_padding_parity_bit_identical(P, arrays):
    net, eng = _engine(P, arrays)
    try:
        P.serving.warmup(eng)
        seq = [5, 9, 2, 41, 7]
        out = eng.submit(seq, timeout=10.0)
        solo = _solo(P, net, onp.asarray([seq + [0] * 3], 'int32'))[0, :5]
        assert out.shape == (5, CFG['hidden'])
        assert onp.array_equal(out, solo)
    finally:
        eng.drain()


# ---------------------------------------------------------------------------
# warmup and the zero-recompile storm
# ---------------------------------------------------------------------------

def _storm(P, eng, n=40, seed=3):
    rng = onp.random.RandomState(seed)
    lengths = rng.randint(1, 17, n)
    reqs = [list(rng.randint(0, 100, int(k))) for k in lengths]
    errs, outs = [], [None] * n

    def client(i):
        try:
            outs[i] = eng.submit(reqs[i], timeout=60.0)
        except Exception as e:                        # noqa: BLE001
            errs.append(e)
    threads = [threading.Thread(target=client, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errs, errs
    return reqs, outs


@pytest.mark.usefixtures('cpu_graphs')
def test_zero_recompiles_after_warmup_randomized_storm(P, arrays):
    _net, eng = _engine(P, arrays)
    try:
        rep = P.serving.warmup(eng)
        assert rep['compiles'] and rep['compiles'] > 0
        n_led = len(P.compile.ledger())
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter('always')
            reqs, outs = _storm(P, eng)
        for r, o in zip(reqs, outs):
            assert o.shape == (len(r), CFG['hidden'])
        recompiled = [w for w in caught
                      if 'Recompile' in type(w.message).__name__]
        assert not recompiled, [str(w.message) for w in recompiled]
        assert len(P.compile.ledger()) == n_led, \
            f"storm recompiled: {P.compile.ledger()[n_led:]}"
        st = eng.stats()
        assert st['requests'] == 40 and st['shed'] == 0
        assert st['p50_ms'] is not None and st['p99_ms'] >= st['p50_ms']
        if P.port:
            sites = [e['site'] for e in P.compile.ledger()]
            assert sorted(s for s in sites if s.startswith('serving:')) == \
                sorted(f'serving:warmup_b{b}_s{s}'
                       for b, s in eng.bucket_grid())
            assert sites.count(f'cachedop:{eng.runner.block.name}') == 6
            assert rep['compiles'] == 12
            assert eng.runner.block._cached_op.num_graphs == 6
            assert set(CAPTURE_THREADS) == {'MainThread'}
            assert P.compile.validate_ledger(P.compile.ledger()) == []
    finally:
        eng.drain()


def test_warmup_report_and_threshold_restore(P, arrays):
    _net, eng = _engine(P, arrays)
    try:
        P.metrics.set_recompile_threshold(5)
        rep = P.serving.warmup(eng)
        assert P.metrics._recompile_threshold == 5
        assert set(rep['buckets']) == {f'b{b}_s{s}'
                                       for b, s in eng.bucket_grid()}
        assert rep['total_seconds'] > 0
        assert 'cache' in rep
        assert P.telemetry.value('mxnet_tpu_serving_warmup_buckets',
                                 engine=eng.name) == 6
        assert P.telemetry.value('mxnet_tpu_serving_warmup_seconds',
                                 engine=eng.name) > 0
    finally:
        eng.drain()


@pytest.mark.usefixtures('cpu_graphs')
def test_port_late_bucket_captures_on_the_worker(arrays):
    """A bucket warmup never saw is captured on the engine's worker
    thread (client threads never touch the device), once; the next
    request of that shape replays it."""
    P = _ns('mxnet_tpu_torch')
    _clean(P)
    P.compile.enable()
    _net, eng = _engine(P, arrays)
    try:
        out1 = eng.submit([4, 5, 6], timeout=10.0)
        out2 = eng.submit([4, 5, 6], timeout=10.0)
        assert onp.array_equal(out1, out2)
        assert CAPTURE_THREADS == [f'mxtt-serve-batcher-{eng.name}']
        (e,) = P.compile.ledger()
        assert e['site'] == f'cachedop:{eng.runner.block.name}'
        assert e['signature']['args'][0]['shape'] == [1, 8]
    finally:
        eng.drain()
        _clean(P)


# ---------------------------------------------------------------------------
# shedding: OOM, admission, queue limit, oversized
# ---------------------------------------------------------------------------

def test_oom_sheds_batch_and_replica_survives(P, arrays, tmp_path,
                                              monkeypatch):
    """The JAX case injects alloc.oom through its fault registry; the
    port's allocator failure is a torch.cuda.OutOfMemoryError raised in
    the block's forward. Either way the guard dumps, the batch sheds and
    the next request is served."""
    monkeypatch.setenv('MXTPU_FLIGHT_DIR', str(tmp_path))
    P.memory.enable()
    P.trace.enable()
    net, eng = _engine(P, arrays)
    try:
        P.serving.warmup(eng)
        if P.port:
            real = type(net).forward
            fired = []

            def forward(self, *a, **k):
                if not fired:
                    fired.append(1)
                    raise torch.cuda.OutOfMemoryError(
                        'CUDA out of memory. Tried to allocate 2.00 GiB')
                return real(self, *a, **k)
            monkeypatch.setattr(type(net), 'forward', forward)
        else:
            from mxnet_tpu.resilience import faults
            faults.arm('alloc.oom', 'raise', window=1)
        try:
            with pytest.raises(P.serving.RequestShed,
                               match='out of device memory'):
                eng.submit([1, 2, 3], timeout=10.0)
        finally:
            if not P.port:
                faults.disarm()
        out = eng.submit([1, 2, 3], timeout=10.0)
        assert out.shape == (3, CFG['hidden'])
        assert eng.stats()['shed'] == 1
        assert P.telemetry.value('mxnet_tpu_serving_shed_total',
                                 engine=eng.name, reason='oom') == 1
        with open(P.memory.default_oom_path()) as f:
            doc = json.load(f)
        assert P.memory.validate_oom_dump(doc) == []
        assert doc['site'] == 'serving.dispatch'
        kinds = [e['kind'] for e in P.flight.get().events()]
        assert 'memory.oom' in kinds and 'serving.shed' in kinds
    finally:
        eng.drain()


def test_admission_control_sheds_before_the_device(P, arrays):
    P.trace.enable()
    _net, eng = _engine(P, arrays, admission=lambda: 'memory_pressure')
    try:
        with pytest.raises(P.serving.RequestShed, match='memory_pressure'):
            eng.submit([1, 2, 3])
        assert eng.stats()['shed'] == 1
        assert P.telemetry.value('mxnet_tpu_serving_shed_total',
                                 engine=eng.name,
                                 reason='memory_pressure') == 1
        (note,) = [e for e in P.flight.get().events()
                   if e['kind'] == 'serving.shed']
        assert note['reason'] == 'memory_pressure' and note['count'] == 1
    finally:
        eng.drain()


def test_queue_limit_sheds(P, arrays):
    _net, eng = _engine(P, arrays, queue_limit=1, deadline_ms=5000.0,
                        batch_buckets='4')
    eng.submit_async([1, 2, 3])
    assert P.telemetry.value('mxnet_tpu_serving_queue_depth',
                             engine=eng.name) == 1
    with pytest.raises(P.serving.RequestShed, match='queue full'):
        eng.submit_async([4, 5])
    assert P.telemetry.value('mxnet_tpu_serving_shed_total',
                             engine=eng.name, reason='queue_full') == 1
    assert eng.drain() == 1
    with pytest.raises(P.serving.RequestShed, match='draining'):
        eng.submit([1, 2])
    assert P.telemetry.value('mxnet_tpu_serving_shed_total',
                             engine=eng.name, reason='draining') == 1


def test_too_long_request_is_a_client_error(P, arrays):
    _net, eng = _engine(P, arrays)
    try:
        with pytest.raises(P.serving.RequestTooLarge):
            eng.submit(list(range(17)))
    finally:
        eng.drain()


def _watchdog_of(P, eng):
    return eng.watchdog if P.port else eng._watchdog


def _zeros_runner(stall_on=None, stall_s=0.0):
    calls = []

    def runner(mat):
        calls.append(mat.shape)
        if len(calls) == stall_on:
            time.sleep(stall_s)
        return onp.zeros(mat.shape + (2,), 'float32')
    return runner


def test_watchdog_reports_one_stall_for_a_stalled_dispatch(P):
    """A dispatch that completes no batch for longer than the deadline
    gets exactly one stall report, in both packages (one per stall: the
    watchdog re-arms at the next completed batch)."""
    eng = P.serving.InferenceEngine(
        _zeros_runner(stall_on=2, stall_s=1.5), seq_buckets='8',
        batch_buckets='1', deadline_ms=1.0, watchdog_seconds=0.5)
    try:
        for seq in ([1, 2, 3], [4, 5], [6]):
            eng.submit(seq, timeout=10.0)
        wd = _watchdog_of(P, eng)
        assert wd.deadline_seconds == 0.5
    finally:
        eng.drain(timeout=10.0)
    assert wd.stalls == 1
    assert wd.last_step == 3              # one beat per completed batch
    assert P.telemetry.value(
        'mxnet_tpu_resilience_watchdog_stalls_total') == 1


def test_watchdog_stays_quiet_through_a_burst(P, monkeypatch):
    """Armed from MXTPU_SERVE_WATCHDOG_SECONDS, a burst of requests from
    two threads gives no stall report; drain stops the watchdog."""
    monkeypatch.setenv('MXTPU_SERVE_WATCHDOG_SECONDS', '5')
    eng = P.serving.InferenceEngine(
        _zeros_runner(), seq_buckets='8,16', batch_buckets='1,2,4',
        deadline_ms=1.0)
    wd = _watchdog_of(P, eng)
    assert wd is not None and wd.deadline_seconds == 5.0
    errors = []

    def client(k):
        try:
            for i in range(10):
                eng.submit(list(range(1, 2 + (i + k) % 15)), timeout=10.0)
        except Exception as e:          # noqa: BLE001
            errors.append(e)
    threads = [threading.Thread(target=client, args=(k,)) for k in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30.0)
    eng.drain(timeout=10.0)
    assert not errors and wd.stalls == 0 and wd.last_step >= 1
    assert wd._thread is None             # stopped with the engine
    monkeypatch.delenv('MXTPU_SERVE_WATCHDOG_SECONDS')
    eng = P.serving.InferenceEngine(_zeros_runner(), watchdog_seconds=0)
    assert _watchdog_of(P, eng) is None
    eng.drain()


def test_port_results_survive_a_reused_output_buffer():
    """A runner that hands back one buffer it overwrites (as the pinned
    copy does per bucket shape): each request keeps its own values."""
    P = _ns('mxnet_tpu_torch')
    buf = onp.zeros((1, 8, 2), 'float32')

    def runner(mat):
        buf[...] = mat[..., None]
        return buf
    eng = P.serving.InferenceEngine(runner, seq_buckets='8',
                                    batch_buckets='1', deadline_ms=1.0)
    try:
        a = eng.submit([1, 2, 3], timeout=10.0)
        b = eng.submit([7, 8, 9], timeout=10.0)
        assert a[:, 0].tolist() == [1, 2, 3]
        assert b[:, 0].tolist() == [7, 8, 9]
    finally:
        eng.drain()


# ---------------------------------------------------------------------------
# parity and telemetry
# ---------------------------------------------------------------------------

def test_served_outputs_match_jax_engine(arrays):
    kw = dict(seq_buckets=(8, 16), batch_buckets=(1, 2, 4), deadline_ms=2)
    rng = onp.random.RandomState(7)
    requests = [list(rng.randint(1, 100, int(n)))
                for n in rng.randint(2, 17, 12)]
    outs = {}
    for name in PKGS:
        P = _ns(name)
        _net, eng = _engine(P, arrays, **kw)
        try:
            P.serving.warmup(eng)
            outs[name] = [eng.submit(r, timeout=60.0) for r in requests]
        finally:
            eng.drain()
    for req, j, t in zip(requests, outs['mxnet_tpu'],
                         outs['mxnet_tpu_torch']):
        assert t.shape == j.shape == (len(req), CFG['hidden'])
        onp.testing.assert_allclose(t, j, rtol=RTOL, atol=ATOL)


def test_serving_counters_and_spans_match_stats(P, arrays):
    P.trace.enable()
    _net, eng = _engine(P, arrays)
    try:
        P.serving.warmup(eng)
        P.trace.clear()
        _storm(P, eng, n=24, seed=5)
    finally:
        eng.drain()
    st = eng.stats()
    v = P.telemetry.value
    assert v('mxnet_tpu_serving_requests_total', engine=eng.name) == \
        st['requests'] == 24
    assert v('mxnet_tpu_serving_batches_total', engine=eng.name) == \
        st['batches']
    hits = sum(val for labels, val in
               P.telemetry.series('mxnet_tpu_serving_bucket_hits_total'))
    assert hits == st['batches']
    assert v('mxnet_tpu_serving_latency_seconds', engine=eng.name)[0] == 24
    fills, _ = v('mxnet_tpu_serving_batch_fill_ratio', engine=eng.name)
    assert fills == st['batches']
    spans = [e for e in P.trace.chrome_events()
             if e['ph'] == 'B' and e['name'] == 'serving.dispatch']
    assert len(spans) == st['batches']
    assert all({'engine', 'batch', 'seq', 'fill'} <= set(e['args'])
               for e in spans)
    assert sum(e['args']['fill'] for e in spans) == 24
    assert v('mxnet_tpu_serving_queue_depth', engine=eng.name) == 0


def test_cachedop_cache_key_is_prefix_free(arrays, tmp_path):
    """JAX: a second Dense under a new prefix writes no new entry to
    the persistent compile cache. Port: two BERTs under different
    prefixes key every bucket alike, so their graphs' ledger signatures
    are one."""
    import glob
    import mxnet_tpu as mx
    from mxnet_tpu import nd
    from mxnet_tpu.telemetry import compile as jcomp
    cache = str(tmp_path / 'xla_cache')
    jcomp.clear(cache_dir=cache)
    try:
        x = nd.array(onp.random.RandomState(0).randn(4, 8).astype('float32'))
        files = []
        for i in range(2):
            # explicit prefixes: the global auto-naming counter stays
            # untouched for the tests that run after this one
            d = mx.gluon.nn.Dense(16, in_units=8, prefix=f'keytest{i}_')
            d.initialize()
            d.hybridize()
            d(x)
            files.append(len([f for f in glob.glob(
                os.path.join(cache, '**'), recursive=True)
                if os.path.isfile(f)]))
        assert files[0] >= 1 and files[1] == files[0]
    finally:
        jcomp.clear(ledger='', cache_dir='')
    from mxnet_tpu_torch.gluon.block import CachedOp
    P = _ns('mxnet_tpu_torch')
    a, b = _bert(P, arrays), _bert(P, arrays)
    assert a.name != b.name
    tok = torch.zeros(4, 16, dtype=torch.int32)
    with torch.inference_mode():
        assert CachedOp(a).key((tok,)) == CachedOp(b).key((tok,))
