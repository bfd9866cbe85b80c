"""The serving recipe on the card: ``BlockRunner`` hybridizes a bf16 BERT,
each bucket is one captured CUDA graph, and the output comes back through
a pinned buffer.

These tests need a CUDA device and carry the ``cuda`` marker; without a
card they skip. On the card, from the root of the checkout (the file
imports only torch, numpy and the port, so the JAX conftest is left out):

    python -m pytest --noconftest -m cuda tests/test_torch_serving_cuda.py

The model is BERT at hidden 256, 2 layers, 4 heads (head dim 64, the
tensor-core variants of the kernels), bf16, weights Normal(0.02) from a
numpy seed. TF32 stays off so eager runs and captures agree bitwise.
"""
import contextlib
import os

import numpy as onp
import pytest
import torch

from mxnet_tpu_torch import serving
from mxnet_tpu_torch.models.bert import BertModel
from mxnet_tpu_torch.ops import _build
from mxnet_tpu_torch.telemetry import compile as comp
from mxnet_tpu_torch.weights import params_from_mxnet_tpu

pytestmark = pytest.mark.cuda

CFG = dict(vocab_size=1000, hidden=256, layers=2, heads=4, intermediate=1024,
           max_len=128)
KERNELS = ('flash_fwd_tc_kernel', '_add_ln_fwd', 'dense_gelu_tc_kernel')


@pytest.fixture(autouse=True)
def card(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    torch.backends.cuda.matmul.allow_tf32 = False
    monkeypatch.setenv('MXTPU_PALLAS_LN', '1')
    monkeypatch.setenv('MXTPU_PALLAS_FFN', '1')
    comp.disable()
    comp.clear(ledger='')
    yield
    comp.disable()
    comp.clear(ledger='')


def _net():
    net = BertModel(**CFG, dtype=torch.bfloat16, device='cuda')
    rng = onp.random.RandomState(0)
    arrays = {n: (rng.standard_normal(tuple(p.shape)).astype('float32') *
                  onp.float32(0.02)) if n.endswith('weight')
              else p.detach().float().cpu().numpy()
              for n, p in net.named_parameters()}
    net.load_state_dict(params_from_mxnet_tpu(arrays, net))
    return net


def _mat(batch, seq, seed=0):
    return onp.random.RandomState(seed).randint(
        1, CFG['vocab_size'], (batch, seq)).astype('int32')


def _engine(net, **kw):
    return serving.InferenceEngine(serving.BlockRunner(net),
                                   seq_buckets='64,128',
                                   batch_buckets='1,2', **kw)


def _kernels(fn, iters=2, tries=3):
    """{kernel of KERNELS: launches per call} from a profiler trace. Every
    call launches the flash forward once a layer; a trace of CUDA-graph
    replays that counts fewer came back short (seen on the card), and is
    taken again, up to ``tries`` times, as chip_smoke.py does."""
    from torch.profiler import ProfilerActivity, profile
    for attempt in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        counts = {e.key: e.count for e in prof.key_averages()}
        got = {k: sum(c for n, c in counts.items() if k in n) / iters
               for k in KERNELS}
        if got['flash_fwd_tc_kernel'] >= CFG['layers']:
            break
        print(f'profiler trace {attempt + 1} short ({got}): taken again')
    return got


def test_each_bucket_replay_is_bitwise_the_eager_forward():
    net = _net()
    engine = _engine(net)
    try:
        grid = engine.bucket_grid()
        req = _mat(1, 50)[0]
        padded = onp.zeros((1, 64), 'int32')
        padded[0, :50] = req
        net.hybridize(False)
        eager = {(b, s): engine.runner(_mat(b, s)).copy() for b, s in grid}
        eager_req = engine.runner(padded)[0, :50].copy()
        net.hybridize()
        comp.enable()
        rep = serving.warmup(engine)
        assert net._cached_op.num_graphs == len(grid)
        sites = [e['site'] for e in comp.ledger()]
        assert sorted(s for s in sites if s.startswith('serving:')) == \
            sorted(f'serving:warmup_b{b}_s{s}' for b, s in grid)
        assert rep['compiles'] == len(sites)
        counts = dict(_build.launch_counts)
        for b, s in grid:
            got = engine.runner(_mat(b, s))
            assert onp.array_equal(got, eager[(b, s)]), (b, s)
        # replays relaunch the kernels from the graph, not the wrappers
        assert dict(_build.launch_counts) == counts
        n = len(comp.ledger())
        out = engine.submit(list(req), timeout=60.0)
        assert onp.array_equal(out, eager_req)
        assert len(comp.ledger()) == n
    finally:
        engine.drain()


def test_rehybridize_after_a_knob_flip_recaptures_the_new_route(
        monkeypatch):
    L = CFG['layers']
    net = _net()
    engine = _engine(net)
    try:
        serving.warmup(engine)
        mat = _mat(2, 128)
        assert _kernels(lambda: engine.runner(mat)) == {
            'flash_fwd_tc_kernel': L, '_add_ln_fwd': 2 * L,
            'dense_gelu_tc_kernel': L}
        monkeypatch.setenv('MXTPU_PALLAS_LN', '0')
        monkeypatch.setenv('MXTPU_PALLAS_FFN', '0')
        # a captured bucket keeps the route it was captured with ...
        assert _kernels(lambda: engine.runner(mat))['_add_ln_fwd'] == 2 * L
        # ... until hybridize() clears the cache and it is captured again
        net.hybridize()
        serving.warmup(engine)
        assert _kernels(lambda: engine.runner(mat)) == {
            'flash_fwd_tc_kernel': L, '_add_ln_fwd': 0,
            'dense_gelu_tc_kernel': 0}
    finally:
        engine.drain()


def test_pinned_copy_is_bitwise_the_pageable_copy():
    net = _net()
    runner = serving.BlockRunner(net)
    assert runner.pinned
    for b, s in ((1, 64), (2, 128)):
        mat = _mat(b, s, seed=3)
        pinned = runner(mat).copy()
        assert pinned.dtype == onp.float32
        runner.pinned = False
        pageable = runner(mat)
        runner.pinned = True
        assert onp.array_equal(pinned, pageable)
        again = runner(mat)
        assert onp.array_equal(again, pinned)


@contextlib.contextmanager
def _memory_cap(extra_bytes):
    """The allocator may hold only what is allocated now plus
    ``extra_bytes``, until the block ends."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    total = torch.cuda.get_device_properties(0).total_memory
    cap = torch.cuda.memory_reserved() + extra_bytes
    torch.cuda.set_per_process_memory_fraction(cap / total)
    try:
        yield
    finally:
        torch.cuda.set_per_process_memory_fraction(1.0)


def test_a_real_allocator_failure_sheds_and_the_next_request_is_served(
        tmp_path, monkeypatch):
    """A bucket warmup never saw, dispatched with the allocator capped:
    its first (eager) run fails to allocate, the batch sheds with
    RequestShed and the OOM dump is written; with the cap lifted the same
    bucket is captured and served."""
    monkeypatch.setenv('MXTPU_FLIGHT_DIR', str(tmp_path))
    from mxnet_tpu_torch.telemetry import memory
    net = _net()
    engine = serving.InferenceEngine(serving.BlockRunner(net),
                                     seq_buckets='64,128',
                                     batch_buckets='1,2', deadline_ms=1.0)
    try:
        engine.runner(_mat(1, 64))          # one bucket captured
        req = list(_mat(1, 120)[0])         # bucket (1, 128): not yet
        with _memory_cap(0):
            with pytest.raises(serving.RequestShed,
                               match='out of device memory'):
                engine.submit(req, timeout=60.0)
        assert engine.stats()['shed'] == 1
        assert os.path.exists(memory.default_oom_path())
        out = engine.submit(req, timeout=60.0)
        assert out.shape == (120, CFG['hidden'])
        assert onp.isfinite(out).all()
    finally:
        engine.drain()


def _arrays(net, seed):
    rng = onp.random.RandomState(seed)
    return {n: (rng.standard_normal(tuple(p.shape)).astype('float32') *
                onp.float32(0.02)) if n.endswith('weight')
            else p.detach().float().cpu().numpy()
            for n, p in net.named_parameters()}


def test_reload_over_http_into_captured_graphs_needs_no_recapture(tmp_path):
    """PredictServer's /reload on a warmed, hybridized bf16 BERT: the new
    weights are copied into the parameters' storage, so the captured
    graphs serve them (bitwise the eager forward with those weights) and
    the compile ledger gains no cachedop: entry."""
    net = _net()
    engine = _engine(net)
    srv = None
    try:
        comp.enable()
        serving.warmup(engine)
        caps = [e for e in comp.ledger() if e['site'].startswith('cachedop:')]
        assert len(caps) == len(engine.bucket_grid())
        donor = BertModel(**CFG, dtype=torch.bfloat16, device='cuda')
        donor.load_state_dict(params_from_mxnet_tpu(_arrays(donor, 9),
                                                    donor))
        path = str(tmp_path / 'donor.params')
        donor.save_parameters(path)
        ptrs = {n: p.data_ptr() for n, p in net.named_parameters()}
        srv = serving.PredictServer(engine, port=0, block=net)
        req = [int(t) for t in _mat(1, 100, seed=4)[0]]
        st, before = serving.http_json('127.0.0.1', srv.port, '/predict',
                                       {'inputs': req}, timeout=60.0)
        assert st == 200
        st, doc = serving.http_json('127.0.0.1', srv.port, '/reload',
                                    {'path': path}, timeout=60.0)
        assert st == 200 and doc['reloaded']
        st, after = serving.http_json('127.0.0.1', srv.port, '/predict',
                                      {'inputs': req}, timeout=60.0)
        assert st == 200
        assert {n: p.data_ptr() for n, p in net.named_parameters()} == ptrs
        assert [e for e in comp.ledger()
                if e['site'].startswith('cachedop:')] == caps
        assert after['outputs'] != before['outputs']
        padded = onp.zeros((1, 128), 'int32')
        padded[0, :100] = req
        donor.eval()
        with torch.inference_mode():
            want = donor(torch.from_numpy(padded).cuda())[0][0, :100]
        want = want.float().cpu().numpy().astype(onp.float64)
        assert onp.array_equal(onp.asarray(after['outputs']), want)
    finally:
        if srv is not None:
            srv.stop()
        engine.drain()
