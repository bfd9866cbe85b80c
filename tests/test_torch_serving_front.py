"""The port's serving front against the JAX package's: PredictServer over
HTTP (/predict, /reload, /drain, admission, weight quantization) and the
Router (mirrors the route, admission, quantize, reload, drain and router
cases of tests/test_serving.py).

The model is tests/test_serving.py's small token model (Embedding 64 x 8,
Dense 4, no flatten), built in each package (``P``). Its weights are made
in the JAX package and cross to the port by structured name, so both
servers answer the same requests with the same weights: the port's
/predict outputs are held to the JAX server's within 1e-6. The int8
weight grid is held to the JAX ``encode_decode`` bit for bit.

Every server binds 127.0.0.1 on a free port, every client call and every
wait has a deadline of 10 s or less, and every fixture stops its server
and drains its engine in a ``finally``.
"""
import contextlib
import functools
import importlib
import json
import os
import signal
import threading
import time
import types

import numpy as onp
import pytest
import torch
from test_torch_jax_globals import jax_globals  # noqa: F401

PKGS = ('mxnet_tpu', 'mxnet_tpu_torch')
HOST = '127.0.0.1'
PARITY_ATOL = 1e-6


def _ns(name):
    tel = importlib.import_module(name + '.telemetry')
    return types.SimpleNamespace(
        name=name, pkg=importlib.import_module(name),
        serving=importlib.import_module(name + '.serving'),
        telemetry=tel, compile=tel.compile, metrics=tel.metrics,
        memory=tel.memory, trace=tel.trace, flight=tel.flight,
        manifest=importlib.import_module(name + '.checkpoint.manifest'),
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


@pytest.fixture(params=PKGS)
def P(request):
    ns = _ns(request.param)
    _clean(ns)
    ns.telemetry.enable()
    ns.compile.enable()
    yield ns
    _clean(ns)


_CLASSES = {}


def _tok_class(P):
    if P.name not in _CLASSES:
        nn = P.pkg.gluon.nn

        class TokModel(nn.HybridBlock):
            def __init__(self, vocab=64, dim=8, classes=4, **kw):
                super().__init__(**kw)
                with self.name_scope():
                    self.embed = nn.Embedding(vocab, dim)
                    self.proj = nn.Dense(classes, flatten=False)

            def forward(self, x):
                return self.proj(self.embed(x))
        _CLASSES[P.name] = TokModel
    return _CLASSES[P.name]


@functools.lru_cache(maxsize=None)
def _jax_arrays(seed):
    """The JAX token model's initial weights by structured name."""
    import mxnet_tpu as mx
    mx.random.seed(seed)
    net = _tok_class(_ns('mxnet_tpu'))(prefix='tokmodel_')
    net.initialize()
    net(mx.nd.array(onp.zeros((1, 8), 'int32')))
    return {k: v.data().asnumpy()
            for k, v in net._collect_params_with_prefix().items()}


def _tok_model(P, seed=0):
    """The token model in ``P``, placed (on the CPU for the port) and
    holding the JAX weights drawn from ``seed``."""
    with (P.pkg.cpu() if P.port else contextlib.nullcontext()):
        net = _tok_class(P)(prefix='tokmodel_')
        net.initialize()
        net(P.pkg.nd.array(onp.zeros((1, 8), 'int32')))
        for k, p in net._collect_params_with_prefix().items():
            p.set_data(P.pkg.nd.array(_jax_arrays(seed)[k]))
    return net


def _dtype(param):
    """A parameter's dtype by name (numpy's in JAX, torch's in the port)."""
    return str(param.data().dtype).rsplit('.', 1)[-1]


def _forward(P, net, tokens):
    """The block's eager forward of one padded row, as numpy."""
    x = onp.asarray([tokens], 'int32')
    if P.port:
        with torch.inference_mode():
            return net(torch.from_numpy(x)).float().numpy()[0]
    return net(P.pkg.nd.array(x)).asnumpy()[0]


def _engine(P, net=None, **kw):
    net = net if net is not None else _tok_model(P)
    kw.setdefault('seq_buckets', '8,16')
    kw.setdefault('batch_buckets', '1,2,4')
    kw.setdefault('deadline_ms', 2.0)
    runner = P.serving.BlockRunner(net, **({'device': 'cpu'} if P.port
                                           else {}))
    return net, P.serving.InferenceEngine(runner, **kw)


@pytest.fixture()
def served(P):
    net, eng = _engine(P)
    srv = None
    try:
        P.serving.warmup(eng)
        srv = P.serving.PredictServer(eng, port=0, block=net)
        yield net, eng, srv
    finally:
        if srv is not None:
            srv.stop()
        eng.drain(timeout=10.0)


def _wait(cond, timeout=10.0):
    deadline = time.monotonic() + timeout
    while not cond() and time.monotonic() < deadline:
        time.sleep(0.02)
    return cond()


def _dead_port():
    import socket
    with socket.socket() as s:
        s.bind((HOST, 0))
        return s.getsockname()[1]


# ---------------------------------------------------------------------------
# admission and weight quantization
# ---------------------------------------------------------------------------

def test_memory_admission_predicate(P, monkeypatch):
    assert P.serving.memory_admission(0) is None
    admit = P.serving.memory_admission(1.0)    # 1 MiB limit
    monkeypatch.setattr(P.memory, 'health_fields',
                        lambda: {'live_bytes': 8 << 20})
    assert 'memory_pressure' in admit()
    monkeypatch.setattr(P.memory, 'health_fields',
                        lambda: {'live_bytes': 0})
    assert admit() is None


def test_memory_admission_reads_the_knob(P, monkeypatch):
    monkeypatch.setenv('MXTPU_SERVE_MEMORY_LIMIT_MB', '0')
    assert P.serving.memory_admission() is None
    monkeypatch.setenv('MXTPU_SERVE_MEMORY_LIMIT_MB', '2')
    monkeypatch.setattr(P.memory, 'health_fields',
                        lambda: {'live_bytes': 3 << 20})
    assert 'memory_pressure (3MiB > 2MiB)' == P.serving.memory_admission()()


def test_admission_sheds_503_before_the_device(P, monkeypatch):
    """A limit below the live bytes answers 503 and the engine's
    dispatch count does not move."""
    monkeypatch.setattr(P.memory, 'health_fields',
                        lambda: {'live_bytes': 8 << 20})
    net, eng = _engine(P, admission=P.serving.memory_admission(1.0))
    srv = None
    try:
        srv = P.serving.PredictServer(eng, port=0, block=net)
        st, doc = P.serving.http_json(HOST, srv.port, '/predict',
                                      {'inputs': [1, 2, 3]})
        assert st == 503 and 'memory_pressure' in doc['error'], doc
        s = eng.stats()
        assert s['batches'] == 0 and s['requests'] == 0 and s['shed'] == 1
    finally:
        if srv is not None:
            srv.stop()
        eng.drain(timeout=10.0)


def test_quantize_weights_bf16_and_int8(P):
    net = _tok_model(P)
    P.serving.quantize_weights(net, 'bf16')
    assert _dtype(net.proj.weight) == 'bfloat16'
    net2 = _tok_model(P)
    before = onp.asarray(net2.proj.weight.data().asnumpy()).copy()
    P.serving.quantize_weights(net2, 'int8')
    after = onp.asarray(net2.proj.weight.data().asnumpy())
    assert not onp.array_equal(before, after)       # snapped to the grid
    assert onp.allclose(before, after, atol=0.1)    # but nearby
    with pytest.raises(P.MXNetError):
        P.serving.quantize_weights(net2, 'fp4')
    assert P.serving.quantize_weights(net2, '') is net2


def test_port_quantize_reads_the_knob(monkeypatch):
    P = _ns('mxnet_tpu_torch')
    net = _tok_model(P)
    monkeypatch.setenv('MXTPU_SERVE_QUANTIZE', '')
    assert P.serving.quantize_weights(net) is net
    assert _dtype(net.proj.weight) == 'float32'
    monkeypatch.setenv('MXTPU_SERVE_QUANTIZE', 'bf16')
    P.serving.quantize_weights(net)
    assert _dtype(net.proj.weight) == 'bfloat16'


def _codec_inputs():
    rng = onp.random.RandomState(7)
    big = rng.randn(3, 512).astype('float32') * 3
    big[0, 5] = onp.nan
    big[1, 7] = onp.inf
    big[2, 256:] = 0.0                      # a zero block: scale 1.0
    return [big, rng.randn(5, 7).astype('float32'),
            rng.randn(256).astype('float32'),
            onp.float32(rng.randn()), onp.zeros((2, 0), 'float32'),
            (rng.randn(4, 768) * 0.02).astype('float32')]


@pytest.mark.parametrize('ctype', ['int8', 'fp16', '2bit'])
@pytest.mark.parametrize('block', [256, 0])
def test_codec_grid_bit_equal_to_jax_encode_decode(ctype, block):
    import jax.numpy as jnp
    from mxnet_tpu.parallel import compression as jc
    from mxnet_tpu_torch.parallel import compression as tc
    for x in _codec_inputs():
        want = onp.asarray(jc.encode_decode(jnp.asarray(x), ctype,
                                            block=block))
        got = tc.encode_decode(torch.from_numpy(onp.array(x)), ctype,
                               block=block).numpy()
        assert got.dtype == want.dtype == onp.float32
        assert got.shape == want.shape
        assert onp.array_equal(got.view('int32'), want.view('int32')), \
            (ctype, block, x.shape)


def test_codec_refuses_an_unknown_type():
    from mxnet_tpu_torch.base import MXNetError
    from mxnet_tpu_torch.parallel import compression as tc
    with pytest.raises(MXNetError, match='unknown codec'):
        tc.encode_decode(torch.ones(3), 'int4')


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_int8_quantized_weights_bit_equal_to_jax(dtype):
    """'int8' snaps each float parameter in f32 and writes it back in the
    parameter's dtype: on a bf16 block the snapped value is rounded to
    bf16 again, in both packages alike."""
    out = {}
    for name in PKGS:
        P = _ns(name)
        net = _tok_model(P, seed=3)
        if dtype == 'bfloat16':
            net.cast('bfloat16')
        P.serving.quantize_weights(net, 'int8')
        out[name] = {k: onp.asarray(p.data().asnumpy(), 'float32')
                     for k, p in net._collect_params_with_prefix().items()}
    for k, want in out['mxnet_tpu'].items():
        got = out['mxnet_tpu_torch'][k]
        assert onp.array_equal(got.view('int32'), want.view('int32')), k


# ---------------------------------------------------------------------------
# replica server routes
# ---------------------------------------------------------------------------

def test_predict_single_and_list(P, served):
    _net, _eng, srv = served
    st, doc = P.serving.http_json(HOST, srv.port, '/predict',
                                  {'inputs': [1, 2, 3]})
    assert st == 200 and len(doc['outputs']) == 3
    assert doc['latency_ms'] > 0
    st, doc = P.serving.http_json(HOST, srv.port, '/predict',
                                  {'inputs': [[1, 2, 3], [4, 5]]})
    assert st == 200
    assert len(doc['outputs']) == 2 and len(doc['outputs'][1]) == 2


def test_predict_outputs_match_the_jax_server():
    """Both servers, the same weights, the same requests: the port's
    outputs within 1e-6 of the JAX server's, and equal to its own engine's
    in-process result after the JSON round trip."""
    got = {}
    requests = [{'inputs': [1, 2, 3]},
                {'inputs': [[5, 9, 11, 2, 63], [4], list(range(1, 17))]}]
    for name in PKGS:
        P = _ns(name)
        net, eng = _engine(P)
        srv = None
        try:
            srv = P.serving.PredictServer(eng, port=0, block=net)
            got[name] = [P.serving.http_json(HOST, srv.port, '/predict', r)
                         for r in requests]
            direct = eng.submit([5, 9, 11, 2, 63], timeout=10.0)
        finally:
            if srv is not None:
                srv.stop()
            eng.drain(timeout=10.0)
        assert onp.array_equal(onp.asarray(got[name][1][1]['outputs'][0]),
                               onp.asarray(direct, onp.float64))
    for (sj, dj), (st, dt) in zip(got['mxnet_tpu'], got['mxnet_tpu_torch']):
        assert sj == st == 200
        if isinstance(dj['outputs'][0][0], list):
            pairs = list(zip(dj['outputs'], dt['outputs']))
        else:
            pairs = [(dj['outputs'], dt['outputs'])]
        for a, b in pairs:
            assert onp.asarray(a).shape == onp.asarray(b).shape
            assert onp.allclose(onp.asarray(b), onp.asarray(a), rtol=0,
                                atol=PARITY_ATOL)


BAD_REQUESTS = [
    ('POST', '/predict', {'wrong_key': 1}),
    ('POST', '/predict', {'inputs': list(range(99))}),
    ('POST', '/predict', b'{not json'),
    ('POST', '/nope', {}),
    ('GET', '/nope', None),
    ('GET', '/predict', None),
    ('POST', '/reload', b'[1'),
    ('POST', '/reload', {}),
]


def _raw(port, method, path, body):
    import http.client
    conn = http.client.HTTPConnection(HOST, port, timeout=10.0)
    try:
        if body is None:
            conn.request(method, path)
        else:
            if not isinstance(body, bytes):
                body = json.dumps(body).encode()
            conn.request(method, path, body=body,
                         headers={'Content-Length': str(len(body))})
        resp = conn.getresponse()
        resp.read()
        return resp.status
    finally:
        conn.close()


def test_bad_requests_get_the_jax_servers_status_codes():
    codes = {}
    for name in PKGS:
        P = _ns(name)
        net, eng = _engine(P)
        srv = None
        try:
            srv = P.serving.PredictServer(eng, port=0, block=net)
            codes[name] = [_raw(srv.port, *r) for r in BAD_REQUESTS]
            st, doc = P.serving.http_json(HOST, srv.port, '/healthz')
            assert st == 200 and doc['status'] == 'ok'
        finally:
            if srv is not None:
                srv.stop()
            eng.drain(timeout=10.0)
    assert codes['mxnet_tpu_torch'] == codes['mxnet_tpu'] == \
        [400, 400, 400, 404, 404, 404, 400, 400]


def test_a_body_that_is_not_an_object_is_a_client_error():
    """A JSON body that is not an object: the JAX handler's TypeError
    escapes its route and the connection drops with no answer (a
    reference fault, ROADMAP queue 3); the port answers 400."""
    import http.client
    codes = {}
    for name in PKGS:
        P = _ns(name)
        net, eng = _engine(P)
        srv = None
        try:
            srv = P.serving.PredictServer(eng, port=0, block=net)
            try:
                codes[name] = _raw(srv.port, 'POST', '/predict', [1, 2])
            except http.client.RemoteDisconnected:
                codes[name] = 'dropped'
            st, _ = P.serving.http_json(HOST, srv.port, '/predict',
                                        {'inputs': [1, 2]})
            assert st == 200                # the replica still serves
        finally:
            if srv is not None:
                srv.stop()
            eng.drain(timeout=10.0)
    assert codes == {'mxnet_tpu': 'dropped', 'mxnet_tpu_torch': 400}


def test_predict_client_errors(P, served):
    _net, _eng, srv = served
    st, doc = P.serving.http_json(HOST, srv.port, '/predict',
                                  {'wrong_key': 1})
    assert st == 400, doc
    st, doc = P.serving.http_json(HOST, srv.port, '/predict',
                                  {'inputs': list(range(99))})
    assert st == 400, doc
    st, _doc = P.serving.http_json(HOST, srv.port, '/nope', {})
    assert st == 404
    # the inherited GET routes still answer
    st, doc = P.serving.http_json(HOST, srv.port, '/healthz')
    assert st in (200, 503) and isinstance(doc, dict)
    st, _doc = P.serving.http_json(HOST, srv.port, '/metrics')
    assert st == 200


def test_reload_by_path_swaps_weights(P, served, tmp_path):
    net, _eng, srv = served
    donor = _tok_model(P, seed=11)
    path = str(tmp_path / 'weights.params')
    donor.save_parameters(path)
    st, before = P.serving.http_json(HOST, srv.port, '/predict',
                                     {'inputs': [1, 2, 3]})
    assert st == 200
    st, doc = P.serving.http_json(HOST, srv.port, '/reload', {'path': path})
    assert st == 200 and doc['reloaded'], doc
    st, after = P.serving.http_json(HOST, srv.port, '/predict',
                                    {'inputs': [1, 2, 3]})
    assert st == 200
    # the donor's weights differ, so the outputs must flip...
    assert before['outputs'] != after['outputs']
    # ...to exactly the donor's own forward
    want = _forward(P, donor, [1, 2, 3] + [0] * 5)[:3]
    assert onp.allclose(onp.asarray(after['outputs']), want, atol=1e-6)


def test_port_reloads_a_jax_checkpoint_as_the_jax_server_does(tmp_path):
    """A .params file the JAX package wrote, reloaded by both servers:
    the same answers within 1e-6."""
    donor = _tok_model(_ns('mxnet_tpu'), seed=5)
    path = str(tmp_path / 'weights.params')
    donor.save_parameters(path)
    outs = {}
    for name in PKGS:
        P = _ns(name)
        net, eng = _engine(P)
        srv = None
        try:
            srv = P.serving.PredictServer(eng, port=0, block=net)
            st, _ = P.serving.http_json(HOST, srv.port, '/reload',
                                        {'path': path})
            assert st == 200
            st, doc = P.serving.http_json(HOST, srv.port, '/predict',
                                          {'inputs': [7, 8, 9, 10]})
            assert st == 200
            outs[name] = onp.asarray(doc['outputs'])
        finally:
            if srv is not None:
                srv.stop()
            eng.drain(timeout=10.0)
    assert onp.allclose(outs['mxnet_tpu_torch'], outs['mxnet_tpu'],
                        rtol=0, atol=PARITY_ATOL)


def test_reload_invalid_step_is_409(P, served, tmp_path):
    _net, _eng, srv = served
    srv.replica_root = str(tmp_path)
    st, doc = P.serving.http_json(HOST, srv.port, '/reload',
                                  {'ns': 'serving', 'step': 3})
    assert st == 409, doc


def _write_step(P, root, net, step, corrupt=False):
    """A committed step directory in the manifest format: weights.params
    and manifest.json with its sha256 (a flipped byte when ``corrupt``)."""
    mf = P.manifest
    d = os.path.join(root, 'serving', mf.step_dir_name(step))
    os.makedirs(d)
    path = os.path.join(d, 'weights.params')
    net.save_parameters(path)
    data = open(path, 'rb').read()
    mf.write_manifest(d, {'step': step, 'blobs': [{
        'name': 'weights', 'file': 'weights.params', 'bytes': len(data),
        'sha256': mf.sha256_bytes(data)}]})
    if corrupt:
        with open(path, 'r+b') as f:
            f.seek(len(data) // 2)
            b = f.read(1)
            f.seek(len(data) // 2)
            f.write(bytes([b[0] ^ 0xFF]))
    return d


def test_reload_by_step_validates_the_manifest(P, served, tmp_path):
    net, _eng, srv = served
    srv.replica_root = str(tmp_path)
    donor = _tok_model(P, seed=13)
    _write_step(P, str(tmp_path), donor, 4)
    _write_step(P, str(tmp_path), donor, 5, corrupt=True)
    st, doc = P.serving.http_json(HOST, srv.port, '/reload',
                                  {'ns': 'serving', 'step': 5})
    assert st == 409 and 'sha256' in doc['error'], doc
    st, doc = P.serving.http_json(HOST, srv.port, '/reload',
                                  {'ns': 'serving', 'step': 4})
    assert st == 200 and doc == {'reloaded': True, 'step': 4}
    assert srv.reloaded_step == 4
    st, doc = P.serving.http_json(HOST, srv.port, '/predict',
                                  {'inputs': [3, 1]})
    want = _forward(P, donor, [3, 1] + [0] * 6)[:2]
    assert onp.allclose(onp.asarray(doc['outputs']), want, atol=1e-6)


def test_manifests_cross_between_the_packages(tmp_path):
    """Either package's manifest module validates the other's step
    directory, and both name its corruption."""
    jp, tp = _ns('mxnet_tpu'), _ns('mxnet_tpu_torch')
    net = _tok_model(jp)
    a = _write_step(jp, str(tmp_path / 'a'), net, 1)
    b = _write_step(tp, str(tmp_path / 'b'), net, 1, corrupt=True)
    assert jp.manifest.step_dir_name(12) == tp.manifest.step_dir_name(12) \
        == 'step_0000000012'
    assert tp.manifest.validate_step_dir(a) == \
        jp.manifest.validate_step_dir(a)
    for mf in (jp.manifest, tp.manifest):
        with pytest.raises(mf.CorruptCheckpointError, match='sha256'):
            mf.validate_step_dir(b)
    assert tp.manifest.committed_steps(str(tmp_path / 'a' / 'serving')) \
        == [1]


def test_drain_stops_admission_and_listener(P, served):
    _net, eng, srv = served
    st, doc = P.serving.http_json(HOST, srv.port, '/drain', {})
    assert st == 200 and doc['draining']
    assert _wait(lambda: srv._server is None), \
        "drain never closed the listener"
    with pytest.raises(P.serving.RequestShed):
        eng.submit([1, 2, 3])


def test_sigterm_drains_the_replica(P, served):
    _net, eng, srv = served
    old = signal.getsignal(signal.SIGTERM)
    try:
        srv.install_sigterm()
        os.kill(os.getpid(), signal.SIGTERM)
        assert _wait(lambda: srv._server is None), \
            "SIGTERM never closed the listener"
    finally:
        signal.signal(signal.SIGTERM, old)
    assert srv.draining.is_set()
    with pytest.raises(P.serving.RequestShed):
        eng.submit([1, 2, 3])


def test_port_healthz_says_draining():
    P = _ns('mxnet_tpu_torch')
    net, eng = _engine(P)
    srv = P.serving.PredictServer(eng, port=0, block=net, start=False)
    try:
        assert srv.health()['status'] == 'ok'
        srv.draining.set()
        assert srv.health()['status'] == 'draining'
        assert srv._route('/healthz')[0] == '503 Service Unavailable'
    finally:
        srv.stop()
        eng.drain(timeout=10.0)


# ---------------------------------------------------------------------------
# /reload into captured graphs (the port's CachedOp path on the CPU)
# ---------------------------------------------------------------------------

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


def _cpu_capture(fn, device, generators=(), warm_up=False):
    from mxnet_tpu_torch.telemetry import compile as comp
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
    monkeypatch.setattr(block, 'capture', _cpu_capture)
    monkeypatch.setattr(block, 'graph_generators', lambda b, d: [])


def _cachedop_entries(P):
    return [e for e in P.compile.ledger()
            if e['site'].startswith('cachedop:')]


@pytest.mark.usefixtures('cpu_graphs')
def test_port_reload_after_capture_needs_no_recapture(tmp_path):
    """A warmed, hybridized block takes /reload's weights in place: every
    parameter keeps its storage (a captured graph reads it by address),
    the next predict equals the donor's eager forward, and the compile
    ledger gains no cachedop: entry."""
    P = _ns('mxnet_tpu_torch')
    _clean(P)
    P.compile.enable()
    net, eng = _engine(P)
    srv = None
    try:
        P.serving.warmup(eng)
        n_graphs = net._cached_op.num_graphs
        assert n_graphs == 6
        entries = len(_cachedop_entries(P))
        assert entries == 6
        ptrs = {n: p.data_ptr() for n, p in net.named_parameters()}
        srv = P.serving.PredictServer(eng, port=0, block=net)
        donor = _tok_model(P, seed=17)
        path = str(tmp_path / 'w.params')
        donor.save_parameters(path)
        st, _ = P.serving.http_json(HOST, srv.port, '/reload',
                                    {'path': path})
        assert st == 200
        st, doc = P.serving.http_json(HOST, srv.port, '/predict',
                                      {'inputs': [[9, 8, 7], [1] * 12]})
        assert st == 200
        assert {n: p.data_ptr() for n, p in net.named_parameters()} == ptrs
        assert len(_cachedop_entries(P)) == entries
        assert net._cached_op.num_graphs == n_graphs
        want0 = _forward(P, donor, [9, 8, 7] + [0] * 5)[:3]
        want1 = _forward(P, donor, [1] * 12 + [0] * 4)[:12]
        assert onp.array_equal(onp.asarray(doc['outputs'][0], 'float32'),
                               want0)
        assert onp.array_equal(onp.asarray(doc['outputs'][1], 'float32'),
                               want1)
    finally:
        if srv is not None:
            srv.stop()
        eng.drain(timeout=10.0)
        _clean(P)


@pytest.mark.usefixtures('cpu_graphs')
def test_port_bf16_quantize_recaptures_in_warmup_not_in_traffic():
    """``quantize_weights(block, 'bf16')`` casts, which drops the graphs;
    warming the engine again recaptures every bucket there, and traffic
    after it adds no ledger entry."""
    P = _ns('mxnet_tpu_torch')
    _clean(P)
    P.compile.enable()
    net, eng = _engine(P)
    try:
        P.serving.warmup(eng)
        assert len(_cachedop_entries(P)) == 6
        P.serving.quantize_weights(net, 'bf16')
        assert net._cached_op is None
        P.serving.warmup(eng)
        assert len(_cachedop_entries(P)) == 12
        n = len(P.compile.ledger())
        for length in (1, 3, 8, 9, 16, 5, 12):
            out = eng.submit(list(range(1, length + 1)), timeout=10.0)
            assert out.shape == (length, 4) and out.dtype == onp.float32
        assert len(P.compile.ledger()) == n
    finally:
        eng.drain(timeout=10.0)
        _clean(P)


# ---------------------------------------------------------------------------
# router: failover, ejection, readmission
# ---------------------------------------------------------------------------

def test_router_fails_over_and_ejects(P, served):
    _net, _eng, srv = served
    dead = _dead_port()
    r = P.serving.Router(endpoints=[(HOST, dead), (HOST, srv.port)],
                         eject_failures=1, readmit_seconds=60.0)
    outs = [r.predict([1, 2, 3]) for _ in range(4)]
    assert all(len(o) == 3 for o in outs)
    assert r.failovers >= 1
    assert 0 in r.ejected()              # the dead endpoint is out
    assert P.telemetry.value('mxnet_tpu_serving_ejections_total',
                             rank=0) >= 1


def test_router_4xx_is_the_callers_fault_no_ejection(P, served):
    _net, _eng, srv = served
    r = P.serving.Router(endpoints=[(HOST, srv.port)], eject_failures=1)
    with pytest.raises(P.MXNetError):
        r.predict(list(range(99)))       # too long -> 400
    assert r.ejected() == []             # the replica keeps its seat


def test_router_no_replicas(P):
    r = P.serving.Router(endpoints=[])
    with pytest.raises(P.serving.NoReplicasError):
        r.predict([1, 2, 3])


def test_router_reads_its_knobs(P, monkeypatch):
    monkeypatch.setenv('MXTPU_SERVE_EJECT_FAILURES', '3')
    monkeypatch.setenv('MXTPU_SERVE_READMIT_SECONDS', '0.5')
    r = P.serving.Router(endpoints=[(HOST, 1)])
    assert r.eject_failures == 3 and r.readmit_seconds == 0.5


def test_router_survives_a_drain_mid_burst(P):
    """Two replicas behind a router, 24 requests from 4 client threads,
    /drain sent to one replica mid-burst: no request fails."""
    made = [_engine(P) for _ in range(2)]
    servers = []
    try:
        for net, eng in made:
            servers.append(P.serving.PredictServer(eng, port=0, block=net))
        r = P.serving.Router(endpoints=[(HOST, s.port) for s in servers],
                             eject_failures=2, readmit_seconds=60.0)
        rng = onp.random.RandomState(0)
        reqs = [rng.randint(1, 64, int(n)).tolist()
                for n in rng.randint(1, 17, 24)]
        results, errors = [None] * len(reqs), []
        started = threading.Event()

        def client(idx):
            try:
                for i in idx:
                    results[i] = r.predict(reqs[i], timeout=10.0)
                    started.set()
            except Exception as e:                    # noqa: BLE001
                errors.append(repr(e))

        threads = [threading.Thread(target=client,
                                    args=(range(t, len(reqs), 4),))
                   for t in range(4)]
        for t in threads:
            t.start()
        assert started.wait(10.0)
        st, _ = P.serving.http_json(HOST, servers[0].port, '/drain', {})
        assert st == 200
        for t in threads:
            t.join(timeout=10.0)
        assert not any(t.is_alive() for t in threads)
        assert not errors, errors
        assert all(len(o) == len(q) for o, q in zip(results, reqs))
        assert _wait(lambda: servers[0]._server is None)
        # the drained replica refuses from now on: the next requests fail
        # over to the survivor
        for q in reqs[:4]:
            assert len(r.predict(q, timeout=10.0)) == len(q)
        assert r.failovers >= 1
    finally:
        for s in servers:
            s.stop()
        for _net, eng in made:
            eng.drain(timeout=10.0)


def test_port_router_counts_every_answer_under_contention():
    """Eight client threads share one Router with a short switch
    interval: its request count is every answered predict (the counters
    are updated under its lock)."""
    import sys
    P = _ns('mxnet_tpu_torch')
    net, eng = _engine(P)
    srv = None
    interval = sys.getswitchinterval()
    try:
        srv = P.serving.PredictServer(eng, port=0, block=net,
                                      max_handlers=16)
        r = P.serving.Router(endpoints=[(HOST, srv.port)])
        answered, errors = [], []

        def client():
            try:
                for i in range(8):
                    answered.append(len(r.predict([1 + i, 2], timeout=10.0)))
            except Exception as e:                    # noqa: BLE001
                errors.append(repr(e))
        sys.setswitchinterval(1e-6)
        threads = [threading.Thread(target=client) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=10.0)
        assert not any(t.is_alive() for t in threads)
        assert not errors, errors
        assert len(answered) == 64 and r.requests == 64
        assert r.failovers == 0
    finally:
        sys.setswitchinterval(interval)
        if srv is not None:
            srv.stop()
        eng.drain(timeout=10.0)


def test_port_router_readmits_through_healthz():
    """An ejected replica past its readmit time is probed with GET
    /healthz: a healthy one rejoins, a draining or dead one sits out
    another period."""
    P = _ns('mxnet_tpu_torch')
    net, eng = _engine(P)
    srv = None
    try:
        srv = P.serving.PredictServer(eng, port=0, block=net)
        dead = _dead_port()
        r = P.serving.Router(endpoints=[(HOST, srv.port), (HOST, dead)],
                             eject_failures=1, readmit_seconds=0.2)
        r.eject(0)
        r.eject(1)
        assert r.ejected() == [0, 1]
        r._candidates()                   # not due yet: no probe
        assert r.readmissions == 0
        time.sleep(0.25)
        cands = r._candidates()           # both due: 0 healthy, 1 dead
        assert r.readmissions == 1 and r.ejected() == [1]
        assert [c.rank for c in cands] == [0, 1]
        assert len(r.predict([1, 2])) == 2
        srv.draining.set()                # /healthz now answers 503
        r.eject(0)
        time.sleep(0.25)
        r._candidates()
        assert r.ejected() == [0, 1] and r.readmissions == 1
    finally:
        if srv is not None:
            srv.stop()
        eng.drain(timeout=10.0)


def test_port_refuses_what_waits_for_the_distributed_runtime():
    from mxnet_tpu_torch.base import MXNetError
    P = _ns('mxnet_tpu_torch')
    with pytest.raises(MXNetError, match='item 10'):
        P.serving.discover_replicas(object(), 9000)
    with pytest.raises(MXNetError, match='item 10'):
        P.serving.push_weights(None, 1, [])
    with pytest.raises(MXNetError, match='item 10'):
        P.serving.Router(endpoints=[], membership=object())
    net, eng = _engine(P)
    try:
        with pytest.raises(MXNetError, match='item 10'):
            P.serving.PredictServer(eng, block=net, membership=object(),
                                    start=False)
    finally:
        eng.drain(timeout=10.0)


def test_port_serve_port_knob(monkeypatch):
    P = _ns('mxnet_tpu_torch')
    port = _dead_port()
    monkeypatch.setenv('MXTPU_SERVE_PORT', str(port))
    net, eng = _engine(P)
    srv = None
    try:
        srv = P.serving.PredictServer(eng, block=net)
        assert srv.port == port
        st, doc = P.serving.http_json(HOST, port, '/predict',
                                      {'inputs': [4, 4]})
        assert st == 200 and len(doc['outputs']) == 2
    finally:
        if srv is not None:
            srv.stop()
        eng.drain(timeout=10.0)


def test_serving_exports_match_the_jax_package():
    jax_all = set(_ns('mxnet_tpu').serving.__all__)
    port_all = set(_ns('mxnet_tpu_torch').serving.__all__)
    assert jax_all == port_all
    for name in ('PredictServer', 'quantize_weights', 'memory_admission',
                 'Router', 'http_json', 'NoReplicasError'):
        assert name in port_all
