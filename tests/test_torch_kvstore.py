"""The port's KVStore (``mxnet_tpu_torch.kvstore``) against the JAX
package's (``mxnet_tpu.kvstore``), on the CPU.

Both stores take the same numpy-seeded pushes and are compared key by
key: ``local``, ``device`` and ``dist_sync`` in a world of one process;
lists of 1-4 copies, ``pushpull``, ``broadcast``, ``row_sparse_pull``;
``set_optimizer`` with the optimizer states saved and loaded; 2bit, fp16
and int8 compression over 5 pushes, residuals and decoded values, and the
wire bytes. Sums and codecs are bitwise. An optimizer's update is held to
rel 1e-6: XLA and torch may round the same f32 expression (Adam's square
root and division) one ulp apart. Also: every type name of the JAX
``_TYPES`` table, pushes and pulls from threads, the telemetry counters,
the ``collective.all_reduce`` fault site, and the server role, which
exits at import (in a subprocess).

The seams: ``gluon.Trainer`` with ``update_on_kvstore=True``, with each
``compression_params`` codec and with a ``KVStore`` object, three f32
steps against the JAX Trainer on the same weights and data (parameters
within rel 1e-5); its states payload round trip.
"""
import os
import pickle
import subprocess
import sys
import threading

import numpy as onp
import pytest
import torch

import mxnet_tpu as mj
import mxnet_tpu_torch as mt
from mxnet_tpu.kvstore.gradient_compression import \
    GradientCompression as JGC
from mxnet_tpu.kvstore.kvstore import _TYPES as J_TYPES
from mxnet_tpu.parallel import compression as jcodecs
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.kvstore.gradient_compression import \
    GradientCompression as TGC
from mxnet_tpu_torch.parallel import compression as tcodecs
from test_torch_jax_globals import jax_globals  # noqa: F401

ROOT = os.path.normpath(os.path.join(os.path.dirname(__file__), os.pardir))
CODECS = ('2bit', 'fp16', 'int8')
SHAPE = (4, 8)


@pytest.fixture(autouse=True)
def _port_on_cpu():
    with mt.cpu():
        yield


def _rand(seed, shape=SHAPE, scale=1.0):
    return (onp.random.RandomState(seed).randn(*shape) * scale) \
        .astype('float32')


def _both(make):
    """``make(pkg)`` run in the JAX package and in the port."""
    return make(mj), make(mt)


@pytest.mark.parametrize('name', sorted(J_TYPES))
def test_create_every_type(name):
    j, t = _both(lambda pk: pk.kv.create(name))
    assert type(t).__name__ == type(j).__name__
    assert t.type == j.type
    assert (t.rank, t.num_workers) == (j.rank, j.num_workers) == (0, 1)
    assert isinstance(t, mt.kvstore.KVStoreBase)
    assert t.is_capable('optimizer') and not t.is_capable('bogus')


def test_create_refuses_unknown_names():
    for pk in (mj, mt):
        with pytest.raises(pk.MXNetError, match='unknown kvstore type'):
            pk.kv.create('bogus')
        with pytest.raises(pk.MXNetError, match='must be a string'):
            pk.kv.create(3)


def test_dist_kvstore_single_process():
    """tests/test_parallel.py::test_dist_kvstore_single_process."""
    for pk in (mj, mt):
        kv = pk.kvstore.create('dist_sync')
        assert kv.rank == 0 and kv.num_workers == 1
        kv.init(0, pk.nd.ones((2, 2)))
        out = pk.nd.zeros((2, 2))
        kv.push(0, pk.nd.ones((2, 2)) * 3)
        kv.pull(0, out)
        onp.testing.assert_array_equal(out.asnumpy(), onp.full((2, 2), 3.0))


@pytest.mark.parametrize('kind', ['local', 'device', 'dist_sync'])
@pytest.mark.parametrize('copies', [1, 2, 3, 4])
def test_push_pull_copies_match_jax(kind, copies):
    """Two keys, each pushed as ``copies`` arrays in one call, then pulled
    into ``copies`` outputs: the sums are the JAX store's, bitwise."""
    keys = [3, 'w']
    vals = {k: [_rand(10 * i + c) for c in range(copies)]
            for i, k in enumerate(keys)}

    def run(pk):
        kv = pk.kv.create(kind)
        kv.init(keys, [pk.nd.zeros(SHAPE) for _ in keys])
        kv.push(keys, [[pk.nd.array(v) for v in vals[k]] for k in keys])
        outs = [[pk.nd.zeros(SHAPE) for _ in range(copies)] for _ in keys]
        kv.pull(keys, out=outs)
        return [[o.asnumpy() for o in row] for row in outs]
    j, t = _both(run)
    for k, jrow, trow in zip(keys, j, t):
        want = vals[k][0]
        for v in vals[k][1:]:
            want = want + v
        for jo, to in zip(jrow, trow):
            onp.testing.assert_array_equal(to, jo)
            onp.testing.assert_array_equal(to, want)


def test_push_without_init_stores_and_repeated_keys_merge():
    """A key pushed twice in one call is one merged push; a pull of a
    key never stored raises in both."""
    def run(pk):
        kv = pk.kv.create('local')
        kv.push([5, 5], [pk.nd.array(_rand(1)), pk.nd.array(_rand(2))])
        out = pk.nd.zeros(SHAPE)
        kv.pull(5, out=out)
        with pytest.raises(pk.MXNetError, match='not initialized'):
            kv.pull(6, out=pk.nd.zeros(SHAPE))
        return out.asnumpy()
    j, t = _both(run)
    onp.testing.assert_array_equal(t, j)


def test_pushpull_and_broadcast_match_jax():
    a, b = _rand(1), _rand(2)

    def run(pk):
        kv = pk.kv.create('device')
        kv.init(0, pk.nd.zeros(SHAPE))
        ins = [pk.nd.array(a), pk.nd.array(b)]
        kv.pushpull(0, ins)                 # all-reduce into the inputs
        out = pk.nd.zeros(SHAPE)
        kv.pushpull(0, pk.nd.array(a), out=out)
        bc = [pk.nd.zeros(SHAPE), pk.nd.zeros(SHAPE)]
        kv.broadcast(1, pk.nd.array(b), out=bc)
        return [x.asnumpy() for x in ins + [out] + bc]
    j, t = _both(run)
    for jo, to in zip(j, t):
        onp.testing.assert_array_equal(to, jo)
    onp.testing.assert_array_equal(t[0], a + b)
    onp.testing.assert_array_equal(t[3], b)


def test_pull_copies_and_never_aliases_the_store():
    """The pulled array is a copy: changing it leaves the store alone, and
    a pushed array changed afterwards does not reach the store."""
    kv = mt.kv.create('local')
    v = mt.nd.array(_rand(3))
    kv.init(0, mt.nd.zeros(SHAPE))
    kv.push(0, v)
    v._data.add_(1.0)
    out = mt.nd.zeros(SHAPE)
    kv.pull(0, out=out)
    out._data.add_(1.0)
    again = mt.nd.zeros(SHAPE)
    kv.pull(0, out=again)
    onp.testing.assert_array_equal(again.asnumpy(), _rand(3))


@pytest.mark.parametrize('opt, params', [
    ('sgd', {'learning_rate': 0.1, 'momentum': 0.9, 'wd': 0.01}),
    ('adam', {'learning_rate': 0.01})])
def test_set_optimizer_and_states_round_trip(tmp_path, opt, params):
    """The optimizer runs in the store: three pushes against the JAX
    store's (rel 1e-6, see the module docstring), then the states saved
    with the optimizer (its update counts), loaded into a fresh store and
    two more pushes, equal to the store that kept going (bitwise: the
    same torch code)."""
    w0 = _rand(4, scale=0.5)
    grads = [_rand(20 + i) for i in range(5)]

    def make(pk, w):
        kv = pk.kv.create('device')
        kv.set_optimizer(pk.optimizer.create(opt, **params))
        kv.init(0, pk.nd.array(w))
        return kv

    def pushes(pk, kv, gs):
        for g in gs:
            kv.push(0, pk.nd.array(g))
        out = pk.nd.zeros(SHAPE)
        kv.pull(0, out=out)
        return out.asnumpy()
    j = pushes(mj, make(mj, w0), grads[:3])
    kv = make(mt, w0)
    t = pushes(mt, kv, grads[:3])
    onp.testing.assert_allclose(t, j, rtol=1e-6, atol=1e-7)
    path = str(tmp_path / 'states')
    kv.save_optimizer_states(path, dump_optimizer=True)
    fresh = make(mt, t)
    fresh.load_optimizer_states(path)
    kept = pushes(mt, kv, grads[3:])
    onp.testing.assert_array_equal(pushes(mt, fresh, grads[3:]), kept)
    jkv = make(mj, w0)
    pushes(mj, jkv, grads[:3])
    onp.testing.assert_allclose(kept, pushes(mj, jkv, grads[3:]),
                                rtol=1e-6, atol=1e-7)
    with pytest.raises(MXNetError, match='no updater'):
        mt.kv.create('local').save_optimizer_states(path)


def test_set_updater_sees_ndarrays():
    """A user updater gets the merged push and the stored value as
    NDArrays and writes the stored one, as MXNet's does."""
    def run(pk):
        kv = pk.kv.create('local')
        kv.init(0, pk.nd.ones(SHAPE))

        def updater(key, grad, weight):
            weight[:] = weight + 2 * grad
        kv.set_updater(updater)
        kv.push(0, [pk.nd.array(_rand(5)), pk.nd.array(_rand(6))])
        out = pk.nd.zeros(SHAPE)
        kv.pull(0, out=out)
        return out.asnumpy()
    j, t = _both(run)
    onp.testing.assert_array_equal(t, j)


@pytest.mark.parametrize('ctype', CODECS)
@pytest.mark.parametrize('block', [0, 4])
def test_gradient_compression_math_matches_jax(ctype, block):
    """tests/test_parallel.py::test_gradient_compression_math over 5
    pushes of one key: each decoded value and the residual carried after
    it, bitwise the JAX codec's."""
    jgc, tgc = JGC(ctype, 0.5, block), TGC(ctype, 0.5, block)
    assert tgc.get_params() == jgc.get_params()
    for i in range(5):
        g = _rand(30 + i, scale=0.6)
        jo = jgc.compress_decompress(mj.nd.array(g), 'k').asnumpy()
        to = tgc.compress_decompress(mt.nd.array(g), 'k').asnumpy()
        onp.testing.assert_array_equal(to, jo)
        onp.testing.assert_array_equal(tgc._residual['k'].numpy(),
                                       onp.asarray(jgc._residual['k']))


def test_gradient_compression_2bit_reference_values():
    """The reference's numbers (compute_expected_2bit_quantization)."""
    gc = TGC('2bit', threshold=0.5)
    grad = mt.nd.array([0.3, 0.7, -0.6, -0.2])
    onp.testing.assert_array_equal(gc.compress_decompress(grad, 'k')
                                   .asnumpy(), [0.0, 0.5, -0.5, 0.0])
    onp.testing.assert_array_equal(gc.compress_decompress(grad, 'k')
                                   .asnumpy(), [0.5, 0.5, -0.5, 0.0])
    r = gc._residual['k'].numpy()
    onp.testing.assert_allclose(r, [0.1, 0.4, -0.2, -0.4], rtol=1e-6)
    gc.reset()
    assert not gc._residual


def test_transient_nan_does_not_poison_the_residual():
    gc = TGC('2bit', threshold=0.5)
    gc.compress_decompress(mt.nd.array([0.3, 0.7]), 'k')
    before = gc._residual['k'].clone()
    bad = gc.compress_decompress(mt.nd.array([float('nan'), 1.0]), 'k')
    assert not onp.all(onp.isfinite(bad.asnumpy()))
    assert torch.equal(gc._residual['k'], before)
    out = gc.compress_decompress(mt.nd.array([0.3, 0.7]), 'k').asnumpy()
    assert onp.all(onp.isfinite(out))


def test_gradient_compression_validates_like_jax():
    for gc in (JGC, TGC):
        with pytest.raises(Exception, match='block_size'):
            gc('int8', block_size=-64)
        with pytest.raises(Exception, match='threshold'):
            gc('2bit', threshold=-1.0)
        with pytest.raises(Exception, match='not supported'):
            gc('3bit')
        assert gc('none', threshold=0.25).type == 'none'


def test_codec_wire_bytes_math():
    """tests/test_compression.py::test_codec_wire_bytes_math on the port's
    codecs, and each store codec's ``wire_bytes`` equal to the JAX
    one's."""
    c = tcodecs
    assert c.wire_bytes((4, 512), 'fp16') == 2 * 4 * 512
    assert c.wire_bytes((4, 512), 'int8', 256) == 4 * 512 + 4 * (4 * 512 //
                                                                256)
    assert c.wire_bytes((4, 512), '2bit', 256) == \
        (4 * 512 * 2 + 7) // 8 + 4 * (4 * 512 // 256)
    assert c.wire_bytes((4, 512), '2bit', 0) == (4 * 512 * 2 + 7) // 8
    assert c.wire_bytes((7,), 'int8', 256) == 7 + 4
    assert c.wire_bytes((), 'fp16') == 2
    assert c.wire_bytes((4, 512), 'none') == 4 * 4 * 512
    assert c.wire_bytes((4, 512), 'none') / c.wire_bytes(
        (4, 512), '2bit', 0) > 15.9
    for ctype in CODECS:
        for block in (0, 256):
            for shape in ((4, 512), (7,), (), (3, 256)):
                assert TGC(ctype, 0.5, block).wire_bytes(shape) == \
                    JGC(ctype, 0.5, block).wire_bytes(shape)
                assert c.n_scales(shape, block) == \
                    jcodecs.n_scales(shape, block)


def test_resolve_validates_like_jax():
    """tests/test_compression.py::test_resolve_validates_and_reads_knobs
    without the knobs (they pick the compiled step's codec, which waits
    for ROADMAP item 8): the same specs and refusals as the JAX
    package's."""
    c = tcodecs
    assert c.resolve(None) is None
    assert c.resolve({'type': 'none'}) is None
    for params in ({'type': '2bit', 'threshold': 0.25, 'block_size': 128},
                   {'type': 'int8'}, {'type': 'fp16', 'block_size': 0}):
        assert c.resolve(params) == jcodecs.resolve(params)
    with pytest.raises(MXNetError, match='not supported'):
        c.resolve({'type': '3bit'})
    with pytest.raises(MXNetError, match='threshold'):
        c.resolve({'type': '2bit', 'threshold': 0})


@pytest.mark.parametrize('ctype', CODECS)
def test_store_compression_matches_jax(ctype):
    """set_gradient_compression: 5 pushes of two copies each through the
    store, the pulled values bitwise the JAX store's."""
    def run(pk):
        kv = pk.kv.create('device')
        kv.set_gradient_compression({'type': ctype, 'threshold': 0.4})
        kv.init(0, pk.nd.zeros(SHAPE))
        outs = []
        for i in range(5):
            kv.push(0, [pk.nd.array(_rand(40 + i, scale=0.3)),
                        pk.nd.array(_rand(50 + i, scale=0.3))])
            out = pk.nd.zeros(SHAPE)
            kv.pull(0, out=out)
            outs.append(out.asnumpy())
        return outs
    j, t = _both(run)
    for jo, to in zip(j, t):
        onp.testing.assert_array_equal(to, jo)


def test_row_sparse_pull_matches_jax():
    """tests/test_sparse.py::test_kvstore_row_sparse_pull in both."""
    a = onp.random.RandomState(6).uniform(-1, 1, (8, 3)).astype('float32')

    def run(pk):
        kv = pk.kv.create('local')
        kv.init('w', pk.nd.sparse.row_sparse_array(a))
        out = pk.nd.sparse.zeros('row_sparse', (8, 3))
        kv.row_sparse_pull('w', out=out,
                           row_ids=pk.nd.array(onp.array([2, 5])))
        return out.asnumpy()
    j, t = _both(run)
    onp.testing.assert_array_equal(t, j)
    assert onp.array_equal(t[[2, 5]], a[[2, 5]])
    assert (t[[0, 1, 3, 4, 6, 7]] == 0).all()


def test_concurrent_push_pull_from_threads():
    """tests/test_thread_local.py::test_concurrent_kvstore_push_pull:
    threads pushing and pulling distinct keys of one store; each pull
    reads its own key's last push."""
    kv = mt.kv.create('local')
    for k in range(6):
        kv.init(k, mt.nd.zeros((4,), ctx=mt.cpu()))
    errors = []

    def worker(k):
        try:
            with mt.cpu():
                for _ in range(10):
                    kv.push(k, mt.nd.ones((4,)) * (k + 1))
                    out = mt.nd.zeros((4,))
                    kv.pull(k, out=out)
                    assert float(out.asnumpy()[0]) == k + 1
        except Exception as e:  # pragma: no cover
            errors.append((k, e))

    threads = [threading.Thread(target=worker, args=(k,)) for k in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors


def test_push_and_pull_counters_match_jax():
    from mxnet_tpu import telemetry as jtel
    from mxnet_tpu_torch import telemetry as ttel

    def run(pk, tel):
        was = tel.enabled()
        tel.enable()
        tel.reset()
        try:
            kv = pk.kv.create('local')
            kv.init(1, pk.nd.zeros(SHAPE))
            kv.push(1, [pk.nd.ones(SHAPE), pk.nd.ones(SHAPE)])
            kv.pull(1, out=[pk.nd.zeros(SHAPE)])
            kv.pushpull(1, pk.nd.ones(SHAPE), out=pk.nd.zeros(SHAPE))
            return [tel.value(n, key='1') for n in (
                'mxnet_tpu_kvstore_push_total',
                'mxnet_tpu_kvstore_push_bytes_total',
                'mxnet_tpu_kvstore_pull_total',
                'mxnet_tpu_kvstore_pull_bytes_total')] + [
                tel.value('mxnet_tpu_kvstore_pushpull_total')]
        finally:
            tel.reset()
            if not was:
                tel.disable()
    assert run(mt, ttel) == run(mj, jtel) == [2, 384, 2, 256, 1]


def test_collective_fault_site_fires_in_the_reduction():
    from mxnet_tpu_torch.resilience import faults
    kv = mt.kv.create('device')
    kv.init(0, mt.nd.zeros(SHAPE))
    faults.arm('collective.all_reduce', 'raise', window=2)
    try:
        kv.push(0, mt.nd.ones(SHAPE))
        with pytest.raises(faults.InjectedFault):
            kv.push(0, mt.nd.ones(SHAPE))
    finally:
        faults.disarm()
    kv.barrier()


def test_server_role_noop():
    from mxnet_tpu_torch.kvstore_server import KVStoreServer, \
        _init_kvstore_server_module
    assert KVStoreServer(None).run() is None
    assert _init_kvstore_server_module() is False


def test_server_role_process_exits_at_import():
    """A DMLC_ROLE=server process exits at import, before the script's
    body runs (tests/test_misc_modules.py's case, for the port)."""
    r = subprocess.run(
        [sys.executable, '-c',
         'import mxnet_tpu_torch; print("SHOULD_NOT_RUN")'],
        capture_output=True, text=True, timeout=120, cwd=ROOT,
        env={**os.environ, 'DMLC_ROLE': 'server', 'PYTHONPATH': ROOT})
    assert r.returncode == 0, r.stderr
    assert 'SHOULD_NOT_RUN' not in r.stdout


# -- the Trainer's seams ------------------------------------------------------

IN, OUT, N = 6, 5, 4


def _weights():
    rng = onp.random.RandomState(7)
    return (rng.randn(OUT, IN).astype('float32') * 0.3,
            rng.randn(OUT).astype('float32') * 0.1)


def _batches(steps=3):
    rng = onp.random.RandomState(8)
    return [rng.randn(N, IN).astype('float32') for _ in range(steps)]


def _jax_run(opt, params, steps=3, **kw):
    net = mj.gluon.nn.Dense(OUT, in_units=IN)
    net.initialize()
    w, b = _weights()
    net.weight.set_data(mj.nd.array(w))
    net.bias.set_data(mj.nd.array(b))
    if isinstance(kw.get('kvstore'), str) and kw.pop('kv_object', False):
        kw['kvstore'] = mj.kv.create(kw['kvstore'])
    tr = mj.gluon.Trainer(net.collect_params(), opt, dict(params), **kw)
    for x in _batches(steps):
        with mj.autograd.record():
            loss = (net(mj.nd.array(x)) ** 2).sum()
        loss.backward()
        tr.step(N)
    return [net.weight.data().asnumpy(), net.bias.data().asnumpy()], tr


def _port_run(opt, params, steps=3, **kw):
    net = mt.gluon.nn.Dense(OUT, in_units=IN)
    net.initialize()
    w, b = _weights()
    net.weight.set_data(mt.nd.array(w))
    net.bias.set_data(mt.nd.array(b))
    if isinstance(kw.get('kvstore'), str) and kw.pop('kv_object', False):
        kw['kvstore'] = mt.kv.create(kw['kvstore'])
    tr = mt.gluon.Trainer(net.collect_params(), opt, dict(params), **kw)
    for x in _batches(steps):
        with mt.autograd.record():
            loss = (net(mt.nd.array(x)) ** 2).sum()
        loss.backward()
        tr.step(N)
    return [net.weight.data().asnumpy(), net.bias.data().asnumpy()], tr


SEAMS = {
    'update_on_kvstore': dict(kvstore='device', update_on_kvstore=True),
    'update_on_kvstore_local_object': dict(kvstore='local', kv_object=True,
                                           update_on_kvstore=True),
    'kv_object': dict(kvstore='dist_sync', kv_object=True),
    **{f'{c}_on_kvstore': dict(kvstore='device', update_on_kvstore=True,
                               compression_params={'type': c,
                                                   'threshold': 0.2})
       for c in CODECS},
    **{f'{c}_in_place': dict(kvstore='device',
                             compression_params={'type': c,
                                                 'threshold': 0.2})
       for c in CODECS},
    **{f'{c}_no_kvstore': dict(kvstore=None,
                               compression_params={'type': c,
                                                   'threshold': 0.2})
       for c in CODECS},
}


@pytest.mark.parametrize('opt, params', [
    ('sgd', {'learning_rate': 0.05, 'momentum': 0.9, 'wd': 0.01}),
    ('adam', {'learning_rate': 0.01})])
@pytest.mark.parametrize('seam', sorted(SEAMS))
def test_trainer_seams_match_jax(seam, opt, params):
    j, jtr = _jax_run(opt, params, **dict(SEAMS[seam]))
    t, ttr = _port_run(opt, params, **dict(SEAMS[seam]))
    for tv, jv in zip(t, j):
        onp.testing.assert_allclose(tv, jv, rtol=1e-5, atol=1e-7)
    assert ttr._update_on_kvstore == jtr._update_on_kvstore
    if 'compression_params' in SEAMS[seam]:
        # the codec ran, and carries a residual per parameter index
        comp = ttr._compression() or ttr._kvstore._compression
        assert sorted(comp._residual) == [0, 1]
    else:
        # the store's per-parameter update is the fused update's within
        # f32 rounding (a few ulp of the weights)
        plain, _ = _port_run(opt, params)
        for a, b in zip(t, plain):
            onp.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)


def test_trainer_update_on_kvstore_states_round_trip():
    """With the optimizer in the store, the states payload is the store's;
    restored into a second Trainer it continues as the first, bitwise."""
    params = {'learning_rate': 0.01}
    _, tr = _port_run('adam', params, kvstore='device',
                      update_on_kvstore=True,
                      compression_params={'type': '2bit'})
    comp = tr._kvstore._compression
    assert comp._residual
    blob = tr.get_states_bytes()
    assert pickle.loads(blob)[0].keys() == {0, 1}
    tr.set_states_bytes(blob)
    assert not comp._residual
    assert tr._kvstore._updater.states.keys() == {0, 1}


@pytest.mark.parametrize('restore', ['checkpoint', 'set_data'])
def test_trainer_update_on_kvstore_resumes_from_a_restore(tmp_path, restore):
    """With the optimizer in the store, a restore is where the next step
    starts (MXNet resets the store in ``Parameter.set_data`` for this):
    saved after step 2, stepped, restored (a CheckpointManager restore,
    or ``set_data`` and ``set_states_bytes``) and stepped again, the
    weights and states are those of the first step 3, bitwise."""
    from mxnet_tpu_torch.checkpoint import CheckpointManager
    net = mt.gluon.nn.Dense(OUT, in_units=IN)
    net.initialize()
    w, b = _weights()
    net.weight.set_data(mt.nd.array(w))
    net.bias.set_data(mt.nd.array(b))
    tr = mt.gluon.Trainer(net.collect_params(), 'adam',
                          {'learning_rate': 0.01}, kvstore='device',
                          update_on_kvstore=True)
    xs = _batches(3)

    def step(x):
        with mt.autograd.record():
            loss = (net(mt.nd.array(x)) ** 2).sum()
        loss.backward()
        tr.step(N)

    def weights():
        return [net.weight.data().asnumpy(), net.bias.data().asnumpy()]
    step(xs[0])
    step(xs[1])
    saved, blob = weights(), tr.get_states_bytes()
    mgr = CheckpointManager(str(tmp_path), params=net, trainer=tr)
    mgr.save(2, block=True)
    step(xs[2])
    want, want_states = weights(), tr.get_states_bytes()
    if restore == 'checkpoint':
        assert mgr.restore_latest() == 2
    else:
        net.weight.set_data(mt.nd.array(saved[0]))
        net.bias.set_data(mt.nd.array(saved[1]))
        tr.set_states_bytes(blob)
    mgr.close()
    for got, s in zip(weights(), saved):
        onp.testing.assert_array_equal(got, s)
    step(xs[2])
    for got, s in zip(weights(), want):
        onp.testing.assert_array_equal(got, s)
    got_states, want_states = (pickle.loads(x)[0]
                               for x in (tr.get_states_bytes(), want_states))
    for k in want_states:
        for a, e in zip(got_states[k], want_states[k]):
            onp.testing.assert_array_equal(a, e)


def test_trainer_refuses_an_unknown_codec_and_store():
    for kw in (dict(compression_params={'type': 'bogus'}),
               dict(kvstore='bogus')):
        with pytest.raises(MXNetError):
            _port_run('sgd', {'learning_rate': 0.1}, steps=1, **kw)
        with pytest.raises(mj.MXNetError):
            _jax_run('sgd', {'learning_rate': 0.1}, steps=1, **kw)
