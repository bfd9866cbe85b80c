"""ZeRO-1 over ``torch.distributed``: the port's ``ShardedTrainStep`` and
``gluon.Trainer`` at dp = 2 and 4 against the JAX package's on a CPU mesh
of the same size (``tests/test_zero1.py`` mirrored).

Worlds of 2 and 4 gloo ranks run once for the module (``launch_local``,
a ``FileStore`` under ``tmp_path``, one thread per rank, 120 s each, then
every rank is killed). Every rank gets the same weights (the JAX net's
arrays by structured name) and its rows of the same numpy-seeded global
batch (64 x 16, 8 classes), and pickles what it read; the worker imports
only the port and numpy. The dp = 2 world restores the payload the dp = 4
world saved. The JAX references run here, each JAX block with a prefix,
so no JAX name counter moves.
"""
import os
import pickle
import threading

import numpy as onp
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import autograd as jautograd
from mxnet_tpu import gluon as jgluon
from mxnet_tpu import nd
from mxnet_tpu.base import MXNetError as JMXNetError
from mxnet_tpu.parallel import ShardedTrainStep as JStep
from mxnet_tpu.parallel import make_mesh as jmake_mesh
from mxnet_tpu.parallel.step import compose_zero_spec as j_compose
from jax.sharding import PartitionSpec as JP
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.parallel import dist
from mxnet_tpu_torch.parallel.step import P, compose_zero_spec


@pytest.fixture(autouse=True, scope='module')
def _jax_name_counters():
    """The JAX package's global block-name counters as this file found
    them, put back after it: its unnamed JAX blocks would otherwise move
    the prefixes of reference tests that run later in the same worker
    (``tests/test_zero3.py`` and ``test_zero1.py`` pair parameters by
    sorted prefixed names, ROADMAP queue 3)."""
    from mxnet_tpu.gluon.block import _BlockScope
    saved = dict(_BlockScope._global_counter)
    yield
    _BlockScope._global_counter.clear()
    _BlockScope._global_counter.update(saved)


ROOT = os.path.normpath(os.path.join(os.path.dirname(__file__), os.pardir))
WORLD_TIMEOUT = 120.0
OPTS = ('adam', 'adamw', 'lamb')
TOL = 1e-6

WORKER = r'''
import os, pickle, sys, time
import numpy as onp
import torch
torch.set_num_threads(1)
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd, gluon, parallel, telemetry
from mxnet_tpu_torch.gluon import nn
from mxnet_tpu_torch.parallel import dist

tmp, name = sys.argv[1], sys.argv[2]
dist.init(device='cpu')
r, n = dist.rank(), dist.num_workers()
ref = onp.load(os.path.join(tmp, 'ref.npz'))
W = {k[2:]: ref[k] for k in ref.files if k.startswith('w:')}
x, y = ref['x'], ref['y']
b = x.shape[0] // n
xs, ys = torch.from_numpy(x[r * b:(r + 1) * b]), \
    torch.from_numpy(y[r * b:(r + 1) * b])
mesh = parallel.make_mesh((n,), ('dp',), devices=['cpu'])
out = {}


def net_with(weights):
    with mx.cpu():
        net = nn.HybridSequential()
        net.add(nn.Dense(32, activation='relu', in_units=16))
        net.add(nn.Dense(8, in_units=32))
        net.initialize()
    net.load_state_dict({k: torch.from_numpy(v) for k, v in weights.items()})
    return net


def weights(net):
    return {k: p.detach().numpy().copy() for k, p in net.named_parameters()}


def step_of(net, opt='adamw', **kw):
    return parallel.ShardedTrainStep(
        net, gluon.loss.SoftmaxCrossEntropyLoss(), opt,
        {'learning_rate': 0.01}, mesh=mesh, **kw)


for opt in ('adam', 'adamw', 'lamb'):
    for zero in (True, False):
        net = net_with(W)
        st = step_of(net, opt, zero=zero)
        losses = [float(st(xs, ys)) for _ in range(3)]
        out[('run', opt, zero)] = dict(
            losses=losses, weights=weights(net), zero=st.zero,
            specs={k: v for k, v in st.zero_specs.items()},
            opt_bytes=st.opt_state_bytes_per_device(),
            param_bytes=st.param_bytes_per_device(),
            comm=st.comm_bytes_per_hop(), mem=st.memory_analysis(),
            moment_shapes={k: tuple(s[0].shape)
                           for k, s in st._state.items()})

# the comm telemetry contract
telemetry.enable()
telemetry.reset()
st = step_of(net_with(W), zero=True)
for _ in range(2):
    st(xs, ys)
V = telemetry.value
out['telem_zero'] = dict(
    rs=V('mxnet_tpu_comm_collective_bytes_total', kind='reduce_scatter',
         axis='dp', stage='zero1'),
    ag=V('mxnet_tpu_comm_collective_bytes_total', kind='all_gather',
         axis='dp', stage='zero1'),
    n_rs=V('mxnet_tpu_comm_collectives_total', kind='reduce_scatter',
           axis='dp', stage='zero1'),
    gauge=V('mxnet_tpu_comm_opt_state_bytes_per_device'),
    method=st.opt_state_bytes_per_device(), params=len(st._trainable))
telemetry.reset()
st = step_of(net_with(W), zero=False)
for _ in range(2):
    st(xs, ys)
out['telem_off'] = dict(
    ar=V('mxnet_tpu_comm_collective_bytes_total', kind='all_reduce',
         axis='dp', stage='off'),
    rs=V('mxnet_tpu_comm_collective_bytes_total', kind='reduce_scatter',
         axis='dp', stage='off'),
    gauge=V('mxnet_tpu_comm_opt_state_bytes_per_device'))
telemetry.disable()

# the MXTPU_ZERO gate
os.environ['MXTPU_ZERO'] = '0'
gate = [step_of(net_with(W)).zero, step_of(net_with(W), zero=True).zero]
del os.environ['MXTPU_ZERO']
gate.append(step_of(net_with(W)).zero)
out['gate'] = gate

# states across dp: the dp = 4 world saves, the dp = 2 world restores
saved = os.path.join(tmp, 'states_dp4.pkl')
if n == 4:
    net = net_with(W)
    st = step_of(net, zero=True)
    for _ in range(3):
        st(xs, ys)
    blob3, w3 = st.get_states_bytes(), weights(net)
    st(xs, ys)
    doc = dict(blob3=blob3, w3=w3, blob4=st.get_states_bytes(),
               w4=weights(net))
    if r == 0:
        with open(saved + '.tmp', 'wb') as f:
            pickle.dump(doc, f)
        os.replace(saved + '.tmp', saved)
else:
    deadline = time.monotonic() + 90
    while not os.path.exists(saved) and time.monotonic() < deadline:
        time.sleep(0.2)
    with open(saved, 'rb') as f:
        doc = pickle.load(f)
    for zero in (True, False):
        net = net_with(doc['w3'])
        st = step_of(net, zero=zero)
        st.set_states_bytes(doc['blob3'])
        st(xs, ys)
        out[('restored', zero)] = dict(blob=st.get_states_bytes(),
                                       weights=weights(net))
        st.set_states_bytes(doc['blob3'])
        out[('roundtrip', zero)] = st.get_states_bytes()
    fresh = step_of(net_with(W))
    try:
        fresh.get_states_bytes()
        out['fresh'] = 'ran'
    except Exception as e:
        out['fresh'] = str(e)
    fresh.set_states_bytes(doc['blob3'])
    out['pending'] = fresh.get_states_bytes()


# the Trainer
def trainer_run(kvstore='device', steps=3, global_batch=False):
    net = net_with(W)
    tr = gluon.Trainer(net.collect_params(), 'adam',
                       {'learning_rate': 0.01}, kvstore=kvstore)
    lf = gluon.loss.SoftmaxCrossEntropyLoss()
    xa, ya = (torch.from_numpy(x), torch.from_numpy(y)) if global_batch \
        else (xs, ys)
    for _ in range(steps):
        with autograd.record():
            loss = lf(net(mx.nd.array(xa, ctx=mx.cpu())),
                      mx.nd.array(ya, ctx=mx.cpu()))
        loss.backward()
        tr.step(x.shape[0])
    return net, tr


net_z, tr_z = trainer_run()
net_p, tr_p = trainer_run(kvstore=None, global_batch=True)
blob = tr_z.get_states_bytes()
out['trainer'] = dict(
    zero=(tr_z._zero_active, tr_z._zero_dp), plain_zero=tr_p._zero_active,
    weights=weights(net_z), plain_weights=weights(net_p),
    opt_bytes=tr_z.opt_state_bytes_per_device(),
    plain_opt_bytes=tr_p.opt_state_bytes_per_device(),
    param_bytes=tr_z.param_bytes_per_device(), blob=blob)
tr_p.set_states_bytes(blob)
out['trainer']['restored'] = tr_p.get_states_bytes()
tr_z.set_states_bytes(blob)
with autograd.record():
    loss = gluon.loss.SoftmaxCrossEntropyLoss()(
        net_z(mx.nd.array(xs, ctx=mx.cpu())), mx.nd.array(ys, ctx=mx.cpu()))
loss.backward()
tr_z.step(x.shape[0])
out['trainer']['after_restore'] = (tr_z._zero_active, weights(net_z))
os.environ['MXTPU_ZERO'] = '0'
_, tr_off = trainer_run(steps=2)
del os.environ['MXTPU_ZERO']
out['trainer_gate'] = dict(
    zero=tr_off._zero_active,
    shapes=[tuple(s.shape) for st in tr_off._updater.states.values()
            for s in st])
with open(os.path.join(tmp, f'{name}_r{r}.pkl'), 'wb') as f:
    pickle.dump(out, f)
dist.shutdown()
'''


def _jnet():
    net = jgluon.nn.HybridSequential(prefix='zt_')
    with net.name_scope():
        net.add(jgluon.nn.Dense(32, activation='relu', in_units=16,
                                prefix='d0_'))
        net.add(jgluon.nn.Dense(8, in_units=32, prefix='d1_'))
    net.initialize(mx.init.Xavier())
    return net


def _data():
    rng = onp.random.RandomState(0)
    return rng.randn(64, 16).astype(onp.float32), \
        rng.randint(0, 8, 64).astype(onp.float32)


@pytest.fixture(scope='module')
def arrays():
    mx.random.seed(0)
    net = _jnet()
    return {k: v.data().asnumpy()
            for k, v in net._collect_params_with_prefix().items()}


def _jnet_with(arrays):
    net = _jnet()
    for k, p in net._collect_params_with_prefix().items():
        p.set_data(nd.array(arrays[k]))
    return net


def _jweights(net):
    return {k: p.data().asnumpy()
            for k, p in net._collect_params_with_prefix().items()}


@pytest.fixture(scope='module')
def worlds(tmp_path_factory, arrays):
    tmp = tmp_path_factory.mktemp('zero1')
    x, y = _data()
    onp.savez(tmp / 'ref.npz', x=x, y=y,
              **{f'w:{k}': v for k, v in arrays.items()})
    script = tmp / 'worker.py'
    script.write_text(WORKER)
    codes = {}

    def run(n):
        codes[n] = dist.launch_local(
            [str(script), str(tmp), f'dp{n}'], n=n,
            env={'OMP_NUM_THREADS': '1', 'PYTHONPATH': ROOT},
            coordinator=f'file://{tmp}/dp{n}.store', timeout=WORLD_TIMEOUT)

    threads = [threading.Thread(target=run, args=(n,)) for n in (2, 4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    out = {}
    for n in (2, 4):
        assert codes[n] == [0] * n, (n, codes[n])
        out[n] = [pickle.loads((tmp / f'dp{n}_r{r}.pkl').read_bytes())
                  for r in range(n)]
    out['dp4_doc'] = pickle.loads((tmp / 'states_dp4.pkl').read_bytes())
    return out


_JAX_RUNS = {}


def _jax_run(arrays, opt, n, zero=True):
    key = (opt, n, zero)
    if key not in _JAX_RUNS:
        net = _jnet_with(arrays)
        step = JStep(net, jgluon.loss.SoftmaxCrossEntropyLoss(), opt,
                     {'learning_rate': 0.01}, mesh=jmake_mesh((n,), ('dp',)),
                     zero=zero)
        x, y = _data()
        losses = [float(step(nd.array(x), nd.array(y)).asscalar())
                  for _ in range(3)]
        _JAX_RUNS[key] = (losses, _jweights(net), step)
    return _JAX_RUNS[key]


def _max_diff(a, b):
    return max(float(onp.max(onp.abs(a[k] - b[k]))) for k in b)


@pytest.mark.parametrize('n', [2, 4])
@pytest.mark.parametrize('opt', OPTS)
def test_zero1_parity_vs_replicated_and_jax(worlds, arrays, opt, n):
    """3 steps: the ZeRO-1 step matches the replicated one and the JAX
    step on a mesh of the same size, losses and weights within 1e-6 in
    f32, on every rank."""
    jl, jw, _ = _jax_run(arrays, opt, n)
    for o in worlds[n]:
        z, rep = o[('run', opt, True)], o[('run', opt, False)]
        assert z['zero'] and not rep['zero']
        for a, b, c in zip(z['losses'], rep['losses'], jl):
            assert abs(a - b) <= TOL and abs(a - c) <= TOL, \
                (z['losses'], rep['losses'], jl)
        assert _max_diff(z['weights'], rep['weights']) <= TOL
        assert _max_diff(z['weights'], jw) <= TOL, (opt, n)


@pytest.mark.parametrize('n', [2, 4])
def test_zero1_state_is_sharded_one_over_dp(worlds, arrays, n):
    """Each moment holds 1/dp of its tensor along the JAX layout's dim,
    and the per-device byte counts equal the JAX step's at the same net
    and dp (its update counts, one int32 per parameter, included)."""
    _, _, jz = _jax_run(arrays, 'adamw', n)
    _, _, jr = _jax_run(arrays, 'adamw', n, zero=False)
    names = {f'{i}.{k}': f'zt_d{i}_{k}' for i in (0, 1)
             for k in ('weight', 'bias')}
    for o in worlds[n]:
        z, rep = o[('run', 'adamw', True)], o[('run', 'adamw', False)]
        for k, shape in z['moment_shapes'].items():
            full = arrays[k].shape
            spec = z['specs'][k]
            assert tuple(spec) == tuple(jz.zero_specs[names[k]]), k
            d = list(spec).index('dp')
            assert shape == (full[d] // n,) + full[:d] + full[d + 1:]
        assert z['opt_bytes'] == jz.opt_state_bytes_per_device()
        assert rep['opt_bytes'] == jr.opt_state_bytes_per_device()
        assert z['param_bytes'] == jz.param_bytes_per_device()
        assert rep['opt_bytes'] / n <= z['opt_bytes'] <= rep['opt_bytes'] / n \
            + 4 * 4


@pytest.mark.parametrize('n', [2, 4])
def test_zero1_comm_accounting_equals_jax(worlds, arrays, n):
    _, _, jz = _jax_run(arrays, 'adamw', n)
    _, _, jr = _jax_run(arrays, 'adamw', n, zero=False)
    for o in worlds[n]:
        assert o[('run', 'adamw', True)]['comm'] == jz.comm_bytes_per_hop()
        assert o[('run', 'adamw', False)]['comm'] == jr.comm_bytes_per_hop()


@pytest.mark.parametrize('n', [2, 4])
def test_zero1_memory_analysis_buckets(worlds, n):
    """The JAX step's bucket table: the tracked pools are this rank's
    parameters and (sharded) optimizer state, and the activation bucket
    is the peak minus them, so the buckets sum to the peak."""
    for o in worlds[n]:
        for zero in (True, False):
            run = o[('run', 'adamw', zero)]
            m = run['mem']
            b = m['buckets_bytes']
            assert m['dp'] == n and m['zero_stage'] == int(zero)
            assert b['params'] == run['param_bytes']
            assert b['optimizer_state'] == run['opt_bytes']
            assert sum(b.values()) == m['peak_bytes_per_device']
            assert b['activations_temp'] >= 0


@pytest.mark.parametrize('n', [2, 4])
def test_zero1_comm_telemetry_accounting(worlds, n):
    """ZeRO swaps the all-reduce for a reduce-scatter and an all-gather
    at the same ring bytes, one reduce-scatter per parameter per step,
    and the gauge is the method's figure."""
    for o in worlds[n]:
        tz, to = o['telem_zero'], o['telem_off']
        assert tz['rs'] and tz['ag'] and tz['rs'] == tz['ag']
        assert tz['n_rs'] == 2 * tz['params']
        assert tz['gauge'] == tz['method']
        assert to['rs'] is None
        assert to['ar'] == tz['rs'] + tz['ag']
        assert to['gauge'] >= (n - 1) * tz['gauge']


@pytest.mark.parametrize('n', [2, 4])
def test_zero1_flag_gate(worlds, n):
    for o in worlds[n]:
        assert o['gate'] == [False, True, True]


def _states(blob):
    return pickle.loads(blob)['opt_state']


def test_zero1_checkpoint_dp4_to_dp2_bit_parity(worlds):
    """States saved under ZeRO at dp = 4 restore at dp = 2 under ZeRO and
    without it: one more step lands where the saving world's fourth step
    landed (1e-6), and the payload round trip (and a restore before the
    first step) is bit-identical."""
    ranks2 = worlds[2]
    doc = worlds['dp4_doc']
    ref4, w4 = pickle.loads(doc['blob4']), doc['w4']
    saved = pickle.loads(doc['blob3'])
    assert saved['zero'] and saved['dp'] == 4
    for o in ranks2:
        for zero in (True, False):
            got = pickle.loads(o[('restored', zero)]['blob'])
            assert got['dp'] == 2 and got['zero'] == zero
            for k in ref4['opt_state']:
                for a, b in zip(ref4['opt_state'][k], got['opt_state'][k]):
                    assert onp.allclose(a, b, rtol=0, atol=TOL), (zero, k)
            assert _max_diff(o[('restored', zero)]['weights'], w4) <= TOL
            rt = _states(o[('roundtrip', zero)])
            for k, st in saved['opt_state'].items():
                for a, b in zip(st, rt[k]):
                    assert onp.array_equal(a, b), (zero, k)
        assert 'no optimizer state yet' in o['fresh']
        pend = _states(o['pending'])
        for k, st in saved['opt_state'].items():
            for a, b in zip(st, pend[k]):
                assert onp.array_equal(a, b), k


def _jax_trainer(arrays, steps=3):
    net = _jnet_with(arrays)
    x, y = _data()
    xs, ys = nd.array(x), nd.array(y)
    tr = jgluon.Trainer(net.collect_params(), 'adam',
                        {'learning_rate': 0.01})
    loss_fn = jgluon.loss.SoftmaxCrossEntropyLoss()
    for _ in range(steps):
        with jautograd.record():
            loss = loss_fn(net(xs), ys)
        loss.backward()
        tr.step(x.shape[0])
    return _jweights(net)


@pytest.mark.parametrize('n', [2, 4])
def test_trainer_zero1_parity_and_sharded_states(worlds, arrays, n):
    """The Trainer over the world's ranks activates ZeRO in the fused
    update (default-on), shards the Adam moments 1/dp, and trains like
    the one-process Trainer on the global batch and the JAX Trainer."""
    jw = _jax_trainer(arrays)
    for o in worlds[n]:
        t = o['trainer']
        assert t['zero'] == (True, n) and not t['plain_zero']
        assert _max_diff(t['weights'], t['plain_weights']) <= TOL
        assert _max_diff(t['weights'], jw) <= TOL
        assert t['plain_opt_bytes'] / n <= t['opt_bytes'] <= \
            t['plain_opt_bytes'] / n + 4 * 4
        assert t['param_bytes'] == sum(v.nbytes for v in arrays.values())


@pytest.mark.parametrize('n', [2, 4])
def test_trainer_zero1_restore_into_non_zero_trainer(worlds, n):
    """States saved under ZeRO restore bit-identical into a trainer
    without ZeRO, and the ZeRO trainer takes its own payload back."""
    for o in worlds[n]:
        t = o['trainer']
        a, b = pickle.loads(t['blob'])[0], pickle.loads(t['restored'])[0]
        assert set(a) == set(b)
        for k in a:
            for la, lb in zip(_leaves(a[k]), _leaves(b[k])):
                assert onp.array_equal(la, lb), k
        zero, w = t['after_restore']
        assert zero and all(onp.isfinite(v).all() for v in w.values())


def _leaves(s):
    if isinstance(s, (list, tuple)):
        for x in s:
            yield from _leaves(x)
    elif s is not None:
        yield onp.asarray(s)


@pytest.mark.parametrize('n', [2, 4])
def test_trainer_zero1_flag_gate(worlds, arrays, n):
    for o in worlds[n]:
        g = o['trainer_gate']
        assert not g['zero']
        assert sorted(g['shapes']) == sorted(
            v.shape for v in arrays.values() for _ in range(2))


def test_compose_zero_spec_rules():
    """tests/test_zero1.py::test_compose_zero_spec_rules, case for case,
    on both packages."""
    cases = [((32, 16), ('tp', None), 4), ((32, 16), ('dp', None), 4),
             ((32, 16), (('tp', 'dp'), None), 4), ((32, 16), (None, 'tp'), 4),
             ((32,), (), 8), ((3,), (), 8), ((12,), (), 8), ((), (), 8)]
    want = [('tp', 'dp'), None, None, ('dp', 'tp'), ('dp',), None, None, None]
    for (shape, spec, dp), w in zip(cases, want):
        got = compose_zero_spec(shape, P(*spec), 'dp', dp)
        ref = j_compose(shape, JP(*spec), 'dp', dp)
        assert (None if got is None else tuple(got)) == w
        assert (None if ref is None else tuple(ref)) == w
    with pytest.raises(MXNetError, match='not divisible'):
        compose_zero_spec((12, 16), P('dp', None), 'dp', 8)
    with pytest.raises(JMXNetError, match='not divisible'):
        j_compose((12, 16), JP('dp', None), 'dp', 8)


def test_refusals_name_their_roadmap_items(arrays):
    """What this slice leaves out raises by name: tensor parallelism
    (item 6a); the distributed kvstores, compression and
    update_on_kvstore are item 8. A parameter sharded over dp between
    steps (the fsdp-style param_specs, ZeRO-3's layout, item 7) is
    accepted, as the JAX step accepts it: at dp = 1 nothing shards and the
    step trains as without the spec."""
    from mxnet_tpu_torch import gluon, parallel
    from mxnet_tpu_torch.gluon import nn
    with torch.device('cpu'):
        net = nn.HybridSequential()
        net.add(nn.Dense(4, in_units=3, device='cpu'))
        net.initialize()
    mesh = parallel.make_mesh(devices=['cpu'])
    loss = gluon.loss.L2Loss()
    x, y = torch.ones(2, 3), torch.zeros(2, 4)
    w0 = net[0].weight.data().asnumpy().copy()
    step = parallel.ShardedTrainStep(net, loss, 'adamw', mesh=mesh,
                                     param_specs={'0.weight': ('dp', None)})
    step(x, y)
    assert step.zero_stage == 0 and step.zero_specs['0.weight'] is None
    assert not onp.array_equal(net[0].weight.data().asnumpy(), w0)
    with pytest.raises(MXNetError, match='item 6a'):
        parallel.ShardedTrainStep(net, loss, 'adamw', mesh=mesh,
                                  param_specs={'0.weight': (None, 'tp')})
    params = net.collect_params()
    for kw in (dict(kvstore='dist_sync'),
               dict(compression_params={'type': '2bit'}),
               dict(update_on_kvstore=True)):
        with pytest.raises(MXNetError, match='item 8'):
            gluon.Trainer(params, 'sgd', **kw)
