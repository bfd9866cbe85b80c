"""ZeRO-3 in the port's ``ShardedTrainStep`` over ``torch.distributed``,
against the JAX step's stage 3 on a CPU mesh of the same size
(``tests/test_zero3.py`` mirrored): the parameters themselves live 1/dp
between steps, each layer group is all-gathered before its first use and
regathered in the backward, the gradients reduce-scatter into the shard
update.

Worlds of 2 and 4 gloo ranks run once for the module (``launch_local``,
a ``FileStore`` under ``tmp_path``, 120 s each, then every rank is
killed). Every rank gets the same weights (the JAX nets' arrays by
structured name) and its rows of the same numpy-seeded global batch, and
pickles what it read; the worker imports only the port and numpy. The
dp = 2 world restores the payload the dp = 4 world saved. The JAX
references run here, each JAX block with a prefix, so no JAX name
counter moves. f32 throughout: parity within 1e-6 (the JAX suite's
bound), ZeRO-3 against ZeRO-1 bit for bit.

The non-finite guard and ``CheckpointManager`` cases at stage 3 are in
tests/test_torch_resilience.py (a NaN rank skipping on every rank) and
tests/test_torch_checkpoint.py (a dp-2 checkpoint restored at dp 1).
Left out, each named: the tensor-parallel composition (item 6a), and the
Trainer's stage 3 (what remains of item 7: the port's Trainer raises at
``MXTPU_ZERO=3`` with dp > 1, which
``test_trainer_zero3_raises_where_the_jax_trainer_shards`` shows).
"""
import os
import pickle
import threading

import jax
import numpy as onp
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as JP

import mxnet_tpu as mx
from mxnet_tpu import gluon as jgluon
from mxnet_tpu import nd
from mxnet_tpu.parallel import ShardedTrainStep as JStep
from mxnet_tpu.parallel import make_mesh as jmake_mesh
from mxnet_tpu.parallel.collectives import ordered_barrier as j_barrier
from mxnet_tpu.parallel.step import zero3_layout as j_layout
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.parallel import dist
from mxnet_tpu_torch.parallel.collectives import ordered_barrier
from mxnet_tpu_torch.parallel.step import P, zero3_layout
from test_torch_jax_globals import jax_globals  # noqa: F401


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
from mxnet_tpu_torch import gluon, parallel, telemetry
from mxnet_tpu_torch.gluon import nn
from mxnet_tpu_torch.models.bert import BertForPretraining, \
    bert_pretrain_loss, dp_generators
from mxnet_tpu_torch.parallel import dist

tmp, name = sys.argv[1], sys.argv[2]
dist.init(device='cpu')
r, n = dist.rank(), dist.num_workers()
ref = onp.load(os.path.join(tmp, 'ref.npz'))
mesh = parallel.make_mesh((n,), ('dp',), devices=['cpu'])
out = {}


def rows(a):
    b = a.shape[0] // n
    return torch.from_numpy(a[r * b:(r + 1) * b])


def net_with(prefix, sizes):
    with mx.cpu():
        net = nn.HybridSequential()
        net.add(nn.Dense(sizes[1], activation='relu', in_units=sizes[0]))
        net.add(nn.Dense(sizes[2], in_units=sizes[1]))
        net.initialize()
    net.load_state_dict({k[len(prefix):]: torch.from_numpy(ref[k])
                         for k in ref.files if k.startswith(prefix)})
    return net


def step_of(net, opt='adamw', **kw):
    return parallel.ShardedTrainStep(
        net, gluon.loss.SoftmaxCrossEntropyLoss(), opt,
        {'learning_rate': 0.01}, mesh=mesh, **kw)


def full(st):
    return {k: v.numpy().copy() for k, v in st.full_parameters().items()}


NETS = {'even': ('w:', (16, 32, 8), 'x', 'y'),
        'ragged': ('g:', (13, 19, 7), 'gx', 'gy')}


def run(kind, opt, zero, steps=3):
    prefix, sizes, xk, yk = NETS[kind]
    net = net_with(prefix, sizes)
    st = step_of(net, opt, zero=zero)
    xs, ys = rows(ref[xk]), rows(ref[yk])
    losses = [float(st(xs, ys)) for _ in range(steps)]
    blob = st.get_states_bytes()
    return st, dict(
        losses=losses, weights=full(st), stage=st.zero_stage,
        stats=st.stats(), param_bytes=st.param_bytes_per_device(),
        opt_bytes=st.opt_state_bytes_per_device(),
        pad_bytes=st.opt_state_pad_bytes, comm=st.comm_bytes_per_hop(),
        layouts=st.zero3_layouts, groups=st._z3.groups if st._z3 else None,
        gather_plan=list(st._gather_plan), mem=st.memory_analysis(),
        held={k: tuple(v.shape) for k, v in st._held().items()},
        masters={k: tuple(v.shape) for k, v in st._master.items()},
        blob=blob)


for opt in ('adam', 'adamw', 'lamb'):
    for zero in (0, 1, 3):
        out[('run', opt, zero)] = run('even', opt, zero)[1]
for zero in (0, 3):
    out[('ragged', zero)] = run('ragged', 'adamw', zero)[1]

# the comm telemetry contract at stage 3
telemetry.enable()
telemetry.reset()
st, _ = run('even', 'adamw', 3, steps=2)
V = telemetry.value
out['telem'] = dict(
    ag=V('mxnet_tpu_comm_collective_bytes_total', kind='all_gather',
         axis='dp', stage='zero3'),
    rs=V('mxnet_tpu_comm_collective_bytes_total', kind='reduce_scatter',
         axis='dp', stage='zero3'),
    n_ag=V('mxnet_tpu_comm_collectives_total', kind='all_gather', axis='dp',
           stage='zero3'),
    gauge=V('mxnet_tpu_comm_param_bytes_per_device'),
    method=st.param_bytes_per_device(), params=len(st._trainable),
    plan=sum(b for _l, b, _c in st._gather_plan),
    per_step=st.gather_bytes_per_step())
telemetry.disable()

# the MXTPU_ZERO gate
os.environ['MXTPU_ZERO'] = '3'
gate = [step_of(net_with('w:', (16, 32, 8))).zero_stage,
        step_of(net_with('w:', (16, 32, 8)), zero=1).zero_stage,
        step_of(net_with('w:', (16, 32, 8)), zero=False).zero_stage]
try:
    step_of(net_with('w:', (16, 32, 8)), zero=2)
    gate.append('ran')
except Exception as e:
    gate.append(str(e))
# the Trainer's stage 3 is not ported: it raises rather than run ZeRO-1
net = net_with('w:', (16, 32, 8))
tr = gluon.Trainer(net.collect_params(), 'adam', {'learning_rate': 0.01})
from mxnet_tpu_torch import autograd
with autograd.record():
    loss = gluon.loss.SoftmaxCrossEntropyLoss()(
        net(mx.nd.array(rows(ref['x']), ctx=mx.cpu())),
        mx.nd.array(rows(ref['y']), ctx=mx.cpu()))
loss.backward()
try:
    tr.step(ref['x'].shape[0])
    out['trainer'] = 'ran'
except Exception as e:
    out['trainer'] = str(e)
del os.environ['MXTPU_ZERO']
out['gate'] = gate

# fsdp-style param_specs: the caller's dp dim
st = step_of(net_with('w:', (16, 32, 8)), zero=3,
             param_specs={'0.weight': (None, 'dp')})
st(rows(ref['x']), rows(ref['y']))
out['fsdp'] = dict(layout=st.zero3_layouts['0.weight'],
                   held=tuple(st._held()['0.weight'].shape),
                   weights=full(st))
try:
    step_of(net_with('w:', (16, 32, 8)), zero=1,
            param_specs={'0.weight': (None, 'dp')})(rows(ref['x']),
                                                   rows(ref['y']))
    out['fsdp_zero1'] = 'ran'
except Exception as e:
    out['fsdp_zero1'] = str(e)

# remat with dropout under ZeRO-3: the stage-1 trajectory, bit for bit
cfg = dict(vocab_size=64, hidden=32, layers=2, heads=2, intermediate=64,
           max_len=32, type_vocab=2, dropout=0.1)
bert = {k[2:]: ref[k] for k in ref.files if k.startswith('b:')}


def bert_run(zero, policy):
    os.environ['MXTPU_REMAT'] = policy
    hidden, attn = dp_generators(7, 'cpu')
    net = BertForPretraining(cfg, device='cpu', generator=hidden,
                             attn_generator=attn)
    net.load_state_dict({k: torch.from_numpy(v) for k, v in bert.items()})
    st = parallel.ShardedTrainStep(net, bert_pretrain_loss, 'adamw',
                                   {'learning_rate': 1e-3}, mesh=mesh,
                                   zero=zero)
    ins = [rows(ref['bt']), rows(ref['bty']), rows(ref['bv']),
           rows(ref['bm'])]
    labs = [rows(ref['bl']), rows(ref['bn'])]
    losses = [float(st(ins, labs)) for _ in range(2)]
    del os.environ['MXTPU_REMAT']
    return dict(losses=losses, weights=full(st), stats=st.stats())


out['bert'] = {(z, p): bert_run(z, p) for z, p in
               ((1, 'none'), (3, 'none'), (3, 'layer'), (3, 'aggressive'))}

# states across stages and dp: the dp = 4 world saves at stage 3, the
# dp = 2 world restores at stages 0, 1 and 3
saved = os.path.join(tmp, 'states_dp4.pkl')
if n == 4:
    for kind in ('even', 'ragged'):
        st, _ = run(kind, 'adamw', 3)
        blob3, w3 = st.get_states_bytes(), full(st)
        st(rows(ref[NETS[kind][2]]), rows(ref[NETS[kind][3]]))
        doc = dict(blob3=blob3, w3=w3, blob4=st.get_states_bytes(),
                   w4=full(st))
        if r == 0:
            with open(saved + kind + '.tmp', 'wb') as f:
                pickle.dump(doc, f)
            os.replace(saved + kind + '.tmp', saved + kind)
else:
    for kind in ('even', 'ragged'):
        prefix, sizes, xk, yk = NETS[kind]
        deadline = time.monotonic() + 90
        while not os.path.exists(saved + kind) and \
                time.monotonic() < deadline:
            time.sleep(0.2)
        with open(saved + kind, 'rb') as f:
            doc = pickle.load(f)
        for zero in (0, 1, 3):
            net = net_with(prefix, sizes)
            net.load_state_dict({k: torch.from_numpy(v)
                                 for k, v in doc['w3'].items()})
            st = step_of(net, zero=zero)
            st.set_states_bytes(doc['blob3'])
            st(rows(ref[xk]), rows(ref[yk]))
            out[('restored', kind, zero)] = dict(
                blob=st.get_states_bytes(), weights=full(st))
            st.set_states_bytes(doc['blob3'])
            out[('roundtrip', kind, zero)] = st.get_states_bytes()
with open(os.path.join(tmp, f'{name}_r{r}.pkl'), 'wb') as f:
    pickle.dump(out, f)
dist.shutdown()
'''


def _jnet(prefix, sizes):
    net = jgluon.nn.HybridSequential(prefix=prefix)
    with net.name_scope():
        net.add(jgluon.nn.Dense(sizes[1], activation='relu',
                                in_units=sizes[0], prefix='d0_'))
        net.add(jgluon.nn.Dense(sizes[2], in_units=sizes[1], prefix='d1_'))
    net.initialize(mx.init.Xavier())
    return net


SIZES = {'even': ('z3e_', (16, 32, 8)), 'ragged': ('z3r_', (13, 19, 7))}


def _data(kind):
    rng = onp.random.RandomState(0 if kind == 'even' else 1)
    din, classes = SIZES[kind][1][0], SIZES[kind][1][2]
    return rng.randn(64, din).astype(onp.float32), \
        rng.randint(0, classes, 64).astype(onp.float32)


@pytest.fixture(scope='module')
def arrays():
    out = {}
    for kind, (prefix, sizes) in SIZES.items():
        mx.random.seed(0)
        out[kind] = {k: v.data().asnumpy() for k, v in
                     _jnet(prefix, sizes)._collect_params_with_prefix()
                     .items()}
    return out


def _bert_ref():
    from mxnet_tpu_torch.models.bert import BertForPretraining
    cfg = dict(vocab_size=64, hidden=32, layers=2, heads=2, intermediate=64,
               max_len=32, type_vocab=2, dropout=0.1)
    net = BertForPretraining(cfg, device='cpu')
    rng = onp.random.RandomState(3)
    w = {f'b:{k}': (rng.randn(*p.shape) * 0.05).astype('float32')
         for k, p in net.named_parameters()}
    Bn, T, M = 8, 16, 4
    batch = dict(bt=rng.randint(0, 64, (Bn, T)), bty=rng.randint(0, 2, (Bn, T)),
                 bv=rng.randint(T // 2, T + 1, Bn).astype('float32'),
                 bm=rng.randint(0, T, (Bn, M)), bl=rng.randint(0, 64, (Bn, M)),
                 bn=rng.randint(0, 2, Bn))
    return w, batch


@pytest.fixture(scope='module')
def worlds(tmp_path_factory, arrays):
    tmp = tmp_path_factory.mktemp('zero3')
    (x, y), (gx, gy) = _data('even'), _data('ragged')
    w, batch = _bert_ref()
    onp.savez(tmp / 'ref.npz', x=x, y=y, gx=gx, gy=gy, **batch, **w,
              **{f'w:{k}': v for k, v in arrays['even'].items()},
              **{f'g:{k}': v for k, v in arrays['ragged'].items()})
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
    out['docs'] = {kind: pickle.loads(
        (tmp / f'states_dp4.pkl{kind}').read_bytes())
        for kind in ('even', 'ragged')}
    return out


_JAX = {}


def _jax_run(arrays, kind, opt, n, zero):
    key = (kind, opt, n, zero)
    if key not in _JAX:
        prefix, sizes = SIZES[kind]
        net = _jnet(prefix, sizes)
        for k, p in net._collect_params_with_prefix().items():
            p.set_data(nd.array(arrays[kind][k]))
        step = JStep(net, jgluon.loss.SoftmaxCrossEntropyLoss(), opt,
                     {'learning_rate': 0.01}, mesh=jmake_mesh((n,), ('dp',)),
                     zero=zero)
        x, y = _data(kind)
        losses = [float(step(nd.array(x), nd.array(y)).asscalar())
                  for _ in range(3)]
        w = {k: p.data().asnumpy()
             for k, p in net._collect_params_with_prefix().items()}
        _JAX[key] = (losses, w, step)
    return _JAX[key]


def _max_diff(a, b):
    return max(float(onp.max(onp.abs(a[k] - b[k]))) for k in b)


# ---------------------------------------------------------------------------
# parity
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('n', [2, 4])
@pytest.mark.parametrize('opt', OPTS)
def test_zero3_parity_vs_zero1_replicated_and_jax(worlds, arrays, opt, n):
    """3 steps: ZeRO-3 is ZeRO-1 bit for bit (a layout change; the update
    is elementwise on the same values), the replicated step within 1e-6
    (LAMB's norms reduce in another order), and the JAX step's stage 3 on
    a mesh of the same size within 1e-6, on every rank."""
    jl, jw, js = _jax_run(arrays, 'even', opt, n, 3)
    assert js.zero_stage == 3
    for o in worlds[n]:
        z3, z1, z0 = (o[('run', opt, z)] for z in (3, 1, 0))
        assert (z3['stage'], z1['stage'], z0['stage']) == (3, 1, 0)
        assert z3['losses'] == z1['losses']
        for k in z3['weights']:
            assert onp.array_equal(z3['weights'][k], z1['weights'][k]), k
        assert _max_diff(z3['weights'], z0['weights']) <= TOL
        for a, c in zip(z3['losses'], jl):
            assert abs(a - c) <= TOL, (z3['losses'], jl)
        assert _max_diff(z3['weights'], jw) <= TOL, (opt, n)


@pytest.mark.parametrize('n', [2, 4])
def test_zero3_params_and_masters_live_sharded(worlds, arrays, n):
    """Between steps each rank holds 1/dp of every parameter (all dims
    here divide by dp), the byte counts equal the JAX step's at stage 3,
    and the optimizer state is ZeRO-1's."""
    _, _, js = _jax_run(arrays, 'even', 'adamw', n, 3)
    for o in worlds[n]:
        z3, z1 = o[('run', 'adamw', 3)], o[('run', 'adamw', 1)]
        assert z1['param_bytes'] == n * z3['param_bytes']
        assert z3['param_bytes'] == js.param_bytes_per_device()
        assert z3['opt_bytes'] == z1['opt_bytes'] == \
            js.opt_state_bytes_per_device()
        for k, shape in z3['held'].items():
            full = arrays['even'][k].shape
            assert onp.prod(shape) * n == onp.prod(full), k
        assert z3['stats']['captured'] is False
        assert not z1['stats']['captured'] is False


@pytest.mark.parametrize('n', [2, 4])
def test_zero3_layer_groups_and_gather_plan(worlds, arrays, n):
    """One layer group per owning module (the JAX step's per-Dense
    groups), the gather plan two ring all-gathers of each group a step,
    equal to the JAX step's; the step's all-gathers: each group once in
    the forward, and again in the backward where autograd saved it."""
    _, _, js = _jax_run(arrays, 'even', 'adamw', n, 3)
    for o in worlds[n]:
        z3 = o[('run', 'adamw', 3)]
        assert z3['groups'] == [('0', ['0.bias', '0.weight']),
                                ('1', ['1.bias', '1.weight'])]
        assert len(js._layer_groups) == len(z3['groups'])
        assert [b for _g, b, _c in z3['gather_plan']] == \
            [b for _g, b, _c in js._gather_plan]
        assert all(c == 2 for _g, _b, c in z3['gather_plan'])
        assert z3['comm'] == js.comm_bytes_per_hop()
        # forward 2 groups; backward regathers the second (the first
        # layer's weight is not saved: its input needs no gradient)
        assert z3['stats']['layer_groups'] == 2
        assert z3['stats']['gathers'] == 3 and z3['stats']['gather_ms'] > 0
        assert z3['mem']['gather_bytes_per_layer'] == {
            g: int(b) for g, b, _c in z3['gather_plan']}


def test_zero3_layout_rules_are_the_jax_steps():
    cases = [((32, 16), ('tp', None), 4), ((32, 16), (), 8),
             ((32, 16), ('dp', None), 8), ((13, 7), (), 8),
             ((13, 7), ('tp', None), 8), ((3,), (), 8), ((), (), 8),
             ((12, 16), (None, 'dp'), 8), ((96,), (), 8), ((7, 2), (), 2)]
    for shape, spec, dp in cases:
        got = zero3_layout(shape, P(*spec), 'dp', dp)
        want = j_layout(shape, JP(*spec), 'dp', dp)
        assert got['mode'] == want['mode'], (shape, spec)
        for k in want:
            g = got[k]
            assert (tuple(g) if k.endswith('spec') else g) == \
                (tuple(want[k]) if k.endswith('spec') else want[k]), (k, shape)
    for fn, err in ((zero3_layout, MXNetError), (j_layout, Exception)):
        with pytest.raises(err, match='not divisible'):
            fn((12, 16), (P if fn is zero3_layout else JP)('dp', None), 'dp',
               8)


@pytest.mark.parametrize('n', [2, 4])
def test_zero3_flat_pad_parity_and_accounting(worlds, arrays, n):
    """A net whose dims never divide by dp flattens and pads: training
    matches the replicated update and the JAX stage 3 within 1e-6, the f32
    stores shard (padded)/dp, the pad is reported, and the state bytes
    equal the JAX step's."""
    jl, jw, js = _jax_run(arrays, 'ragged', 'adamw', n, 3)
    for o in worlds[n]:
        z3, z0 = o[('ragged', 3)], o[('ragged', 0)]
        modes = {k: v['mode'] for k, v in z3['layouts'].items()}
        assert set(modes.values()) == {'flat'}, modes
        for a, b, c in zip(z3['losses'], z0['losses'], jl):
            assert abs(a - b) <= TOL and abs(a - c) <= TOL
        assert _max_diff(z3['weights'], z0['weights']) <= TOL
        assert _max_diff(z3['weights'], jw) <= TOL
        for k, lay in z3['layouts'].items():
            assert lay['padded'] % n == 0
            assert z3['masters'][k] == (lay['padded'] // n,)
        assert z3['opt_bytes'] == js.opt_state_bytes_per_device()
        assert z3['pad_bytes'] > 0 and z3['pad_bytes'] == \
            js.opt_state_pad_bytes
        assert z3['opt_bytes'] < z0['opt_bytes']
        assert z3['mem']['pad_bytes'] == z3['pad_bytes']
        assert z3['comm'] == js.comm_bytes_per_hop()


def test_zero3_ordered_barrier_differentiates():
    """An identity whose outputs come from one node over all its inputs,
    each output's gradient flowing to its own input, as the JAX
    barrier's."""
    a = torch.arange(4.0, requires_grad=True)
    b = torch.ones(2, requires_grad=True)
    oa, ob = ordered_barrier(a * 2, b)
    assert torch.equal(oa, a * 2) and oa.grad_fn is ob.grad_fn
    (oa.sum() + 3 * ob.sum()).backward()
    assert torch.equal(a.grad, torch.full((4,), 2.0))
    assert torch.equal(b.grad, torch.full((2,), 3.0))
    (single,) = ordered_barrier(a)
    assert torch.equal(single, a)
    import jax.numpy as jnp
    ja, jb = jax.grad(lambda x, y: jnp.sum(j_barrier(x * 2, y)[0]) + 3 *
                      jnp.sum(j_barrier(x * 2, y)[1]), argnums=(0, 1))(
        jnp.arange(4.0), jnp.ones(2))
    assert onp.array_equal(onp.asarray(ja), a.grad.numpy())
    assert onp.array_equal(onp.asarray(jb), b.grad.numpy())


# ---------------------------------------------------------------------------
# states across stages and dp
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('kind', ['even', 'ragged'])
def test_zero3_states_blob_across_stages_and_dp(worlds, kind):
    """States saved at dp = 4 under ZeRO-3 (flat stores unflattened, every
    leaf logical) restore at dp = 2 under ZeRO-3, ZeRO-1 and none: one
    more step lands where the saving world's did (1e-6), and each
    payload round trip is bit for bit."""
    doc = worlds['docs'][kind]
    saved = pickle.loads(doc['blob3'])
    assert saved['stage'] == 3 and saved['zero'] and saved['dp'] == 4
    ref4 = pickle.loads(doc['blob4'])
    for o in worlds[2]:
        for zero in (0, 1, 3):
            got = pickle.loads(o[('restored', kind, zero)]['blob'])
            assert got['stage'] == zero and got['dp'] == 2
            for k in ref4['opt_state']:
                for a, b in zip(ref4['opt_state'][k], got['opt_state'][k]):
                    assert onp.allclose(a, b, rtol=0, atol=TOL), (zero, k)
            assert _max_diff(o[('restored', kind, zero)]['weights'],
                             doc['w4']) <= TOL
            rt = pickle.loads(o[('roundtrip', kind, zero)])
            for k, st in saved['opt_state'].items():
                for a, b in zip(st, rt['opt_state'][k]):
                    assert onp.array_equal(a, b), (zero, k)


# ---------------------------------------------------------------------------
# flags, telemetry, fsdp specs, remat, the Trainer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('n', [2, 4])
def test_zero3_flag_gate(worlds, n, monkeypatch):
    for o in worlds[n]:
        assert o['gate'][:3] == [3, 1, 0]
        assert 'stage 2' in o['gate'][3]
    from mxnet_tpu_torch import config
    for raw, want in (('3', 3), ('on', 1), ('0', 0)):
        monkeypatch.setenv('MXTPU_ZERO', raw)
        assert config.get('MXTPU_ZERO') == want
    monkeypatch.setenv('MXTPU_ZERO', '2')
    with pytest.raises(MXNetError, match='MXTPU_ZERO'):
        config.get('MXTPU_ZERO')


@pytest.mark.parametrize('n', [2, 4])
def test_zero3_comm_telemetry_stage_labels(worlds, n):
    """stage='zero3' counters: the all-gathers move twice the
    reduce-scatters' bytes (the forward's gather and the backward's
    regather of f32 parameters, one f32 gradient reduce-scatter), two
    gathers per parameter a step, the per-layer plan twice over two
    steps, and the gauge is the method's figure."""
    for o in worlds[n]:
        t = o['telem']
        assert t['ag'] == 2 * t['rs'] and t['n_ag'] == 2 * 2 * t['params']
        assert t['gauge'] == t['method'] and t['ag'] == 2 * t['plan']
        assert t['per_step'] == int(t['plan'])


@pytest.mark.parametrize('n', [2, 4])
def test_zero3_takes_an_fsdp_style_spec(worlds, arrays, n):
    """param_specs naming dp picks the shard dim (dim 1 here, where the
    step would pick dim 0), and trains as the default layout does; at
    stage 1 such a spec raises."""
    for o in worlds[n]:
        f = o['fsdp']
        assert f['layout']['mode'] == 'dim' and \
            tuple(f['layout']['spec']) == (None, 'dp')
        assert f['held'] == (16 // n, 32)
        assert 'zero=3' in o['fsdp_zero1']


@pytest.mark.parametrize('n', [2, 4])
def test_zero3_remat_with_dropout_is_stage1_bit_for_bit(worlds, n):
    """A small BERT with attention and hidden dropout 0.1: ZeRO-3 under
    none, layer and aggressive remat is the ZeRO-1 trajectory bit for bit
    (the recompute regathers its layer groups and replays the
    generators)."""
    for o in worlds[n]:
        b = o['bert']
        base = b[(1, 'none')]
        for key in ((3, 'none'), (3, 'layer'), (3, 'aggressive')):
            got = b[key]
            assert got['losses'] == base['losses'], key
            for k in base['weights']:
                assert onp.array_equal(got['weights'][k],
                                       base['weights'][k]), (key, k)
            assert got['stats']['layer_groups'] > 8


def _jax_trainer_layout(arrays, mesh):
    """The JAX Trainer's own ZeRO decision, ``Trainer._zero_layout``
    (``mxnet_tpu/gluon/trainer.py:447``, which its fused update calls at
    ``:708-711``), for weights placed replicated on ``mesh``, with no
    update run: the weight re-placement it asks of ``jax.device_put`` is
    recorded instead of made. (A whole Trainer step re-placed the weights
    and raced with the fused update's programs now and then, ROADMAP
    queue 3.) Returns (the layout, the Trainer, the shardings asked
    for)."""
    net = _jnet(*SIZES['even'])
    for k, p in net._collect_params_with_prefix().items():
        p.set_data(nd.array(arrays['even'][k]))
    net(nd.array(_data('even')[0]))
    repl = NamedSharding(mesh, JP())
    for p in net.collect_params().values():
        p.data()._data = jax.device_put(p.data()._data, repl)
    tr = jgluon.Trainer(net.collect_params(), 'adam', {'learning_rate': 0.01})
    items = [(i, p, None, p.list_data()) for i, p in enumerate(tr._params)
             if p.grad_req != 'null']
    asked = []

    def record(xs, shardings):
        asked.extend(shardings)
        return xs
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax, 'device_put', record)
        layout = tr._zero_layout(items)
    return layout, tr, asked


@pytest.mark.parametrize('n', [2, 4])
def test_trainer_zero3_raises_where_the_jax_trainer_shards(worlds, arrays,
                                                           monkeypatch, n):
    """MXTPU_ZERO=3 with dp > 1: the JAX Trainer chooses stage 3 and asks
    for every weight re-placed dp-sharded; the port's raises, naming
    ROADMAP item 7, where it once ran ZeRO-1 under the stage-3
    setting."""
    monkeypatch.setenv('MXTPU_ZERO', '3')
    layout, tr, asked = _jax_trainer_layout(arrays,
                                            jmake_mesh((n,), ('dp',)))
    assert layout['zero'] and layout['stage'] == 3 and layout['dp'] == n
    assert tr._zero3_mesh is not None
    assert len(asked) == len(tr._params) and \
        all('dp' in tuple(sh.spec) for sh in asked)
    for o in worlds[n]:
        assert 'item 7' in o['trainer'] and 'MXTPU_ZERO=3' in o['trainer']
