"""The RowSparse path of the port's compiled step (``mxnet_tpu_torch/
ops/rowsparse.py`` and ``parallel/step.py``) against the JAX package's:
every non-slow case of ``tests/test_sparse_step.py`` run through both
packages (the dedup tier, lazy freezing and the update-bytes shrink,
exact mode bit for bit against dense, the lazy delta, the dense-to-sparse
restore with its manifest, the eager sparse layout, the dedup's
determinism), the port's step held against the JAX step on a one-device
CPU mesh for every ``_OPTS`` optimizer in lazy and exact mode (losses rel
1e-5, parameters and moments rel 1e-4 in Frobenius norm, untouched rows'
moments exactly 0), the sentinel case with row ``vocab - 1`` live and
fewer live rows than the budget, and the refusals, each naming its
ROADMAP item.
"""
import pickle

import jax
import jax.numpy as jnp
import numpy as onp
import pytest
import torch

import mxnet_tpu as mj
import mxnet_tpu_torch as mt
from mxnet_tpu.ops import rowsparse as jrs
from mxnet_tpu.parallel import step as jstep
from mxnet_tpu.parallel.mesh import make_mesh as jmake_mesh
from mxnet_tpu_torch.ops import rowsparse as trs
from mxnet_tpu_torch.parallel import ShardedTrainStep, make_mesh
from mxnet_tpu_torch.weights import params_from_mxnet_tpu

VOCAB, DIM = 2000, 8
LOSS_RTOL, RTOL = 1e-5, 1e-4


@pytest.fixture(autouse=True, scope='module')
def _jax_name_counters():
    """The JAX package's global block-name counters as this file found
    them, put back after it (``tests/test_zero3.py`` and
    ``test_zero1.py`` pair parameters by sorted prefixed names)."""
    from mxnet_tpu.gluon.block import _BlockScope
    saved = dict(_BlockScope._global_counter)
    yield
    _BlockScope._global_counter.clear()
    _BlockScope._global_counter.update(saved)


@pytest.fixture(autouse=True)
def _port_on_cpu():
    with mt.cpu():
        yield


def _batch(lo=0, hi=40, seed=0, shape=(16, 5)):
    ids = onp.random.RandomState(seed).randint(lo, hi, size=shape) \
        .astype(onp.float32)
    lab = onp.random.RandomState(seed + 1).randn(*shape, 4) \
        .astype(onp.float32)
    return ids, lab


def _build(pkg, vocab=VOCAB, dim=DIM, seed=11, arrays=None):
    """The JAX test's net (Embedding(sparse_grad=True) + Dense(4)); the
    port's takes the JAX net's weights by structured name."""
    mx = mj if pkg == 'jax' else mt
    mx.random.seed(seed)
    net = mx.gluon.nn.HybridSequential(prefix='sp_')
    with net.name_scope():
        net.add(mx.gluon.nn.Embedding(vocab, dim, sparse_grad=True))
        net.add(mx.gluon.nn.Dense(4, flatten=False, in_units=dim))
    net.initialize()
    if arrays is not None:
        net.load_state_dict(params_from_mxnet_tpu(arrays, net))
    return net


def _jax_arrays(jnet):
    return {k: p.data().asnumpy()
            for k, p in jnet._collect_params_with_prefix().items()}


def _env(monkeypatch, sparse, exact=False):
    monkeypatch.setenv('MXTPU_SPARSE', '1' if sparse else '0')
    monkeypatch.setenv('MXTPU_SPARSE_EXACT', '1' if exact else '0')
    monkeypatch.delenv('MXTPU_SPARSE_TABLE_AXIS', raising=False)
    monkeypatch.delenv('MXTPU_SPARSE_ROWS', raising=False)


def _sq_loss_port(out, label):
    return (out - label) ** 2


def _sq_loss_jax(out, label):
    return (out - label) ** 2


def _jax_step(jnet, opt, params):
    mesh = jmake_mesh((1,), ('dp',), devices=jax.devices()[:1])
    return jstep.ShardedTrainStep(jnet, _sq_loss_jax, opt, dict(params),
                                  mesh=mesh)


def _port_step(net, opt, params):
    return ShardedTrainStep(net, _sq_loss_port, opt, dict(params),
                            mesh=make_mesh(devices=['cpu']))


def _run_port(monkeypatch, sparse, exact=False, steps=3, opt='adam',
              params=None, arrays=None, batches=None):
    _env(monkeypatch, sparse, exact)
    net = _build('port', arrays=arrays)
    step = _port_step(net, opt, params or {'learning_rate': 0.01})
    batches = batches or [_batch()] * steps
    losses = [float(step(torch.from_numpy(i), torch.from_numpy(l)))
              for i, l in batches]
    return net, step, losses


def _rel(a, b):
    a, b = onp.asarray(a, onp.float64), onp.asarray(b, onp.float64)
    return onp.linalg.norm(a - b) / max(onp.linalg.norm(b), 1e-30)


# ---------------------------------------------------------------------------
# the dedup tier: unique_rows / dedup_take / merge_row_blocks
# ---------------------------------------------------------------------------

def test_unique_rows_dedup_sentinel_and_inverse():
    ids = onp.array([7, 2, 7, 7, 0, 2, 9, 42])   # 42 clamps to vocab-1
    juids, jinv, jn = jrs.unique_rows(jnp.asarray(ids), budget=8, vocab=10)
    uids, inv, n_live = trs.unique_rows(torch.from_numpy(ids), budget=8,
                                        vocab=10)
    assert int(n_live) == int(jn) == 4
    onp.testing.assert_array_equal(uids.numpy(), onp.asarray(juids))
    onp.testing.assert_array_equal(inv.numpy(), onp.asarray(jinv))
    assert list(uids.numpy()[:4]) == [0, 2, 7, 9]
    assert all(int(u) == 10 for u in uids.numpy()[4:])
    onp.testing.assert_array_equal(uids.numpy()[inv.numpy()],
                                   onp.clip(ids, 0, 9))


def test_dedup_take_parity_with_heavily_repeated_ids():
    """The embedding/take backward dedups repeated ids by a segment sum
    before the table-shaped write: the forward is the plain gather bit
    for bit, the gradient the scatter-add reference's, with one id
    repeated ~70 times."""
    W = onp.random.RandomState(3).randn(50, 6).astype(onp.float32)
    ids = onp.random.RandomState(0).choice(
        [1, 7, 7, 7, 33], size=120).astype(onp.int64)
    w = torch.from_numpy(W).requires_grad_()
    got_f = trs.dedup_take(w, torch.from_numpy(ids))
    onp.testing.assert_array_equal(got_f.detach().numpy(), W[ids])
    (got_f ** 2).sum().backward()
    ref = torch.from_numpy(W).requires_grad_()
    (ref[torch.from_numpy(ids)] ** 2).sum().backward()
    assert onp.allclose(w.grad.numpy(), ref.grad.numpy(), atol=1e-5)
    jg = jax.grad(lambda a: jnp.sum(jrs.dedup_take(
        a, jnp.asarray(ids.astype(onp.int32))) ** 2))(jnp.asarray(W))
    assert onp.allclose(w.grad.numpy(), onp.asarray(jg), atol=1e-5)


def test_merge_row_blocks_overlap_and_sentinels():
    u = onp.array([2, 5, 10, 10], onp.int64)          # 10 == sentinel
    v = onp.zeros((4, 3), onp.float32)
    v[0], v[1] = 1.0, 2.0
    uu, vv = onp.concatenate([u, u]), onp.concatenate([v, v])
    mu, mv, n_live = trs.merge_row_blocks(torch.from_numpy(uu),
                                          torch.from_numpy(vv), vocab=10)
    jmu, jmv, jn = jrs.merge_row_blocks(jnp.asarray(uu.astype(onp.int32)),
                                        jnp.asarray(vv), vocab=10)
    assert int(n_live) == int(jn) == 2
    onp.testing.assert_array_equal(mu.numpy(), onp.asarray(jmu))
    onp.testing.assert_array_equal(mv.numpy(), onp.asarray(jmv))
    dense = onp.zeros((10, 3))
    for uid, val in zip(mu.numpy(), mv.numpy()):
        if uid < 10:
            dense[uid] += val
    assert onp.allclose(dense[2], 2.0) and onp.allclose(dense[5], 4.0)
    assert onp.allclose(onp.delete(dense, [2, 5], axis=0), 0.0)


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_dedup_unsorted_id_order_bitwise_invariant(seed):
    """Permuting the ids changes neither the forward values nor the
    gradient, bit for bit: the segment sum's order depends on the id
    multiset only (three seeds, the JAX test's flakiness_checker 3x)."""
    W = onp.random.RandomState(100 + seed).randn(30, 4).astype(onp.float32)
    base = onp.random.RandomState(seed + 1).randint(0, 30, size=64)
    ref_vals = onp.sort(W[base].ravel())
    grads = []
    for perm_seed in range(3):
        ids = torch.from_numpy(
            onp.random.RandomState(perm_seed).permutation(base))
        w = torch.from_numpy(W).requires_grad_()
        out = trs.dedup_take(w, ids)
        assert onp.array_equal(onp.sort(out.detach().numpy().ravel()),
                               ref_vals)
        (out ** 2).sum().backward()
        grads.append(w.grad.numpy())
    assert onp.array_equal(grads[0], grads[1])
    assert onp.array_equal(grads[0], grads[2])


# ---------------------------------------------------------------------------
# the step tier
# ---------------------------------------------------------------------------

def test_sparse_step_lazy_freezes_absent_rows_and_shrinks(monkeypatch):
    net, step, losses = _run_port(monkeypatch, sparse=True, steps=2)
    assert step._sparse_names, 'the table must take the sparse path'
    assert losses[1] < losses[0]
    (name,) = step._sparse_names
    ids, _ = _batch()
    touched = onp.unique(ids.astype(int))
    m = step._state[name][0].numpy()
    untouched = onp.setdiff1d(onp.arange(VOCAB), touched)
    assert onp.all(m[untouched] == 0.0)
    assert onp.any(m[touched] != 0.0)
    rep = step.sparse_report()
    assert rep['mode'] == 'lazy'
    assert rep['update_shrink'] >= 5.0, rep
    assert rep['tables'][name]['budget'] == 80
    lay = step.sparse_layout()
    assert lay['tables'][name]['vocab'] == VOCAB
    doc = pickle.loads(step.get_states_bytes())
    assert doc['sparse']['mode'] == 'lazy'
    sig = step._sparse_sig
    assert sig and sig['tables'][name] == 80
    # the JAX step's report on the same net and batch
    monkeypatch.setenv('MXTPU_SPARSE', '1')
    jnet = _build('jax')
    js = _jax_step(jnet, 'adam', {'learning_rate': 0.01})
    js(mj.nd.array(ids), mj.nd.array(_batch()[1]))
    jrep = js.sparse_report()
    assert jrep['update_bytes_per_step'] == rep['update_bytes_per_step']
    assert jrep['update_shrink'] == rep['update_shrink']


def test_sparse_exact_trajectory_bitwise_parity_vs_dense(monkeypatch):
    """Exact-mode Adam on the sparse path is the dense path bit for bit
    over 3 steps: both write the same segment-summed row blocks before
    the same dense update."""
    net_d, step_d, loss_d = _run_port(monkeypatch, sparse=False)
    net_s, step_s, loss_s = _run_port(monkeypatch, sparse=True, exact=True)
    assert not step_d._sparse_names and step_s._sparse_names
    assert step_s._sparse_exact
    assert loss_d == loss_s
    for (n, pd), (_, ps) in zip(sorted(net_d.named_parameters()),
                                sorted(net_s.named_parameters())):
        assert torch.equal(pd, ps), n
    # lazy_update=False in optimizer_params is exact mode too
    net_x, step_x, loss_x = _run_port(
        monkeypatch, sparse=True,
        params={'learning_rate': 0.01, 'lazy_update': False})
    assert step_x._sparse_exact and loss_x == loss_d
    for (n, pd), (_, px) in zip(sorted(net_d.named_parameters()),
                                sorted(net_x.named_parameters())):
        assert torch.equal(pd, px), n


def test_sparse_lazy_documented_delta_vs_dense(monkeypatch):
    """Lazy Adam differs from dense only through rows touched earlier and
    absent later: identical on a constant batch; after a disjoint batch
    the delta stays under one bias-corrected moment step (~lr)."""
    net_d, step_d, _ = _run_port(monkeypatch, sparse=False)
    net_s, step_s, _ = _run_port(monkeypatch, sparse=True)
    wd = net_d[0].weight.data().asnumpy()
    ws = net_s[0].weight.data().asnumpy()
    assert onp.array_equal(wd, ws)
    ids2, lab2 = _batch(lo=100, hi=140, seed=5)
    step_d(torch.from_numpy(ids2), torch.from_numpy(lab2))
    step_s(torch.from_numpy(ids2), torch.from_numpy(lab2))
    delta = onp.abs(net_d[0].weight.data().asnumpy()
                    - net_s[0].weight.data().asnumpy()).max()
    assert delta > 0.0
    assert delta <= 0.011


def test_dense_to_sparse_state_restore_and_manifest(monkeypatch, tmp_path):
    """A payload written by the dense path restores into a sparse step,
    which trains on like the dense run under exact mode, and the
    checkpoint manifest records optimizer_state_layout.sparse."""
    from mxnet_tpu_torch.checkpoint import CheckpointManager
    from mxnet_tpu_torch.checkpoint import manifest as mf
    net_d, step_d, _ = _run_port(monkeypatch, sparse=False, steps=2)
    blob = step_d.get_states_bytes()
    assert 'sparse' not in pickle.loads(blob)
    params_d = {n: p.detach().clone() for n, p in net_d.named_parameters()}
    _env(monkeypatch, True, exact=True)
    net_s = _build('port')
    with torch.no_grad():
        for n, p in net_s.named_parameters():
            p.copy_(params_d[n])
    step_s = _port_step(net_s, 'adam', {'learning_rate': 0.01})
    step_s.set_states_bytes(blob)       # pending until the first build
    ids, lab = _batch()
    l_d = float(step_d(torch.from_numpy(ids), torch.from_numpy(lab)))
    l_s = float(step_s(torch.from_numpy(ids), torch.from_numpy(lab)))
    assert l_d == l_s
    for (n, pd), (_, ps) in zip(sorted(net_d.named_parameters()),
                                sorted(net_s.named_parameters())):
        assert onp.allclose(pd.detach().numpy(), ps.detach().numpy(),
                            atol=1e-6), n
    doc = pickle.loads(step_s.get_states_bytes())
    assert doc['sparse']['mode'] == 'exact'
    mgr = CheckpointManager(str(tmp_path), params=net_s, trainer=step_s,
                            async_save=False)
    mgr.save(1)
    mgr.close()
    layout = mf.read_manifest(mgr.step_dir(1))['metadata'][
        'optimizer_state_layout']
    assert layout['sparse']['mode'] == 'exact'
    assert list(layout['sparse']['tables']) == step_s._sparse_names
    # and a sparse (lazy) payload restores into a dense step
    _env(monkeypatch, True)
    net_l, step_l, _ = _run_port(monkeypatch, sparse=True, steps=1)
    _env(monkeypatch, False)
    net_e = _build('port')
    with torch.no_grad():
        for (n, p), (_, q) in zip(sorted(net_e.named_parameters()),
                                  sorted(net_l.named_parameters())):
            p.copy_(q)
    step_e = _port_step(net_e, 'adam', {'learning_rate': 0.01})
    step_e.set_states_bytes(step_l.get_states_bytes())
    l_l = float(step_l(torch.from_numpy(ids), torch.from_numpy(lab)))
    l_e = float(step_e(torch.from_numpy(ids), torch.from_numpy(lab)))
    assert l_l == l_e and not step_e._sparse_names


def test_trainer_sparse_layout_eager():
    """gluon.Trainer describes the sparse tables for the manifest on the
    eager path, as the JAX Trainer does."""
    lays = {}
    for pkg, mx in (('jax', mj), ('port', mt)):
        mx.random.seed(0)
        net = mx.gluon.nn.HybridSequential()
        net.add(mx.gluon.nn.Embedding(100, 4, sparse_grad=True))
        net.add(mx.gluon.nn.Dense(2, flatten=False, in_units=4))
        net.initialize()
        tr = mx.gluon.Trainer(net.collect_params(), 'adam',
                              {'learning_rate': 0.01})
        lay = tr.sparse_layout()
        assert lay is not None and lay['mode'] == 'lazy'
        (tbl,) = lay['tables'].values()
        assert tbl == {'vocab': 100, 'dim': 4}
        lays[pkg] = lay
        net2 = mx.gluon.nn.Dense(2, in_units=4)
        net2.initialize()
        assert mx.gluon.Trainer(net2.collect_params(), 'sgd',
                                {}).sparse_layout() is None
    assert lays['port']['mode'] == lays['jax']['mode']


# ---------------------------------------------------------------------------
# the port's step against the JAX step
# ---------------------------------------------------------------------------

OPTS = {
    'sgd': {'learning_rate': 0.05, 'momentum': 0.9, 'wd': 1e-3},
    'adam': {'learning_rate': 0.01, 'wd': 1e-3},
    'adamw': {'learning_rate': 0.01, 'wd': 0.01},
    'lamb': {'learning_rate': 0.01, 'wd': 0.01},
}


def _both_steps(monkeypatch, opt, params, exact, batches, vocab=VOCAB):
    _env(monkeypatch, True, exact)
    jnet = _build('jax', vocab=vocab)
    arrays = _jax_arrays(jnet)
    js = _jax_step(jnet, opt, params)
    tnet = _build('port', vocab=vocab, arrays=arrays)
    ts = _port_step(tnet, opt, params)
    jl, tl = [], []
    for ids, lab in batches:
        jl.append(float(js(mj.nd.array(ids), mj.nd.array(lab)).asnumpy()))
        tl.append(float(ts(torch.from_numpy(ids), torch.from_numpy(lab))))
    return jnet, js, tnet, ts, jl, tl


def _hold(jnet, js, tnet, ts, jl, tl):
    onp.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)
    names = {id(p): n for n, p in jnet.collect_params().items()}
    jparams = {k: (names[id(p)], p)
               for k, p in jnet._collect_params_with_prefix().items()}
    for k, p in tnet.named_parameters():
        jn, jp = jparams[k]
        assert _rel(p.detach().numpy(), jp.data().asnumpy()) < RTOL, k
        jst = [s for s in js._opt_state[jn] if getattr(s, 'ndim', 0)]
        for a, b in zip(ts._state[k], jst):
            assert _rel(a.numpy(), onp.asarray(b)) < RTOL, k


@pytest.mark.parametrize('exact', [False, True], ids=['lazy', 'exact'])
@pytest.mark.parametrize('opt', sorted(OPTS))
def test_step_matches_jax_step(monkeypatch, opt, exact):
    """3 steps (the second batch disjoint from the first, so lazy rows
    go absent with live moments) on the sparse table, against the JAX
    step; under lazy the moments of rows no batch touched stay 0."""
    batches = [_batch(), _batch(lo=100, hi=140, seed=5), _batch()]
    jnet, js, tnet, ts, jl, tl = _both_steps(monkeypatch, opt, OPTS[opt],
                                             exact, batches)
    assert ts._sparse_names == ['0.weight'] and js._sparse_names
    assert ts._sparse_exact == exact
    _hold(jnet, js, tnet, ts, jl, tl)
    if not exact:
        touched = onp.unique(onp.concatenate(
            [b[0].ravel() for b in batches]).astype(int))
        untouched = onp.setdiff1d(onp.arange(VOCAB), touched)
        for s in ts._state['0.weight']:
            assert onp.all(s.numpy()[untouched] == 0.0)


def test_sentinel_with_last_row_live(monkeypatch):
    """Row vocab - 1 is live and fewer rows are live than the budget, so
    the sentinel slots would clamp onto a live row: the lazy writes go
    through the last live slot and carry its value, and the step matches
    the JAX step (whose sentinel writes XLA drops)."""
    vocab = 50
    ids = onp.array([[49, 3, 49, 3, 49], [0, 49, 0, 3, 3]], onp.float32)
    lab = onp.random.RandomState(7).randn(2, 5, 4).astype(onp.float32)
    uids, _, n_live = trs.unique_rows(torch.from_numpy(ids), 10, vocab)
    assert int(n_live) == 3 and uids.tolist()[:3] == [0, 3, 49]
    assert uids.tolist()[3:] == [vocab] * 7
    jnet, js, tnet, ts, jl, tl = _both_steps(
        monkeypatch, 'adam', OPTS['adam'], False, [(ids, lab)] * 3,
        vocab=vocab)
    _hold(jnet, js, tnet, ts, jl, tl)
    w = tnet[0].weight.detach().numpy()
    w0 = _jax_arrays(_build('jax', vocab=vocab))['0.weight']
    rest = [i for i in range(vocab) if i not in (0, 3, 49)]
    onp.testing.assert_array_equal(w[rest], w0[rest])
    assert not onp.allclose(w[49], w0[49])


def test_two_lookups_of_one_table_merge(monkeypatch):
    """A table looked up twice in one step: its row blocks merge into one
    (merge_row_blocks), and the step matches the JAX step."""
    losses = {}
    for pkg, mx in (('jax', mj), ('port', mt)):
        _env(monkeypatch, True)

        class Twice(mx.gluon.nn.HybridBlock):
            def __init__(self, **kw):
                super().__init__(**kw)
                with self.name_scope():
                    self.emb = mx.gluon.nn.Embedding(60, 4, sparse_grad=True)
                    self.out = mx.gluon.nn.Dense(1, flatten=False,
                                                 in_units=4)

            def hybrid_forward(self, F, x, y):
                return self.out(self.emb(x) + self.emb(y))

        mx.random.seed(3)
        net = Twice(prefix='tw_')
        net.initialize()
        if pkg == 'jax':
            arrays = _jax_arrays(net)
        else:
            net.load_state_dict(params_from_mxnet_tpu(arrays, net))
        x = onp.random.RandomState(1).randint(0, 20, (6, 3)) \
            .astype(onp.float32)
        y = onp.random.RandomState(2).randint(10, 30, (6, 3)) \
            .astype(onp.float32)
        lab = onp.random.RandomState(3).randn(6, 3, 1).astype(onp.float32)
        if pkg == 'jax':
            step = _jax_step(net, 'adam', {'learning_rate': 0.05})
            losses[pkg] = [float(step([mj.nd.array(x), mj.nd.array(y)],
                                      mj.nd.array(lab)).asnumpy())
                           for _ in range(2)]
            jw = net.emb.weight.data().asnumpy()
        else:
            step = _port_step(net, 'adam', {'learning_rate': 0.05})
            losses[pkg] = [float(step([torch.from_numpy(x),
                                       torch.from_numpy(y)],
                                      torch.from_numpy(lab)))
                           for _ in range(2)]
            assert step._sparse_budgets['emb.weight'] == [18, 18]
            tw = net.emb.weight.detach().numpy()
    onp.testing.assert_allclose(losses['port'], losses['jax'],
                                rtol=LOSS_RTOL)
    assert _rel(tw, jw) < RTOL


def test_lookup_count_change_raises(monkeypatch):
    net, step, _ = _run_port(monkeypatch, sparse=True, steps=1)
    ids, lab = _batch(shape=(8, 5))
    with pytest.raises(mt.MXNetError, match='build a new step'):
        step(torch.from_numpy(ids), torch.from_numpy(lab))


def test_rows_ceiling_takes_the_dense_path(monkeypatch):
    monkeypatch.setenv('MXTPU_SPARSE_ROWS', '40')
    monkeypatch.setenv('MXTPU_SPARSE', '1')
    net = _build('port')
    step = _port_step(net, 'adam', {'learning_rate': 0.01})
    ids, lab = _batch()
    step(torch.from_numpy(ids), torch.from_numpy(lab))
    assert step._sparse_names == [] and step.sparse_report() is None


def test_sparse_refusals_name_their_items(monkeypatch):
    import numpy
    from mxnet_tpu_torch.parallel.mesh import Mesh
    _env(monkeypatch, True)
    net = _build('port')
    monkeypatch.setenv('MXTPU_SPARSE_TABLE_AXIS', 'tp')
    with pytest.raises(mt.MXNetError, match='item 6a'):
        _port_step(net, 'adam', {})
    monkeypatch.delenv('MXTPU_SPARSE_TABLE_AXIS')
    with pytest.raises(mt.MXNetError, match='item 8'):
        ShardedTrainStep(net, _sq_loss_port, 'adam', {},
                         compression_params={'type': '2bit'})
    cpu = torch.device('cpu')
    mesh2 = Mesh(numpy.array([cpu, cpu], dtype=object), ('dp',))
    with pytest.raises(mt.MXNetError, match='item 12a'):
        ShardedTrainStep(net, _sq_loss_port, 'adam', {}, mesh=mesh2, zero=1)
    with pytest.raises(mt.MXNetError, match='item 7'):
        ShardedTrainStep(net, _sq_loss_port, 'adam', {}, mesh=mesh2, zero=3)
    # with the sparse path off the same table is a dense parameter
    monkeypatch.setenv('MXTPU_SPARSE', '0')
    _port_step(net, 'adam', {})


def test_sparse_telemetry_one_step_late(monkeypatch):
    """The metrics the JAX step emits for the sparse path: each table's
    live rows, row bytes and dedup ratio, read one step late (the first
    step records none), and the ``optimizer.sparse_update`` instant."""
    from mxnet_tpu_torch.telemetry import metrics, trace
    _env(monkeypatch, True)
    net = _build('port')
    step = _port_step(net, 'adam', {'learning_rate': 0.01})
    ids, lab = _batch()
    live = len(onp.unique(ids.astype(int)))
    metrics.reset()
    metrics.enable()
    trace.clear()
    trace.enable()
    try:
        step(torch.from_numpy(ids), torch.from_numpy(lab))
        assert metrics.value('mxnet_tpu_sparse_live_rows',
                             table='0.weight') is None
        for _ in range(2):
            step(torch.from_numpy(ids), torch.from_numpy(lab))
        assert metrics.value('mxnet_tpu_sparse_live_rows',
                             table='0.weight') == live
        assert metrics.value('mxnet_tpu_sparse_row_bytes_total',
                             table='0.weight') == 2 * live * DIM * 4
        assert metrics.value('mxnet_tpu_sparse_dedup_ratio',
                             table='0.weight') == pytest.approx(80 / live)
        names = [e.get('name') for e in trace.chrome_events()]
        assert names.count('optimizer.sparse_update') == 3
    finally:
        metrics.disable()
        metrics.reset()
        trace.disable()
        trace.clear()
