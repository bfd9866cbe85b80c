"""The port's sparse storage (``mxnet_tpu_torch/ndarray/sparse.py``,
``ops/sparse_ops.py``, the lazy updates of ``optimizer_ops`` and the
optimizers, ``Parameter(stype=, grad_stype=)``, ``Embedding(
sparse_grad=True)``, ``SparseEmbedding``, the Trainer's loop) against the
JAX package's: every case of ``tests/test_sparse.py`` run through both
packages on the same numpy inputs, with the JAX tests' tolerances (the
port on the CPU). ``test_kvstore_row_sparse_pull`` waits for ROADMAP
item 8: the port's ``kvstore.row_sparse_pull`` raises naming it.
"""
import copy

import numpy as onp
import pytest
import torch

import mxnet_tpu as mj
import mxnet_tpu_torch as mt
from mxnet_tpu.ndarray import sparse as jsp
from mxnet_tpu_torch.ndarray import sparse as tsp
from mxnet_tpu.ops import optimizer_ops as JO
from mxnet_tpu_torch.ops import optimizer_ops as TO


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


PKGS = {'jax': (mj, jsp), 'port': (mt, tsp)}


def _rand_sparse(shape, density, rs):
    a = rs.uniform(-1, 1, shape).astype('float32')
    a[rs.uniform(0, 1, shape) > density] = 0
    return a


# ---- the NDArray surface ----------------------------------------------

def _csr_parts(pkg, a):
    mx, sp = PKGS[pkg]
    csr = sp.csr_matrix(a)
    data, indices, indptr = (csr.data.asnumpy(), csr.indices.asnumpy(),
                             csr.indptr.asnumpy())
    rebuilt = sp.csr_matrix((data, indices, indptr), shape=a.shape)
    assert rebuilt.stype == 'csr'
    return data, indices, indptr, rebuilt.asnumpy()


def test_csr_parts_roundtrip():
    a = _rand_sparse((7, 11), 0.3, onp.random.RandomState(0))
    want = _csr_parts('jax', a)
    got = _csr_parts('port', a)
    for w, g in zip(want, got):
        onp.testing.assert_array_equal(g, w)
    data, indices, indptr, rebuilt = got
    assert onp.allclose(rebuilt, a)
    assert indptr[0] == 0 and indptr[-1] == (a != 0).sum()
    assert (onp.diff(indptr) >= 0).all()


def test_csr_empty_rows():
    a = onp.zeros((4, 5), dtype='float32')
    a[2, 3] = 2.5
    for pkg in PKGS:
        csr = PKGS[pkg][1].csr_matrix(a)
        assert onp.allclose(csr.indptr.asnumpy(), [0, 0, 0, 1, 1]), pkg
        assert csr.indices.asnumpy().tolist() == [3], pkg


def test_row_sparse_roundtrip():
    rs = onp.random.RandomState(1)
    data = rs.uniform(-1, 1, (3, 4)).astype('float32')
    indices = onp.array([1, 4, 6])
    outs = {}
    for pkg, (mx, sp) in PKGS.items():
        rsp = sp.row_sparse_array((data, indices), shape=(8, 4))
        assert rsp.stype == 'row_sparse'
        assert rsp.indices.asnumpy().tolist() == [1, 4, 6]
        assert onp.allclose(rsp.data.asnumpy(), data)
        dense = rsp.tostype('default')
        assert dense.stype == 'default'
        outs[pkg] = dense.asnumpy()
    onp.testing.assert_array_equal(outs['port'], outs['jax'])
    assert onp.allclose(outs['port'][indices], data)


def test_retain():
    a = onp.random.RandomState(2).uniform(1, 2, (6, 3)).astype('float32')
    outs = {}
    for pkg, (mx, sp) in PKGS.items():
        rsp = sp.row_sparse_array(a)
        outs[pkg] = sp.retain(rsp, mx.nd.array(onp.array([0, 5]))).asnumpy()
    out = outs['port']
    onp.testing.assert_array_equal(out, outs['jax'])
    assert onp.allclose(out[[0, 5]], a[[0, 5]])
    assert (out[1:5] == 0).all()


def test_sparse_dot_matches_dense():
    rs = onp.random.RandomState(3)
    a = _rand_sparse((5, 8), 0.4, rs)
    b = rs.uniform(-1, 1, (8, 3)).astype('float32')
    outs = {pkg: sp.dot(sp.csr_matrix(a), mx.nd.array(b)).asnumpy()
            for pkg, (mx, sp) in PKGS.items()}
    assert onp.allclose(outs['port'], a @ b, atol=1e-5)
    assert onp.allclose(outs['port'], outs['jax'], atol=1e-5)


def test_density():
    a = onp.zeros((4, 4), dtype='float32')
    a[0, 0] = 1
    for pkg, (mx, sp) in PKGS.items():
        assert abs(sp.csr_matrix(a).density - 1 / 16) < 1e-9, pkg


# ---- lazy updates -----------------------------------------------------

def _port_grad(g):
    return tsp.RowSparseNDArray(torch.from_numpy(g))


def test_lazy_sgd_mom_skips_absent_rows():
    rs = onp.random.RandomState(4)
    w0 = rs.uniform(-1, 1, (6, 4)).astype('float32')
    g = onp.zeros((6, 4), dtype='float32')
    g[[1, 3]] = rs.uniform(-1, 1, (2, 4))
    kw = dict(learning_rate=0.1, momentum=0.9, wd=0.01, lazy_update=True)

    jo = mj.optimizer.SGD(**kw)
    jw = mj.nd.array(w0.copy())
    js = jo.create_state(0, jw)
    jo.update(0, jw, jsp.RowSparseNDArray(mj.nd.array(g)._data), js)

    to = mt.optimizer.SGD(**kw)
    tw = torch.from_numpy(w0.copy())
    ts = to.create_state(0, tw)
    to.update(0, tw, _port_grad(g), ts)
    wn = tw.numpy()
    assert onp.allclose(wn, jw.asnumpy())
    assert onp.allclose(ts.numpy(), js.asnumpy())
    assert onp.allclose(wn[[0, 2, 4, 5]], w0[[0, 2, 4, 5]])
    assert not onp.allclose(wn[[1, 3]], w0[[1, 3]])
    assert (ts.numpy()[[0, 2, 4, 5]] == 0).all()

    # dense grad with identical values: every row updated (wd applies)
    jw2 = mj.nd.array(w0.copy())
    js2 = jo.create_state(1, jw2)
    jo.update(1, jw2, mj.nd.array(g), js2)
    tw2 = torch.from_numpy(w0.copy())
    ts2 = to.create_state(1, tw2)
    to.update(1, tw2, torch.from_numpy(g), ts2)
    assert not onp.allclose(tw2.numpy()[[0, 2]], w0[[0, 2]])
    assert onp.allclose(tw2.numpy(), jw2.asnumpy())


def test_lazy_adam_state_frozen_for_absent_rows():
    rs = onp.random.RandomState(5)
    w0 = rs.uniform(-1, 1, (5, 3)).astype('float32')
    g = onp.zeros((5, 3), dtype='float32')
    g[0] = 1.0

    jo = mj.optimizer.Adam(learning_rate=0.05, lazy_update=True)
    jw = mj.nd.array(w0.copy())
    js = jo.create_state(0, jw)
    to = mt.optimizer.Adam(learning_rate=0.05, lazy_update=True)
    tw = torch.from_numpy(w0.copy())
    ts = to.create_state(0, tw)
    for _ in range(3):
        jo.update(0, jw, jsp.RowSparseNDArray(mj.nd.array(g)._data), js)
        to.update(0, tw, _port_grad(g), ts)
    mean, var = ts
    assert onp.allclose(tw.numpy()[1:], w0[1:])
    assert (mean.numpy()[1:] == 0).all()
    assert (var.numpy()[1:] == 0).all()
    assert not onp.allclose(tw.numpy()[0], w0[0])
    assert onp.allclose(tw.numpy(), jw.asnumpy())
    for t, j in zip(ts, js):
        assert onp.allclose(t.numpy(), j.asnumpy())


def _rowsparse_case(seed=6, shape=(8, 5)):
    rs = onp.random.RandomState(seed)
    w = rs.uniform(-1, 1, shape).astype('float32')
    g = rs.uniform(-1, 1, shape).astype('float32')
    g[[0, 3, 4, 7]] = 0          # absent rows
    states = [rs.uniform(0, 1, shape).astype('float32') for _ in range(2)]
    return w, g, states


@pytest.mark.parametrize('lazy', [True, False])
@pytest.mark.parametrize('op,n_states,kw', [
    ('sgd_update', 0, dict(lr=0.1, wd=0.01)),
    ('sgd_mom_update', 1, dict(lr=0.1, momentum=0.9, wd=0.01)),
    ('adam_update', 2, dict(lr=0.01, wd=0.01, rescale_grad=0.5,
                            clip_gradient=0.4)),
])
def test_lazy_ops_match_jax_on_absent_rows(op, n_states, kw, lazy):
    """Every optimizer op that takes ``lazy_update``, on a gradient with
    absent (all-zero) rows: the port's op equals the JAX op."""
    w, g, states = _rowsparse_case()
    want = getattr(JO, op)(w, g, *states[:n_states], lazy_update=lazy, **kw)
    got = getattr(TO, op)(torch.from_numpy(w), torch.from_numpy(g),
                          *[torch.from_numpy(s) for s in states[:n_states]],
                          lazy_update=lazy, **kw)
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    for t, j in zip(got, want):
        onp.testing.assert_allclose(t.numpy(), onp.asarray(j), rtol=1e-6,
                                    atol=1e-7)
    if lazy:
        for t, s in zip(got, [w] + states[:n_states]):
            onp.testing.assert_array_equal(t.numpy()[[0, 3, 4, 7]],
                                           s[[0, 3, 4, 7]])


@pytest.mark.parametrize('stype', ['row_sparse', 'default'])
@pytest.mark.parametrize('cls,kw', [
    ('SGD', dict(learning_rate=0.1, wd=0.01)),
    ('SGD', dict(learning_rate=0.1, momentum=0.9, wd=0.01)),
    ('SGD', dict(learning_rate=0.1, momentum=0.9, lazy_update=False)),
    ('Adam', dict(learning_rate=0.05, wd=0.01)),
    ('Adam', dict(learning_rate=0.05, lazy_update=False)),
])
def test_lazy_update_only_on_row_sparse_grads(cls, kw, stype):
    """``lazy_update`` takes effect exactly when the gradient's stype is
    row_sparse, in every optimizer class the JAX package gives it."""
    w0, g, _ = _rowsparse_case(seed=7)
    jo = getattr(mj.optimizer, cls)(**kw)
    to = getattr(mt.optimizer, cls)(**kw)
    jw, tw = mj.nd.array(w0.copy()), torch.from_numpy(w0.copy())
    js, ts = jo.create_state(0, jw), to.create_state(0, tw)
    for _ in range(2):
        jg = mj.nd.array(g)
        if stype == 'row_sparse':
            jg = jsp.RowSparseNDArray(jg._data)
            tg = _port_grad(g)
        else:
            tg = torch.from_numpy(g)
        jo.update(0, jw, jg, js)
        to.update(0, tw, tg, ts)
    onp.testing.assert_allclose(tw.numpy(), jw.asnumpy(), rtol=1e-5,
                                atol=1e-7)
    jl = [] if js is None else ([js] if not isinstance(js, tuple) else js)
    tl = [] if ts is None else ([ts] if not isinstance(ts, tuple) else ts)
    for t, j in zip(tl, jl):
        onp.testing.assert_allclose(t.numpy(), j.asnumpy(), rtol=1e-5,
                                    atol=1e-7)
    # absent rows: frozen under a lazy update; moved by wd otherwise
    frozen = onp.array_equal(tw.numpy()[[0, 3]], w0[[0, 3]])
    if stype == 'row_sparse' and kw.get('lazy_update', True):
        assert frozen
    elif kw.get('wd'):
        assert not frozen


# ---- Gluon ------------------------------------------------------------

def _embedding_step(pkg, w0, vocab, dim, ids, opt, opt_kw):
    mx = PKGS[pkg][0]
    emb = mx.gluon.nn.Embedding(vocab, dim, sparse_grad=True)
    emb.initialize(mx.init.Normal(0.1))
    emb.weight.set_data(mx.nd.array(w0))
    trainer = mx.gluon.Trainer(emb.collect_params(), opt, opt_kw)
    x = mx.nd.array(ids)
    with mx.autograd.record():
        y = emb(x)
        loss = (y * y).sum()
    loss.backward()
    assert emb.weight.grad().stype == 'row_sparse'
    grad = emb.weight.grad().asnumpy()
    trainer.step(1)
    return emb.weight.data().asnumpy(), grad


def test_embedding_sparse_grad_end_to_end():
    """Embedding with sparse_grad trains only touched rows under lazy SGD
    (ref: test_module.py sparse embedding tests)."""
    vocab, dim = 10, 4
    w0 = onp.random.RandomState(8).normal(0, 0.1, (vocab, dim)) \
        .astype('float32')
    ids = onp.array([1, 3, 3], dtype='float32')
    kw = {'learning_rate': 0.5, 'momentum': 0.9}
    jw, jg = _embedding_step('jax', w0, vocab, dim, ids, 'sgd', kw)
    tw, tg = _embedding_step('port', w0, vocab, dim, ids, 'sgd', kw)
    onp.testing.assert_allclose(tg, jg, rtol=1e-6)
    onp.testing.assert_allclose(tw, jw, rtol=1e-6)
    untouched = [i for i in range(vocab) if i not in (1, 3)]
    assert onp.allclose(tw[untouched], w0[untouched])
    assert not onp.allclose(tw[[1, 3]], w0[[1, 3]])


def test_kvstore_row_sparse_pull():
    """ROADMAP item 8: the port's KVStore, row_sparse_pull included,
    raises naming it (the JAX package's local store pulls the rows)."""
    with pytest.raises(mt.MXNetError, match='item 8'):
        mt.kv.create('local')
    with pytest.raises(mt.MXNetError, match='item 8'):
        mt.kv.row_sparse_pull('w', out=tsp.zeros('row_sparse', (8, 3)),
                              row_ids=mt.nd.array(onp.array([2, 5])))


def test_sparse_grad_is_row_sparse_ndarray():
    for pkg, (mx, sp) in PKGS.items():
        emb = mx.gluon.nn.Embedding(6, 3, sparse_grad=True)
        emb.initialize(mx.init.Normal(0.1))
        x = mx.nd.array(onp.array([0, 2], dtype='float32'))
        with mx.autograd.record():
            loss = (emb(x) ** 2).sum()
        loss.backward()
        g = emb.weight.grad()
        assert isinstance(g, sp.RowSparseNDArray), pkg
        assert g.stype == 'row_sparse'
        assert sorted(g.indices.asnumpy().tolist()) == [0, 2]


def test_dot_csr_dense_storage_dispatch():
    """nd.dot with a CSR lhs routes through the sparse kernel
    (FComputeEx storage-driven dispatch, op_attr_types.h:304) and
    matches the dense result."""
    from mxnet_tpu_torch.ops import sparse_ops
    rng = onp.random.RandomState(0)
    dense = rng.randn(8, 6).astype('float32')
    dense[dense < 0.5] = 0.0
    r = rng.randn(6, 4).astype('float32')
    csr = tsp.csr_matrix(dense)
    rhs = mt.nd.array(r)
    before = sparse_ops.route_counts['dot_csr_dense']
    out = mt.nd.dot(csr, rhs)
    assert sparse_ops.route_counts['dot_csr_dense'] == before + 1
    onp.testing.assert_allclose(out.asnumpy(), dense @ r, rtol=1e-5,
                                atol=1e-5)
    want = mj.nd.dot(jsp.csr_matrix(dense), mj.nd.array(r)).asnumpy()
    onp.testing.assert_allclose(out.asnumpy(), want, rtol=1e-5, atol=1e-5)
    out2 = mt.nd.dot(mt.nd.array(dense), rhs)
    assert sparse_ops.route_counts['dot_csr_dense'] == before + 1
    onp.testing.assert_allclose(out2.asnumpy(), out.asnumpy(), rtol=1e-5,
                                atol=1e-5)
    # the nnz budget of the payload is counted once and cached
    assert csr._nnz_cache[1] == int((dense != 0).sum())


def test_dot_csr_dense_under_autograd():
    """The sparse route under autograd recording: gradients flow to the
    dense operand."""
    rng = onp.random.RandomState(1)
    dense = rng.randn(6, 5).astype('float32')
    dense[dense < 0.6] = 0.0
    w = rng.randn(5, 3).astype('float32')
    grads = {}
    for pkg, (mx, sp) in PKGS.items():
        csr = sp.csr_matrix(dense)
        W = mx.nd.array(w)
        W.attach_grad()
        with mx.autograd.record():
            loss = mx.nd.sum(mx.nd.dot(csr, W))
        loss.backward()
        grads[pkg] = W.grad.asnumpy()
    want = dense.T @ onp.ones((6, 3), 'float32')
    onp.testing.assert_allclose(grads['port'], want, rtol=1e-5, atol=1e-5)
    onp.testing.assert_allclose(grads['port'], grads['jax'], rtol=1e-5,
                                atol=1e-5)


def test_csr_parts_cached_per_payload(monkeypatch):
    """The accessors compute the compressed parts once per payload."""
    a = tsp.csr_matrix(onp.asarray([[1.0, 0.0], [0.0, 2.0]]))
    calls = {'n': 0}
    orig = onp.nonzero

    def counting_nonzero(*args, **kwargs):
        calls['n'] += 1
        return orig(*args, **kwargs)

    monkeypatch.setattr(onp, 'nonzero', counting_nonzero)
    _ = a.data, a.indices, a.indptr, a.data
    assert calls['n'] == 1, calls['n']
    # a write rebinds _data: exactly one recompute
    a[:] = onp.asarray([[0.0, 3.0], [4.0, 0.0]])
    idx = a.indices.asnumpy()
    ptr = a.indptr.asnumpy()
    _ = a.data
    assert calls['n'] == 2, calls['n']
    monkeypatch.undo()
    onp.testing.assert_array_equal(idx, [1, 0])
    onp.testing.assert_array_equal(ptr, [0, 1, 2])


def test_rowsparse_parts_cached_and_correct():
    for pkg, (mx, sp) in PKGS.items():
        r = sp.row_sparse_array(onp.asarray([[0.0, 0.0], [5.0, 6.0]]))
        onp.testing.assert_array_equal(r.indices.asnumpy(), [1])
        onp.testing.assert_array_equal(r.data.asnumpy(), [[5.0, 6.0]])
        r2 = copy.deepcopy(r)   # the deep copy carries the sparse slots
        assert r2.stype == 'row_sparse', pkg
        onp.testing.assert_array_equal(r2.indices.asnumpy(), [1])


# ---- the rest of the slice's surface ------------------------------------

def test_stype_casts_zeros_and_attach_grad():
    a = _rand_sparse((5, 4), 0.5, onp.random.RandomState(9))
    for pkg, (mx, sp) in PKGS.items():
        x = mx.nd.array(a)
        assert x.stype == 'default'
        for st in ('csr', 'row_sparse', 'default'):
            y = x.tostype(st)
            assert y.stype == st, (pkg, st)
            onp.testing.assert_array_equal(y.asnumpy(), a)
            onp.testing.assert_array_equal(
                sp.cast_storage(y, 'default').asnumpy(), a)
        z = sp.zeros('row_sparse', (3, 2))
        assert z.stype == 'row_sparse' and z.indices.asnumpy().size == 0
        w = mx.nd.array(a)
        w.attach_grad(stype='row_sparse')
        assert w.grad.stype == 'row_sparse', pkg
        with mx.autograd.record():
            loss = (mx.nd.take(w, mx.nd.array([1, 1, 3])) ** 2).sum()
        loss.backward()
        assert w.grad.stype == 'row_sparse', pkg
        assert sorted(w.grad.indices.asnumpy().tolist()) == \
            sorted({1, 3} & set(onp.nonzero(a.any(axis=1))[0].tolist()))


def test_parameter_stypes_and_row_sparse_data():
    w0 = onp.random.RandomState(10).randn(6, 3).astype('float32')
    outs = {}
    for pkg, (mx, sp) in PKGS.items():
        p = mx.gluon.Parameter('w', shape=(6, 3), stype='row_sparse',
                               grad_stype='row_sparse')
        p.initialize()
        p.set_data(mx.nd.array(w0))
        assert p.stype == 'row_sparse', pkg
        assert p._grad_stype == 'row_sparse'
        assert p.grad().stype == 'row_sparse'
        r = p.row_sparse_data(mx.nd.array([0, 4]))
        assert r.stype == 'row_sparse'
        (r2,) = p.list_row_sparse_data(mx.nd.array([0, 4]))
        onp.testing.assert_array_equal(r2.asnumpy(), r.asnumpy())
        outs[pkg] = r.asnumpy()
        q = mx.gluon.Parameter('q', shape=(2,))
        assert q.stype == 'default'
    onp.testing.assert_array_equal(outs['port'], outs['jax'])
    assert (outs['port'][[1, 2, 3, 5]] == 0).all()
    with pytest.raises(mt.MXNetError, match='storage type'):
        mt.gluon.Parameter('bad', shape=(2,), grad_stype='blocked')


def test_save_load_sparse_bitwise(tmp_path):
    """nd.save / nd.load of row_sparse and csr arrays: the reference's
    format, as far as the JAX package writes it (the dense payload): the
    two packages write the same bytes and read back the same values."""
    rs = onp.random.RandomState(11)
    a = _rand_sparse((6, 5), 0.4, rs)
    blobs, loaded = {}, {}
    for pkg, (mx, sp) in PKGS.items():
        f = str(tmp_path / f'{pkg}.nd')
        mx.nd.save(f, {'r': sp.row_sparse_array(a), 'c': sp.csr_matrix(a)})
        blobs[pkg] = open(f, 'rb').read()
        loaded[pkg] = {k: v.asnumpy() for k, v in mx.nd.load(f).items()}
    assert blobs['port'] == blobs['jax']
    for k in ('r', 'c'):
        onp.testing.assert_array_equal(loaded['port'][k], a)
        onp.testing.assert_array_equal(loaded['port'][k], loaded['jax'][k])


def test_sparse_embedding_trains_like_jax():
    vocab, dim = 12, 3
    w0 = onp.random.RandomState(12).randn(vocab, dim).astype('float32')
    ids = onp.array([2, 5, 5, 9], dtype='float32')
    outs = {}
    for pkg, (mx, sp) in PKGS.items():
        from importlib import import_module
        cnn = import_module(f'{mx.__name__}.gluon.contrib.nn')
        emb = cnn.SparseEmbedding(vocab, dim)
        emb.initialize()
        emb.weight.set_data(mx.nd.array(w0))
        tr = mx.gluon.Trainer(emb.collect_params(), 'adam',
                              {'learning_rate': 0.1})
        with mx.autograd.record():
            loss = (emb(mx.nd.array(ids)) ** 2).sum()
        loss.backward()
        assert emb.weight.grad().stype == 'row_sparse'
        tr.step(1)
        outs[pkg] = emb.weight.data().asnumpy()
    onp.testing.assert_allclose(outs['port'], outs['jax'], rtol=1e-5,
                                atol=1e-7)
    rest = [i for i in range(vocab) if i not in (2, 5, 9)]
    onp.testing.assert_array_equal(outs['port'][rest], w0[rest])


def test_rand_ndarray_and_compare_optimizer():
    from mxnet_tpu_torch import test_utils as tu
    onp.random.seed(13)
    for st in ('default', 'csr', 'row_sparse'):
        x = tu.rand_ndarray((20, 6), stype=st, density=0.3)
        assert x.stype == st
        a = x.asnumpy()
        assert a.shape == (20, 6) and (a != 0).any()
        if st == 'row_sparse':
            assert not (a != 0).any(axis=1).all()
    # the same optimizer twice agrees; lazy and exact Adam agree on a
    # dense gradient and not on a row-sparse one
    tu.compare_optimizer(mt.optimizer.SGD(learning_rate=0.1, momentum=0.9),
                         mt.optimizer.SGD(learning_rate=0.1, momentum=0.9),
                         [(4, 3), (5,)], 'float32', g_stype='row_sparse')
    tu.compare_optimizer(mt.optimizer.Adam(learning_rate=0.1),
                         mt.optimizer.Adam(learning_rate=0.1,
                                           lazy_update=False),
                         [(4, 3)], 'float32')
    with pytest.raises(AssertionError):      # wd moves the absent rows
        tu.compare_optimizer(
            mt.optimizer.Adam(learning_rate=0.1, wd=0.1),
            mt.optimizer.Adam(learning_rate=0.1, wd=0.1, lazy_update=False),
            [(6, 3)], 'float32', g_stype='row_sparse', ntrials=1)
    # the JAX helper takes the same arguments
    from mxnet_tpu import test_utils as ju
    ju.compare_optimizer(mj.optimizer.SGD(learning_rate=0.1),
                         mj.optimizer.SGD(learning_rate=0.1), [(4, 3)],
                         'float32', w_stype='default', g_stype='row_sparse',
                         ntrials=1)
    assert ju.rand_ndarray((3, 3), stype='csr').stype == 'csr'
