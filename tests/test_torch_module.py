"""The port's Module API (``mxnet_tpu_torch.module``, ``model``,
``callback``) against the JAX package, on the CPU.

``Module.fit`` from the same weights (carried across as numpy arrays) on
the same NDArrayIter batches gives the same parameters after every epoch
in both packages: an MLP ending in SoftmaxOutput with SGD and momentum,
and a conv/BatchNorm net (the JAX side under ``mxnet_tpu.autograd.
train_mode()``: its Executor does not enter training mode, ROADMAP queue
3). The checkpoint pair (``prefix-symbol.json``, ``prefix-NNNN.params``)
goes across the two packages both ways; ``Module.load`` then ``predict``
is bitwise the predictions before the save. The cases of
tests/test_misc_modules.py and test_train_e2e.py:240-330 that drive
Module run here at a few epochs on synthetic data, and the port twins of
tests/test_resilience.py's and test_checkpoint.py's Module cases (item
9's interrupt and checkpoint cases) close ROADMAP item 9.

Tolerance: f32; parameters after training agree to rel Frobenius 1e-5
(1e-4 through BatchNorm over two epochs), outputs to rtol 1e-5.
"""
import glob
import logging
import types

import numpy as onp
import pytest
import torch

import mxnet_tpu as mj
import mxnet_tpu_torch as mt
from mxnet_tpu_torch.base import MXNetError
from test_torch_jax_globals import jax_globals  # noqa: F401


@pytest.fixture(autouse=True)
def _port_on_cpu():
    with mt.cpu():
        yield


def _pkg(mx):
    return types.SimpleNamespace(mx=mx, nd=mx.nd, sym=mx.sym, mod=mx.module,
                                 io=mx.io, port=mx is mt)


JAX, PORT = _pkg(mj), _pkg(mt)


@pytest.fixture(params=['jax', 'port'])
def P(request):
    return JAX if request.param == 'jax' else PORT


def rel_fro(got, want):
    got = onp.asarray(got, onp.float64)
    want = onp.asarray(want, onp.float64)
    return float(onp.linalg.norm(got - want) /
                 max(onp.linalg.norm(want), 1e-30))


def mlp(sym):
    x = sym.Variable('data')
    h = sym.Activation(sym.FullyConnected(x, num_hidden=16, name='fc1'),
                       act_type='relu', name='relu1')
    return sym.SoftmaxOutput(sym.FullyConnected(h, num_hidden=2,
                                                name='fc2'),
                             sym.Variable('softmax_label'), name='softmax')


def convbn(sym):
    x = sym.Variable('data')
    c = sym.Convolution(x, kernel=(3, 3), num_filter=4, pad=(1, 1),
                        name='c1')
    bn = sym.BatchNorm(c, fix_gamma=False, name='bn1')
    a = sym.Activation(bn[0], act_type='relu', name='relu1')
    f = sym.FullyConnected(sym.Flatten(a, name='flat'), num_hidden=2,
                           name='fc')
    return sym.SoftmaxOutput(f, sym.Variable('softmax_label'), name='sm')


def toy(n=32, shape=(6,), seed=0):
    rng = onp.random.RandomState(seed)
    X = rng.randn(n, *shape).astype('float32')
    Y = (X.reshape(n, -1).sum(1) > 0).astype('float32')
    return X, Y


def init_values(net, data_shape, seed=1):
    """{name: numpy} for every parameter of ``net``, from numpy."""
    exe = net.simple_bind(mt.cpu(), data=data_shape,
                          softmax_label=(data_shape[0],))
    rng = onp.random.RandomState(seed)
    args = {n: (rng.randn(*a.shape) * 0.3).astype('float32')
            for n, a in exe.arg_dict.items()
            if n not in ('data', 'softmax_label')}
    aux = {n: (onp.ones if n.endswith('var') else onp.zeros)(a.shape,
                                                             'float32')
           for n, a in exe.aux_dict.items()}
    return args, aux


def fit(pkg, make, X, Y, args, aux, epochs, batch=8, contexts=None,
        module_kw=None, **kw):
    net = make(pkg.sym)
    ctx = contexts or [pkg.mx.cpu()]
    mod = pkg.mod.Module(net, data_names=('data',),
                         label_names=('softmax_label',), context=ctx,
                         **(module_kw or {}))
    it = pkg.io.NDArrayIter(X, Y, batch_size=batch,
                            label_name='softmax_label')
    trajectory = []

    def record(epoch, symbol, arg, aux_):
        trajectory.append({n: v.asnumpy() for n, v in arg.items()})
    mod.fit(it, num_epoch=epochs, optimizer='sgd',
            optimizer_params={'learning_rate': 0.1, 'momentum': 0.9,
                              **kw},
            arg_params={n: pkg.nd.array(v) for n, v in args.items()},
            aux_params={n: pkg.nd.array(v) for n, v in aux.items()},
            epoch_end_callback=record)
    return mod, trajectory


def test_module_fit_trajectory_matches_jax():
    X, Y = toy()
    args, aux = init_values(mlp(mt.sym), (8, 6))
    _, tt = fit(PORT, mlp, X, Y, args, aux, epochs=2)
    _, jt = fit(JAX, mlp, X, Y, args, aux, epochs=2)
    assert len(tt) == len(jt) == 2
    for te, je in zip(tt, jt):
        for n in args:
            assert rel_fro(te[n], je[n]) < 1e-5, n


def test_module_fit_through_batchnorm_matches_jax():
    """conv/BatchNorm/FC through Module.fit, 2 epochs: the parameters
    against the JAX package's (in train_mode, fault 1), the moving
    statistics against numpy's momentum formula over the batches."""
    X, Y = toy(32, (3, 6, 6), seed=2)
    args, aux = init_values(convbn(mt.sym), (8, 3, 6, 6))
    tmod, tt = fit(PORT, convbn, X, Y, args, aux, epochs=2, wd=1e-3)
    with mj.autograd.train_mode():
        _, jt = fit(JAX, convbn, X, Y, args, aux, epochs=2, wd=1e-3)
    for te, je in zip(tt, jt):
        for n in args:
            assert rel_fro(te[n], je[n]) < 1e-4, n
    _, taux = tmod.get_params()
    assert set(taux) == {'bn1_moving_mean', 'bn1_moving_var'}
    # 8 updates of momentum 0.9 from (0, 1): far from where they started
    assert onp.abs(taux['bn1_moving_mean'].asnumpy()).max() > 1e-3


def test_module_moving_stats_follow_the_momentum_formula():
    """One Module training step on BatchNorm over the data: moving mean
    0.9 * 0 + 0.1 * batch mean, moving variance 0.9 * 1 + 0.1 * the
    batch's biased variance; the JAX Module leaves them where they were
    (fault 1)."""
    x = (onp.random.RandomState(4).randn(8, 3, 2, 2) * 2 + 5) \
        .astype('float32')
    y = onp.zeros(8, 'float32')
    stats = {}
    for pkg in (PORT, JAX):
        bn = pkg.sym.BatchNorm(pkg.sym.Variable('data'), fix_gamma=True,
                               momentum=0.9, eps=1e-5, name='bn')
        out = pkg.sym.MakeLoss(pkg.sym.sum(bn[0], name='s'), name='loss')
        mod = pkg.mod.Module(out, data_names=('data',), label_names=None,
                             context=pkg.mx.cpu())
        mod.bind(data_shapes=[('data', x.shape)])
        mod.init_params()
        mod.forward(pkg.io.DataBatch([pkg.nd.array(x)], None),
                    is_train=True)
        stats[pkg.port] = {n: v.asnumpy()
                           for n, v in mod.get_params()[1].items()}
    onp.testing.assert_allclose(stats[True]['bn_moving_mean'],
                                0.1 * x.mean(axis=(0, 2, 3)), rtol=1e-5)
    onp.testing.assert_allclose(stats[True]['bn_moving_var'],
                                0.9 + 0.1 * x.var(axis=(0, 2, 3)),
                                rtol=1e-5)
    assert not stats[False]['bn_moving_mean'].any()


def test_two_contexts_sum_and_rescale_like_one():
    """A batch split over two contexts: gradients summed per parameter
    and scaled by 1/batch, so the updates equal one context's."""
    X, Y = toy()
    args, aux = init_values(mlp(mt.sym), (8, 6))
    _, one = fit(PORT, mlp, X, Y, args, aux, epochs=1)
    _, two = fit(PORT, mlp, X, Y, args, aux, epochs=1,
                 contexts=[mt.cpu(0), mt.cpu(0)])
    for n in args:
        assert rel_fro(two[0][n], one[0][n]) < 1e-5, n


def test_fixed_param_names_stay_and_others_move():
    X, Y = toy()
    args, aux = init_values(mlp(mt.sym), (8, 6))
    mod = mt.module.Module(mlp(mt.sym), fixed_param_names=['fc1_weight'])
    it = mt.io.NDArrayIter(X, Y, batch_size=8)
    mod.fit(it, num_epoch=1,
            arg_params={n: mt.nd.array(v) for n, v in args.items()})
    got = {n: v.asnumpy() for n, v in mod.get_params()[0].items()}
    onp.testing.assert_array_equal(got['fc1_weight'], args['fc1_weight'])
    assert not onp.allclose(got['fc2_weight'], args['fc2_weight'])
    assert mod._execs[0].grad_dict.get('fc1_weight') is None


def test_get_params_are_copies():
    X, Y = toy()
    args, aux = init_values(mlp(mt.sym), (8, 6))
    mod = mt.module.Module(mlp(mt.sym))
    it = mt.io.NDArrayIter(X, Y, batch_size=8)
    mod.fit(it, num_epoch=1,
            arg_params={n: mt.nd.array(v) for n, v in args.items()})
    before = mod.get_params()[0]['fc2_weight'].asnumpy().copy()
    held = mod.get_params()[0]['fc2_weight']
    it.reset()
    mod.forward_backward(next(iter(it)))
    mod.update()
    onp.testing.assert_array_equal(held.asnumpy(), before)
    assert not onp.array_equal(mod.get_params()[0]['fc2_weight'].asnumpy(),
                               before)


@pytest.mark.parametrize('direction', ['port_saves', 'jax_saves'])
def test_checkpoint_pair_loads_across(tmp_path, direction):
    """save_checkpoint in one package, load_checkpoint and Module.load in
    the other: the same symbol, parameters and predictions."""
    X, Y = toy(16)
    args, aux = init_values(convbn(mt.sym), (8, 3, 6, 6))
    X = onp.random.RandomState(5).randn(16, 3, 6, 6).astype('float32')
    src, dst = (PORT, JAX) if direction == 'port_saves' else (JAX, PORT)
    prefix = str(tmp_path / 'net')
    src.mx.model.save_checkpoint(
        prefix, 3, convbn(src.sym),
        {n: src.nd.array(v) for n, v in args.items()},
        {n: src.nd.array(v + 0.5) for n, v in aux.items()})
    sym, arg, auxp = dst.mx.model.load_checkpoint(prefix, 3)
    assert sym.tojson() == convbn(dst.sym).tojson()
    for n, v in args.items():
        onp.testing.assert_array_equal(arg[n].asnumpy(), v)
    for n, v in aux.items():
        onp.testing.assert_array_equal(auxp[n].asnumpy(), v + 0.5)
    preds = []
    for pkg in (src, dst):
        mod = pkg.mod.Module.load(prefix, 3, context=pkg.mx.cpu()) \
            if pkg.port else _jax_loaded(prefix)
        mod.bind(data_shapes=[('data', (8, 3, 6, 6))],
                 label_shapes=[('softmax_label', (8,))], for_training=False)
        preds.append(mod.predict(pkg.io.NDArrayIter(X, batch_size=8))
                     .asnumpy())
    onp.testing.assert_allclose(preds[0], preds[1], rtol=1e-5, atol=1e-6)


def _jax_loaded(prefix):
    """The JAX Module of a checkpoint: its Module.load keeps the arrays
    aside, so init_params takes them after bind."""
    sym, arg, aux = mj.model.load_checkpoint(prefix, 3)
    mod = mj.module.Module(sym, context=mj.cpu())

    class Loaded:
        def bind(self, **kw):
            mod.bind(**kw)
            mod.init_params(arg_params=arg, aux_params=aux)

        def predict(self, it):
            return mod.predict(it)
    return Loaded()


def test_label_and_explicit_weight_shapes_are_inferred():
    """As MXNet infers them: an explicit weight variable takes the
    auto-created parameter's rule by position, and SoftmaxOutput's label
    the data's leading dimensions, so a checkpoint's Module binds for
    prediction with the data shape alone."""
    x = mt.sym.Variable('data')
    out = mt.sym.SoftmaxOutput(
        mt.sym.FullyConnected(x, mt.sym.Variable('w'), mt.sym.Variable('b'),
                              num_hidden=3, name='fc'),
        mt.sym.Variable('softmax_label'), name='sm')
    args, outs, _ = out.infer_shape(data=(4, 5))
    assert args == [(4, 5), (3, 5), (3,), (4,)] and outs == [(4, 3)]
    mod = mt.module.Module(out, context=mt.cpu())
    mod.bind(data_shapes=[('data', (4, 5))], for_training=False)
    assert mod._execs[0].arg_dict['softmax_label'].shape == (4,)


def test_module_load_predicts_bitwise_and_restores_optimizer(tmp_path):
    X, Y = toy(32, (3, 6, 6), seed=6)
    args, aux = init_values(convbn(mt.sym), (8, 3, 6, 6))
    mod, _ = fit(PORT, convbn, X, Y, args, aux, epochs=1)
    it = mt.io.NDArrayIter(X, batch_size=8)
    before = mod.predict(it).asnumpy()
    prefix = str(tmp_path / 'm')
    mod.save_checkpoint(prefix, 1, save_optimizer_states=True)
    loaded = mt.module.Module.load(prefix, 1, load_optimizer_states=True,
                                   context=mt.cpu())
    loaded.bind(data_shapes=it.provide_data,
                label_shapes=[('softmax_label', (8,))], for_training=True)
    after = loaded.predict(it).asnumpy()
    assert after.tobytes() == before.tobytes()
    loaded.init_optimizer(optimizer='sgd',
                          optimizer_params={'learning_rate': 0.1,
                                            'momentum': 0.9})
    assert set(loaded._updater.states) == set(mod._updater.states)
    for k, v in mod._updater.states.items():
        onp.testing.assert_array_equal(loaded._updater.states[k].numpy(),
                                       v.numpy())


def test_score_and_predict(P):
    X, Y = toy()
    args, aux = init_values(mlp(mt.sym), (8, 6))
    mod = P.mod.Module(mlp(P.sym), context=P.mx.cpu())
    mod.bind(data_shapes=[('data', (8, 6))],
             label_shapes=[('softmax_label', (8,))])
    mod.init_params(arg_params={n: P.nd.array(v) for n, v in args.items()})
    it = P.io.NDArrayIter(X, Y, batch_size=8, label_name='softmax_label')
    score = dict(mod.score(it, 'acc'))
    pred = mod.predict(it).asnumpy()
    assert pred.shape == (32, 2)
    acc = float((pred.argmax(1) == Y).mean())
    assert abs(score['accuracy'] - acc) < 1e-6


def test_module_fit_with_auto_created_params_learns(P):
    """test_train_e2e.py:test_module_fit_with_auto_created_params at a
    few epochs on separable synthetic data."""
    P.mx.random.seed(2)
    X, Y = toy(256, (10,), seed=3)
    out = mlp(P.sym)
    assert 'fc1_weight' in out.list_arguments()
    mod = P.mod.Module(out, context=P.mx.cpu())
    it = P.io.NDArrayIter(X, Y, batch_size=32, label_name='softmax_label')
    mod.fit(it, optimizer='sgd',
            optimizer_params={'learning_rate': 0.1, 'momentum': 0.9},
            initializer=P.mx.init.Xavier(), num_epoch=6)
    assert dict(mod.score(it, 'acc'))['accuracy'] >= 0.9


def test_batchnorm_auto_params_are_aux_states(P):
    X, _ = toy(32, (3, 8, 8), seed=0)
    X = onp.random.RandomState(0).rand(32, 3, 8, 8).astype('f')
    Y = (X.mean(axis=(1, 2, 3)) > 0.5).astype('f')
    mod = P.mod.Module(convbn(P.sym), context=P.mx.cpu(0))
    it = P.io.NDArrayIter(X, Y, batch_size=8, label_name='softmax_label')
    mod.fit(it, optimizer='sgd',
            optimizer_params={'learning_rate': 0.1, 'wd': 0.01},
            initializer=P.mx.init.Xavier(), num_epoch=2)
    _, auxp = mod.get_params()
    assert set(auxp) == {'bn1_moving_mean', 'bn1_moving_var'}
    assert 'bn1_moving_var' not in mod._execs[0].grad_dict


def test_module_fit_with_monitor(P, caplog):
    X, Y = toy()
    mod = P.mod.Module(mlp(P.sym), context=P.mx.cpu(0))
    it = P.io.NDArrayIter(X, Y, batch_size=16, label_name='softmax_label')
    mon = P.mx.monitor.Monitor(interval=1)
    with caplog.at_level(logging.INFO):
        mod.fit(it, num_epoch=1, monitor=mon,
                optimizer_params=(('learning_rate', 0.1),))
    assert any('fc1_output' in r.message for r in caplog.records)


def test_module_accepts_group2ctxs(P):
    x = P.sym.Variable('data')
    with P.mx.AttrScope(ctx_group='g'):
        out = P.sym.FullyConnected(x, P.sym.Variable('fc_weight',
                                                     shape=(4, 8)),
                                   P.sym.Variable('fc_bias', shape=(4,)),
                                   num_hidden=4, name='fc')
    mod = P.mod.Module(out, data_names=('data',), label_names=None,
                       context=P.mx.cpu(0),
                       group2ctxs={'g': P.mx.cpu(0)})
    mod.bind(data_shapes=[('data', (2, 8))], for_training=False)
    mod.init_params()
    mod.forward(P.io.DataBatch([P.nd.ones((2, 8))], None), is_train=False)
    assert mod.get_outputs()[0].shape == (2, 4)


def test_bucketing_module_buckets_share_weights():
    """Two buckets of different lengths train one set of weights: a step
    in bucket 8 moves what bucket 4 reads."""
    def sym_gen(key):
        x = mt.sym.Variable('data')
        h = mt.sym.FullyConnected(x, mt.sym.Variable('w'), None,
                                  num_hidden=2, no_bias=True, flatten=False,
                                  name='fc')
        out = mt.sym.MakeLoss(mt.sym.sum(h, name='s'), name='loss')
        return out, ('data',), None
    mod = mt.module.BucketingModule(sym_gen, default_bucket_key=8,
                                    context=mt.cpu())
    mod.bind(data_shapes=[('data', (2, 8, 3))], for_training=True)
    mod.init_params(arg_params={'w': mt.nd.ones((2, 3))})
    mod.init_optimizer(optimizer_params={'learning_rate': 0.5,
                                         'rescale_grad': 1.0})
    small = mt.io.DataBatch([mt.nd.ones((2, 4, 3))], None, bucket_key=4,
                            provide_data=[('data', (2, 4, 3))])
    mod.forward(small, is_train=True)
    mod.backward()
    mod.update()
    w4 = mod.get_params()[0]['w'].asnumpy()
    onp.testing.assert_allclose(w4, 1 - 0.5 * 8)    # 2 x 4 rows of ones
    big = mt.io.DataBatch([mt.nd.ones((2, 8, 3))], None, bucket_key=8,
                          provide_data=[('data', (2, 8, 3))])
    mod.forward(big, is_train=False)
    onp.testing.assert_allclose(mod.get_outputs()[0].asnumpy(),
                                (2 * 8 * 3 * 2) * (1 - 4.0))


def test_sequential_module_chains_and_backpropagates():
    """Two Modules chained give the gradients of the one-Module graph."""
    X, Y = toy(16, (6,), seed=8)
    args, _ = init_values(mlp(mt.sym), (8, 6))
    x = mt.sym.Variable('data')
    first = mt.sym.Activation(mt.sym.FullyConnected(x, num_hidden=16,
                                                    name='fc1'),
                              act_type='relu', name='relu1')
    second = mt.sym.SoftmaxOutput(
        mt.sym.FullyConnected(mt.sym.Variable('data'), num_hidden=2,
                              name='fc2'),
        mt.sym.Variable('softmax_label'), name='softmax')
    seq = mt.module.SequentialModule()
    seq.add(mt.module.Module(first, label_names=None, context=mt.cpu()))
    seq.add(mt.module.Module(second, context=mt.cpu()))
    seq.bind(data_shapes=[('data', (8, 6))],
             label_shapes=[('softmax_label', (8,))])
    arg_nd = {n: mt.nd.array(v) for n, v in args.items()}
    seq.init_params(arg_params=arg_nd, allow_missing=True)
    one = mt.module.Module(mlp(mt.sym), context=mt.cpu())
    one.bind(data_shapes=[('data', (8, 6))],
             label_shapes=[('softmax_label', (8,))])
    one.init_params(arg_params=arg_nd)
    batch = mt.io.DataBatch([mt.nd.array(X[:8])], [mt.nd.array(Y[:8])])
    for m in (seq, one):
        m.forward(batch, is_train=True)
        m.backward()
    onp.testing.assert_allclose(seq.get_outputs()[0].asnumpy(),
                                one.get_outputs()[0].asnumpy(), rtol=1e-6)
    g_seq = seq._modules[0]._execs[0].grad_dict['fc1_weight'].asnumpy()
    g_one = one._execs[0].grad_dict['fc1_weight'].asnumpy()
    assert rel_fro(g_seq, g_one) < 1e-6


def test_callbacks_run(P, tmp_path, caplog):
    """Speedometer, ProgressBar, log_train_metric and do_checkpoint in
    fit (legacy prefix files)."""
    X, Y = toy()
    mod = P.mod.Module(mlp(P.sym), context=P.mx.cpu())
    it = P.io.NDArrayIter(X, Y, batch_size=8, label_name='softmax_label')
    cb = P.mx.callback
    prefix = str(tmp_path / 'cb')
    with caplog.at_level(logging.INFO):
        mod.fit(it, num_epoch=2,
                batch_end_callback=[cb.Speedometer(8, frequent=2),
                                    cb.ProgressBar(4),
                                    cb.log_train_metric(2)],
                epoch_end_callback=cb.do_checkpoint(prefix, period=2))
    assert sorted(glob.glob(prefix + '*')) == [prefix + '-0002.params',
                                              prefix + '-symbol.json']
    assert any('samples/sec' in r.message for r in caplog.records)


# ---------------------------------------------------------------------------
# Item 9's Module cases: the port twins of tests/test_resilience.py and
# tests/test_checkpoint.py
# ---------------------------------------------------------------------------

def _fc_module():
    data = mt.sym.Variable('data')
    out = mt.sym.FullyConnected(data, num_hidden=2, name='fc')
    out = mt.sym.SoftmaxOutput(out, mt.sym.Variable('softmax_label'),
                               name='softmax')
    return mt.module.Module(out, data_names=('data',),
                            label_names=('softmax_label',))


def test_module_fit_keyboard_interrupt_saves_and_exits(tmp_path, caplog):
    from mxnet_tpu_torch import checkpoint
    x, y = toy()
    mod = _fc_module()
    mgr = checkpoint.CheckpointManager(str(tmp_path), async_save=False)
    calls = {'n': 0}

    def interrupt_cb(param):
        calls['n'] += 1
        if calls['n'] == 3:
            raise KeyboardInterrupt

    logger = logging.getLogger('mxtpu_torch.test.module')
    mod.logger = logger
    with caplog.at_level(logging.WARNING, logger=logger.name):
        mod.fit(mt.io.NDArrayIter(x, y, batch_size=8), num_epoch=50,
                batch_end_callback=interrupt_cb, checkpoint_manager=mgr)
    assert mgr.latest_step() == 2          # saved at the last whole step
    assert any('resumable from step 2' in r.message
               for r in caplog.records)
    ck = mgr.restore_latest(apply=False)
    assert any(k.startswith('arg:') for k in ck.params)


def test_module_fit_autosave_commits_real_params(tmp_path):
    from mxnet_tpu_torch import checkpoint
    x, y = toy()
    mod = _fc_module()
    mgr = checkpoint.CheckpointManager(str(tmp_path), async_save=False,
                                       autosave_steps=2, keep_last_n=10)
    mod.fit(mt.io.NDArrayIter(x, y, batch_size=8), num_epoch=1,
            checkpoint_manager=mgr)
    assert mgr.all_steps() == [2, 4]       # 4 batches, cadence every 2
    ck = mgr.restore_latest(apply=False)
    w = ck.params['arg:fc_weight']
    onp.testing.assert_array_equal(
        w, mod.get_params()[0]['fc_weight'].asnumpy())
    assert mgr._params is None             # provider unbound after fit


def test_do_checkpoint_callback_routes_through_manager(tmp_path):
    from mxnet_tpu_torch.callback import do_checkpoint
    from mxnet_tpu_torch.checkpoint import CheckpointManager
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    cb = do_checkpoint('unused-prefix', period=2, manager=mgr)
    net_sym = mt.sym.fully_connected(mt.sym.var('data'), num_hidden=2,
                                     name='fc')
    arg = {'fc_weight': mt.nd.ones((2, 3))}
    aux = {'bn_mean': mt.nd.zeros((3,))}
    cb(0, net_sym, arg, aux)
    assert mgr.all_steps() == []
    cb(1, net_sym, arg, aux)
    assert mgr.all_steps() == [2]
    ck = mgr.restore_latest(apply=False)
    assert set(ck.params) == {'arg:fc_weight', 'aux:bn_mean'}
    assert ck.blobs['symbol'] == net_sym.tojson().encode('utf-8')
    assert glob.glob(str(tmp_path / 'unused-prefix*')) == []
    mgr.close()


def test_module_checkpoint_callback_resumes_the_optimizer(tmp_path):
    """module_checkpoint through a manager carries the updater's states;
    a new Module restores params and states from it and continues as the
    first would have."""
    from mxnet_tpu_torch.callback import module_checkpoint
    from mxnet_tpu_torch.checkpoint import CheckpointManager
    x, y = toy()
    mod = _fc_module()
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    it = mt.io.NDArrayIter(x, y, batch_size=8)
    mod.fit(it, num_epoch=2, optimizer_params={'learning_rate': 0.1,
                                               'momentum': 0.9},
            epoch_end_callback=module_checkpoint(
                mod, 'unused', save_optimizer_states=True, manager=mgr))
    assert mgr.all_steps() == [1, 2]
    ck = mgr.restore_latest(apply=False)
    arg = {k[4:]: mt.nd.array(v) for k, v in ck.params.items()
           if k.startswith('arg:')}
    mod2 = _fc_module()
    mod2.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
    mod2.init_params(arg_params=arg)
    mod2.init_optimizer(optimizer_params={'learning_rate': 0.1,
                                          'momentum': 0.9})
    mod2._updater.set_states(ck.trainer_states)
    mod2._optimizer = mod2._updater.optimizer
    it.reset()
    batch = next(iter(it))
    for m in (mod, mod2):
        m.forward_backward(batch)
        m.update()
    onp.testing.assert_allclose(mod2.get_params()[0]['fc_weight'].asnumpy(),
                                mod.get_params()[0]['fc_weight'].asnumpy(),
                                rtol=1e-6)
    mgr.close()


@pytest.mark.parametrize('ctype', ['2bit', 'fp16', 'int8'])
def test_module_refuses_compression_params(ctype):
    """tests/test_compression.py::test_module_routes_compression_params:
    ``compression_params`` compress each summed gradient in
    ``Module.update`` with an error-feedback residual per parameter, the
    fit's parameters the JAX Module's within rel 1e-5 after each epoch;
    an unknown codec is refused, as in the JAX package."""
    X, Y = toy()
    args, aux = init_values(mlp(mt.sym), (8, 6))
    comp = {'type': ctype, 'threshold': 0.1}
    tm, tt = fit(PORT, mlp, X, Y, args, aux, epochs=2,
                 module_kw=dict(compression_params=comp))
    jm, jt = fit(JAX, mlp, X, Y, args, aux, epochs=2,
                 module_kw=dict(compression_params=comp))
    assert tm._compression is not None and tm._compression._residual
    assert sorted(tm._compression._residual) == \
        sorted(jm._compression._residual)
    _, plain = fit(PORT, mlp, X, Y, args, aux, epochs=1)
    assert any(rel_fro(tt[0][n], plain[0][n]) > 0 for n in args)
    for te, je in zip(tt, jt):
        for n in args:
            assert rel_fro(te[n], je[n]) < 1e-5, n
    with pytest.raises(MXNetError, match='not supported'):
        mt.module.Module(mlp(mt.sym), compression_params={'type': 'bogus'})
