"""``contrib.svrg_optimization.SVRGModule`` of the port against the JAX
package's, on the CPU.

The three cases of tests/test_svrg.py (convergence on linear
regression, the full-gradient snapshot against 2/N X^T (Xw - y), the fit
loop) run through both packages, and from the same initial weights on
the same batches both packages follow the same trajectory within 1e-5
(f32) over every epoch, through ``update_full_grads`` plus
``forward_backward_svrg``/``update`` and through ``fit``.
"""
import numpy as onp
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu.contrib.svrg_optimization import SVRGModule as JSVRG
from mxnet_tpu_torch.contrib.svrg_optimization import SVRGModule as TSVRG
from test_torch_jax_globals import jax_globals  # noqa: F401

PKGS = {'jax': (jmx, JSVRG), 'port': (mx, TSVRG)}
TOL = 1e-5


@pytest.fixture(autouse=True)
def _cpu():
    with mx.cpu():
        yield


def _linreg_problem(pkg, init_w=True):
    m, svrg = PKGS[pkg]
    rng = onp.random.RandomState(0)
    X = rng.randn(200, 5).astype(onp.float32)
    w_true = rng.randn(5, 1).astype(onp.float32)
    Y = (X @ w_true).astype(onp.float32)
    sym = m.symbol
    data = sym.var('data')
    w = sym.var('w', shape=(5, 1))
    label = sym.var('lin_label')
    loss = sym.MakeLoss(sym.mean(sym.square(sym.dot(data, w) - label)))
    mod = svrg(loss, data_names=('data',), label_names=('lin_label',),
               update_freq=2)
    mod.bind(data_shapes=[('data', (20, 5))],
             label_shapes=[('lin_label', (20, 1))])
    it = m.io.NDArrayIter(X, Y, batch_size=20, label_name='lin_label')
    if init_w:
        w0 = onp.random.RandomState(1).normal(0, 0.1, (5, 1)) \
            .astype(onp.float32)
        mod.init_params(arg_params={'w': m.nd.array(w0)})
    else:
        mod.init_params(m.init.Normal(0.1))
    mod.init_optimizer(optimizer='sgd',
                       optimizer_params=(('learning_rate', 0.05),
                                         ('rescale_grad', 1.0)))
    return mod, it, X, Y


def _loss(mod, X, Y):
    w_est = mod.get_params()[0]['w'].asnumpy()
    return float(onp.mean((X @ w_est - Y) ** 2))


def _svrg_epochs(mod, it, epochs):
    ws = []
    for epoch in range(epochs):
        if epoch % mod.update_freq == 0:
            mod.update_full_grads(it)
        it.reset()
        for batch in it:
            mod.forward_backward_svrg(batch)
            mod.update()
        ws.append(mod.get_params()[0]['w'].asnumpy())
    return ws


@pytest.mark.parametrize('pkg', ['jax', 'port'])
def test_svrg_converges_on_linreg(pkg):
    mod, it, X, Y = _linreg_problem(pkg, init_w=False)
    l0 = _loss(mod, X, Y)
    _svrg_epochs(mod, it, 6)
    assert _loss(mod, X, Y) < l0 * 0.1


@pytest.mark.parametrize('pkg', ['jax', 'port'])
def test_svrg_full_grads_snapshot(pkg):
    mod, it, X, Y = _linreg_problem(pkg)
    mod.update_full_grads(it)
    assert mod._full_grads is not None and 'w' in mod._full_grads
    w0 = mod.get_params()[0]['w'].asnumpy()
    expect = 2.0 / X.shape[0] * X.T @ (X @ w0 - Y)
    got = mod._full_grads['w']
    got = got.cpu().numpy() if hasattr(got, 'cpu') else onp.asarray(got)
    assert onp.allclose(got, expect, rtol=1e-3, atol=1e-4), \
        onp.abs(got - expect).max()


@pytest.mark.parametrize('pkg', ['jax', 'port'])
def test_svrg_fit_loop(pkg):
    mod, it, X, Y = _linreg_problem(pkg, init_w=False)
    mod.fit(it, eval_metric='mse', optimizer='sgd',
            optimizer_params=(('learning_rate', 0.05), ('rescale_grad', 1.0)),
            num_epoch=4)
    assert _loss(mod, X, Y) < 0.2


def test_svrg_trajectories_agree():
    traj = {pkg: _svrg_epochs(*_linreg_problem(pkg)[:2], 5)
            for pkg in PKGS}
    for e, (got, want) in enumerate(zip(traj['port'], traj['jax'])):
        onp.testing.assert_allclose(got, want, rtol=TOL, atol=TOL,
                                    err_msg=f'epoch {e}')
    mods = {pkg: _linreg_problem(pkg)[:2] for pkg in PKGS}
    grads = {}
    for pkg, (mod, it) in mods.items():
        mod.update_full_grads(it)
        g = mod._full_grads['w']
        grads[pkg] = g.cpu().numpy() if hasattr(g, 'cpu') else onp.asarray(g)
    onp.testing.assert_allclose(grads['port'], grads['jax'], rtol=TOL,
                                atol=TOL)


def test_svrg_fit_trajectories_agree():
    seen = {}
    for pkg in PKGS:
        mod, it, _, _ = _linreg_problem(pkg)
        ws = []
        metric = mod.fit(
            it, eval_metric='mse', optimizer='sgd',
            optimizer_params=(('learning_rate', 0.05),
                              ('rescale_grad', 1.0)), num_epoch=3,
            epoch_end_callback=lambda e, s, a, x: ws.append(
                a['w'].asnumpy()))
        seen[pkg] = (ws, metric.get()[1])
    for got, want in zip(seen['port'][0], seen['jax'][0]):
        onp.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    onp.testing.assert_allclose(seen['port'][1], seen['jax'][1], rtol=1e-4)


def test_svrg_step_needs_a_snapshot():
    mod, it, _, _ = _linreg_problem('port')
    it.reset()
    with pytest.raises(ValueError, match='update_full_grads'):
        mod.forward_backward_svrg(next(iter(it)))


def test_svrg_fit_takes_a_kvstore_object_like_jax():
    """``fit(kvstore=...)`` takes a KVStore object as well as a type name
    (the Module's update pushes nothing through it, in both packages): the
    trajectory is the JAX module's."""
    seen = {}
    for pkg, (m, _) in PKGS.items():
        mod, it, _, _ = _linreg_problem(pkg)
        ws = []
        mod.fit(it, eval_metric='mse', kvstore=m.kv.create('device'),
                optimizer='sgd',
                optimizer_params=(('learning_rate', 0.05),
                                  ('rescale_grad', 1.0)), num_epoch=2,
                epoch_end_callback=lambda e, s, a, x: ws.append(
                    a['w'].asnumpy()))
        seen[pkg] = ws
    for got, want in zip(seen['port'], seen['jax']):
        onp.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
