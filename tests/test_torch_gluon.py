"""The port's Gluon API against the JAX package's, on the CPU.

Every case of tests/test_gluon.py runs through both packages with the
same code (the ``P`` fixture hands it one package's ``mx``, ``nd``,
``autograd``, ``gluon``, ``nn``; the port inside ``with mx.cpu():``, its
default context being the card). Then the ops the layers stand on
(convolution, pooling, batch_norm, ...), every loss and the layers are
held against the JAX package on the same numpy inputs and weights, the
initializers by their statistics, and the Parameter/Block semantics the
port keeps (grad_req, deferred initialisation, the two notions of
training, .params files both ways).

Tolerance: f32 everywhere; results the two compute in another summation
order agree to rtol 1e-5, atol 1e-6 (1e-5 where a convolution sums a
few hundred products), gradients to rel Frobenius 1e-5.

Weights never come from the two packages' generators (jax/numpy there,
torch here): they are carried across by structured name
(``_collect_params_with_prefix``), so a test never depends on the
global ``_BlockScope`` counters that name ``dense0_``, ``dense11_``...
"""
import types

import numpy as onp
import pytest
import torch

import mxnet_tpu as mj
import mxnet_tpu_torch as mt
from mxnet_tpu import gluon as jgluon
from mxnet_tpu_torch import gluon as tgluon
from mxnet_tpu_torch.base import MXNetError
from test_torch_jax_globals import jax_globals  # noqa: F401


RTOL, ATOL = 1e-5, 1e-6


def _pkg(mx, gluon):
    return types.SimpleNamespace(mx=mx, nd=mx.nd, autograd=mx.autograd,
                                 gluon=gluon, nn=gluon.nn, loss=gluon.loss,
                                 init=mx.init, port=mx is mt)


JAX, PORT = _pkg(mj, jgluon), _pkg(mt, tgluon)


@pytest.fixture(autouse=True)
def _port_on_cpu():
    with mt.cpu():
        yield


@pytest.fixture(params=['jax', 'port'])
def P(request):
    return JAX if request.param == 'jax' else PORT


def _np(v):
    if isinstance(v, (mj.nd.NDArray, mt.nd.NDArray)):
        return v.asnumpy()
    if isinstance(v, torch.Tensor):
        return v.detach().float().numpy()
    return onp.asarray(v)


def close(got, want, rtol=RTOL, atol=ATOL):
    g, w = _np(got), _np(want)
    assert g.shape == w.shape, (g.shape, w.shape)
    onp.testing.assert_allclose(g, w, rtol=rtol, atol=atol)


def rel_fro(got, want):
    g, w = _np(got).astype(onp.float64), _np(want).astype(onp.float64)
    return onp.linalg.norm(g - w) / max(onp.linalg.norm(w), 1e-30)


def carry(jnet, tnet):
    """The JAX block's values into the port block, by structured name."""
    src = {k: p.data().asnumpy()
           for k, p in jnet._collect_params_with_prefix().items()}
    dst = tnet._collect_params_with_prefix()
    assert sorted(src) == sorted(dst)
    for k, v in src.items():
        dst[k].set_data(mt.nd.array(v))


# ---- every case of tests/test_gluon.py, through both packages -----------

def test_dense_forward(P):
    nd, nn = P.nd, P.nn
    net = nn.Dense(4, in_units=3)
    net.initialize()
    x = nd.ones((2, 3))
    out = net(x)
    assert out.shape == (2, 4)
    w = net.weight.data().asnumpy()
    b = net.bias.data().asnumpy()
    close(out, onp.ones((2, 3)).dot(w.T) + b)


def test_deferred_init(P):
    net = P.nn.Dense(4)
    net.initialize()
    out = net(P.nd.ones((2, 7)))
    assert out.shape == (2, 4)
    assert net.weight.shape == (4, 7)


def test_sequential(P):
    nn = P.nn
    net = nn.HybridSequential()
    net.add(nn.Dense(8, activation='relu'))
    net.add(nn.Dense(3))
    net.initialize()
    out = net(P.nd.ones((2, 5)))
    assert out.shape == (2, 3)
    assert len(net) == 2
    assert isinstance(net[0], nn.Dense)


def test_collect_params_naming(P):
    nn = P.nn
    net = nn.HybridSequential(prefix='model_')
    with net.name_scope():
        net.add(nn.Dense(4))
        net.add(nn.Dense(2))
    names = list(net.collect_params().keys())
    assert all(n.startswith('model_') for n in names)
    assert len(names) == 4
    assert [n[len('model_'):] for n in names] == [
        'dense0_weight', 'dense0_bias', 'dense1_weight', 'dense1_bias']


def test_param_save_load(P, tmp_path):
    nn = P.nn
    net = nn.Dense(3, in_units=2)
    net.initialize()
    fname = str(tmp_path / 'p.params')
    net.save_parameters(fname)
    net2 = nn.Dense(3, in_units=2)
    net2.load_parameters(fname)
    close(net.weight.data(), net2.weight.data(), 0, 0)


def test_conv_pool(P):
    nn = P.nn
    net = nn.HybridSequential()
    net.add(nn.Conv2D(4, kernel_size=3, padding=1, activation='relu'))
    net.add(nn.MaxPool2D(2, 2))
    net.initialize()
    out = net(P.nd.ones((2, 3, 8, 8)))
    assert out.shape == (2, 4, 4, 4)


def test_batchnorm_train_inference(P):
    nd = P.nd
    net = P.nn.BatchNorm(in_channels=3)
    net.initialize()
    xn = onp.random.RandomState(0).randn(4, 3, 2, 2).astype(onp.float32)
    x = nd.array(xn)
    with P.autograd.record():
        out = net(x)
    mean = xn.mean(axis=(0, 2, 3))
    var = xn.var(axis=(0, 2, 3))
    expect = (xn - mean[None, :, None, None]) / onp.sqrt(
        var[None, :, None, None] + 1e-5)
    close(out, expect, 1e-3, 1e-4)
    rm = net.running_mean.data().asnumpy()
    close(rm, 0.1 * mean, 1e-3, 1e-5)
    # the running variance takes the biased batch variance
    close(net.running_var.data(), 0.9 + 0.1 * var, 1e-5, 1e-6)
    out2 = net(x)
    rv = net.running_var.data().asnumpy()
    expect2 = (xn - rm[None, :, None, None]) / onp.sqrt(
        rv[None, :, None, None] + 1e-5)
    close(out2, expect2, 1e-3, 1e-4)


def test_hybridize_matches_eager(P):
    """As tests/test_gluon.py, but the second net takes the first's values
    by structured name: sorting prefixed names (dense9_ after dense10_)
    pairs the wrong parameters once the global counter passes 9, which
    is why the JAX test fails after other tests in one process."""
    nd, nn, autograd = P.nd, P.nn, P.autograd
    rng = onp.random.RandomState(1)
    net = nn.HybridSequential()
    net.add(nn.Dense(16, activation='relu'))
    net.add(nn.Dense(4))
    net.initialize()
    x = nd.array(rng.rand(5, 8).astype(onp.float32))
    eager = net(x).asnumpy()
    net.hybridize()
    close(net(x), eager, 1e-5, 0)
    x2 = nd.array(rng.rand(5, 8).astype(onp.float32))
    with autograd.record():
        loss = (net(x2) ** 2).sum()
    loss.backward()
    g_hybrid = net[0].weight.grad().asnumpy().copy()
    net2 = nn.HybridSequential()
    net2.add(nn.Dense(16, activation='relu'))
    net2.add(nn.Dense(4))
    net2.initialize()
    net2(x2)
    dst = net2._collect_params_with_prefix()
    for k, p in net._collect_params_with_prefix().items():
        dst[k].set_data(p.data())
    with autograd.record():
        loss2 = (net2(x2) ** 2).sum()
    loss2.backward()
    close(g_hybrid, net2[0].weight.grad(), 1e-4, 1e-5)


def test_hybridize_batchnorm_stats_update(P):
    nn = P.nn
    net = nn.HybridSequential()
    net.add(nn.Dense(4, in_units=3))
    net.add(nn.BatchNorm(in_channels=4))
    net.initialize()
    net.hybridize()
    x = P.nd.array(onp.random.RandomState(2).rand(8, 3).astype(onp.float32))
    before = net[1].running_mean.data().asnumpy().copy()
    with P.autograd.record():
        net(x)
    after = net[1].running_mean.data().asnumpy()
    assert not onp.allclose(before, after)


def test_trainer_sgd_step(P):
    nd = P.nd
    net = P.nn.Dense(1, in_units=2, use_bias=False)
    net.initialize()
    net.weight.set_data(nd.array([[1.0, 1.0]]))
    trainer = P.gluon.Trainer(net.collect_params(), 'sgd',
                              {'learning_rate': 0.1})
    x = nd.array([[1., 2.]])
    with P.autograd.record():
        loss = net(x).sum()
    loss.backward()
    trainer.step(1)
    close(net.weight.data(), [[0.9, 0.8]], 1e-6, 0)


def test_embedding_layer(P):
    net = P.nn.Embedding(10, 4)
    net.initialize()
    out = net(P.nd.array([1, 3]))
    assert out.shape == (2, 4)
    close(out, net.weight.data().asnumpy()[[1, 3]], 0, 0)


def test_losses(P):
    nd, gloss = P.nd, P.loss
    pred = nd.array([[1., 2., 3.], [3., 2., 1.]])
    label = nd.array([2, 0])
    l = gloss.SoftmaxCrossEntropyLoss()(pred, label)
    expect = -onp.log(onp.exp([3, 3]) / onp.exp([[1, 2, 3], [3, 2, 1]])
                      .sum(axis=1))
    close(l, expect, 1e-5, 0)
    close(gloss.L2Loss()(nd.array([1., 2.]), nd.array([0., 0.])),
          [0.5, 2.0])
    close(gloss.L1Loss()(nd.array([1., -2.]), nd.array([0., 0.])),
          [1., 2.])


def test_lambda_blocks(P):
    nn, nd = P.nn, P.nd
    close(nn.HybridLambda('tanh')(nd.array([0.])), [0.])
    close(nn.Lambda(lambda x: x * 2)(nd.array([3.])), [6.])


def test_global_norm_clip(P):
    nd = P.nd
    arrays = [nd.ones((2, 2)) * 3, nd.ones((3,)) * 4]
    norm = P.gluon.utils.clip_global_norm(arrays, 1.0)
    assert abs(norm - onp.sqrt(4 * 9 + 3 * 16)) < 1e-4
    total = onp.sqrt(sum((a.asnumpy() ** 2).sum() for a in arrays))
    assert abs(total - 1.0) < 1e-5


def test_global_norm_clip_scales_parameter_gradients(P):
    """``p.grad()`` arrays clipped together: the Parameters' own
    gradients shrink, so the next Trainer step reads the clipped ones."""
    nn, nd = P.nn, P.nd
    net = nn.Dense(3, in_units=4)
    net.initialize(P.init.One())
    with P.autograd.record():
        loss = (net(nd.ones((2, 4))) * 100).sum()
    loss.backward()
    params = list(net.collect_params().values())
    norm = P.gluon.utils.clip_global_norm([p.grad() for p in params], 0.25)
    assert abs(norm - onp.sqrt(3 * 4 * 200 ** 2 + 3 * 200 ** 2)) < 1e-2
    total = onp.sqrt(sum((p.grad().asnumpy() ** 2).sum() for p in params))
    assert abs(total - 0.25) < 1e-6


def test_block_repr_and_summary(P, capsys):
    net = P.nn.HybridSequential()
    net.add(P.nn.Dense(4, in_units=2))
    net.initialize()
    assert 'Dense(2 -> 4, linear)' in repr(net)
    net.summary(P.nd.ones((1, 2)))
    captured = capsys.readouterr()
    assert 'Total params: 12' in captured.out


def _train_n_steps(P, optname, kw, fused, arrays, n=4, seed=11):
    """tests/test_gluon.py's _train_n_steps, the initial weights given."""
    nd, nn = P.nd, P.nn
    net = nn.HybridSequential()
    net.add(nn.Dense(16, activation='relu'), nn.Dense(8))
    net.initialize(P.init.Xavier())
    net(nd.ones((2, 12)))
    for k, p in net._collect_params_with_prefix().items():
        p.set_data(nd.array(arrays[k]))
    tr = P.gluon.Trainer(net.collect_params(), optname, dict(kw))
    if not fused:
        tr._optimizer.fused_update = False
    rng = onp.random.RandomState(seed)
    X = rng.randn(32, 12).astype(onp.float32)
    y = rng.randint(0, 8, 32).astype(onp.int32)
    lossfn = P.loss.SoftmaxCrossEntropyLoss()
    for _ in range(n):
        with P.autograd.record():
            loss = lossfn(net(nd.array(X)), nd.array(y))
        loss.backward()
        tr.step(32)
    return [p.data().asnumpy() for _, p in
            sorted(net._collect_params_with_prefix().items())]


@pytest.mark.parametrize('optname,kw', [
    ('sgd', {'learning_rate': 0.05, 'momentum': 0.9, 'wd': 1e-4}),
    ('nag', {'learning_rate': 0.05, 'momentum': 0.9}),
    ('adam', {'learning_rate': 1e-2}),
    ('adamw', {'learning_rate': 1e-2}),
    ('lamb', {'learning_rate': 1e-2})])
def test_trainer_fused_update_matches_eager(optname, kw):
    """The ported optimizers of tests/test_gluon.py's sweep: the fused
    update and the per-parameter loop agree, and both follow the JAX
    Trainer over 4 steps of the Gluon loop."""
    rng = onp.random.RandomState(5)
    arrays = {'0.weight': rng.randn(16, 12).astype('f') * 0.3,
              '0.bias': rng.randn(16).astype('f') * 0.1,
              '1.weight': rng.randn(8, 16).astype('f') * 0.3,
              '1.bias': rng.randn(8).astype('f') * 0.1}
    fused = _train_n_steps(PORT, optname, kw, True, arrays)
    loop = _train_n_steps(PORT, optname, kw, False, arrays)
    want = _train_n_steps(JAX, optname, kw, True, arrays)
    for f, l, w in zip(fused, loop, want):
        assert onp.abs(f - l).max() < 1e-5    # as tests/test_gluon.py
        onp.testing.assert_allclose(f, w, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize('optname', ['lars', 'nadam'])
def test_trainer_fused_impure_fallback(optname):
    """tests/test_gluon.py: LARS (it reads norms on the host) and Nadam
    (Python state moves each update) refuse the fused update and take
    the per-parameter loop, which follows the JAX Trainer over 4 steps."""
    from mxnet_tpu_torch import optimizer as topt
    kw = {'lars': {'learning_rate': 0.05},
          'nadam': {'learning_rate': 1e-2}}[optname]
    assert topt.create(optname).fused_update is False
    rng = onp.random.RandomState(6)
    arrays = {'0.weight': rng.randn(16, 12).astype('f') * 0.3,
              '0.bias': rng.randn(16).astype('f') * 0.1,
              '1.weight': rng.randn(8, 16).astype('f') * 0.3,
              '1.bias': rng.randn(8).astype('f') * 0.1}
    got = _train_n_steps(PORT, optname, kw, True, arrays)
    want = _train_n_steps(JAX, optname, kw, True, arrays)
    for g, w in zip(got, want):
        onp.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6)


# ---- the same script through both packages ------------------------------

_RECIPE = '''
import numpy as onp
from {pkg} import nd, autograd, gluon
from {pkg}.gluon import nn
net = nn.HybridSequential()
net.add(nn.Dense(16, activation='relu'))
net.add(nn.Dense(4))
net.initialize()
net.hybridize()
rng = onp.random.RandomState(0)
X = nd.array(rng.randn(32, 6).astype('float32'))
y = nd.array(rng.randint(0, 4, 32).astype('int32'))
net(X)
for p in net.collect_params().values():
    p.set_data(nd.array(rng.randn(*p.shape).astype('float32') * 0.3))
trainer = gluon.Trainer(net.collect_params(), 'adam',
                        {{'learning_rate': 0.01}})
loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
losses = []
for _ in range(5):
    with autograd.record():
        loss = loss_fn(net(X), y)
    loss.backward()
    trainer.step(32)
    losses.append(float(loss.mean().asscalar()))
net.save_parameters(fname)
net2 = nn.HybridSequential()
net2.add(nn.Dense(16, activation='relu'))
net2.add(nn.Dense(4))
net2.load_parameters(fname)
out, out2 = net(X).asnumpy(), net2(X).asnumpy()
'''


def test_skill_recipe_runs_unchanged_in_both_packages(tmp_path):
    """The drive recipe of the verify skill (HybridSequential of Dense,
    initialize, hybridize, Trainer 'adam', record, backward, step, a
    save/load round trip), one script with only the import changed."""
    runs = {}
    for pkg in ('mxnet_tpu', 'mxnet_tpu_torch'):
        scope = {'fname': str(tmp_path / f'{pkg}.params')}
        exec(_RECIPE.format(pkg=pkg), scope)
        runs[pkg] = scope
    j, t = runs['mxnet_tpu'], runs['mxnet_tpu_torch']
    assert t['losses'][-1] < t['losses'][0]
    onp.testing.assert_allclose(t['losses'], j['losses'], rtol=1e-5)
    onp.testing.assert_array_equal(t['out'], t['out2'])
    close(t['out'], j['out'], 1e-5, 1e-5)


# ---- the ops the layers stand on ------------------------------------------

def _nd_both(fn, *arrays, **kw):
    """fn(nd, *NDArrays) through both packages -> (port, jax)."""
    got = fn(mt.nd, *[mt.nd.array(a) for a in arrays], **kw)
    want = fn(mj.nd, *[mj.nd.array(a) for a in arrays], **kw)
    return got, want


def _rand(*shape, seed=0):
    return onp.random.RandomState(seed).randn(*shape).astype(onp.float32)


@pytest.mark.parametrize('nd_,stride,pad,dilate,groups', [
    (1, 1, 0, 1, 1), (1, 2, 1, 1, 2), (2, 1, 1, 1, 1), (2, 2, 3, 1, 1),
    (2, 1, 2, 2, 1), (2, 2, 1, 1, 4), (3, 1, 1, 1, 1), (3, 2, 0, 1, 2)])
def test_convolution_matches_jax(nd_, stride, pad, dilate, groups):
    k = 3
    x = _rand(2, 4, *([9] * nd_), seed=1)
    w = _rand(8, 4 // groups, *([k] * nd_), seed=2) * 0.2
    b = _rand(8, seed=3)
    got, want = _nd_both(
        lambda nd, x, w, b: nd.convolution(
            x, w, b, kernel=(k,) * nd_, stride=stride, dilate=dilate,
            pad=pad, num_filter=8, num_group=groups), x, w, b)
    close(got, want, 1e-5, 1e-5)


@pytest.mark.parametrize('nd_,stride,pad,adj,groups', [
    (1, 2, 1, 1, 1), (2, 1, 0, 0, 1), (2, 2, 1, 1, 1), (2, 2, 0, 0, 2),
    (3, 2, 1, 0, 1)])
def test_deconvolution_matches_jax(nd_, stride, pad, adj, groups):
    x = _rand(2, 4, *([5] * nd_), seed=4)
    w = _rand(4, 6 // groups, *([3] * nd_), seed=5) * 0.2
    got, want = _nd_both(
        lambda nd, x, w: nd.deconvolution(
            x, w, None, kernel=(3,) * nd_, stride=stride, pad=pad, adj=adj,
            num_filter=6, num_group=groups, no_bias=True), x, w)
    close(got, want, 1e-5, 1e-5)


@pytest.mark.parametrize('kw', [
    dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1), pool_type='max'),
    dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1), pool_type='max',
         pooling_convention='full'),
    dict(kernel=(2, 2), stride=(2, 2), pad=(0, 0), pool_type='max',
         pooling_convention='full'),
    dict(kernel=(3, 3), stride=(2, 2), pad=(2, 2), pool_type='max'),
    dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1), pool_type='avg'),
    dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1), pool_type='avg',
         count_include_pad=False),
    dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1), pool_type='avg',
         pooling_convention='full', count_include_pad=False),
    dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1), pool_type='avg',
         pooling_convention='full'),
    dict(kernel=(2, 2), stride=(1, 1), pad=(0, 0), pool_type='sum'),
    dict(kernel=(2, 2), stride=(2, 2), pad=(0, 0), pool_type='lp'),
    dict(kernel=(1, 1), pool_type='max', global_pool=True),
    dict(kernel=(1, 1), pool_type='avg', global_pool=True)])
def test_pooling_matches_jax(kw):
    """Shape 10 x 10 with kernel 3, stride 2, pad 1 under 'full' has a
    last window that starts in the right padding: kept, as in JAX."""
    x = _rand(2, 3, 10, 10, seed=6)
    got, want = _nd_both(lambda nd, x: nd.pooling(x, **kw), x)
    close(got, want)


@pytest.mark.parametrize('dims', [1, 3])
def test_pooling_1d_3d_matches_jax(dims):
    x = _rand(2, 3, *([7] * dims), seed=7)
    for kw in (dict(pool_type='max', pooling_convention='full'),
               dict(pool_type='avg', count_include_pad=False)):
        got, want = _nd_both(lambda nd, x: nd.pooling(
            x, kernel=(3,) * dims, stride=(2,) * dims, pad=(1,) * dims,
            **kw), x)
        close(got, want)


@pytest.mark.parametrize('training', [True, False])
@pytest.mark.parametrize('fix_gamma', [True, False])
def test_batch_norm_op_matches_jax(training, fix_gamma):
    """Output and the new running statistics; the variance update takes
    the biased batch variance and momentum 0.9 of the old value."""
    x = _rand(4, 3, 5, 5, seed=8) * 2 + 1
    g, b = _rand(3, seed=9), _rand(3, seed=10)
    rm, rv = _rand(3, seed=11) * 0.1, onp.abs(_rand(3, seed=12)) + 0.5

    def case(nd, x, g, b, rm, rv):
        ag = (mt if nd is mt.nd else mj).autograd
        with ag.train_mode() if training else ag.predict_mode():
            return nd.batch_norm(x, g, b, rm, rv, eps=1e-5, momentum=0.9,
                                 fix_gamma=fix_gamma)
    got, want = _nd_both(case, x, g, b, rm, rv)
    for a, w in zip(got, want):
        close(a, w, 1e-5, 1e-5)


@pytest.mark.parametrize('act', ['leaky', 'elu', 'selu', 'gelu', 'prelu'])
def test_leaky_relu_matches_jax(act):
    x = _rand(3, 4, 5, seed=13)
    gamma = onp.array([0.1, 0.2, 0.3, 0.4], onp.float32)
    got, want = _nd_both(lambda nd, x, g: nd.leaky_relu(
        x, gamma=g if act == 'prelu' else None, act_type=act, slope=0.3),
        x, gamma)
    close(got, want)


@pytest.mark.parametrize('act', ['relu', 'sigmoid', 'tanh', 'softrelu',
                                 'softsign', 'gelu', 'silu'])
def test_activation_matches_jax(act):
    got, want = _nd_both(lambda nd, x: nd.activation(x, act_type=act),
                         _rand(4, 7, seed=14))
    close(got, want)


def test_norms_and_cross_entropy_match_jax():
    x = _rand(2, 6, 4, 4, seed=15)
    g, b = _rand(6, seed=16), _rand(6, seed=17)
    close(*_nd_both(lambda nd, x, g, b: nd.instance_norm(x, g, b, eps=1e-3),
                    x, g, b), 1e-5, 1e-5)
    close(*_nd_both(lambda nd, x, g, b: nd.group_norm(
        x, g, b, num_groups=3, eps=1e-5), x, g, b), 1e-5, 1e-5)
    logits = _rand(5, 7, seed=18)
    labels = onp.array([0, 3, 6, 2, 2], onp.float32)
    close(*_nd_both(lambda nd, x, y: nd.softmax_cross_entropy(x, y),
                    logits, labels), 1e-5, 1e-5)


# ---- every loss -------------------------------------------------------------

_LOSSES = [
    ('L2Loss', {}, 'reg'), ('L1Loss', {}, 'reg'),
    ('SigmoidBinaryCrossEntropyLoss', {}, 'bin'),
    ('SigmoidBinaryCrossEntropyLoss', {'from_sigmoid': True}, 'prob'),
    ('SoftmaxCrossEntropyLoss', {}, 'cls'),
    ('SoftmaxCrossEntropyLoss', {'sparse_label': False}, 'dist'),
    ('KLDivLoss', {'from_logits': False}, 'dist'),
    ('HuberLoss', {'rho': 0.5}, 'reg'), ('HingeLoss', {}, 'sign'),
    ('SquaredHingeLoss', {}, 'sign'), ('LogisticLoss', {}, 'sign'),
    ('PoissonNLLLoss', {'compute_full': True}, 'count'),
]


@pytest.mark.parametrize('name,kw,kind', _LOSSES)
def test_loss_matches_jax(name, kw, kind):
    rng = onp.random.RandomState(19)
    pred = rng.randn(4, 5).astype(onp.float32)
    label = {'reg': rng.randn(4, 5), 'bin': rng.randint(0, 2, (4, 5)),
             'cls': rng.randint(0, 5, (4,)),
             'dist': onp.abs(rng.rand(4, 5)) / 2.5,
             'sign': onp.sign(rng.randn(4, 5)),
             'count': rng.poisson(2.0, (4, 5)),
             'prob': rng.randint(0, 2, (4, 5))}[kind].astype(onp.float32)
    if kind == 'prob':
        pred = 1 / (1 + onp.exp(-pred))
    weight = rng.rand(4, 1).astype(onp.float32)
    for sw in (None, weight):
        args = (pred, label) + (() if sw is None else (sw,))
        got = getattr(tgluon.loss, name)(**kw)(
            *[mt.nd.array(a) for a in args])
        want = getattr(jgluon.loss, name)(**kw)(
            *[mj.nd.array(a) for a in args])
        close(got, want, 1e-5, 1e-6)


def test_triplet_and_cosine_losses_match_jax():
    rng = onp.random.RandomState(20)
    a, p, n = (rng.randn(3, 6).astype(onp.float32) for _ in range(3))
    close(*[L(*[pk.nd.array(v) for v in (a, p, n)]) for L, pk in (
        (tgluon.loss.TripletLoss(margin=0.5), mt),
        (jgluon.loss.TripletLoss(margin=0.5), mj))])
    lab = onp.array([1, -1, 1], onp.float32)
    close(*[L(*[pk.nd.array(v) for v in (a, p, lab)]) for L, pk in (
        (tgluon.loss.CosineEmbeddingLoss(margin=0.1), mt),
        (jgluon.loss.CosineEmbeddingLoss(margin=0.1), mj))])


def test_ctc_loss_waits_for_its_op():
    """The CTC op is ported: CTCLoss builds and, on labels where MXNet's
    padding rule and the JAX op's agree, gives the JAX layer's losses
    (tests/test_torch_ctc.py holds the rest)."""
    x = onp.random.RandomState(0).randn(2, 6, 5).astype(onp.float32)
    lab = onp.array([[1, 2, -1, -1], [3, 1, 2, -1]], onp.float32)
    got = tgluon.loss.CTCLoss()(mt.nd.array(x), mt.nd.array(lab))
    want = jgluon.loss.CTCLoss()(mj.nd.array(x), mj.nd.array(lab))
    close(got, want, 1e-5, 1e-5)


# ---- layers against JAX, with the JAX weights ----------------------------

def _layer_pair(make, x):
    """(port layer, JAX layer), the JAX one initialized (Xavier) and run
    once, its values carried into the port one."""
    jl, tl = make(jgluon.nn), make(tgluon.nn)
    jl.initialize(mj.init.Xavier())
    tl.initialize(mt.init.Xavier())
    jl(mj.nd.array(x))
    tl(mt.nd.array(x))
    carry(jl, tl)
    return tl, jl


@pytest.mark.parametrize('make,shape', [
    (lambda nn: nn.Conv1D(5, 3, strides=2, padding=1), (2, 3, 11)),
    (lambda nn: nn.Conv2D(6, (3, 2), padding=(1, 0), groups=3,
                          activation='relu'), (2, 3, 8, 7)),
    (lambda nn: nn.Conv3D(4, 2, dilation=2), (1, 2, 6, 6, 6)),
    (lambda nn: nn.Conv2DTranspose(5, 3, strides=2, padding=1,
                                   output_padding=1), (2, 3, 5, 5)),
    (lambda nn: nn.Conv1DTranspose(4, 3, strides=2), (2, 3, 6)),
    (lambda nn: nn.AvgPool2D(3, 2, 1, ceil_mode=True,
                             count_include_pad=False), (2, 3, 10, 10)),
    (lambda nn: nn.MaxPool3D(2, 2, ceil_mode=True), (1, 2, 5, 5, 5)),
    (lambda nn: nn.GlobalMaxPool1D(), (2, 3, 9)),
    (lambda nn: nn.ReflectionPad2D(2), (1, 2, 5, 5)),
    (lambda nn: nn.Dense(7, activation='tanh', flatten=False), (2, 3, 5)),
    (lambda nn: nn.LayerNorm(), (3, 4, 6)),
    (lambda nn: nn.GroupNorm(num_groups=2), (2, 4, 3, 3)),
    (lambda nn: nn.InstanceNorm(scale=True), (2, 4, 3, 3)),
    (lambda nn: nn.PReLU(), (3, 8)),
    (lambda nn: nn.LeakyReLU(0.2), (3, 8)),
    (lambda nn: nn.ELU(0.7), (3, 8)),
    (lambda nn: nn.SELU(), (3, 8)),
    (lambda nn: nn.GELU(), (3, 8)),
    (lambda nn: nn.Swish(1.5), (3, 8)),
    (lambda nn: nn.Flatten(), (2, 3, 4))])
def test_layer_matches_jax(make, shape):
    x = _rand(*shape, seed=21)
    tl, jl = _layer_pair(make, x)
    close(tl(mt.nd.array(x)), jl(mj.nd.array(x)), 1e-5, 1e-5)


def test_layer_gradients_match_jax():
    """A conv + BatchNorm + Dense stack in training mode: outputs, every
    gradient and the running statistics. (The conv has no bias: before a
    BatchNorm its exact gradient is 0, and both packages give noise.)"""
    def make(nn):
        net = nn.HybridSequential()
        net.add(nn.Conv2D(4, 3, padding=1, use_bias=False), nn.BatchNorm(),
                nn.Activation('relu'), nn.MaxPool2D(2, 2), nn.Dense(3))
        return net
    x = _rand(2, 3, 6, 6, seed=22)
    tnet, jnet = _layer_pair(make, x)
    outs = {}
    for pk, net in ((mt, tnet), (mj, jnet)):
        with pk.autograd.record():
            y = net(pk.nd.array(x))
            loss = (y * y).sum()
        loss.backward()
        outs[pk] = (y, {k: (p.grad().asnumpy() if p.grad_req != 'null'
                            else p.data().asnumpy())
                        for k, p in net._collect_params_with_prefix()
                        .items()})
    close(outs[mt][0], outs[mj][0], 1e-5, 1e-5)
    for k, want in outs[mj][1].items():
        assert rel_fro(outs[mt][1][k], want) <= 1e-5, k


# ---- initializers -----------------------------------------------------------

def _draw(init, shape, name='x_weight'):
    t = torch.empty(shape)
    mt.random.seed(3)
    init(mt.init.InitDesc(name), t)
    return t.numpy().astype(onp.float64)


@pytest.mark.parametrize('rnd,factor,mag', [
    ('uniform', 'avg', 3), ('uniform', 'in', 2), ('gaussian', 'out', 3),
    ('gaussian', 'avg', 2.34)])
def test_xavier_statistics(rnd, factor, mag):
    shape = (64, 32, 3, 3)
    fan_in, fan_out = 32 * 9, 64 * 9
    f = {'avg': (fan_in + fan_out) / 2, 'in': fan_in, 'out': fan_out}[factor]
    scale = onp.sqrt(mag / f)
    w = _draw(mt.init.Xavier(rnd, factor, mag), shape)
    std = scale / onp.sqrt(3) if rnd == 'uniform' else scale
    assert abs(w.mean()) < 4 * std / onp.sqrt(w.size)
    assert abs(w.std() / std - 1) < 0.03
    if rnd == 'uniform':
        assert onp.abs(w).max() <= scale and onp.abs(w).max() > 0.99 * scale


def test_uniform_normal_msra_statistics():
    u = _draw(mt.init.Uniform(0.3), (200, 100))
    assert onp.abs(u).max() <= 0.3 and abs(u.std() - 0.3 / onp.sqrt(3)) < 3e-3
    n = _draw(mt.init.Normal(0.05), (200, 100))
    assert abs(n.mean()) < 2e-3 and abs(n.std() / 0.05 - 1) < 0.02
    m = _draw(mt.init.MSRAPrelu('in', 0.25), (128, 64, 3, 3))
    want = onp.sqrt(2.0 / (1 + 0.25 ** 2) / (64 * 9))
    assert abs(m.std() / want - 1) < 0.02


def test_deterministic_initializers_match_jax():
    """Name-pattern dispatch, Constant, Zero/One, Bilinear and LSTMBias
    give the JAX package's values exactly."""
    cases = [('Bilinear', (), (2, 1, 4, 4), 'up_weight'),
             ('LSTMBias', (2.0,), (16,), 'lstm_bias'),
             ('Constant', (0.7,), (3, 4), 'c_weight'),
             ('One', (), (5,), 'a_weight'), ('Zero', (), (5,), 'a_weight'),
             ('Xavier', (), (4,), 'bn_gamma'), ('Xavier', (), (4,), 'b_beta'),
             ('Xavier', (), (4,), 'd_bias'),
             ('Xavier', (), (4,), 'bn_running_var'),
             ('Uniform', (), (4,), 'bn_running_mean')]
    for cls, args, shape, name in cases:
        got = _draw(getattr(mt.init, cls)(*args), shape, name)
        arr = mj.nd.zeros(shape)
        getattr(mj.init, cls)(*args)(mj.init.InitDesc(name), arr)
        onp.testing.assert_allclose(got, arr.asnumpy(), rtol=1e-6)


def test_orthogonal_mixed_create():
    w = _draw(mt.init.Orthogonal(scale=1.0), (8, 20))
    onp.testing.assert_allclose(w @ w.T, onp.eye(8), atol=1e-5)
    mixed = mt.init.Mixed(['fc.*', '.*'], [mt.init.Constant(2.0), 'zeros'])
    t = torch.ones(3)
    mixed('fc_weight', t)
    assert t.tolist() == [2.0] * 3
    mixed('conv_weight', t)
    assert t.tolist() == [0.0] * 3
    mixed('fc_gamma', t)             # the name pattern still rules gamma
    assert t.tolist() == [1.0] * 3
    assert isinstance(mt.init.create('xavier'), mt.init.Xavier)
    x = mt.init.create(mt.init.Xavier('gaussian', 'in', 2).dumps())
    assert (x.rnd_type, x.factor_type, x.magnitude) == ('gaussian', 'in', 2)
    with pytest.raises(MXNetError):
        mt.init.create('no_such_init')


def test_earlier_call_form_fills_weights_only():
    net = tgluon.nn.Dense(4, in_units=3, device='cpu')
    mt.init.Normal(0.5)(net, torch.Generator().manual_seed(0))
    assert float(net.weight.detach().abs().sum()) > 0
    assert float(net.bias.detach().abs().sum()) == 0


# ---- Parameter and Block semantics ----------------------------------------

def test_grad_req_add_null_and_shared_storage():
    nd, autograd = mt.nd, mt.autograd
    net = tgluon.nn.Dense(2, in_units=3)
    net.initialize()
    x = nd.ones((1, 3))
    net.weight.grad_req = 'add'
    for _ in range(2):
        with autograd.record():
            net(x).sum().backward()
    close(net.weight.grad(), onp.full((2, 3), 2.0))
    close(net.bias.grad(), onp.ones(2))
    net.bias.grad_req = 'null'
    assert net.bias.grad is None and not net.bias.tensor.requires_grad
    # data() shares storage with the registered tensor, both ways
    d = net.weight.data()
    d[:] = 5.0
    assert float(net.weight.tensor.detach().sum()) == 30.0
    assert dict(net.named_parameters())['weight'] is net.weight.tensor


def test_forward_before_initialize_and_deferred_errors():
    net = tgluon.nn.Dense(4, in_units=3)
    with pytest.raises(MXNetError, match='dense.*_weight.*not been '
                                         'initialized'):
        net(mt.nd.ones((2, 3)))
    deferred = tgluon.nn.Dense(4)
    with pytest.raises(MXNetError, match='not been initialized'):
        deferred(mt.nd.ones((2, 3)))
    deferred.initialize()
    assert deferred.weight.shape == (4, 0)
    deferred(mt.nd.ones((2, 3)))
    assert deferred.weight.shape == (4, 3)


def test_load_into_mismatched_architecture_raises(tmp_path):
    net = tgluon.nn.Dense(3, in_units=2)
    net.initialize()
    f = str(tmp_path / 'a.params')
    net.save_parameters(f)
    other = tgluon.nn.Dense(3, in_units=5)
    with pytest.raises(MXNetError, match='shape mismatch'):
        other.load_parameters(f)
    seq = tgluon.nn.HybridSequential()
    seq.add(tgluon.nn.Dense(3, in_units=2), tgluon.nn.Dense(1))
    with pytest.raises(MXNetError, match='missing'):
        seq.load_parameters(f)


@pytest.mark.parametrize('writer', ['jax', 'port'])
def test_params_file_across_packages(tmp_path, writer):
    """A Dense + BatchNorm stack saved by one package loads into the
    other and gives the same output."""
    def make(nn):
        net = nn.HybridSequential()
        net.add(nn.Dense(5), nn.BatchNorm(), nn.Dense(2))
        return net
    x = _rand(4, 6, seed=23)
    f = str(tmp_path / 'n.params')
    src_pk, dst_pk = (mj, mt) if writer == 'jax' else (mt, mj)
    src = make((jgluon if writer == 'jax' else tgluon).nn)
    src.initialize(src_pk.init.Xavier())
    with src_pk.autograd.record():
        src(src_pk.nd.array(x))      # moves the running statistics
    src.save_parameters(f)
    dst = make((tgluon if writer == 'jax' else jgluon).nn)
    dst.load_parameters(f)
    close(dst(dst_pk.nd.array(x)), src(src_pk.nd.array(x)), 1e-5, 1e-6)


def test_cast_and_hooks_and_apply():
    net = tgluon.nn.HybridSequential()
    net.add(tgluon.nn.Dense(4, in_units=3), tgluon.nn.BatchNorm(in_channels=4))
    net.initialize()
    net.hybridize()
    seen = []
    h = net.register_forward_hook(lambda b, i, o: seen.append(o.shape))
    net(mt.nd.ones((2, 3)))
    h.detach()
    net(mt.nd.ones((2, 3)))
    assert seen == [torch.Size([2, 4])]
    net.cast('bfloat16')
    assert net._cached_op is None
    assert net[1].running_var.dtype == torch.bfloat16
    assert net(mt.nd.ones((2, 3), dtype='bfloat16')).dtype == torch.bfloat16
    names = []
    net.apply(lambda b: names.append(type(b).__name__))
    assert names == ['Dense', 'BatchNorm', 'HybridSequential']


@pytest.mark.parametrize('layer', ['batchnorm', 'dropout'])
def test_training_mode_rule_for_both_kinds_of_call(layer):
    """NDArray calls take the mode from autograd (training inside
    record()); tensor calls from the module's flag."""
    x = _rand(64, 3, 4, 4, seed=24)
    blk = tgluon.nn.BatchNorm(in_channels=3) if layer == 'batchnorm' \
        else tgluon.nn.Dropout(0.5)
    blk.initialize()

    def trained(out, inp):
        if layer == 'dropout':
            return bool((_np(out) == 0).any())
        return abs(_np(out).mean()) < 1e-5 and abs(inp.mean()) > 1e-3

    xs = x + 1.0
    with mt.autograd.record():
        assert trained(blk(mt.nd.array(xs)), xs)
    assert blk.training
    assert not trained(blk(mt.nd.array(xs)), xs)    # predict mode
    assert not blk.training
    t = torch.from_numpy(xs)
    assert not trained(blk(t), xs)                   # the flag: eval
    blk.train()
    assert trained(blk(t), xs)
    with mt.autograd.predict_mode():
        assert trained(blk(t), xs)                   # tensors ignore it


def test_symbol_api_refusals(tmp_path):
    """The Symbol API is ported (ROADMAP item 15): export writes
    the pair SymbolBlock.imports reads back; what still raises is a
    SymbolBlock of several outputs."""
    net = tgluon.nn.Dense(2, in_units=2)
    net.initialize()
    files = net.export(str(tmp_path / 'dense'))
    blk = tgluon.SymbolBlock.imports(files[0], ['data'], files[1])
    x = mt.nd.array(onp.arange(4, dtype=onp.float32).reshape(2, 2))
    close(blk(x), net(x))
    with pytest.raises(MXNetError, match='one output'):
        tgluon.SymbolBlock([mt.sym.var('a'), mt.sym.var('b')],
                           mt.sym.var('a'))


def test_bert_layers_are_the_gluon_blocks():
    """One Dense/LayerNorm/Embedding/Dropout class: the BERT model's
    layers are Gluon Blocks with the JAX package's structured names."""
    from mxnet_tpu_torch.models.bert import BertModel
    net = BertModel(vocab_size=50, hidden=16, layers=1, heads=2,
                    intermediate=32, max_len=8, device='cpu')
    assert isinstance(net.encoder[0].ffn1, tgluon.nn.Dense)
    assert isinstance(net.encoder[0].ln1, tgluon.nn.LayerNorm)
    assert isinstance(net.word_embed, tgluon.nn.Embedding)
    assert isinstance(net.encoder[0].dropout, tgluon.nn.Dropout)
    names = [n for n, _ in net.named_parameters()]
    assert 'encoder.0.attention.qkv.weight' in names
    assert 'embed_ln.gamma' in names


def test_gluon_defaults_to_the_card():
    """Outside a CPU scope a layer is placed on gpu(0): with no card,
    building one with a known shape raises, and a deferred one raises at
    the forward that would place it."""
    if torch.cuda.is_available():
        pytest.skip('a card is present')
    with mt.gpu(0):
        with pytest.raises(MXNetError, match='no CUDA device'):
            tgluon.nn.Dense(4, in_units=3)
        bn = tgluon.nn.BatchNorm()
        bn.initialize()
        with pytest.raises(MXNetError, match='no CUDA device'):
            bn(mt.nd.ones((2, 3), ctx=mt.cpu()))
    net = tgluon.nn.Dense(4, in_units=3)       # the CPU scope of the suite
    net.initialize()
    assert net.weight.tensor.device.type == 'cpu'


def test_deferred_parameters_get_gradients_in_their_first_step():
    """A net whose shapes wait for the input, first called inside
    record(): the parameters it places there get their gradients from
    that step's backward, as in the JAX package."""
    x = onp.abs(_rand(3, 5, seed=25)) + 0.1
    grads = {}
    for pk, gl in ((mj, jgluon), (mt, tgluon)):
        net = gl.nn.HybridSequential()
        net.add(gl.nn.Dense(4, activation='relu'), gl.nn.Dense(2))
        net.initialize(pk.init.Constant(0.1))
        with pk.autograd.record():
            loss = (net(pk.nd.array(x)) ** 2).sum()
        loss.backward()
        grads[pk] = {k: p.grad().asnumpy() for k, p in
                     net._collect_params_with_prefix().items()}
    for k, want in grads[mj].items():
        assert onp.abs(want).sum() > 0, k
        close(grads[mt][k], want, 1e-5, 1e-5)


# ---------------------------------------------------------------------------
# the CachedOp key: the parameter names are walked once, not per call
# ---------------------------------------------------------------------------

def _keyed_net():
    net = tgluon.nn.HybridSequential(prefix='keynet_')
    with net.name_scope():
        net.add(tgluon.nn.Dense(4, in_units=3),
                tgluon.nn.Dense(2, in_units=4))
    net.initialize()
    return net, tgluon.block.CachedOp(net), (torch.ones(2, 3),)


def test_cachedop_key_is_unchanged_and_not_rebuilt_for_an_unchanged_block(
        monkeypatch):
    net, op, args = _keyed_net()
    net(mt.nd.ones((2, 3)))            # predict mode from here on
    key = op.key(args)
    walks = []
    walk = tgluon.block.Block._collect_params_with_prefix

    def counted(self, prefix=''):
        walks.append(prefix)
        return walk(self, prefix)
    monkeypatch.setattr(tgluon.block.Block, '_collect_params_with_prefix',
                        counted)
    for _ in range(5):
        net(mt.nd.ones((2, 3)))        # train() and the flags: no change
        assert op.key(args) == key
    assert walks == []
    assert key[-1] == ('0.weight', '0.bias', '1.weight', '1.bias')


def test_cachedop_key_changes_when_a_parameter_is_added():
    net, op, args = _keyed_net()
    extra = tgluon.Parameter('extra', shape=(1,))
    key = op.key(args)
    net[0].extra = extra
    new = op.key(args)
    assert new != key and '0.extra' in new[-1]


def test_cachedop_key_changes_when_a_child_is_swapped():
    net, op, args = _keyed_net()
    swap = tgluon.nn.Dense(2, in_units=4, use_bias=False)
    inner = tgluon.nn.HybridSequential()
    leaf = tgluon.nn.Dense(1, in_units=2)
    key = op.key(args)                  # after every block was built
    net.register_child(swap, '1')
    new = op.key(args)
    assert new != key and new[-1] == ('0.weight', '0.bias', '1.weight')
    # a child registered further down changes the outer block's key too
    net.register_child(inner, '2')
    assert op.key(args) == new
    inner.add(leaf)
    assert op.key(args)[-1] == ('0.weight', '0.bias', '1.weight',
                                '2.0.weight', '2.0.bias')
    net.extra = tgluon.nn.Dense(1, in_units=2, prefix='extra_')
    assert op.key(args)[-1][-2:] == ('extra.weight', 'extra.bias')


def test_cast_and_hybridize_clear_drop_the_kept_names():
    net, _op, _args = _keyed_net()
    net.hybridize()
    net._cached_op = tgluon.block.CachedOp(net)
    net._cached_op.param_names()
    net.hybridize(clear=False)
    assert net._cached_op is not None
    net.hybridize()
    assert net._cached_op is None
    net._cached_op = tgluon.block.CachedOp(net)
    net.cast('bfloat16')
    assert net._cached_op is None
