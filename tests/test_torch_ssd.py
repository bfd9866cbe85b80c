"""The port's SSD (``models/ssd.py``) against the JAX package's, on the CPU
in f32: the five cases of tests/test_ssd.py with both packages side by
side, at image size 64 and the three-scale head of examples/train_ssd.py
(sizes (.15, .25), (.35, .45), (.6, .7), ratios [1, 2, .5]), 3 classes.

The JAX net is initialized (Xavier) and placed by one forward, and its
values are carried into the port's by structured name. Then:

- the forward's anchors, class and box predictions within atol 1e-5;
- ``hybridize()`` changes nothing on the CPU (the same forward runs);
- one training step: ``ssd_train_loss`` within rel 1e-5, every
  gradient within rel Frobenius 1e-4, and one Adam step (lr 1e-3)
  through ``gluon.Trainer`` in each package. Adam's first update is
  -lr * g / (|g| + eps), about lr times the sign of g, so an element
  whose gradient is at the rounding noise of the two packages takes
  either sign. The update is held within rel Frobenius 1e-4 over the
  elements whose gradient's sign is resolved (|g| at least 1000 times the
  two packages' difference there), and those unresolved are fewer than
  1% of all.
  A ReLU input within f32 rounding of 0 can put the two packages on
  different sides of the kink (and JAX's relu has derivative 0.5 at 0,
  MXNet's and the port's 0): as in tests/test_torch_model_zoo.py, every
  ReLU input of the step is recorded in both packages, at most four
  units (of 155648) may be so placed, each within 1e-5 of 0, and where
  any are, the step is run again with each such input set to the port's
  value in the JAX net (to JAX's in the port, where the port's is 0),
  the move carrying no gradient. A convolution's bias ahead of a BatchNorm has gradient 0 in exact
  arithmetic: its gradient, rounding noise in both packages (norm under
  1e-5 of the largest), is not compared, and its update is held to
  |update| <= lr;
- ``detect``: ids exactly, scores and boxes within 1e-5;
- ``ssd_512`` constructs with the JAX net's structured names and shapes,
  and makes 24572 anchors at 512 x 512;
- ``weights.params_from_mxnet_tpu`` carries ssd_512, a 2-layer
  bidirectional LSTM and a GRU from the JAX package by name.
"""
import functools

import numpy as onp
import pytest
import torch

import mxnet_tpu as mj
import mxnet_tpu_torch as mt
from mxnet_tpu.gluon import rnn as jrnn
from mxnet_tpu.models import ssd as jssd
from mxnet_tpu_torch.gluon import rnn as trnn
from mxnet_tpu_torch.models import ssd as tssd
from mxnet_tpu_torch.ops import nn as tops_nn
from mxnet_tpu_torch.weights import params_from_mxnet_tpu
from test_torch_jax_globals import jax_globals  # noqa: F401

ATOL = 1e-5
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4
UPDATE_TOL = 1e-4
LR = 1e-3
MAX_AMBIGUOUS = 4
SIGN_MARGIN = 1e3
SIZES = [(.15, .25), (.35, .45), (.6, .7)]
RATIOS = [[1, 2, .5]] * 3


@pytest.fixture(autouse=True)
def _port_on_cpu():
    with mt.cpu():
        yield


def rel_fro(got, want):
    g, w = onp.asarray(got, onp.float64), onp.asarray(want, onp.float64)
    return onp.linalg.norm(g - w) / max(onp.linalg.norm(w), 1e-30)


def _values(net):
    return {k: p.data().asnumpy()
            for k, p in net._collect_params_with_prefix().items()}


def _pair(B=2, seed=0):
    x = onp.random.RandomState(seed).randn(B, 3, 64, 64).astype(onp.float32)
    nets = [mod.SSD(num_classes=3, image_size=64, sizes=SIZES,
                    ratios=RATIOS) for mod in (jssd, tssd)]
    jnet, tnet = nets
    jnet.initialize(mj.init.Xavier())
    tnet.initialize(mt.init.Xavier())
    jnet(mj.nd.array(x))
    tnet(mt.nd.array(x))
    src, dst = _values(jnet), tnet._collect_params_with_prefix()
    assert sorted(src) == sorted(dst)
    for k, v in src.items():
        dst[k].set_data(mt.nd.array(v))
    return jnet, tnet, x


def _fresh(models, pkg, values, x):
    net = models.SSD(num_classes=3, image_size=64, sizes=SIZES,
                     ratios=RATIOS)
    net.initialize()
    net(pkg.nd.array(x))
    for k, p in net._collect_params_with_prefix().items():
        p.set_data(pkg.nd.array(values[k]))
    return net


def _n_anchors(s=64):
    f0 = s // 8
    return sum(4 * (f0 // 2 ** i) ** 2 for i in range(3))


def test_ssd_forward_matches_jax():
    jnet, tnet, x = _pair()
    A = _n_anchors()
    jout = jnet(mj.nd.array(x))
    tout = tnet(mt.nd.array(x))
    for shape, j, t in zip([(1, A, 4), (2, 4, A), (2, A * 4)], jout, tout):
        assert t.shape == shape
        onp.testing.assert_allclose(t.asnumpy(), j.asnumpy(), rtol=0,
                                    atol=ATOL)
    a = tout[0].asnumpy()
    assert a.min() > -0.6 and a.max() < 1.6
    # the anchors are a constant: the same tensor for every forward
    assert tnet(mt.nd.array(x))[0]._data is tout[0]._data


def test_ssd_hybridize_changes_nothing_on_the_cpu():
    jnet, tnet, x = _pair(B=1, seed=1)
    eager = [o.asnumpy() for o in tnet(mt.nd.array(x))]
    tnet.hybridize()
    hybrid = [o.asnumpy() for o in tnet(mt.nd.array(x))]
    for e, h, j in zip(eager, hybrid, jnet(mj.nd.array(x))):
        onp.testing.assert_array_equal(e, h)
        onp.testing.assert_allclose(h, j.asnumpy(), rtol=0, atol=ATOL)


def _label(B):
    label = onp.full((B, 4, 5), -1.0, onp.float32)
    label[0, 0] = [0, 0.1, 0.1, 0.45, 0.5]
    label[1, 0] = [2, 0.5, 0.4, 0.9, 0.95]
    label[1, 1] = [1, 0.05, 0.6, 0.3, 0.9]
    return label


def _adam_step(pkg, net, models, x, label, monkeypatch, shift=None):
    """One Adam step of the Gluon loop: (loss, gradients, update, every
    ReLU input in call order). ``shift`` maps (ReLU call, flat index) to
    a value that input takes instead, the move carrying no gradient."""
    relu_in = []
    # the port's layers call ops.nn (tensors) or nd (either) directly
    sites = [pkg.nd] + ([tops_nn] if pkg is mt else [])
    act = {id(m): m.activation for m in sites}

    def recording(data, act_type='relu', *, _act, **kwargs):
        if act_type == 'relu':
            a = (data.asnumpy() if hasattr(data, 'asnumpy')
                 else data.detach().numpy()).copy()
            for (i, e), v in (shift or {}).items():
                if i == len(relu_in):
                    move = onp.zeros(a.size, onp.float32)
                    move[e] = v - a.ravel()[e]
                    move = move.reshape(a.shape)
                    data = data + (pkg.nd.array(move) if hasattr(
                        data, 'asnumpy') else torch.from_numpy(move))
                    a = a + move
            relu_in.append(a)
        return _act(data, act_type=act_type, **kwargs)
    for m in sites:
        monkeypatch.setattr(m, 'activation', functools.partial(
            recording, _act=act[id(m)]))
    before = _values(net)
    trainer = pkg.gluon.Trainer(net.collect_params(), 'adam',
                                {'learning_rate': LR})
    with pkg.autograd.record():
        loss = models.ssd_train_loss(*net(pkg.nd.array(x)),
                                     pkg.nd.array(label))
    loss.backward()
    for m in sites:
        monkeypatch.setattr(m, 'activation', act[id(m)])
    grads = {k: p.grad().asnumpy() for k, p in
             net._collect_params_with_prefix().items()
             if p.grad_req != 'null'}
    trainer.step(x.shape[0])
    after = _values(net)
    return (float(loss.asnumpy()), grads,
            {k: after[k] - before[k] for k in grads}, relu_in)


def _ambiguous_relus(got, want):
    """[(ReLU call, flat index, port's input, JAX's input)] where the two
    inputs lie on different sides of 0, or one of them is 0: there the
    packages' derivatives differ (MXNet's relu has derivative 0 at 0, as
    torch's has; JAX's maximum splits a tie, 0.5)."""
    assert [a.shape for a in got] == [b.shape for b in want]
    out = []
    for i, (a, b) in enumerate(zip(got, want)):
        a, b = a.ravel(), b.ravel()
        for e in onp.flatnonzero(((a > 0) != (b > 0)) | (a == 0) |
                                 (b == 0)):
            out.append((i, int(e), float(a[e]), float(b[e])))
    return out


def test_ssd_train_step_matches_jax(monkeypatch):
    jnet, tnet, x = _pair()
    j0, t0 = _values(jnet), _values(tnet)
    label = _label(2)
    jl, jg, jup, jrelu = _adam_step(mj, jnet, jssd, x, label, monkeypatch)
    tl, tg, tup, trelu = _adam_step(mt, tnet, tssd, x, label, monkeypatch)
    amb = _ambiguous_relus(trelu, jrelu)
    assert len(amb) <= MAX_AMBIGUOUS, amb
    assert all(max(abs(a), abs(b)) < 1e-5 and (a != 0 or b != 0)
               for _, _, a, b in amb), amb
    # each unit within f32 rounding of 0 takes one input in both
    # packages: the port's, unless that is 0 (then JAX's)
    jshift = {(i, e): a for i, e, a, _ in amb if a != 0}
    tshift = {(i, e): b for i, e, a, b in amb if a == 0}
    if jshift:
        jl, jg, jup, jrelu = _adam_step(mj, _fresh(jssd, mj, j0, x), jssd,
                                        x, label, monkeypatch, jshift)
    if tshift:
        tl, tg, tup, trelu = _adam_step(mt, _fresh(tssd, mt, t0, x), tssd,
                                        x, label, monkeypatch, tshift)
    if amb:
        assert _ambiguous_relus(trelu, jrelu) == []
    assert onp.isfinite(tl)
    assert abs(tl - jl) <= LOSS_RTOL * abs(jl), (tl, jl)
    largest = max(onp.linalg.norm(g) for g in jg.values())
    noise, unresolved, total = [], 0, 0
    for k, want in jup.items():
        if k.endswith('.bias') and _feeds_batchnorm(tnet, k):
            noise.append(k)
            assert onp.linalg.norm(jg[k]) <= 1e-5 * largest, k
            assert onp.abs(tup[k]).max() <= LR * (1 + 1e-5), k
            continue
        assert rel_fro(tg[k], jg[k]) <= GRAD_TOL, k
        resolved = onp.abs(jg[k]) >= SIGN_MARGIN * onp.abs(tg[k] - jg[k])
        assert rel_fro(tup[k][resolved], want[resolved]) <= UPDATE_TOL, k
        unresolved += int((~resolved).sum())
        total += resolved.size
    assert len(noise) == 10, noise     # the backbone's 4 and stages' 6 convs
    assert unresolved < 0.01 * total, (unresolved, total)


def _feeds_batchnorm(net, key):
    """Whether parameter ``key`` is the bias of a convolution followed
    by a BatchNorm in its HybridSequential."""
    *path, conv_i, _ = key.split('.')
    blk = net
    for p in path:
        blk = blk._children[p]
    kids = list(blk._children.values())
    i = int(conv_i)
    return i + 1 < len(kids) and type(kids[i + 1]).__name__ == 'BatchNorm'


def test_ssd_detect_matches_jax():
    jnet, tnet, x = _pair(B=1, seed=2)
    jdet = jnet.detect(mj.nd.array(x), threshold=-1.0).asnumpy()
    tdet = tnet.detect(mt.nd.array(x), threshold=-1.0).asnumpy()
    A = _n_anchors()
    assert tdet.shape == (1, A, 6)
    onp.testing.assert_array_equal(tdet[..., 0], jdet[..., 0])
    onp.testing.assert_allclose(tdet, jdet, rtol=0, atol=ATOL)
    kept = tdet[0][tdet[0, :, 0] >= 0]
    assert len(kept) and (kept[:, 0] < 3).all()
    assert ((kept[:, 1] >= 0) & (kept[:, 1] <= 1)).all()


def test_ssd_512_constructs_with_the_jax_names_and_24572_anchors():
    jnet, tnet = jssd.ssd_512(num_classes=20), tssd.ssd_512(num_classes=20)
    assert len(tnet.stages) == 7 and len(tnet.cls_heads) == 7
    jp, tp = (n._collect_params_with_prefix() for n in (jnet, tnet))
    assert list(tp) == list(jp)
    assert {k: tuple(p.shape) for k, p in tp.items()} == \
        {k: tuple(p.shape) for k, p in jp.items()}
    tnet.initialize()
    x = onp.zeros((1, 3, 512, 512), onp.float32)
    anchor, cls_pred, loc_pred = tnet(mt.nd.array(x))
    assert anchor.shape == (1, 24572, 4)
    assert cls_pred.shape == (1, 21, 24572)
    assert loc_pred.shape == (1, 24572 * 4)
    assert tssd.ssd_300().image_size == 300 and len(tssd.ssd_300().stages) \
        == 6


def _carry_by_params_from_mxnet_tpu(jnet, tnet, run_j, run_t):
    run_j()
    run_t()
    arrays = _values(jnet)
    tnet.load_state_dict(params_from_mxnet_tpu(arrays, tnet))
    got = {k: v.detach().numpy() for k, v in tnet.named_parameters()}
    assert sorted(got) == sorted(arrays)
    for k, v in arrays.items():
        onp.testing.assert_array_equal(got[k], v)


def test_params_from_mxnet_tpu_carries_ssd_512():
    jnet, tnet = jssd.ssd_512(num_classes=20), tssd.ssd_512(num_classes=20)
    jnet.initialize(mj.init.Xavier())
    tnet.initialize()
    # every parameter's shape is fixed by the layers, not the image size
    x = onp.random.RandomState(3).randn(1, 3, 64, 64).astype(onp.float32)
    _carry_by_params_from_mxnet_tpu(
        jnet, tnet, lambda: jnet(mj.nd.array(x)),
        lambda: tnet(mt.nd.array(x)))
    tnet.eval()
    jout = jnet(mj.nd.array(x))
    tout = tnet(mt.nd.array(x))
    for j, t in zip(jout, tout):
        onp.testing.assert_allclose(t.asnumpy(), j.asnumpy(), rtol=0,
                                    atol=ATOL)


@pytest.mark.parametrize('make', [
    lambda m: m.LSTM(8, num_layers=2, bidirectional=True),
    lambda m: m.GRU(8)], ids=['lstm_2_bi', 'gru'])
def test_params_from_mxnet_tpu_carries_rnn_layers(make):
    jnet, tnet = make(jrnn), make(trnn)
    jnet.initialize(mj.init.Xavier())
    tnet.initialize()
    x = onp.random.RandomState(4).randn(5, 2, 3).astype(onp.float32)
    _carry_by_params_from_mxnet_tpu(
        jnet, tnet, lambda: jnet(mj.nd.array(x)),
        lambda: tnet(mt.nd.array(x)))
    onp.testing.assert_allclose(tnet(mt.nd.array(x)).asnumpy(),
                                jnet(mj.nd.array(x)).asnumpy(), rtol=0,
                                atol=ATOL)
