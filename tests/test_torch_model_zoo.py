"""The port's vision model zoo (ResNet v1/v2) and LeNet against the JAX
package's, on the CPU in f32.

ResNet-18 v1 and v2 (thumbnail, 10 classes, B = 2, 3 x 32 x 32) and LeNet
(B = 2, 1 x 28 x 28) are built in both packages, the JAX net's
(Xavier) values carried into the port's by structured name, then:

- the forward in predict mode: rtol 1e-4, atol 1e-5;
- one SGD step (momentum 0.9, lr 0.1) of the Gluon loop in training mode
  (``autograd.record``, SoftmaxCrossEntropyLoss, ``backward``,
  ``Trainer.step``): loss rel 1e-5, every gradient rel Frobenius 1e-4,
  the parameters after the step rel Frobenius 1e-5, the running
  statistics rtol 1e-5 (its absolute part at the vector's scale).

  A ReLU input within f32 rounding of 0 can put the two packages on
  different sides of the kink, and every gradient upstream of it then
  differs by ~2e-3. An input of exactly 0 does the same: MXNet's relu
  (and torch's) has derivative 0 there, JAX's maximum 0.5. At the
  suite's seed one residual sum in ResNet-18 v1's stage 2 is 0.0 in JAX
  and 3.6e-6 in the port. The test records every ReLU input of the step
  in both packages and asserts that at most one unit is so placed, and
  only within 1e-5 of 0. Where one is, the step is run again from the
  same values with that one input set to the port's value in the JAX net
  (to JAX's in the port, where the port's is 0), the move carrying no
  gradient; then every bound above holds against JAX's step, with no
  other exception.

Also: ResNet-50 v1's structured names and (MXNet, 0 = deferred) shapes
equal the JAX net's; ``get_model`` raises on an unknown name and every
ResNet name constructs; .params files cross between the packages both
ways with their running statistics; pretrained weights come from a local
file only; bench.py's ResNet-50 program runs in the port with only its
imports and mesh line changed; and the compiled step trains a BatchNorm
net as the JAX step does, running statistics included, with autograd's
training flag set for the ``nd`` ops a hybrid_forward calls.

The rest of the zoo (AlexNet, VGG, SqueezeNet, MobileNet v1/v2, DenseNet,
Inception v3): each family's predict forward against JAX's (He-normal
weights carried by ``params_from_mxnet_tpu``, rel Frobenius 1e-5);
densenet121's whole forward is ``slow`` (over 30 s on the JAX side), its
dense blocks run at full width instead; every JAX name constructs with
the JAX net's structured names and shapes; the model store's bare and
zipped local files, checksum refusal and ``purge``.
"""
import functools
import hashlib
import os

import numpy as onp
import pytest
import torch

import mxnet_tpu as mj
import mxnet_tpu_torch as mt
from mxnet_tpu.gluon.model_zoo import vision as jvision
from mxnet_tpu.models import lenet as jlenet
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon.model_zoo import vision as tvision
from mxnet_tpu_torch.models import lenet as tlenet
from mxnet_tpu_torch.ops import nn as tops_nn


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


MODELS = {
    'resnet18_v1': (lambda pk: (jvision if pk is mj else tvision)
                    .resnet18_v1(classes=10, thumbnail=True), (2, 3, 32, 32)),
    'resnet18_v2': (lambda pk: (jvision if pk is mj else tvision)
                    .resnet18_v2(classes=10, thumbnail=True), (2, 3, 32, 32)),
    'lenet': (lambda pk: (jlenet if pk is mj else tlenet).LeNet(),
              (2, 1, 28, 28)),
}
RESNET_NAMES = [f'resnet{n}_v{v}' for v in (1, 2)
                for n in (18, 34, 50, 101, 152)]


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


def _pair(name, seed=0):
    """(port net, JAX net, input): the JAX net initialized with Xavier,
    both placed by one predict-mode forward, the JAX values in both."""
    make, shape = MODELS[name]
    x = onp.random.RandomState(seed).randn(*shape).astype(onp.float32)
    jnet, tnet = make(mj), make(mt)
    jnet.initialize(mj.init.Xavier())
    tnet.initialize(mt.init.Xavier())
    jnet(mj.nd.array(x))
    tnet(mt.nd.array(x))
    src = _values(jnet)
    dst = tnet._collect_params_with_prefix()
    assert sorted(src) == sorted(dst)
    for k, v in src.items():
        dst[k].set_data(mt.nd.array(v))
    return tnet, jnet, x


@pytest.mark.parametrize('name', sorted(MODELS))
def test_forward_matches_jax(name):
    tnet, jnet, x = _pair(name)
    got = tnet(mt.nd.array(x)).asnumpy()
    want = jnet(mj.nd.array(x)).asnumpy()
    onp.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def _stats_close(got, want, name):
    """rtol 1e-5 of each running statistic, with the absolute part of it
    taken at the vector's scale: a channel mean near 0 sums its batch in
    another order in each package (f32 rounding of the sum, ~1e-7)."""
    onp.testing.assert_allclose(got, want, rtol=1e-5,
                                atol=1e-5 * float(onp.abs(want).max()),
                                err_msg=name)


def _sgd_step(pk, net, x, y, monkeypatch, shift=None):
    """One SGD-momentum step of the Gluon loop: (loss, gradients, values
    after the step, every ReLU input in call order). ``shift`` maps
    (ReLU call, flat index) to a value that input takes instead, the
    move carrying no gradient."""
    relu_in = []
    # the port's layers call ops.nn (tensors) or nd (either) directly
    sites = [pk.nd] + ([tops_nn] if pk is mt else [])
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
                    data = data + (pk.nd.array(move) if hasattr(
                        data, 'asnumpy') else torch.from_numpy(move))
                    a = a + move
            relu_in.append(a)
        return _act(data, act_type=act_type, **kwargs)
    for m in sites:
        monkeypatch.setattr(m, 'activation', functools.partial(
            recording, _act=act[id(m)]))
    trainer = pk.gluon.Trainer(net.collect_params(), 'sgd',
                               {'learning_rate': 0.1, 'momentum': 0.9})
    loss_fn = pk.gluon.loss.SoftmaxCrossEntropyLoss()
    with pk.autograd.record():
        loss = loss_fn(net(pk.nd.array(x)), pk.nd.array(y))
    loss.backward()
    for m in sites:
        monkeypatch.setattr(m, 'activation', act[id(m)])
    grads = {k: p.grad().asnumpy()
             for k, p in net._collect_params_with_prefix().items()
             if p.grad_req != 'null'}
    trainer.step(x.shape[0])
    return loss.asnumpy(), grads, _values(net), relu_in


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


def _fresh(pk, name, values, x):
    net = MODELS[name][0](pk)
    net.initialize()
    net(pk.nd.array(x))
    for k, p in net._collect_params_with_prefix().items():
        p.set_data(pk.nd.array(values[k]))
    return net


@pytest.mark.parametrize('name', sorted(MODELS))
def test_sgd_step_matches_jax(name, monkeypatch):
    tnet, jnet, x = _pair(name)
    before = _values(tnet)
    y = onp.array([3, 7], onp.int32)
    t_loss, t_grads, t_after, t_relu = _sgd_step(mt, tnet, x, y,
                                                 monkeypatch)
    j_loss, j_grads, j_after, j_relu = _sgd_step(mj, jnet, x, y,
                                                 monkeypatch)
    onp.testing.assert_allclose(t_loss, j_loss, rtol=1e-5)
    amb = _ambiguous_relus(t_relu, j_relu)
    assert len(amb) <= 1, amb
    if amb:
        # the one unit within f32 rounding of 0 takes one input in both
        # packages: the port's, unless that is 0 (then JAX's)
        i, e, a, b = amb[0]
        assert max(abs(a), abs(b)) < 1e-5 and (a != 0 or b != 0), amb
        if a != 0:
            j_loss, j_grads, j_after, j_relu = _sgd_step(
                mj, _fresh(mj, name, before, x), x, y, monkeypatch,
                shift={(i, e): a})
        else:
            t_loss, t_grads, t_after, t_relu = _sgd_step(
                mt, _fresh(mt, name, before, x), x, y, monkeypatch,
                shift={(i, e): b})
        assert _ambiguous_relus(t_relu, j_relu) == []
        onp.testing.assert_allclose(t_loss, j_loss, rtol=1e-5)
    assert sorted(t_grads) == sorted(j_grads)
    for k in j_grads:
        assert rel_fro(t_grads[k], j_grads[k]) <= 1e-4, k
        assert rel_fro(t_after[k], j_after[k]) <= 1e-5, k
    for k in j_after:
        if k.endswith(('running_mean', 'running_var')):
            _stats_close(t_after[k], j_after[k], k)


def test_resnet50_v1_names_and_shapes_match_jax():
    jnet = jvision.resnet50_v1(classes=1000)
    tnet = tvision.resnet50_v1(classes=1000)
    jp = {k: tuple(p.shape)
          for k, p in jnet._collect_params_with_prefix().items()}
    tp = {k: tuple(p.shape)
          for k, p in tnet._collect_params_with_prefix().items()}
    assert list(tp) == list(jp)
    assert tp == jp
    named = [n for n, _ in tnet.named_parameters()]
    assert named == list(jp)
    # the prefixed names differ only by the global counter's offset
    jn = [k.split('_', 1)[1] for k in jnet.collect_params()]
    tn = [k.split('_', 1)[1] for k in tnet.collect_params()]
    assert tn == jn


def test_get_model_unknown_raises():
    # the message lists every name, the families beyond ResNet among them
    with pytest.raises(ValueError, match='alexnet.*inceptionv3'):
        tvision.get_model('resnet9999_v9')


@pytest.mark.parametrize('name', RESNET_NAMES)
def test_every_resnet_constructs(name):
    net = tvision.get_model(name, classes=10)
    assert isinstance(net, (tvision.ResNetV1, tvision.ResNetV2))
    assert len(list(net.named_parameters())) == \
        len(jvision.get_model(name, classes=10)._collect_params_with_prefix())


def _trained_resnet18(pk):
    """resnet18_v1 (thumbnail), its running statistics moved by two
    training-mode forwards."""
    net = (jvision if pk is mj else tvision).resnet18_v1(classes=10,
                                                         thumbnail=True)
    net.initialize(pk.init.Xavier())
    rng = onp.random.RandomState(4)
    for _ in range(2):
        with pk.autograd.record():
            net(pk.nd.array(rng.randn(4, 3, 32, 32).astype(onp.float32)))
    return net


@pytest.mark.parametrize('writer', ['jax', 'port'])
def test_params_file_round_trip_across_packages(tmp_path, writer):
    src_pk, dst_pk = (mj, mt) if writer == 'jax' else (mt, mj)
    src = _trained_resnet18(src_pk)
    assert not onp.allclose(
        src.features[1][0].body[1].running_mean.data().asnumpy(), 0)
    f = str(tmp_path / 'resnet18_v1.params')
    src.save_parameters(f)
    dst = (jvision if dst_pk is mj else tvision).resnet18_v1(
        classes=10, thumbnail=True)
    dst.load_parameters(f)
    want, got = _values(src), _values(dst)
    for k in want:
        onp.testing.assert_array_equal(got[k], want[k])
    x = onp.random.RandomState(5).randn(2, 3, 32, 32).astype(onp.float32)
    onp.testing.assert_allclose(dst(dst_pk.nd.array(x)).asnumpy(),
                                src(src_pk.nd.array(x)).asnumpy(),
                                rtol=1e-4, atol=1e-5)


def test_pretrained_loads_a_local_file_only(tmp_path, monkeypatch):
    from mxnet_tpu_torch.gluon.model_zoo import model_store
    src = _trained_resnet18(mt)
    published = tmp_path / 'published.params'
    src.save_parameters(str(published))
    sha1 = hashlib.sha1(published.read_bytes()).hexdigest()
    monkeypatch.setitem(model_store._model_sha1, 'resnet18_v1', sha1)
    repo = tmp_path / 'repo' / 'gluon' / 'models'
    repo.mkdir(parents=True)
    published.rename(repo / f'resnet18_v1-{sha1[:8]}.params')
    cache = tmp_path / 'cache'
    with pytest.raises(MXNetError, match='downloads nothing'):
        tvision.get_model('resnet18_v1', pretrained=True, classes=10,
                          thumbnail=True, root=str(cache))
    monkeypatch.setenv('MXNET_GLUON_REPO', 'file://' + str(tmp_path / 'repo'))
    net = tvision.get_model('resnet18_v1', pretrained=True, classes=10,
                            thumbnail=True, root=str(cache))
    x = mt.nd.array(onp.random.RandomState(6).randn(2, 3, 32, 32)
                    .astype(onp.float32))
    onp.testing.assert_array_equal(net(x).asnumpy(), src(x).asnumpy())
    # the cached copy serves the next load without the repo
    monkeypatch.delenv('MXNET_GLUON_REPO')
    again = tvision.get_model('resnet18_v1', pretrained=True, classes=10,
                              thumbnail=True, root=str(cache))
    onp.testing.assert_array_equal(again(x).asnumpy(), src(x).asnumpy())


def test_bench_resnet_program_runs_in_the_port():
    """bench.py:191-214 (_resnet_report's model, loss, step and warm-up)
    with only the imports and the mesh line changed, at B = 2 and 64 x 64
    on the CPU (the card runs it at B = 64, 224 x 224 in chip_smoke)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import nd
    from mxnet_tpu_torch.gluon.model_zoo.vision import resnet50_v1
    from mxnet_tpu_torch.parallel import make_mesh, ShardedTrainStep
    batch = 2

    net = resnet50_v1(classes=1000)
    net.initialize(mx.init.Xavier())
    net.cast('bfloat16')

    def loss_fn(logits, labels):
        logp = nd.log_softmax(logits, axis=-1)
        return -nd.mean(nd.pick(logp, labels, axis=-1))

    mesh = make_mesh(devices=[torch.device('cpu')])
    step = ShardedTrainStep(net, loss_fn, 'sgd',
                            {'learning_rate': 0.1, 'momentum': 0.9},
                            mesh=mesh)
    rng = onp.random.RandomState(0)
    x = nd.array(rng.randn(batch, 3, 64, 64).astype(onp.float32))
    y = nd.array(rng.randint(0, 1000, (batch,)).astype(onp.int32))
    rm = net.features[1].running_mean
    for _ in range(2):
        v = float(step([x], [y]).asnumpy())
        assert onp.isfinite(v), "non-finite resnet loss"
    assert net.features[0].weight.dtype == torch.bfloat16
    assert float(rm.data().asnumpy().__abs__().sum()) > 0


class _AutogradBatchNorm(mt.gluon.nn.BatchNorm):
    """BatchNorm written as the JAX package's layer is: ``F.batch_norm``
    with ``training`` left to autograd's flag, the new statistics written
    back on every call."""

    def hybrid_forward(self, F, x, gamma, beta, running_mean, running_var):
        out, new_mean, new_var = F.batch_norm(
            x, gamma, beta, running_mean, running_var, **self._kwargs)
        with torch.no_grad():
            running_mean.copy_(new_mean)
            running_var.copy_(new_var)
        return out


@pytest.mark.parametrize('bn', ['layer', 'nd'])
def test_compiled_step_trains_batchnorm_as_jax(bn):
    """A conv + BatchNorm + Dense net through both packages'
    ShardedTrainStep (SGD, momentum 0.9), f32: the loss at each of 3
    steps, the parameters and the running statistics after them. 'nd'
    is a port BatchNorm that calls ``F.batch_norm`` with ``training``
    left to autograd's flag, as the JAX layer does: the step must set
    that flag, not only the module's."""
    from mxnet_tpu import parallel as jpar
    from mxnet_tpu_torch import parallel as tpar

    def make(pk):
        nn = pk.gluon.nn
        net = nn.HybridSequential()
        norm = _AutogradBatchNorm() if pk is mt and bn == 'nd' \
            else nn.BatchNorm()
        net.add(nn.Conv2D(4, 3, padding=1, use_bias=False), norm,
                nn.Activation('relu'), nn.GlobalAvgPool2D(), nn.Dense(5))
        return net

    def loss_fn_for(nd):
        def loss_fn(logits, labels):
            return -nd.mean(nd.pick(nd.log_softmax(logits, axis=-1), labels,
                                    axis=-1))
        return loss_fn

    rng = onp.random.RandomState(7)
    # 8 samples: the JAX step shards the batch over the suite's 8 CPU
    # devices
    x = rng.randn(8, 3, 8, 8).astype(onp.float32)
    y = rng.randint(0, 5, (8,)).astype(onp.int32)
    jnet, tnet = make(mj), make(mt)
    jnet.initialize(mj.init.Xavier())
    tnet.initialize(mt.init.Xavier())
    jnet(mj.nd.array(x))
    tnet(mt.nd.array(x))
    for k, v in _values(jnet).items():
        tnet._collect_params_with_prefix()[k].set_data(mt.nd.array(v))
    kw = {'learning_rate': 0.1, 'momentum': 0.9}
    jstep = jpar.ShardedTrainStep(jnet, loss_fn_for(mj.nd), 'sgd', dict(kw))
    tstep = tpar.ShardedTrainStep(tnet, loss_fn_for(mt.nd), 'sgd', dict(kw))
    for _ in range(3):
        lj = float(jstep([mj.nd.array(x)], [mj.nd.array(y)]).asnumpy())
        lt = float(tstep([mt.nd.array(x)], [mt.nd.array(y)]).asnumpy())
        assert abs(lt - lj) <= 1e-5 * abs(lj)
    assert not mt.autograd.is_training()
    want, got = _values(jnet), _values(tnet)
    assert not onp.allclose(want['1.running_mean'], 0)
    for k in want:
        if k.endswith(('running_mean', 'running_var')):
            _stats_close(got[k], want[k], k)
        else:
            assert rel_fro(got[k], want[k]) <= 1e-5, k


def test_compiled_step_trains_dropout_in_nd():
    """``F.dropout`` in a hybrid_forward draws its mask inside the step:
    two steps at lr 0 on the same batch give different losses, and the
    predict-mode forward after them matches the net without dropout."""
    from mxnet_tpu_torch import parallel as tpar

    class Net(mt.gluon.HybridBlock):
        def __init__(self):
            super().__init__()
            with self.name_scope():
                self.dense = mt.gluon.nn.Dense(3, in_units=16)

        def hybrid_forward(self, F, x):
            return self.dense(F.dropout(x, p=0.5))

    net = Net()
    net.initialize()
    step = tpar.ShardedTrainStep(
        net, lambda out, lab: mt.nd.mean(mt.nd.square(out - lab)), 'sgd',
        {'learning_rate': 0.0})
    rng = onp.random.RandomState(12)
    x = mt.nd.array(rng.randn(4, 16).astype(onp.float32))
    y = mt.nd.array(rng.randn(4, 3).astype(onp.float32))
    losses = [float(step([x], [y]).asnumpy()) for _ in range(2)]
    assert losses[0] != losses[1]
    onp.testing.assert_array_equal(net(x).asnumpy(),
                                   net.dense(x).asnumpy())


def test_weights_carry_a_gluon_net_with_its_running_stats():
    """weights.params_from_mxnet_tpu moves a trained JAX resnet18_v1,
    running statistics included, into the port's by structured name; a
    net still waiting for its shapes is refused."""
    from mxnet_tpu_torch.weights import params_from_mxnet_tpu
    src = _trained_resnet18(mj)
    arrays = _values(src)
    net = tvision.resnet18_v1(classes=10, thumbnail=True)
    with pytest.raises(MXNetError, match='deferred'):
        params_from_mxnet_tpu(arrays, net)
    net.initialize()
    x = onp.random.RandomState(8).randn(2, 3, 32, 32).astype(onp.float32)
    net(mt.nd.array(x))
    net.load_state_dict(params_from_mxnet_tpu(arrays, net))
    got = _values(net)
    for k in arrays:
        onp.testing.assert_array_equal(got[k], arrays[k])
    onp.testing.assert_allclose(net(mt.nd.array(x)).asnumpy(),
                                src(mj.nd.array(x)).asnumpy(),
                                rtol=1e-4, atol=1e-5)


# ---- the rest of the zoo: AlexNet, VGG, SqueezeNet, MobileNet, DenseNet,
# Inception v3. Each forward runs in predict mode with He-normal weights
# (Xavier gaussian, fan in, magnitude 2), so that activations keep their
# scale through the depthwise and BatchNorm stacks; the JAX side runs
# eagerly, which here takes less time than its hybridized compile.

HE = dict(rnd_type='gaussian', factor_type='in', magnitude=2)
ZOO_OUT_RTOL = 1e-5
# (name, input side): the narrow nets at the smallest side they take
# whole, the published widths at their published sides
ZOO_FORWARDS = [('alexnet', 224), ('vgg11', 32), ('vgg11_bn', 32),
                ('squeezenet1.0', 64), ('squeezenet1.1', 64),
                ('mobilenet0.25', 64), ('mobilenetv2_1.0', 224),
                ('inceptionv3', 299),
                # the JAX side takes over 30 s here (eagerly; longer
                # hybridized): held in tier-1 by its blocks below
                pytest.param('densenet121', 224, marks=pytest.mark.slow)]


def _carried(jnet, tnet, x):
    """Both nets initialised and placed by one predict-mode forward, the
    JAX net's arrays (BatchNorm's running statistics among them) carried
    into the port's by ``weights.params_from_mxnet_tpu``; returns the two
    outputs then."""
    from mxnet_tpu_torch.weights import params_from_mxnet_tpu
    jnet.initialize(mj.init.Xavier(**HE))
    tnet.initialize(mt.init.Xavier(**HE))
    want = jnet(mj.nd.array(x)).asnumpy()
    tnet(mt.nd.array(x))
    tnet.load_state_dict(params_from_mxnet_tpu(_values(jnet), tnet))
    return tnet(mt.nd.array(x)).asnumpy(), want


@pytest.mark.parametrize('name,side', ZOO_FORWARDS)
def test_zoo_forward_matches_jax(name, side):
    x = onp.random.RandomState(0).randn(2, 3, side, side) \
        .astype(onp.float32)
    got, want = _carried(jvision.get_model(name, classes=10),
                         tvision.get_model(name, classes=10), x)
    assert got.shape == (2, 10)
    assert onp.abs(want).max() > 1e-2
    assert rel_fro(got, want) <= ZOO_OUT_RTOL


def _blocks(pk):
    vision = jvision if pk is mj else tvision
    from importlib import import_module
    dn = import_module(vision.__name__ + '.densenet')
    mb = import_module(vision.__name__ + '.mobilenet')
    return {
        # densenet121's first and last dense blocks at their input widths
        # (growth 32, bottleneck 4), the first with its transition
        'densenet121_stage1': (lambda: _seq(pk, dn._make_dense_block(
            6, 4, 32, 0, 1), dn._make_transition(128)), (64, 14)),
        'densenet121_stage4': (lambda: dn._make_dense_block(16, 4, 32, 0, 4),
                               (512, 7)),
        # mobilenet1.0's depthwise-separable pair at 512 channels (the
        # whole v1 net runs at 0.25 above)
        'mobilenet1.0_dw': (lambda: _dw(pk, mb), (512, 7)),
    }


def _seq(pk, *blocks):
    net = pk.gluon.nn.HybridSequential(prefix='')
    for b in blocks:
        net.add(b)
    return net


def _dw(pk, mb):
    net = pk.gluon.nn.HybridSequential(prefix='')
    mb._add_conv_dw(net, dw_channels=512, channels=512, stride=1)
    return net


BLOCKS = sorted(_blocks(mt))


@pytest.mark.parametrize('block', BLOCKS)
def test_zoo_block_at_full_width_matches_jax(block):
    make_j, (c, side) = _blocks(mj)[block]
    make_t, _ = _blocks(mt)[block]
    x = onp.random.RandomState(1).randn(2, c, side, side).astype(onp.float32)
    got, want = _carried(make_j(), make_t(), x)
    assert got.shape == want.shape
    assert onp.abs(want).max() > 1e-2
    assert rel_fro(got, want) <= ZOO_OUT_RTOL


ZOO_NAMES = sorted(jvision._models)


def test_model_zoo_list_complete():
    """The port's twin of tests/test_model_zoo.py::
    test_model_zoo_list_complete: every family the reference model zoo
    ships is constructible, and get_model serves exactly the JAX
    package's names."""
    assert sorted(tvision._models) == ZOO_NAMES
    for fam in ['alexnet', 'vgg11', 'vgg13', 'vgg16', 'vgg19', 'vgg11_bn',
                'squeezenet1.0', 'squeezenet1.1', 'densenet121',
                'densenet161', 'densenet169', 'densenet201', 'inceptionv3',
                'mobilenet1.0', 'mobilenet0.5', 'mobilenetv2_1.0',
                'resnet18_v1', 'resnet34_v1', 'resnet50_v1', 'resnet101_v1',
                'resnet152_v1', 'resnet18_v2', 'resnet34_v2', 'resnet50_v2',
                'resnet101_v2', 'resnet152_v2']:
        net = tvision.get_model(fam, classes=10)
        assert net is not None


@pytest.mark.parametrize('name', [n for n in ZOO_NAMES
                                  if not n.startswith('resnet')])
def test_zoo_names_and_shapes_match_jax(name):
    """Each new family's structured names and (MXNet, 0 = deferred)
    shapes are the JAX net's, and its prefixed names differ only by the
    global counters' offsets."""
    jnet = jvision.get_model(name)
    tnet = tvision.get_model(name)
    jp = {k: tuple(p.shape)
          for k, p in jnet._collect_params_with_prefix().items()}
    tp = {k: tuple(p.shape)
          for k, p in tnet._collect_params_with_prefix().items()}
    assert list(tp) == list(jp)
    assert tp == jp
    strip = __import__('re').compile(r'\d+')
    assert [strip.sub('', k) for k in tnet.collect_params()] == \
        [strip.sub('', k) for k in jnet.collect_params()]


def _publish(tmp_path, monkeypatch, net, name, zipped):
    """Save ``net`` as ``name``'s published file into a local repo (bare or
    as the published zip), its SHA-1 made the table's; returns the file
    stem."""
    import zipfile
    params = tmp_path / 'published.params'
    net.save_parameters(str(params))
    sha1 = hashlib.sha1(params.read_bytes()).hexdigest()
    from mxnet_tpu_torch.gluon.model_zoo import model_store
    monkeypatch.setitem(model_store._model_sha1, name, sha1)
    repo = tmp_path / 'repo' / 'gluon' / 'models'
    repo.mkdir(parents=True, exist_ok=True)
    stem = f'{name}-{sha1[:8]}'
    if zipped:
        with zipfile.ZipFile(repo / (stem + '.zip'), 'w') as zf:
            zf.write(params, arcname=stem + '.params')
    else:
        params.rename(repo / (stem + '.params'))
    return stem


def test_model_store_pretrained_end_to_end(tmp_path, monkeypatch):
    """The port's twin of tests/test_model_zoo.py::
    test_model_store_pretrained_end_to_end, for a family beyond ResNet:
    get_model(..., pretrained=True) resolves the file through the store
    (local repo -> SHA-1 -> cache -> .params) and reproduces the
    publishing net's logits; the cache serves the next load alone."""
    mt.random.seed(3)
    src = tvision.get_model('squeezenet1.1', classes=10)
    src.initialize(mt.init.Xavier())
    x = mt.nd.array(onp.random.RandomState(0).randn(2, 3, 64, 64)
                    .astype(onp.float32))
    ref = src(x).asnumpy()
    stem = _publish(tmp_path, monkeypatch, src, 'squeezenet1.1', False)
    monkeypatch.setenv('MXNET_GLUON_REPO', 'file://' + str(tmp_path / 'repo'))
    cache = tmp_path / 'cache'
    net = tvision.get_model('squeezenet1.1', pretrained=True, classes=10,
                            root=str(cache))
    onp.testing.assert_array_equal(net(x).asnumpy(), ref)
    (tmp_path / 'repo' / 'gluon' / 'models' / (stem + '.params')).unlink()
    again = tvision.get_model('squeezenet1.1', pretrained=True, classes=10,
                              root=str(cache))
    onp.testing.assert_array_equal(again(x).asnumpy(), ref)


def test_model_store_zip_and_checksum(tmp_path, monkeypatch):
    """The port's twin of tests/test_model_zoo.py::
    test_model_store_zip_and_checksum: a zip-packaged repo file is
    unpacked into the cache, and a payload whose checksum is not the
    published one is refused."""
    import zipfile
    from mxnet_tpu_torch.gluon.model_zoo import model_store
    mt.random.seed(4)
    net = tvision.get_model('squeezenet1.0', classes=10)
    net.initialize(mt.init.Xavier())
    net(mt.nd.ones((1, 3, 64, 64)))   # materialize deferred shapes
    stem = _publish(tmp_path, monkeypatch, net, 'squeezenet1.0', True)
    monkeypatch.setenv('MXNET_GLUON_REPO', str(tmp_path / 'repo'))
    out = model_store.get_model_file('squeezenet1.0',
                                     root=str(tmp_path / 'cache'))
    assert out.endswith(stem + '.params')
    back = tvision.get_model('squeezenet1.0', classes=10)
    back.load_parameters(out)
    for k, v in _values(net).items():
        onp.testing.assert_array_equal(_values(back)[k], v)
    # no scratch files left beside the cached one
    assert sorted(os.listdir(tmp_path / 'cache')) == [stem + '.params']

    with zipfile.ZipFile(tmp_path / 'repo' / 'gluon' / 'models' /
                         (stem + '.zip'), 'w') as zf:
        zf.writestr(stem + '.params', b'corrupted bytes')
    with pytest.raises(ValueError, match='different hash'):
        model_store.get_model_file('squeezenet1.0',
                                   root=str(tmp_path / 'cache2'))


def test_model_store_purge_and_a_remote_repo(tmp_path, monkeypatch):
    """purge() removes the cached .params files (and only those); a repo
    that is not a local directory raises instead of downloading."""
    from mxnet_tpu_torch.gluon.model_zoo import model_store
    cache = tmp_path / 'cache'
    cache.mkdir()
    for f in ('a-1234abcd.params', 'b-5678abcd.params', 'notes.txt'):
        (cache / f).write_bytes(b'x')
    model_store.purge(str(cache))
    assert sorted(os.listdir(cache)) == ['notes.txt']
    model_store.purge(str(tmp_path / 'absent'))        # no directory: fine
    monkeypatch.setenv('MXNET_GLUON_REPO', 'https://example.invalid/')
    with pytest.raises(MXNetError, match='downloads nothing'):
        model_store.get_model_file('alexnet', root=str(cache))
    # a cached file with the wrong content is fetched again, not served
    (cache / f'alexnet-{model_store.short_hash("alexnet")}.params') \
        .write_bytes(b'stale')
    with pytest.raises(MXNetError, match='downloads nothing'):
        model_store.get_model_file('alexnet', root=str(cache))
