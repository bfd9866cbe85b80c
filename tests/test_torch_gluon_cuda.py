"""Gluon's ``hybridize()`` on the card: captured CUDA graphs against the
same blocks run eagerly.

These tests need a CUDA device and carry the ``cuda`` marker; without a
card they skip. On the card, from the root of the checkout (the file
imports only torch, numpy and the port, so the JAX conftest is left out):

    python -m pytest --noconftest -m cuda tests/test_torch_gluon_cuda.py

cuDNN's TF32 and its benchmark mode stay off, so the eager run and the
capture pick the same algorithms and the predict-mode results must be
bitwise equal.
"""
import gc

import numpy as onp
import pytest
import torch

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd, gluon, nd
from mxnet_tpu_torch.gluon.model_zoo import vision

pytestmark = pytest.mark.cuda


@pytest.fixture(autouse=True)
def card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    # what earlier tests of the process left (graphs, streams, generators
    # kept alive by garbage cycles, queued work) is finished and freed
    # before this test captures anything
    gc.collect()
    torch.cuda.synchronize()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = False
    mx.random.seed(0)


def _net(dtype='float32'):
    """resnet18_v1 (thumbnail) on the card, placed by one forward."""
    net = vision.resnet18_v1(classes=10, thumbnail=True)
    net.initialize(mx.init.Xavier(), ctx=mx.gpu(0))
    if dtype != 'float32':
        net.cast(dtype)
    net(_x(dtype))
    return net


def _x(dtype='float32', batch=4, seed=0):
    return nd.array(onp.random.RandomState(seed).randn(batch, 3, 32, 32)
                    .astype('float32'), ctx=mx.gpu(0), dtype=dtype)


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_hybridized_predict_is_bitwise_the_eager_forward(dtype):
    net = _net(dtype)
    x = _x(dtype)
    eager = net(x).asnumpy()
    net.hybridize()
    first = net(x).asnumpy()       # the key's first call: eager + capture
    replay = net(x).asnumpy()
    other = net(_x(dtype, seed=1)).asnumpy()
    onp.testing.assert_array_equal(first, eager)
    onp.testing.assert_array_equal(replay, eager)
    assert not onp.array_equal(other, eager)
    assert net._cached_op.num_graphs == 1
    net(_x(dtype, batch=2))        # another shape: another graph
    assert net._cached_op.num_graphs == 2


def test_batchnorm_running_stats_update_in_place_under_capture():
    """autograd.train_mode() outside record(): captured, and each replay
    updates the running statistics as one eager forward does."""
    eager_net, graph_net = _net(), _net()
    for k, p in eager_net._collect_params_with_prefix().items():
        graph_net._collect_params_with_prefix()[k].set_data(p.data())
    graph_net.hybridize()
    bn = 'features.1.0.body.1.running_mean'
    for step in range(3):
        x = _x(seed=step)
        with autograd.train_mode():
            a = eager_net(x).asnumpy()
            b = graph_net(x).asnumpy()
        onp.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-6)
        ra = eager_net._collect_params_with_prefix()[bn].data().asnumpy()
        rb = graph_net._collect_params_with_prefix()[bn].data().asnumpy()
        onp.testing.assert_allclose(rb, ra, rtol=1e-5, atol=1e-7)
    assert graph_net._cached_op.num_graphs == 1


def test_hybridized_training_step_matches_eager():
    """Under autograd.record() the forward and backward replay as graphs
    (make_graphed_callables). Three steps, each from the eager net's
    current values: the losses, every gradient and the running
    statistics agree with the eager step (the same kernels; only the
    graph's order of independent launches may differ)."""
    eager, hybrid = _net(), _net()
    hybrid.hybridize()
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    y = nd.array(onp.array([1, 2, 3, 4]), ctx=mx.gpu(0))
    for step in range(3):
        src = eager._collect_params_with_prefix()
        for k, p in hybrid._collect_params_with_prefix().items():
            p.set_data(src[k].data())
        x = _x(seed=step)
        out = {}
        for name, net in (('eager', eager), ('hybrid', hybrid)):
            with autograd.record():
                loss = loss_fn(net(x), y)
            loss.backward()
            params = net._collect_params_with_prefix()
            out[name] = (loss.asnumpy(), {
                k: (p.grad() if p.grad_req != 'null' else p.data())
                .asnumpy() for k, p in params.items()})
        onp.testing.assert_allclose(out['hybrid'][0], out['eager'][0],
                                    rtol=1e-5)
        for k, want in out['eager'][1].items():
            got = out['hybrid'][1][k]
            err = onp.linalg.norm(got - want) / max(onp.linalg.norm(want),
                                                    1e-30)
            assert err <= 1e-5, (step, k, err)
        # an SGD step on the eager net; the next step starts both there
        for p in eager.collect_params().values():
            if p.grad_req != 'null':
                p.set_data(p.data() - 0.01 * p.grad())
    assert hybrid._cached_op.num_graphs == 1


class _DropoutNet(gluon.HybridBlock):
    """A Dense layer behind ``F.dropout``, the MXNet idiom: the mask comes
    from the port's generator, not from a layer's own."""

    def __init__(self, mode='training'):
        super().__init__()
        self._mode = mode
        with self.name_scope():
            self.dense = gluon.nn.Dense(8, in_units=64)

    def hybrid_forward(self, F, x):
        return self.dense(F.dropout(x, p=0.5, mode=self._mode))


def _dropout_x():
    return nd.array(onp.random.RandomState(3).randn(16, 64)
                    .astype('float32'), ctx=mx.gpu(0))


def test_nd_dropout_under_record_draws_a_new_mask_each_call():
    """Under autograd.record() a hybridized block whose forward draws
    from the port's generator runs eagerly (make_graphed_callables could
    not register that generator): each call draws a new mask, and the
    gradient flows through it."""
    net = _DropoutNet()
    net.initialize(ctx=mx.gpu(0))
    net.hybridize()
    x = _dropout_x()
    outs = []
    for _ in range(3):
        with autograd.record():
            out = net(x)
        out.backward()
        outs.append(out.asnumpy())
        assert onp.abs(net.dense.weight.grad().asnumpy()).sum() > 0
    assert not onp.array_equal(outs[0], outs[1])
    assert not onp.array_equal(outs[1], outs[2])
    assert net._cached_op.num_graphs == 1


def test_nd_dropout_in_a_predict_graph_draws_a_new_mask_each_replay():
    """mode='always' draws in predict mode too: the captured graph has the
    port's generator registered even when the key's first call is that
    generator's first use, so each replay draws a new mask."""
    mx.random._generators.pop(('cuda', 0), None)
    net = _DropoutNet(mode='always')
    net.initialize(ctx=mx.gpu(0))
    net.hybridize()
    x = _dropout_x()
    outs = [net(x).asnumpy() for _ in range(3)]
    assert not onp.array_equal(outs[1], outs[2])
    assert not onp.array_equal(outs[0], outs[1])
    assert net._cached_op.num_graphs == 1
