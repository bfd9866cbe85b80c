"""``MXTPU_REMAT`` in the port's ``ShardedTrainStep``: the JAX step's
three policies (none, layer, aggressive) on a small BERT.

- Against the JAX step under each policy, f32, dropout 0 (the JAX
  package's dropout draws other numbers): losses within rel 1e-5 over 3
  steps, parameters within rel 1e-4 (the bounds of
  ``tests/test_torch_sharded_step.py``).
- The port alone with attention and hidden dropout 0.1: under 'layer' and
  'aggressive' the loss, the gradients and the parameters after 2 steps
  are those under 'none' bit for bit on the CPU. A recompute that drew
  new masks or a new attention seed (generators not replayed) fails this.
- A BatchNorm net: the recompute leaves the running statistics as the
  forward left them.
"""
import jax
import numpy as onp
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import nd
from mxnet_tpu.models.bert import BertForPretraining as JBertPT
from mxnet_tpu.models.bert import bert_pretrain_loss as j_loss
from mxnet_tpu.parallel import step as jstep
from mxnet_tpu.parallel.mesh import make_mesh as jmake_mesh
from mxnet_tpu_torch import parallel
from mxnet_tpu_torch.models.bert import BertForPretraining, bert_pretrain_loss
from mxnet_tpu_torch.weights import params_from_mxnet_tpu
from test_torch_jax_globals import jax_globals  # noqa: F401

CFG = dict(vocab_size=256, hidden=64, layers=2, heads=2, intermediate=128,
           max_len=64, type_vocab=2, dropout=0.0)
B, T, M = 4, 32, 8
LOSS_RTOL, RTOL = 1e-5, 1e-4
POLICIES = ('none', 'layer', 'aggressive')
OPT = {'learning_rate': 1e-3, 'wd': 0.01, 'eps': 1e-6}


@pytest.fixture(scope='module')
def arrays():
    mx.random.seed(0)
    net = JBertPT(CFG, prefix='remat_')
    net.initialize(mx.init.Normal(0.02))
    net(nd.array(onp.zeros((1, 8), 'int32')))
    return {k: v.data().asnumpy()
            for k, v in net._collect_params_with_prefix().items()}


def _batch(seed=0):
    rng = onp.random.RandomState(seed)
    tokens = rng.randint(0, CFG['vocab_size'], (B, T)).astype('int32')
    types = rng.randint(0, 2, (B, T)).astype('int32')
    valid = rng.randint(T // 2, T + 1, B).astype('float32')
    mpos = onp.stack([rng.choice(T, M, replace=False)
                      for _ in range(B)]).astype('int32')
    labels = rng.randint(0, CFG['vocab_size'], (B, M)).astype('int32')
    labels[rng.rand(B, M) < 0.25] = -1
    nsp = rng.randint(0, 2, B).astype('int32')
    return [tokens, types, valid, mpos], [labels, nsp]


def _rel_fro(got, want):
    got, want = onp.asarray(got, onp.float64), onp.asarray(want, onp.float64)
    den = onp.linalg.norm(want)
    return onp.linalg.norm(got - want) / (den if den > 0 else 1.0)


def _port_net(arrays, cfg=CFG, gens=(None, None)):
    net = BertForPretraining(cfg, device='cpu', generator=gens[0],
                             attn_generator=gens[1])
    net.load_state_dict(params_from_mxnet_tpu(arrays, net))
    return net


def _tensors(batch):
    ins, labs = batch
    return [torch.from_numpy(a) for a in ins], \
        [torch.from_numpy(a) for a in labs]


@pytest.mark.parametrize('policy', POLICIES)
def test_port_step_matches_the_jax_step_under_each_policy(arrays, policy,
                                                          monkeypatch):
    monkeypatch.setenv('MXTPU_REMAT', policy)
    jnet = JBertPT(CFG, prefix='remat_')
    jnet.initialize()
    jnet(nd.array(onp.zeros((1, 8), 'int32')))
    for k, p in jnet._collect_params_with_prefix().items():
        p.set_data(nd.array(arrays[k]))
    js = jstep.ShardedTrainStep(
        jnet, j_loss, 'adamw', dict(OPT),
        mesh=jmake_mesh((1,), ('dp',), devices=jax.devices()[:1]))
    net = _port_net(arrays)
    ts = parallel.ShardedTrainStep(net, bert_pretrain_loss, 'adamw',
                                   dict(OPT),
                                   mesh=parallel.make_mesh(devices=['cpu']))
    assert js._remat_policy == ts._remat_policy == policy
    for i in range(3):
        ins, labs = _batch(i)
        jl = float(js([nd.array(a) for a in ins],
                      [nd.array(a) for a in labs]).asnumpy())
        tl = float(ts(*_tensors((ins, labs))))
        assert abs(tl - jl) <= LOSS_RTOL * abs(jl), (policy, i, tl, jl)
    jp = jnet._collect_params_with_prefix()
    worst = max((_rel_fro(p.detach().numpy(), jp[n].data().asnumpy()), n)
                for n, p in net.named_parameters())
    assert worst[0] <= RTOL, worst


def _dropout_run(arrays, policy, monkeypatch):
    """2 steps with attention and hidden dropout 0.1, then the gradients of
    a third batch through the step's own forward."""
    monkeypatch.setenv('MXTPU_REMAT', policy)
    gens = (torch.Generator().manual_seed(5), torch.Generator().manual_seed(6))
    net = _port_net(arrays, dict(CFG, dropout=0.1), gens)
    step = parallel.ShardedTrainStep(net, bert_pretrain_loss, 'adamw',
                                     dict(OPT),
                                     mesh=parallel.make_mesh(devices=['cpu']))
    losses = [float(step(*_tensors(_batch(i)))) for i in range(2)]
    ins, labs = _tensors(_batch(2))
    prev = step._train_flags()
    try:
        with torch.enable_grad():
            mlm, nsp = step._forward(ins)
            loss = bert_pretrain_loss(mlm, nsp, *labs)
            params = [p for _, p in step._trainable]
            grads = torch.autograd.grad(loss, params)
    finally:
        step._restore_flags(prev)
    return losses, {n: g for (n, _), g in zip(step._trainable, grads)}, \
        {n: p.detach().clone() for n, p in net.named_parameters()}


@pytest.mark.parametrize('policy', ['layer', 'aggressive'])
def test_remat_with_dropout_is_none_bit_for_bit(arrays, policy, monkeypatch):
    base = _dropout_run(arrays, 'none', monkeypatch)
    got = _dropout_run(arrays, policy, monkeypatch)
    assert got[0] == base[0]
    for n in base[1]:
        assert torch.equal(got[1][n], base[1][n]), (policy, 'grad', n)
        assert torch.equal(got[2][n], base[2][n]), (policy, 'param', n)
    # dropout did act: a different hidden stream gives other gradients
    assert any(float(g.abs().sum()) > 0 for g in base[1].values())


@pytest.mark.parametrize('policy', ['layer', 'aggressive'])
def test_recompute_leaves_batchnorm_statistics_as_the_forward(policy,
                                                              monkeypatch):
    from mxnet_tpu_torch import gluon
    from mxnet_tpu_torch.gluon import nn

    def run(pol):
        monkeypatch.setenv('MXTPU_REMAT', pol)
        torch.manual_seed(0)
        net = nn.HybridSequential()
        net.add(nn.Dense(16, in_units=8, device='cpu'),
                nn.BatchNorm(in_channels=16, device='cpu'),
                nn.Dense(4, in_units=16, device='cpu'))
        net.initialize(mx_init())
        step = parallel.ShardedTrainStep(
            net, gluon.loss.SoftmaxCrossEntropyLoss(), 'sgd',
            {'learning_rate': 0.1}, mesh=parallel.make_mesh(devices=['cpu']))
        rng = onp.random.RandomState(0)
        for _ in range(2):
            step(torch.from_numpy(rng.randn(12, 8).astype('float32')),
                 torch.from_numpy(rng.randint(0, 4, 12).astype('float32')))
        return {n: b.detach().clone() for n, b in net.named_parameters()
                if not b.requires_grad}

    base, got = run('none'), run(policy)
    assert base and all(torch.equal(got[n], base[n]) for n in base)


def mx_init():
    import mxnet_tpu_torch as tmx
    tmx.random.seed(0)
    return tmx.init.Xavier()
