"""BERT pretraining data-parallel: the port's ``ShardedTrainStep`` at dp = 2
over gloo against the JAX step on a two-device CPU mesh and against the
port at dp = 1, and the attention-dropout masks by global coordinates.

A small ``BertForPretraining`` (vocab 256, hidden 64, 2 layers, 2 heads,
FFN 128, max_len 64, f32), initialised Normal(0.02) in the JAX package;
its arrays cross to every rank by structured name. The global batch is
B = 8, T = 32, valid_length in [T/2, T], 8 masked positions a row with a
quarter of their labels -1 (so the masked-LM loss divides by a count
that differs between the ranks' rows: the step's loss is the global
batch's). AdamW lr 1e-3, wd 0.01, eps 1e-6 (see test_torch_sharded_step:
rounding-noise gradients of the qkv key bias). Three steps; losses and
weights within 1e-5:

- dropout 0: the port at dp = 2 against the JAX step at dp = 2 (JAX
  draws its attention seed from threefry, so no seed could match);
- hidden dropout 0, attention dropout 0.1: the port at dp = 2 against the
  port at dp = 1 on the global batch, the attention stream seeded alike
  (``dp_generators``).

The two ranks' attention keep masks (the plain version's, at the
``bh_base`` the world gives) equal the one-process masks at the global
batch bit for bit, and the JAX ``_counter_keep`` at global coordinates.
The hidden-dropout masks differ between the ranks, each keeping within
a binomial 5 sigma of 0.9. The world (a ``FileStore`` under ``tmp_path``,
one thread per rank, 120 s, then killed) runs once for the module; its
worker imports only the port and numpy.
"""
import os
import pickle

import jax.numpy as jnp
import numpy as onp
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import nd
from mxnet_tpu.models.bert import BertForPretraining as JBertPT
from mxnet_tpu.models.bert import bert_pretrain_loss as j_loss
from mxnet_tpu.ops.pallas_attention import _counter_keep
from mxnet_tpu.parallel import ShardedTrainStep as JStep
from mxnet_tpu.parallel import make_mesh as jmake_mesh
from mxnet_tpu_torch import parallel
from mxnet_tpu_torch.models.bert import (BertForPretraining,
                                         bert_pretrain_loss, dp_generators)
from mxnet_tpu_torch.ops import flash_attention as fa
from mxnet_tpu_torch.parallel import dist
from mxnet_tpu_torch.weights import params_from_mxnet_tpu
from test_torch_jax_globals import jax_globals  # noqa: F401

ROOT = os.path.normpath(os.path.join(os.path.dirname(__file__), os.pardir))
WORLD_TIMEOUT = 120.0
CFG = dict(vocab_size=256, hidden=64, layers=2, heads=2, intermediate=128,
           max_len=64, type_vocab=2, dropout=0.0)
B, T, M, STEPS, SEED = 8, 32, 8, 3, 7
OPT = {'learning_rate': 1e-3, 'wd': 0.01, 'eps': 1e-6}
ATTN_P, HIDDEN_P = 0.1, 0.1
TOL = 1e-5

WORKER = r'''
import os, pickle, sys
import numpy as onp
import torch
torch.set_num_threads(1)
from mxnet_tpu_torch import parallel
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon import nn
from mxnet_tpu_torch.models.bert import (BertForPretraining,
                                         bert_pretrain_loss, dp_generators)
from mxnet_tpu_torch.ops import attention, flash_attention as fa
from mxnet_tpu_torch.parallel import dist
from mxnet_tpu_torch.weights import params_from_mxnet_tpu

tmp, name = sys.argv[1], sys.argv[2]
dist.init(device='cpu')
r, n = dist.rank(), dist.num_workers()
with open(os.path.join(tmp, 'ref.pkl'), 'rb') as f:
    ref = pickle.load(f)
cfg, opt, steps, seed = ref['cfg'], ref['opt'], ref['steps'], ref['seed']
b = ref['batch'][0][0].shape[0] // n
ins = [torch.from_numpy(a[r * b:(r + 1) * b]) for a in ref['batch'][0]]
labs = [torch.from_numpy(a[r * b:(r + 1) * b]) for a in ref['batch'][1]]
mesh = parallel.make_mesh((n,), ('dp',), devices=['cpu'])
out = {}


def train(attn_p, **gens):
    net = BertForPretraining(dict(cfg, dropout=attn_p), device='cpu',
                             **gens)
    for m in net.modules():
        if isinstance(m, nn.Dropout):
            m._rate = 0.0        # hidden dropout off, attention's kept
    net.load_state_dict(params_from_mxnet_tpu(ref['arrays'], net))
    st = parallel.ShardedTrainStep(net, bert_pretrain_loss, 'adamw',
                                   dict(opt), mesh=mesh)
    losses = [float(st(ins, labs)) for _ in range(steps)]
    return dict(losses=losses, zero=st.zero, weights={
        k: p.detach().numpy().copy() for k, p in net.named_parameters()})


out['plain'] = train(0.0)
hidden, attn = dp_generators(seed, 'cpu')
out['attn'] = train(ref['attn_p'], generator=hidden, attn_generator=attn)
# the attention masks this rank draws, at the world's bh_base
B, H, T = b, cfg['heads'], ins[0].shape[1]
out['bh_base'] = attention._world_bh_base(B, H)
out['keep'] = fa._keep_multipliers(ref['mask_seed'], B, H, T, T,
                                   ref['attn_p'], 'cpu',
                                   out['bh_base']).numpy()
# hidden dropout: one stream per rank
hidden, _ = dp_generators(seed, 'cpu')
drop = nn.Dropout(ref['hidden_p'], generator=hidden)
drop.train()
out['hidden_mask'] = (drop(torch.ones(64, 64)) != 0).numpy()
# one generator feeding both under dp is refused at the build
net = BertForPretraining(dict(cfg, dropout=0.1), device='cpu',
                         generator=torch.Generator().manual_seed(seed))
net.load_state_dict(params_from_mxnet_tpu(ref['arrays'], net))
try:
    parallel.ShardedTrainStep(net, bert_pretrain_loss, 'adamw', dict(opt),
                              mesh=mesh)(ins, labs)
    out['shared'] = 'ran'
except MXNetError as e:
    out['shared'] = str(e)
with open(os.path.join(tmp, f'{name}_r{r}.pkl'), 'wb') as f:
    pickle.dump(out, f)
dist.shutdown()
'''


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


@pytest.fixture(scope='module')
def model():
    mx.random.seed(0)
    net = JBertPT(CFG, prefix='dpbert_')
    net.initialize(mx.init.Normal(0.02))
    net(nd.array(onp.zeros((1, 8), 'int32')))
    arrays = {k: v.data().asnumpy()
              for k, v in net._collect_params_with_prefix().items()}
    return net, arrays


@pytest.fixture(scope='module')
def world(tmp_path_factory, model):
    _, arrays = model
    tmp = tmp_path_factory.mktemp('dpbert')
    with open(tmp / 'ref.pkl', 'wb') as f:
        pickle.dump(dict(cfg=CFG, opt=OPT, steps=STEPS, seed=SEED,
                         arrays=arrays, batch=_batch(), attn_p=ATTN_P,
                         hidden_p=HIDDEN_P, mask_seed=SEED), f)
    script = tmp / 'worker.py'
    script.write_text(WORKER)
    codes = dist.launch_local([str(script), str(tmp), 'dp2'], n=2,
                              env={'OMP_NUM_THREADS': '1',
                                   'PYTHONPATH': ROOT},
                              coordinator=f'file://{tmp}/dp2.store',
                              timeout=WORLD_TIMEOUT)
    assert codes == [0, 0], codes
    return [pickle.loads((tmp / f'dp2_r{r}.pkl').read_bytes())
            for r in range(2)]


def _max_diff(got, want):
    return max(float(onp.max(onp.abs(got[k] - want[k]))) for k in want)


def test_bert_dp2_matches_the_jax_step_at_dp2(model, world):
    jnet, arrays = model
    for k, p in jnet._collect_params_with_prefix().items():
        p.set_data(nd.array(arrays[k]))
    step = JStep(jnet, j_loss, 'adamw', dict(OPT),
                 mesh=jmake_mesh((2,), ('dp',)))
    ins, labs = _batch()
    jl = [float(step([nd.array(a) for a in ins],
                     [nd.array(a) for a in labs]).asnumpy())
          for _ in range(STEPS)]
    jw = {k: p.data().asnumpy()
          for k, p in jnet._collect_params_with_prefix().items()}
    assert all(b < a for a, b in zip(jl, jl[1:])), jl
    for o in world:
        got = o['plain']
        assert got['zero']
        assert max(abs(a - b) for a, b in zip(got['losses'], jl)) <= TOL, \
            (got['losses'], jl)
        assert _max_diff(got['weights'], jw) <= TOL


def test_bert_dp2_with_attention_dropout_matches_dp1(model, world):
    """The attention masks are a hash of global coordinates, so two ranks
    with the shared stream train what one process trains on the global
    batch."""
    _, arrays = model
    hidden, attn = dp_generators(SEED, 'cpu')
    net = BertForPretraining(dict(CFG, dropout=ATTN_P), device='cpu',
                             generator=hidden, attn_generator=attn)
    for m in net.modules():
        if type(m).__name__ == 'Dropout':
            m._rate = 0.0
    net.load_state_dict(params_from_mxnet_tpu(arrays, net))
    step = parallel.ShardedTrainStep(net, bert_pretrain_loss, 'adamw',
                                     dict(OPT),
                                     mesh=parallel.make_mesh(devices=['cpu']))
    ins, labs = _batch()
    losses = [float(step([torch.from_numpy(a) for a in ins],
                         [torch.from_numpy(a) for a in labs]))
              for _ in range(STEPS)]
    weights = {k: p.detach().numpy() for k, p in net.named_parameters()}
    plain = world[0]['plain']['losses']
    assert losses[0] != plain[0]          # the dropout ran
    for o in world:
        got = o['attn']
        assert max(abs(a - b) for a, b in zip(got['losses'], losses)) <= \
            TOL, (got['losses'], losses)
        assert _max_diff(got['weights'], weights) <= TOL


def test_attention_masks_are_the_global_batch_masks(world):
    b, H = B // 2, CFG['heads']
    assert [o['bh_base'] for o in world] == [0, b * H]
    ranks = onp.concatenate([o['keep'] for o in world])
    one = fa._keep_multipliers(SEED, B, H, T, T, ATTN_P, 'cpu').numpy()
    assert onp.array_equal(ranks, one)
    bh = jnp.arange(B * H, dtype=jnp.uint32).reshape(B, H, 1, 1)
    rows = jnp.arange(T, dtype=jnp.uint32).reshape(1, 1, T, 1)
    cols = jnp.arange(T, dtype=jnp.uint32).reshape(1, 1, 1, T)
    ref = onp.asarray(_counter_keep(jnp.uint32(SEED), bh, rows, cols,
                                    ATTN_P))
    assert onp.array_equal(ranks, ref)
    # without the offset the two ranks would draw the same masks
    assert not onp.array_equal(world[0]['keep'], world[1]['keep'])


def test_hidden_dropout_masks_are_per_rank(world):
    a, b = (o['hidden_mask'] for o in world)
    assert not onp.array_equal(a, b)
    keep = 1 - HIDDEN_P
    for m in (a, b):
        sigma = (keep * HIDDEN_P / m.size) ** 0.5
        assert abs(m.mean() - keep) <= 5 * sigma, m.mean()


def test_one_generator_for_both_streams_is_refused_under_dp(world):
    for o in world:
        assert 'separate streams' in o['shared']
