"""GPT, the Transformer and the Estimator on the card.

These tests need a CUDA device and carry the ``cuda`` marker; without a
card they skip. On the card, from the root of the checkout (the file
imports only torch, numpy and the port, so the JAX conftest is left out):

    python -m pytest --noconftest -m cuda tests/test_torch_lm_cuda.py

GPT runs at hidden 128, 2 layers, 2 heads (head dim 64: the tensor-core
variants of the flash kernels), T = 256, bf16, dropout 0.1 drawn on the
card, through ``ShardedTrainStep`` (one CUDA graph). The Transformer
runs bf16 at hidden 128, 2 + 2 layers, Tq = 40 != Tk = 64 under a key
mask. TF32 stays off.
"""
import numpy as onp
import pytest
import torch

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import gluon, parallel
from mxnet_tpu_torch.gluon.contrib import estimator as est_mod
from mxnet_tpu_torch.gluon.data import ArrayDataset, DataLoader
from mxnet_tpu_torch.models import gpt, transformer
from mxnet_tpu_torch.ops import attention as attn_ops

pytestmark = pytest.mark.cuda


@pytest.fixture(autouse=True)
def card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    torch.backends.cuda.matmul.allow_tf32 = False
    yield


def _zero_counters():
    mx.ops.reset_launch_counts()
    for k in attn_ops.route_counts:
        attn_ops.route_counts[k] = 0


def _replay_launches(fn, replays=3):
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(replays):
            fn()
        torch.cuda.synchronize()
    names = {e.key: e.count for e in prof.key_averages()}
    return {k: sum(c for n, c in names.items() if k in n) / replays
            for k in ('flash_fwd_tc_kernel', 'flash_bwd_dq_tc_kernel',
                      'flash_bwd_dkv_tc_kernel')}


def test_captured_gpt_step_launches_the_flash_kernels():
    """The eager step and the capture launch the forward, dq and dk/dv
    kernels once a layer each, on the tensor-core variant; each replay
    relaunches them from the graph, once a layer; the flash route carries
    every attention call and the losses are finite and fall."""
    cfg = dict(vocab_size=1000, hidden=128, layers=2, heads=2, max_len=256)
    gen = torch.Generator('cuda').manual_seed(0)
    net = gpt.GPTModel(**cfg, dropout=0.1, dtype=torch.bfloat16,
                       device='cuda', generator=gen)
    net.initialize(mx.init.Normal(0.02), force_reinit=True)
    step = parallel.ShardedTrainStep(net, gpt.gpt_lm_loss, 'adamw',
                                     {'learning_rate': 3e-3})
    rng = onp.random.RandomState(0)
    toks = rng.randint(0, cfg['vocab_size'], (4, 256))
    labels = onp.full_like(toks, -1)
    labels[:, :-1] = toks[:, 1:]
    ins = [torch.from_numpy(toks).cuda()]
    labs = [torch.from_numpy(labels).cuda()]
    _zero_counters()
    losses = [float(step(ins, labs)) for _ in range(3)]
    L = cfg['layers']
    assert attn_ops.route_counts['flash'] == 2 * L
    counts = {k: v for k, v in mx.ops.launch_counts.items() if v}
    assert counts == {'flash_attn_fwd': 2 * L, 'flash_attn_bwd_dq': 2 * L,
                      'flash_attn_bwd_dkv': 2 * L}
    assert {k: v for k, v in mx.ops.variant_counts.items() if v} == {
        'flash_attn_fwd.tc': 2 * L, 'flash_attn_bwd_dq.tc': 2 * L,
        'flash_attn_bwd_dkv.tc': 2 * L}
    assert _replay_launches(lambda: step(ins, labs)) == {
        'flash_fwd_tc_kernel': L, 'flash_bwd_dq_tc_kernel': L,
        'flash_bwd_dkv_tc_kernel': L}
    losses += [float(step(ins, labs)) for _ in range(6)]
    assert all(onp.isfinite(losses)) and losses[-1] < losses[0], losses


def test_gpt_eval_forward_is_deterministic_with_dropout_on():
    """Outside autograd's training mode the blocks draw no attention
    noise on the card either: two predict-mode forwards agree bitwise."""
    gen = torch.Generator('cuda').manual_seed(1)
    net = gpt.GPTModel(vocab_size=500, hidden=128, layers=2, heads=2,
                       max_len=128, dropout=0.1, dtype=torch.bfloat16,
                       device='cuda', generator=gen)
    net.initialize(mx.init.Normal(0.02), force_reinit=True)
    toks = mx.nd.array(onp.random.RandomState(2).randint(0, 500, (2, 128)),
                       ctx=mx.gpu(0), dtype='int32')
    a, b = net(toks).asnumpy(), net(toks).asnumpy()
    onp.testing.assert_array_equal(a, b)


def test_transformer_routes_every_attention_to_flash():
    """Every attention call takes the flash route, one forward kernel
    each, on the tensor-core variant, and the logits agree with the f32
    CPU plain forward within the serving bound (rel Frobenius 0.05)."""
    cfg = dict(hidden=128, enc_layers=2, dec_layers=2, heads=2,
               ffn_hidden=256, max_len=64, dropout=0.0)
    cpu = transformer.TransformerModel(50, 50, **cfg, device='cpu')
    cpu.initialize(mx.init.Xavier(), force_reinit=True)
    card = transformer.TransformerModel(50, 50, **cfg, device='cuda',
                                        dtype=torch.bfloat16)
    card.load_state_dict(cpu.state_dict())
    rng = onp.random.RandomState(0)
    src = torch.from_numpy(rng.randint(0, 50, (2, 64)))
    tgt = torch.from_numpy(rng.randint(0, 50, (2, 40)))
    mask = torch.arange(64)[None, None, None, :] < \
        torch.tensor([64, 33])[:, None, None, None]
    _zero_counters()
    with torch.no_grad():
        got = card.eval()(src.cuda(), tgt.cuda(), mask.cuda())
        want = cpu.eval()(src, tgt, mask)
    assert attn_ops.route_counts['flash'] == 6
    assert mx.ops.variant_counts['flash_attn_fwd.tc'] == 6
    g, w = got.float().cpu(), want
    assert float((g - w).norm() / w.norm()) <= 0.05


def _toy_problem(n=128, d=10, classes=3, seed=0):
    rng = onp.random.RandomState(seed)
    w = rng.randn(d, classes).astype(onp.float32)
    x = rng.randn(n, d).astype(onp.float32)
    y = (x.dot(w) + 0.1 * rng.randn(n, classes)).argmax(axis=1)
    return x, y.astype(onp.float32)


def test_estimator_fits_on_the_card(tmp_path):
    """The default context is the card: batches and parameters live
    there, the metrics read them on the host, and a CheckpointHandler and
    a WatchdogHandler run beside the fit."""
    x, y = _toy_problem()
    net = gluon.nn.HybridSequential()
    net.add(gluon.nn.Dense(16, activation='relu', in_units=10))
    net.add(gluon.nn.Dense(3, in_units=16))
    net.initialize(mx.init.Xavier())
    trainer = gluon.Trainer(net.collect_params(), 'sgd',
                            {'learning_rate': 0.1})
    acc = mx.metric.Accuracy()
    est = est_mod.Estimator(net, gluon.loss.SoftmaxCrossEntropyLoss(),
                            metrics=[acc], trainer=trainer)
    assert est.context == [mx.gpu(0)]
    wd = est_mod.WatchdogHandler(deadline_seconds=60)
    est.fit(DataLoader(ArrayDataset(x, y), batch_size=32), epochs=2,
            event_handlers=[est_mod.CheckpointHandler(str(tmp_path)), wd])
    assert wd._step == 8
    assert net[0].weight.data()._data.is_cuda
    assert 0.0 <= acc.get()[1] <= 1.0
