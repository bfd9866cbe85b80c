"""The guard, the checkpoint manager and the RNG state on the card.

These tests need a CUDA device and carry the ``cuda`` marker; without a
card they skip. On the card, from the root of the checkout (the file
imports only torch, numpy and the port, so the JAX conftest is left out):

    python -m pytest --noconftest -m cuda tests/test_torch_resilience_cuda.py

The model is BERT at hidden 256, 2 layers, 4 heads (head dim 64: the
tensor-core variants of the flash kernels), bf16, dropout 0.1 drawn on
the card, both fused-kernel knobs on, its compiled step one CUDA graph.
TF32 stays off so eager runs and replays agree bitwise.
"""
import numpy as onp
import pytest
import torch

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import checkpoint, gluon, parallel, serialization
from mxnet_tpu_torch import random as trandom
from mxnet_tpu_torch.gluon import nn
from mxnet_tpu_torch.models.bert import BertForPretraining, bert_pretrain_loss
from mxnet_tpu_torch.resilience import NonFiniteGuard, faults

pytestmark = pytest.mark.cuda

CFG = dict(vocab_size=1000, hidden=256, layers=2, heads=4, intermediate=1024,
           max_len=128, type_vocab=2, dropout=0.1)


@pytest.fixture(autouse=True)
def card(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    torch.backends.cuda.matmul.allow_tf32 = False
    monkeypatch.setenv('MXTPU_PALLAS_LN', '1')
    monkeypatch.setenv('MXTPU_PALLAS_FFN', '1')
    faults.disarm()
    yield
    faults.disarm()


def _net(seed=0):
    net = BertForPretraining(CFG, dtype=torch.bfloat16, device='cuda',
                             generator=torch.Generator('cuda')
                             .manual_seed(seed + 1))
    rng = onp.random.RandomState(seed)
    with torch.no_grad():
        for n, p in net.named_parameters():
            if n.endswith('weight'):
                p.copy_(torch.from_numpy(rng.standard_normal(tuple(p.shape))
                                         .astype('float32') * 0.02))
    return net


def _batch(seed, B=4, T=128, M=16):
    rng = onp.random.RandomState(seed)
    ins = [rng.randint(0, CFG['vocab_size'], (B, T)),
           onp.zeros((B, T), 'int64'),
           rng.randint(T // 2, T + 1, B).astype('float32'),
           onp.stack([rng.choice(T, M, replace=False) for _ in range(B)])]
    labs = [rng.randint(0, CFG['vocab_size'], (B, M)), rng.randint(0, 2, B)]
    return [torch.from_numpy(a).cuda() for a in ins], \
        [torch.from_numpy(a).cuda() for a in labs]


def _step(net, guard=None):
    return parallel.ShardedTrainStep(net, bert_pretrain_loss, 'adamw',
                                     {'learning_rate': 1e-3, 'wd': 0.01},
                                     guard=guard)


def _state(net, step):
    return ([p.detach().clone() for p in net.parameters()],
            [m.clone() for m in step._master.values()],
            [s.clone() for st in step._state.values() for s in st],
            step._t.clone())


def _equal(a, b):
    return all(torch.equal(x, y) for xs, ys in zip(a[:3], b[:3])
               for x, y in zip(xs, ys)) and torch.equal(a[3], b[3])


def test_guarded_step_skips_inside_the_graph():
    """A NaN step (the fault's device scalar) replayed from the one
    captured graph leaves every gated tensor bitwise; the next step reads
    the flag and trains on."""
    net = _net()
    guard = NonFiniteGuard(policy='skip')
    step = _step(net, guard)
    faults.arm('step.dispatch', 'nan', window=(3, 3))
    b = _batch(1)
    for _ in range(2):
        step(*b)
    before = _state(net, step)
    assert not onp.isfinite(float(step(*b)))
    assert _equal(before, _state(net, step))
    assert onp.isfinite(float(step(*b)))
    assert guard.bad_steps == 1 and len(step._graphs) == 1
    assert not _equal(before, _state(net, step))


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_flag_catches_one_bad_element(dtype):
    """One NaN or inf element in one gradient turns the flag off (the
    inf-norm reduction propagates both on the card)."""
    net = _net()
    step = _step(net, NonFiniteGuard(policy='skip'))
    step(*_batch(1))
    loss = torch.tensor(1.0, device='cuda')
    for bad in (float('nan'), float('inf'), -float('inf')):
        gs = [torch.randn(512, 256, device='cuda', dtype=dtype)
              for _ in range(4)]
        gs[2].view(-1)[777] = bad
        step._gate.check(gs, loss)
        assert float(step._gate.ok) == 0.0, bad
    step._gate.check([torch.randn(64, device='cuda', dtype=dtype)])
    assert float(step._gate.ok) == 1.0
    step._gate.check([], torch.tensor(float('nan'), device='cuda'))
    assert float(step._gate.ok) == 0.0


def test_rng_state_after_replays_is_the_eager_state():
    """A generator registered with the step's graph advances its Philox
    offset on every replay as an eager step would: the state after N
    calls (one eager, N-1 replays) is the state after N eager forwards."""
    b = _batch(2)
    net = _net(3)
    step = _step(net)
    for _ in range(4):
        step(*b)
    got = trandom.get_state(net)['torch']['modules']
    net2 = _net(3)
    net2.train()
    for _ in range(4):
        bert_pretrain_loss(*net2(*b[0]), *b[1]).mean().backward()
    want = trandom.get_state(net2)['torch']['modules']
    assert got == want and len(got) == 1


def test_restore_into_the_captured_step_replays_bitwise(tmp_path):
    """Save at step 2; two more steps; restore step 2 into the same
    captured step (in place: the graph stays valid) and run the two
    steps again: the same losses and state bit for bit, dropout and all
    (the generators' states came back)."""
    net = _net(4)
    step = _step(net)
    batches = [_batch(10 + i) for i in range(4)]
    for b in batches[:2]:
        step(*b)
    mgr = checkpoint.CheckpointManager(str(tmp_path), params=net,
                                       trainer=step)
    mgr.save(2)                  # async: the copies land before step 3
    first = [float(step(*b)) for b in batches[2:]]
    after = _state(net, step)
    ptrs = [p.data_ptr() for p in net.parameters()]
    assert mgr.restore_latest() == 2
    assert [p.data_ptr() for p in net.parameters()] == ptrs
    again = [float(step(*b)) for b in batches[2:]]
    assert again == first
    assert _equal(after, _state(net, step))
    assert len(step._graphs) == 1
    mgr.close()


def test_async_snapshot_is_the_state_at_save(tmp_path):
    """The snapshot's copies are queued on the step's stream before the
    next replay rewrites the tensors in place: the checkpoint holds the
    state save() was called at."""
    net = _net(5)
    step = _step(net)
    b = _batch(3)
    step(*b)
    want = {n: p.detach().float().cpu().numpy() for n, p in
            net.named_parameters()}
    mgr = checkpoint.CheckpointManager(str(tmp_path), params=net,
                                       trainer=step)
    mgr.save(1)
    for _ in range(3):
        step(*b)
    mgr.wait()
    ck = mgr.restore_latest(apply=False)
    for n, w in want.items():
        got = serialization.to_tensor(ck.params[n]).float().numpy()
        assert onp.array_equal(got, w), n
    mgr.close()


def test_trainer_guard_inside_the_fused_graph():
    """The Trainer's captured fused update under the guard: poisoned
    steps keep the weights, the next steps train, the counts rewind."""
    rng = onp.random.RandomState(0)
    x = mx.nd.array(rng.randn(64, 32).astype('float32'), ctx=mx.gpu())
    y = mx.nd.array(rng.randn(64, 1).astype('float32'), ctx=mx.gpu())
    with mx.gpu():
        net = nn.Dense(1, in_units=32)
        net.initialize()
    trainer = gluon.Trainer(net.collect_params(), 'adam',
                            {'learning_rate': 0.05})
    guard = NonFiniteGuard(policy='skip')
    trainer.attach_guard(guard)
    faults.arm('step.dispatch', 'nan', window=(3, 4))
    loss_fn = gluon.loss.L2Loss()
    ws = []
    for _ in range(6):
        with mx.autograd.record():
            loss = loss_fn(net(x), y)
        loss.backward()
        trainer.step(64)
        ws.append(net.weight.data().asnumpy().copy())
    assert onp.array_equal(ws[1], ws[2]) and onp.array_equal(ws[2], ws[3])
    assert not onp.array_equal(ws[4], ws[5])
    assert guard.bad_steps == 2
    assert set(trainer.optimizer._index_update_count.values()) == {4}
    assert len(trainer._fused[1]) == 1           # one captured graph
