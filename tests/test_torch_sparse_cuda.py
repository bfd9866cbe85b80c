"""The RowSparse path on the card, at small sizes: the sparse step
captured as one CUDA graph and replayed, no device assert where the
sentinel slots meet a live row vocab - 1, the dedup's table gradient
bitwise equal across 3 runs, exact mode bitwise against the dense path,
and the lazy step against the same step on the CPU.

These tests need a CUDA device and carry the ``cuda`` marker; without a
card they skip. On the card, from the root of the checkout (the file
imports only torch, numpy and the port, so the JAX conftest is left out):

    python -m pytest --noconftest -m cuda tests/test_torch_sparse_cuda.py

Losses within rel 1e-5 and parameters and moments within rel Frobenius
1e-4 of the CPU (f32, TF32 off); the bitwise checks exact.
"""
import numpy as onp
import pytest
import torch

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.gluon import nn
from mxnet_tpu_torch.ops import rowsparse as rs
from mxnet_tpu_torch.parallel import ShardedTrainStep

pytestmark = pytest.mark.cuda


@pytest.fixture(autouse=True)
def card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield


@pytest.fixture
def env(monkeypatch):
    def set_(sparse=True, exact=False):
        monkeypatch.setenv('MXTPU_SPARSE', '1' if sparse else '0')
        monkeypatch.setenv('MXTPU_SPARSE_EXACT', '1' if exact else '0')
    return set_


def _net(ctx, vocab=500, dim=8, seed=3):
    with ctx:
        net = nn.HybridSequential()
        net.add(nn.Embedding(vocab, dim, sparse_grad=True))
        net.add(nn.Dense(4, flatten=False, in_units=dim))
        net.initialize()
    rng = onp.random.RandomState(seed)
    with torch.no_grad():
        for _, p in sorted(net.named_parameters()):
            p.copy_(torch.from_numpy(rng.standard_normal(
                tuple(p.shape)).astype(onp.float32) * 0.1))
    return net


def _batch(vocab=500, seed=0, shape=(16, 5)):
    rng = onp.random.RandomState(seed)
    ids = rng.randint(0, 40, shape).astype(onp.float32)
    ids[0, :2] = vocab - 1          # the last row live
    lab = rng.standard_normal(shape + (4,)).astype(onp.float32)
    return ids, lab


def _steps(device, steps=3, exact=False, **kw):
    ctx = mx.gpu(0) if device == 'cuda' else mx.cpu()
    net = _net(ctx, **kw)
    step = ShardedTrainStep(net, lambda o, y: (o - y) ** 2, 'adam',
                            {'learning_rate': 0.01})
    ids, lab = _batch()
    x, y = torch.from_numpy(ids).to(device), torch.from_numpy(lab).to(device)
    losses = [float(step(x, y)) for _ in range(steps)]
    return net, step, losses


def _rel(a, b):
    a, b = a.detach().double().cpu(), b.detach().double().cpu()
    return float(torch.linalg.norm(a - b) /
                 torch.linalg.norm(b).clamp_min(1e-30))


def test_sparse_step_is_one_captured_graph_matching_the_cpu(env):
    env()
    gnet, gstep, gl = _steps('cuda')
    cnet, cstep, cl = _steps('cpu')
    assert gstep._sparse_names == ['0.weight'] and len(gstep._graphs) == 1
    onp.testing.assert_allclose(gl, cl, rtol=1e-5)
    cp = dict(cnet.named_parameters())
    for n, p in gnet.named_parameters():
        assert _rel(p, cp[n]) < 1e-4, n
        for a, b in zip(gstep._state[n], cstep._state[n]):
            assert _rel(a, b) < 1e-4, n
    # untouched rows keep zero moments; the replays do not sync the host
    ids, _ = _batch()
    free = onp.setdiff1d(onp.arange(500), ids.astype(int))
    for s in gstep._state['0.weight']:
        assert bool((s[torch.from_numpy(free).cuda()] == 0).all())
    x, y = (torch.from_numpy(a).cuda() for a in _batch())
    torch.cuda.set_sync_debug_mode('error')
    try:
        for _ in range(3):
            gstep(x, y)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


def test_sentinel_meets_the_last_live_row_without_a_device_assert(env):
    env()
    vocab = 50
    ids = torch.tensor([49, 3, 49, 3, 49, 0, 49, 0, 3, 3], device='cuda')
    uids, inv, n_live = rs.unique_rows(ids, 10, vocab)
    torch.cuda.synchronize()
    assert int(n_live) == 3
    assert uids.tolist() == [0, 3, 49] + [vocab] * 7
    ws = rs.write_slots(n_live, 10)
    assert ws.tolist() == [0, 1, 2] + [2] * 7
    t = torch.zeros(vocab, 2, device='cuda')
    t.index_copy_(0, uids.index_select(0, ws),
                  torch.arange(20., device='cuda').reshape(10, 2)
                  .index_select(0, ws))
    g = rs.densify_rows(uids, torch.ones(10, 2, device='cuda'), vocab)
    torch.cuda.synchronize()
    assert t[49].tolist() == [4.0, 5.0]
    # the live rows land; the sentinel slots' rows go to the spare row
    assert g.sum().item() == 6.0
    assert g[[0, 3, 49]].tolist() == [[1.0, 1.0]] * 3


def test_dedup_gradient_bitwise_3x_and_under_permutation():
    rng = onp.random.RandomState(0)
    w0 = torch.from_numpy(rng.standard_normal((300, 8)).astype(
        onp.float32)).cuda()
    base = rng.randint(0, 300, 4096)
    grads = []
    for perm in (None, 0, 1, None, 2):
        ids = base if perm is None else \
            onp.random.RandomState(perm).permutation(base)
        w = w0.clone().requires_grad_()
        out = rs.dedup_take(w, torch.from_numpy(ids).cuda())
        (out * out).sum().backward()
        grads.append(w.grad)
    assert all(torch.equal(grads[0], g) for g in grads[1:])
    ref = w0.clone().requires_grad_()
    (ref[torch.from_numpy(base).cuda()] ** 2).sum().backward()
    assert _rel(grads[0], ref.grad) < 1e-6


def test_exact_is_the_dense_path_bitwise_on_the_card(env):
    env(exact=True)
    snet, sstep, sl = _steps('cuda')
    env(sparse=False)
    dnet, dstep, dl = _steps('cuda')
    assert sstep._sparse_names and not dstep._sparse_names
    assert sl == dl
    dp = dict(dnet.named_parameters())
    for n, p in snet.named_parameters():
        assert torch.equal(p, dp[n]), n


def test_eager_trainer_lazy_on_the_card():
    grads = {}
    for dev, ctx in (('cuda', mx.gpu(0)), ('cpu', mx.cpu())):
        net = _net(ctx)
        w0 = net[0].weight.data().asnumpy()
        tr = mx.gluon.Trainer(net.collect_params(), 'sgd',
                              {'learning_rate': 0.1, 'momentum': 0.9})
        ids, lab = _batch()
        with ctx:
            x, y = mx.nd.array(ids), mx.nd.array(lab)
        for _ in range(2):
            with mx.autograd.record():
                loss = ((net(x) - y) ** 2).mean()
            loss.backward()
            tr.step(1)
        assert net[0].weight.grad().stype == 'row_sparse'
        grads[dev] = net[0].weight.data().asnumpy()
        absent = onp.setdiff1d(onp.arange(500), ids.astype(int))
        assert onp.array_equal(grads[dev][absent], w0[absent])
    onp.testing.assert_allclose(grads['cuda'], grads['cpu'], rtol=1e-5,
                                atol=1e-7)
