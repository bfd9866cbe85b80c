"""The sequence and detection ops on the card against their runs on the
CPU: ``rnn``, ``ctc_loss``, ``box_nms`` and ``multibox_target`` at small
sizes, f32 with TF32 off.

These tests need a CUDA device and carry the ``cuda`` marker; without a
card they skip. On the card, from the root of the checkout (the file
imports only torch, numpy and the port, so the JAX conftest is left out):

    python -m pytest --noconftest -m cuda tests/test_torch_seq_det_cuda.py

Values are held within rel 1e-5 (atol 1e-5 where they sit near 0) and
gradients within rel Frobenius 1e-4; NMS's kept rows and their order,
and multibox_target's class targets and masks, exactly.
"""
import numpy as onp
import pytest
import torch

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.ops import contrib, detection
from mxnet_tpu_torch.ops import nn as nn_ops

pytestmark = pytest.mark.cuda


@pytest.fixture(autouse=True)
def card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield


def rel_fro(got, want):
    g, w = got.detach().double().cpu(), want.detach().double().cpu()
    return float((g - w).norm() / w.norm().clamp_min(1e-30))


def _both(fn, *arrays, grad=(), **kw):
    """fn on the CPU and on the card from the same numpy arrays; the
    gradients of a fixed projection of the outputs with respect to the
    arrays whose positions are in ``grad``."""
    out = []
    for dev in ('cpu', 'cuda'):
        ts = [torch.tensor(a, device=dev, requires_grad=i in grad)
              for i, a in enumerate(arrays)]
        res = fn(*ts, **kw)
        res = res if isinstance(res, tuple) else (res,)
        if grad:
            g = torch.Generator().manual_seed(0)
            sum((r * torch.randn(r.shape, generator=g).to(dev)).sum()
                for r in res if r.is_floating_point()).backward()
        out.append((res, [ts[i].grad for i in grad]))
    return out


@pytest.mark.parametrize('mode', ['rnn_relu', 'rnn_tanh', 'lstm', 'gru'])
@pytest.mark.parametrize('bi', [False, True])
def test_rnn_op_on_the_card(mode, bi):
    T, N, I, H, L = 7, 4, 5, 8, 2
    D = 2 if bi else 1
    G = nn_ops._RNN_GATES[mode]
    n = sum(D * (G * H * (I if l == 0 else H * D) + G * H * H)
            for l in range(L)) + L * D * 2 * G * H
    rng = onp.random.RandomState(1)
    args = [rng.randn(T, N, I).astype(onp.float32),
            (rng.randn(n) * 0.3).astype(onp.float32),
            rng.randn(L * D, N, H).astype(onp.float32)]
    if mode == 'lstm':
        args.append(rng.randn(L * D, N, H).astype(onp.float32))

    def run(x, p, h, c=None):
        return nn_ops.rnn(x, p, h, c, state_size=H, num_layers=L, mode=mode,
                          bidirectional=bi)
    (cpu, gc), (gpu, gg) = _both(run, *args, grad=tuple(range(len(args))))
    for a, b in zip(gpu, cpu):
        assert a.is_cuda
        torch.testing.assert_close(a.cpu(), b, rtol=1e-5, atol=1e-5)
    for a, b in zip(gg, gc):
        assert rel_fro(a, b) <= 1e-4


def test_rnn_dropout_draws_on_the_card():
    x = torch.rand(1, 64, 32, device='cuda') + 0.5
    eye = torch.eye(32).reshape(-1)
    params = torch.cat([eye, torch.zeros(32 * 32), eye, torch.zeros(32 * 32),
                        torch.zeros(4 * 32)]).cuda()
    with mx.autograd.train_mode():
        out = nn_ops.rnn(x, params, torch.zeros(2, 64, 32, device='cuda'),
                         state_size=32, num_layers=2, mode='rnn_relu', p=0.5)
    dropped = float((out[0] == 0).float().mean())
    assert out[0].is_cuda and 0.4 < dropped < 0.6


@pytest.mark.parametrize('blank', ['first', 'last'])
def test_ctc_loss_on_the_card(blank):
    T, N, C = 30, 6, 8
    rng = onp.random.RandomState(2)
    x = rng.randn(T, N, C).astype(onp.float32)
    lab = onp.full((N, 5), -1, onp.float32)
    for i in range(N):
        n = 1 + i % 5
        lab[i, :n] = rng.randint(1 if blank == 'first' else 0, C - 1, n)
    dlen = onp.array([30, 25, 20, 30, 12, 28], onp.float32)
    (cpu, gc), (gpu, gg) = _both(
        lambda x, l, d: nn_ops.ctc_loss(x, l, d, use_data_lengths=True,
                                        blank_label=blank),
        x, lab, dlen, grad=(0,))
    torch.testing.assert_close(gpu[0].cpu(), cpu[0], rtol=1e-5, atol=1e-5)
    assert rel_fro(gg[0], gc[0]) <= 1e-4


def _det_rows(rng, B, N):
    xy = rng.rand(B, N, 2) * 0.8
    boxes = onp.concatenate([xy, xy + 0.05 + rng.rand(B, N, 2) * 0.3], -1)
    d = onp.concatenate([rng.randint(0, 4, (B, N, 1)), rng.rand(B, N, 1),
                         boxes], -1).astype(onp.float32)
    d[:, ::7, 1] = 0.5          # ties
    return d


@pytest.mark.parametrize('topk', [-1, 50])
@pytest.mark.parametrize('force', [False, True])
def test_box_nms_on_the_card(topk, force):
    d = _det_rows(onp.random.RandomState(3), 3, 300)
    (cpu, _), (gpu, _) = _both(contrib.box_nms, d, overlap_thresh=0.4,
                               topk=topk, id_index=0, force_suppress=force)
    got, want = gpu[0].cpu(), cpu[0]
    assert torch.equal(got[..., 1] >= 0, want[..., 1] >= 0)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize('ratio', [-1.0, 3.0])
def test_multibox_target_on_the_card(ratio):
    rng = onp.random.RandomState(4)
    A, B, M = 500, 4, 6
    xy = rng.rand(1, A, 2) * 0.8
    anchor = onp.concatenate([xy, xy + 0.05 + rng.rand(1, A, 2) * 0.2],
                             -1).astype(onp.float32)
    label = onp.full((B, M, 5), -1.0, onp.float32)
    for b in range(B):
        for m in range(1 + b):
            x0, y0 = rng.rand(2) * 0.6
            label[b, m] = [rng.randint(5), x0, y0, x0 + 0.2, y0 + 0.25]
    label[3, 4] = label[3, 1]        # two gt boxes share their best anchor
    label[3, 4, 0] = 4
    cls_pred = rng.randn(B, 6, A).astype(onp.float32)
    (cpu, _), (gpu, _) = _both(detection.multibox_target, anchor, label,
                               cls_pred, negative_mining_ratio=ratio)
    torch.testing.assert_close(gpu[0].cpu(), cpu[0], rtol=0, atol=1e-5)
    assert torch.equal(gpu[1].cpu(), cpu[1])
    assert torch.equal(gpu[2].cpu(), cpu[2])
