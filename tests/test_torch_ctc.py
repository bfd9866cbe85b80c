"""The port's CTC loss (``nd.ctc_loss``, ``gluon.loss.CTCLoss``) against
the JAX package's and against ``torch.nn.functional.ctc_loss``, on the CPU
in f32.

The port pads labels as MXNet documents: with ``blank_label='first'`` a
label counts when it is > 0, with ``'last'`` when it is >= 0 and not the
blank, so -1 pads in both modes and label 0 is a class under 'last'. The
JAX op swaps the two rules (``mxnet_tpu/ops/nn.py:478-483``: >= 0 under
'first', > 0 under 'last'), so ``gluon.loss.CTCLoss``, which passes
'last', drops every label 0 there. The port deliberately does not copy
that (ROADMAP queue 3).

- Where the two rules agree (no label 0, no label equal to the blank,
  -1 padding; the reference's own test case among them) the loss is held
  to the JAX op's within atol 1e-5 and its gradient with respect to the
  logits to ``jax.grad``'s within rel Frobenius 1e-4, in both blank modes,
  with and without data and label lengths.
- Where they differ (label 0 under 'last'; 0-padding under 'first') the
  port is held to ``torch.nn.functional.ctc_loss`` (atol 1e-5), which is
  used here only, and the JAX op is shown to differ.
- ``CTCLoss`` in the layouts NTC/TNC and NT/TN, with lengths and a
  ``sample_weight``, against JAX's layer on agreeing inputs.
"""
import jax
import jax.numpy as jnp
import numpy as onp
import pytest
import torch
import torch.nn.functional as F

import mxnet_tpu as mj
import mxnet_tpu_torch as mt
from mxnet_tpu.ops import nn as jnn
from mxnet_tpu_torch.ops import nn as tnn
from test_torch_jax_globals import jax_globals  # noqa: F401

ATOL = 1e-5
GRAD_TOL = 1e-4


@pytest.fixture(autouse=True)
def _port_on_cpu():
    with mt.cpu():
        yield


def rel_fro(got, want):
    g, w = onp.asarray(got, onp.float64), onp.asarray(want, onp.float64)
    return onp.linalg.norm(g - w) / max(onp.linalg.norm(w), 1e-30)


def _agreeing_labels(rng, N, L, C, lens):
    """Labels in 1..C-2 (neither blank in either mode, never 0), -1
    after each row's length."""
    lab = onp.full((N, L), -1, onp.float32)
    for i, n in enumerate(lens):
        lab[i, :n] = rng.randint(1, C - 1, n)
    return lab


CASES = [(blank, lengths) for blank in ('first', 'last')
         for lengths in (None, 'data', 'label', 'both')]


@pytest.mark.parametrize('blank,lengths', CASES)
def test_ctc_loss_matches_jax_where_the_padding_rules_agree(blank, lengths):
    T, N, C, L = 12, 4, 6, 5
    rng = onp.random.RandomState(1)
    x = rng.randn(T, N, C).astype(onp.float32)
    lab_lens = onp.array([5, 3, 1, 4], onp.float32)
    lab = _agreeing_labels(rng, N, L, C, lab_lens.astype(int))
    dlen = onp.array([12, 9, 7, 10], onp.float32)
    use_d = lengths in ('data', 'both')
    use_l = lengths in ('label', 'both')
    kw = dict(use_data_lengths=use_d, use_label_lengths=use_l,
              blank_label=blank)
    w = rng.rand(N).astype(onp.float32)

    def jloss(xj):
        out = jnn.ctc_loss(xj, jnp.asarray(lab), jnp.asarray(dlen),
                           jnp.asarray(lab_lens), **kw)
        return jnp.sum(out * w), out
    (_, jout), jg = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    tout = tnn.ctc_loss(xt, torch.tensor(lab), torch.tensor(dlen),
                        torch.tensor(lab_lens), **kw)
    onp.testing.assert_allclose(tout.detach().numpy(), onp.asarray(jout),
                                rtol=0, atol=ATOL)
    (tout * torch.from_numpy(w)).sum().backward()
    assert rel_fro(xt.grad.numpy(), jg) <= GRAD_TOL


def test_the_reference_test_case_matches_jax_and_torch():
    """tests/test_operator.py's case: T = 6, N = 2, C = 5, blank 'first'."""
    T, N, C = 6, 2, 5
    x = onp.random.RandomState(0).randn(T, N, C).astype(onp.float32)
    lab = onp.array([[1, 2, -1, -1], [3, -1, -1, -1]], onp.float32)
    got = mt.nd.ctc_loss(mt.nd.array(x), mt.nd.array(lab)).asnumpy()
    onp.testing.assert_allclose(
        got, mj.nd.ctc_loss(mj.nd.array(x), mj.nd.array(lab)).asnumpy(),
        rtol=0, atol=ATOL)
    ref = F.ctc_loss(torch.tensor(x).log_softmax(-1),
                     torch.tensor([[1, 2], [3, 0]]), torch.tensor([T, T]),
                     torch.tensor([2, 1]), blank=0, reduction='none')
    onp.testing.assert_allclose(got, ref.numpy(), rtol=0, atol=ATOL)


def _torch_ctc(x, targets, target_lens, blank):
    T, N, _ = x.shape
    return F.ctc_loss(torch.tensor(x).log_softmax(-1),
                      torch.tensor(targets), torch.full((N,), T),
                      torch.tensor(target_lens), blank=blank,
                      reduction='none').numpy()


def test_label_zero_is_a_class_under_blank_last():
    """MXNet: with 'last', -1 pads and 0 is a real class. The port
    matches torch's CTC with blank C - 1; the JAX op drops the 0s."""
    T, N, C = 6, 2, 5
    x = onp.random.RandomState(0).randn(T, N, C).astype(onp.float32)
    lab = onp.array([[0, 2, -1, -1], [3, 0, 1, -1]], onp.float32)
    got = mt.nd.ctc_loss(mt.nd.array(x), mt.nd.array(lab),
                         blank_label='last').asnumpy()
    want = _torch_ctc(x, [[0, 2, 0], [3, 0, 1]], [2, 3], blank=C - 1)
    onp.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    jax_out = mj.nd.ctc_loss(mj.nd.array(x), mj.nd.array(lab),
                             blank_label='last').asnumpy()
    assert onp.abs(jax_out - want).min() > 0.01, (jax_out, want)


def test_zero_pads_under_blank_first():
    """MXNet: with 'first', 0 is the blank and pads. The port matches
    torch's CTC with blank 0; the JAX op counts the 0s as labels."""
    T, N, C = 8, 2, 5
    x = onp.random.RandomState(2).randn(T, N, C).astype(onp.float32)
    lab = onp.array([[1, 2, 0, 0], [3, 0, 0, 0]], onp.float32)
    got = mt.nd.ctc_loss(mt.nd.array(x), mt.nd.array(lab)).asnumpy()
    want = _torch_ctc(x, [[1, 2], [3, 1]], [2, 1], blank=0)
    onp.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    jax_out = mj.nd.ctc_loss(mj.nd.array(x), mj.nd.array(lab)).asnumpy()
    assert onp.abs(jax_out - want).min() > 0.01, (jax_out, want)


def test_label_lengths_and_data_lengths_against_torch():
    """Ragged data lengths and explicit label lengths, label 0 under
    'last', against torch's CTC on each row's own length."""
    T, N, C = 10, 3, 7
    rng = onp.random.RandomState(5)
    x = rng.randn(T, N, C).astype(onp.float32)
    lab = onp.array([[0, 3, 3, -1], [5, 0, 2, 1], [4, -1, -1, -1]],
                    onp.float32)
    lab_lens = onp.array([3, 4, 1], onp.float32)
    dlen = onp.array([10, 8, 5], onp.float32)
    got = tnn.ctc_loss(torch.tensor(x), torch.tensor(lab),
                       torch.tensor(dlen), torch.tensor(lab_lens),
                       use_data_lengths=True, use_label_lengths=True,
                       blank_label='last').numpy()
    want = F.ctc_loss(torch.tensor(x).log_softmax(-1),
                      torch.tensor(onp.maximum(lab, 0).astype(onp.int64)),
                      torch.tensor(dlen.astype(onp.int64)),
                      torch.tensor(lab_lens.astype(onp.int64)),
                      blank=C - 1, reduction='none').numpy()
    onp.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


LAYOUTS = [(l, ll) for l in ('NTC', 'TNC') for ll in ('NT', 'TN')]


@pytest.mark.parametrize('layout,label_layout', LAYOUTS)
@pytest.mark.parametrize('with_lengths', [False, True])
def test_ctcloss_layer_matches_jax(layout, label_layout, with_lengths):
    T, N, C, L = 10, 3, 6, 4
    rng = onp.random.RandomState(8)
    x = rng.randn(T, N, C).astype(onp.float32)
    lab_lens = onp.array([4, 2, 3], onp.float32)
    lab = _agreeing_labels(rng, N, L, C, lab_lens.astype(int))
    dlen = onp.array([10, 7, 9], onp.float32)
    sw = rng.rand(N).astype(onp.float32)
    pred = x if layout == 'TNC' else x.transpose(1, 0, 2)
    label = lab if label_layout == 'NT' else lab.T
    outs, grads = [], []
    for pkg in (mj, mt):
        loss_fn = pkg.gluon.loss.CTCLoss(layout, label_layout)
        p = pkg.nd.array(pred)
        p.attach_grad()
        args = [p, pkg.nd.array(label)]
        if with_lengths:
            args += [pkg.nd.array(dlen), pkg.nd.array(lab_lens)]
        else:
            args += [None, None]
        with pkg.autograd.record():
            out = loss_fn(*args, pkg.nd.array(sw))
        out.backward()
        outs.append(out.asnumpy())
        grads.append(p.grad.asnumpy())
    assert outs[1].shape == (N,)
    onp.testing.assert_allclose(outs[1], outs[0], rtol=0, atol=ATOL)
    assert rel_fro(grads[1], grads[0]) <= GRAD_TOL


def test_ctcloss_layer_counts_label_zero():
    """The layer passes 'last': a label 0 is a class (torch's CTC with
    blank C - 1), the sample weight scales each row."""
    T, N, C = 6, 2, 5
    x = onp.random.RandomState(0).randn(N, T, C).astype(onp.float32)
    lab = onp.array([[0, 2, -1, -1], [3, 0, 1, -1]], onp.float32)
    sw = onp.array([0.5, 2.0], onp.float32)
    got = mt.gluon.loss.CTCLoss()(mt.nd.array(x), mt.nd.array(lab), None,
                                  None, mt.nd.array(sw)).asnumpy()
    want = _torch_ctc(x.transpose(1, 0, 2), [[0, 2, 0], [3, 0, 1]], [2, 3],
                      blank=C - 1) * sw
    onp.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
