"""The port's Transformer (``mxnet_tpu_torch/models/transformer.py``)
against the JAX package's, on the CPU in f32, and the port's twins of
``tests/test_transformer.py``.

One JAX ``TransformerModel`` (vocab 50, hidden 64, 2 encoder and 2
decoder layers, 4 heads, FFN 128, max_len 64, dropout 0) is initialised
Xavier; its arrays, the two positional tables (Constants) among them,
cross to the port's model by structured name. Both take the same source
(B = 3, Ts = 12, a boolean key mask from valid lengths 12, 7 and 5) and
target (Tt = 9) tokens: the cross-attention has Tq != Tk under the key
mask. JAX's ``multi_head_attention`` takes its XLA route here, the
port's its plain route.

Bounds: logits within 1e-5 (relative Frobenius error), the loss within
1e-5 relative, every gradient and every parameter after one SGD-momentum
step of ``gluon.Trainer`` within rtol 1e-4 with atol 1e-7. The absolute
part is for the k_proj biases: softmax ignores a shift shared by every
key of a row, so their gradient is zero in exact arithmetic, and what
either package computes for it is f32 rounding noise.
"""
import numpy as onp
import pytest
import torch

import mxnet_tpu as mj
from mxnet_tpu import autograd as jautograd
from mxnet_tpu import gluon as jgluon
from mxnet_tpu import nd as jnd
from mxnet_tpu.models import transformer as jtr
from mxnet_tpu.models.bert import masked_cross_entropy as j_ce
import mxnet_tpu_torch as mt
from mxnet_tpu_torch import gluon, parallel
from mxnet_tpu_torch.models import transformer as ttr
from mxnet_tpu_torch.models.bert import masked_cross_entropy
from mxnet_tpu_torch.weights import params_from_mxnet_tpu

CFG = dict(hidden=64, enc_layers=2, dec_layers=2, heads=4, ffn_hidden=128,
           max_len=64, dropout=0.0)
VOCAB, B, TS, TT = 50, 3, 12, 9
VALID = [12, 7, 5]
OUT_RTOL, RTOL, ATOL = 1e-5, 1e-4, 1e-7
SGD = ('sgd', {'learning_rate': 0.1, 'momentum': 0.9})


@pytest.fixture(autouse=True, scope='module')
def _jax_name_counters():
    """The JAX package's global block-name counters as this file found
    them, put back after it (``tests/test_zero3.py`` and
    ``test_zero1.py`` pair parameters by sorted prefixed names)."""
    from mxnet_tpu.gluon.block import _BlockScope
    saved = dict(_BlockScope._global_counter)
    yield
    _BlockScope._global_counter.clear()
    _BlockScope._global_counter.update(saved)


@pytest.fixture(autouse=True)
def _port_on_cpu():
    with mt.cpu():
        yield


def rel_fro(got, want):
    g, w = onp.asarray(got, onp.float64), onp.asarray(want, onp.float64)
    return onp.linalg.norm(g - w) / max(onp.linalg.norm(w), 1e-30)


@pytest.fixture(scope='module')
def jax_model():
    mj.random.seed(0)
    net = jtr.TransformerModel(VOCAB, VOCAB, **CFG)
    net.initialize(mj.init.Xavier())
    arrays = {k: v.data().asnumpy()
              for k, v in net._collect_params_with_prefix().items()}
    return net, arrays


def _reset_jax(net, arrays):
    for k, p in net._collect_params_with_prefix().items():
        p.set_data(jnd.array(arrays[k]))
        if p.grad_req != 'null':
            p.zero_grad()


def _port(arrays):
    net = ttr.TransformerModel(VOCAB, VOCAB, **CFG, device='cpu')
    net.load_state_dict(params_from_mxnet_tpu(arrays, net))
    return net


def _batch(seed=0):
    rng = onp.random.RandomState(seed)
    src = rng.randint(0, VOCAB, (B, TS)).astype('int32')
    tgt = rng.randint(0, VOCAB, (B, TT)).astype('int32')
    labels = rng.randint(0, VOCAB, (B, TT)).astype('int32')
    labels[rng.rand(B, TT) < 0.2] = -1
    mask = onp.arange(TS)[None, None, None, :] < \
        onp.asarray(VALID)[:, None, None, None]
    return src, tgt, mask, labels


def _jax_mask(mask):
    return jnd.array(mask, dtype='bool')


def test_names_shapes_and_the_constant_cross(jax_model):
    _, arrays = jax_model
    net = _port(arrays)
    assert {k: tuple(p.shape) for k, p in net.named_parameters()} == \
        {k: v.shape for k, v in arrays.items()}
    for name in ('encoder.pos.pe', 'tgt_pos.pe'):
        p = dict(net.named_parameters())[name]
        assert not p.requires_grad
        onp.testing.assert_array_equal(p.detach().numpy(), arrays[name])


def test_forward_matches_jax(jax_model):
    jnet, arrays = jax_model
    _reset_jax(jnet, arrays)
    src, tgt, mask, _ = _batch()
    want = jnet(jnd.array(src), jnd.array(tgt), _jax_mask(mask)).asnumpy()
    net = _port(arrays).eval()
    with torch.no_grad():
        got = net(*(torch.from_numpy(a) for a in (src, tgt, mask)))
    assert got.shape == (B, TT, VOCAB)
    assert rel_fro(got.numpy(), want) <= OUT_RTOL
    # the key mask acts: without it the logits move
    with torch.no_grad():
        free = net(torch.from_numpy(src), torch.from_numpy(tgt))
    assert rel_fro(free.numpy(), want) > 1e-3


def test_one_trainer_step_matches_jax(jax_model):
    """The key mask as an additive float (0 keeps, -1e30 drops): under
    JAX's ``autograd.record`` a boolean mask input fails (its float0
    cotangent), so the training case takes the other mask form both
    packages accept."""
    jnet, arrays = jax_model
    _reset_jax(jnet, arrays)
    src, tgt, mask, labels = _batch(seed=1)
    mask = onp.where(mask, 0.0, -1e30).astype(onp.float32)
    jtrainer = jgluon.Trainer(jnet.collect_params(), *SGD)
    with jautograd.record():
        jloss = j_ce(jnet(jnd.array(src), jnd.array(tgt), jnd.array(mask)),
                     jnd.array(labels))
    jloss.backward()
    jparams = jnet._collect_params_with_prefix()
    jgrads = {k: p.grad().asnumpy() for k, p in jparams.items()
              if p.grad_req != 'null'}
    jtrainer.step(1)

    net = _port(arrays).train()
    trainer = gluon.Trainer(net.collect_params(), *SGD)
    loss = masked_cross_entropy(
        net(*(torch.from_numpy(a) for a in (src, tgt, mask))),
        torch.from_numpy(labels))
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(jloss.asnumpy()),
                                                 rel=OUT_RTOL)
    named = dict(net.named_parameters())
    assert set(jgrads) == {n for n, p in named.items() if p.requires_grad}
    for name, g in jgrads.items():
        onp.testing.assert_allclose(named[name].grad.numpy(), g, rtol=RTOL,
                                    atol=ATOL, err_msg=name)
    trainer.step(1)
    for name, p in named.items():
        onp.testing.assert_allclose(p.detach().numpy(),
                                    jparams[name].data().asnumpy(),
                                    rtol=RTOL, atol=ATOL, err_msg=name)


def test_positional_constant_takes_no_gradient(jax_model):
    _, arrays = jax_model
    net = _port(arrays).train()
    trainer = gluon.Trainer(net.collect_params(), *SGD)
    src, tgt, mask, labels = _batch(seed=2)
    loss = masked_cross_entropy(
        net(*(torch.from_numpy(a) for a in (src, tgt, mask))),
        torch.from_numpy(labels))
    loss.backward()
    trainer.step(1)
    for name, pos in (('encoder.pos.pe', net.encoder.pos),
                      ('tgt_pos.pe', net.tgt_pos)):
        assert pos.pe.grad_req == 'null'
        assert pos.pe.tensor.grad is None
        onp.testing.assert_array_equal(pos.pe.tensor.detach().numpy(),
                                       arrays[name])
    assert 'encoder.pos.pe' not in {n for n, p in net.named_parameters()
                                    if p.requires_grad}


def _tiny(vocab=32):
    return ttr.TransformerModel(vocab, vocab, hidden=32, enc_layers=1,
                                dec_layers=1, heads=2, ffn_hidden=64,
                                max_len=64, dropout=0.0)


def test_transformer_shapes():
    net = _tiny()
    net.initialize(mt.init.Xavier())
    src = mt.nd.array(onp.random.RandomState(0).randint(0, 32, (2, 10))
                      .astype('int32'), dtype='int32')
    tgt = mt.nd.array(onp.random.RandomState(1).randint(0, 32, (2, 7))
                      .astype('int32'), dtype='int32')
    out = net(src, tgt)
    assert out.shape == (2, 7, 32)


def test_decoder_is_causal():
    """Changing a future decoder-input token must not change earlier
    positions' logits (the decoder self-attention is causal)."""
    net = _tiny()
    net.initialize(mt.init.Xavier())
    rng = onp.random.RandomState(0)
    src = mt.nd.array(rng.randint(0, 32, (1, 8)).astype('int32'),
                      dtype='int32')
    tgt = rng.randint(0, 32, (1, 6)).astype('int32')
    out1 = net(src, mt.nd.array(tgt, dtype='int32')).asnumpy()
    tgt2 = tgt.copy()
    tgt2[0, 4] = (tgt2[0, 4] + 1) % 32     # perturb position 4
    out2 = net(src, mt.nd.array(tgt2, dtype='int32')).asnumpy()
    onp.testing.assert_allclose(out1[0, :4], out2[0, :4],
                                rtol=1e-5, atol=1e-6)
    assert onp.abs(out1[0, 4:] - out2[0, 4:]).max() > 1e-4


def test_encoder_mask_drops_padding():
    net = ttr.TransformerEncoder(32, hidden=32, layers=1, heads=2,
                                 ffn_hidden=64, max_len=64, dropout=0.0)
    net.initialize(mt.init.Xavier())
    rng = onp.random.RandomState(0)
    src = rng.randint(0, 32, (2, 8)).astype('int32')
    vlen = onp.asarray([5, 8])
    mask = onp.arange(8)[None, None, None, :] < vlen[:, None, None, None]
    out_m = net(mt.nd.array(src, dtype='int32'),
                mt.nd.array(mask, dtype='bool')).asnumpy()
    # perturb a PADDED source token for row 0: masked output unchanged
    src2 = src.copy()
    src2[0, 6] = (src2[0, 6] + 3) % 32
    out_m2 = net(mt.nd.array(src2, dtype='int32'),
                 mt.nd.array(mask, dtype='bool')).asnumpy()
    onp.testing.assert_allclose(out_m[0, :5], out_m2[0, :5],
                                rtol=1e-5, atol=1e-6)


def test_transformer_training_reduces_loss():
    net = _tiny(vocab=16)
    net.initialize(mt.init.Xavier())
    mesh = parallel.make_mesh((1,), ('dp',), devices=['cpu'])
    step = parallel.ShardedTrainStep(net, masked_cross_entropy, 'adam',
                                     {'learning_rate': 1e-3}, mesh=mesh)
    rng = onp.random.RandomState(0)
    src = rng.randint(4, 16, (8, 6)).astype('int32')
    tgt_out = src[:, ::-1].copy()
    tgt_in = onp.concatenate(
        [onp.ones((8, 1), onp.int32), tgt_out[:, :-1]], axis=1)
    losses = []
    for _ in range(12):
        losses.append(float(step([torch.from_numpy(src),
                                  torch.from_numpy(tgt_in)],
                                 [torch.from_numpy(tgt_out)])))
    assert onp.isfinite(losses).all()
    assert losses[-1] < losses[0], losses
