"""The port's BERT pretraining step against the JAX package's.

One JAX ``BertForPretraining`` (vocab 512, hidden 128, 2 layers, 2 heads,
FFN 512, max_len 64, dropout 0) is initialised Normal(0.02); its arrays
cross to the port's model by structured name (``params_from_mxnet_tpu``).
Both packages then take the same batch (B=4, T=32, valid_length, 8 masked
positions per row with some -1 labels, NSP labels, token types) through
``bert_pretrain_loss``, the JAX ``autograd.record()``/``backward()`` on
one side and ``torch.autograd`` on the other, and AdamW steps through
their ``gluon.Trainer``s. Everything runs on the CPU in f32.
"""
import numpy as onp
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import autograd as jautograd
from mxnet_tpu import gluon as jgluon
from mxnet_tpu import nd
from mxnet_tpu.models.bert import BertForPretraining as JBertPT
from mxnet_tpu.models.bert import bert_pretrain_loss as j_loss
from mxnet_tpu_torch import gluon
from mxnet_tpu_torch.models.bert import BertForPretraining, bert_pretrain_loss
from mxnet_tpu_torch.weights import load_parameters, params_from_mxnet_tpu
from test_torch_jax_globals import jax_globals  # noqa: F401


CFG = dict(vocab_size=512, hidden=128, layers=2, heads=2, intermediate=512,
           max_len=64, type_vocab=2, dropout=0.0)
B, T, M = 4, 32, 8
RTOL, ATOL = 1e-4, 1e-5
OPT = ('adamw', {'learning_rate': 1e-3, 'wd': 0.01})


@pytest.fixture(scope='module')
def jax_model():
    mx.random.seed(0)
    net = JBertPT(CFG)
    net.initialize(mx.init.Normal(0.02))
    net(nd.array(onp.zeros((1, 8), 'int32')))
    arrays = {k: v.data().asnumpy()
              for k, v in net._collect_params_with_prefix().items()}
    return net, arrays


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
    return tokens, types, valid, mpos, labels, nsp


def _reset_jax(net, arrays):
    """The initial weights, and zero gradient buffers: a parameter that the
    loss does not reach keeps whatever its buffer held, so a buffer left
    by an earlier test would leak into this one."""
    for k, p in net._collect_params_with_prefix().items():
        p.set_data(nd.array(arrays[k]))
        p.zero_grad()


def _port_model(arrays):
    net = BertForPretraining(CFG, device='cpu').train()
    net.load_state_dict(params_from_mxnet_tpu(arrays, net))
    return net


def _jax_step(net, batch, with_types=True):
    tokens, types, valid, mpos, labels, nsp = (nd.array(a) for a in batch)
    with jautograd.record():
        mlm, ns = net(tokens, types if with_types else None, valid, mpos)
        loss = j_loss(mlm, ns, labels, nsp)
    loss.backward()
    return float(loss.asnumpy())


def _port_step(net, batch, with_types=True):
    tokens, types, valid, mpos, labels, nsp = (torch.from_numpy(a)
                                               for a in batch)
    mlm, ns = net(tokens, types if with_types else None, valid, mpos)
    loss = bert_pretrain_loss(mlm, ns, labels, nsp)
    loss.backward()
    return float(loss.detach())


def test_loss_and_gradients_match_jax(jax_model):
    jnet, arrays = jax_model
    _reset_jax(jnet, arrays)
    batch = _batch()
    j = _jax_step(jnet, batch)
    net = _port_model(arrays)
    t = _port_step(net, batch)
    assert t == pytest.approx(j, rel=RTOL)
    jgrads = {k: p.grad().asnumpy()
              for k, p in jnet._collect_params_with_prefix().items()}
    tgrads = dict(net.named_parameters())
    assert set(jgrads) == set(tgrads)
    for name, p in tgrads.items():
        onp.testing.assert_allclose(p.grad.numpy(), jgrads[name], rtol=RTOL,
                                    atol=ATOL, err_msg=name)


def _train_both(jnet, arrays, with_types, steps=3, batch_seed=10):
    """Both Trainers over the same batches. Returns the port's model.

    The loss of every step is held at the bound, and so is every parameter
    element after the last step whose gradient the two packages agree on
    to 0.1% at every step. The others are elements whose gradient is close
    to f32 rounding noise: the key third of each qkv bias, whose gradient
    is zero in exact arithmetic (a constant added to every key of a row
    shifts all its scores alike, which softmax ignores), and elements that
    cancel to near zero, such as some embedding entries behind the
    LayerNorm's backward. AdamW divides by the root of the second moment,
    so it turns that noise into steps of up to lr in either direction,
    which two correct implementations need not share: those elements must
    stay few (< 2% of all) and within the 2 * lr * steps AdamW can move
    them."""
    _reset_jax(jnet, arrays)
    jparams = jnet._collect_params_with_prefix()
    jtrainer = jgluon.Trainer(jnet.collect_params(), *OPT)
    net = _port_model(arrays)
    trainer = gluon.Trainer(gluon.collect_params(net), *OPT)
    noisy = {}
    for i in range(steps):
        batch = _batch(seed=batch_seed + i)
        jl = _jax_step(jnet, batch, with_types)
        tl = _port_step(net, batch, with_types)
        assert tl == pytest.approx(jl, rel=RTOL)
        for name, p in net.named_parameters():
            tg = p.grad.numpy() if p.grad is not None else 0.0
            jg = jparams[name].grad().asnumpy()
            noisy[name] = noisy.get(name, False) | \
                (onp.abs(tg - jg) > 1e-3 * onp.abs(jg))
        jtrainer.step(1)
        trainer.step(1)
        net.zero_grad(set_to_none=False)
    n_noisy = n_all = 0
    for name, p in net.named_parameters():
        got, want = p.detach().numpy(), jparams[name].data().asnumpy()
        ok = ~noisy[name]
        onp.testing.assert_allclose(got[ok], want[ok], rtol=RTOL, atol=ATOL,
                                    err_msg=name)
        assert onp.abs(got - want).max() <= \
            2 * OPT[1]['learning_rate'] * steps, name
        n_noisy += int(noisy[name].sum())
        n_all += got.size
    assert n_noisy < 0.02 * n_all, (n_noisy, n_all)
    return net


def test_three_adamw_steps_match_the_jax_trainer(jax_model):
    jnet, arrays = jax_model
    _train_both(jnet, arrays, with_types=True)


def test_unused_type_embedding_decays_as_in_jax(jax_model):
    """Without token types, type_embed.weight takes no part in the loss:
    its torch .grad stays None. The JAX Trainer updates it with a zero
    gradient, so AdamW's decoupled weight decay shrinks it by (1 - lr*wd)
    every step; the port's Trainer does the same."""
    jnet, arrays = jax_model
    net = _train_both(jnet, arrays, with_types=False)
    p = net.bert.type_embed.weight
    assert p.grad is None
    lr, wd = OPT[1]['learning_rate'], OPT[1]['wd']
    want = arrays['bert.type_embed.weight'] * onp.float32(1 - lr * wd) ** 3
    onp.testing.assert_allclose(p.detach().numpy(), want, rtol=1e-6)


def test_collect_params_gives_structured_names_and_multipliers(jax_model):
    _, arrays = jax_model
    params = gluon.collect_params(_port_model(arrays))
    assert list(params) == list(arrays)
    assert {(p.lr_mult, p.wd_mult) for p in params.values()} == {(1.0, 1.0)}


def test_pretraining_weights_cross_one_to_one(jax_model, tmp_path):
    """A JAX BertForPretraining (``bert.`` prefix and the heads) loads into
    the port by name, from its arrays and through a ``.params`` file that
    ``mxnet_tpu`` writes, and both give the same MLM and NSP logits."""
    jnet, arrays = jax_model
    _reset_jax(jnet, arrays)
    path = str(tmp_path / 'bert_pt.params')
    jnet.save_parameters(path)
    from_file = load_parameters(BertForPretraining(CFG, device='cpu'), path)
    from_arrays = _port_model(arrays)
    for name, p in from_file.named_parameters():
        onp.testing.assert_array_equal(p.detach().numpy(), arrays[name])
    tokens, types, valid, mpos, _, _ = _batch(seed=5)
    jmlm, jnsp = jnet(*(nd.array(a) for a in (tokens, types, valid, mpos)))
    for net in (from_file.eval(), from_arrays.eval()):
        with torch.inference_mode():
            mlm, nsp = net(*(torch.from_numpy(a)
                             for a in (tokens, types, valid, mpos)))
        assert mlm.shape == (B, M, CFG['vocab_size'])
        onp.testing.assert_allclose(mlm.numpy(), jmlm.asnumpy(), rtol=RTOL,
                                    atol=ATOL)
        onp.testing.assert_allclose(nsp.numpy(), jnsp.asnumpy(), rtol=RTOL,
                                    atol=ATOL)
