"""The port's GPT (``mxnet_tpu_torch/models/gpt.py``) against the JAX
package's, on the CPU in f32.

One JAX ``GPTModel`` (vocab 97, hidden 64, 2 layers, 4 heads, max_len 32,
dropout 0) is initialised Normal(0.02); its arrays cross to the port's
model by structured name (``params_from_mxnet_tpu``). Both packages then
take the same tokens (B = 2, T = 32; labels the tokens shifted left, -1
padding the last position). JAX's ``multi_head_attention`` takes its XLA
route here, the port's its plain route.

Bounds: logits and ``gpt_lm_loss`` within 1e-5 relative (the logits as
relative Frobenius error), gradients within 1e-4 (each tensor's relative
Frobenius error); one ``ShardedTrainStep`` AdamW step's loss within 1e-5
and its updated parameters within 1e-4. The step's AdamW divides by the
root of the second moment, so an element whose gradient is f32 rounding
noise (the key third of each qkv bias: softmax ignores a shift shared by
every key) would step by about lr in either direction; the step case sets
``eps`` to 1e-6, as ``tests/test_torch_sharded_step.py`` does, where
such noise moves an element by ~1e-3 lr and the real gradients keep their
normalised steps.

The tied head: the embedding's gradient is the lookup's plus the head's.
Rows of tokens the batch does not hold get the head's part only, so they
show that the head's part arrived; the whole gradient is held against
JAX's, in a plain backward and through the compiled step.
"""
import jax
import numpy as onp
import pytest
import torch

import mxnet_tpu as mj
from mxnet_tpu import autograd as jautograd
from mxnet_tpu import nd as jnd
from mxnet_tpu.models import gpt as jgpt
from mxnet_tpu.parallel import step as jstep
from mxnet_tpu.parallel.mesh import make_mesh as jmake_mesh
import mxnet_tpu_torch as mt
from mxnet_tpu_torch import parallel
from mxnet_tpu_torch.models import gpt as tgpt
from mxnet_tpu_torch.ops import attention as attn_ops
from mxnet_tpu_torch.weights import params_from_mxnet_tpu

CFG = dict(vocab_size=97, hidden=64, layers=2, heads=4, max_len=32)
B, T = 2, 32
OUT_RTOL, GRAD_RTOL = 1e-5, 1e-4
ADAMW = {'learning_rate': 1e-3, 'wd': 0.01, 'eps': 1e-6}


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
    net = jgpt.GPTModel(**CFG, dropout=0.0)
    net.initialize(mj.init.Normal(0.02))
    arrays = {k: v.data().asnumpy()
              for k, v in net._collect_params_with_prefix().items()}
    return net, arrays


def _reset_jax(net, arrays):
    for k, p in net._collect_params_with_prefix().items():
        p.set_data(jnd.array(arrays[k]))
        p.zero_grad()


def _port(arrays, dropout=0.0):
    net = tgpt.GPTModel(**CFG, dropout=dropout, device='cpu')
    net.load_state_dict(params_from_mxnet_tpu(arrays, net))
    return net


def _batch(seed=0, vocab=None):
    """Tokens drawn from the lower half of the vocabulary, so that the
    upper half's embedding rows are reached by the head alone."""
    rng = onp.random.RandomState(seed)
    toks = rng.randint(0, (vocab or CFG['vocab_size']) // 2,
                       (B, T)).astype('int32')
    labels = onp.full_like(toks, -1)
    labels[:, :-1] = toks[:, 1:]
    return toks, labels


def test_names_and_shapes_match_jax(jax_model):
    _, arrays = jax_model
    net = _port(arrays)
    assert {k: tuple(p.shape) for k, p in net.named_parameters()} == \
        {k: v.shape for k, v in arrays.items()}
    # the head is tied: there is no separate decoder weight
    assert not any('decoder' in n for n in arrays)


def test_logits_and_loss_match_jax(jax_model):
    jnet, arrays = jax_model
    _reset_jax(jnet, arrays)
    toks, labels = _batch()
    jlogits = jnet(jnd.array(toks))
    jloss = float(jgpt.gpt_lm_loss(jlogits, jnd.array(labels)).asnumpy())
    net = _port(arrays).eval()
    with torch.no_grad():
        logits = net(torch.from_numpy(toks))
        loss = float(tgpt.gpt_lm_loss(logits, torch.from_numpy(labels)))
    assert logits.shape == (B, T, CFG['vocab_size'])
    assert rel_fro(logits.numpy(), jlogits.asnumpy()) <= OUT_RTOL
    assert loss == pytest.approx(jloss, rel=OUT_RTOL)


def test_gradients_and_the_tied_embedding_match_jax(jax_model):
    jnet, arrays = jax_model
    _reset_jax(jnet, arrays)
    toks, labels = _batch(seed=1)
    with jautograd.record():
        jloss = jgpt.gpt_lm_loss(jnet(jnd.array(toks)), jnd.array(labels))
    jloss.backward()
    jgrads = {k: p.grad().asnumpy()
              for k, p in jnet._collect_params_with_prefix().items()}
    net = _port(arrays).train()
    loss = tgpt.gpt_lm_loss(net(torch.from_numpy(toks)),
                            torch.from_numpy(labels))
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(jloss.asnumpy()),
                                        rel=OUT_RTOL)
    for name, p in net.named_parameters():
        assert rel_fro(p.grad.numpy(), jgrads[name]) <= GRAD_RTOL, name
    g = net.word_embed.weight.grad.numpy()
    unseen = onp.setdiff1d(onp.arange(CFG['vocab_size']), toks)
    assert len(unseen) > CFG['vocab_size'] // 3
    # rows the lookup never read carry the head's gradient, and JAX's
    assert onp.abs(g[unseen]).max() > 0
    assert rel_fro(g[unseen], jgrads['word_embed.weight'][unseen]) \
        <= GRAD_RTOL


def test_one_sharded_adamw_step_matches_jax(jax_model):
    jnet, arrays = jax_model
    _reset_jax(jnet, arrays)
    toks, labels = _batch(seed=2)
    jmesh = jmake_mesh((1,), ('dp',), devices=jax.devices()[:1])
    jst = jstep.ShardedTrainStep(jnet, jgpt.gpt_lm_loss, 'adamw',
                                 dict(ADAMW), mesh=jmesh)
    jl = float(jst([jnd.array(toks)], [jnd.array(labels)]).asnumpy())
    want = {k: p.data().asnumpy()
            for k, p in jnet._collect_params_with_prefix().items()}
    net = _port(arrays)
    st = parallel.ShardedTrainStep(net, tgpt.gpt_lm_loss, 'adamw',
                                   dict(ADAMW),
                                   mesh=parallel.make_mesh(devices=['cpu']))
    tl = float(st([torch.from_numpy(toks)], [torch.from_numpy(labels)]))
    assert tl == pytest.approx(jl, rel=OUT_RTOL)
    for name, p in net.named_parameters():
        got = p.detach().numpy()
        assert rel_fro(got - arrays[name], want[name] - arrays[name]) \
            <= GRAD_RTOL, name
    # the tied embedding took both gradients: rows no token read moved,
    # as in JAX's step (AdamW's first step moves an element by ~lr
    # whatever its gradient's scale, so the move itself shows it)
    unseen = onp.setdiff1d(onp.arange(CFG['vocab_size']), toks)
    moved = net.word_embed.weight.tensor.detach().numpy()[unseen] - \
        arrays['word_embed.weight'][unseen]
    decay = -ADAMW['learning_rate'] * ADAMW['wd'] * \
        arrays['word_embed.weight'][unseen]
    assert onp.median(onp.abs(moved - decay)) > ADAMW['learning_rate']
    onp.testing.assert_allclose(
        moved, want['word_embed.weight'][unseen] -
        arrays['word_embed.weight'][unseen], rtol=1e-3, atol=1e-7)


def test_eval_mode_draws_no_attention_dropout(jax_model):
    """Dropout 0.1 (attention and hidden): outside ``autograd.record``
    the forward is deterministic and equals the dropout-0 model's;
    inside ``record(train_mode=True)`` it draws noise."""
    _, arrays = jax_model
    toks, _ = _batch(seed=3)
    net = _port(arrays, dropout=0.1)
    routes = dict(attn_ops.route_counts)
    a = net(mt.nd.array(toks, dtype='int32')).asnumpy()
    b = net(mt.nd.array(toks, dtype='int32')).asnumpy()
    onp.testing.assert_array_equal(a, b)
    plain = _port(arrays).eval()
    with torch.no_grad():
        c = plain(torch.from_numpy(toks)).numpy()
    onp.testing.assert_array_equal(a, c)
    assert attn_ops.route_counts['plain'] - routes['plain'] == \
        3 * CFG['layers']
    # the gate itself: a training-mode block asks for attention dropout
    seen = []
    mha = attn_ops.multi_head_attention

    def spy(*args, **kw):
        seen.append(kw['dropout_p'])
        return mha(*args, **kw)
    attn_ops.multi_head_attention = spy
    try:
        with mt.autograd.record():
            d = net(mt.nd.array(toks, dtype='int32')).asnumpy()
        net(mt.nd.array(toks, dtype='int32'))
    finally:
        attn_ops.multi_head_attention = mha
    assert seen == [0.1] * CFG['layers'] + [0.0] * CFG['layers']
    assert not onp.array_equal(a, d)


def test_gpt_causal_lm_trains():
    """The port's twin of tests/test_train_e2e.py::
    test_gpt_causal_lm_trains: causal (a future token leaves earlier
    logits alone), trains through the compiled step, tied head."""
    cfg = dict(vocab_size=128, hidden=32, layers=2, heads=4, max_len=32,
               dropout=0.0)
    mt.random.seed(0)
    model = tgpt.GPTModel(**cfg)
    model.initialize(mt.init.Normal(0.02))
    rng = onp.random.RandomState(0)
    toks = rng.randint(0, 128, (2, 16)).astype(onp.int32)
    base = model(mt.nd.array(toks, dtype='int32')).asnumpy()
    toks2 = toks.copy()
    toks2[:, 12:] = (toks2[:, 12:] + 1) % 128
    pert = model(mt.nd.array(toks2, dtype='int32')).asnumpy()
    assert onp.allclose(base[:, :12], pert[:, :12], atol=1e-5)
    assert onp.abs(base[:, 12:] - pert[:, 12:]).max() > 1e-4

    step = parallel.ShardedTrainStep(model, tgpt.gpt_lm_loss, 'adamw',
                                     {'learning_rate': 3e-3},
                                     mesh=parallel.make_mesh(
                                         (1,), ('dp',), devices=['cpu']))
    labels = onp.full_like(toks, -1)
    labels[:, :-1] = toks[:, 1:]
    tokens, labels = torch.from_numpy(toks), torch.from_numpy(labels)
    losses = [float(step([tokens], [labels])) for _ in range(12)]
    assert losses[-1] < losses[0], losses
    names = list(model.collect_params())
    assert not any('decoder' in n for n in names)


def test_tiny_transformer_overfits_10x():
    """The port's twin of tests/test_train_e2e.py::
    test_tiny_transformer_overfits_10x: a tiny GPT overfits a fixed batch
    (final loss < initial / 10) through the compiled step."""
    mt.random.seed(3)
    model = tgpt.GPTModel(vocab_size=64, hidden=64, layers=2, heads=4,
                          max_len=32, dropout=0.0)
    model.initialize(mt.init.Normal(0.02))
    rng = onp.random.RandomState(1)
    toks = rng.randint(0, 64, (4, 24)).astype(onp.int32)
    labels = onp.full_like(toks, -1)
    labels[:, :-1] = toks[:, 1:]
    step = parallel.ShardedTrainStep(model, tgpt.gpt_lm_loss, 'adamw',
                                     {'learning_rate': 1e-2},
                                     mesh=parallel.make_mesh(
                                         (1,), ('dp',), devices=['cpu']))
    tokens, labs = torch.from_numpy(toks), torch.from_numpy(labels)
    first = last = None
    for _ in range(400):
        last = float(step([tokens], [labs]))
        if first is None:
            first = last
        if last < first / 10:
            break
    assert last < first / 10, (first, last)
