"""The port's AMP (``mxnet_tpu_torch.amp``) against the JAX package's
(``mxnet_tpu.amp``), on the CPU.

Every case of ``tests/test_amp.py`` and ``tests/test_amp_policy.py`` runs
on the port; the policy table is compared op by op over the ops both
registries hold; a small BERT pretraining step (2 layers, hidden 64, 4
heads, T = 16, dropout 0) runs under ``amp.init('bfloat16')`` and
``amp.init('float16')`` in both packages from the same numpy weights, its
seam dtypes, loss and gradients held to JAX's; the Trainer's skip of a
step with a non-finite gradient, ``convert_hybrid_block`` and the CachedOp
key are held to JAX's behaviour.

``amp.init`` patches a module namespace in each package (``nd``), so every
test that calls it restores both through the ``amp_off`` fixture
(``_deinit`` in teardown): nothing leaks into another test file that runs
later in the same worker. Every JAX block here has a ``prefix``, so no
test shifts the JAX package's global name counters.
"""
import numpy as onp
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import amp as jamp
from mxnet_tpu import autograd as jautograd
from mxnet_tpu import gluon as jgluon
from mxnet_tpu import nd as jnd
from mxnet_tpu.amp import amp as jamp_mod
from mxnet_tpu.amp import lists as jlists
from mxnet_tpu.models.bert import BertForPretraining as JBertPT
from mxnet_tpu.models.bert import bert_pretrain_loss as j_loss
import mxnet_tpu_torch as mt
from mxnet_tpu_torch import amp
from mxnet_tpu_torch import autograd, gluon, nd
from mxnet_tpu_torch.amp import amp as amp_mod
from mxnet_tpu_torch.amp import lists
from mxnet_tpu_torch.base import MXNetError, list_ops
from mxnet_tpu_torch.models.bert import BertForPretraining
from mxnet_tpu_torch.models.bert import bert_pretrain_loss
from mxnet_tpu_torch.weights import params_from_mxnet_tpu
from test_torch_jax_globals import jax_globals  # noqa: F401


POLICIES = {'lp16', 'fp32', 'widest', 'nofloat', 'passthrough'}


@pytest.fixture
def amp_off():
    """Restores both packages' nd namespaces after the test, whatever it
    initialised."""
    yield
    amp_mod._deinit()
    jamp_mod._deinit()


@pytest.fixture
def cpu():
    with mt.cpu():
        yield


def _dt(x):
    """'bfloat16', 'float16', 'float32', ... of an NDArray or tensor of
    either package."""
    s = str(x.dtype)
    return s[len('torch.'):] if s.startswith('torch.') else s


# ---- tests/test_amp.py, on the port

def test_autocast_matmul_bf16(amp_off, cpu):
    amp.init()
    a = nd.array(onp.random.rand(8, 16).astype(onp.float32))
    b = nd.array(onp.random.rand(16, 4).astype(onp.float32))
    out = nd.dot(a, b)
    assert _dt(out) == 'bfloat16'
    # fp32-pinned op promotes back up
    assert _dt(nd.softmax(out)) == 'float32'


def test_autocast_widest(amp_off, cpu):
    amp.init()
    a = nd.array(onp.ones((4, 4), onp.float32)).astype('bfloat16')
    b = nd.array(onp.ones((4, 4), onp.float32))
    assert _dt(nd.broadcast_add(a, b)) == 'float32'


def test_amp_training_converges(amp_off, cpu):
    """Dense layer under autocast: forward in bf16, f32 master weights, the
    loss falls 5x in 100 steps, as in the JAX test."""
    amp.init()
    net = gluon.nn.Dense(1)
    net.initialize(mt.init.Xavier())
    trainer = gluon.Trainer(net.collect_params(), 'sgd',
                            {'learning_rate': 0.1})
    amp.init_trainer(trainer)
    loss_fn = gluon.loss.L2Loss()
    rng = onp.random.RandomState(0)
    X = rng.rand(64, 4).astype(onp.float32)
    W = onp.array([[1.0], [-2.0], [3.0], [0.5]], onp.float32)
    x, y = nd.array(X), nd.array(X @ W)
    first = last = None
    for _ in range(100):
        with autograd.record():
            loss = loss_fn(net(x), y)
            with amp.scale_loss(loss, trainer) as scaled:
                pass
        scaled.backward()
        trainer.step(64)
        last = float(loss.mean().asnumpy())
        if first is None:
            first = last
    assert last < first * 0.2, (first, last)
    assert _dt(net.weight.data()) == 'float32'


def test_loss_scaler_overflow_skips_update():
    s = amp.LossScaler(init_scale=1024., scale_window=2)
    s.update_scale(overflow=True)
    assert s.loss_scale == 512.
    s.update_scale(False)
    s.update_scale(False)
    assert s.loss_scale == 1024.
    s2 = amp.LossScaler(init_scale=2., min_scale=1.)
    s2.update_scale(True)
    s2.update_scale(True)
    assert s2.loss_scale == 1.


def _dense_pair(w0, b0):
    """The same Dense(1) in both packages (the JAX one named)."""
    jnet = jgluon.nn.Dense(1, in_units=3, prefix='ampskip_')
    jnet.initialize()
    jnet.weight.set_data(jnd.array(w0))
    jnet.bias.set_data(jnd.array(b0))
    tnet = gluon.nn.Dense(1, in_units=3)
    tnet.initialize(ctx=mt.cpu())
    tnet.weight.set_data(w0)
    tnet.bias.set_data(b0)
    return jnet, tnet


@pytest.mark.parametrize('opt', ['sgd', 'adamw'])
def test_trainer_skips_on_nonfinite_grad(amp_off, cpu, opt):
    """A non-finite gradient skips the step in both packages: weights and
    update counts unchanged, the scale halved; the next clean step then
    updates, to the same weights in both (the JAX test, held side by
    side, with a stateless and a stateful optimizer)."""
    rng = onp.random.RandomState(4)
    w0, b0 = rng.randn(1, 3).astype('f4'), rng.randn(1).astype('f4')
    jnet, tnet = _dense_pair(w0, b0)
    kw = {'learning_rate': 0.1}
    jtr = jgluon.Trainer(jnet.collect_params(), opt, dict(kw))
    ttr = gluon.Trainer(tnet.collect_params(), opt, dict(kw))
    jamp.init_trainer(jtr, loss_scale=1024.)
    amp.init_trainer(ttr, loss_scale=1024.)
    x = onp.ones((2, 3), onp.float32)
    for bad in (True, False):
        scale = onp.inf if bad else 1.0
        with jautograd.record():
            jl = (jnet(jnd.array(x)) * scale).sum()
            with jamp.scale_loss(jl, jtr) as js:
                pass
        js.backward()
        with autograd.record():
            tl = (tnet(nd.array(x)) * scale).sum()
            with amp.scale_loss(tl, ttr) as ts:
                pass
        ts.backward()
        jtr.step(2)
        ttr.step(2)
        jw = jnet.weight.data().asnumpy()
        tw = tnet.weight.data().asnumpy()
        if bad:
            onp.testing.assert_array_equal(jw, w0)
            onp.testing.assert_array_equal(tw, w0)
            assert ttr._amp_loss_scaler.loss_scale == \
                jtr._amp_loss_scaler.loss_scale == 512.
            assert ttr.optimizer.num_update == jtr.optimizer.num_update == 0
        else:
            assert not onp.array_equal(tw, w0)
            assert ttr.optimizer.num_update == jtr.optimizer.num_update == 1
            onp.testing.assert_allclose(tw, jw, rtol=1e-6, atol=1e-7)
            onp.testing.assert_allclose(tnet.bias.data().asnumpy(),
                                        jnet.bias.data().asnumpy(),
                                        rtol=1e-6, atol=1e-7)


def test_convert_hybrid_block(cpu):
    """The converted copy: output f32 within the bf16 bound of the JAX
    test, and equal to the JAX package's converted copy of the same
    weights to bf16 rounding; the input block untouched; Dense weights
    bf16, BatchNorm's parameters f32."""
    rng = onp.random.RandomState(1)
    X = rng.rand(4, 6).astype(onp.float32)

    def build(g, prefix=None):
        kw = {} if prefix is None else {'prefix': prefix}
        net = g.nn.HybridSequential(**kw)
        with net.name_scope():
            net.add(g.nn.Dense(8, activation='relu', in_units=6))
            net.add(g.nn.BatchNorm(in_channels=8))
            net.add(g.nn.Dense(2, in_units=8))
        return net
    jnet = build(jgluon, 'ampconv_')
    jnet.initialize()
    tnet = build(gluon)
    tnet.initialize()
    for (jn, jp), (tn, tp) in zip(
            sorted(jnet._collect_params_with_prefix().items()),
            sorted(tnet._collect_params_with_prefix().items())):
        assert jn == tn
        tp.set_data(jp.data().asnumpy().copy())
    ref = tnet(nd.array(X)).asnumpy()
    before = {n: p.data().asnumpy().copy()
              for n, p in tnet.collect_params().items()}

    conv = amp.convert_hybrid_block(tnet)
    out = conv(nd.array(X))
    jout = jamp.convert_hybrid_block(jnet)(jnd.array(X))
    assert _dt(out) == 'float32' and _dt(jout) == 'float32'
    onp.testing.assert_allclose(out.asnumpy(), ref, atol=5e-2, rtol=5e-2)
    onp.testing.assert_allclose(out.asnumpy(), jout.asnumpy(), atol=2e-2,
                                rtol=2e-2)
    for n, p in tnet.collect_params().items():
        assert _dt(p.data()) == 'float32'
        onp.testing.assert_array_equal(p.data().asnumpy(), before[n])
    params = conv.collect_params()
    for n, p in params.items():
        want = 'float32' if 'batchnorm' in n else 'bfloat16'
        assert _dt(p.data()) == want, n
    assert conv.collect_params() is not tnet.collect_params()


def test_convert_model_raises():
    with pytest.raises(NotImplementedError, match='convert_hybrid_block'):
        amp.convert_model(None)


def test_the_op_lists_match_jax():
    assert amp.list_lp16_ops() == jamp.list_lp16_ops()
    assert amp.list_fp32_ops() == jamp.list_fp32_ops()
    assert lists.WIDEST_OPS == jlists.WIDEST_OPS


# ---- tests/test_amp_policy.py, on the port

def test_every_registered_op_has_a_policy():
    table = lists.policy_table()
    assert not [op for op in list_ops() if op not in table]
    assert not {op: p for op, p in table.items() if p not in POLICIES}


def test_policy_table_equals_jax_for_every_shared_op():
    """For every op that both registries hold, the port's policy is the JAX
    package's."""
    mine, theirs = lists.policy_table(), jlists.policy_table()
    shared = sorted(set(mine) & set(theirs))
    assert len(shared) == len(mine) > 150
    assert {op: mine[op] for op in shared} == \
        {op: theirs[op] for op in shared}


def test_matmul_class_is_lp16():
    table = lists.policy_table()
    for op in ['fully_connected', 'convolution', 'dot', 'batch_dot',
               '_npi_einsum', '_npi_matmul', 'rnn', 'linalg_gemm']:
        if op in table:
            assert table[op] == 'lp16', op


def test_numerics_sensitive_is_fp32():
    table = lists.policy_table()
    for op in ['softmax', 'log_softmax', 'batch_norm', 'layer_norm',
               'exp', 'log', 'sum', 'mean', 'ctc_loss', 'norm',
               '_npi_exp', '_npi_log', 'linalg_potrf']:
        if op in table:
            assert table[op] == 'fp32', op


def test_cheap_elementwise_not_pinned_fp32():
    table = lists.policy_table()
    for op in ['sqrt', 'square', 'reciprocal', 'rsqrt', 'rcbrt', 'cbrt']:
        if op in table:
            assert table[op] == 'passthrough', op
        assert op not in lists.FP32_OPS
    for op in ['sum', 'mean', 'prod', 'nansum', 'norm']:
        if op in table:
            assert table[op] == 'fp32', op


def test_amp_keeps_bf16_through_cheap_elementwise(amp_off, cpu):
    amp.init('bfloat16')
    x = nd.array(onp.ones((2, 3), onp.float32)).astype('bfloat16')
    assert _dt(nd.sqrt(x)) == 'bfloat16'
    assert _dt(nd.square(x)) == 'bfloat16'
    assert _dt(nd.sum(x)) == 'float32'


def test_integer_semantics_never_cast():
    table = lists.policy_table()
    for op in ['argmax', 'argmin', 'one_hot', 'topk', 'broadcast_equal',
               'quantized_conv', 'random_randint', 'shape_array']:
        if op in table:
            assert table[op] == 'nofloat', op


def test_optimizer_updates_are_passthrough():
    for op, p in lists.policy_table().items():
        if op.endswith('_update'):
            assert p == 'passthrough', op


def test_explicit_lists_win_over_derivation():
    for op in lists.LP16_OPS:
        assert lists.derive_policy(op) == 'lp16', op
    for op in lists.FP32_OPS:
        assert lists.derive_policy(op) == 'fp32', op
    for op in lists.WIDEST_OPS:
        assert lists.derive_policy(op) == 'widest', op


@pytest.mark.parametrize('target', ['bfloat16', 'float16'])
def test_amp_init_patches_derived_ops(amp_off, cpu, target):
    """Through NDArrays and through torch tensors (what a hybrid_forward's
    ``F`` ops receive): fully_connected runs in the target, softmax
    upcasts it to f32, an integer op stays integer."""
    amp.init(target)
    out = nd.fully_connected(nd.array(onp.ones((2, 4), onp.float32)),
                             nd.array(onp.ones((3, 4), onp.float32)),
                             num_hidden=3, no_bias=True)
    assert _dt(out) == target
    assert _dt(nd.softmax(out)) == 'float32'
    t = nd.fully_connected(torch.ones(2, 4), torch.ones(3, 4),
                           num_hidden=3, no_bias=True)
    assert isinstance(t, torch.Tensor) and _dt(t) == target
    assert _dt(nd.log_softmax(t)) == 'float32'
    assert _dt(nd.argmax(t, axis=1)) == _dt(
        nd.argmax(torch.ones(2, 3), axis=1))


def test_init_refuses_an_unknown_target_and_keeps_the_first(amp_off):
    with pytest.raises(MXNetError, match='target_dtype'):
        amp.init('float64')
    amp.init('float16')
    epoch = amp_mod.patch_epoch()
    amp.init('bfloat16')                # ignored, as in the reference
    assert amp_mod._target_dtype == 'float16'
    assert amp_mod.patch_epoch() == epoch
    amp_mod._deinit()
    assert amp_mod.patch_epoch() == epoch + 1
    assert nd.fully_connected is not None and not hasattr(
        nd.fully_connected, '__amp_original__')


def test_contrib_amp_is_amp():
    assert mt.contrib.amp is mt.amp is amp


# ---- the scaler's defaults and the Trainer seam

@pytest.mark.parametrize('target,scale,dynamic', [
    ('bfloat16', 1.0, False), ('float16', 2.0 ** 16, True)])
def test_init_trainer_defaults_match_jax(amp_off, cpu, target, scale,
                                         dynamic):
    amp.init(target)
    jamp.init(target)
    tnet = gluon.nn.Dense(1, in_units=2)
    tnet.initialize()
    jnet = jgluon.nn.Dense(1, in_units=2, prefix='ampdefault_')
    jnet.initialize()
    ttr = amp.init_trainer(gluon.Trainer(tnet.collect_params(), 'sgd'))
    jtr = jamp.init_trainer(jgluon.Trainer(jnet.collect_params(), 'sgd'))
    for tr in (ttr, jtr):
        assert tr._amp_loss_scaler.loss_scale == scale
        assert tr._amp_loss_scaler.dynamic is dynamic
    with pytest.raises(MXNetError, match='init_trainer'):
        amp.init_trainer(object())


def test_scale_loss_and_unscale_set_the_trainer_scale(amp_off, cpu):
    """scale_loss yields loss * scale (a list for a list) and sets the
    trainer's _scale to original / scale; unscale divides the gradients in
    place and restores the original scale, as in JAX."""
    amp.init('float16')
    net = gluon.nn.Dense(1, in_units=2)
    net.initialize()
    tr = amp.init_trainer(gluon.Trainer(net.collect_params(), 'sgd',
                                        {'rescale_grad': 2.0}))
    loss = torch.tensor(3.0)
    with amp.scale_loss(loss, tr) as s:
        assert float(s) == 3.0 * 2 ** 16
    assert tr._scale == 2.0 / 2 ** 16
    with amp.scale_loss([loss, loss], tr) as s:
        assert [float(x) for x in s] == [3.0 * 2 ** 16] * 2
    net.weight.tensor.grad = torch.full((1, 2), 2.0 ** 16)
    amp.unscale(tr)
    assert torch.equal(net.weight.tensor.grad, torch.ones(1, 2))
    assert tr._scale == 2.0
    bare = gluon.Trainer(net.collect_params(), 'sgd')
    with pytest.raises(MXNetError, match='init_trainer'):
        with amp.scale_loss(loss, bare):
            pass


def test_a_new_loss_scale_rebuilds_no_fused_update(amp_off, cpu):
    """rescale_grad is an entry of the fused update's scalar vector: a step
    at a halved loss scale reuses the program (on the card, the captured
    graph) and divides by the new scale."""
    amp.init('float16')
    p = torch.nn.Parameter(torch.ones(3))
    tr = amp.init_trainer(gluon.Trainer([p], 'sgd', {'learning_rate': 1.0}))
    scaler = tr._amp_loss_scaler
    for want_scale in (2.0 ** 16, 2.0 ** 15):
        scaler.loss_scale = want_scale
        with amp.scale_loss(torch.tensor(1.0), tr):
            pass
        p.grad = torch.full((3,), want_scale)   # scaled gradient of 1
        before = p.detach().clone()
        tr.step(1)
        torch.testing.assert_close(before - p.detach(), torch.ones(3))
        if want_scale == 2.0 ** 16:
            program = tr._fused
        assert tr._fused is program


def test_has_overflow_reads_params_and_buffers():
    s = amp.LossScaler()
    p = torch.nn.Parameter(torch.ones(2))
    assert s.has_overflow([p]) is False          # no gradient yet
    p.grad = torch.tensor([1.0, float('nan')])
    assert s.has_overflow([p]) is True
    assert s.has_overflow([torch.ones(2), torch.tensor([float('inf')])])
    assert s.has_overflow([torch.ones(2)]) is False


# ---- the CachedOp key

def test_cachedop_key_changes_at_init_and_deinit(amp_off, cpu):
    """A CUDA graph captured before amp.init() must not be replayed after
    it, nor the other way round: the key carries the patch epoch."""
    from mxnet_tpu_torch.gluon.block import CachedOp
    net = gluon.nn.HybridSequential(prefix='ampkey_')
    net.add(gluon.nn.Dense(2, in_units=3))
    net.initialize()
    op = CachedOp(net)
    args = (torch.ones(1, 3),)
    k0 = op.key(args)
    amp.init('bfloat16')
    k1 = op.key(args)
    amp_mod._deinit()
    k2 = op.key(args)
    assert len({k0, k1, k2}) == 3
    assert k0[-1] == k1[-1] == k2[-1]           # the names stay last


# ---- a small BERT pretraining step under AMP in both packages

CFG = dict(vocab_size=128, hidden=64, layers=2, heads=4, intermediate=256,
           max_len=32, type_vocab=2, dropout=0.0)
B, T, M = 3, 16, 4
# tolerances (chosen from the targets' precision before the comparison):
# both packages round to the target at the same seams but in their own
# kernels, so the logits may differ by an ulp or two of the target
# (2**-8 relative for bf16, 2**-11 for float16) of the largest logit; the
# loss is an f32 mean of those, 1e-3 relative; each gradient passes two
# layers of such roundings: rel Frobenius 0.05 (bf16) / 0.01 (float16),
# cosine 0.999 / 0.9999
BERT_TOL = {'bfloat16': dict(ulp=2.0 ** -8, grad_rel=0.05, cos=0.999),
            'float16': dict(ulp=2.0 ** -11, grad_rel=0.01, cos=0.9999)}


@pytest.fixture(scope='module')
def bert_arrays():
    mx.random.seed(0)
    net = JBertPT(CFG, prefix='ampbert_')
    net.initialize(mx.init.Normal(0.02))
    net(jnd.array(onp.zeros((1, 8), 'int32')))
    return net, {k: v.data().asnumpy()
                 for k, v in net._collect_params_with_prefix().items()}


def _bert_batch():
    rng = onp.random.RandomState(0)
    tokens = rng.randint(0, CFG['vocab_size'], (B, T)).astype('int32')
    types = rng.randint(0, 2, (B, T)).astype('int32')
    valid = rng.randint(T // 2, T + 1, B).astype('float32')
    mpos = onp.stack([rng.choice(T, M, replace=False)
                      for _ in range(B)]).astype('int32')
    labels = rng.randint(0, CFG['vocab_size'], (B, M)).astype('int32')
    labels[0, 0] = -1
    nsp = rng.randint(0, 2, B).astype('int32')
    return tokens, types, valid, mpos, labels, nsp


def _record_seams(monkeypatch):
    """{package: [(seam, dtypes)]}: the attention op's q, k, v and mask and
    add_layer_norm's x and res, as each model calls them."""
    import mxnet_tpu.ops.attention as jattn
    import mxnet_tpu.ops.nn as jnn
    import mxnet_tpu_torch.ops.attention as tattn
    import mxnet_tpu_torch.ops.nn as tnn
    seen = {'jax': [], 'port': []}

    def spy(pkg, mod, name, n):
        orig = getattr(mod, name)

        def wrapper(*args, **kwargs):
            seen[pkg].append((name, tuple(_dt(a) for a in args[:n])))
            return orig(*args, **kwargs)
        monkeypatch.setattr(mod, name, wrapper)
    spy('jax', jattn, 'multi_head_attention', 4)
    spy('port', tattn, 'multi_head_attention', 4)
    spy('jax', jnn, 'add_layer_norm', 2)
    spy('port', tnn, 'add_layer_norm', 2)
    return seen


@pytest.mark.parametrize('target', ['bfloat16', 'float16'])
def test_bert_step_under_amp_matches_jax(amp_off, monkeypatch, bert_arrays,
                                         target):
    jnet, arrays = bert_arrays
    jamp.init(target)
    amp.init(target)
    seen = _record_seams(monkeypatch)
    batch = _bert_batch()
    for k, p in jnet._collect_params_with_prefix().items():
        p.set_data(jnd.array(arrays[k]))
        p.zero_grad()
    jins = [jnd.array(a) for a in batch]
    with jautograd.record():
        jmlm, jnsp = jnet(*jins[:4])
        jl = j_loss(jmlm, jnsp, jins[4], jins[5])
    jl.backward()
    jgrads = {k: p.grad().asnumpy()
              for k, p in jnet._collect_params_with_prefix().items()}

    net = BertForPretraining(CFG, device='cpu').train()
    net.load_state_dict(params_from_mxnet_tpu(arrays, net))
    tins = [torch.from_numpy(a if a.dtype == onp.float32 else
                             a.astype('int64')) for a in batch]
    mlm, nsp = net(*tins[:4])
    loss = bert_pretrain_loss(mlm, nsp, tins[4], tins[5])
    loss.backward()

    # the seams: attention inputs in the target (the mask f32), the
    # residual stream f32 meeting a sublayer output in the target, the
    # heads' logits in the target, the loss f32 -- in both packages
    layers = CFG['layers']
    assert seen['port'] == seen['jax']
    assert seen['port'].count(('multi_head_attention',
                               (target,) * 3 + ('float32',))) == layers
    assert seen['port'].count(('add_layer_norm',
                               ('float32', target))) == 2 * layers
    assert _dt(mlm) == _dt(jmlm) == target
    assert _dt(nsp) == _dt(jnsp) == target
    assert _dt(loss) == _dt(jl) == 'float32'

    tol = BERT_TOL[target]
    want = jmlm.asnumpy().astype('float32')
    onp.testing.assert_allclose(
        mlm.detach().float().numpy(), want, rtol=0,
        atol=2 * tol['ulp'] * float(onp.abs(want).max()))
    jloss = float(jl.asnumpy())
    assert abs(float(loss.detach()) - jloss) <= 1e-3 * abs(jloss)
    for name, p in net.named_parameters():
        assert p.grad.dtype == torch.float32, name
        g, w = p.grad.numpy(), jgrads[name].astype('float32')
        rel = onp.linalg.norm(g - w) / onp.linalg.norm(w)
        cos = float((g * w).sum() / (onp.linalg.norm(g) *
                                     onp.linalg.norm(w)))
        assert rel <= tol['grad_rel'], (name, rel)
        assert cos >= tol['cos'], (name, cos)


def test_bert_loss_without_amp_is_the_plain_formula():
    """The loss through the nd namespace gives, without AMP, bitwise the
    gather-and-sum formula the port used before it went through nd."""
    g = torch.Generator().manual_seed(3)
    mlm = torch.randn(4, 6, 50, generator=g, requires_grad=True)
    nsp = torch.randn(4, 2, generator=g, requires_grad=True)
    labels = torch.randint(-1, 50, (4, 6), generator=g)
    nl = torch.randint(0, 2, (4,), generator=g)
    got = bert_pretrain_loss(mlm, nsp, labels, nl)
    logp = torch.log_softmax(mlm, dim=-1)
    valid = labels >= 0
    safe = torch.where(valid, labels, torch.zeros_like(labels))
    tok = -torch.gather(logp, -1, safe[..., None])[..., 0] * valid
    nlogp = torch.log_softmax(nsp, dim=-1)
    want = tok.sum() / (valid.sum() + 1e-6) + \
        (-torch.gather(nlogp, -1, nl[:, None])[:, 0]).mean()
    assert torch.equal(got, want)
    ga = torch.autograd.grad(got, (mlm, nsp))
    gb = torch.autograd.grad(want, (mlm, nsp))
    assert all(torch.equal(a, b) for a, b in zip(ga, gb))


def test_deepcopy_of_a_block_copies_its_parameters(cpu):
    """convert_hybrid_block clones the model with copy.deepcopy (the JAX
    package's Parameter.__deepcopy__): the copy's Parameters, its
    registered tensors and their gradients are new tensors with the same
    values, each Parameter still the one its block registers, and
    writing the copy leaves the original as it was."""
    import copy
    net = gluon.nn.HybridSequential(prefix='ampcopy_')
    net.add(gluon.nn.Dense(3, in_units=2), gluon.nn.Dense(1, in_units=3))
    net.initialize()
    net[0].weight.tensor.grad = torch.ones(3, 2)
    twin = copy.deepcopy(net)
    named = dict(twin.named_parameters())
    for (n, p), (m, q) in zip(net.collect_params().items(),
                              twin.collect_params().items()):
        assert n == m and p is not q and p.tensor is not q.tensor
        assert torch.equal(p.data()._data, q.data()._data)
    assert twin[0].weight.tensor is named['0.weight']
    assert twin[0].weight.tensor.grad is not net[0].weight.tensor.grad
    assert torch.equal(twin[0].weight.tensor.grad, torch.ones(3, 2))
    before = net[0].weight.data().asnumpy().copy()
    twin[0].weight.set_data(onp.zeros((3, 2), 'f4'))
    onp.testing.assert_array_equal(net[0].weight.data().asnumpy(), before)
