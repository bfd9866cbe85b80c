"""The PyTorch bridge (``mx.torch``), ``contrib.text`` and
``contrib.tensorboard`` of the port against the JAX package's, on the
CPU.

tests/test_interop_tools.py's six cases that launch nothing run through
both packages (its two ``tools/launch.py`` cases wait for ROADMAP queue
1 items 8 and 10). The bridge: in the port ``to_torch``/``from_torch``
share storage (the same ``data_ptr()``); ``TorchOp`` gives the same
outputs and input gradients as torch autograd and as the JAX package's
bridge, and a module's parameters accumulate their ``.grad``; a TorchOp
inside a Gluon model takes one SGD step to the JAX package's parameters.
Text: the same vocabulary, indices and vectors (bitwise: the same
float parsing). Tensorboard: the same lines, wall times aside.
Tolerance: f32, rel 1e-5 (outputs) and 1e-4 (gradients), as the JAX
test holds them.
"""
import json

import numpy as onp
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu_torch.test_utils import assert_almost_equal
from test_torch_jax_globals import jax_globals  # noqa: F401

PKGS = {'jax': jmx, 'port': mx}


@pytest.fixture(autouse=True)
def _cpu():
    with mx.cpu():
        yield


@pytest.mark.parametrize('pkg', ['jax', 'port'])
def test_torch_tensor_conversion(pkg):
    m = PKGS[pkg]
    x = onp.random.RandomState(0).rand(3, 4).astype(onp.float32)
    a = m.nd.array(x)
    t = m.torch.to_torch(a)
    assert tuple(t.shape) == (3, 4)
    back = m.torch.from_torch(t)
    assert_almost_equal(back, x)


def test_port_bridge_shares_storage():
    a = mx.nd.array(onp.arange(6, dtype=onp.float32).reshape(2, 3))
    t = mx.torch.to_torch(a)
    assert t.data_ptr() == a._data.data_ptr()
    assert not t.requires_grad
    t[0, 0] = 42.0
    assert a.asnumpy()[0, 0] == 42.0
    b = mx.torch.from_torch(t)
    assert b._data.data_ptr() == t.data_ptr()
    with pytest.raises(TypeError):
        mx.torch.to_torch(t)
    with pytest.raises(TypeError):
        mx.torch.from_torch(a)


def _linear(seed=0):
    torch.manual_seed(seed)
    return torch.nn.Linear(4, 2)


def _torchop_step(m, lin, x_np):
    x = m.nd.array(x_np)
    x.attach_grad()
    with m.autograd.record():
        y = m.torch.TorchOp(lin)(x)
        loss = (y * y).sum()
    loss.backward()
    return y.asnumpy(), x.grad.asnumpy()


def test_torch_op_gradients_match_torch_autograd():
    x_np = onp.random.RandomState(1).rand(3, 4).astype(onp.float32)
    lin = _linear()
    y, gx = _torchop_step(mx, lin, x_np)
    port_wgrad = lin.weight.grad.clone()
    tx = torch.from_numpy(x_np.copy()).requires_grad_(True)
    ref = _linear()
    ty = ref(tx)
    (ty * ty).sum().backward()
    assert_almost_equal(y, ty.detach().numpy(), rtol=1e-5, atol=1e-6)
    assert_almost_equal(gx, tx.grad.numpy(), rtol=1e-4, atol=1e-5)
    assert_almost_equal(port_wgrad, ref.weight.grad, rtol=1e-4, atol=1e-5)
    # the same as the JAX package's bridge, and .grad accumulates
    jlin = _linear()
    jy, jgx = _torchop_step(jmx, jlin, x_np)
    assert_almost_equal(y, jy, rtol=1e-5, atol=1e-6)
    assert_almost_equal(gx, jgx, rtol=1e-5, atol=1e-6)
    assert_almost_equal(port_wgrad, jlin.weight.grad, rtol=1e-5, atol=1e-6)
    _torchop_step(mx, lin, x_np)
    assert_almost_equal(lin.weight.grad, 2 * port_wgrad, rtol=1e-5,
                        atol=1e-6)


def test_torch_op_multi_output_and_outside_record():
    def split(x):
        return x[:, :2] * 2.0, x[:, 2:].sum(1)
    x_np = onp.arange(8, dtype=onp.float32).reshape(2, 4)
    a, b = mx.torch.TorchOp(split)(mx.nd.array(x_np))
    assert_almost_equal(a, x_np[:, :2] * 2)
    assert_almost_equal(b, x_np[:, 2:].sum(1))
    x = mx.nd.array(x_np)
    x.attach_grad()
    with mx.autograd.record():
        a, b = mx.torch.TorchOp(split)(x)
        loss = a.sum() + 3 * b.sum()
    loss.backward()
    assert_almost_equal(x.grad, [[2, 2, 3, 3]] * 2)


def _gluon_net(m, torch_mid, arrays=None):
    class Net(m.gluon.Block):
        def __init__(self):
            super().__init__(prefix='net_')
            with self.name_scope():
                self.fc1 = m.gluon.nn.Dense(8, in_units=3)
                self.fc2 = m.gluon.nn.Dense(2, in_units=8)

        def forward(self, x):
            return self.fc2(torch_mid(self.fc1(x)))
    net = Net()
    net.initialize(m.init.Xavier())
    if arrays is not None:
        for k, p in net._collect_params_with_prefix().items():
            p.set_data(arrays[k])
    return net


def test_torch_op_inside_gluon_model():
    """One SGD step of a Gluon model with a torch Tanh in the middle, in
    both packages from the same weights."""
    rs = onp.random.RandomState(2)
    x = rs.rand(4, 3).astype(onp.float32)
    y = onp.array([0, 1, 0, 1], onp.float32)
    out = {}
    arrays = None
    for pkg in ('jax', 'port'):
        m = PKGS[pkg]
        net = _gluon_net(m, m.torch.TorchOp(torch.nn.Tanh()), arrays)
        if arrays is None:
            arrays = {k: p.data().asnumpy() for k, p in
                      net._collect_params_with_prefix().items()}
        trainer = m.gluon.Trainer(net.collect_params(), 'sgd',
                                  {'learning_rate': 0.1})
        loss_fn = m.gluon.loss.SoftmaxCrossEntropyLoss()
        with m.autograd.record():
            loss = loss_fn(net(m.nd.array(x)), m.nd.array(y)).mean()
        loss.backward()
        trainer.step(4)
        out[pkg] = {k: p.data().asnumpy() for k, p in
                    net._collect_params_with_prefix().items()}
    for k in arrays:
        assert onp.isfinite(out['port'][k]).all()
        assert not onp.array_equal(out['port'][k], arrays[k]), k
        assert_almost_equal(out['port'][k], out['jax'][k], rtol=1e-5,
                            atol=1e-6)


@pytest.mark.parametrize('pkg', ['jax', 'port'])
def test_vocabulary(pkg):
    text = PKGS[pkg].contrib.text
    c = text.count_tokens_from_str("a b b c c c")
    v = text.Vocabulary(c, min_freq=2)
    assert len(v) == 3
    assert v.to_indices('c') == 1
    assert v.to_indices('missing') == 0
    assert v.to_tokens([1, 2]) == ['c', 'b']
    with pytest.raises(ValueError):
        v.to_tokens(99)
    v2 = text.Vocabulary(c, reserved_tokens=['<pad>'])
    assert v2.to_indices('<pad>') == 1


def test_vocabularies_agree():
    src = "The quick brown fox\njumps over the lazy dog the end\nFox"
    vocabs = {}
    for pkg, m in PKGS.items():
        t = m.contrib.text
        c = t.count_tokens_from_str(src, to_lower=True)
        vocabs[pkg] = (dict(c), t.Vocabulary(
            c, most_freq_count=5, reserved_tokens=['<pad>', '<s>']))
    assert vocabs['port'][0] == vocabs['jax'][0]
    assert vocabs['port'][1].idx_to_token == vocabs['jax'][1].idx_to_token
    assert vocabs['port'][1].token_to_idx == vocabs['jax'][1].token_to_idx


@pytest.mark.parametrize('pkg', ['jax', 'port'])
def test_custom_embedding(pkg, tmp_path):
    m = PKGS[pkg]
    f = tmp_path / 'emb.txt'
    f.write_text("hello 0.1 0.2\nworld 0.3 0.4\n")
    emb = m.contrib.text.CustomEmbedding(str(f))
    assert emb.vec_len == 2
    assert_almost_equal(emb.get_vecs_by_tokens('world'),
                        onp.array([0.3, 0.4], onp.float32))
    assert_almost_equal(emb.get_vecs_by_tokens('zzz'),
                        onp.zeros(2, onp.float32))
    emb.update_token_vectors('hello', m.nd.array([[9.0, 9.0]]))
    assert_almost_equal(emb.get_vecs_by_tokens('hello'),
                        onp.array([9.0, 9.0], onp.float32))


def test_embeddings_agree_and_live_on_their_context(tmp_path):
    f1 = tmp_path / 'a.txt'
    f1.write_text("3 2\nhello 0.1 0.2\nworld 0.3 0.4\nHi 1e-3 -2.5\n")
    f2 = tmp_path / 'b.txt'
    f2.write_text("world 1 2 3\nfoo 4 5 6\n")
    out = {}
    for pkg, m in PKGS.items():
        t = m.contrib.text
        vocab = t.Vocabulary(t.count_tokens_from_str('hello world foo bar'))
        kw = {'ctx': mx.cpu()} if pkg == 'port' else {}
        e1 = t.CustomEmbedding(str(f1), **kw)
        e2 = t.CustomEmbedding(str(f2), vocabulary=vocab, **kw)
        comp = t.CompositeEmbedding(vocab, [e1, e2], **kw)
        out[pkg] = (e1.idx_to_vec.asnumpy(), e2.idx_to_vec.asnumpy(),
                    comp.idx_to_vec.asnumpy(), comp.idx_to_token,
                    e1.get_vecs_by_tokens(['HI', 'hi'],
                                          lower_case_backup=True).asnumpy())
        if pkg == 'port':
            assert comp.idx_to_vec.context == mx.cpu()
    for got, want in zip(out['port'], out['jax']):
        if isinstance(got, list):
            assert got == want
        else:
            onp.testing.assert_array_equal(got, want)


@pytest.mark.parametrize('pkg', ['jax', 'port'])
def test_tensorboard_callback(pkg, tmp_path):
    m = PKGS[pkg]
    tb = m.contrib.tensorboard

    class P:
        pass

    p = P()
    p.eval_metric = m.metric.Accuracy()
    p.eval_metric.update(m.nd.array([0.0, 1.0]),
                         m.nd.array([[0.9, 0.1], [0.2, 0.8]]))
    w = tb.JSONLWriter(str(tmp_path))
    cb = tb.LogMetricsCallback(summary_writer=w, prefix='train')
    cb(p)
    content = (tmp_path / 'scalars.jsonl').read_text()
    assert 'train-accuracy' in content


def test_tensorboard_lines_agree(tmp_path, monkeypatch):
    """The same lines from both packages, wall times aside, through the
    fallback writer (tensorboardX hidden); a callback without a metric
    counts the step and writes nothing."""
    import sys
    monkeypatch.setitem(sys.modules, 'tensorboardX', None)
    lines = {}
    for pkg, m in PKGS.items():
        tb = m.contrib.tensorboard
        metric = m.metric.create(['acc', 'mse'])
        metric.update([m.nd.array([0.0, 1.0, 1.0])],
                      [m.nd.array([[0.9, 0.1], [0.2, 0.8], [0.6, 0.4]])])
        cb = tb.LogMetricsCallback(logging_dir=str(tmp_path / pkg))
        P = type('P', (), {'eval_metric': metric})
        cb(P())
        cb(type('P', (), {'eval_metric': None})())
        cb(P())
        cb.summary_writer.close()
        with open(tmp_path / pkg / 'scalars.jsonl') as f:
            lines[pkg] = [{k: v for k, v in json.loads(ln).items()
                           if k != 'wall_time'} for ln in f]
    assert lines['port'] == lines['jax']
    assert [ln['step'] for ln in lines['port']] == [1, 1, 3, 3]
