"""The port's fused RNN op, ``gluon.rnn`` layers and cells against the JAX
package's, on the CPU in f32.

- ``nd.rnn`` (``ops/nn.py``) over 'rnn_relu', 'rnn_tanh', 'lstm' and 'gru'
  at 1 and 2 layers, one and two directions, and the LSTM with its cell
  clip: outputs and final states within atol 1e-5 of the JAX op on the
  same numpy inputs, and the gradients of a random projection of every
  output with respect to the flat parameters, the inputs and the initial
  states within rel Frobenius 1e-4 of ``jax.grad``'s. Dropout is 0 here:
  the two packages' random streams differ (jax threefry against torch
  Philox), so the inter-layer mask is checked statistically apart.
- ``RNN``, ``LSTM``, ``GRU`` in both layouts: the JAX layer's parameter
  names, its values carried across by name, outputs and states within
  1e-5 and every parameter's gradient within rel Frobenius 1e-4.
- Each cell's ``unroll`` against the JAX cell's (outputs and states
  within 1e-5), with and without ``valid_length``; ``_unfuse()`` of a
  unidirectional layer against the fused layer; and the JAX package's
  fault that the port mirrors: a bidirectional layer's ``_unfuse()``
  cannot be unrolled (``SequentialRNNCell`` steps each child, and a
  ``BidirectionalCell`` raises when stepped).
"""
import jax
import jax.numpy as jnp
import numpy as onp
import pytest
import torch

import mxnet_tpu as mj
import mxnet_tpu_torch as mt
from mxnet_tpu.gluon import rnn as jrnn
from mxnet_tpu.ops import nn as jnn
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon import rnn as trnn
from mxnet_tpu_torch.ops import nn as tnn
from test_torch_jax_globals import jax_globals  # noqa: F401

ATOL = 1e-5      # forward values
GRAD_TOL = 1e-4  # gradients, rel Frobenius


@pytest.fixture(autouse=True)
def _port_on_cpu():
    with mt.cpu():
        yield


def rel_fro(got, want):
    g, w = onp.asarray(got, onp.float64), onp.asarray(want, onp.float64)
    return onp.linalg.norm(g - w) / max(onp.linalg.norm(w), 1e-30)


def _n_params(mode, L, D, I, H):
    G = tnn._RNN_GATES[mode]
    n = sum(D * (G * H * (I if l == 0 else H * D) + G * H * H)
            for l in range(L))
    return n + L * D * 2 * G * H


OP_CASES = [(m, L, bi, None) for m in ('rnn_relu', 'rnn_tanh', 'lstm', 'gru')
            for L in (1, 2) for bi in (False, True)] + \
    [('lstm', 2, True, (-0.3, 0.4)), ('lstm', 1, False, (-0.2, 0.2))]


@pytest.mark.parametrize('mode,L,bi,clip', OP_CASES)
def test_rnn_op_matches_jax(mode, L, bi, clip):
    T, N, I, H = 5, 3, 4, 6
    D = 2 if bi else 1
    rng = onp.random.RandomState(7)
    x = rng.randn(T, N, I).astype(onp.float32)
    p = (rng.randn(_n_params(mode, L, D, I, H)) * 0.4).astype(onp.float32)
    h0 = rng.randn(L * D, N, H).astype(onp.float32)
    c0 = rng.randn(L * D, N, H).astype(onp.float32) if mode == 'lstm' \
        else None
    kw = dict(state_size=H, num_layers=L, mode=mode, bidirectional=bi)
    if clip is not None:
        kw.update(lstm_state_clip_min=clip[0], lstm_state_clip_max=clip[1])
    n_out = 3 if mode == 'lstm' else 2
    outs_shape = [(T, N, H * D)] + [(L * D, N, H)] * (n_out - 1)
    cot = [rng.randn(*s).astype(onp.float32) for s in outs_shape]

    def jloss(x, p, h0, c0):
        outs = jnn.rnn(x, p, h0, c0, **kw)
        return sum(jnp.sum(o * c) for o, c in zip(outs, cot)), outs

    args = [jnp.asarray(a) for a in (x, p, h0)] + \
        [jnp.asarray(c0) if c0 is not None else None]
    argnums = (0, 1, 2, 3) if c0 is not None else (0, 1, 2)
    (_, jouts), jgrads = jax.value_and_grad(jloss, argnums, has_aux=True)(
        *args)

    targs = [torch.tensor(a, requires_grad=True) for a in (x, p, h0)] + \
        ([torch.tensor(c0, requires_grad=True)] if c0 is not None else [])
    touts = tnn.rnn(*targs[:3], targs[3] if c0 is not None else None, **kw)
    assert len(touts) == n_out
    for j, t, s in zip(jouts, touts, outs_shape):
        assert tuple(t.shape) == s
        onp.testing.assert_allclose(t.detach().numpy(), onp.asarray(j),
                                    rtol=0, atol=ATOL)
    sum((o * torch.from_numpy(c)).sum() for o, c in zip(touts, cot)
        ).backward()
    for name, t, j in zip(('data', 'params', 'state', 'state_cell'), targs,
                          jgrads):
        assert rel_fro(t.grad.numpy(), j) <= GRAD_TOL, name


def test_rnn_op_is_registered_under_the_jax_name():
    x = mt.nd.array(onp.ones((2, 1, 3), onp.float32))
    p = mt.nd.array(onp.full(_n_params('gru', 1, 1, 3, 2), 0.1, onp.float32))
    out, h = mt.nd.rnn(x, p, mt.nd.zeros((1, 1, 2)), state_size=2,
                       mode='gru')
    assert out.shape == (2, 1, 2) and h.shape == (1, 1, 2)


def test_rnn_dropout_draws_between_layers_at_its_rate():
    """Two identity relu layers: the second layer's output is the input
    times the inter-layer mask over keep. In autograd train mode about p
    of it is 0 and the rest input / keep; in predict mode nothing is
    dropped."""
    H, N, p = 128, 128, 0.5
    eye = onp.eye(H, dtype=onp.float32).reshape(-1)
    zeros = onp.zeros(H * H, onp.float32)
    params = onp.concatenate([eye, zeros, eye, zeros,
                              onp.zeros(4 * H, onp.float32)])
    x = onp.random.RandomState(3).rand(1, N, H).astype(onp.float32) + 0.5
    args = (mt.nd.array(x), mt.nd.array(params), mt.nd.zeros((2, N, H)))
    kw = dict(state_size=H, num_layers=2, mode='rnn_relu', p=p)
    gen = mt.random.generator(torch.device('cpu'))
    state = gen.get_state()
    with mt.autograd.train_mode():
        out = mt.nd.rnn(*args, **kw)[0].asnumpy()
    gen.set_state(state)
    ratio = out / x
    dropped = ratio == 0
    assert abs(dropped.mean() - p) < 0.02, dropped.mean()
    onp.testing.assert_allclose(ratio[~dropped], 1 / (1 - p), rtol=1e-6)
    with mt.autograd.predict_mode():
        onp.testing.assert_allclose(mt.nd.rnn(*args, **kw)[0].asnumpy(), x,
                                    rtol=1e-6)


def _values(net):
    return {k: p.data().asnumpy()
            for k, p in net._collect_params_with_prefix().items()}


def _carry(jnet, tnet):
    src, dst = _values(jnet), tnet._collect_params_with_prefix()
    assert sorted(src) == sorted(dst)
    for k, v in src.items():
        assert tuple(dst[k].shape) == v.shape, k
        dst[k].set_data(mt.nd.array(v))


LAYER_CASES = [(cls, bi, layout) for cls in ('RNN', 'LSTM', 'GRU')
               for bi in (False, True) for layout in ('TNC', 'NTC')]


@pytest.mark.parametrize('cls,bi,layout', LAYER_CASES)
def test_layer_matches_jax(cls, bi, layout):
    H, L, T, N, I = 6, 2, 5, 3, 4
    kw = dict(num_layers=L, bidirectional=bi, layout=layout)
    if cls == 'RNN':
        kw['activation'] = 'tanh'
    jnet, tnet = getattr(jrnn, cls)(H, **kw), getattr(trnn, cls)(H, **kw)
    jnet.initialize(mj.init.Xavier())
    tnet.initialize(mt.init.Xavier())
    rng = onp.random.RandomState(5)
    shape = (T, N, I) if layout == 'TNC' else (N, T, I)
    x = rng.randn(*shape).astype(onp.float32)
    # the first forward places the deferred input weights
    jnet(mj.nd.array(x))
    tnet(mt.nd.array(x))
    _carry(jnet, tnet)
    names = sorted(dict(tnet.named_parameters()))
    want = sorted(f'{d}{j}_{k}' for j in range(L) for d in 'lr'[:1 + bi]
                  for k in ('i2h_weight', 'h2h_weight', 'i2h_bias',
                            'h2h_bias'))
    assert names == want
    states = [rng.randn(*s['shape']).astype(onp.float32)
              for s in jnet.state_info(N)]
    jx, tx = mj.nd.array(x), mt.nd.array(x)
    jst = [mj.nd.array(s) for s in states]
    tst = [mt.nd.array(s) for s in states]
    with mj.autograd.record():
        jout, jnew = jnet(jx, jst)
        jl = (jout * jout).sum() + sum((s * s).sum() for s in jnew)
    jl.backward()
    with mt.autograd.record():
        tout, tnew = tnet(tx, tst)
        tl = (tout * tout).sum() + sum((s * s).sum() for s in tnew)
    tl.backward()
    onp.testing.assert_allclose(tout.asnumpy(), jout.asnumpy(), rtol=0,
                                atol=ATOL)
    for a, b in zip(tnew, jnew):
        onp.testing.assert_allclose(a.asnumpy(), b.asnumpy(), rtol=0,
                                    atol=ATOL)
    jp = jnet._collect_params_with_prefix()
    for k, p in tnet._collect_params_with_prefix().items():
        assert rel_fro(p.grad().asnumpy(), jp[k].grad().asnumpy()) \
            <= GRAD_TOL, k
    # without states: the output alone, from zeros
    onp.testing.assert_allclose(tnet(tx).asnumpy(), jnet(jx).asnumpy(),
                                rtol=0, atol=ATOL)


def test_layer_begin_state_and_repr():
    net = trnn.LSTM(8, num_layers=3, bidirectional=True, input_size=4)
    net.initialize()
    h, c = net.begin_state(5, ctx=mt.cpu())
    assert h.shape == c.shape == (6, 5, 8)
    assert repr(net) == repr(jrnn.LSTM(8, num_layers=3, bidirectional=True,
                                       input_size=4))
    with pytest.raises(AssertionError):
        trnn.GRU(4, layout='CTN')


CELLS = {
    'rnn_tanh': lambda m, **kw: m.RNNCell(5, **kw),
    'rnn_relu': lambda m, **kw: m.RNNCell(5, activation='relu', **kw),
    'lstm': lambda m, **kw: m.LSTMCell(5, **kw),
    'gru': lambda m, **kw: m.GRUCell(5, **kw),
    'sequential': lambda m, **kw: _seq(m),
    'residual': lambda m, **kw: m.ResidualCell(m.GRUCell(3, **kw)),
    'zoneout_off': lambda m, **kw: m.ZoneoutCell(m.LSTMCell(5, **kw)),
    'bidirectional': lambda m, **kw: m.BidirectionalCell(
        m.LSTMCell(4, prefix='l_'), m.LSTMCell(4, prefix='r_')),
}


def _seq(m):
    stack = m.SequentialRNNCell()
    with stack.name_scope():
        stack.add(m.LSTMCell(5))
        stack.add(m.DropoutCell(0.0))
        stack.add(m.GRUCell(4))
    return stack


def _unroll(cell, pkg, x, layout, valid):
    args = dict(layout=layout, merge_outputs=True)
    if valid is not None:
        args['valid_length'] = pkg.nd.array(valid)
    return cell.unroll(4, pkg.nd.array(x), **args)


@pytest.mark.parametrize('name', sorted(CELLS))
@pytest.mark.parametrize('layout,valid', [('NTC', None), ('TNC', None),
                                          ('NTC', [4, 2])])
def test_cell_unroll_matches_jax(name, layout, valid):
    jcell, tcell = CELLS[name](jrnn), CELLS[name](trnn)
    jcell.initialize(mj.init.Xavier())
    tcell.initialize(mt.init.Xavier())
    x = onp.random.RandomState(2).randn(
        *((2, 4, 3) if layout == 'NTC' else (4, 2, 3))).astype(onp.float32)
    _unroll(jcell, mj, x, layout, valid)
    _unroll(tcell, mt, x, layout, valid)
    _carry(jcell, tcell)
    jout, jst = _unroll(jcell, mj, x, layout, valid)
    tout, tst = _unroll(tcell, mt, x, layout, valid)
    onp.testing.assert_allclose(tout.asnumpy(), jout.asnumpy(), rtol=0,
                                atol=ATOL)
    assert len(tst) == len(jst)
    for a, b in zip(tst, jst):
        onp.testing.assert_allclose(a.asnumpy(), b.asnumpy(), rtol=0,
                                    atol=ATOL)


@pytest.mark.parametrize('cls', ['RNN', 'LSTM', 'GRU'])
def test_unfuse_matches_the_fused_layer(cls):
    """A unidirectional layer's ``_unfuse()`` shares its parameters and
    unrolls to its output (the JAX package's property, in the port)."""
    net = getattr(trnn, cls)(6, num_layers=2, input_size=4)
    net.initialize(mt.init.Xavier())
    x = onp.random.RandomState(4).randn(5, 3, 4).astype(onp.float32)
    fused = net(mt.nd.array(x)).asnumpy()
    stack = net._unfuse()
    assert {id(p) for p in stack.collect_params().values()} == \
        {id(p) for p in net.collect_params().values()}
    out, _ = stack.unroll(5, mt.nd.array(x), layout='TNC',
                          merge_outputs=True)
    onp.testing.assert_allclose(out.asnumpy(), fused, rtol=0, atol=ATOL)


@pytest.mark.parametrize('cls', ['RNN', 'LSTM', 'GRU'])
def test_bidirectional_unfuse_cannot_be_unrolled_as_in_jax(cls):
    """Reference fault the port mirrors (ROADMAP queue 3): the stack a
    bidirectional layer unfuses to steps its BidirectionalCell, which
    raises, in both packages; MXNet unrolls cell by cell."""
    x = onp.ones((3, 2, 4), onp.float32)
    for pkg, mod in ((mj, jrnn), (mt, trnn)):
        net = getattr(mod, cls)(5, num_layers=2, bidirectional=True,
                                input_size=4)
        net.initialize()
        stack = net._unfuse()
        with pytest.raises(Exception, match='Bidirectional cannot be '
                                            'stepped'):
            stack.unroll(3, pkg.nd.array(x), layout='TNC')
    with pytest.raises(MXNetError):
        trnn.BidirectionalCell(trnn.GRUCell(2), trnn.GRUCell(2))(
            mt.nd.array(x[0]), [])
