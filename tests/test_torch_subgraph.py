"""The port's subgraph backends (``mxnet_tpu_torch.subgraph``:
``hybridize(backend=...)``, ``optimize_for``, ``fuse_attention``)
against the JAX package's, on the CPU.

tests/test_subgraph.py's NaiveAttentionBlock, re-written for the port
(its forward takes tensors: ``nd.split`` for ``qkv.split``, ``permute``
for ``transpose``, the mask built with torch on x's device), and the JAX
block itself carry the same weights (by structured name). The fused
forward and backward are held against the unfused ones and against the
JAX fused block (its Pallas kernel in interpret mode, as
tests/test_subgraph.py runs it); ``stats['matches']`` counts a trace per
call signature in both packages. On the CPU the port's fused program
runs ``flash_attention``'s plain version; on the card the same program
runs kernel A forward and K2/K3 backward (tests/test_torch_sym_cuda.py).

Tolerance: f32, rtol 1e-4, atol 1e-5 (the JAX test's bounds: the flash
arithmetic sums in another order).
"""
import numpy as onp
import pytest
import torch

import mxnet_tpu as mj
import mxnet_tpu_torch as mt
from mxnet_tpu_torch import autograd, nd
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon import nn
from mxnet_tpu_torch.gluon.block import HybridBlock
from test_torch_jax_globals import jax_globals  # noqa: F401

RTOL, ATOL = 1e-4, 1e-5


@pytest.fixture(autouse=True)
def _port_on_cpu():
    with mt.cpu():
        yield


class NaiveAttentionBlock(HybridBlock):
    """tests/test_subgraph.py's block for the port: attention written by
    hand with separate ops. ``mask`` picks the additive key mask of the
    JAX test ('add'), a select mask ('where', 'masked_fill'), or none;
    ``k_transposed`` hands the product K already transposed."""

    def __init__(self, hidden, heads, mask=None, k_transposed=False,
                 **kwargs):
        super().__init__(**kwargs)
        self._h = heads
        self._mask = mask
        self._kt = k_transposed
        with self.name_scope():
            self.qkv = nn.Dense(3 * hidden, flatten=False, in_units=hidden)
            self.proj = nn.Dense(hidden, flatten=False, in_units=hidden)

    def forward(self, x, valid_len=None):
        N, T, C = x.shape
        H = self._h
        D = C // H
        q, k, v = nd.split(self.qkv(x), num_outputs=3, axis=-1)
        q = q.reshape(N, T, H, D).permute(0, 2, 1, 3)
        k = k.reshape(N, T, H, D).permute(0, 2, 1, 3)
        v = v.reshape(N, T, H, D).permute(0, 2, 1, 3)
        if self._kt:
            scores = nd.batch_dot(q, k.transpose(-1, -2).contiguous())
        else:
            scores = nd.batch_dot(q, k, transpose_b=True)
        scores = scores / (D ** 0.5)
        if self._mask and valid_len is not None:
            keep = torch.arange(T, device=x.device).reshape(1, 1, 1, T) < \
                valid_len.reshape(-1, 1, 1, 1)
            if self._mask == 'add':
                big = torch.full((1, 1, 1, 1), -1e30, dtype=x.dtype,
                                 device=x.device)
                scores = scores + (1.0 - keep.to(x.dtype)) * big
            elif self._mask == 'where':
                scores = torch.where(keep, scores,
                                     torch.tensor(-1e30, dtype=x.dtype))
            else:
                scores = scores.masked_fill(~keep, -1e30)
        att = nd.softmax(scores, axis=-1)
        out = nd.batch_dot(att, v)
        return self.proj(out.permute(0, 2, 1, 3).reshape(N, T, C))


def _jax_block(masked):
    import sys
    import os
    sys.path.insert(0, os.path.dirname(__file__))
    from test_subgraph import NaiveAttentionBlock as JaxBlock
    blk = JaxBlock(32, 4, masked=masked)
    blk.initialize(mj.init.Xavier())
    return blk


def _pair(mask=None, **kw):
    """A port block and the JAX block with the port's weights."""
    mt.random.seed(5)
    blk = NaiveAttentionBlock(32, 4, mask=mask, **kw)
    blk.initialize(mt.init.Xavier())
    jblk = _jax_block(mask is not None)
    jparams = jblk._collect_params_with_prefix()
    for name, p in blk._collect_params_with_prefix().items():
        jparams[name].set_data(p.data().asnumpy())
    return blk, jblk


def _x(seed, shape=(2, 16, 32)):
    return onp.random.RandomState(seed).randn(*shape).astype(onp.float32)


VLEN = onp.array([11, 16], onp.float32)


def test_fuse_attention_backend_matches_unfused_and_jax():
    x = _x(0)
    blk, jblk = _pair()
    ref = blk(nd.array(x)).asnumpy()
    blk.hybridize(backend='fuse_attention')
    out = blk(nd.array(x)).asnumpy()
    assert blk._subgraph_backend.stats['matches'] == 1
    onp.testing.assert_allclose(out, ref, rtol=RTOL, atol=ATOL)
    jblk.hybridize(backend='fuse_attention')
    jout = jblk(mj.nd.array(x)).asnumpy()
    assert jblk._subgraph_backend.stats['matches'] >= 1
    onp.testing.assert_allclose(out, jout, rtol=RTOL, atol=ATOL)


def test_fuse_attention_backward_matches_unfused_and_jax():
    x = _x(1, (2, 8, 32))
    grads = {}
    for backend in (None, 'fuse_attention'):
        blk, jblk = _pair()
        for pkg, b in ((mt, blk), (mj, jblk))[:2 if backend else 1]:
            if backend:
                b.hybridize(backend=backend)
            xx = pkg.nd.array(x)
            xx.attach_grad()
            with pkg.autograd.record():
                y = (b(xx) ** 2).sum()
            y.backward()
            qkv = b._collect_params_with_prefix()['qkv.weight']
            grads[(pkg is mt, backend)] = (xx.grad.asnumpy(),
                                           qkv.grad().asnumpy())
    want = grads[(True, None)]
    for key, got in grads.items():
        for g, w in zip(got, want):
            onp.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL,
                                        err_msg=str(key))


def test_unknown_backend_rejected():
    blk, _ = _pair()
    with pytest.raises(MXNetError, match='not registered'):
        blk.hybridize(backend='definitely_not_a_backend')
    with pytest.raises(mj.MXNetError, match='not registered'):
        _jax_block(False).hybridize(backend='definitely_not_a_backend')
    assert mt.subgraph.list_backends() == ['fuse_attention']


def test_backend_noop_on_unmatched_graph():
    net = nn.HybridSequential()
    net.add(nn.Dense(8, in_units=4), nn.Dense(2))
    net.initialize(mt.init.Xavier())
    x = nd.ones((2, 4))
    ref = net(x).asnumpy()
    net.hybridize(backend='fuse_attention')
    out = net(x).asnumpy()
    onp.testing.assert_allclose(out, ref, atol=1e-6)
    assert net._subgraph_backend.stats['matches'] == 0


@pytest.mark.parametrize('mask', ['add', 'where', 'masked_fill'])
def test_fuse_attention_with_a_key_mask(mask):
    """An additive key-padding mask (the JAX test's), or a select mask,
    reaches flash_attention's key_mask: fused against unfused, and the
    additive case against the JAX fused block."""
    x = _x(2)
    blk, jblk = _pair(mask=mask)
    ref = blk(nd.array(x), nd.array(VLEN)).asnumpy()
    blk.hybridize(backend='fuse_attention')
    out = blk(nd.array(x), nd.array(VLEN)).asnumpy()
    assert blk._subgraph_backend.stats['matches'] == 1
    onp.testing.assert_allclose(out, ref, rtol=RTOL, atol=ATOL)
    if mask == 'add':
        jblk.hybridize(backend='fuse_attention')
        jout = jblk(mj.nd.array(x), mj.nd.array(VLEN)).asnumpy()
        onp.testing.assert_allclose(out, jout, rtol=RTOL, atol=ATOL)


def test_fuse_attention_with_k_given_transposed():
    x = _x(3)
    blk, _ = _pair(k_transposed=True)
    ref = blk(nd.array(x)).asnumpy()
    out = blk.optimize_for(nd.array(x), backend='fuse_attention').asnumpy()
    assert blk._subgraph_backend.stats['matches'] == 1
    onp.testing.assert_allclose(out, ref, rtol=RTOL, atol=ATOL)


class GivenKtAttention(HybridBlock):
    """Attention over q (B, H, T, D), K already transposed (B, H, D, Tk)
    and v, all three inputs of the block: no transpose in the trace for
    the matcher to walk back through."""

    def forward(self, q, kt, v):
        scores = nd.batch_dot(q, kt) / (q.shape[-1] ** 0.5)
        return nd.batch_dot(nd.softmax(scores, axis=-1), v)


def test_fuse_attention_with_contiguous_k_given_transposed(monkeypatch):
    """A contiguous pre-transposed K takes the matcher's k_transposed
    route, and flash_attention gets K with a unit stride on D, as the
    kernels need: fused against unfused and against numpy."""
    from mxnet_tpu_torch.ops import flash_attention as fa
    rng = onp.random.RandomState(6)
    q, kt, v = (rng.randn(*s).astype(onp.float32) for s in
                ((2, 2, 8, 16), (2, 2, 16, 12), (2, 2, 12, 16)))
    blk = GivenKtAttention()
    ref = blk(nd.array(q), nd.array(kt), nd.array(v)).asnumpy()
    seen, real = [], fa.flash_attention

    def spy(q, k, v, **kw):
        seen.append((tuple(k.shape), k.stride(-1)))
        return real(q, k, v, **kw)
    monkeypatch.setattr(fa, 'flash_attention', spy)
    blk.hybridize(backend='fuse_attention')
    out = blk(nd.array(q), nd.array(kt), nd.array(v)).asnumpy()
    assert blk._subgraph_backend.stats['matches'] == 1
    prog, = blk._subgraph_backend._programs.values()
    fused, = [n for n in prog.graph.nodes
              if n.op == 'call_function' and
              '_fused_attention' in str(n.target)]
    assert fused.args[8] is True                # k_transposed
    assert seen == [((2, 2, 12, 16), 1)]
    s = onp.einsum('bhqd,bhdk->bhqk', q, kt) / 4.0
    p = onp.exp(s - s.max(-1, keepdims=True))
    want = onp.einsum('bhqk,bhkd->bhqd', p / p.sum(-1, keepdims=True), v)
    onp.testing.assert_allclose(out, ref, rtol=RTOL, atol=ATOL)
    onp.testing.assert_allclose(out, want, rtol=RTOL, atol=ATOL)


def test_fused_program_runs_the_flash_function():
    """The rewritten program calls flash_attention in place of the chain:
    no softmax and no batched product with V are left in it."""
    blk, _ = _pair(mask='add')
    blk.hybridize(backend='fuse_attention')
    blk(nd.array(_x(4)), nd.array(VLEN))
    prog, = blk._subgraph_backend._programs.values()
    targets = [str(n.target) for n in prog.graph.nodes
               if n.op == 'call_function']
    assert any('_fused_attention' in t for t in targets)
    assert not any('softmax' in t for t in targets)
    assert not any('bmm' in t for t in targets)


def test_matches_count_once_per_call_signature_as_jax():
    """A trace per new signature: same shape twice (1), a new shape (2),
    under autograd.record (3), again (3), in both packages."""
    counts = {}
    for pkg in (mt, mj):
        blk, jblk = _pair()
        b = blk if pkg is mt else jblk
        b.hybridize(backend='fuse_attention')
        seen = []
        x = pkg.nd.array(_x(0, (2, 16, 32)))
        b(x)
        b(x)
        seen.append(b._subgraph_backend.stats['matches'])
        b(pkg.nd.array(_x(0, (3, 16, 32))))
        seen.append(b._subgraph_backend.stats['matches'])
        x.attach_grad()
        for _ in range(2):
            with pkg.autograd.record():
                y = b(x).sum()
            y.backward()
            seen.append(b._subgraph_backend.stats['matches'])
        counts[pkg is mt] = seen
    assert counts[True] == counts[False] == [1, 2, 3, 3]


def test_backend_refuses_a_forward_that_draws_random_numbers():
    """A traced program would repeat one dropout draw: the backend names
    the draw and refuses."""
    class Dropped(HybridBlock):
        def __init__(self):
            super().__init__()
            with self.name_scope():
                self.drop = nn.Dropout(0.5)

        def forward(self, x):
            return self.drop(x)
    blk = Dropped()
    blk.hybridize(backend='fuse_attention')
    x = nd.ones((2, 4))
    out = blk(x)                        # predict mode: no draw, runs
    onp.testing.assert_array_equal(out.asnumpy(), 1.0)
    with pytest.raises(MXNetError, match='draws random numbers'):
        with autograd.record():
            blk(x)


def test_batchnorm_running_stats_move_through_the_fused_program():
    """The rewritten program keeps the in-place writes of the forward: a
    BatchNorm ahead of the attention updates its running statistics as
    it does unfused."""
    class Normed(HybridBlock):
        def __init__(self):
            super().__init__()
            with self.name_scope():
                self.bn = nn.BatchNorm(axis=-1, in_channels=32)
                self.att = NaiveAttentionBlock(32, 4)

        def forward(self, x):
            return self.att(self.bn(x))
    x = _x(5)
    stats = []
    for backend in (None, 'fuse_attention'):
        mt.random.seed(5)
        blk = Normed()
        blk.initialize(mt.init.Xavier())
        if backend:
            blk.hybridize(backend=backend)
        xx = nd.array(x)
        with autograd.record():
            blk(xx).sum().backward()
        stats.append(blk.bn.running_mean.data().asnumpy())
    assert not onp.allclose(stats[0], 0)
    onp.testing.assert_allclose(stats[1], stats[0], rtol=1e-6)
