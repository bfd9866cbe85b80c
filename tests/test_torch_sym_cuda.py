"""The symbolic API on the card against its runs on the CPU, at small
sizes: the Executor's forward and backward (a conv/BatchNorm/FC graph in
f32 with TF32 off; multi_head_attention in bf16 on the flash kernels),
group2ctx across the CPU and the card, Module.fit, and fuse_attention
running kernel A forward and K2/K3 backward, eagerly and as a captured
block.

These tests need a CUDA device and carry the ``cuda`` marker; without a
card they skip. On the card, from the root of the checkout (the file
imports only torch, numpy and the port, so the JAX conftest is left out):

    python -m pytest --noconftest -m cuda tests/test_torch_sym_cuda.py

f32 values within rel 1e-5 and gradients within rel Frobenius 1e-4; bf16
attention within rel Frobenius 0.05 of f32 on the CPU; launch counts
exact.
"""
import numpy as onp
import pytest
import torch

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import nd
from mxnet_tpu_torch.gluon import nn
from mxnet_tpu_torch.gluon.block import HybridBlock

pytestmark = pytest.mark.cuda


@pytest.fixture(autouse=True)
def card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield


def rel_fro(got, want):
    g = torch.as_tensor(got).double().cpu()
    w = torch.as_tensor(want).double().cpu()
    return float((g - w).norm() / w.norm().clamp_min(1e-30))


def conv_net(sym):
    x = sym.Variable('data')
    c = sym.Convolution(x, kernel=(3, 3), num_filter=4, pad=(1, 1),
                        name='c1')
    bn = sym.BatchNorm(c, fix_gamma=False, name='bn1')
    a = sym.Activation(bn[0], act_type='tanh', name='act')
    f = sym.FullyConnected(sym.Flatten(a), num_hidden=3, name='fc')
    return sym.SoftmaxOutput(f, sym.Variable('softmax_label'), name='sm')


def _bind(ctx, shapes, vals):
    exe = conv_net(mx.sym).simple_bind(ctx, **shapes)
    for n, v in vals.items():
        arr = exe.arg_dict[n] if n in exe.arg_dict else exe.aux_dict[n]
        arr._data = torch.from_numpy(v).to(arr._data.device)
    return exe


def test_executor_step_on_the_card_matches_the_cpu():
    shapes = dict(data=(4, 3, 8, 8), softmax_label=(4,))
    probe = conv_net(mx.sym).simple_bind(mx.cpu(), **shapes)
    rng = onp.random.RandomState(0)
    vals = {n: (rng.randn(*a.shape) * 0.3).astype('f')
            for n, a in probe.arg_dict.items()}
    vals['softmax_label'] = rng.randint(0, 3, 4).astype('f')
    outs, grads, aux = [], [], []
    for ctx in (mx.gpu(0), mx.cpu()):
        exe = _bind(ctx, shapes, vals)
        outs.append(exe.forward(is_train=True)[0].asnumpy())
        exe.backward()
        grads.append({n: g.asnumpy() for n, g in exe.grad_dict.items()})
        aux.append({n: a.asnumpy() for n, a in exe.aux_dict.items()})
        assert exe.arg_dict['data']._data.device.type == \
            ('cuda' if ctx.device_type == 'gpu' else 'cpu')
    onp.testing.assert_allclose(outs[0], outs[1], rtol=1e-5, atol=1e-6)
    for n in grads[1]:
        if n in ('softmax_label', 'c1_bias'):
            continue
        assert rel_fro(grads[0][n], grads[1][n]) < 1e-4, n
    for n in aux[1]:
        onp.testing.assert_allclose(aux[0][n], aux[1][n], rtol=1e-5)


def test_simple_bind_defaults_to_the_card():
    exe = mx.sym.sin(mx.sym.Variable('x')).simple_bind(x=(2,))
    assert exe.arg_dict['x']._data.is_cuda
    mod = mx.module.Module(conv_net(mx.sym))
    mod.bind(data_shapes=[('data', (2, 3, 8, 8))],
             label_shapes=[('softmax_label', (2,))])
    assert mod._execs[0].arg_dict['c1_weight']._data.is_cuda


def test_group2ctx_across_the_cpu_and_the_card():
    """Each group's nodes run on its device: an output on the card from a
    group on the CPU, gradients back across, equal to an ungrouped run."""
    x = mx.sym.Variable('x')
    with mx.AttrScope(ctx_group='host'):
        h = mx.sym.FullyConnected(x, mx.sym.Variable('w1'), None,
                                  num_hidden=8, no_bias=True, name='fc1')
    with mx.AttrScope(ctx_group='card'):
        out = mx.sym.FullyConnected(mx.sym.tanh(h), mx.sym.Variable('w2'),
                                    None, num_hidden=4, no_bias=True,
                                    name='fc2')
    shapes = dict(x=(2, 16), w1=(8, 16), w2=(4, 8))
    rng = onp.random.RandomState(1)
    vals = {n: rng.randn(*s).astype('f') for n, s in shapes.items()}
    res = []
    for groups in ({'host': mx.cpu(), 'card': mx.gpu(0)}, None):
        exe = out.simple_bind(mx.gpu(0), group2ctx=groups, **shapes)
        for n, v in vals.items():
            arr = exe.arg_dict[n]
            arr._data = torch.from_numpy(v).to(arr._data.device)
        if groups:
            assert exe.arg_dict['w1']._data.device.type == 'cpu'
        y = exe.forward(is_train=True)[0]
        assert y._data.is_cuda
        exe.backward()
        res.append((y.asnumpy(), exe.grad_dict['w1'].asnumpy()))
    onp.testing.assert_allclose(res[0][0], res[1][0], rtol=1e-5)
    onp.testing.assert_allclose(res[0][1], res[1][1], rtol=1e-5)


def test_symbolic_attention_launches_the_flash_kernels():
    """multi_head_attention in a bf16 graph: one forward launches A once,
    its backward K2 and K3 once each; output within 0.05 of f32 on the
    CPU."""
    q = mx.sym.Variable('q')
    k = mx.sym.Variable('k')
    v = mx.sym.Variable('v')
    att = mx.sym.multi_head_attention(q, k, v, num_heads=2, name='att')
    shapes = dict(q=(2, 64, 128), k=(2, 64, 128), v=(2, 64, 128))
    rng = onp.random.RandomState(2)
    vals = {n: rng.randn(*s).astype('f') for n, s in shapes.items()}
    outs = []
    for ctx, dtype in ((mx.gpu(0), 'bfloat16'), (mx.cpu(), 'float32')):
        exe = att.simple_bind(ctx, type_dict=dict.fromkeys(shapes, dtype),
                              **shapes)
        mx.ops.reset_launch_counts()
        y = exe.forward(is_train=True, **vals)[0]
        fwd = {n: c for n, c in mx.ops.launch_counts.items() if c}
        mx.ops.reset_launch_counts()
        exe.backward()
        bwd = {n: c for n, c in mx.ops.launch_counts.items() if c}
        if ctx.device_type == 'gpu':
            assert fwd == {'flash_attn_fwd': 1}
            assert bwd == {'flash_attn_bwd_dq': 1, 'flash_attn_bwd_dkv': 1}
        outs.append(y.asnumpy().astype('f'))
    assert rel_fro(outs[0], outs[1]) < 0.05


def test_module_fit_on_the_card_matches_the_cpu():
    rng = onp.random.RandomState(3)
    X = rng.randn(16, 3, 8, 8).astype('f')
    Y = (onp.arange(16) % 3).astype('f')
    probe = conv_net(mx.sym).simple_bind(mx.cpu(), data=(8, 3, 8, 8),
                                         softmax_label=(8,))
    args = {n: (rng.randn(*a.shape) * 0.3).astype('f')
            for n, a in probe.arg_dict.items()
            if n not in ('data', 'softmax_label')}
    got = []
    for ctx in (mx.gpu(0), mx.cpu()):
        with ctx:
            it = mx.io.NDArrayIter(X, Y, batch_size=8)
        mod = mx.module.Module(conv_net(mx.sym), context=ctx)
        mod.fit(it, num_epoch=2, optimizer_params={'learning_rate': 0.1,
                                                   'momentum': 0.9},
                arg_params={n: mx.nd.array(v, ctx=mx.cpu())
                            for n, v in args.items()})
        got.append({n: v.asnumpy() for n, v in mod.get_params()[0].items()})
    for n in args:
        if n != 'c1_bias':
            assert rel_fro(got[0][n], got[1][n]) < 1e-4, n


class NaiveAttention(HybridBlock):
    def __init__(self, hidden, heads, **kwargs):
        super().__init__(**kwargs)
        self._h = heads
        with self.name_scope():
            self.qkv = nn.Dense(3 * hidden, flatten=False, in_units=hidden)

    def forward(self, x):
        N, T, C = x.shape
        D = C // self._h
        q, k, v = nd.split(self.qkv(x), num_outputs=3, axis=-1)
        q, k, v = (t.reshape(N, T, self._h, D).permute(0, 2, 1, 3)
                   for t in (q, k, v))
        att = nd.softmax(nd.batch_dot(q, k, transpose_b=True) / D ** 0.5,
                         axis=-1)
        return nd.batch_dot(att, v).permute(0, 2, 1, 3).reshape(N, T, C)


def test_fuse_attention_runs_the_flash_kernels_eagerly():
    """The backend's program on card tensors: A in the forward, K2 and K3
    in the backward, against the unfused block in bf16."""
    mx.random.seed(4)
    blk = NaiveAttention(128, 2)
    blk.initialize(mx.init.Normal(0.02), ctx=mx.gpu(0))
    blk.cast('bfloat16')
    x = torch.from_numpy(onp.random.RandomState(5).randn(2, 64, 128)) \
        .to('cuda', torch.bfloat16).requires_grad_()
    ref = blk(x)
    backend = mx.subgraph.get_backend('fuse_attention')
    mx.ops.reset_launch_counts()
    out = backend.run(blk, [x])
    assert backend.stats['matches'] == 1
    assert mx.ops.launch_counts['flash_attn_fwd'] == 1
    assert rel_fro(out.float(), ref.float()) < 0.05
    out.float().sum().backward()
    assert mx.ops.launch_counts['flash_attn_bwd_dq'] == 1
    assert mx.ops.launch_counts['flash_attn_bwd_dkv'] == 1


def test_fuse_attention_captures_as_the_blocks_graph():
    """Hybridized with the backend, the block's rewritten program is
    captured: the kernels launch at the capture, a replay matches the
    eager program, and nothing is traced again."""
    mx.random.seed(4)
    blk = NaiveAttention(128, 2)
    blk.initialize(mx.init.Normal(0.02), ctx=mx.gpu(0))
    blk.cast('bfloat16')
    x = mx.nd.array(onp.random.RandomState(5).randn(2, 64, 128),
                    ctx=mx.gpu(0), dtype='bfloat16')
    ref = blk(x).asnumpy()
    blk.hybridize(backend='fuse_attention')
    mx.ops.reset_launch_counts()
    first = blk(x).asnumpy()
    launched = mx.ops.launch_counts['flash_attn_fwd']
    again = blk(x).asnumpy()
    assert launched >= 1 and mx.ops.launch_counts['flash_attn_fwd'] == \
        launched
    assert blk._cached_op.num_graphs == 1
    assert blk._subgraph_backend.stats['matches'] == 1
    assert onp.array_equal(first, again)
    assert rel_fro(again, ref) < 0.05


class GivenKtAttention(HybridBlock):
    """q (B, H, T, D), K already transposed (B, H, D, Tk) and v as the
    block's inputs: the matcher's k_transposed route."""

    def forward(self, q, kt, v):
        scores = nd.batch_dot(q, kt) / (q.shape[-1] ** 0.5)
        return nd.batch_dot(nd.softmax(scores, axis=-1), v)


def test_fuse_attention_with_contiguous_k_given_transposed():
    """A contiguous (B, H, D, Tk) K reaches the kernels with a unit stride
    on D: A forward, K2 and K3 backward, against the unfused block."""
    rng = onp.random.RandomState(7)
    q, kt, v = (torch.from_numpy(rng.randn(*s)).to('cuda', torch.bfloat16)
                .requires_grad_() for s in
                ((2, 2, 64, 64), (2, 2, 64, 96), (2, 2, 96, 64)))
    blk = GivenKtAttention()
    ref = blk(q, kt, v)
    backend = mx.subgraph.get_backend('fuse_attention')
    mx.ops.reset_launch_counts()
    out = backend.run(blk, [q, kt, v])
    assert backend.stats['matches'] == 1
    prog, = backend._programs.values()
    fused, = [n for n in prog.graph.nodes if n.op == 'call_function' and
              '_fused_attention' in str(n.target)]
    assert fused.args[8] is True                # k_transposed
    assert mx.ops.launch_counts['flash_attn_fwd'] == 1
    assert rel_fro(out.float(), ref.float()) < 0.05
    g = torch.autograd.grad(out.float().sum(), kt)[0]
    g_ref = torch.autograd.grad(ref.float().sum(), kt)[0]
    assert mx.ops.launch_counts['flash_attn_bwd_dq'] == 1
    assert mx.ops.launch_counts['flash_attn_bwd_dkv'] == 1
    assert rel_fro(g.float(), g_ref.float()) < 0.05


def test_batch_norm_with_fixed_gamma_trains_on_the_card():
    """BatchNorm with gamma fixed at 1 (fix_gamma, Gluon's scale=False)
    trains on the card as on the CPU: the CUDA backward of
    ``native_batch_norm`` refuses a missing weight, so the op passes
    ones."""
    rng = onp.random.RandomState(6)
    x = rng.randn(4, 3, 5, 5).astype('f')
    g = rng.randn(4, 3, 5, 5).astype('f')
    grads = []
    for ctx in (mx.gpu(0), mx.cpu()):
        bn = nn.BatchNorm(scale=False, in_channels=3)
        bn.initialize(ctx=ctx)
        xs = mx.nd.array(x, ctx=ctx)
        xs.attach_grad()
        with mx.autograd.record():
            y = bn(xs)
        y.backward(mx.nd.array(g, ctx=ctx))
        grads.append((xs.grad.asnumpy(), bn.beta.grad().asnumpy()))
    for a, b in zip(*grads):
        assert rel_fro(a, b) < 1e-4
