"""The frontends of the port on the card against their runs on the CPU, at
small sizes: op libraries on card tensors (and a hybridized block that
calls one, run eagerly by its CachedOp), the torch bridge, ``Features``,
the profiler's device trace, an ONNX file imported onto the card,
``quantize_net`` of a conv net and SVRG's trajectory.

These tests need a CUDA device and carry the ``cuda`` marker; without a
card they skip. On the card, from the root of the checkout (the file
imports only torch, numpy and the port, so the JAX conftest is left out):

    python -m pytest --noconftest -m cuda tests/test_torch_frontends_cuda.py

f32 with TF32 off: values within rel 1e-5 (ONNX and quantized outputs
1e-4), the op library's outputs and the int8 weights bitwise.
"""
import json

import numpy as onp
import pytest
import torch

import mxnet_tpu_torch as mx

pytestmark = pytest.mark.cuda


@pytest.fixture(autouse=True)
def card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield


def rel(got, want):
    g = torch.as_tensor(onp.asarray(got)).double()
    w = torch.as_tensor(onp.asarray(want)).double()
    return float((g - w).norm() / w.norm().clamp_min(1e-30))


@pytest.fixture(scope='module')
def libpath(tmp_path_factory):
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv('MXTPU_COMPILE_CACHE_DIR',
                  str(tmp_path_factory.mktemp('build')))
        path = mx.library.example_library()
    mx.library.load(path)
    return path


@pytest.mark.parametrize('op, arrays', [
    ('my_relu', [onp.linspace(-3, 3, 24, dtype=onp.float32).reshape(4, 6)]),
    ('my_gemm', [onp.random.RandomState(0).randn(5, 7).astype(onp.float32),
                 onp.random.RandomState(1).randn(7, 3).astype(onp.float32)]),
    ('my_split2', [onp.arange(24, dtype=onp.int64).reshape(4, 6)])])
def test_op_library_on_the_card(libpath, op, arrays):
    outs = {}
    for ctx in (mx.gpu(0), mx.cpu()):
        res = getattr(mx.nd, op)(*[mx.nd.array(a, ctx=ctx, dtype=a.dtype)
                                   for a in arrays])
        res = res if isinstance(res, (list, tuple)) else [res]
        assert all(r.context == ctx for r in res)
        outs[ctx.device_type] = [r.asnumpy() for r in res]
    for g, c in zip(outs['gpu'], outs['cpu']):
        onp.testing.assert_array_equal(g, c)


def test_hybridized_block_with_a_host_op_runs_eagerly(libpath):
    class Net(mx.gluon.HybridBlock):
        def __init__(self):
            super().__init__()
            with self.name_scope():
                self.fc = mx.gluon.nn.Dense(6, in_units=4)

        def hybrid_forward(self, F, x):
            return F.my_relu(self.fc(x)) * 2.0

    net = Net()
    net.initialize(ctx=mx.gpu(0))
    x = mx.nd.array(onp.random.RandomState(2).randn(3, 4)
                    .astype(onp.float32), ctx=mx.gpu(0))
    eager = net(x).asnumpy()
    net.hybridize()
    first, second = net(x).asnumpy(), net(x).asnumpy()
    onp.testing.assert_array_equal(first, eager)
    onp.testing.assert_array_equal(second, eager)
    assert net._cached_op.num_eager == 1
    x.attach_grad()
    with mx.autograd.record():
        y = net(x)
    y.backward()
    assert net._cached_op.num_eager == 2
    assert onp.isfinite(x.grad.asnumpy()).all()


def test_bridge_shares_storage_and_torch_op_gradients_on_the_card():
    x_np = onp.random.RandomState(3).rand(3, 4).astype(onp.float32)
    a = mx.nd.array(x_np, ctx=mx.gpu(0))
    t = mx.torch.to_torch(a)
    assert t.is_cuda and t.data_ptr() == a._data.data_ptr()
    assert mx.torch.from_torch(t)._data.data_ptr() == t.data_ptr()
    torch.manual_seed(0)
    lin = torch.nn.Linear(4, 2).cuda()
    a.attach_grad()
    with mx.autograd.record():
        y = mx.torch.TorchOp(lin)(a)
        loss = (y * y).sum()
    loss.backward()
    ref = torch.nn.Linear(4, 2).cuda()
    ref.load_state_dict(lin.state_dict())
    tx = torch.from_numpy(x_np).cuda().requires_grad_()
    (ref(tx) ** 2).sum().backward()
    assert rel(a.grad.asnumpy(), tx.grad.cpu()) < 1e-5
    assert rel(lin.weight.grad.cpu(), ref.weight.grad.cpu()) < 1e-5


def test_features_on_the_card():
    f = mx.runtime.Features()
    assert f.is_enabled('CUDA') and f.is_enabled('CUDNN')
    assert not f.is_enabled('TPU') and not f.is_enabled('XLA')


def test_profiler_device_trace_holds_the_cards_kernels(tmp_path):
    mx.profiler.set_config(jax_trace_dir=str(tmp_path), profile_all=True,
                           filename=str(tmp_path / 'p.json'))
    try:
        mx.profiler.start()
        a = mx.nd.ones((64, 64), ctx=mx.gpu(0))
        for _ in range(3):
            mx.nd.dot(a, a)
        mx.profiler.stop()
        mx.profiler.dump()
    finally:
        mx.profiler.set_config(jax_trace_dir=None, profile_all=False,
                               filename='profile.json')
    with open(mx.profiler.device_trace_file()) as f:
        evs = json.load(f)['traceEvents']
    kernels = [e for e in evs if e.get('cat') == 'kernel']
    assert len(kernels) >= 3
    with open(tmp_path / 'p.json') as f:
        rows = [e for e in json.load(f)['traceEvents']
                if e.get('cat') == 'operator']
    assert [e['name'] for e in rows].count('dot') == 3


def _cnn(ctx, arrays=None):
    """A small conv net on ``ctx``; its weights ``arrays`` where given."""
    net = mx.gluon.nn.HybridSequential(prefix='cnn_')
    with net.name_scope():
        net.add(mx.gluon.nn.Conv2D(8, 3, padding=1, activation='relu',
                                   in_channels=3),
                mx.gluon.nn.BatchNorm(in_channels=8),
                mx.gluon.nn.MaxPool2D(2), mx.gluon.nn.Flatten(),
                mx.gluon.nn.Dense(5, in_units=128))
    mx.random.seed(5)
    net.initialize(mx.init.Xavier(), ctx=ctx)
    for n, p in net._collect_params_with_prefix().items():
        if arrays is not None:
            p.set_data(mx.nd.array(arrays[n], ctx=ctx))
    return net


def _arrays(net):
    return {n: p.data().asnumpy()
            for n, p in net._collect_params_with_prefix().items()}


def test_onnx_round_trip_onto_the_card(tmp_path):
    x = onp.random.RandomState(4).rand(2, 3, 8, 8).astype(onp.float32)
    net = _cnn(mx.gpu(0))
    net.hybridize()
    ref = net(mx.nd.array(x, ctx=mx.gpu(0))).asnumpy()
    card_file, cpu_file = str(tmp_path / 'g.onnx'), str(tmp_path / 'c.onnx')
    mx.contrib.onnx.export_model(net, None, input_shapes=[x.shape],
                                 onnx_file_path=card_file)
    net.collect_params().reset_ctx(mx.cpu())
    mx.contrib.onnx.export_model(net, None, input_shapes=[x.shape],
                                 onnx_file_path=cpu_file)
    with open(card_file, 'rb') as f, open(cpu_file, 'rb') as g:
        assert f.read() == g.read()
    back = mx.contrib.onnx.import_to_gluon(card_file, ctx=mx.gpu(0))
    assert rel(back(mx.nd.array(x, ctx=mx.gpu(0))).asnumpy(), ref) < 1e-4


def test_quantize_net_on_the_card_against_the_cpu():
    rs = onp.random.RandomState(6)
    calib = rs.uniform(-1, 1, (8, 3, 8, 8)).astype(onp.float32)
    x = rs.uniform(-1, 1, (2, 3, 8, 8)).astype(onp.float32)
    q = {}
    arrays = _arrays(_cnn(mx.cpu()))
    for ctx in (mx.gpu(0), mx.cpu()):
        with ctx:
            net = _cnn(ctx, arrays)
            q[ctx.device_type] = mx.contrib.quantization.quantize_net(
                net, calib_data=mx.nd.array(calib, ctx=ctx),
                calib_mode='naive')
    params = {k: {n: p.data().asnumpy() for n, p in
                  q[k]._collect_params_with_prefix().items()} for k in q}
    for n, v in params['cpu'].items():
        if v.dtype == onp.int8:
            onp.testing.assert_array_equal(params['gpu'][n], v)
        else:
            onp.testing.assert_allclose(params['gpu'][n], v, rtol=1e-5,
                                        atol=1e-7)
    # the CPU net with the card's ranges: the same quantization
    for n, p in q['cpu']._collect_params_with_prefix().items():
        p.set_data(mx.nd.array(params['gpu'][n], ctx=mx.cpu(),
                               dtype=params['gpu'][n].dtype))
    got = q['gpu'](mx.nd.array(x, ctx=mx.gpu(0))).asnumpy()
    want = q['cpu'](mx.nd.array(x, ctx=mx.cpu())).asnumpy()
    assert rel(got, want) < 1e-4
    # hybridized: one CUDA graph, its replays the eager forward
    q['gpu'].hybridize()
    for _ in range(2):
        replay = q['gpu'](mx.nd.array(x, ctx=mx.gpu(0))).asnumpy()
        onp.testing.assert_array_equal(replay, got)
    assert q['gpu']._cached_op.num_graphs == 1


def test_svrg_on_the_card_against_the_cpu():
    from mxnet_tpu_torch.contrib.svrg_optimization import SVRGModule
    rng = onp.random.RandomState(0)
    X = rng.randn(200, 5).astype(onp.float32)
    Y = (X @ rng.randn(5, 1).astype(onp.float32)).astype(onp.float32)
    w0 = onp.random.RandomState(1).normal(0, 0.1, (5, 1)).astype('float32')
    out = {}
    for ctx in (mx.gpu(0), mx.cpu()):
        s = mx.sym
        loss = s.MakeLoss(s.mean(s.square(
            s.dot(s.var('data'), s.var('w', shape=(5, 1))) -
            s.var('lin_label'))))
        mod = SVRGModule(loss, data_names=('data',),
                         label_names=('lin_label',), update_freq=2,
                         context=ctx)
        mod.bind(data_shapes=[('data', (20, 5))],
                 label_shapes=[('lin_label', (20, 1))])
        mod.init_params(arg_params={'w': mx.nd.array(w0, ctx=ctx)})
        it = mx.io.NDArrayIter(X, Y, batch_size=20, label_name='lin_label')
        mod.fit(it, eval_metric='mse', optimizer='sgd',
                optimizer_params=(('learning_rate', 0.05),
                                  ('rescale_grad', 1.0)), num_epoch=3)
        out[ctx.device_type] = mod.get_params()[0]['w'].asnumpy()
    onp.testing.assert_allclose(out['gpu'], out['cpu'], rtol=1e-5,
                                atol=1e-5)
