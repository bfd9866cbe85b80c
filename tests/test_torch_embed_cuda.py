"""The C ABIs and the KVStore of the port on the card against their runs
on the CPU, at small sizes: the predict ABI with ``dev_type=2``, the
training ABI's CachedOp in float16 and its LeNet-style loop, the
standalone embedder ``examples/c_embedder/train_mlp.c``, the store's
codecs on card tensors, and the Trainer with ``update_on_kvstore``.

These tests need a CUDA device and carry the ``cuda`` marker; without a
card they skip. On the card, from the root of the checkout (the file
imports only torch, numpy and the port, so the JAX conftest is left out):

    python -m pytest --noconftest -m cuda tests/test_torch_embed_cuda.py

f32 with TF32 off: the predict ABI bitwise the SymbolBlock forward on the
card and within 1e-4 of the CPU (the SIMT flash kernel against the plain
attention); the training ABI bitwise the same CachedOp driven from
Python; the store bitwise the CPU store's; the two Trainer routes'
moments bitwise.
"""
import ctypes
import os
import shutil
import subprocess

import numpy as onp
import pytest
import torch

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import _capi, _train_embed

pytestmark = pytest.mark.cuda
ROOT = os.path.normpath(os.path.join(os.path.dirname(__file__), os.pardir))


@pytest.fixture(autouse=True)
def card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield


@pytest.fixture(scope='module')
def build(tmp_path_factory):
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv('MXTPU_COMPILE_CACHE_DIR',
                  str(tmp_path_factory.mktemp('build')))
        yield {n: _capi.load(n) for n in ('predict', 'train')}


def encoder(sym, hidden=64, heads=2, layers=2, ffn=128):
    h = sym.Variable('data')
    mask = sym.Variable('mask')
    for i in range(layers):
        p = f'l{i}_'

        def fc(x, n, name):
            return sym.FullyConnected(x, num_hidden=n, flatten=False,
                                      name=p + name)
        att = sym.multi_head_attention(fc(h, hidden, 'q'), fc(h, hidden, 'k'),
                                       fc(h, hidden, 'v'), mask,
                                       num_heads=heads, name=p + 'att')
        h = sym.LayerNorm(h + fc(att, hidden, 'o'), name=p + 'ln1')
        f = sym.Activation(fc(h, ffn, 'ffn1'), act_type='gelu',
                           name=p + 'gelu')
        h = sym.LayerNorm(h + fc(f, hidden, 'ffn2'), name=p + 'ln2')
    return h


def encoder_case(batch=2, seq=64, hidden=64, seed=3):
    net = encoder(mx.sym)
    rng = onp.random.RandomState(seed)
    shapes = dict(data=(batch, seq, hidden), mask=(batch, 1, 1, seq))
    args, _, _ = net.infer_shape(**shapes)
    arrays = {n: (rng.standard_normal(s) * 0.02 if n.endswith('_weight')
                  else onp.ones(s) if n.endswith('_gamma')
                  else onp.zeros(s)).astype(onp.float32)
              for n, s in zip(net.list_arguments(), args)
              if n not in shapes}
    valid = rng.randint(seq // 2, seq + 1, batch)
    inputs = dict(
        data=rng.standard_normal(shapes['data']).astype(onp.float32),
        mask=onp.where(onp.arange(seq)[None] < valid[:, None], 0.0, -1e4)
        .astype(onp.float32).reshape(shapes['mask']))
    head = rng.standard_normal(shapes['data']).astype(onp.float32)
    return net, arrays, inputs, head


def test_predict_abi_on_the_card(build, tmp_path):
    net, arrays, inputs, _ = encoder_case()
    path = str(tmp_path / 'enc-0000.params')
    with mx.cpu():
        mx.nd.save(path, {f'arg:{k}': mx.nd.array(v)
                          for k, v in arrays.items()})
    params = open(path, 'rb').read()
    js = net.tojson().encode()
    mx.ops.reset_launch_counts()
    got = _capi.predict(build['predict'], js, params, inputs, dev_type=2)
    assert mx.ops.launch_counts['flash_attn_fwd'] == 2
    from mxnet_tpu_torch.ops import _build
    assert _build.variant_counts['flash_attn_fwd.simt'] == 2
    block = mx.gluon.SymbolBlock(mx.sym.fromjson(js.decode()),
                                 [mx.sym.var('data'), mx.sym.var('mask')])
    from mxnet_tpu_torch.serialization import load_params_dict
    block._load_arg_dict({k: onp.array(v) for k, v in
                          load_params_dict(params).items()}, ctx=mx.gpu(0))
    direct = block(*[mx.nd.array(inputs[k], ctx=mx.gpu(0))
                     for k in ('data', 'mask')]).asnumpy()
    onp.testing.assert_array_equal(got, direct)
    cpu = _capi.predict(build['predict'], js, params, inputs, dev_type=1)
    onp.testing.assert_allclose(got, cpu, rtol=1e-4, atol=1e-4)


def _step(api, js, arrays, inputs, head, dtype):
    names, cop = api.cached_op(js)
    values = dict(arrays, **inputs)
    hs = {n: api.create(values[n].shape, dtype) for n in names}
    for n in names:
        api.set(hs[n], values[n].astype(dtype))
    params = [n for n in names if n in arrays]
    gs = {n: api.create(arrays[n].shape, dtype) for n in params}
    api.mark([hs[n] for n in params], [gs[n] for n in params])
    hh = api.create(head.shape, dtype)
    api.set(hh, head.astype(dtype))
    api.flags(recording=1, training=1)
    try:
        out, = api.call(cop, [hs[n] for n in names])
    finally:
        api.flags(recording=0, training=0)
    api.backward([out], [hh])
    return {n: api.get(api.grad(hs[n]), arrays[n].shape, dtype)
            for n in params}


def test_training_abi_float16_on_the_card(build):
    net, arrays, inputs, head = encoder_case()
    js = net.tojson()
    api = _capi.TrainABI(build['train'])
    mx.ops.reset_launch_counts()
    got = _step(api, js, arrays, inputs, head, 'float16')
    from mxnet_tpu_torch.ops import _build
    for k in ('flash_attn_fwd', 'flash_attn_bwd_dq', 'flash_attn_bwd_dkv'):
        assert _build.dtype_counts[f'{k}.float16'] == 2, k
    want = _step(_capi.ModuleTrainABI(_train_embed), js, arrays, inputs,
                 head, 'float16')
    for n in want:
        onp.testing.assert_array_equal(got[n], want[n])
        assert onp.isfinite(got[n]).all(), n


def test_standalone_embedder_trains_on_the_card(build, tmp_path):
    prog = tmp_path / 'examples' / 'c_embedder'
    prog.mkdir(parents=True)
    shutil.copy(os.path.join(ROOT, 'examples', 'c_embedder', 'train_mlp.c'),
                prog)
    (tmp_path / 'src' / 'train').mkdir(parents=True)
    shutil.copy(_capi.header('train'),
                tmp_path / 'src' / 'train' / 'c_api_train.h')
    exe = _capi.link_program(str(prog / 'train_mlp.c'),
                             str(tmp_path / 'train_mlp'))
    r = subprocess.run([exe], capture_output=True, text=True, timeout=300,
                       env=_capi.program_env(), cwd=str(tmp_path))
    assert r.returncode == 0, r.stderr
    assert 'C EMBEDDER TRAIN OK' in r.stdout


@pytest.mark.parametrize('codec', [None, '2bit', 'fp16', 'int8'])
def test_store_on_card_tensors_matches_the_cpu(codec):
    rng = onp.random.RandomState(5)
    vals = [rng.standard_normal(s).astype(onp.float32) * 0.5
            for s in ((64, 96), (96,), (7,))]
    keys = list(range(len(vals)))

    def run(device):
        kv = mx.kv.create('device')
        if codec:
            kv.set_gradient_compression({'type': codec, 'threshold': 0.3})
        kv.init(keys, [mx.nd.NDArray(torch.zeros(v.shape, device=device))
                       for v in vals])
        outs = [mx.nd.NDArray(torch.empty(v.shape, device=device))
                for v in vals]
        for _ in range(3):
            kv.push(keys, [[mx.nd.NDArray(torch.from_numpy(v).to(device))] * 2
                           for v in vals])
        kv.pull(keys, out=outs)
        return [o._data.cpu() for o in outs]
    for g, w in zip(run('cuda'), run('cpu')):
        assert torch.equal(g, w)


def test_trainer_update_on_kvstore_matches_the_fused_update():
    def run(**kw):
        with mx.gpu(0):
            net = mx.gluon.nn.Dense(32, in_units=48)
            net.initialize()
            net.weight.set_data(onp.random.RandomState(1).randn(32, 48)
                                .astype(onp.float32) * 0.1)
            tr = mx.gluon.Trainer(net.collect_params(), 'adamw',
                                  {'learning_rate': 0.01, 'wd': 0.01}, **kw)
            x = mx.nd.array(onp.random.RandomState(2).randn(8, 48))
            for _ in range(3):
                with mx.autograd.record():
                    loss = (net(x) ** 2).sum()
                loss.backward()
                tr.step(8)
            states = tr._states_updater().states
            return net.weight.data().asnumpy(), states
    w_kv, s_kv = run(update_on_kvstore=True)
    w_f, s_f = run()
    onp.testing.assert_allclose(w_kv, w_f, rtol=1e-6, atol=1e-7)
    for i in s_f:
        for a, b in zip(s_kv[i], s_f[i]):
            assert torch.equal(a, b)


def test_abi_arrays_follow_the_callers_context(build):
    api = _capi.TrainABI(build['train'])
    h = api.create((3,))
    assert ctypes.cast(h, ctypes.py_object).value._data.is_cuda
    with mx.cpu():
        h = api.create((3,))
    assert not ctypes.cast(h, ctypes.py_object).value._data.is_cuda
