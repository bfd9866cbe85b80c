"""The port's C training API (``csrc/embed/c_api_train.{h,cc}`` over
``mxnet_tpu_torch._train_embed``) against the JAX package's
``mxnet_tpu._train_embed`` functions (what the JAX C library calls), on
the CPU: every ``ctypes`` call runs inside ``with mt.cpu():``, whose
context the library's calls see on the calling thread.

The four cases of tests/test_c_train.py through the port's library: an
NDArray round trip and an imperative op by a reference alias name, a
backward through the C ABI, the LeNet loop (a recorded CachedOp forward,
softmax cross-entropy, backward, ``sgd_update`` per parameter), and the
KVStore. The LeNet loop's losses match the same loop driven through the
JAX functions within rel 1e-5 per step over 5 steps, and the first
step's gradients within rel 1e-4 (f32). ``MXTrainSymbolListInputs`` lists
the arguments, then the auxiliary states (a net with BatchNorm). An
array made outside a CPU scope fails naming the missing card, and so
does ``examples/c_embedder/train_mlp.c``, compiled here against the
port's header and library and linked to libpython, run as a program of
its own. The library is built with ``g++`` once for the module; a failed
build fails the tests.
"""
import ctypes
import os
import shutil
import subprocess

import numpy as onp
import pytest

import mxnet_tpu as mj
import mxnet_tpu_torch as mt
from mxnet_tpu import _train_embed as jte
from mxnet_tpu_torch._capi import ModuleTrainABI, TrainABI as CApi
from test_torch_c_predict import c_declarations
from test_torch_jax_globals import jax_globals  # noqa: F401

ROOT = os.path.normpath(os.path.join(os.path.dirname(__file__), os.pardir))
u32 = ctypes.c_uint32
H = ctypes.c_void_p


@pytest.fixture(scope='module')
def lib(tmp_path_factory):
    from mxnet_tpu_torch import _capi
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv('MXTPU_COMPILE_CACHE_DIR',
                  str(tmp_path_factory.mktemp('build')))
        yield _capi.load('train')


def _check(lib, rc):
    assert rc == 0, lib.MXTrainGetLastError().decode()


@pytest.fixture(autouse=True)
def _port_on_cpu():
    with mt.cpu():
        yield


def test_ndarray_roundtrip_and_imperative_op(lib):
    api = CApi(lib)
    a = api.create((2, 3))
    data = onp.arange(6, dtype=onp.float32).reshape(2, 3)
    api.set(a, data)
    onp.testing.assert_array_equal(api.get(a, (2, 3)), data)
    out, = api.invoke('_PlusScalar', [a], {'scalar': 2.0})
    onp.testing.assert_array_equal(api.get(out, (2, 3)), data + 2.0)
    ndim, shape = u32(), (u32 * 8)()
    _check(lib, lib.MXTrainNDArrayGetShape(a, ctypes.byref(ndim), shape))
    assert list(shape[:ndim.value]) == [2, 3]
    bad = onp.zeros(2, onp.float32)
    assert lib.MXTrainNDArraySyncCopyToCPU(
        a, bad.ctypes.data_as(ctypes.c_void_p), bad.nbytes) == -1
    assert b'size mismatch' in lib.MXTrainGetLastError()
    h = H()
    assert lib.MXTrainNDArrayCreate((u32 * 1)(3), 1, 99,
                                    ctypes.byref(h)) == -1
    assert b'unsupported dtype code 99' in lib.MXTrainGetLastError()
    for x in (a, out):
        lib.MXTrainNDArrayFree(x)


def test_autograd_backward_through_c(lib):
    api = CApi(lib)
    x, g = api.create((4,)), api.create((4,))
    api.set(x, [1., 2., 3., 4.])
    api.mark([x], [g])
    api.flags(recording=1)
    try:
        y, = api.invoke('square', [x])
        s, = api.invoke('sum', [y])
    finally:
        api.flags(recording=0)
    api.backward([s])
    onp.testing.assert_array_equal(api.get(api.grad(x), (4,)),
                                   [2., 4., 6., 8.])
    assert lib.MXTrainNDArrayGetGrad(y, ctypes.byref(H())) == -1
    assert b'no gradient' in lib.MXTrainGetLastError()


def lenet_symbol(sym):
    """tests/test_c_train.py's LeNet, weights as explicit inputs."""
    x = sym.Variable('data')
    c1 = sym.Activation(sym.Convolution(
        x, sym.Variable('c1_weight', shape=(8, 1, 5, 5)),
        sym.Variable('c1_bias', shape=(8,)), kernel=(5, 5), num_filter=8,
        name='c1'), act_type='relu')
    p1 = sym.Pooling(c1, kernel=(2, 2), stride=(2, 2), pool_type='max')
    c2 = sym.Activation(sym.Convolution(
        p1, sym.Variable('c2_weight', shape=(16, 8, 3, 3)),
        sym.Variable('c2_bias', shape=(16,)), kernel=(3, 3), num_filter=16,
        name='c2'), act_type='relu')
    p2 = sym.Pooling(c2, kernel=(2, 2), stride=(2, 2), pool_type='max')
    h1 = sym.Activation(sym.FullyConnected(
        sym.Flatten(p2), sym.Variable('fc1_weight', shape=(32, 400)),
        sym.Variable('fc1_bias', shape=(32,)), num_hidden=32, name='fc1'),
        act_type='relu')
    return sym.FullyConnected(h1, sym.Variable('fc2_weight', shape=(10, 32)),
                              sym.Variable('fc2_bias', shape=(10,)),
                              num_hidden=10, name='fc2')


SHAPES = {'data': (8, 1, 28, 28), 'c1_weight': (8, 1, 5, 5),
          'c1_bias': (8,), 'c2_weight': (16, 8, 3, 3), 'c2_bias': (16,),
          'fc1_weight': (32, 400), 'fc1_bias': (32,),
          'fc2_weight': (10, 32), 'fc2_bias': (10,)}


def lenet_loop(api, json_str, steps):
    """tests/test_c_train.py's loop through ``api``: (losses, the first
    step's gradients by name)."""
    names, cop = api.cached_op(json_str)
    assert names[0] == 'data'
    rng = onp.random.RandomState(0)
    handles, grads = {}, {}
    for name in names:
        handles[name] = api.create(SHAPES[name])
        if name != 'data':
            scale = 0.1 if 'weight' in name else 0.0
            api.set(handles[name], rng.randn(*SHAPES[name])
                    .astype(onp.float32) * scale)
            grads[name] = api.create(SHAPES[name])
    pnames = [n for n in names if n != 'data']
    api.mark([handles[n] for n in pnames], [grads[n] for n in pnames])
    imgs = rng.rand(8, 1, 28, 28).astype(onp.float32) * 0.1
    labels = rng.randint(0, 10, 8).astype(onp.float32)
    for i, lab in enumerate(labels.astype(int)):
        imgs[i, 0, lab:lab + 10, lab:lab + 10] += 0.8
    label_h = api.create((8,))
    api.set(label_h, labels)
    losses, first = [], None
    try:
        for _ in range(steps):
            api.set(handles['data'], imgs)
            api.flags(recording=1, training=1)
            logits = api.call(cop, [handles[n] for n in names])[0]
            loss, = api.invoke('softmax_cross_entropy', [logits, label_h])
            api.flags(recording=0)
            losses.append(float(api.get(loss, ()).reshape(-1)[0]))
            api.backward([loss])
            if first is None:
                first = {n: api.get(api.grad(handles[n]), SHAPES[n])
                         for n in pnames}
            for n in pnames:
                newp, = api.invoke('sgd_update',
                                   [handles[n], api.grad(handles[n])],
                                   {'lr': 0.1, 'rescale_grad': 1.0 / 8})
                api.set(handles[n], api.get(newp, SHAPES[n]))
    finally:
        api.flags(recording=0, training=0)
    return losses, first


def test_c_embedder_trains_lenet_like_jax(lib):
    json_str = lenet_symbol(mt.sym).tojson()
    got, got_g = lenet_loop(CApi(lib), json_str, steps=5)
    want, want_g = lenet_loop(ModuleTrainABI(jte), json_str, steps=5)
    onp.testing.assert_allclose(got, want, rtol=1e-5)
    for n, g in want_g.items():
        rel = onp.linalg.norm(got_g[n] - g) / max(onp.linalg.norm(g), 1e-30)
        assert rel <= 1e-4, (n, rel)
    longer, _ = lenet_loop(CApi(lib), json_str, steps=20)
    assert longer[-1] < longer[0] * 0.8, longer


def test_kvstore_through_c(lib):
    api = CApi(lib)
    kv = H()
    _check(lib, lib.MXTrainKVStoreCreate(b'local', ctypes.byref(kv)))
    a = api.create((3,))
    api.set(a, [1., 2., 3.])
    keys = (ctypes.c_int * 1)(7)
    _check(lib, lib.MXTrainKVStoreInit(kv, 1, keys, (H * 1)(a.value)))
    b = api.create((3,))
    api.set(b, [10., 10., 10.])
    _check(lib, lib.MXTrainKVStorePush(kv, 1, keys, (H * 1)(b.value), 0))
    out = api.create((3,))
    _check(lib, lib.MXTrainKVStorePull(kv, 1, keys, (H * 1)(out.value), 0))
    onp.testing.assert_array_equal(api.get(out, (3,)), [10., 10., 10.])
    assert lib.MXTrainKVStoreCreate(b'bogus', ctypes.byref(H())) == -1
    assert b'unknown kvstore type' in lib.MXTrainGetLastError()
    lib.MXTrainKVStoreFree(kv)


def test_list_inputs_are_the_arguments_then_the_aux_states(lib):
    """The JAX package's order (args, then aux), not nnvm's."""
    def net(sym):
        x = sym.Variable('data')
        bn = sym.BatchNorm(sym.FullyConnected(x, num_hidden=4, name='fc'),
                           name='bn')[0]
        return sym.FullyConnected(bn, num_hidden=2, name='out')
    s = net(mt.sym)
    names, _ = CApi(lib).cached_op(s.tojson())
    jnames = jte.symbol_list_inputs(jte.symbol_from_json(
        net(mj.sym).tojson()))
    assert names == jnames == s.list_arguments() + \
        s.list_auxiliary_states()
    assert names[-2:] == ['bn_moving_mean', 'bn_moving_var']


def test_an_array_outside_a_cpu_scope_needs_the_card(lib, monkeypatch):
    import threading
    import torch
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    res = {}

    def other_thread():
        # a thread of its own: no CPU scope is open there
        h = H()
        res['rc'] = lib.MXTrainNDArrayCreate((u32 * 1)(3), 1, 0,
                                             ctypes.byref(h))
        res['msg'] = lib.MXTrainGetLastError()
    t = threading.Thread(target=other_thread)
    t.start()
    t.join(timeout=60)
    assert res['rc'] == -1
    assert b'no CUDA device' in res['msg']


def test_the_header_declares_the_jax_packages_abi():
    own = c_declarations(os.path.join(ROOT, 'mxnet_tpu_torch', 'csrc',
                                      'embed', 'c_api_train.h'))
    assert len(own) == 24
    assert own == c_declarations(os.path.join(ROOT, 'src', 'train',
                                              'c_api_train.h'))
    assert own == c_declarations(os.path.join(
        ROOT, 'mxnet_tpu_torch', 'csrc', 'embed', 'c_api_train.cc'))


def test_standalone_embedder_links_and_needs_the_card(lib, tmp_path):
    """examples/c_embedder/train_mlp.c, read and not edited, compiled from
    a copy laid out so that its ``#include "../../src/train/
    c_api_train.h"`` finds the port's header, linked to the port's
    library and libpython. Run as a program of its own it has no CPU
    scope, so its first array needs the card: here it exits 1 naming the
    missing device (on the card, chip_smoke runs it to the end)."""
    from mxnet_tpu_torch import _capi
    prog = tmp_path / 'examples' / 'c_embedder'
    prog.mkdir(parents=True)
    shutil.copy(os.path.join(ROOT, 'examples', 'c_embedder', 'train_mlp.c'),
                prog)
    hdr = tmp_path / 'src' / 'train'
    hdr.mkdir(parents=True)
    shutil.copy(_capi.header('train'), hdr / 'c_api_train.h')
    exe = _capi.link_program(str(prog / 'train_mlp.c'),
                             str(tmp_path / 'train_mlp'))
    env = _capi.program_env({k: v for k, v in os.environ.items()
                             if k != 'PYTHONPATH'})
    env['CUDA_VISIBLE_DEVICES'] = ''
    r = subprocess.run([exe], capture_output=True, text=True, timeout=180,
                       env=env, cwd=str(tmp_path))
    assert r.returncode == 1, (r.returncode, r.stdout, r.stderr)
    assert 'no CUDA device' in r.stderr, r.stderr
