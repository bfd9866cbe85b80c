"""Wide & Deep on the sparse path: the port's ``models.wide_deep.
WideDeep`` against the JAX package's ``examples/train_wide_deep.py``
model at vocab 2000, 5 fields, dim 16, hidden 64, B = 16 (hot fraction
0.05 of the example's synthetic CTR data). The JAX model is initialised
Normal(0.01) and its arrays cross to the port by structured name
(``weights.params_from_mxnet_tpu``); 3 lazy-Adam steps of each
``ShardedTrainStep`` (the JAX one on a one-device CPU mesh) on the same
batches: losses rel 1e-5, parameters and moments rel 1e-4 in Frobenius
norm, the moments of rows no batch touched exactly 0 in both.
"""
import importlib.util
import os

import jax
import numpy as onp
import pytest
import torch

import mxnet_tpu as mj
import mxnet_tpu_torch as mt
from mxnet_tpu.parallel import step as jstep
from mxnet_tpu.parallel.mesh import make_mesh as jmake_mesh
from mxnet_tpu_torch.models.wide_deep import WideDeep, synthetic_ctr
from mxnet_tpu_torch.parallel import ShardedTrainStep, make_mesh
from mxnet_tpu_torch.weights import params_from_mxnet_tpu

VOCAB, FIELDS, DIM, HIDDEN, B, HOT = 2000, 5, 16, 64, 16, 0.05


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


def _example():
    path = os.path.join(os.path.dirname(__file__), os.pardir, 'examples',
                        'train_wide_deep.py')
    spec = importlib.util.spec_from_file_location('train_wide_deep', path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _rel(a, b):
    a, b = onp.asarray(a, onp.float64), onp.asarray(b, onp.float64)
    return onp.linalg.norm(a - b) / max(onp.linalg.norm(b), 1e-30)


def test_synthetic_ctr_is_the_examples():
    ex = _example()
    want = ex.synthetic_ctr(64, FIELDS, VOCAB, HOT, seed=3)
    got = synthetic_ctr(64, FIELDS, VOCAB, HOT, seed=3)
    for w, g in zip(want, got):
        onp.testing.assert_array_equal(g, w)


@pytest.mark.parametrize('exact', [False, True], ids=['lazy', 'exact'])
def test_wide_deep_matches_the_jax_step(monkeypatch, exact):
    monkeypatch.setenv('MXTPU_SPARSE', '1')
    monkeypatch.setenv('MXTPU_SPARSE_EXACT', '1' if exact else '0')
    ex = _example()
    ids, y = synthetic_ctr(B * 3, FIELDS, VOCAB, HOT)
    mj.random.seed(0)
    jnet = ex.WideDeep(VOCAB, DIM, HIDDEN)
    jnet.initialize(mj.init.Normal(0.01))
    jnet(mj.nd.array(ids[:B]))
    arrays = {k: p.data().asnumpy()
              for k, p in jnet._collect_params_with_prefix().items()}
    jbce = mj.gluon.loss.SigmoidBinaryCrossEntropyLoss()
    js = jstep.ShardedTrainStep(
        jnet, lambda o, l: jbce(o, l), 'adam', {'learning_rate': 0.01},
        mesh=jmake_mesh((1,), ('dp',), devices=jax.devices()[:1]))
    with mt.cpu():
        tnet = WideDeep(VOCAB, DIM, HIDDEN)
        tnet.initialize(mt.init.Normal(0.01))
        tnet(mt.nd.array(ids[:B]))
        tnet.load_state_dict(params_from_mxnet_tpu(arrays, tnet))
        tbce = mt.gluon.loss.SigmoidBinaryCrossEntropyLoss()
        ts = ShardedTrainStep(tnet, lambda o, l: tbce(o, l), 'adam',
                              {'learning_rate': 0.01},
                              mesh=make_mesh(devices=['cpu']))
        jl, tl = [], []
        for i in range(3):
            x, lab = ids[i * B:(i + 1) * B], y[i * B:(i + 1) * B]
            jl.append(float(js(mj.nd.array(x), mj.nd.array(lab)).asnumpy()))
            tl.append(float(ts(torch.from_numpy(x), torch.from_numpy(lab))))
    assert ts._sparse_names == ['deep.weight', 'wide.weight']
    assert ts._sparse_exact == exact
    onp.testing.assert_allclose(tl, jl, rtol=1e-5)
    names = {id(p): n for n, p in jnet.collect_params().items()}
    touched = onp.unique(ids.astype(int))
    untouched = onp.setdiff1d(onp.arange(VOCAB), touched)
    for k, jp in jnet._collect_params_with_prefix().items():
        tp = dict(tnet.named_parameters())[k]
        assert _rel(tp.detach().numpy(), jp.data().asnumpy()) < 1e-4, k
        jst = [s for s in js._opt_state[names[id(jp)]]
               if getattr(s, 'ndim', 0)]
        for a, b in zip(ts._state[k], jst):
            assert _rel(a.numpy(), onp.asarray(b)) < 1e-4, k
            if k in ts._sparse_names and not exact:
                assert onp.all(a.numpy()[untouched] == 0.0)
                assert onp.all(onp.asarray(b)[untouched] == 0.0)
    rep, jrep = ts.sparse_report(), js.sparse_report()
    assert rep['update_bytes_per_step'] == jrep['update_bytes_per_step']
    assert rep['mode'] == jrep['mode'] == ('exact' if exact else 'lazy')
