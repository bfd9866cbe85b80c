"""The port's evaluation metrics (``mxnet_tpu_torch/metric.py``) against
the JAX package's ``metric.py`` on the same seeded inputs.

Each metric takes the same sequence in both packages: two updates, a
``reset_local``, a third update, then ``reset``; after every call its
``get`` and ``get_global`` are held against JAX's (both NaN, or equal
within 1e-6 relative; the counts exactly). The port takes its inputs as
its NDArrays and as torch tensors (bfloat16 predictions among them, read
on the host as float32, are held against JAX given the same rounded
values). Also ``create`` by name, alias, instance, callable and list,
``CompositeEvalMetric``, ``check_label_shapes``, ``update_dict`` and
``get_config``.
"""
import math

import numpy as onp
import pytest
import torch

import mxnet_tpu as mj
import mxnet_tpu_torch as mt
from mxnet_tpu_torch import metric as tmetric

N, C = 24, 5


@pytest.fixture(autouse=True)
def _port_on_cpu():
    with mt.cpu():
        yield


def _probs(rng, n=N, c=C):
    p = rng.rand(n, c).astype(onp.float32) + 0.05
    return p / p.sum(axis=1, keepdims=True)


def _inputs(kind, rng):
    """(labels, preds) numpy arrays for one update of a ``kind`` metric."""
    if kind == 'class':
        return rng.randint(0, C, N).astype(onp.float32), _probs(rng)
    if kind == 'binary':
        return rng.randint(0, 2, N).astype(onp.float32), _probs(rng, c=2)
    if kind == 'regress':
        y = rng.randn(N).astype(onp.float32)
        return y, (y + 0.3 * rng.randn(N)).astype(onp.float32)
    if kind == 'loss':
        return None, rng.rand(N).astype(onp.float32)
    if kind == 'sequence':
        return rng.randint(0, C, (4, 6)).astype(onp.float32), \
            _probs(rng, n=24).reshape(4, 6, C)
    raise ValueError(kind)


# (name, constructor kwargs, input kind)
METRICS = [
    ('acc', {}, 'class'), ('accuracy', {'axis': 1}, 'class'),
    ('top_k_accuracy', {'top_k': 3}, 'class'),
    ('f1', {}, 'binary'), ('mcc', {}, 'binary'),
    ('perplexity', {}, 'sequence'),
    ('perplexity', {'ignore_label': 0}, 'sequence'),
    ('mae', {}, 'regress'), ('mse', {}, 'regress'), ('rmse', {}, 'regress'),
    ('ce', {}, 'class'), ('nll_loss', {}, 'class'),
    ('pearsonr', {}, 'regress'), ('pcc', {}, 'class'),
    ('loss', {}, 'loss'), ('torch', {}, 'loss'), ('caffe', {}, 'loss'),
]


def _close(got, want, what):
    assert type(got) is type(want) or isinstance(got, (int, float)), what
    if isinstance(want, (list, tuple)):
        assert len(got) == len(want), what
        for g, w in zip(got, want):
            _close(g, w, what)
        return
    if isinstance(want, str):
        assert got == want, what
        return
    w, g = float(want), float(got)
    if math.isnan(w):
        assert math.isnan(g), what
    else:
        assert g == pytest.approx(w, rel=1e-6, abs=1e-12), what


def _as_port(a, form):
    if a is None:
        return None
    if form == 'ndarray':
        return mt.nd.array(a)
    t = torch.from_numpy(a)
    return t.to(torch.bfloat16) if form == 'bf16' else t


def _rounded(a, form):
    """What the port reads for ``a`` in ``form``: bfloat16 rounds."""
    if a is None or form != 'bf16':
        return a
    return torch.from_numpy(a).to(torch.bfloat16).float().numpy()


def _states(m):
    return [m.get(), m.get_global(), m.num_inst, m.global_num_inst]


@pytest.mark.parametrize('form', ['ndarray', 'tensor'])
@pytest.mark.parametrize('name,kw,kind', METRICS,
                         ids=[f'{n}{sorted(k.items()) or ""}'
                              for n, k, _ in METRICS])
def test_metric_matches_jax(name, kw, kind, form):
    rng = onp.random.RandomState(7)
    batches = [_inputs(kind, rng) for _ in range(3)]
    jm = mj.metric.create(name, **kw)
    tm = tmetric.create(name, **kw)
    assert type(tm).__name__ == type(jm).__name__
    assert tm.name == jm.name
    _close(_states(tm), _states(jm), 'fresh')

    def update(i):
        lab, pred = batches[i]
        jl = [mj.nd.array(lab)] if lab is not None else None
        tl = [_as_port(lab, form)] if lab is not None else None
        jm.update(jl, [mj.nd.array(pred)])
        tm.update(tl, [_as_port(pred, form)])
    for step, act in enumerate(['update', 'update', 'reset_local', 'update',
                                'reset']):
        if act == 'update':
            update(min(step, 2))
        else:
            getattr(jm, act)()
            getattr(tm, act)()
        _close(_states(tm), _states(jm), f'after call {step} ({act})')


@pytest.mark.parametrize('name', ['acc', 'ce', 'mse', 'perplexity'])
def test_bfloat16_predictions_are_read_as_float32(name):
    kind = {n: k for n, _, k in METRICS}[name]
    rng = onp.random.RandomState(3)
    lab, pred = _inputs(kind, rng)
    jm, tm = mj.metric.create(name), tmetric.create(name)
    jm.update([mj.nd.array(lab)], [mj.nd.array(_rounded(pred, 'bf16'))])
    tm.update([_as_port(lab, 'tensor')], [_as_port(pred, 'bf16')])
    _close(_states(tm), _states(jm), name)


def test_create_by_name_instance_callable_and_list():
    assert isinstance(tmetric.create('acc'), tmetric.Accuracy)
    assert isinstance(tmetric.create('top_k_acc', top_k=2),
                      tmetric.TopKAccuracy)
    m = tmetric.MAE()
    assert tmetric.create(m) is m
    comp = tmetric.create(['acc', 'ce', tmetric.MSE()])
    assert isinstance(comp, tmetric.CompositeEvalMetric)
    assert [type(x).__name__ for x in comp.metrics] == \
        ['Accuracy', 'CrossEntropy', 'MSE']
    with pytest.raises(mt.MXNetError, match='Unknown metric'):
        tmetric.create('no_such_metric')

    def feval(label, pred):
        return float((label == pred.argmax(axis=1)).sum()), len(label)
    cm = tmetric.create(feval)
    jcm = mj.metric.create(feval)
    assert isinstance(cm, tmetric.CustomMetric) and cm.name == jcm.name
    lab, pred = _inputs('class', onp.random.RandomState(1))
    cm.update([mt.nd.array(lab)], [mt.nd.array(pred)])
    jcm.update([mj.nd.array(lab)], [mj.nd.array(pred)])
    _close(_states(cm), _states(jcm), 'custom')
    npm, jnpm = tmetric.np(feval, name='hits'), mj.metric.np(feval,
                                                             name='hits')
    npm.update([lab], [pred])
    jnpm.update([lab], [pred])
    _close(_states(npm), _states(jnpm), 'np')


def test_composite_metric_matches_jax():
    rng = onp.random.RandomState(2)
    batches = [_inputs('class', rng) for _ in range(2)]
    jc = mj.metric.CompositeEvalMetric(['acc', 'ce'])
    tc = tmetric.CompositeEvalMetric(['acc', 'ce'])
    tc.add(tmetric.TopKAccuracy(top_k=2))
    jc.add(mj.metric.TopKAccuracy(top_k=2))
    for lab, pred in batches:
        jc.update([mj.nd.array(lab)], [mj.nd.array(pred)])
        tc.update([torch.from_numpy(lab)], [torch.from_numpy(pred)])
    _close(tc.get(), jc.get(), 'composite')
    _close(tc.get_name_value(), jc.get_name_value(), 'name_value')
    assert type(tc.get_metric(2)).__name__ == 'TopKAccuracy'
    tc.reset()
    jc.reset()
    _close(tc.get(), jc.get(), 'reset')


def test_check_label_shapes_update_dict_and_config():
    tmetric.check_label_shapes([1, 2], [3, 4])
    with pytest.raises(ValueError, match='does not match'):
        tmetric.check_label_shapes([1, 2], [3])
    with pytest.raises(ValueError, match='does not match'):
        tmetric.check_label_shapes(onp.zeros((2, 3)), onp.zeros((3, 2)),
                                   shape=True)
    lab, pred = _inputs('class', onp.random.RandomState(4))
    tm = tmetric.Accuracy(output_names=['out'], label_names=['y'])
    jm = mj.metric.Accuracy(output_names=['out'], label_names=['y'])
    tm.update_dict({'y': mt.nd.array(lab)},
                   {'out': mt.nd.array(pred), 'other': mt.nd.array(pred)})
    jm.update_dict({'y': mj.nd.array(lab)},
                   {'out': mj.nd.array(pred), 'other': mj.nd.array(pred)})
    _close(_states(tm), _states(jm), 'update_dict')
    assert tm.get_config() == jm.get_config()
    assert str(tm) == str(jm)
