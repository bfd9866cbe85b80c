"""The port's ``gluon.Trainer`` against the JAX package's, on the CPU in f32.

Two Dense layers (a: 6 -> 5, b: 6 -> 4) take the same numpy weights and
inputs in both packages; losses are sums of squares, so every number is
an ordinary f32 computation. The JAX side uses ``autograd.record()`` /
``backward()``, whose 'write' gradient buffers a backward overwrites only
where the loss reaches; the port's loop clears ``.grad`` with
``zero_grad()`` (set to None) before each backward, and its Trainer keeps
the buffers. Parameters and states are held to rel 1e-4 (f32 rounding
order over 3 steps), losses to rel 1e-5.
"""
import numpy as onp
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import autograd as jautograd
from mxnet_tpu import gluon as jgluon
from mxnet_tpu import nd
from mxnet_tpu_torch import gluon
from mxnet_tpu_torch import lr_scheduler as tsched
from mxnet_tpu_torch import optimizer as topt
from test_torch_jax_globals import jax_globals  # noqa: F401


RTOL, ATOL = 1e-4, 1e-6
IN, A, B, N = 6, 5, 4, 3

OPTS = {
    'sgd': {'learning_rate': 0.05, 'momentum': 0.9, 'wd': 0.01},
    'nag': {'learning_rate': 0.05, 'momentum': 0.9, 'wd': 0.01},
    'adam': {'learning_rate': 0.01, 'wd': 0.01},
    'adamw': {'learning_rate': 0.01, 'wd': 0.01},
    'lamb': {'learning_rate': 0.01, 'wd': 0.01},
}


def _arrays(seed=0):
    rng = onp.random.RandomState(seed)
    return {'a.weight': rng.randn(A, IN).astype('float32') * 0.3,
            'a.bias': rng.randn(A).astype('float32') * 0.1,
            'b.weight': rng.randn(B, IN).astype('float32') * 0.3,
            'b.bias': rng.randn(B).astype('float32') * 0.1}


def _inputs(steps, seed=1):
    rng = onp.random.RandomState(seed)
    return [rng.randn(N, IN).astype('float32') for _ in range(steps)]


class _JaxPair:
    def __init__(self, arrays, opt, params):
        self.a = jgluon.nn.Dense(A, in_units=IN)
        self.b = jgluon.nn.Dense(B, in_units=IN)
        for layer in (self.a, self.b):
            layer.initialize()
        for name, arr in arrays.items():
            layer, attr = name.split('.')
            getattr(getattr(self, layer), attr).set_data(nd.array(arr))
        self.params = [self.a.weight, self.a.bias, self.b.weight,
                       self.b.bias]
        self.trainer = jgluon.Trainer(self.params, opt, dict(params))

    def step(self, x, use_b=True):
        x = nd.array(x)
        with jautograd.record():
            loss = (self.a(x) ** 2).sum()
            if use_b:
                loss = loss + (self.b(x) ** 2).sum()
        loss.backward()
        self.trainer.step(N)
        return float(loss.asnumpy())

    def values(self):
        return [p.data().asnumpy() for p in self.params]


class _PortPair:
    def __init__(self, arrays, opt, params):
        self.a = gluon.nn.Dense(A, in_units=IN, device='cpu')
        self.b = gluon.nn.Dense(B, in_units=IN, device='cpu')
        with torch.no_grad():
            for name, arr in arrays.items():
                layer, attr = name.split('.')
                getattr(getattr(self, layer), attr).copy_(
                    torch.from_numpy(arr))
        self.params = [self.a.weight, self.a.bias, self.b.weight,
                       self.b.bias]
        self.trainer = gluon.Trainer(self.params, opt, dict(params))

    def step(self, x, use_b=True):
        for p in self.params:
            p.grad = None
        x = torch.from_numpy(x)
        loss = (self.a(x) ** 2).sum()
        if use_b:
            loss = loss + (self.b(x) ** 2).sum()
        loss.backward()
        self.trainer.step(N)
        return float(loss.detach())

    def values(self):
        return [p.detach().numpy() for p in self.params]


def _assert_same(port, jax_side):
    for t, j in zip(port.values(), jax_side.values()):
        onp.testing.assert_allclose(t, j, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize('opt', ['adamw', 'sgd'])
def test_unreached_parameter_matches_jax_trainer(opt):
    """b is reached in step 1 and not in step 2: the JAX Trainer applies
    b's step-1 gradient again (its buffer still holds it), and so must
    the port's, though b's ``.grad`` is None in step 2."""
    arrays, xs = _arrays(), _inputs(2)
    j, t = _JaxPair(arrays, opt, OPTS[opt]), _PortPair(arrays, opt,
                                                       OPTS[opt])
    for k, x in enumerate(xs):
        lj, lt = j.step(x, use_b=k == 0), t.step(x, use_b=k == 0)
        assert abs(lt - lj) <= 1e-5 * abs(lj)
    assert t.b.weight.grad is None
    _assert_same(t, j)


def _states(trainer):
    import pickle
    states, optimizer = pickle.loads(trainer.get_states_bytes())
    return states, optimizer


def _flat(s):
    if isinstance(s, (list, tuple)):
        return [x for y in s for x in _flat(y)]
    return [] if s is None else [onp.asarray(s)]


@pytest.mark.parametrize('path', ['fused', 'loop'])
@pytest.mark.parametrize('opt', sorted(OPTS))
def test_trainer_matches_jax_trainer(opt, path):
    """3 steps of every ported optimizer through both Trainers, the fused
    update (``fused_update``) and the per-parameter loop (the flag off on
    the instance, in both packages); then the states payload holds the
    same numpy values under the same indices."""
    arrays, xs = _arrays(2), _inputs(3, seed=3)
    j, t = _JaxPair(arrays, opt, OPTS[opt]), _PortPair(arrays, opt,
                                                       OPTS[opt])
    if path == 'loop':
        j.trainer._optimizer.fused_update = False
        t.trainer._optimizer.fused_update = False
    for x in xs:
        lj, lt = j.step(x), t.step(x)
        assert abs(lt - lj) <= 1e-5 * abs(lj)
    _assert_same(t, j)
    (js, jo), (ts, to) = _states(j.trainer), _states(t.trainer)
    assert sorted(js) == sorted(ts) == [0, 1, 2, 3]
    assert to.num_update == jo.num_update == 3
    for i in js:
        a, b = _flat(ts[i]), _flat(js[i])
        assert len(a) == len(b) > 0
        for x, y in zip(a, b):
            assert x.dtype == y.dtype == onp.float32
            onp.testing.assert_allclose(x, y, rtol=RTOL, atol=ATOL)


def test_fused_update_equals_the_loop():
    """On the CPU the fused program and the per-parameter loop are the
    same arithmetic, the scalars f32 tensors in one and Python floats in
    the other: 3 AdamW steps agree to f32 rounding."""
    arrays, xs = _arrays(4), _inputs(3, seed=5)
    fused, loop = (_PortPair(arrays, 'adamw', OPTS['adamw'])
                   for _ in range(2))
    loop.trainer._optimizer.fused_update = False
    for x in xs:
        fused.step(x)
        loop.step(x)
    for a, b in zip(fused.values(), loop.values()):
        onp.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize('opt', ['adamw', 'lamb'])
def test_save_and_load_states_round_trip(tmp_path, opt):
    """``save_states`` after 2 steps, ``load_states`` into a new Trainer
    over the same weights: the next step equals the uninterrupted run,
    and the restored optimizer carries the update counts."""
    arrays, xs = _arrays(6), _inputs(3, seed=7)
    run = _PortPair(arrays, opt, OPTS[opt])
    for x in xs[:2]:
        run.step(x)
    path = str(tmp_path / 'trainer.states')
    run.trainer.save_states(path)
    resumed = _PortPair(arrays, opt, OPTS[opt])
    with torch.no_grad():
        for p, q in zip(resumed.params, run.params):
            p.copy_(q)
    resumed.trainer.load_states(path)
    assert resumed.trainer.optimizer.num_update == 2
    assert resumed.trainer.optimizer.param_dict[0] is resumed.params[0]
    run.step(xs[2])
    resumed.step(xs[2])
    for a, b in zip(resumed.values(), run.values()):
        onp.testing.assert_array_equal(a, b)
    assert not any(n.startswith('trainer.states.tmp')
                   for n in map(str, tmp_path.iterdir()))


def test_scheduler_drives_the_fused_update_as_in_jax():
    """A FactorScheduler on AdamW: the rate the host evaluates each step
    reaches the fused update through its device scalars, as the JAX
    Trainer's traced lr does."""
    from mxnet_tpu import lr_scheduler as jsched
    arrays, xs = _arrays(8), _inputs(4, seed=9)
    j = _JaxPair(arrays, 'adamw', {})
    t = _PortPair(arrays, 'adamw', {})
    for side, sched, opt_mod in ((j, jsched, mx.optimizer),
                                 (t, tsched, topt)):
        o = opt_mod.create('adamw', learning_rate=0.02, wd=0.01,
                           lr_scheduler=sched.FactorScheduler(
                               step=1, factor=0.5))
        side.trainer = type(side.trainer)(side.params, o)
    for x in xs:
        j.step(x)
        t.step(x)
    assert t.trainer.learning_rate == pytest.approx(
        j.trainer.learning_rate)
    _assert_same(t, j)


def test_an_optimizer_without_fused_update_takes_the_loop():
    """An optimizer without ``fused_update`` (the base class's default)
    takes the loop; its update sees Python floats."""
    seen = []

    class Probe(topt.Optimizer):
        def update(self, index, weight, grad, state):
            seen.append(type(self._get_lr(index)))

    p = torch.nn.Parameter(torch.ones(3))
    p.grad = torch.ones(3)
    gluon.Trainer([p], Probe(learning_rate=0.1)).step(1)
    assert seen == [float]
