"""The port's learning-rate schedulers against the JAX package's: the
rate at every update count 0..N, with and without warm-up, called in
order as an optimizer calls them (FactorScheduler and
MultiFactorScheduler keep state between calls). Host-side Python floats
on both sides: equal to the last bit."""
import pytest

from mxnet_tpu import lr_scheduler as jsched
from mxnet_tpu_torch import lr_scheduler as tsched
from mxnet_tpu_torch.base import MXNetError
from test_torch_jax_globals import jax_globals  # noqa: F401

CASES = [
    ('FactorScheduler', dict(step=3, factor=0.5, base_lr=0.1)),
    ('FactorScheduler', dict(step=2, factor=0.1, stop_factor_lr=1e-4,
                             base_lr=1.0, warmup_steps=4,
                             warmup_begin_lr=0.01)),
    ('MultiFactorScheduler', dict(step=[3, 7, 12], factor=0.3,
                                  base_lr=0.2)),
    ('MultiFactorScheduler', dict(step=[5, 9], factor=0.5, base_lr=0.2,
                                  warmup_steps=3, warmup_mode='constant',
                                  warmup_begin_lr=0.05)),
    ('PolyScheduler', dict(max_update=15, base_lr=0.1, pwr=2)),
    ('PolyScheduler', dict(max_update=20, base_lr=0.1, pwr=1.5,
                           final_lr=0.01, warmup_steps=5)),
    ('CosineScheduler', dict(max_update=15, base_lr=0.1)),
    ('CosineScheduler', dict(max_update=20, base_lr=0.1, final_lr=0.001,
                             warmup_steps=6, warmup_begin_lr=0.002)),
]


@pytest.mark.parametrize('name,kw', CASES,
                         ids=[f'{n}-{i}' for i, (n, _) in enumerate(CASES)])
def test_scheduler_matches_jax(name, kw):
    j = getattr(jsched, name)(**kw)
    t = getattr(tsched, name)(**kw)
    got = [t(n) for n in range(25)]
    want = [j(n) for n in range(25)]
    assert got == want


def test_schedulers_check_their_arguments_as_jax_does():
    with pytest.raises(MXNetError, match='warmup_mode'):
        tsched.LRScheduler(warmup_mode='cubic')
    with pytest.raises(MXNetError, match='greater or equal than 1'):
        tsched.FactorScheduler(step=0)
    with pytest.raises(MXNetError, match='non-empty list'):
        tsched.MultiFactorScheduler(step=3)
    with pytest.raises(NotImplementedError):
        tsched.LRScheduler()(0)


def test_optimizer_reads_its_scheduler_at_the_update_count():
    """An optimizer's ``learning_rate`` is its scheduler at ``num_update``
    (the scheduler's base_lr set from learning_rate, as in JAX), and
    ``set_learning_rate`` is refused once a scheduler is set."""
    from mxnet_tpu_torch import optimizer as topt
    o = topt.create('sgd', learning_rate=0.4,
                    lr_scheduler=tsched.FactorScheduler(step=1, factor=0.5))
    assert o.learning_rate == 0.4
    o._update_count(0)
    o._update_count(0)
    assert o.num_update == 2 and o.learning_rate == pytest.approx(0.2)
    with pytest.raises(MXNetError, match='LRScheduler'):
        o.set_learning_rate(0.1)
