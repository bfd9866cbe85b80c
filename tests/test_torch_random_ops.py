"""The port's random ops by their distributions (the JAX package's give
other numbers from the same seed, so the two are compared by law, not by
value): at n = 200000 draws, each sampler's mean and variance within 5
standard errors of the distribution's, and a Kolmogorov-Smirnov test
against the distribution (scipy) with p > 1e-4 for the continuous ones;
the discrete ones by their moments and their support. Also: the output
dtypes of the JAX ops (int32 for randint and the multinomials), the same
seed giving the same draws twice, ``random.get_state``/``set_state``
restoring the stream, and every draw coming from the port's generator,
not torch's default one. The CUDA-graph replay case is in
tests/test_torch_ops_cuda.py.
"""
import numpy as onp
import pytest
import scipy.stats as st
import torch

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.base import get_op
from test_torch_jax_globals import jax_globals  # noqa: F401

N = 200000


@pytest.fixture(autouse=True)
def _port_on_cpu():
    with mt.cpu():
        mt.random.seed(123)
        yield


def _draw(name, *args, **kwargs):
    out = get_op(name).fn(*args, **kwargs)
    return out.to(torch.float64).numpy().reshape(-1)


def _moments(x, mean, var):
    se_mean = onp.sqrt(var / x.size)
    assert abs(x.mean() - mean) < 5 * se_mean, (x.mean(), mean)
    # the variance's standard error from the fourth moment, estimated
    m4 = onp.mean((x - x.mean()) ** 4)
    se_var = onp.sqrt(max(m4 - var ** 2, 1e-12) / x.size)
    assert abs(x.var() - var) < 6 * se_var, (x.var(), var)


CONTINUOUS = [
    ('random_uniform', dict(low=-2.0, high=3.0, shape=(N,)),
     st.uniform(-2.0, 5.0)),
    ('random_normal', dict(loc=1.0, scale=2.0, shape=(N,)),
     st.norm(1.0, 2.0)),
    ('random_gamma', dict(alpha=2.5, beta=1.5, shape=(N,)),
     st.gamma(2.5, scale=1.5)),
    ('random_exponential', dict(lam=4.0, shape=(N,)), st.expon(scale=0.25)),
    ('_npi_uniform', dict(low=1.0, high=2.0, size=(N,)), st.uniform(1, 1)),
    ('_npi_normal', dict(loc=-1.0, scale=0.5, size=(N,)),
     st.norm(-1.0, 0.5)),
    ('_npi_gamma', dict(shape=3.0, scale=2.0, size=(N,)),
     st.gamma(3.0, scale=2.0)),
    ('_npi_exponential', dict(scale=2.0, size=(N,)), st.expon(scale=2.0)),
    ('_npi_gumbel', dict(loc=1.0, scale=2.0, size=(N,)),
     st.gumbel_r(1.0, 2.0)),
    ('_npi_logistic', dict(loc=0.5, scale=1.5, size=(N,)),
     st.logistic(0.5, 1.5)),
    ('_npi_laplace', dict(loc=0.0, scale=2.0, size=(N,)),
     st.laplace(0.0, 2.0)),
    ('_npi_rayleigh', dict(scale=2.0, size=(N,)), st.rayleigh(scale=2.0)),
    ('_npi_weibull', dict(a=1.5, size=(N,)), st.weibull_min(1.5)),
    ('_npi_pareto', dict(a=5.0, size=(N,)), st.lomax(5.0)),
    ('_npi_powerd', dict(a=3.0, size=(N,)), st.powerlaw(3.0)),
]


@pytest.mark.parametrize('name,kwargs,dist', CONTINUOUS,
                         ids=[c[0] for c in CONTINUOUS])
def test_continuous_sampler_follows_its_law(name, kwargs, dist):
    x = _draw(name, **kwargs)
    assert x.size == N
    _moments(x, dist.mean(), dist.var())
    assert st.kstest(x, dist.cdf).pvalue > 1e-4


DISCRETE = [
    ('random_poisson', dict(lam=3.5, shape=(N,)), st.poisson(3.5)),
    ('random_negative_binomial', dict(k=4, p=0.4, shape=(N,)),
     st.nbinom(4, 0.4)),
    # mean mu, variance mu + alpha mu^2: NB(n = 1/alpha, p = 1/(1+alpha mu))
    ('random_generalized_negative_binomial',
     dict(mu=2.0, alpha=0.5, shape=(N,)), st.nbinom(2.0, 0.5)),
    ('random_randint', dict(low=-3, high=7, shape=(N,)), st.randint(-3, 7)),
    ('_npi_randint', dict(low=2, high=9, size=(N,)), st.randint(2, 9)),
    ('_npi_bernoulli', dict(prob=0.3, size=(N,)), st.bernoulli(0.3)),
]


@pytest.mark.parametrize('name,kwargs,dist', DISCRETE,
                         ids=[d[0] for d in DISCRETE])
def test_discrete_sampler_follows_its_law(name, kwargs, dist):
    x = _draw(name, **kwargs)
    _moments(x, dist.mean(), dist.var())
    assert (x == onp.round(x)).all()
    lo, hi = dist.support()
    assert x.min() >= lo and x.max() <= hi
    # the frequency of each of the first values against the pmf
    for k in range(int(max(lo, 0)), int(max(lo, 0)) + 3):
        p = dist.pmf(k)
        freq = (x == k).mean()
        assert abs(freq - p) < 5 * onp.sqrt(p * (1 - p) / N) + 1e-9, (k,)


@pytest.mark.parametrize('name', ['sample_uniform', 'sample_normal',
                                  'sample_gamma'])
def test_per_element_samplers(name):
    a = torch.tensor([0.5, 2.0])
    b = torch.tensor([1.5, 3.0])
    x = get_op(name).fn(a, b, shape=(N // 2,)).to(torch.float64).numpy()
    assert x.shape == (2, N // 2)
    laws = {'sample_uniform': lambda lo, hi: st.uniform(lo, hi - lo),
            'sample_normal': lambda m, s: st.norm(m, s),
            'sample_gamma': lambda al, be: st.gamma(al, scale=be)}[name]
    for row, (p, q) in zip(x, [(0.5, 1.5), (2.0, 3.0)]):
        d = laws(p, q)
        _moments(row, d.mean(), d.var())
        assert st.kstest(row, d.cdf).pvalue > 1e-4


def test_multinomial_frequencies_and_dtypes():
    probs = torch.tensor([[0.2, 0.5, 0.3], [0.6, 0.1, 0.3]])
    s = get_op('sample_multinomial').fn(probs, shape=(N // 2,))
    assert s.dtype == torch.int32 and s.shape == (2, N // 2)
    for row, p in zip(s.numpy(), probs.numpy()):
        freq = onp.bincount(row, minlength=3) / row.size
        assert onp.abs(freq - p).max() < 5 * onp.sqrt(0.25 / row.size)
    one = get_op('sample_multinomial').fn(probs)
    assert one.shape == (2,) and one.dtype == torch.int32
    counts = get_op('_npi_multinomial').fn(10, [0.2, 0.8], size=(N // 10,))
    assert counts.dtype == torch.int32
    assert (counts.sum(-1) == 10).all()
    _moments(counts[:, 1].to(torch.float64).numpy(), 8.0, 1.6)


def test_get_prob_returns_no_log_probabilities_as_in_jax():
    """MXNet's multinomial(get_prob=True) also returns the samples'
    log-probabilities; the JAX op accepts the flag and returns the
    samples only, and the port mirrors it (ROADMAP queue 3)."""
    import mxnet_tpu as mj
    p = onp.asarray([[0.5, 0.5]], onp.float32)
    want = mj.nd.random.multinomial(mj.nd.array(p), get_prob=True)
    got = mt.nd.random.multinomial(mt.nd.array(p), get_prob=True)
    assert not isinstance(want, tuple) and not isinstance(got, tuple)
    assert got.shape == want.shape and got.dtype == want.dtype


def test_shuffle_and_choice_are_permutations():
    a = torch.arange(1000, dtype=torch.int32)
    for name in ('shuffle', '_npi_shuffle'):
        s = get_op(name).fn(a)
        assert sorted(s.tolist()) == list(range(1000))
        assert s.tolist() != list(range(1000))
    c = get_op('_npi_choice').fn(50, size=(50,), replace=False)
    assert sorted(c.tolist()) == list(range(50)) and c.dtype == torch.int32
    c = get_op('_npi_choice').fn(4, size=(N,), p=[0.1, 0.2, 0.3, 0.4])
    freq = onp.bincount(c.numpy(), minlength=4) / N
    assert onp.abs(freq - [0.1, 0.2, 0.3, 0.4]).max() < 0.006


@pytest.mark.parametrize('name,kwargs', [
    ('random_uniform', dict(shape=(64,))),
    ('random_normal', dict(shape=(64,))),
    ('random_randint', dict(low=0, high=100, shape=(64,))),
    ('_npi_gamma', dict(size=(64,))), ('_npi_choice', dict(a=9, size=(8,))),
])
def test_the_same_seed_gives_the_same_draws(name, kwargs):
    mt.random.seed(7)
    a = get_op(name).fn(**kwargs)
    b = get_op(name).fn(**kwargs)
    mt.random.seed(7)
    c = get_op(name).fn(**kwargs)
    assert torch.equal(a, c) and not torch.equal(a, b)


def test_draws_come_from_the_ports_generator_and_its_state():
    mt.random.seed(11)
    torch.manual_seed(0)
    state = mt.random.get_state()
    a = mt.nd.random.normal(0, 1, shape=(32,), ctx=mt.cpu()).asnumpy()
    torch.manual_seed(99)            # torch's default generator: unused
    mt.random.set_state(state)
    b = mt.nd.random.normal(0, 1, shape=(32,), ctx=mt.cpu()).asnumpy()
    onp.testing.assert_array_equal(a, b)


def test_nd_random_namespace():
    x = mt.nd.random.uniform(0, 1, shape=(4, 5))
    assert x.shape == (4, 5) and x.dtype == onp.float32
    assert mt.nd.random.randn(3, 2).shape == (3, 2)
    assert mt.nd.random.randint(0, 5, shape=(7,)).dtype == onp.int32
    lo = mt.nd.array([0.0, 10.0])
    s = mt.nd.random.uniform(lo, lo + 1, shape=(3,))
    assert s.shape == (2, 3) and (s.asnumpy()[1] >= 10).all()
    assert mt.nd.random.shuffle(mt.nd.arange(6)).shape == (6,)
    for fn in (mt.nd.random.gamma, mt.nd.random.exponential,
               mt.nd.random.poisson, mt.nd.random.negative_binomial,
               mt.nd.random.generalized_negative_binomial):
        assert fn(shape=(5,)).shape == (5,)


def test_like_samplers_take_shape_dtype_and_device():
    x = torch.zeros((3, 4), dtype=torch.float16)
    for name in ('random_uniform_like', 'random_normal_like',
                 'random_gamma_like', 'random_exponential_like',
                 'random_poisson_like', 'random_negative_binomial_like',
                 'random_generalized_negative_binomial_like'):
        y = get_op(name).fn(x)
        assert y.shape == x.shape and y.dtype == x.dtype, name


def test_np_random_namespace_dtypes():
    assert mt.np.random.randint(0, 5, size=(4,)).dtype == onp.int32
    assert mt.np.random.uniform(size=(3,)).dtype == onp.float32
    assert mt.np.random.multinomial(5, [0.5, 0.5], size=(2,)).dtype == \
        onp.int32
    assert mt.npx.random.normal_n(0.0, 1.0, batch_shape=(6,)).shape == (6,)
