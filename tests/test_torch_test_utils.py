"""The port's ``test_utils`` against the JAX package's, on the CPU.

Every public name of ``mxnet_tpu.test_utils`` is in the port's. The ten
cases of tests/test_test_utils.py run through both packages; the
helpers that draw from numpy's global generator give the same arrays in
both from the same seed (bitwise: the same numpy calls), the synthetic
MNIST set among them; the check helpers pass and fail alike. One
difference is pinned: with ``MXNET_TEST_DEVICE`` unset,
``default_context()`` is the port's current context (the card outside a
``with mx.cpu():`` scope) where the JAX package's is the CPU.
"""
import inspect

import numpy as onp
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu import test_utils as jtu
from mxnet_tpu_torch import test_utils as tu
from test_torch_jax_globals import jax_globals  # noqa: F401

PKGS = {'jax': jmx, 'port': mx}


@pytest.fixture(autouse=True)
def _cpu():
    with mx.cpu():
        yield


def _public(mod):
    return {n for n, v in vars(mod).items() if not n.startswith('_') and
            (inspect.isfunction(v) or inspect.isclass(v)) and
            v.__module__ == mod.__name__}


def test_every_public_name_of_the_jax_module_is_in_the_port():
    missing = sorted(_public(jtu) - set(dir(tu)))
    assert not missing
    assert _public(jtu) <= set(tu.__all__)
    assert len(_public(jtu)) == 71


def test_mnist_synthetic_set_is_the_jax_packages(monkeypatch):
    monkeypatch.delenv('MXNET_TPU_MNIST_DIR', raising=False)
    got, want = tu.get_mnist(), jtu.get_mnist()
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        onp.testing.assert_array_equal(got[k], want[k])


def test_mnist_reads_idx_files(tmp_path, monkeypatch):
    import struct

    def write(name, arr):
        with open(tmp_path / name, 'wb') as f:
            f.write(struct.pack('>I', 0x800 | arr.ndim))
            f.write(struct.pack('>' + 'I' * arr.ndim, *arr.shape))
            f.write(arr.astype(onp.uint8).tobytes())
    rs = onp.random.RandomState(3)
    imgs = rs.randint(0, 256, (5, 28, 28))
    labs = rs.randint(0, 10, (5,))
    for stem in ('train', 't10k'):
        write(f'{stem}-images-idx3-ubyte', imgs)
        write(f'{stem}-labels-idx1-ubyte', labs)
    monkeypatch.setenv('MXNET_TPU_MNIST_DIR', str(tmp_path))
    got, want = tu.get_mnist(), jtu.get_mnist()
    for k in want:
        onp.testing.assert_array_equal(got[k], want[k])
    assert got['train_data'].shape == (5, 1, 28, 28)
    onp.testing.assert_array_equal(got['test_label'], labs)


@pytest.mark.parametrize('pkg', ['jax', 'port'])
def test_sparse_generators(pkg):
    t = {'jax': jtu, 'port': tu}[pkg]
    arr, dense = t.rand_sparse_ndarray((16, 10), 'csr', density=0.3)
    assert arr.stype == 'csr'
    onp.testing.assert_allclose(arr.asnumpy(), dense)
    assert 0.05 < (dense != 0).mean() < 0.6
    arr, dense = t.rand_sparse_ndarray((12, 6), 'row_sparse', density=0.5)
    assert arr.stype == 'row_sparse'
    onp.testing.assert_allclose(arr.asnumpy(), dense)
    pl, dense = t.rand_sparse_ndarray((8, 16), 'csr', density=0.2,
                                      distribution='powerlaw')
    assert (pl.asnumpy()[0] != 0).sum() >= 1


@pytest.mark.parametrize('stype, kw', [
    ('csr', dict(density=0.3)), ('row_sparse', dict(density=0.5)),
    ('csr', dict(density=0.2, distribution='powerlaw')),
    ('row_sparse', dict(rsp_indices=[1, 4, 5]))])
def test_sparse_generators_draw_the_same_arrays(stype, kw):
    out = {}
    for pkg, t in (('jax', jtu), ('port', tu)):
        onp.random.seed(11)
        arr, dense = t.rand_sparse_ndarray((12, 10), stype, **kw)
        out[pkg] = (arr.asnumpy(), dense)
    for g, w in zip(out['port'], out['jax']):
        onp.testing.assert_array_equal(g, w)


@pytest.mark.parametrize('pkg', ['jax', 'port'])
def test_create_sparse_array_modifier_and_zd(pkg):
    t = {'jax': jtu, 'port': tu}[pkg]
    d = t.create_sparse_array((10, 8), 'csr', density=0.4,
                              modifier_func=lambda x: 2.0).asnumpy()
    assert set(onp.unique(d)).issubset({0.0, 2.0})
    z = t.create_sparse_array_zd((10, 8), 'csr', density=0)
    assert (z.asnumpy() == 0).all()


@pytest.mark.parametrize('pkg', ['jax', 'port'])
def test_shuffle_csr_column_indices_preserves_value(pkg):
    t = {'jax': jtu, 'port': tu}[pkg]
    arr, dense = t.rand_sparse_ndarray((10, 12), 'csr', density=0.3)
    onp.testing.assert_allclose(t.shuffle_csr_column_indices(arr).asnumpy(),
                                dense)


@pytest.mark.parametrize('pkg', ['jax', 'port'])
@pytest.mark.parametrize('draw, buckets, probs, bound', [
    (lambda rng, n: rng.randint(0, 4, n), [0, 1, 2, 3], [0.25] * 4, 20),
    (lambda rng, n: rng.rand(n), [(0, .5), (.5, 1.0)], [0.5, 0.5], 15)])
def test_chi_square_check(pkg, draw, buckets, probs, bound):
    t = {'jax': jtu, 'port': tu}[pkg]
    rng = onp.random.RandomState(0)
    chi2, counts = t.chi_square_check(lambda n: draw(rng, n),
                                      buckets=buckets, probs=probs,
                                      nsamples=20000)
    assert chi2 < bound, chi2
    assert counts.sum() == 20000


def test_sampler_checks_agree_on_the_port_samplers():
    """verify_generator, mean_check and var_check over the port's own
    sampler (on NDArrays) pass, and give the JAX helpers' answers on the
    same numpy draws."""
    import scipy.stats as ss
    buckets, probs = tu.gen_buckets_probs_with_ppf(ss.norm.ppf, 5)
    jb, jp = jtu.gen_buckets_probs_with_ppf(ss.norm.ppf, 5)
    assert (buckets, probs) == (jb, jp)
    mx.random.seed(4)

    def gen(n):
        return mx.nd.random.normal(0, 1, shape=(n,))
    assert tu.verify_generator(gen, buckets, probs, nsamples=20000)
    assert tu.mean_check(gen, 0.0, 1.0, nsamples=20000)
    assert tu.var_check(gen, 1.0, nsamples=20000)
    for name in ('verify_generator', 'mean_check', 'var_check'):
        args = {'verify_generator': (buckets, probs), 'mean_check': (0.0, 1.0),
                'var_check': (1.0,)}[name]
        res = []
        for t in (jtu, tu):
            rng = onp.random.RandomState(9)
            res.append(getattr(t, name)(lambda n: rng.standard_normal(n),
                                        *args, nsamples=5000))
        assert res[0] == res[1], name


@pytest.mark.parametrize('pkg', ['jax', 'port'])
def test_get_mnist_and_iterator(pkg):
    t = {'jax': jtu, 'port': tu}[pkg]
    m = t.get_mnist()
    assert m['train_data'].shape[1:] == (1, 28, 28)
    assert m['train_label'].max() <= 9
    train, val = t.get_mnist_iterator(32)
    batch = next(iter(train))
    assert batch.data[0].shape == (32, 1, 28, 28)


@pytest.mark.parametrize('pkg', ['jax', 'port'])
def test_same_symbol_structure(pkg):
    m = PKGS[pkg]
    t = {'jax': jtu, 'port': tu}[pkg]

    def build():
        x = m.sym.Variable('x')
        return m.sym.Activation(m.sym.FullyConnected(
            x, num_hidden=4, name='fc'), act_type='relu')
    assert t.same_symbol_structure(build(), build())
    other = m.sym.FullyConnected(m.sym.Variable('x'), num_hidden=4,
                                 name='fc')
    assert not t.same_symbol_structure(build(), other)


@pytest.mark.parametrize('pkg', ['jax', 'port'])
def test_env_and_context_helpers(pkg, monkeypatch):
    m = PKGS[pkg]
    t = {'jax': jtu, 'port': tu}[pkg]
    import os
    monkeypatch.delenv('MXTPU_TEST_ENV_VAR', raising=False)
    t.set_env_var('MXTPU_TEST_ENV_VAR', 'yes')
    assert os.environ['MXTPU_TEST_ENV_VAR'] == 'yes'
    os.environ.pop('MXTPU_TEST_ENV_VAR', None)
    with t.EnvManager('MXTPU_TEST_ENV_VAR', 'in'):
        assert os.environ['MXTPU_TEST_ENV_VAR'] == 'in'
    assert 'MXTPU_TEST_ENV_VAR' not in os.environ
    assert t.get_etol() == 0.0 and t.get_etol(0.1) == 0.1
    assert t.has_tvm_ops() is False
    assert t.is_op_runnable() is True
    assert isinstance(t.list_gpus(), list)
    t.set_default_context(m.cpu(0))
    try:
        assert t.default_context().device_type == 'cpu'
    finally:
        m.context.Context._default_ctx.stack.pop()


def test_default_context_differs_from_the_jax_packages(monkeypatch):
    """``MXNET_TEST_DEVICE`` is honoured by both; unset, the port's
    default is its current context (the card outside a CPU scope), the
    JAX package's the CPU."""
    monkeypatch.delenv('MXNET_TEST_DEVICE', raising=False)
    assert jtu.default_context().device_type == 'cpu'
    assert tu.default_context() == mx.cpu()
    stack = mx.context.Context._default_ctx.stack
    saved = list(stack)
    stack.clear()
    try:
        assert tu.default_context() == mx.gpu(0)
    finally:
        stack.extend(saved)
    for dev, kind in (('gpu', 'gpu'), ('cpu', 'cpu')):
        monkeypatch.setenv('MXNET_TEST_DEVICE', dev)
        assert tu.default_context().device_type == kind
        assert jtu.default_context().device_type == kind


@pytest.mark.parametrize('pkg', ['jax', 'port'])
def test_matrix_generators(pkg):
    t = {'jax': jtu, 'port': tu}[pkg]
    m = t.new_sym_matrix_with_real_eigvals_2d(5)
    onp.testing.assert_allclose(m, m.T)
    q = t.new_orthonormal_matrix_2d(4)
    onp.testing.assert_allclose(q @ q.T, onp.eye(4), atol=1e-5)
    a = t.new_matrix_with_real_eigvals_2d(4)
    assert onp.abs(onp.linalg.eigvals(a).imag).max() < 1e-5
    assert t.new_matrix_with_real_eigvals_nd(3, ndim=2).shape == (2, 3, 3)


@pytest.mark.parametrize('name, args', [
    ('random_arrays', ((2, 3), (4,))), ('random_arrays', ((2, 2),)),
    ('random_uniform_arrays', ((3, 2),)), ('rand_shape_2d', ()),
    ('rand_shape_3d', ()), ('rand_shape_nd', (4,)),
    ('random_sample', (list('abcdefg'), 3)), ('rand_coord_2d', (0, 5, 1, 9)),
    ('new_sym_matrix_with_real_eigvals_nd', (3,)),
    ('new_matrix_with_real_eigvals_nd', (3, 2)),
    ('create_2d_tensor', (2, 3)), ('create_vector', (4,))])
def test_generators_draw_the_same_arrays(name, args):
    out = []
    for t in (jtu, tu):
        onp.random.seed(17)
        out.append(getattr(t, name)(*args))

    def same(a, b):
        if isinstance(a, (list, tuple)):
            assert type(a) is type(b) and len(a) == len(b)
            for x, y in zip(a, b):
                same(x, y)
        else:
            assert onp.asarray(a).dtype == onp.asarray(b).dtype
            onp.testing.assert_array_equal(a, b)
    same(out[1], out[0])


@pytest.mark.parametrize('pkg', ['jax', 'port'])
def test_parse_location_and_shapes(pkg):
    m = PKGS[pkg]
    t = {'jax': jtu, 'port': tu}[pkg]
    s = m.sym.sin(m.sym.Variable('a'))
    loc = t._parse_location(s, {'a': onp.ones((2, 2), onp.float32)})
    assert set(loc) == {'a'}
    with pytest.raises(ValueError):
        t._parse_location(s, {'bogus': onp.ones((2, 2))})
    t.check_shapes((2, 3), (2, 3))
    with pytest.raises(AssertionError):
        t.check_shapes((2, 3), (3, 2))
    assert t.location_error((2,), (3,), 'a') == \
        jtu.location_error((2,), (3,), 'a')


def test_comparisons_pass_and_fail_alike():
    a = onp.array([1.0, 2.0, onp.nan], onp.float32)
    b = onp.array([1.0, 2.0 + 1e-3, onp.nan], onp.float32)
    for t in (jtu, tu):
        assert t.almost_equal_ignore_nan(a, a)
        assert not t.almost_equal_ignore_nan(a, b)
        assert t.almost_equal_ignore_nan(a, b, rtol=1e-2)
        with pytest.raises(AssertionError):
            t.assert_almost_equal_ignore_nan(a, b)
        t.assert_almost_equal_with_err(a[:2], b[:2], etol=0.5)
        with pytest.raises(AssertionError):
            t.assert_almost_equal_with_err(a[:2], b[:2], etol=0.1)
        assert t.same(a[:2], a[:2].copy())
        t.assert_exception(lambda: 1 / 0, ZeroDivisionError)
        with pytest.raises(AssertionError):
            t.assert_exception(lambda: 1, ZeroDivisionError)
        assert t.find_max_violation(a[:2], b[:2]) == \
            jtu.find_max_violation(a[:2], b[:2])
        assert t.get_rtol('float16') == 1e-2 and t.get_atol() == 1e-5
        assert t.get_rtol('bfloat16') == 2e-2
        onp.testing.assert_array_equal(
            t.collapse_sum_like(onp.ones((2, 3, 4)), (3, 1)),
            onp.full((3, 1), 8.0))
        onp.testing.assert_array_equal(
            t.np_reduce(onp.arange(24.0).reshape(2, 3, 4), (0, 2), True,
                        onp.sum),
            jtu.np_reduce(onp.arange(24.0).reshape(2, 3, 4), (0, 2), True,
                          onp.sum))
    import torch
    assert tu.get_rtol(torch.bfloat16) == 2e-2
    assert tu.get_tolerance(onp.zeros(2, onp.float64)) == (1e-6, 1e-8)


def test_gradient_and_symbol_checks():
    """check_numeric_gradient, numeric_grad, check_symbolic_forward and
    _backward, simple_forward and check_consistency on the port."""
    rs = onp.random.RandomState(5)
    x = rs.rand(3, 2).astype(onp.float32)
    tu.check_numeric_gradient(lambda a: (a * a).sum(), [x], eps=1e-2)
    (g,) = tu.numeric_grad(lambda a: (a ** 3).sum(), [x.astype(onp.float64)])
    onp.testing.assert_allclose(g, 3 * x.astype(onp.float64) ** 2,
                                rtol=1e-6)
    s = mx.sym.Variable('a') * 2.0 + mx.sym.sin(mx.sym.Variable('b'))
    b = rs.rand(3, 2).astype(onp.float32)
    want = x * 2.0 + onp.sin(b)
    tu.check_symbolic_forward(s, {'a': x, 'b': b}, [want])
    tu.check_symbolic_forward(s, [x, b], want)
    onp.testing.assert_allclose(tu.simple_forward(s, a=x, b=b), want,
                                rtol=1e-6)
    og = onp.ones_like(x)
    grads = tu.check_symbolic_backward(s, {'a': x, 'b': b}, og,
                                       {'a': 2 * og, 'b': onp.cos(b)})
    assert set(grads) == {'a', 'b'}
    res = tu.check_consistency(lambda v: v * 3, [mx.nd.array(x)],
                               ctx_list=[mx.cpu(), mx.cpu()])
    onp.testing.assert_allclose(res[0], 3 * x)
    with pytest.raises(AssertionError):
        tu.check_symbolic_forward(s, {'a': x, 'b': b}, [want + 1])


def test_hybridize_consistency_and_helpers():
    def dense():
        mx.random.seed(1)
        return mx.gluon.nn.Dense(3, in_units=2)
    tu.check_gluon_hybridize_consistency(dense,
                                         [onp.ones((4, 2), onp.float32)])
    it = tu.DummyIter('batch')
    assert next(it) == next(iter(it)) == 'batch'
    a = mx.nd.array(onp.ones(3, onp.float32))
    assert tu.same_array(a, mx.torch.from_torch(mx.torch.to_torch(a)))
    assert not tu.same_array(a, a.copy())
    assert tu.check_speed(lambda: None, n=3, warmup=1) >= 0.0
    calls = []

    @tu.retry(3)
    def flaky():
        calls.append(1)
        assert len(calls) == 3
    flaky()
    assert len(calls) == 3
    tu.compare_ndarray_tuple((a, (a,)), (a, (a,)))
    assert tu.is_cd_run() is False
    with tu.discard_stderr():
        import sys
        print('hidden', file=sys.stderr)


def test_zip_and_bz2_unpack_local_files(tmp_path):
    import bz2
    import zipfile
    with zipfile.ZipFile(tmp_path / 'd.zip', 'w') as z:
        z.writestr('inner.txt', 'zipped')
    tu.get_zip_data(str(tmp_path), 'http://unused', 'd.zip')
    assert (tmp_path / 'inner.txt').read_text() == 'zipped'
    with bz2.BZ2File(tmp_path / 'd.bz2', 'wb') as f:
        f.write(b'packed')
    tu.get_bz2_data(str(tmp_path), 'd.txt', 'http://unused', 'd.bz2')
    assert (tmp_path / 'd.txt').read_bytes() == b'packed'
    tu.get_bz2_data(str(tmp_path), 'absent.txt', 'http://unused', 'no.bz2')
    assert not (tmp_path / 'absent.txt').exists()
