"""``mx.np`` and ``mx.npx`` of the port against the JAX package's, on the
CPU: every case of tests/test_numpy_op.py through both packages, the dtype
rules of the JAX package's x64-off arrays (a Python int list is int32,
argmax int32, the sum of a bool array int32, arange/zeros/eye float32,
indices int32), the ``ndarray`` type, and the frontend's functions, one
by one, on the same inputs in both (f32 at rtol 1e-5, atol 1e-6; integer
and bool results, dtypes and shapes exactly).
"""
import numpy as onp
import pytest

import mxnet_tpu as mj
import mxnet_tpu_torch as mt
from test_torch_jax_globals import jax_globals  # noqa: F401

RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True)
def _port_on_cpu():
    with mt.cpu():
        yield


def _np(v):
    return v.asnumpy() if hasattr(v, 'asnumpy') else onp.asarray(v)


def _same(got, want, exact=False):
    if isinstance(want, (tuple, list)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w, exact)
        return
    g, w = _np(got), _np(want)
    assert g.shape == w.shape, (g.shape, w.shape)
    assert g.dtype == w.dtype, (g.dtype, w.dtype)
    if exact or w.dtype.kind not in 'fc':
        onp.testing.assert_array_equal(g, w)
    else:
        onp.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)


@pytest.fixture(params=['jax', 'torch'])
def mx(request):
    return mj if request.param == 'jax' else mt


def assert_almost_equal(a, b, rtol=1e-5, atol=1e-6):
    onp.testing.assert_allclose(_np(a), _np(b), rtol=rtol, atol=atol)


# --- every case of tests/test_numpy_op.py, in both packages ----------------

def test_nan_reductions(mx):
    mnp = mx.np
    x = onp.array([[1.0, onp.nan, 3.0], [4.0, 5.0, onp.nan]], onp.float32)
    m = mnp.array(x)
    assert_almost_equal(mnp.nansum(m), onp.nansum(x))
    assert_almost_equal(mnp.nanmean(m, axis=1), onp.nanmean(x, axis=1))
    assert_almost_equal(mnp.nanmax(m, axis=0), onp.nanmax(x, axis=0))
    assert_almost_equal(mnp.nanstd(m), onp.nanstd(x), rtol=1e-5)


def test_float_manipulation(mx):
    mnp = mx.np
    x = onp.array([-1.5, 0.0, 2.5], onp.float32)
    m = mnp.array(x)
    assert_almost_equal(mnp.copysign(mnp.ones(3), m),
                        onp.copysign(onp.ones(3), x))
    assert_almost_equal(mnp.logaddexp(m, m), onp.logaddexp(x, x), rtol=1e-6)
    assert_almost_equal(mnp.heaviside(m, mnp.array(0.5)),
                        onp.heaviside(x, 0.5))
    assert_almost_equal(mnp.fmax(m, mnp.zeros(3)), onp.fmax(x, 0))
    assert bool(mnp.isposinf(mnp.array([onp.inf]))[0].item())
    assert_almost_equal(mnp.real(m), x)
    assert_almost_equal(mnp.conj(m), x)


def test_index_and_set_routines(mx):
    mnp = mx.np
    x = onp.array([3, 1, 2, 3], onp.int32)
    m = mnp.array(x)
    assert_almost_equal(mnp.unique(m), onp.unique(x))
    r, c = mnp.unravel_index(mnp.array([5]), (2, 3))
    assert r.item() == 1 and c.item() == 2
    assert_almost_equal(mnp.flatnonzero(mnp.array([0, 2, 0, 3])),
                        onp.flatnonzero(onp.array([0, 2, 0, 3])))
    assert bool(mnp.isin(mnp.array([2]), m)[0].item())


def test_einsum_tensordot(mx):
    mnp = mx.np
    rng = onp.random.RandomState(0)
    a = rng.rand(3, 4).astype(onp.float32)
    b = rng.rand(4, 5).astype(onp.float32)
    assert_almost_equal(mnp.einsum('ij,jk->ik', mnp.array(a), mnp.array(b)),
                        onp.einsum('ij,jk->ik', a, b), rtol=1e-5)
    assert_almost_equal(mnp.tensordot(mnp.array(a), mnp.array(b), axes=1),
                        onp.tensordot(a, b, axes=1), rtol=1e-5)


def test_linalg_namespace(mx):
    mnp = mx.np
    rng = onp.random.RandomState(1)
    a = rng.rand(4, 4).astype(onp.float32)
    a = a @ a.T + 4 * onp.eye(4, dtype=onp.float32)
    inv = mnp.linalg.inv(mnp.array(a))
    assert_almost_equal(mnp.matmul(mnp.array(a), inv), onp.eye(4),
                        rtol=1e-3, atol=1e-3)
    w, v = mnp.linalg.eigh(mnp.array(a))
    assert_almost_equal(onp.sort(w.asnumpy()),
                        onp.sort(onp.linalg.eigh(a)[0]), rtol=1e-4)


def test_interop_with_nd(mx):
    mnp = mx.np
    m = mnp.array([[1.0, 2.0]])
    n = m.as_nd_ndarray()
    assert type(n).__name__ == 'NDArray'
    back = n.as_np_ndarray() if hasattr(n, 'as_np_ndarray') \
        else mnp.array(n)
    assert_almost_equal(back, onp.array([[1.0, 2.0]]))


def test_npx_registry_bridge(mx):
    np, npx = mx.np, mx.npx
    a = np.array([[1., 2.], [3., 4.]])
    out = npx.leaky_relu(a)
    assert out.shape == (2, 2)
    assert float(npx.erf(np.array([0.0]))[0]) == 0.0
    assert npx.softmax(a).shape == (2, 2)
    with pytest.raises(AttributeError):
        npx.definitely_not_an_op


def test_npx_save_load_roundtrip(mx, tmp_path):
    np, npx = mx.np, mx.npx
    a = np.array([[1., 2.], [3., 4.]])
    f = str(tmp_path / 'x.params')
    npx.save(f, {'a': a})
    back = npx.load(f)
    assert onp.allclose(back['a'].asnumpy(), a.asnumpy())


def test_npx_random_samplers(mx):
    npx = mx.npx
    mx.random.seed(0)
    s = npx.random.bernoulli(0.5, size=(500,))
    assert 0.35 < float(s.asnumpy().mean()) < 0.65
    n = npx.random.normal_n(0.0, 1.0, batch_shape=(64,))
    assert n.shape == (64,)
    u = npx.random.uniform_n(0.0, 1.0, batch_shape=(8,))
    assert u.shape == (8,) and 0 <= float(u.asnumpy().min())


def test_npx_image_namespace(mx):
    npx = mx.npx
    img = mx.np.ones((8, 8, 3), dtype='float32') * 0.5
    assert npx.image.to_tensor(img).shape == (3, 8, 8)
    assert npx.image.flip_left_right(img).shape == (8, 8, 3)
    assert npx.image.flip_top_bottom(img).shape == (8, 8, 3)
    for name in ('random_brightness', 'random_contrast',
                 'random_saturation', 'random_hue'):
        assert getattr(npx.image, name)(img, 0.8, 1.2).shape == (8, 8, 3)
    assert npx.image.random_color_jitter(
        img, 0.2, 0.2, 0.2, 0.1).shape == (8, 8, 3)
    assert npx.image.random_lighting(img).shape == (8, 8, 3)
    img_u8 = mx.np.ones((8, 8, 3), dtype='uint8') * 128
    t = npx.image.normalize(npx.image.to_tensor(img_u8),
                            mean=(0.5, 0.5, 0.5), std=(0.2, 0.2, 0.2))
    onp.testing.assert_allclose(t.asnumpy(), (128 / 255.0 - 0.5) / 0.2,
                                atol=1e-5)


# --- the dtype rules of the JAX package's arrays ---------------------------

@pytest.mark.parametrize('case', [
    lambda np: np.array([1, 2]), lambda np: np.array([1.5, 2.0]),
    lambda np: np.array([True, False]),
    lambda np: np.argmax(np.array([[1.0, 3.0], [2.0, 0.5]]), axis=1),
    lambda np: np.argmin(np.array([1.0, 3.0])),
    lambda np: np.sum(np.array([True, False, True])),
    lambda np: np.sum(np.array([1, 2, 3])),
    lambda np: np.mean(np.array([1, 2, 4])),
    lambda np: np.cumsum(np.array([1, 2, 3])),
    lambda np: np.prod(np.array([1, 2, 3])),
    lambda np: np.arange(5), lambda np: np.zeros((2, 3)),
    lambda np: np.ones((2,)), lambda np: np.eye(3), lambda np: np.full(
        (2,), 7), lambda np: np.indices((2, 3)),
    lambda np: np.linspace(0, 1, 5), lambda np: np.identity(2),
    lambda np: np.array([1, 2]) / np.array([2, 4]),
    lambda np: np.array([1, 2]) + 1.5, lambda np: np.array([1, 2]) * 2,
    lambda np: np.sqrt(np.array([1, 4])),
    lambda np: np.floor(np.array([1, 4])),
    lambda np: np.rint(np.array([1, 4])),
    lambda np: np.bincount(np.array([0, 1, 1, 3])),
    lambda np: np.nonzero(np.array([0, 1, 1])),
    lambda np: np.searchsorted(np.array([1.0, 2.0, 3.0]),
                               np.array([2.5])),
    lambda np: np.unique(np.array([3, 1, 3]), return_counts=True),
    lambda np: np.random.randint(0, 4, size=(3,)).astype('int32') * 0,
], ids=lambda c: None)
def test_dtype_rules_match_jax(case):
    _same(case(mt.np), case(mj.np))


def test_ndarray_semantics():
    a = mt.np.array([[1.0, 2.0], [3.0, 4.0]])
    assert isinstance(a, mt.np.ndarray) and isinstance(a, mt.nd.NDArray)
    s = mt.np.sum(a)
    assert s.shape == () and isinstance(s, mt.np.ndarray)
    assert a[0].shape == (2,) and a[0, 1].shape == ()
    assert (a.T == mt.np.array([[1.0, 3.0], [2.0, 4.0]])).asnumpy().all()
    assert repr(mt.np.array([1, 2])) == repr(mj.np.array([1, 2]))
    assert a.reshape(4).shape == (4,) and a.tolist() == [[1, 2], [3, 4]]
    assert (a @ a).shape == (2, 2) and (1 - a).dtype == onp.float32
    assert a.context == mt.cpu()


# --- the frontend's functions, one by one, against the JAX package's -------

_X = onp.random.RandomState(5).uniform(0.1, 0.9, (3, 4)).astype(onp.float32)
_Y = onp.random.RandomState(6).uniform(0.1, 0.9, (3, 4)).astype(onp.float32)
_I = onp.asarray([[3, 1, 2, 3], [0, 5, 2, 1], [4, 4, 0, 2]], onp.int32)

_UNARY = ['sqrt', 'cbrt', 'square', 'exp', 'expm1', 'log', 'log2', 'log10',
          'log1p', 'sin', 'cos', 'tan', 'arcsin', 'arccos', 'arctan', 'sinh',
          'cosh', 'tanh', 'arcsinh', 'arctanh', 'degrees', 'radians',
          'abs', 'absolute', 'fabs', 'sign', 'floor', 'ceil', 'trunc',
          'rint', 'around', 'round', 'reciprocal', 'negative', 'sum', 'prod',
          'mean', 'std', 'var', 'min', 'max', 'amin', 'amax', 'argmin',
          'argmax', 'cumsum', 'cumprod', 'ravel', 'transpose', 'squeeze',
          'flip', 'fliplr', 'flipud', 'rot90', 'diag', 'diagonal',
          'diagflat', 'tril', 'triu', 'trace', 'sort', 'argsort',
          'count_nonzero', 'isnan', 'isinf', 'isfinite', 'nan_to_num',
          'median', 'average', 'cov', 'corrcoef', 'ediff1d', 'exp2',
          'isposinf', 'isneginf', 'positive', 'deg2rad', 'rad2deg', 'sinc',
          'i0', 'ptp', 'real', 'imag', 'conj', 'conjugate', 'angle',
          'flatnonzero', 'argwhere', 'signbit', 'iscomplex', 'isreal',
          'nansum', 'nanprod', 'nanmean', 'nanstd', 'nanvar', 'nanmin',
          'nanmax', 'nanargmin', 'nanargmax', 'nancumsum', 'nancumprod',
          'nanmedian', 'any', 'all', 'copy', 'fix', 'atleast_1d',
          'atleast_2d', 'atleast_3d', 'nonzero', 'zeros_like', 'ones_like',
          'shape', 'ndim', 'size', 'frexp', 'modf', 'unique', 'gradient',
          'logical_not', 'asarray']
_BINARY = ['add', 'subtract', 'multiply', 'divide', 'true_divide', 'mod',
           'remainder', 'power', 'arctan2', 'hypot', 'maximum', 'minimum',
           'logical_and', 'logical_or', 'logical_xor', 'equal', 'not_equal',
           'greater', 'greater_equal', 'less', 'less_equal', 'isclose',
           'allclose', 'array_equal', 'floor_divide', 'float_power',
           'copysign', 'nextafter', 'logaddexp', 'logaddexp2', 'fmax',
           'fmin', 'fmod', 'heaviside', 'divmod', 'inner', 'kron',
           'vdot', 'append', 'isin', 'union1d', 'intersect1d',
           'setdiff1d', 'in1d', 'broadcast_arrays']
_INT_UNARY = ['invert', 'bincount', 'unique', 'packbits', 'sum', 'cumsum',
              'argmax', 'sort', 'abs', 'sign', 'square']
_INT_BINARY = ['lcm', 'gcd', 'bitwise_and', 'bitwise_or', 'bitwise_xor',
               'left_shift', 'right_shift', 'floor_divide', 'mod',
               'add', 'multiply', 'power', 'maximum', 'true_divide']


def _both(fn):
    return fn(mt.np), fn(mj.np)


@pytest.mark.parametrize('name', _UNARY)
def test_unary_function_matches_jax(name):
    if name in ('sum', 'mean', 'min', 'max', 'argmax', 'cumsum', 'std'):
        _same(*_both(lambda np: getattr(np, name)(np.array(_X), axis=1)))
    x = _X.reshape(-1) if name in ('ediff1d', 'flatnonzero', 'unique') \
        else _X
    if name in ('diag', 'diagflat'):
        x = _X[0]
    got, want = _both(lambda np: getattr(np, name)(np.array(x)))
    if name in ('shape', 'ndim', 'size'):
        assert got == want
        return
    _same(got, want)


@pytest.mark.parametrize('name', _BINARY)
def test_binary_function_matches_jax(name):
    x, y = (_X[0], _Y[0]) if name in ('inner', 'vdot', 'union1d',
                                       'intersect1d', 'setdiff1d', 'in1d',
                                       'isin', 'kron') else (_X, _Y)
    got, want = _both(lambda np: getattr(np, name)(np.array(x), np.array(y)))
    if name in ('allclose', 'array_equal'):
        assert bool(got) == bool(want)
        return
    _same(got, want)


@pytest.mark.parametrize('name', _INT_UNARY)
def test_integer_unary_function_matches_jax(name):
    x = _I.reshape(-1) if name in ('bincount', 'unique') else _I
    _same(*_both(lambda np: getattr(np, name)(np.array(x))))


@pytest.mark.parametrize('name', _INT_BINARY)
def test_integer_binary_function_matches_jax(name):
    _same(*_both(lambda np: getattr(np, name)(np.array(_I),
                                              np.array(_I % 3 + 1))))


@pytest.mark.parametrize('case', [
    lambda np: np.reshape(np.array(_X), (4, 3)),
    lambda np: np.swapaxes(np.array(_X), 0, 1),
    lambda np: np.moveaxis(np.array(_X), 0, 1),
    lambda np: np.rollaxis(np.array(_X), 1),
    lambda np: np.expand_dims(np.array(_X), 1),
    lambda np: np.tile(np.array(_X), (2, 1)),
    lambda np: np.repeat(np.array(_X), 2, axis=0),
    lambda np: np.roll(np.array(_X), 2),
    lambda np: np.broadcast_to(np.array(_X[0]), (2, 4)),
    lambda np: np.concatenate([np.array(_X), np.array(_Y)], axis=1),
    lambda np: np.stack([np.array(_X), np.array(_Y)]),
    lambda np: np.vstack([np.array(_X), np.array(_Y)]),
    lambda np: np.hstack([np.array(_X), np.array(_Y)]),
    lambda np: np.dstack([np.array(_X), np.array(_Y)]),
    lambda np: np.column_stack([np.array(_X[0]), np.array(_Y[0])]),
    lambda np: np.split(np.array(_X), 2, axis=1),
    lambda np: np.array_split(np.array(_X), 3, axis=1),
    lambda np: np.hsplit(np.array(_X), 2),
    lambda np: np.vsplit(np.array(_X), 3),
    lambda np: np.take(np.array(_X), np.array([0, 2]), axis=1),
    lambda np: np.take_along_axis(np.array(_X), np.array(_I[:, :2] % 4),
                                  axis=1),
    lambda np: np.where(np.array(_X) > 0.5, np.array(_X), np.array(_Y)),
    lambda np: np.where(np.array(_X) > 0.5, np.array(_X), 0.0),
    lambda np: np.clip(np.array(_X), 0.3, 0.6),
    lambda np: np.pad(np.array(_X), 1),
    lambda np: np.pad(np.array(_X), ((1, 0), (0, 2)), mode='edge'),
    lambda np: np.pad(np.array(_X), 2, mode='reflect'),
    lambda np: np.insert(np.array(_X[0]), 1, 9.0),
    lambda np: np.insert(np.array(_X[0]), np.array([0, 2]), 9.0),
    lambda np: np.delete(np.array(_X[0]), 1),
    lambda np: np.delete(np.array(_X), slice(0, 2), axis=1),
    lambda np: np.percentile(np.array(_X), 30.0),
    lambda np: np.quantile(np.array(_X), 0.7, axis=0),
    lambda np: np.nanpercentile(np.array(_X), 40.0),
    lambda np: np.nanquantile(np.array(_X), 0.4),
    lambda np: np.linspace(0, 2, 7), lambda np: np.logspace(0, 2, 5),
    lambda np: np.meshgrid(np.array(_X[0]), np.array(_Y[:, 0])),
    lambda np: np.tril_indices(3), lambda np: np.triu_indices(3, 1),
    lambda np: np.diag_indices(3),
    lambda np: np.dot(np.array(_X), np.array(_Y).T),
    lambda np: np.matmul(np.array(_X), np.array(_Y).T),
    lambda np: np.outer(np.array(_X[0]), np.array(_Y[0])),
    lambda np: np.cross(np.array(_X[:, :3]), np.array(_Y[:, :3])),
    lambda np: np.polyval(np.array(_X[0]), np.array(_Y[0])),
    lambda np: np.vander(np.array(_X[0]), 3),
    lambda np: np.interp(np.array(_X[0]), np.array([0.0, 0.5, 1.0]),
                         np.array([1.0, 3.0, 2.0])),
    lambda np: np.histogram(np.array(_X), bins=4),
    lambda np: np.digitize(np.array(_X[0]), np.array([0.25, 0.5, 0.75])),
    lambda np: np.convolve(np.array(_X[0]), np.array([1.0, 0.5])),
    lambda np: np.correlate(np.array(_X[0]), np.array([1.0, 0.5])),
    lambda np: np.diff(np.array(_X), axis=0),
    lambda np: np.trim_zeros(np.array([0.0, 1.0, 2.0, 0.0])),
    lambda np: np.resize(np.array(_X[0]), (2, 3)),
    lambda np: np.extract(np.array(_X) > 0.5, np.array(_X)),
    lambda np: np.compress(np.array([True, False, True]), np.array(_X),
                           axis=0),
    lambda np: np.choose(np.array([0, 1, 0, 1]), [np.array(_X[0]),
                                                  np.array(_Y[0])]),
    lambda np: np.select([np.array(_X) > 0.5], [np.array(_X)]),
    lambda np: np.ravel_multi_index((np.array([1, 2]), np.array([0, 3])),
                                    (3, 4)),
    lambda np: np.unpackbits(np.array([3, 255], dtype='uint8')),
    lambda np: np.packbits(np.array([1, 0, 1, 1, 0, 0, 0, 1, 1])),
    lambda np: np.full_like(np.array(_X), 2.5),
    lambda np: np.empty((2, 2)) * 0,
    lambda np: np.ldexp(np.array(_X), np.array([1, 2, 3, 4])),
    lambda np: np.apply_along_axis(lambda r: r * 2, 1, np.array(_X)),
    lambda np: np.polyfit(np.array([0.0, 1.0, 2.0, 3.0]),
                          np.array([1.0, 3.0, 5.0, 7.0]), 1),
    lambda np: np.linalg.norm(np.array(_X)),
    lambda np: np.linalg.det(np.array(_X[:, :3])),
    lambda np: np.linalg.slogdet(np.array(_X[:, :3])),
    lambda np: np.linalg.solve(np.array(_X[:, :3]) + 2 * np.eye(3),
                               np.array(_Y[:, 0])),
    lambda np: np.linalg.pinv(np.array(_X)),
    lambda np: np.linalg.matrix_rank(np.array(_X)),
    lambda np: np.linalg.svd(np.array(_X), compute_uv=False),
    lambda np: np.linalg.multi_dot([np.array(_X), np.array(_Y).T,
                                    np.array(_X)]),
    lambda np: np.linalg.matrix_power(np.array(_X[:, :3]), 3),
    lambda np: np.linalg.eigvalsh(np.array(_X[:, :3]) @ np.array(
        _X[:, :3]).T),
    lambda np: np.linalg.lstsq(np.array(_X.T), np.array(_Y[0]))[0],
    lambda np: np.linalg.qr(np.array(_X.T))[1] * 0 + 1,
    lambda np: np.linalg.cholesky(np.array(_X[:, :3]) @ np.array(
        _X[:, :3]).T + np.eye(3)),
    lambda np: np.linalg.tensorinv(np.array(
        _X[:, :3] + 2 * onp.eye(3, dtype=onp.float32)), ind=1),
])
def test_structural_function_matches_jax(case):
    _same(*_both(case))


def test_dtype_helpers_and_partition_match_jax():
    for a, b in (('float16', 'float32'), ('int32', 'float32'),
                 ('int8', 'uint8'), ('int64', 'float64')):
        assert mt.np.promote_types(a, b) == mj.np.promote_types(a, b)
    assert mt.np.result_type(mt.np.array([1, 2]), 1.5) == \
        mj.np.result_type(mj.np.array([1, 2]), 1.5)
    assert mt.np.can_cast('int8', 'int32') == mj.np.can_cast('int8', 'int32')
    assert mt.np.finfo('float32').eps == mj.np.finfo('float32').eps
    assert mt.np.iinfo('int8').max == mj.np.iinfo('int8').max
    assert mt.np.iterable(mt.np.array([1])) == mj.np.iterable(
        mj.np.array([1]))
    got, want = _both(lambda np: np.partition(np.array(_X[0]), 2))
    assert _np(got)[2] == _np(want)[2]
    onp.testing.assert_array_equal(onp.sort(_np(got)), onp.sort(_np(want)))
    _same(*_both(lambda np: np.ascontiguousarray(np.array(_X))))
    _same(*_both(lambda np: np.arccosh(np.array(_X) + 1.5)))
    _same(*_both(lambda np: np.dsplit(np.array(_X.reshape(1, 3, 4)), 2)))


def test_apply_over_axes_takes_mx_np_functions_unlike_jax():
    """The JAX frontend hands its own ndarray to jnp.apply_over_axes,
    which refuses it; the port gives numpy's result (ROADMAP queue 3)."""
    with pytest.raises(TypeError):
        mj.np.apply_over_axes(mj.np.sum, mj.np.array(_X), [0, 1])
    got = mt.np.apply_over_axes(mt.np.sum, mt.np.array(_X), [0, 1])
    onp.testing.assert_allclose(got.asnumpy(), onp.apply_over_axes(
        onp.sum, _X, [0, 1]), rtol=RTOL)


def test_frontend_exports_the_jax_names():
    names = {k for k in dir(mj.np) if not k.startswith('_')}
    port = {k for k in dir(mt.np) if not k.startswith('_')}
    assert names - {'jax', 'jnp', 'annotations'} <= port
    assert len(names - {'jax', 'jnp', 'annotations'}) == 278
    npx = {k for k in dir(mj.npx) if not k.startswith('_')}
    assert npx - {'jax', 'jnp', 'annotations'} <= \
        {k for k in dir(mt.npx) if not k.startswith('_')}


def test_util_switches_are_thread_local():
    import threading
    from mxnet_tpu_torch import util
    seen = {}
    util.set_np(shape=True, array=True)
    try:
        t = threading.Thread(target=lambda: seen.update(
            arr=util.is_np_array()))
        t.start()
        t.join()
        assert util.is_np_array() and seen['arr'] is False
        with util.np_array(False):
            assert not util.is_np_array()
        assert util.is_np_array()

        @util.use_np
        def f():
            return util.is_np_shape(), util.is_np_array()
        util.reset_np()
        assert f() == (True, True)
        assert (util.is_np_shape(), util.is_np_array()) == (False, False)
    finally:
        util.set_np_shape(True)
        util.set_np_array(False)
    util.setenv('MXTPU_TEST_UTIL_VAR', 'x')
    assert util.getenv('MXTPU_TEST_UTIL_VAR') == 'x'


@pytest.mark.parametrize('pkg', ['jax', 'torch'])
def test_registry_module(pkg):
    """tests/test_misc_modules.py's registry cases through both."""
    m = mj if pkg == 'jax' else mt
    registry = m.registry

    class Base:
        pass

    register = registry.get_register_func(Base, 'thing')
    alias = registry.get_alias_func(Base, 'thing')
    create = registry.get_create_func(Base, 'thing')

    @register
    @alias('fx')
    class FooThing(Base):
        def __init__(self, v=1):
            self.v = v

    assert isinstance(create('foothing'), FooThing)
    assert isinstance(create('fx'), FooThing)
    assert create('{"name": "foothing", "v": 7}').v == 7
    with pytest.raises(m.MXNetError):
        create('nope')

    class B2:
        pass

    create2 = registry.get_create_func(B2, 'widget')
    with pytest.raises(m.MXNetError, match='invalid widget config'):
        create2('{"v": 7}')
    with pytest.raises(m.MXNetError):
        create2('{not json')


def test_top_level_exports():
    for name in ('np', 'npx', 'numpy', 'numpy_extension', 'util',
                 'registry', 'seed', 'list_ops', 'register_op',
                 'test_utils'):
        assert hasattr(mt, name), name
    assert mt.list_ops() == sorted(mt.base._OP_REGISTRY)
    assert mt.nd.linalg.gemm2 and mt.nd.random.normal
