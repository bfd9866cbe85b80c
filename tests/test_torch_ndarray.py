"""The port's ``mx.nd`` against the JAX package's on the CPU: every case of
tests/test_ndarray.py, then each registered op family, on the same numpy
inputs through ``mxnet_tpu.nd`` and ``mxnet_tpu_torch.nd``
(``ctx=mx.cpu()``).

Tolerance: values that both packages compute exactly (creation, shapes,
indexing, integer and comparison results, sorting) must be equal; float
math may differ in the last bits (another summation order, another libm),
so it is held to rtol 1e-5, atol 1e-6 in float32. dtypes must be equal,
except bfloat16, which the port's ``asnumpy`` widens to float32.
"""
import numpy as onp
import pytest
import torch

import mxnet_tpu as mj
import mxnet_tpu_torch as mt
from mxnet_tpu import nd as ndj
from mxnet_tpu_torch import nd as ndt
from test_torch_jax_globals import jax_globals  # noqa: F401

RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True)
def _port_on_cpu():
    with mt.cpu():
        yield


def _np(v):
    if isinstance(v, (mj.nd.NDArray, mt.nd.NDArray)):
        return v.asnumpy()
    return onp.asarray(v)


def assert_same(got, want, exact=False):
    """Port result ``got`` against JAX result ``want`` (NDArrays, numbers,
    tuples or dicts of them)."""
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            assert_same(got[k], want[k], exact)
        return
    if isinstance(want, (tuple, list)) and not isinstance(got, onp.ndarray):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert_same(g, w, exact)
        return
    g, w = _np(got), _np(want)
    assert g.shape == w.shape, (g.shape, w.shape)
    assert g.dtype == w.dtype, (g.dtype, w.dtype)
    if exact or not onp.issubdtype(w.dtype, onp.floating):
        onp.testing.assert_array_equal(g, w)
    else:
        onp.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)


def both(case, exact=False):
    """Run ``case(mx, nd)`` through both packages and compare."""
    want = case(mj, ndj)
    got = case(mt, ndt)
    assert_same(got, want, exact)
    return got


# ---- every case of tests/test_ndarray.py -----------------------------------

def test_creation():
    got = both(lambda mx, nd: dict(
        zeros=nd.zeros((2, 3)), ones=nd.ones((2, 3)),
        full=nd.full((2, 2), 7.0), array=nd.array([[1, 2], [3, 4]]),
        arange=nd.arange(0, 10, 2), ints=nd.array(onp.arange(4)),
        f64=nd.array(onp.ones(3, onp.float64))), exact=True)
    assert got['zeros'].dtype == onp.float32
    assert got['ints'].dtype == onp.int32


def test_arithmetic():
    def case(mx, nd):
        a = nd.array([[1., 2.], [3., 4.]])
        b = nd.array([[5., 6.], [7., 8.]])
        return [a + b, a - b, a * b, b / a, a + 1, 2 * a, 1 / a, a ** 2, -a,
                3 - a, 2 ** a, a % 3, a / 4]
    both(case)


def test_inplace():
    def case(mx, nd):
        a = nd.ones((2, 2))
        orig = a
        a += 1
        after_add = orig.asnumpy()
        a *= 3
        a -= 1
        a /= 2
        return [after_add, orig]
    both(case, exact=True)


def test_comparisons():
    def case(mx, nd):
        a = nd.array([1., 2., 3.])
        b = nd.array([2., 2., 2.])
        i = nd.array([1, 2, 3])
        return [a > b, a >= b, a == b, a != b, a < b, a <= b, a > 2, a == 2,
                i > 1, i != 2]
    got = both(case, exact=True)
    assert got[-1].dtype == onp.int32     # 0/1 in the lhs dtype


def test_indexing():
    def case(mx, nd):
        a = nd.array(onp.arange(12).reshape(3, 4))
        out = [a[1], a[1:3], a[2, 3].asscalar(), a[:, 1], a[nd.array([2, 0])]]
        a[1] = 0
        out.append(a.copy())
        a[0, 2] = 7
        a[nd.array([2])] = -1
        out.append(a.copy())
        a[:] = 5
        out.append(a)
        return out
    both(case, exact=True)


def test_shape_methods():
    def case(mx, nd):
        a = nd.array(onp.arange(24).reshape(2, 3, 4))
        parts = a.split(3, axis=1)
        return [a.reshape(6, 4), a.reshape((-1,)), a.reshape(0, -1),
                a.transpose(), a.transpose(1, 0, 2), a.flatten(),
                a.expand_dims(0), a.swapaxes(0, 2), nd.concat(a, a, dim=1),
                nd.stack(a, a, axis=0), len(parts), parts[0], parts[2],
                a.T.shape, a.squeeze().shape, a.tile((1, 2, 1)),
                a.repeat(2, axis=0), a.broadcast_to((2, 2, 3, 4)),
                a.slice_axis(2, 1, 3)]
    both(case, exact=True)


def test_reduce():
    def case(mx, nd):
        a = nd.array(onp.arange(6).reshape(2, 3).astype(onp.float32))
        return [a.sum(), a.sum(axis=0), a.mean(axis=1), a.max(), a.min(),
                a.argmax(axis=1), a.argmin(), nd.norm(a), a.prod(axis=1),
                a.sum(axis=1, keepdims=True), a.norm(ord=1, axis=0)]
    both(case)


def test_dot():
    rng = onp.random.RandomState(0)
    a, b = rng.rand(3, 4).astype('f'), rng.rand(4, 5).astype('f')
    x, y = rng.rand(2, 3, 4).astype('f'), rng.rand(2, 4, 5).astype('f')
    v = rng.rand(4).astype('f')

    def case(mx, nd):
        return [nd.dot(nd.array(a), nd.array(b)),
                nd.batch_dot(nd.array(x), nd.array(y)),
                nd.dot(nd.array(v), nd.array(v)),
                nd.dot(nd.array(a), nd.array(a), transpose_b=True),
                nd.dot(nd.array(b), nd.array(b), transpose_a=True),
                nd.dot(nd.array(x), nd.array(b)),
                nd.batch_dot(nd.array(x), nd.array(x), transpose_b=True),
                nd.array(a).dot(nd.array(b))]
    both(case)


def test_astype_copy():
    def case(mx, nd):
        a = nd.array([1.5, 2.5, -1.5])
        b = a.astype('int32')
        c = a.copy()
        c += 1
        return [b, a, c, a.astype(onp.float16), b.astype('float32')]
    got = both(case, exact=True)
    assert got[0].dtype == onp.int32


def test_topk_sort():
    def case(mx, nd):
        a = nd.array([[3., 1., 2.], [6., 5., 4.]])
        return [nd.topk(a, k=2), nd.topk(a, k=2, ret_typ='value'),
                nd.sort(a), nd.argsort(a), nd.sort(a, is_ascend=False),
                nd.topk(a, k=1, axis=0), nd.topk(a, k=2, is_ascend=True),
                nd.topk(a, k=2, ret_typ='mask'),
                nd.topk(a, k=2, ret_typ='both'),
                nd.argsort(a, axis=0, is_ascend=False)]
    both(case, exact=True)


@pytest.mark.parametrize('writer', ['jax', 'port'])
def test_save_load_across_packages(tmp_path, writer):
    """A file written by one package loads in the other, as a dict and as
    a list, with values and dtypes kept."""
    fname = str(tmp_path / 'arrs')
    arrs = {'a': onp.array([1., 2.], 'f'), 'b': onp.array([[3.]], 'f'),
            'i': onp.arange(4, dtype=onp.int32)}
    src = ndj if writer == 'jax' else ndt
    src.save(fname, {k: src.array(v) for k, v in arrs.items()})
    for nd in (ndj, ndt):
        loaded = nd.load(fname)
        assert set(loaded) == set(arrs)
        for k, v in arrs.items():
            assert loaded[k].dtype == v.dtype
            onp.testing.assert_array_equal(loaded[k].asnumpy(), v)
    src.save(fname, [src.array(arrs['a']), src.array(arrs['b'])])
    for nd in (ndj, ndt):
        la = nd.load(fname)
        onp.testing.assert_array_equal(la[0].asnumpy(), arrs['a'])
        onp.testing.assert_array_equal(la[1].asnumpy(), arrs['b'])
    with open(fname, 'rb') as f:
        buf = f.read()
    onp.testing.assert_array_equal(ndt.load_frombuffer(buf)[1].asnumpy(),
                                   arrs['b'])


def test_wait_to_read():
    def case(mx, nd):
        a = nd.ones((10, 10))
        b = a * 2
        b.wait_to_read()
        nd.waitall()
        return b
    both(case, exact=True)


def test_context():
    a = ndt.ones((2, 2), ctx=mt.cpu(0))
    assert a.context == mt.cpu(0)
    b = a.as_in_context(mt.cpu(0))
    assert b is a
    onp.testing.assert_array_equal(a.copyto(mt.cpu()).asnumpy(), a.asnumpy())


def test_one_hot_embedding_take():
    def case(mx, nd):
        idx = nd.array([0, 2])
        w = nd.array(onp.arange(12).reshape(4, 3).astype(onp.float32))
        return [nd.one_hot(idx, depth=3), nd.embedding(idx, w),
                nd.take(w, nd.array([1, 3])),
                nd.take(w, nd.array([5, -1])),
                nd.take(w, nd.array([5, -1]), mode='wrap'),
                nd.one_hot(nd.array([1, 3]), depth=3, on_value=5.0,
                           off_value=-1.0)]
    both(case, exact=True)


# ---- value semantics and the default context ------------------------------

def test_views_never_alias_writes():
    """A JAX NDArray never shares a buffer with another: writing into a
    reshape, a transpose or a slice leaves the source as it was."""
    def case(mx, nd):
        a = nd.array(onp.arange(4.0))
        b = a.reshape((2, 2))
        b[:] = 0
        c = a.reshape((2, 2)).T
        c[0] = 9
        d = a[1:3]
        d += 100
        return [a, b, c, d]
    both(case, exact=True)


def test_default_context_is_the_card():
    """Outside a ``with mx.cpu():`` scope the port's default is gpu(0),
    not the JAX package's cpu(0)."""
    assert mt.current_context() == mt.cpu()
    with mt.gpu(0):
        assert mt.current_context() == mt.gpu(0)
    assert mt.context._DEFAULT == mt.gpu(0)
    assert mj.context._DEFAULT == mj.cpu(0)


def test_bfloat16_dtype_and_asnumpy():
    a = ndt.array([1.0, 2.5, -3.0], dtype='bfloat16')
    assert a.dtype == torch.bfloat16
    out = a.asnumpy()
    assert out.dtype == onp.float32
    onp.testing.assert_array_equal(out, [1.0, 2.5, -3.0])
    assert a.astype('float32').dtype == onp.float32


def test_dlpack_round_trip():
    a = ndt.array(onp.arange(6.0).reshape(2, 3))
    b = ndt.from_dlpack(a.to_dlpack_for_read())
    onp.testing.assert_array_equal(b.asnumpy(), a.asnumpy())
    onp.testing.assert_array_equal(ndt.from_numpy(onp.ones(2)).asnumpy(),
                                   onp.ones(2, 'f'))


def test_registry_names_match_the_jax_package():
    """Every op the port registers exists under the same name in the JAX
    registry (the port registers a subset), and nd exposes it."""
    from mxnet_tpu.base import list_ops as jax_ops
    port = set(mt.base.list_ops())
    assert port <= set(jax_ops()), sorted(port - set(jax_ops()))
    assert len(port) > 150
    for name in port:
        assert callable(getattr(ndt, name))


def test_late_registered_op_is_reachable():
    from mxnet_tpu_torch.base import _OP_REGISTRY, register_op

    @register_op('port_test_twice')
    def twice(data):
        return data * 2
    try:
        out = ndt.port_test_twice(ndt.array([1.0, 2.0]))
        onp.testing.assert_array_equal(out.asnumpy(), [2.0, 4.0])
        assert ndt.imperative_invoke('port_test_twice',
                                     ndt.array([3.0])).asscalar() == 6.0
    finally:
        del _OP_REGISTRY['port_test_twice']


def test_op_errors_are_mxnet_errors():
    with pytest.raises(mt.MXNetError, match='Error in operator'):
        ndt.array([1.0, 2.0]) + ndt.array([1.0, 2.0, 3.0])
    with pytest.raises(mt.MXNetError):
        ndt.imperative_invoke('no_such_op')


# ---- each op family on the same inputs ------------------------------------

_RNG = onp.random.RandomState(7)
_POS = (_RNG.rand(3, 4) * 0.8 + 0.1).astype('f')      # in (0.1, 0.9)
_X = _RNG.randn(3, 4).astype('f')
_Y = _RNG.randn(3, 4).astype('f')
_ROW = _RNG.randn(4).astype('f')

UNARY = ['abs', 'sign', 'rint', 'ceil', 'floor', 'trunc', 'fix', 'square',
         'sqrt', 'cbrt', 'exp', 'log', 'log10', 'log2', 'log1p', 'expm1',
         'sin', 'cos', 'tan', 'arcsin', 'arccos', 'arctan', 'sinh', 'cosh',
         'tanh', 'arcsinh', 'arctanh', 'degrees', 'radians', 'erf',
         'erfinv', 'gamma', 'gammaln', 'logical_not', 'reciprocal', 'rsqrt',
         'rcbrt', 'negative', 'relu', 'sigmoid', 'hard_sigmoid', 'softsign',
         'gelu', 'gelu_tanh', 'isnan', 'isinf', 'isfinite']


@pytest.mark.parametrize('op', UNARY)
def test_unary(op):
    both(lambda mx, nd: getattr(nd, op)(nd.array(_POS)))


def test_unary_arccosh_and_signed():
    both(lambda mx, nd: [nd.arccosh(nd.array(_POS + 1)), nd.cbrt(
        nd.array(_X)), nd.sign(nd.array(_X)), nd.relu(nd.array(_X)),
        nd.clip(nd.array(_X), -0.5, 0.5), nd.clip(nd.array(_X), a_min=0.0)])


BINARY = ['broadcast_add', 'broadcast_sub', 'broadcast_mul',
          'broadcast_div', 'broadcast_mod', 'broadcast_power',
          'broadcast_maximum', 'broadcast_minimum', 'broadcast_hypot',
          'broadcast_equal', 'broadcast_not_equal', 'broadcast_greater',
          'broadcast_greater_equal', 'broadcast_lesser',
          'broadcast_lesser_equal', 'broadcast_logical_and',
          'broadcast_logical_or', 'broadcast_logical_xor', 'elemwise_add',
          'elemwise_sub', 'elemwise_mul', 'elemwise_div']


@pytest.mark.parametrize('op', BINARY)
def test_binary(op):
    rhs = _ROW if op.startswith('broadcast') else _Y
    lhs = _POS if op == 'broadcast_power' else _X
    both(lambda mx, nd: getattr(nd, op)(nd.array(lhs), nd.array(rhs)))


def test_mod_takes_the_divisors_sign():
    """jnp.mod is torch.remainder, not torch.fmod."""
    got = both(lambda mx, nd: [nd.broadcast_mod(nd.array([-7., 7.]),
                                                nd.array([3., -3.])),
                               nd.array([-7., 7.]) % 3,
                               nd.rmod_scalar(nd.array([-3., 3.]),
                                              scalar=7.0)], exact=True)
    onp.testing.assert_array_equal(got[0].asnumpy(), [2., -2.])


SCALAR = ['plus_scalar', 'minus_scalar', 'rminus_scalar', 'mul_scalar',
          'div_scalar', 'rdiv_scalar', 'mod_scalar', 'rmod_scalar',
          'power_scalar', 'rpower_scalar', 'maximum_scalar',
          'minimum_scalar', 'equal_scalar', 'not_equal_scalar',
          'greater_scalar', 'greater_equal_scalar', 'lesser_scalar',
          'lesser_equal_scalar', 'logical_and_scalar', 'logical_or_scalar',
          'logical_xor_scalar']


@pytest.mark.parametrize('op', SCALAR)
@pytest.mark.parametrize('kind', ['float', 'int'])
def test_scalar(op, kind):
    if kind == 'float':
        data, s = _POS, 0.5
    else:
        data, s = onp.arange(-3, 9, dtype=onp.int32).reshape(3, 4), 2
        if op in ('rdiv_scalar', 'rmod_scalar', 'rpower_scalar'):
            data = data + 4             # no zero or negative divisors
    both(lambda mx, nd: getattr(nd, op)(nd.array(data), scalar=s))


def test_misc_elemwise():
    cond = (_X > 0).astype('f')
    both(lambda mx, nd: [
        nd.add_n(nd.array(_X), nd.array(_Y), nd.array(_POS)),
        nd.cast(nd.array(_X), dtype='float16'),
        nd.amp_cast(nd.array(_X), dtype='float16'),
        nd.where(nd.array(cond), nd.array(_X), nd.array(_Y)),
        nd.cast(nd.array(_X * 3), dtype='int32')])


REDUCE = ['sum', 'mean', 'prod', 'nansum', 'nanprod', 'max', 'min']


@pytest.mark.parametrize('op', REDUCE)
@pytest.mark.parametrize('axis,keepdims,exclude', [
    (None, False, False), (0, False, False), (1, True, False),
    ((0, 2), False, False), (1, False, True), ((), False, False)])
def test_reduce_ops(op, axis, keepdims, exclude):
    rng = onp.random.RandomState(8)
    data = rng.randn(2, 3, 4).astype('f') if op != 'prod' else \
        (rng.rand(2, 3, 4) + 0.5).astype('f')
    both(lambda mx, nd: getattr(nd, op)(nd.array(data), axis=axis,
                                        keepdims=keepdims, exclude=exclude))


def test_reduce_integer_dtypes_and_arg():
    ints = onp.arange(12, dtype=onp.int32).reshape(3, 4)
    both(lambda mx, nd: [
        nd.sum(nd.array(ints)), nd.sum(nd.array(ints), axis=1),
        nd.mean(nd.array(ints), axis=0), nd.prod(nd.array(ints[:, :2] + 1)),
        nd.argmax(nd.array(_X)), nd.argmax(nd.array(_X), axis=0),
        nd.argmin(nd.array(_X), axis=1, keepdims=True),
        nd.argmax(nd.array(_X), keepdims=True)])


def test_broadcast_cumulative_moments():
    both(lambda mx, nd: [
        nd.broadcast_to(nd.array(_ROW[None]), shape=(3, 4)),
        nd.broadcast_to(nd.array(_ROW[None]), shape=(3, 0)),
        nd.broadcast_like(nd.array(_ROW[None]), nd.array(_X)),
        nd.broadcast_axis(nd.array(_ROW[None]), axis=0, size=5),
        nd.cumsum(nd.array(_X), axis=1), nd.cumsum(nd.array(_X)),
        nd.cumprod(nd.array(_POS), axis=0),
        nd.moments(nd.array(_X), axes=(1,)),
        nd.moments(nd.array(_X), axes=(0,), keepdims=True),
        nd.norm(nd.array(_X), ord=1), nd.norm(nd.array(_X), axis=1)])


@pytest.mark.parametrize('shape,target,reverse', [
    ((2, 3, 4), (6, 4), False), ((2, 3, 4), (0, -1), False),
    ((2, 3, 4), (-2,), False), ((2, 3, 4), (-3, 4), False),
    ((2, 3, 4), (2, -4, 3, 1, 4), False), ((2, 3, 4), (-4, 1, 2, -2), False),
    ((2, 3, 4), (0, -1), True), ((2, 3, 4), (-1, 0), True)])
def test_reshape_codes(shape, target, reverse):
    data = onp.arange(24, dtype='f').reshape(shape)
    both(lambda mx, nd: nd.reshape(nd.array(data), shape=target,
                                   reverse=reverse), exact=True)


def test_matrix_ops():
    a = onp.arange(24, dtype='f').reshape(2, 3, 4)
    img = onp.arange(32, dtype='f').reshape(1, 8, 2, 2)
    m = onp.random.RandomState(9).randn(4, 4).astype('f')
    both(lambda mx, nd: [
        nd.slice(nd.array(a), begin=(0, 1), end=(2, 3)),
        nd.slice(nd.array(a), begin=(None, None, 3), end=(None, None, 0),
                 step=(1, 1, -1)),
        nd.slice_axis(nd.array(a), axis=1, begin=1, end=None),
        nd.slice_like(nd.array(a), nd.array(onp.zeros((1, 2))), axes=(0, 1)),
        nd.split(nd.array(a), num_outputs=2, axis=2, squeeze_axis=False),
        nd.split(nd.array(a), num_outputs=3, axis=1, squeeze_axis=True),
        nd.tile(nd.array(a), reps=(2, 1, 1)),
        nd.repeat(nd.array(a), repeats=2), nd.flip(nd.array(a), axis=1),
        nd.reverse(nd.array(a), axis=(0, 2)),
        nd.pad(nd.array(img), mode='constant',
               pad_width=(0, 0, 0, 0, 1, 1, 2, 0), constant_value=3.0),
        nd.pad(nd.array(img), mode='edge', pad_width=(0, 0, 0, 0, 1, 1, 1, 1)),
        nd.pad(nd.array(img), mode='reflect',
               pad_width=(0, 0, 0, 0, 1, 1, 1, 1)),
        nd.depth_to_space(nd.array(img), block_size=2),
        nd.space_to_depth(nd.array(onp.arange(16, dtype='f').reshape(
            1, 1, 4, 4)), block_size=2),
        nd.expand_dims(nd.array(a), axis=-1), nd.squeeze(nd.array(a[:1])),
        nd.swapaxes(nd.array(a), dim1=0, dim2=1),
        nd.khatri_rao(nd.array(m[:2]), nd.array(m[2:])),
        nd.zeros_like(nd.array(a)), nd.ones_like(nd.array(a)),
        nd.diag(nd.array(m)), nd.diag(nd.array(m[0]), k=1),
        nd.tril(nd.array(m)), nd.triu(nd.array(m), k=1),
        nd.einsum(nd.array(m), nd.array(m), subscripts='ij,jk->ik'),
        nd.flatten(nd.array(a)), nd.transpose(nd.array(a), axes=(2, 0, 1))])


def test_shape_and_size_arrays():
    """int64 as the reference and the JAX source ask; JAX without x64
    truncates them to int32, so only the values are compared."""
    a = onp.zeros((2, 3, 4), 'f')
    for op in ('shape_array', 'size_array'):
        got = getattr(ndt, op)(ndt.array(a)).asnumpy()
        want = getattr(ndj, op)(ndj.array(a)).asnumpy()
        assert got.dtype == onp.int64
        onp.testing.assert_array_equal(got, want)


def test_histogram():
    data = onp.array([0.0, 0.5, 1.0, 1.5, 2.0, 2.0, 3.5], 'f')
    both(lambda mx, nd: [nd.histogram(nd.array(data), bin_cnt=4),
                         nd.histogram(nd.array(data), bin_cnt=3,
                                      range=(0.0, 3.0))])


def test_index_ops():
    data = onp.arange(12, dtype='f').reshape(3, 4)
    both(lambda mx, nd: [
        nd.take(nd.array(data), nd.array([[0, 2], [1, 1]])),
        nd.take(nd.array(data), nd.array([3, 0]), axis=1),
        nd.batch_take(nd.array(data), nd.array([0, 3, 1])),
        nd.pick(nd.array(data), nd.array([0, 3, 9])),
        nd.pick(nd.array(data), nd.array([1, 0, 2, 2]), axis=0,
                keepdims=True),
        nd.gather_nd(nd.array(data), nd.array([[0, 2], [1, 3]])),
        nd.scatter_nd(nd.array([5., 6.]), nd.array([[0, 2], [1, 3]]),
                      shape=(3, 4)),
        nd.index_copy(nd.array(data), nd.array([2, 0]),
                      nd.array(onp.ones((2, 4), 'f'))),
        nd.index_add(nd.array(data), nd.array([1, 1]),
                     nd.array(onp.ones((2, 4), 'f'))),
        nd.boolean_mask(nd.array(data), nd.array([1, 0, 1])),
        nd.sequence_mask_like(nd.array(data), nd.array(data > 4)),
        nd.ravel_multi_index(nd.array([[1, 2], [3, 0]]), shape=(3, 4)),
        nd.unravel_index(nd.array([7, 5]), shape=(3, 4))], exact=True)


def test_init_ops():
    both(lambda mx, nd: [
        nd.linspace(start=0, stop=1, num=5),
        nd.linspace(start=0, stop=1, num=4, endpoint=False),
        nd.eye(N=3), nd.eye(N=2, M=4, k=1, dtype='int32'),
        nd.arange(0, 6, 1.5, repeat=2), nd.arange(5),
        nd.full((2,), 3, dtype='int32'), nd.ones((2, 2), dtype='float16')])


def test_nn_ops():
    length = onp.array([2, 4, 1], 'f')
    both(lambda mx, nd: [
        nd.softmax(nd.array(_X)), nd.softmax(nd.array(_X), axis=0),
        nd.softmax(nd.array(_X), temperature=2.0),
        nd.softmax(nd.array(_X), length=nd.array(length)),
        nd.log_softmax(nd.array(_X)),
        nd.log_softmax(nd.array(_X), axis=0, temperature=0.5),
        nd.blockgrad(nd.array(_X)),
        nd.embedding(nd.array([3, 0]), nd.array(_X.T)),
        nd.dropout(nd.array(_X), p=0.5),
        nd.activation(nd.array(_X), act_type='tanh'),
        nd.fully_connected(nd.array(_X), nd.array(_Y), nd.array(_ROW[:3]),
                           num_hidden=3),
        nd.layer_norm(nd.array(_X), nd.array(_ROW), nd.array(_ROW))])
