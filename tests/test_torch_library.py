"""Op libraries loaded at run time (``mxnet_tpu_torch.library``) against
the JAX package's (``mxnet_tpu.library``), on the CPU.

The port's copy of ``src/lib_api/example_lib.cc``
(``mxnet_tpu_torch/csrc/lib_api/``) is built once by the port
(``library.example_library()``: ``g++`` into the build directory, here a
temporary one) and the same ``.so`` is loaded into both packages: the C
ABI is one. The cases of tests/test_library.py run through both:
loading and listing, eager calls (f32 and int32), the GEMM against
numpy, the two-output op over four dtypes, the error surface and a
missing path. Each op gives the same arrays in both packages, bitwise
(the same C code on the same host bytes). The JAX case under ``jit``
becomes the port's hybridized block (eager on the CPU; on the card the
CachedOp runs such a block eagerly, tests/test_torch_frontends_cuda.py)
and a Symbol graph. A failed ``g++`` build raises with the compiler's
output; a second ``build`` finds the library built.
"""
import numpy as onp
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu_torch.base import MXNetError
from test_torch_jax_globals import jax_globals  # noqa: F401

EXAMPLE_OPS = {'my_relu', 'my_gemm', 'my_split2'}


@pytest.fixture(scope='module')
def libpath(tmp_path_factory):
    """The example library, built by the port into a build directory of
    this module's own; the port's registry and loaded libraries put back
    as they were after the module."""
    from mxnet_tpu_torch import library
    from mxnet_tpu_torch.base import _OP_REGISTRY
    registry, loaded = dict(_OP_REGISTRY), dict(library._loaded)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv('MXTPU_COMPILE_CACHE_DIR',
                  str(tmp_path_factory.mktemp('build')))
        yield library.example_library()
    _OP_REGISTRY.clear()
    _OP_REGISTRY.update(registry)
    library._loaded.clear()
    library._loaded.update(loaded)


@pytest.fixture(autouse=True)
def _cpu():
    with mx.cpu():
        yield


def test_build_goes_to_the_build_directory(libpath):
    from mxnet_tpu_torch import library
    from mxnet_tpu_torch.telemetry import compile as _compile
    import os
    assert os.path.dirname(libpath) == _compile.cache_dir()
    assert os.path.basename(libpath).startswith('libexample_lib-')
    hits = _compile.persistent_cache_stats()['hits']
    assert library.example_library() == libpath
    assert _compile.persistent_cache_stats()['hits'] == hits + 1
    assert libpath in mx.libinfo.find_lib_path()


def test_failed_build_raises_with_the_compilers_output(tmp_path,
                                                       monkeypatch, libpath):
    from mxnet_tpu_torch import library
    monkeypatch.setenv('MXTPU_COMPILE_CACHE_DIR', str(tmp_path / 'b'))
    src = tmp_path / 'broken.cc'
    src.write_text('int MXTPULibVersion(void) { return undeclared_name; }\n')
    with pytest.raises(MXNetError, match='undeclared_name') as err:
        library.build(str(src))
    assert 'g++' in str(err.value)
    assert not list((tmp_path / 'b').glob('*.so'))
    assert not list((tmp_path / 'b').glob('*.tmp'))


@pytest.mark.parametrize('pkg', ['jax', 'port'])
def test_load_and_list(libpath, pkg):
    m = {'jax': jmx, 'port': mx}[pkg]
    ops = m.library.load(libpath)
    assert set(ops) == EXAMPLE_OPS
    assert 'my_relu' in m.list_ops()
    assert libpath in m.library.loaded_libraries()
    assert m.library.load(libpath) == ops


def _both(libpath, op, *arrays, **kw):
    """The op's outputs (a list of numpy arrays) in each package."""
    jmx.library.load(libpath)
    mx.library.load(libpath)
    out = {}
    for pkg, m in (('jax', jmx), ('port', mx)):
        res = getattr(m.nd, op)(*[m.nd.array(a, dtype=a.dtype)
                                  for a in arrays], **kw)
        res = res if isinstance(res, (list, tuple)) else [res]
        out[pkg] = [r.asnumpy() for r in res]
    return out['jax'], out['port']


@pytest.mark.parametrize('x, want', [
    (onp.array([[-1.0, 2.0], [3.0, -4.0]], onp.float32),
     [[0.0, 2.0], [3.0, 0.0]]),
    (onp.array([[-5, 7]], onp.int32), [[0, 7]])])
def test_external_op_eager(libpath, x, want):
    jout, tout = _both(libpath, 'my_relu', x)
    onp.testing.assert_array_equal(tout[0], want)
    assert tout[0].dtype == jout[0].dtype == x.dtype
    onp.testing.assert_array_equal(tout[0], jout[0])


def test_external_gemm_vs_numpy(libpath):
    rng = onp.random.RandomState(0)
    a = rng.randn(5, 7).astype(onp.float32)
    b = rng.randn(7, 3).astype(onp.float32)
    jout, tout = _both(libpath, 'my_gemm', a, b)
    onp.testing.assert_allclose(tout[0], a @ b, rtol=1e-5)
    onp.testing.assert_array_equal(tout[0], jout[0])


@pytest.mark.parametrize('dt', [onp.float32, onp.float16, onp.int64,
                                onp.int8])
def test_external_op_multi_output(libpath, dt):
    x = onp.arange(12).reshape(3, 4).astype(dt)
    jout, tout = _both(libpath, 'my_split2', x)
    onp.testing.assert_array_equal(tout[0], x[:, :2])
    onp.testing.assert_array_equal(tout[1], x[:, 2:])
    for t, j in zip(tout, jout):
        # the JAX package runs without 64-bit types: its int64 is int32
        assert t.dtype == dt
        onp.testing.assert_array_equal(t, j)


def test_external_op_in_a_hybridized_block_and_a_symbol(libpath):
    """The JAX package runs the op under jit; the port's hybridized block
    (eager on the CPU) and a Symbol graph return what the eager op
    returns."""
    mx.library.load(libpath)
    jmx.library.load(libpath)

    class Net(mx.gluon.HybridBlock):
        def hybrid_forward(self, F, x):
            return F.my_relu(x * 2.0) + 1.0

    x = onp.array([[-3.0, 5.0]], onp.float32)
    net = Net()
    net.hybridize()
    onp.testing.assert_array_equal(net(mx.nd.array(x)).asnumpy(),
                                   [[1.0, 11.0]])
    s = mx.sym.my_relu(mx.sym.var('data') * 2.0) + 1.0
    got = s.eval_dict({'data': mx.nd.array(x)}).asnumpy()
    onp.testing.assert_array_equal(got, [[1.0, 11.0]])
    import jax
    import jax.numpy as jnp
    relu = jmx.base.get_op('my_relu').fn
    want = jax.jit(lambda v: relu(v * 2.0) + 1.0)(jnp.asarray(x))
    onp.testing.assert_array_equal(got, onp.asarray(want))


@pytest.mark.parametrize('pkg', ['jax', 'port'])
def test_external_op_error_surface(libpath, pkg):
    m = {'jax': jmx, 'port': mx}[pkg]
    m.library.load(libpath)
    with pytest.raises(m.base.MXNetError, match='my_gemm'):
        m.nd.my_gemm(m.nd.array(onp.zeros((2, 3), onp.float32)),
                     m.nd.array(onp.zeros((4, 5), onp.float32)))
    with pytest.raises(m.base.MXNetError, match='dtype'):
        m.nd.my_relu(m.nd.array(onp.zeros((2, 2), onp.float32)).astype(
            'bfloat16'))


@pytest.mark.parametrize('pkg', ['jax', 'port'])
def test_load_rejects_a_missing_path(tmp_path, pkg):
    m = {'jax': jmx, 'port': mx}[pkg]
    with pytest.raises(m.base.MXNetError, match='not found'):
        m.library.load(str(tmp_path / 'nope.so'))


def test_port_load_rejects_a_library_without_the_abi(tmp_path, libpath):
    """A shared object that is not an op library: refused by name."""
    from mxnet_tpu_torch import library
    from mxnet_tpu_torch.ops._build import Compile
    src = tmp_path / 'other.cc'
    src.write_text('extern "C" int something(void) { return 1; }\n')
    out = str(tmp_path / 'libother.so')
    assert Compile(out, ['g++', '-shared', '-fPIC', str(src)]).wait() is None
    with pytest.raises(MXNetError, match='not an MXTPU op library'):
        library.load(out)
