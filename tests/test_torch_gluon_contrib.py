"""The port's Gluon contrib layers (``mxnet_tpu_torch/gluon/contrib/
nn.py``) against the JAX package's: ``HybridConcurrent`` and
``Concurrent`` (children on one input, concatenated), ``Identity`` and
``PixelShuffle2D`` on seeded inputs, within 1e-6 (f32 on the CPU), with
the JAX children's weights carried by structured name; and
``SparseEmbedding`` (row-sparse gradients) against the JAX layer.
"""
import numpy as onp
import pytest

import mxnet_tpu as mj
import mxnet_tpu_torch as mt
from mxnet_tpu.gluon.contrib import nn as jcnn
from mxnet_tpu_torch.gluon.contrib import nn as tcnn


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


@pytest.fixture(autouse=True)
def _port_on_cpu():
    with mt.cpu():
        yield


def _concurrent(pk, cnn, cls, axis):
    net = getattr(cnn, cls)(axis=axis)
    with net.name_scope():
        net.add(pk.gluon.nn.Dense(4, flatten=False, in_units=6),
                cnn.Identity())
        net.add(pk.gluon.nn.Dense(3, flatten=False, in_units=6,
                                  activation='relu'))
    return net


@pytest.mark.parametrize('cls', ['HybridConcurrent', 'Concurrent'])
@pytest.mark.parametrize('axis', [-1, 2])
def test_concurrent_matches_jax(cls, axis):
    x = onp.random.RandomState(0).randn(2, 5, 6).astype(onp.float32)
    jnet = _concurrent(mj, jcnn, cls, axis)
    tnet = _concurrent(mt, tcnn, cls, axis)
    jnet.initialize(mj.init.Xavier())
    tnet.initialize()
    src = {k: p.data().asnumpy()
           for k, p in jnet._collect_params_with_prefix().items()}
    dst = tnet._collect_params_with_prefix()
    assert sorted(src) == sorted(dst)
    for k, v in src.items():
        dst[k].set_data(mt.nd.array(v))
    want = jnet(mj.nd.array(x)).asnumpy()
    got = tnet(mt.nd.array(x)).asnumpy()
    assert got.shape == want.shape == (2, 5, 4 + 6 + 3)
    onp.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_identity_matches_jax():
    x = onp.random.RandomState(1).randn(3, 4).astype(onp.float32)
    onp.testing.assert_array_equal(
        tcnn.Identity()(mt.nd.array(x)).asnumpy(),
        jcnn.Identity()(mj.nd.array(x)).asnumpy())


@pytest.mark.parametrize('factor', [2, 3])
def test_pixel_shuffle_matches_jax(factor):
    x = onp.random.RandomState(2).randn(
        2, 2 * factor * factor, 3, 4).astype(onp.float32)
    want = jcnn.PixelShuffle2D(factor)(mj.nd.array(x)).asnumpy()
    got = tcnn.PixelShuffle2D(factor)(mt.nd.array(x)).asnumpy()
    assert got.shape == (2, 2, 3 * factor, 4 * factor)
    onp.testing.assert_array_equal(got, want)


def test_sparse_embedding_raises_naming_the_sparse_item():
    """SparseEmbedding is ported (ROADMAP item 12): its gradient is a
    RowSparseNDArray holding the looked-up rows, its output the JAX
    layer's on the same weights; what still raises of the sparse surface
    names its item (the KVStore's row_sparse_pull, item 8)."""
    w0 = onp.random.RandomState(3).randn(10, 4).astype(onp.float32)
    ids = onp.array([1, 7, 7], onp.float32)
    outs = {}
    for name, pk, cnn in (('jax', mj, jcnn), ('port', mt, tcnn)):
        emb = cnn.SparseEmbedding(10, 4)
        emb.initialize()
        emb.weight.set_data(pk.nd.array(w0))
        with pk.autograd.record():
            out = emb(pk.nd.array(ids))
            (out ** 2).sum().backward()
        g = emb.weight.grad()
        assert g.stype == 'row_sparse', name
        assert sorted(g.indices.asnumpy().tolist()) == [1, 7]
        outs[name] = (out.asnumpy(), g.asnumpy())
    for got, want in zip(outs['port'], outs['jax']):
        onp.testing.assert_allclose(got, want, rtol=1e-6)
    with pytest.raises(mt.MXNetError, match='item 8'):
        mt.kv.row_sparse_pull('w', row_ids=mt.nd.array([1]))
