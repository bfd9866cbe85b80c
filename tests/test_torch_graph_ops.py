"""The port's DGL graph ops (``mxnet_tpu_torch/ops/graph.py``) against
the JAX package's: the family of ``tests/test_contrib_ops.py::
test_dgl_graph_ops`` (ref: src/operator/contrib/dgl_graph.cc docstring
examples) through both packages, the deterministic ops held equal, the
samplers to the same structural properties (each draws from its own
package's generator)."""
import jax.numpy as jnp
import numpy as onp
import pytest
import torch

import mxnet_tpu_torch as mt
from mxnet_tpu.base import get_op as jget
from mxnet_tpu_torch.base import get_op as tget
from test_torch_jax_globals import jax_globals  # noqa: F401


@pytest.fixture(autouse=True)
def _port_on_cpu():
    with mt.cpu():
        yield


def _both(name, *args, **kw):
    """The JAX op on jnp arrays and the port's on CPU tensors."""
    want = jget(name).fn(*[jnp.asarray(a) for a in args], **kw)
    got = tget(name).fn(*[torch.from_numpy(onp.asarray(a)) for a in args],
                        **kw)
    return want, got


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else onp.asarray(x)


def _clique():
    data_np = onp.arange(1, 21, dtype=onp.float32)
    dense = onp.zeros((5, 5), onp.float32)
    indices = [1, 2, 3, 4, 0, 2, 3, 4, 0, 1, 3, 4, 0, 1, 2, 4, 0, 1, 2, 3]
    indptr = [0, 4, 8, 12, 16, 20]
    for row in range(5):
        for j in range(indptr[row], indptr[row + 1]):
            dense[row, indices[j]] = data_np[j]
    return dense, data_np


def test_edge_id_and_adjacency():
    x = onp.asarray([[1, 0, 0], [0, 2, 0], [0, 0, 3]], onp.float32)
    u = onp.asarray([0, 0, 1, 1, 2, 2])
    v = onp.asarray([0, 1, 1, 2, 0, 2])
    want, got = _both('edge_id', x, u, v)
    onp.testing.assert_array_equal(_np(got), _np(want))
    assert onp.array_equal(_np(got), [1, -1, 2, -1, -1, 3])
    want, got = _both('dgl_adjacency', x)
    onp.testing.assert_array_equal(_np(got), _np(want))
    assert onp.array_equal(_np(got), onp.eye(3))
    # through mx.nd on NDArrays
    out = mt.nd.edge_id(mt.nd.array(x), mt.nd.array(u), mt.nd.array(v))
    assert onp.array_equal(out.asnumpy(), [1, -1, 2, -1, -1, 3])


def test_subgraph_with_mapping():
    g = onp.asarray([[0, 1, 2], [3, 0, 4], [5, 6, 0]], onp.float32)
    want, got = _both('dgl_subgraph', g, onp.asarray([0, 2]),
                      return_mapping=True)
    for w, t in zip(want, got):
        onp.testing.assert_array_equal(_np(t), _np(w))
    sub, mapping = got
    assert tuple(sub.shape) == (2, 2)
    assert _np(mapping)[0, 1] == 2.0      # the original edge id kept
    assert _np(mapping)[1, 0] == 5.0


def test_uniform_neighbor_sample():
    dense, data_np = _clique()
    seed = onp.asarray([0, 1, 2, 3, 4])
    for name, (verts, subg, layers) in zip(('jax', 'port'), _both(
            'dgl_csr_neighbor_uniform_sample', dense, seed, num_hops=1,
            num_neighbor=2, max_num_vertices=5)):
        verts, subg, layers = _np(verts), _np(subg), _np(layers)
        assert verts[-1] == 5, name
        assert onp.array_equal(verts[:5], [0, 1, 2, 3, 4])
        assert ((subg != 0).sum(axis=1) <= 2).all()
        nz = subg[subg != 0]
        assert set(nz.tolist()) <= set(data_np.tolist())
        assert layers[:5].max() <= 1


def test_non_uniform_neighbor_sample():
    """Zero probability mass on vertices 2..4 forces every sample into
    the columns {0, 1}."""
    dense, _ = _clique()
    prob = onp.asarray([1.0, 1.0, 0.0, 0.0, 0.0], onp.float32)
    seed = onp.asarray([0, 1, 2, 3, 4])
    for name, out in zip(('jax', 'port'), _both(
            'dgl_csr_neighbor_non_uniform_sample', dense, prob, seed,
            num_hops=1, num_neighbor=1, max_num_vertices=5)):
        cols = onp.nonzero(_np(out[1]))[1]
        assert set(cols.tolist()) <= {0, 1}, (name, cols)


def test_graph_compact():
    dense, _ = _clique()
    want, got = _both('dgl_graph_compact', dense, graph_sizes=(3,),
                      return_mapping=True)
    for w, t in zip(want, got):
        onp.testing.assert_array_equal(_np(t), _np(w))
    assert tuple(got[0].shape) == (3, 3)


def test_sampler_repeats_under_the_port_seed():
    dense, _ = _clique()
    seed = torch.tensor([0, 2])
    fn = tget('dgl_csr_neighbor_uniform_sample').fn
    outs = []
    for _ in range(2):
        mt.random.seed(5)
        outs.append(fn(torch.from_numpy(dense), seed, num_hops=2,
                       num_neighbor=2, max_num_vertices=5))
    for a, b in zip(*outs):
        assert torch.equal(a, b)
