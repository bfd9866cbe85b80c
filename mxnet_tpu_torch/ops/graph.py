"""DGL graph ops (counterpart of ``mxnet_tpu/ops/graph.py``; ref:
src/operator/contrib/dgl_graph.cc).

Graphs ride in (dense payloads of) CSR matrices whose stored values are
edge ids, the DGL convention. ``edge_id`` and ``dgl_adjacency`` are
gathers and compares on the tensor's device; the subgraph, the neighbour
samplers and the compaction have a value-dependent output structure, so,
as in the JAX package and the reference's CPU kernels, they run over
host numpy and return tensors on the input's device.
"""
from __future__ import annotations

import numpy as onp
import torch

from ..base import register_op
from .. import random as _random

__all__ = []


def _reg(fn, **kw):
    register_op(fn.__name__, **kw)(fn)
    __all__.append(fn.__name__)
    return fn


def _host(x):
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return (x.float() if x.dtype == torch.bfloat16 else x).cpu().numpy()
    return onp.asarray(x)


def _back(a, like):
    dev = like.device if isinstance(like, torch.Tensor) else 'cpu'
    return torch.from_numpy(onp.ascontiguousarray(a)).to(dev)


@_reg
def edge_id(data, u, v):
    """out[i] = data[u[i], v[i]] if that edge exists, else -1 (ref:
    dgl_graph.cc:1300 _contrib_edge_id)."""
    vals = data[u.to(torch.int64), v.to(torch.int64)]
    return torch.where(vals != 0, vals, -torch.ones_like(vals))


@_reg
def dgl_adjacency(data):
    """The adjacency matrix (every stored edge weight 1.0) of an edge-id
    CSR (ref: dgl_graph.cc:1376)."""
    return (data != 0).to(torch.float32)


def dgl_subgraph(graph, *vertex_lists, return_mapping=False):
    """Induced subgraphs on the given vertex sets (ref:
    dgl_graph.cc:1115): one subgraph per vertex list, each followed by its
    edge-id mapping matrix when ``return_mapping``."""
    g = _host(graph)
    outs = []
    for vl in vertex_lists:
        idx = _host(vl).astype(onp.int64)
        sub = g[onp.ix_(idx, idx)]
        # edges renumbered consecutively from 1, as the reference does
        mask = sub != 0
        new = onp.zeros_like(sub)
        new[mask] = onp.arange(1, int(mask.sum()) + 1)
        outs.append(_back(new, graph))
        if return_mapping:
            outs.append(_back(onp.where(mask, sub, 0), graph))
    return tuple(outs)


register_op('dgl_subgraph', num_outputs=-1)(dgl_subgraph)
__all__.append('dgl_subgraph')


def _neighbor_sample(csr, seeds, num_hops, num_neighbor,
                     max_num_vertices, probability=None):
    """The two samplers' body (ref: dgl_graph.cc SampleSubgraph): BFS from
    the seeds, keeping at most ``num_neighbor`` sampled neighbours per
    vertex and hop; returns (vertices, sampled-edge csr payload, layers).
    The draws come from the port's CPU generator (``mx.random.seed``
    seeds it), where the work runs, whatever the input's device."""
    g = _host(csr)
    cpu = torch.device('cpu')
    seed = int(torch.randint(0, 2 ** 31 - 1, (1,),
                             generator=_random.generator(cpu)).item())
    rng = onp.random.RandomState(seed)
    prob = None if probability is None else _host(probability)

    layer_of = {}
    frontier = []
    for s in _host(seeds).astype(onp.int64).ravel():
        if len(layer_of) >= max_num_vertices:
            break   # the cap applies to the seeds too
        if s >= 0 and s not in layer_of:
            layer_of[int(s)] = 0
            frontier.append(int(s))
    sampled = onp.zeros_like(g)
    for hop in range(1, num_hops + 1):
        nxt = []
        for u in frontier:
            nbrs = onp.nonzero(g[u])[0]
            if len(nbrs) == 0:
                continue
            if len(nbrs) > num_neighbor:
                if prob is not None:
                    p = prob[nbrs].astype(onp.float64)
                    p = p / p.sum()
                    pick = rng.choice(nbrs, num_neighbor, replace=False,
                                      p=p)
                else:
                    pick = rng.choice(nbrs, num_neighbor, replace=False)
            else:
                pick = nbrs
            for vtx in pick:
                if len(layer_of) >= max_num_vertices and \
                        int(vtx) not in layer_of:
                    continue
                sampled[u, vtx] = g[u, vtx]
                if int(vtx) not in layer_of:
                    layer_of[int(vtx)] = hop
                    nxt.append(int(vtx))
        frontier = nxt
    verts = sorted(layer_of)
    out_v = onp.full((max_num_vertices + 1,), -1, onp.int64)
    out_v[:len(verts)] = verts
    out_v[-1] = len(verts)
    out_l = onp.full((max_num_vertices,), -1, onp.int64)
    out_l[:len(verts)] = [layer_of[v] for v in verts]
    return (_back(out_v, csr), _back(sampled, csr), _back(out_l, csr))


def dgl_csr_neighbor_uniform_sample(csr, *seeds, num_hops=1,
                                    num_neighbor=2, max_num_vertices=100):
    """Uniform neighbourhood sampling from an edge-id CSR graph (ref:
    dgl_graph.cc:744): one (vertices, subgraph csr, layers) triple per
    seed array."""
    outs = []
    for s in seeds:
        outs.extend(_neighbor_sample(csr, s, num_hops, num_neighbor,
                                     max_num_vertices))
    return tuple(outs)


def dgl_csr_neighbor_non_uniform_sample(csr, probability, *seeds,
                                        num_hops=1, num_neighbor=2,
                                        max_num_vertices=100):
    """Probability-weighted neighbourhood sampling (ref:
    dgl_graph.cc:838)."""
    outs = []
    for s in seeds:
        outs.extend(_neighbor_sample(csr, s, num_hops, num_neighbor,
                                     max_num_vertices, probability))
    return tuple(outs)


def dgl_graph_compact(*graphs, return_mapping=False, graph_sizes=()):
    """Drop unused vertex slots: graph i keeps its first
    ``graph_sizes[i]`` vertices (ref: dgl_graph.cc:1551)."""
    outs = []
    for g, size in zip(graphs, graph_sizes):
        gh = _host(g)
        compact = gh[:int(size), :int(size)]
        outs.append(_back(compact, g))
        if return_mapping:
            outs.append(_back((compact != 0).astype(gh.dtype), g))
    return tuple(outs)


for _f in (dgl_csr_neighbor_uniform_sample,
           dgl_csr_neighbor_non_uniform_sample, dgl_graph_compact):
    register_op(_f.__name__, num_outputs=-1)(_f)
    __all__.append(_f.__name__)
