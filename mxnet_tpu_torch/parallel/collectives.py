"""Collectives over the dp process group (counterpart of
``mxnet_tpu/parallel/collectives.py``).

The JAX functions are ``lax`` collectives over a named mesh axis inside a
traced program; here they are ``torch.distributed`` calls over the
world's group, which is the dp axis of the world's mesh (the only axis
of size > 1 the port places: tensor parallelism is ROADMAP queue 1 item
6a). ``axis_name`` must be the mesh's dp axis name; outside a world of
more than one rank every collective is the identity over one member, as
a mesh axis of size 1 is.

The reductions differentiate as ``jax.grad`` differentiates their
``lax`` counterparts: ``psum``'s gradient is the ``psum`` of the output
gradients, ``all_gather``'s the ``reduce_scatter`` (a sum) of them, and
``reduce_scatter``'s the ``all_gather``. ``pmax`` carries no gradient.

Over gloo the tensors may be on a card: gloo takes CUDA tensors for
every collective used here (all-reduce, broadcast, all-gather and
reduce-scatter, checked on an H100 with torch 2.11), copying through host
memory itself.

``data_axis`` declares the active data axis while a block runs (the
compiled step declares it around its forward at dp > 1), so that
``SyncBatchNorm`` reduces its statistics over it. ``ppermute`` (ring
attention, ROADMAP queue 1 item 13) raises; ``ordered_barrier`` chains
ZeRO-3's per-layer gathers.
"""
from __future__ import annotations

import re
import threading

import torch
import torch.distributed as tdist

from ..base import MXNetError
from . import dist as _dist

__all__ = ['data_axis', 'current_data_axis', 'psum', 'pmean', 'pmax',
           'all_gather', 'reduce_scatter', 'ppermute', 'axis_index',
           'axis_size', 'ordered_barrier', 'group_params_by_layer']

_tls = threading.local()


def _stack():
    if not hasattr(_tls, 'axes'):
        _tls.axes = []
    return _tls.axes


class data_axis:
    """Context manager declaring the active data-parallel axis name."""

    def __init__(self, name='dp'):
        self.name = name

    def __enter__(self):
        _stack().append(self.name)
        return self

    def __exit__(self, *exc):
        _stack().pop()


def current_data_axis():
    s = _stack()
    return s[-1] if s else None


def _size(axis_name):
    """The axis's member count: the world's size on the dp axis, 1
    outside a world."""
    if _dist.num_workers() == 1:
        return 1
    from .mesh import default_mesh
    shape = default_mesh().shape
    if axis_name not in shape:
        raise MXNetError(f"collectives: no mesh axis {axis_name!r} "
                         f"(the mesh has {sorted(shape)})")
    return int(shape[axis_name])


def all_reduce_(t, op='sum'):
    """In place: ``t`` becomes the reduction over the world."""
    red = {'sum': tdist.ReduceOp.SUM, 'max': tdist.ReduceOp.MAX,
           'min': tdist.ReduceOp.MIN}[op]
    tdist.all_reduce(t, op=red)
    return t


def all_gather_into(out, x):
    """``out`` (world x x's numel, contiguous) becomes every rank's
    ``x`` stacked along dim 0 by rank."""
    n = _dist.num_workers()
    tdist.all_gather(list(out.reshape((n,) + tuple(x.shape)).unbind(0)),
                     x.contiguous())
    return out


def reduce_scatter_into(out, x):
    """``out`` becomes this rank's chunk (dim 0, in rank order) of the
    sum over the world of ``x``; x's dim 0 splits evenly."""
    tdist.reduce_scatter(out, [c.contiguous() for c in
                               x.chunk(_dist.num_workers(), 0)])
    return out


def broadcast_(t, src=0):
    """In place: ``t`` becomes rank ``src``'s."""
    tdist.broadcast(t, src)
    return t


def _gather(x, axis, tiled):
    n = _dist.num_workers()
    out = x.new_empty((n,) + tuple(x.shape))
    all_gather_into(out, x)
    out = out.movedim(0, axis)
    if tiled:
        shape = list(x.shape)
        shape[axis] *= n
        out = out.reshape(shape)
    return out


def _scatter(x, dim):
    n = _dist.num_workers()
    if x.shape[dim] % n:
        raise MXNetError(f"reduce_scatter: dim {dim} of {tuple(x.shape)} "
                         f"does not split over {n} ranks")
    moved = x.movedim(dim, 0).contiguous()
    out = moved.new_empty((moved.shape[0] // n,) + tuple(moved.shape[1:]))
    reduce_scatter_into(out, moved)
    return out.movedim(0, dim)


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return all_reduce_(x.detach().clone())

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.detach().clone())


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, tiled):
        ctx.args = (axis, tiled)
        return _gather(x.detach(), axis, tiled)

    @staticmethod
    def backward(ctx, g):
        axis, tiled = ctx.args
        if not tiled:
            return _scatter(g.movedim(axis, 0), 0).squeeze(0), None, None
        return _scatter(g, axis), None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim):
        ctx.dim = dim
        return _scatter(x.detach(), dim)

    @staticmethod
    def backward(ctx, g):
        return _gather(g.contiguous(), ctx.dim, True), None


def _active(axis_name):
    return _size(axis_name) > 1


def psum(x, axis_name):
    """Sum of ``x`` over the axis, on every member."""
    return _Psum.apply(x) if _active(axis_name) else x


def pmean(x, axis_name):
    n = _size(axis_name)
    return psum(x, axis_name) / n if n > 1 else x


def pmax(x, axis_name):
    if not _active(axis_name):
        return x
    return all_reduce_(x.detach().clone(), op='max')


def all_gather(x, axis_name, axis=0, tiled=True):
    """Every member's ``x`` along ``axis``: concatenated (``tiled``) or
    stacked on a new axis, in member order."""
    if not _active(axis_name):
        return x if tiled else x.unsqueeze(axis)
    return _AllGather.apply(x, axis, tiled)


def reduce_scatter(x, axis_name, scatter_dimension=0):
    """This member's chunk of the sum of ``x`` over the axis, split along
    ``scatter_dimension`` (``lax.psum_scatter(..., tiled=True)``)."""
    if not _active(axis_name):
        return x
    return _ReduceScatter.apply(x, scatter_dimension)


def ppermute(x, axis_name, perm):
    raise MXNetError("collectives.ppermute: ring attention and pipeline "
                     "sends are not ported (ROADMAP queue 1 item 13)")


def axis_index(axis_name):
    """This member's index along the axis: its rank."""
    _size(axis_name)
    return _dist.rank()


def axis_size(axis_name):
    return _size(axis_name)


class _OrderedBarrier(torch.autograd.Function):
    @staticmethod
    def forward(ctx, *arrays):
        return tuple(a.view_as(a) for a in arrays)

    @staticmethod
    def backward(ctx, *grads):
        return grads


def ordered_barrier(*arrays):
    """Identity on ``arrays`` whose outputs all come from one node that
    takes every input (``lax.optimization_barrier`` with the JAX
    package's differentiation rule): each output's gradient flows back
    to its own input. ZeRO-3 (``parallel.step``) passes a layer group's
    shards through it together with the previous group's gathered
    values, so the group's gather is issued behind that one; eager
    PyTorch runs in program order, so the chain is also the schedule."""
    return _OrderedBarrier.apply(*arrays)


# ---------------------------------------------------------------------------
# ZeRO-3 gather scheduling helper (pure: copied as it is)
# ---------------------------------------------------------------------------

def _natural_key(s):
    """Sort key treating digit runs numerically: layer2 < layer10."""
    return tuple(int(t) if t.isdigit() else t
                 for t in re.split(r'(\d+)', s))


_LAYER_RE = re.compile(r'^(.*?(?:layer|block|stage|cell|stack)\d+)')


def group_params_by_layer(names):
    """[(group_key, [param_name, ...]), ...] — parameters bucketed by
    the layer-ish prefix of their name (``...layerN``/``blockN``/... if
    present, else the name minus its final ``_kind`` token), groups and
    members in natural (digit-aware) order."""
    groups = {}
    for n in names:
        m = _LAYER_RE.match(n)
        key = m.group(1) if m else \
            (n.rsplit('_', 1)[0] if '_' in n else n)
        groups.setdefault(key, []).append(n)
    return [(k, sorted(groups[k], key=_natural_key))
            for k in sorted(groups, key=_natural_key)]
