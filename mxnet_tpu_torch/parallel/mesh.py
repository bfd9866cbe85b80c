"""Device meshes (counterpart of ``mxnet_tpu/parallel/mesh.py``).

A mesh names devices along axes ('dp' by default). In a world of more
than one rank (``parallel.dist.init``) a mesh spans the world's ranks,
one device each: position r holds rank r's device, and ``Mesh.device`` is
this rank's, the only one this process places tensors on.
``make_mesh((N,), ('dp',))`` needs a world of N ranks, or N = 1. An axis
other than dp of size > 1 raises: tensor parallelism is ROADMAP queue 1
item 6a. Outside a world the mesh holds one device: the current CUDA
device when none is given, and a CPU mesh only on request
(``devices=['cpu']``).
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as onp
import torch

from ..base import MXNetError
from ..context import resolve_device
from . import dist as _dist

__all__ = ['Mesh', 'make_mesh', 'default_mesh', 'set_default_mesh',
           'mesh_shape']


class Mesh:
    """``devices``: an object array of torch devices shaped by the axes,
    one per rank in rank order; ``rank``: this process's position."""

    def __init__(self, devices, axis_names, rank=0):
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.rank = rank

    @property
    def shape(self):
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self):
        return int(self.devices.size)

    @property
    def device(self):
        """This rank's device."""
        return self.devices.flat[self.rank]

    def __repr__(self):
        return f'Mesh({self.shape}, {list(self.devices.flat)})'


_default_mesh: Optional[Mesh] = None


def make_mesh(axis_shapes: Sequence[int] = None,
              axis_names: Sequence[str] = ('dp',), devices=None) -> Mesh:
    """A mesh of ``axis_shapes`` over the world's ranks, or over
    ``devices`` (default: the current CUDA device) outside a world;
    axis_shapes=None puts every rank (or every given device) on one
    axis."""
    world = _dist.num_workers()
    if world > 1:
        devs = _dist.devices()
        if devices is not None:
            mine = [resolve_device(d) for d in devices]
            if len(mine) != 1 or torch.device(mine[0]) != _dist.device():
                raise MXNetError(f"make_mesh: in a world each rank places "
                                 f"its own device ({_dist.device()}), got "
                                 f"{mine}")
    else:
        devs = [resolve_device(None)] if devices is None else \
            [resolve_device(d) for d in devices]
    n = len(devs)
    if axis_shapes is None:
        axis_shapes = (n,)
    axis_shapes = tuple(int(s) for s in axis_shapes)
    if len(axis_shapes) != len(tuple(axis_names)):
        raise ValueError(f"mesh {axis_shapes} has {len(axis_shapes)} axes "
                         f"but {len(tuple(axis_names))} names")
    for name, s in zip(axis_names, axis_shapes):
        if name != 'dp' and s > 1:
            raise MXNetError(f"mesh axis {name!r} of size {s}: the port "
                             f"places data parallelism only; tensor "
                             f"parallelism is ROADMAP queue 1 item 6a")
    total = int(onp.prod(axis_shapes)) if axis_shapes else 1
    if total > n:
        raise ValueError(f"mesh {axis_shapes} needs {total} devices, "
                         f"have {n}" + (" (one per rank)" if world > 1
                                        else ''))
    if world > 1 and total != world:
        raise MXNetError(f"mesh {axis_shapes} spans {total} of the world's "
                         f"{world} ranks; a mesh spans the whole world")
    if world == 1 and total > 1:
        raise MXNetError(f"mesh {axis_shapes} spans {total} devices in one "
                         f"process: the port runs one rank per card, so a "
                         f"dp mesh of {total} needs a world of {total} "
                         f"ranks (parallel.dist.init or dist.launch_local; "
                         f"ROADMAP queue 1 item 6)")
    dev_array = onp.empty(axis_shapes, dtype=object)
    for i in range(total):
        dev_array.flat[i] = torch.device(devs[i])
    return Mesh(dev_array, axis_names, rank=_dist.rank())


def default_mesh() -> Mesh:
    global _default_mesh
    if _default_mesh is None or \
            _default_mesh.size != _dist.num_workers():
        _default_mesh = make_mesh()
    return _default_mesh


def set_default_mesh(mesh: Mesh):
    global _default_mesh
    _default_mesh = mesh


def mesh_shape(mesh: Mesh = None):
    return (mesh or default_mesh()).shape
