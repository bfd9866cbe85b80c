"""The compiled training step, on one card or data-parallel over a world
of ranks (counterpart of ``mxnet_tpu/parallel``: ``mesh``, ``step``,
``collectives`` and the ``init`` part of ``dist``)."""
from . import collectives, dist
from .mesh import (Mesh, default_mesh, make_mesh, mesh_shape,
                   set_default_mesh)
from .step import ShardedTrainStep, compose_zero_spec, rename_states

__all__ = ['Mesh', 'ShardedTrainStep', 'collectives', 'compose_zero_spec',
           'default_mesh', 'dist', 'make_mesh', 'mesh_shape',
           'rename_states', 'set_default_mesh']
