"""The compiled training step on one device (counterpart of
``mxnet_tpu/parallel``: ``mesh`` and ``step``)."""
from .mesh import (Mesh, default_mesh, make_mesh, mesh_shape,
                   set_default_mesh)
from .step import ShardedTrainStep, rename_states

__all__ = ['Mesh', 'ShardedTrainStep', 'default_mesh', 'make_mesh',
           'mesh_shape', 'rename_states', 'set_default_mesh']
