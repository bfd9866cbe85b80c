"""Operators of the port. Three of them wrap hand-written Hopper kernels,
each inside a ``torch.autograd.Function``:

- ``flash_attention`` — CUDA C++, forward (csrc/flash_attn_fwd.cu) and
  backward (csrc/flash_attn_bwd.cu: dq and dk/dv), the counterpart of
  ``mxnet_tpu/ops/pallas_attention.py``;
- ``fused_layernorm`` — Triton, the counterpart of
  ``ops/pallas_layernorm.py``; its backward is plain PyTorch;
- ``fused_ffn`` — CUDA C++ (csrc/dense_gelu.cu), the counterpart of
  ``ops/pallas_ffn.py``; its backward is plain PyTorch.

``elemwise``, ``reduce``, ``matrix``, ``index``, ``init`` and part of
``nn`` are the registered ops that ``mx.nd`` wraps for NDArrays (plain
PyTorch, as the JAX package left them to XLA).

``contrib`` (the box ops: IoU, NMS, anchors) and ``detection`` (the SSD
and R-CNN heads) are the detection ops, also plain PyTorch.

``misc`` holds the symbolic API's loss ops (``SoftmaxOutput``,
``MakeLoss``, the regression outputs) and ``gradient_multiplier``, each
with its own gradient.

``optimizer_ops`` holds the optimizers' update math (plain PyTorch).

``rowsparse`` (the dedup-first lookup and the compiled step's RowSparse
capture), ``sparse_ops`` (storage casts, retain, the CSR product) and
``graph`` (the DGL ops) are the sparse ops, plain PyTorch as the JAX
package left them to XLA.

``autotune`` picks the flash kernels' tile per shape (the counterpart of
``ops/autotune.py``).

``launch_counts`` counts each kernel's launches, ``variant_counts`` the
launches of the flash forward, dq, dk/dv and FFN1 kernels by variant,
``dtype_counts`` by dtype and ``tile_counts`` the flash kernels' by tile
(see ``_build``).

``random_ops``, ``sequence``, ``quantization`` (int8 products exact in
int32 through float64), ``numpy_ops`` (the ``_npi_*``/``_np_*`` ops of
``mx.np``) and ``ref_compat`` (MXNet's long tail) complete the JAX
package's registry; ``ref_aliases``, imported last, makes every name of
MXNet 1.6's op inventory resolve through ``get_op``, as the JAX package's
``ops/__init__.py`` does.
"""
from ._build import (dtype_counts, launch_counts, reset_launch_counts,
                     tile_counts, variant_counts)
from . import (elemwise, reduce, matrix, nn, index, init, random_ops,
               optimizer_ops, sequence, attention, contrib, detection, misc,
               control_flow, quantization, numpy_ops, sparse_ops, graph,
               ref_compat)
from . import ref_aliases  # after every op module
from . import (autotune, flash_attention, fused_ffn, fused_layernorm,
               rowsparse)
from ..base import _OP_REGISTRY, register_op as _register_op

__all__ = ['attention', 'autotune', 'contrib', 'control_flow', 'detection',
           'elemwise', 'flash_attention',
           'fused_ffn', 'fused_layernorm', 'graph', 'index', 'init',
           'matrix', 'misc', 'nn', 'numpy_ops', 'quantization',
           'random_ops', 'ref_aliases', 'ref_compat', 'rowsparse',
           'sequence', 'sparse_ops',
           'optimizer_ops', 'reduce', 'launch_counts', 'reset_launch_counts',
           'variant_counts', 'dtype_counts', 'tile_counts']


# the counts of outputs the symbolic API needs for this slice's
# multi-output ops (from the JAX package's ``ops/__init__.py`` table; the
# ops ported earlier declare theirs where they are registered)
for _name, _n in [('hawkes_ll', 2), ('sgd_mom_update', 2),
                  ('adam_update', 3)]:
    _od = _OP_REGISTRY[_name]
    _register_op(_name, num_outputs=_n, mutate_inputs=_od.mutate_inputs,
                  nograd=_od.nograd)(_od.fn)
