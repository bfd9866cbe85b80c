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

``autotune`` picks the flash kernels' tile per shape (the counterpart of
``ops/autotune.py``).

``launch_counts`` counts each kernel's launches, ``variant_counts`` the
launches of the flash forward, dq, dk/dv and FFN1 kernels by variant,
``dtype_counts`` by dtype and ``tile_counts`` the flash kernels' by tile
(see ``_build``).
"""
from ._build import (dtype_counts, launch_counts, reset_launch_counts,
                     tile_counts, variant_counts)
from . import (attention, autotune, contrib, detection, elemwise,
               flash_attention, fused_ffn, fused_layernorm, index, init,
               matrix, misc, nn, optimizer_ops, reduce)

__all__ = ['attention', 'autotune', 'contrib', 'detection', 'elemwise',
           'flash_attention',
           'fused_ffn', 'fused_layernorm', 'index', 'init', 'matrix', 'misc',
           'nn',
           'optimizer_ops', 'reduce', 'launch_counts', 'reset_launch_counts',
           'variant_counts', 'dtype_counts', 'tile_counts']
