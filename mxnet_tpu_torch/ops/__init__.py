"""Operators of the port. Three of them wrap hand-written Hopper kernels:

- ``flash_attention`` — CUDA C++ (csrc/flash_attn_fwd.cu), the
  counterpart of ``mxnet_tpu/ops/pallas_attention.py``'s forward;
- ``fused_layernorm`` — Triton, the counterpart of
  ``ops/pallas_layernorm.py``;
- ``fused_ffn`` — CUDA C++ (csrc/dense_gelu.cu), the counterpart of
  ``ops/pallas_ffn.py``.

``launch_counts`` counts each kernel's launches (see ``_build``).
"""
from ._build import launch_counts, reset_launch_counts
from . import attention, flash_attention, fused_ffn, fused_layernorm, nn

__all__ = ['attention', 'flash_attention', 'fused_ffn', 'fused_layernorm',
           'nn', 'launch_counts', 'reset_launch_counts']
