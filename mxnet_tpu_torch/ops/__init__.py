"""Operators of the port. Three of them wrap hand-written Hopper kernels,
each inside a ``torch.autograd.Function``:

- ``flash_attention`` — CUDA C++, forward (csrc/flash_attn_fwd.cu) and
  backward (csrc/flash_attn_bwd.cu: dq and dk/dv), the counterpart of
  ``mxnet_tpu/ops/pallas_attention.py``;
- ``fused_layernorm`` — Triton, the counterpart of
  ``ops/pallas_layernorm.py``; its backward is plain PyTorch;
- ``fused_ffn`` — CUDA C++ (csrc/dense_gelu.cu), the counterpart of
  ``ops/pallas_ffn.py``; its backward is plain PyTorch.

``optimizer_ops`` holds the optimizers' update math (plain PyTorch).

``launch_counts`` counts each kernel's launches (see ``_build``).
"""
from ._build import launch_counts, reset_launch_counts
from . import (attention, flash_attention, fused_ffn, fused_layernorm, nn,
               optimizer_ops)

__all__ = ['attention', 'flash_attention', 'fused_ffn', 'fused_layernorm',
           'nn', 'optimizer_ops', 'launch_counts', 'reset_launch_counts']
