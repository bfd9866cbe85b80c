// Attention-dropout keep mask shared by the flash-attention forward
// (flash_attn_fwd.cu) and backward (flash_attn_bwd.cu) kernels, so that the
// two cannot drift apart.
//
// It is the JAX package's _counter_keep (mxnet_tpu/ops/pallas_attention.py):
// the murmur3 finalizer over the GLOBAL (batch*head, row, col) coordinates
// of an attention element, in uint32 arithmetic that wraps the same way in
// Mosaic, XLA and here. So the mask is a pure function of the seed and the
// coordinates, whatever the tiling. Under data parallelism the kernels pass
// bh as the rank's first global batch*head plus the local one, so two ranks
// with one seed draw the masks of their own rows of the global batch.
#pragma once

#include <stdint.h>

__device__ __forceinline__ bool counter_keep(uint32_t seed, uint32_t bh, uint32_t row,
                                             uint32_t col, uint32_t thresh) {
  uint32_t h = row * 0x9E3779B1u + col;
  h = h + bh * 0x9e3779b9u;
  h = h ^ seed;
  h = h ^ (h >> 16);
  h = h * 0x85ebca6bu;
  h = h ^ (h >> 13);
  h = h * 0xc2b2ae35u;
  h = h ^ (h >> 16);
  return h >= thresh;
}
