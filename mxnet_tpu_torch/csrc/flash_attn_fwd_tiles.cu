// The tensor-core flash-attention forward (flash_fwd_tc.cuh) at the tiles
// other than the default (64, 64), for the autotuner (ops/autotune.py):
// BQ in {64, 128} q rows per block (4 or 8 warps) by BK in {32, 64, 128}
// keys per step, at D = 64 and 128, bfloat16 and float16. A separate
// library, so nvcc builds it beside flash_attn_fwd.cu. Replaces, with
// that source, mxnet_tpu/ops/pallas_attention.py _fa_fwd_kernel, whose
// (G, bq, bk) blocks the JAX autotuner sweeps.
#define MXTT_FWD_TILES                                                                   \
  MXTT_TILE(64, 64, 32) MXTT_TILE(64, 64, 128) MXTT_TILE(64, 128, 32)                    \
  MXTT_TILE(64, 128, 64) MXTT_TILE(64, 128, 128)                                         \
  MXTT_TILE(128, 64, 32) MXTT_TILE(128, 64, 128) MXTT_TILE(128, 128, 32)                 \
  MXTT_TILE(128, 128, 64) MXTT_TILE(128, 128, 128)
#include "flash_fwd_tc.cuh"
