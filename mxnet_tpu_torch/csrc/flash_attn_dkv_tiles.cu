// The tensor-core flash-attention dk/dv kernel (flash_bwd_tc.cuh) at the
// tiles other than the default (64, 64), for the autotuner
// (ops/autotune.py): BQ and BK in {64, 128}, at D = 64 and 128, bfloat16
// and float16 (the tiles of flash_attn_dq_tiles.cu; see there). A
// separate library, so nvcc builds it beside flash_attn_bwd.cu. Replaces,
// with that source, mxnet_tpu/ops/pallas_attention.py _fa_dkv_kernel.
#define MXTT_DKV_TILES                                                                    \
  MXTT_TILE(64, 64, 128) MXTT_TILE(64, 128, 64) MXTT_TILE(64, 128, 128)                   \
  MXTT_TILE(128, 64, 128) MXTT_TILE(128, 128, 64) MXTT_TILE(128, 128, 128)
#include "flash_bwd_tc.cuh"
