// The tensor-core flash-attention dq kernel (flash_bwd_tc.cuh) at the
// tiles other than the default (64, 64), for the autotuner
// (ops/autotune.py): BQ and BK in {64, 128}, at D = 64 and 128, bfloat16
// and float16. One backward tile sizes both the dq and the dk/dv kernel,
// as one (G, bq, bk) triple sizes both JAX backward kernels, so these are
// the tiles flash_attn_dkv_tiles.cu builds too. A separate library, so
// nvcc builds it beside flash_attn_bwd.cu. Replaces, with that source,
// mxnet_tpu/ops/pallas_attention.py _fa_dq_kernel.
#define MXTT_DQ_TILES                                                                     \
  MXTT_TILE(64, 64, 128) MXTT_TILE(64, 128, 64) MXTT_TILE(64, 128, 128)                   \
  MXTT_TILE(128, 64, 128) MXTT_TILE(128, 128, 64) MXTT_TILE(128, 128, 128)
#include "flash_bwd_tc.cuh"
