// Flash-attention forward for Hopper (sm_90a), with a plain C entry point
// loaded through ctypes by mxnet_tpu_torch/ops/flash_attention.py.
//
// Replaces: mxnet_tpu/ops/pallas_attention.py _fa_fwd_kernel (:171-218,
// launched by _fa_forward). Same arithmetic: s = q.k^T * scale in f32;
// keys at or past Tk get -1e30, then the additive key mask, then the causal
// cut (the order of _masked_scores); online softmax with m starting at -1e30, l summed
// over the UNdropped p, the f32 accumulator rescaled by exp(m_prev-m_new);
// dropout scales only the P.V product, with the keep mask hashed from the
// GLOBAL (bh, row, col) coordinates exactly as _counter_keep does, so the
// mask matches the JAX package bit for bit whatever the tiling; P is cast
// to the value dtype before P.V, as the TPU kernel does; o = acc /
// max(l, 1e-30) in the input dtype and lse = m + log(max(l, 1e-30)) in f32.
//
// What bounds it on the H100: at the BERT-base serving shape (B=8, H=12,
// T=512, D=64, bf16) the function reads q, k, v and the mask and writes o
// and lse once: 25.4 MB, 7.6 us at 3.35 TB/s; its 6.44 GFLOP take 6.5 us
// at the 989 TFLOP/s bf16 tensor-core peak. Bytes and operations are
// nearly level, so the kernel has to run its products on the tensor cores
// AND keep its copies in flight; the T x T scores never leave the chip.
//
// Two kernels, routed by the wrapper on dtype and head dim (not a
// fallback: a CUDA tensor always launches one of them, or raises):
//
// flash_fwd_tc_kernel (flash_fwd_tc.cuh), bf16 or f16 and D in {16, 32,
// 64, 128}: the tensor-core design, one template over the element type,
// the head dim and the tile (BQ, BK). One block of BQ / 16 warps per
// (batch*head, BQ-row q tile); each warp owns 16 q rows. The default tile
// (64, 64), four warps, is built here for every D; flash_attn_fwd_tiles.cu
// builds the others the autotuner may pick (ops/autotune.py).
// The two products have 16-bit operands and f32 sums in the JAX kernel
// (S = Q.K^T; P cast to v's dtype before P.V), so mma.sync.m16n8k16
// bf16 (or f16) -> f32 computes them as the reference does: Q's
// A fragments stay in registers for the whole key loop, K and V come from
// shared memory through ldmatrix (V transposed by ldmatrix.trans), and
// the S accumulator turns into the 16-bit A fragments of P.V in registers,
// so P never touches shared memory. The online softmax runs on the
// accumulator's registers, its row max and row sum shuffled across the
// four lanes that share a row. BK-key tiles of K, V and the mask row come
// through a two-stage ring of 16-byte cp.async copies, so tile j+1 is in
// flight while tile j is multiplied; rows are padded by 16 bytes in
// shared memory so ldmatrix is free of bank conflicts. The softmax takes
// exp as exp2 of x * log2(e), one MUFU op, where expf adds a range
// reduction: at D = 64 the per-score work (scale, mask, max, exp, sum,
// cast) costs about as much as the products. mma.sync and not wgmma: its
// register fragments are fixed by the PTX ISA, while a wgmma shared-memory
// descriptor or swizzle that is slightly off gives silently wrong tiles;
// wgmma is a later redesign.
//
// flash_fwd_kernel, f32 (any listed D), and bf16 and f16 at D = 8: the
// first design, scalar f32 FMAs out of shared memory.
//
// float16 needs nothing of its own here: P is at most the dropout keep
// scale, the cast P -> f16 before P.V is what the JAX kernel does, and
// o = acc / l is no larger than the largest |v|. The float16 backward's
// products do (flash_attn_bwd.cu).
//
// In both, there is no head grouping and no padding to a block multiple:
// the ragged edge of q and k is masked in the kernel. q, k, v and o are
// read and written through (batch, head, seq) strides with a unit stride
// on D, so the caller's (B, T, H*D) projections need no copy (the
// tensor-core kernel needs 16-byte aligned rows; the wrapper checks).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

#include "counter_keep.cuh"
#include "mma_tiles.cuh"

// the tensor-core kernel (flash_fwd_tc.cuh) at its default tile, for every
// tensor-core head dim; flash_attn_fwd_tiles.cu builds the other tiles
#define MXTT_FWD_TILES \
  MXTT_TILE(16, 64, 64) MXTT_TILE(32, 64, 64) MXTT_TILE(64, 64, 64) MXTT_TILE(128, 64, 64)
#include "flash_fwd_tc.cuh"

namespace {

constexpr int BQ = 64;         // q rows per block
constexpr int BK = 64;         // keys per tile
constexpr int THREADS = 256;   // 4 threads per q row in the softmax / P.V phase
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as astype does
}
template <> __device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half_rn(x);
}

struct Strides {
  long long b, h, t;
};

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const float* __restrict__ kmask, T* __restrict__ o, float* __restrict__ lse,
                 int H, int Tq, int Tk, Strides qs, Strides ks, Strides vs, Strides os,
                 int mask_div, float scale, int causal, const uint32_t* __restrict__ seed_ptr,
                 uint32_t thresh, float keep_scale, int use_dropout, uint32_t bh_base) {
  static_assert(D % 4 == 0, "D must split over 4 threads");
  const uint32_t seed = use_dropout ? *seed_ptr : 0u;  // the dropout seed, read once
  constexpr int DP = D / 4;            // output columns per thread
  constexpr int KLD = D + 1;           // padded K row: no bank conflicts in the score loop
  constexpr int SLD = BK + 1;
  extern __shared__ float smem[];
  float* Qs = smem;                    // BQ x D
  float* Ks = Qs + BQ * D;             // BK x KLD
  float* Vs = Ks + BK * KLD;           // BK x D
  float* Ss = Vs + BK * D;             // BQ x SLD

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * BQ;
  const int b = bh / H, h = bh % H;
  const int tid = threadIdx.x;
  const T* qp = q + b * qs.b + h * qs.h;
  const T* kp = k + b * ks.b + h * ks.h;
  const T* vp = v + b * vs.b + h * vs.h;
  const float* mrow = kmask ? kmask + (long long)(bh / mask_div) * Tk : nullptr;

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int r = i / D, d = i % D;
    Qs[i] = (q0 + r < Tq) ? to_f32(qp[(q0 + r) * qs.t + d]) : 0.f;
  }

  // score phase: thread (ty, tx) owns rows ty*4+i and columns tx+16*j
  const int ty = tid >> 4, tx = tid & 15;
  // softmax / P.V phase: thread owns one row and a quarter of D; the four
  // threads of a row are adjacent lanes of one warp
  const int row = tid >> 2, part = tid & 3;
  float acc[DP];
#pragma unroll
  for (int j = 0; j < DP; ++j) acc[j] = 0.f;
  float m_i = NEG_INF, l_i = 0.f;

  const int nkb = (Tk + BK - 1) / BK;
  for (int kb = 0; kb < nkb; ++kb) {
    const int k0 = kb * BK;
    __syncthreads();                   // the last tile's P.V is done with Vs and Ss
    for (int i = tid; i < BK * D; i += THREADS) {
      const int r = i / D, d = i % D;
      const bool ok = k0 + r < Tk;
      Ks[r * KLD + d] = ok ? to_f32(kp[(k0 + r) * ks.t + d]) : 0.f;
      Vs[r * D + d] = ok ? to_f32(vp[(k0 + r) * vs.t + d]) : 0.f;
    }
    __syncthreads();

    float sacc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sacc[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty * 4 + i) * D + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * KLD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sacc[i][j] = fmaf(qv[i], kv[j], sacc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = ty * 4 + i, c = tx + 16 * j;
        const int kpos = k0 + c;
        float s = sacc[i][j] * scale;
        s = kpos < Tk ? s : NEG_INF;
        if (mrow != nullptr && kpos < Tk) s += mrow[kpos];
        if (causal && q0 + r < kpos) s = NEG_INF;
        Ss[r * SLD + c] = s;
      }
    }
    __syncthreads();

    float* srow = Ss + row * SLD;
    float mc = NEG_INF;
#pragma unroll
    for (int c = part * 16; c < part * 16 + 16; ++c) mc = fmaxf(mc, srow[c]);
    mc = fmaxf(mc, __shfl_xor_sync(0xffffffffu, mc, 1));
    mc = fmaxf(mc, __shfl_xor_sync(0xffffffffu, mc, 2));
    const float m_new = fmaxf(m_i, mc);
    const float alpha = expf(m_i - m_new);
    float psum = 0.f;
    const uint32_t grow = (uint32_t)(q0 + row);
#pragma unroll
    for (int c = part * 16; c < part * 16 + 16; ++c) {
      const float p = expf(srow[c] - m_new);
      psum += p;
      float pv = p;
      if (use_dropout)
        pv = counter_keep(seed, bh_base + (uint32_t)bh, grow, (uint32_t)(k0 + c), thresh)
                 ? p * keep_scale
                                                                                : 0.f;
      srow[c] = to_f32(from_f32<T>(pv));
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    l_i = l_i * alpha + psum;
    m_i = m_new;
    __syncwarp();                      // the row's p, written by this warp, is read by it

#pragma unroll
    for (int j = 0; j < DP; ++j) acc[j] *= alpha;
    const float* vcol = Vs + part * DP;
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      const float p = srow[c];
#pragma unroll
      for (int j = 0; j < DP; ++j) acc[j] = fmaf(p, vcol[c * D + j], acc[j]);
    }
  }

  const int qpos = q0 + row;
  if (qpos < Tq) {
    const float safe_l = fmaxf(l_i, 1e-30f);
    T* orow = o + b * os.b + h * os.h + qpos * os.t + part * DP;
#pragma unroll
    for (int j = 0; j < DP; ++j) orow[j] = from_f32<T>(acc[j] / safe_l);
    if (part == 0) lse[(long long)bh * Tq + qpos] = m_i + logf(safe_l);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* kmask, void* o, void* lse,
           int B, int H, int Tq, int Tk, Strides qs, Strides ks, Strides vs, Strides os,
           int mask_div, float scale, int causal, const uint32_t* seed, uint32_t thresh,
           float keep_scale, int use_dropout, uint32_t bh_base, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (BQ * D + BK * (D + 1) + BK * D + BQ * (BK + 1));
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(B * H, (Tq + BQ - 1) / BQ);
  flash_fwd_kernel<T, D><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(kmask), static_cast<T*>(o), static_cast<float*>(lse), H, Tq,
      Tk, qs, ks, vs, os, mask_div, scale, causal, seed, thresh, keep_scale, use_dropout,
      bh_base);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_d(int D, const void* q, const void* k, const void* v, const void* kmask, void* o,
               void* lse, int B, int H, int Tq, int Tk, Strides qs, Strides ks, Strides vs,
               Strides os, int mask_div, float scale, int causal, const uint32_t* seed,
               uint32_t thresh, float keep_scale, int use_dropout, uint32_t bh_base,
               cudaStream_t stream) {
#define MXTT_FA_CASE(DD)                                                                     \
  case DD:                                                                                   \
    return launch<T, DD>(q, k, v, kmask, o, lse, B, H, Tq, Tk, qs, ks, vs, os, mask_div,     \
                         scale, causal, seed, thresh, keep_scale, use_dropout, bh_base, stream);
  switch (D) {
    MXTT_FA_CASE(8)
    MXTT_FA_CASE(16)
    MXTT_FA_CASE(32)
    MXTT_FA_CASE(64)
    MXTT_FA_CASE(128)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef MXTT_FA_CASE
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16. kmask may be null (no mask); its row for
// batch*head bh is bh / mask_div (mask_div = H for a per-batch mask).
// lse is (B*H, Tq) float32, contiguous. seed points at the dropout seed on
// the device (its first 32-bit word), read once per block and only when
// use_dropout is set. bh_base is added to each block's batch*head index in
// the dropout hash: a rank's first global batch*head under data
// parallelism, so its masks are the one-device program's; 0 otherwise.
// Returns cudaGetLastError().
extern "C" int mxtt_flash_attn_fwd(int dtype, int D, const void* q, const void* k,
                                   const void* v, const void* kmask, void* o, void* lse, int B,
                                   int H, int Tq, int Tk, long long q_sb, long long q_sh,
                                   long long q_st, long long k_sb, long long k_sh,
                                   long long k_st, long long v_sb, long long v_sh,
                                   long long v_st, long long o_sb, long long o_sh,
                                   long long o_st, int mask_div, float scale, int causal,
                                   const unsigned int* seed, unsigned int thresh, float keep_scale,
                                   int use_dropout, unsigned int bh_base, void* stream) {
  const Strides qs{q_sb, q_sh, q_st}, ks{k_sb, k_sh, k_st}, vs{v_sb, v_sh, v_st},
      os{o_sb, o_sh, o_st};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_d<float>(D, q, k, v, kmask, o, lse, B, H, Tq, Tk, qs, ks, vs, os,
                             mask_div, scale, causal, seed, thresh, keep_scale, use_dropout,
                             bh_base, st);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(D, q, k, v, kmask, o, lse, B, H, Tq, Tk, qs, ks, vs, os,
                                     mask_div, scale, causal, seed, thresh, keep_scale,
                                     use_dropout, bh_base, st);
  if (dtype == 2)
    return dispatch_d<__half>(D, q, k, v, kmask, o, lse, B, H, Tq, Tk, qs, ks, vs, os, mask_div,
                              scale, causal, seed, thresh, keep_scale, use_dropout, bh_base, st);
  return (int)cudaErrorInvalidValue;
}
