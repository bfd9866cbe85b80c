// Flash-attention forward for Hopper (sm_90a), with a plain C entry point
// loaded through ctypes by mxnet_tpu_torch/ops/flash_attention.py.
//
// Replaces: mxnet_tpu/ops/pallas_attention.py _fa_fwd_kernel (launched by
// _fa_forward). Same arithmetic: s = q.k^T * scale in f32; keys at or past
// Tk get -1e30, then the additive key mask, then the causal cut (the order
// of _masked_scores); online softmax with m starting at -1e30, l summed
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
// at the 989 TFLOP/s bf16 tensor-core peak. So the bound is bytes, and
// the design keeps the T x T scores out of device memory: one block per
// (batch*head, 64-row q tile) loops over 64-key tiles staged through
// shared memory, with m, l and the accumulator in registers.
//
// This first version computes with scalar f32 FMAs out of shared memory
// (no tensor cores, no TMA): it is right first; making it fast with wgmma
// is later work. There is no head grouping and no padding to a block
// multiple: the ragged edge of q and k is masked in the kernel. q, k, v
// and o are read and written through (batch, head, seq) strides with a
// unit stride on D, so the caller's (B, T, H*D) projections need no copy.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "counter_keep.cuh"

namespace {

constexpr int BQ = 64;         // q rows per block
constexpr int BK = 64;         // keys per tile
constexpr int THREADS = 256;   // 4 threads per q row in the softmax / P.V phase
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as astype does
}

struct Strides {
  long long b, h, t;
};

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const float* __restrict__ kmask, T* __restrict__ o, float* __restrict__ lse,
                 int H, int Tq, int Tk, Strides qs, Strides ks, Strides vs, Strides os,
                 int mask_div, float scale, int causal, uint32_t seed, uint32_t thresh,
                 float keep_scale, int use_dropout) {
  static_assert(D % 4 == 0, "D must split over 4 threads");
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
        pv = counter_keep(seed, (uint32_t)bh, grow, (uint32_t)(k0 + c), thresh) ? p * keep_scale
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
           int mask_div, float scale, int causal, uint32_t seed, uint32_t thresh,
           float keep_scale, int use_dropout, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (BQ * D + BK * (D + 1) + BK * D + BQ * (BK + 1));
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(B * H, (Tq + BQ - 1) / BQ);
  flash_fwd_kernel<T, D><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(kmask), static_cast<T*>(o), static_cast<float*>(lse), H, Tq,
      Tk, qs, ks, vs, os, mask_div, scale, causal, seed, thresh, keep_scale, use_dropout);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_d(int D, const void* q, const void* k, const void* v, const void* kmask, void* o,
               void* lse, int B, int H, int Tq, int Tk, Strides qs, Strides ks, Strides vs,
               Strides os, int mask_div, float scale, int causal, uint32_t seed,
               uint32_t thresh, float keep_scale, int use_dropout, cudaStream_t stream) {
#define MXTT_FA_CASE(DD)                                                                     \
  case DD:                                                                                   \
    return launch<T, DD>(q, k, v, kmask, o, lse, B, H, Tq, Tk, qs, ks, vs, os, mask_div,     \
                         scale, causal, seed, thresh, keep_scale, use_dropout, stream);
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

// dtype: 0 = float32, 1 = bfloat16. kmask may be null (no mask); its row for
// batch*head bh is bh / mask_div (mask_div = H for a per-batch mask).
// lse is (B*H, Tq) float32, contiguous. Returns cudaGetLastError().
extern "C" int mxtt_flash_attn_fwd(int dtype, int D, const void* q, const void* k,
                                   const void* v, const void* kmask, void* o, void* lse, int B,
                                   int H, int Tq, int Tk, long long q_sb, long long q_sh,
                                   long long q_st, long long k_sb, long long k_sh,
                                   long long k_st, long long v_sb, long long v_sh,
                                   long long v_st, long long o_sb, long long o_sh,
                                   long long o_st, int mask_div, float scale, int causal,
                                   unsigned int seed, unsigned int thresh, float keep_scale,
                                   int use_dropout, void* stream) {
  const Strides qs{q_sb, q_sh, q_st}, ks{k_sb, k_sh, k_st}, vs{v_sb, v_sh, v_st},
      os{o_sb, o_sh, o_st};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_d<float>(D, q, k, v, kmask, o, lse, B, H, Tq, Tk, qs, ks, vs, os,
                             mask_div, scale, causal, seed, thresh, keep_scale, use_dropout,
                             st);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(D, q, k, v, kmask, o, lse, B, H, Tq, Tk, qs, ks, vs, os,
                                     mask_div, scale, causal, seed, thresh, keep_scale,
                                     use_dropout, st);
  return (int)cudaErrorInvalidValue;
}
