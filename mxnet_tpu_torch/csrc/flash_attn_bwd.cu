// Flash-attention backward for Hopper (sm_90a): two kernels, dq and dk/dv,
// with plain C entry points loaded through ctypes by
// mxnet_tpu_torch/ops/flash_attention.py.
//
// Replaces: mxnet_tpu/ops/pallas_attention.py _fa_dq_kernel (:283-316)
// and _fa_dkv_kernel (:319-364), launched by _fa_backward. Same arithmetic: the scores of
// _masked_scores in its order (keys at or past Tk get -1e30, then the
// additive key mask, then the causal cut), p = exp(s - lse) from the
// forward's lse, dp = dO.v^T with f32 operands, dp *= keep under dropout,
// ds = p * (dp - delta) * scale with delta = rowsum(dO*O) computed by the
// caller, dq += ds.k, dv += (p*keep)^T.dO with p in f32 (the forward casts
// p to v's dtype; the backward does not), dk += ds^T.q, all accumulated in
// f32 and cast to the input dtype once, at the store. The dropout mask is
// counter_keep over the GLOBAL (bh, row, col) coordinates, the function the
// forward kernel uses (counter_keep.cuh), so the two agree bit for bit.
//
// What bounds it on the H100: at the BERT-base training shape (B=8, H=12,
// T=512, D=64, bf16) the dq kernel does 6*BH*T^2*D = 9.66 GFLOP (s, dp, dq:
// 9.8 us at the 989 TFLOP/s bf16 peak) and moves q, k, v, dO, lse, delta,
// the mask and dq once, 31.9 MB (9.5 us at 3.35 TB/s); the dk/dv kernel
// does 8*BH*T^2*D = 12.9 GFLOP (13.0 us) over 38.1 MB (11.4 us). Both are
// bound by operations, barely: they need the tensor cores and their copies
// in flight. At the 67 TFLOP/s f32 SIMT rate the same work takes 144 us
// and 192 us. The ds split makes the tensor-core kernels do 4/3 (dq) and
// 3/2 (dk/dv) of that work.
//
// Design: the TPU grids carry the dq (and dk, dv) sums across a sequential
// grid axis in VMEM scratch; here one block owns one output tile and loops
// over the other axis itself, keeping its sums in registers and storing
// once, with no atomics, so a gradient is the same from run to run.
//  - dq, bf16 and D in {16, 32, 64, 128} (flash_bwd_dq_tc_kernel in
//    flash_bwd_tc.cuh, a template over the tile (BQ, BK), default (64,
//    64)): one block of BQ / 16 warps per (batch*head, BQ-row q tile), each
//    warp owning
//    16 q rows, whose Q and dO A fragments, lse and delta it loads once and
//    keeps in registers. BK-key tiles of K, V and the mask row come through
//    a two-stage ring of 16-byte cp.async copies. S = Q.K^T and
//    dP = dO.V^T run on mma.sync (exact bf16 operands, f32 sums: the
//    reference's f32 products up to summation order); ds is formed on
//    their accumulators and becomes, in registers, the A fragment of
//    dQ += dS.K, with K as B by ldmatrix.trans. ds is f32 in the
//    reference, so it is split into two bf16 terms (as below) and both are
//    multiplied.
//  - dq, f32 or D = 8 (flash_bwd_dq_kernel): one block per (batch*head,
//    64-row q tile), looping over 64-key tiles staged through shared
//    memory; scalar f32 FMAs out of shared memory (the first design).
//  - dk/dv, bf16 and D in {16, 32, 64, 128} (flash_bwd_dkv_tc_kernel,
//    flash_bwd_tc.cuh, default tile (64, 64)): one block of BK / 16 warps
//    per (batch*head, BK-key tile), each warp owning 16 keys, looping over
//    BQ-row q tiles that come through a two-stage ring
//    of 16-byte cp.async copies (Q, dO, lse, delta), so the next tile is in
//    flight while this one is multiplied. Its four products run on the
//    tensor cores (mma.sync.m16n8k16 bf16 -> f32, operands by ldmatrix from
//    padded, bank-conflict-free tiles): S^T = K.Q^T and dP^T = V.dO^T have
//    bf16 operands that are exact in f32, so they ARE the reference's f32
//    products up to summation order; their accumulators become, in
//    registers, the A fragments of dV += (P*keep)^T.dO and dK += dS^T.Q.
//    Those two have an f32 operand in the reference, which is split into
//    two bf16 terms (hi = bf16(x), lo = bf16(x - hi), 16 significand bits)
//    each multiplied against the exact bf16 dO or Q: within about 2^-16 of
//    the f32 product, 256 times finer than the bf16 rounding of the stored
//    dk and dv. Rounding p and ds to one bf16 would change the reference's
//    arithmetic; the split keeps it.
//  - dk/dv, f32 or D = 8 (flash_bwd_dkv_kernel): the first design, scalar
//    f32 FMAs out of shared memory.
// - float16 (the same tensor-core kernels, one template over the element
//   type): S and dP are again exact products, but the f32 operands of dV
//   and dK (p*keep, ds) and of dQ (ds) cannot be split into two f16 terms
//   as they are: f16 overflows above 65504, and under the f16 AMP recipe
//   dO carries the loss scale (2^16), so ds above 65504 is the normal
//   case. Of the two ways out, running those products on TF32 mma
//   (m16n8k8) would need ds in another fragment layout (columns t and
//   t + 4, not 2t and 2t + 1: a shuffle per element) and K, Q and dO as
//   32-bit values in shared memory (twice the tiles); scaling keeps the
//   layout and the tiles. So each A row (a q row for dQ, a key for dK and
//   dV) is scaled by a power of two before the split (mma_tiles.cuh
//   f16_rescale): E, the largest exponent of the row's values over the
//   tiles so far, sets the unit 2^(E - 14) of the row's f32 sums, which are
//   rescaled, exactly, when E grows. Every scaled value is below 2^15, so
//   hi = f16(x), lo = f16(x - hi) keep 22 significand bits and flush only
//   values 2^40 below the row's largest; the stores scale back. The
//   bfloat16 kernels are the same code without the scaling.
// The wrapper routes both kernels of one backward by dtype and D to the
// same variant; that is not a fallback on failure.
// Under a causal mask, tiles that the cut removes whole are skipped: their
// p is exactly 0, so they would add exact zeros. Rows at or past Tq and
// keys at or past Tk are masked in the kernel instead of padded. q, k, v,
// dO and the outputs are read and written through (batch, head, seq)
// strides with a unit stride on D, so the caller's (B, T, H*D) views need
// no copy (the tensor-core kernel needs 16-byte aligned rows; the wrapper
// checks).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

#include "counter_keep.cuh"
#include "mma_tiles.cuh"

// the tensor-core kernels (flash_bwd_tc.cuh) at their default tile, for
// every tensor-core head dim; flash_attn_dq_tiles.cu and
// flash_attn_dkv_tiles.cu build the other tiles
#define MXTT_DQ_TILES \
  MXTT_TILE(16, 64, 64) MXTT_TILE(32, 64, 64) MXTT_TILE(64, 64, 64) MXTT_TILE(128, 64, 64)
#define MXTT_DKV_TILES \
  MXTT_TILE(16, 64, 64) MXTT_TILE(32, 64, 64) MXTT_TILE(64, 64, 64) MXTT_TILE(128, 64, 64)
#include "flash_bwd_tc.cuh"

namespace {

constexpr int BQ = 64;         // q rows per tile
constexpr int BK = 64;         // keys per tile
constexpr int THREADS = 256;   // 16 x 16 threads own 4 x 4 score elements each
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

using flash_bwd_tc::BwdArgs;
using flash_bwd_tc::Strides;
using flash_bwd_tc::keep_mul;

// _masked_scores for one element, then exp(s - lse)
__device__ __forceinline__ float prob(float dot, const BwdArgs& a, const float* mrow, int qpos,
                                      int kpos, float lse) {
  float s = dot * a.scale;
  s = kpos < a.Tk ? s : NEG_INF;
  if (mrow != nullptr && kpos < a.Tk) s += mrow[kpos];
  if (a.causal && qpos < kpos) s = NEG_INF;
  return expf(s - lse);
}


// rows [r0, r0 + n) of a (seq, D) head slice into shared memory as f32,
// row stride ld, zero past len
template <typename T, int D>
__device__ __forceinline__ void stage(float* dst, int ld, const T* src, long long st, int r0,
                                      int n, int len) {
  for (int i = threadIdx.x; i < n * D; i += THREADS) {
    const int r = i / D, d = i % D;
    dst[r * ld + d] = (r0 + r < len) ? to_f32(src[(r0 + r) * st + d]) : 0.f;
  }
}

// Both kernels first compute, for one (q tile, k tile) cell, the two
// 64 x 64 products S = Q.K^T and dP = dO.V^T: thread (ty, tx) owns rows
// ty*4+i and columns tx+16*j. A (rows) and B (columns) are f32 tiles in
// shared memory with row strides lda and ldb.
template <int D>
__device__ __forceinline__ void two_products(const float* Qs, const float* dOs, int lda,
                                             const float* Ks, const float* Vs, int ldb,
                                             float (&sacc)[4][4], float (&pacc)[4][4]) {
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) sacc[i][j] = pacc[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float qv[4], ov[4], kv[4], vv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      qv[i] = Qs[(ty * 4 + i) * lda + d];
      ov[i] = dOs[(ty * 4 + i) * lda + d];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      kv[j] = Ks[(tx + 16 * j) * ldb + d];
      vv[j] = Vs[(tx + 16 * j) * ldb + d];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        sacc[i][j] = fmaf(qv[i], kv[j], sacc[i][j]);
        pacc[i][j] = fmaf(ov[i], vv[j], pacc[i][j]);
      }
  }
}

// ------------------------------------------------------------------- dq
template <typename T, int D>
__global__ void __launch_bounds__(THREADS) flash_bwd_dq_kernel(const BwdArgs a) {
  static_assert(D % 4 == 0, "D must split over 4 threads");
  const uint32_t seed = a.use_dropout ? *a.seed : 0u;  // the dropout seed, read once
  constexpr int DP = D / 4;            // dq columns per thread
  constexpr int KLD = D + 1;           // padded K/V rows: no bank conflicts in the products
  constexpr int SLD = BK + 1;
  extern __shared__ float smem[];
  float* Qs = smem;                    // BQ x D
  float* dOs = Qs + BQ * D;            // BQ x D
  float* Ks = dOs + BQ * D;            // BK x KLD
  float* Vs = Ks + BK * KLD;           // BK x KLD
  float* dSs = Vs + BK * KLD;          // BQ x SLD
  float* lse_s = dSs + BQ * SLD;       // BQ
  float* delta_s = lse_s + BQ;         // BQ

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * BQ;
  const int b = bh / a.H, h = bh % a.H;
  const int tid = threadIdx.x;
  const T* kp = static_cast<const T*>(a.k) + b * a.ks.b + h * a.ks.h;
  const T* vp = static_cast<const T*>(a.v) + b * a.vs.b + h * a.vs.h;
  const float* mrow =
      a.kmask ? static_cast<const float*>(a.kmask) + (long long)(bh / a.mask_div) * a.Tk : nullptr;

  stage<T, D>(Qs, D, static_cast<const T*>(a.q) + b * a.qs.b + h * a.qs.h, a.qs.t, q0, BQ, a.Tq);
  stage<T, D>(dOs, D, static_cast<const T*>(a.dout) + b * a.dos.b + h * a.dos.h, a.dos.t, q0, BQ,
              a.Tq);
  if (tid < BQ) {
    const bool ok = q0 + tid < a.Tq;
    const long long at = (long long)bh * a.Tq + q0 + tid;
    lse_s[tid] = ok ? static_cast<const float*>(a.lse)[at] : 0.f;
    delta_s[tid] = ok ? static_cast<const float*>(a.delta)[at] : 0.f;
  }

  const int ty = tid >> 4, tx = tid & 15;
  const int row = tid >> 2, part = tid & 3;   // dq phase: one row, a quarter of D
  float acc[DP];
#pragma unroll
  for (int j = 0; j < DP; ++j) acc[j] = 0.f;

  int nkb = (a.Tk + BK - 1) / BK;
  if (a.causal) nkb = min(nkb, (min(q0 + BQ, a.Tq) + BK - 1) / BK);
  for (int kb = 0; kb < nkb; ++kb) {
    const int k0 = kb * BK;
    __syncthreads();                   // the last tile's dq phase is done with Ks and dSs
    stage<T, D>(Ks, KLD, kp, a.ks.t, k0, BK, a.Tk);
    stage<T, D>(Vs, KLD, vp, a.vs.t, k0, BK, a.Tk);
    __syncthreads();

    float sacc[4][4], pacc[4][4];
    two_products<D>(Qs, dOs, D, Ks, Vs, KLD, sacc, pacc);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = ty * 4 + i, c = tx + 16 * j;
        const int qpos = q0 + r, kpos = k0 + c;
        const float p = prob(sacc[i][j], a, mrow, qpos, kpos, lse_s[r]);
        const float dp = pacc[i][j] * keep_mul(a, seed, bh, qpos, kpos);
        dSs[r * SLD + c] = p * (dp - delta_s[r]) * a.scale;
      }
    }
    __syncthreads();

    const float* dsrow = dSs + row * SLD;
    const float* kcol = Ks + part * DP;
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      const float ds = dsrow[c];
#pragma unroll
      for (int j = 0; j < DP; ++j) acc[j] = fmaf(ds, kcol[c * KLD + j], acc[j]);
    }
  }

  const int qpos = q0 + row;
  if (qpos < a.Tq) {
    T* dst = static_cast<T*>(a.out0) + b * a.os.b + h * a.os.h + qpos * a.os.t + part * DP;
#pragma unroll
    for (int j = 0; j < DP; ++j) dst[j] = from_f32<T>(acc[j]);
  }
}

// ---------------------------------------------------------------- dk/dv
template <typename T, int D>
__global__ void __launch_bounds__(THREADS) flash_bwd_dkv_kernel(const BwdArgs a) {
  static_assert(D % 4 == 0, "D must split over 4 threads");
  const uint32_t seed = a.use_dropout ? *a.seed : 0u;  // the dropout seed, read once
  constexpr int DP = D / 4;
  constexpr int KLD = D + 1;
  constexpr int SLD = BK + 1;
  extern __shared__ float smem[];
  float* Ks = smem;                    // BK x KLD
  float* Vs = Ks + BK * KLD;           // BK x KLD
  float* Qs = Vs + BK * KLD;           // BQ x D
  float* dOs = Qs + BQ * D;            // BQ x D
  float* Ps = dOs + BQ * D;            // BQ x SLD: p * keep
  float* dSs = Ps + BQ * SLD;          // BQ x SLD
  float* lse_s = dSs + BQ * SLD;       // BQ
  float* delta_s = lse_s + BQ;         // BQ

  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * BK;
  const int b = bh / a.H, h = bh % a.H;
  const int tid = threadIdx.x;
  const T* qp = static_cast<const T*>(a.q) + b * a.qs.b + h * a.qs.h;
  const T* dop = static_cast<const T*>(a.dout) + b * a.dos.b + h * a.dos.h;
  const float* mrow =
      a.kmask ? static_cast<const float*>(a.kmask) + (long long)(bh / a.mask_div) * a.Tk : nullptr;

  stage<T, D>(Ks, KLD, static_cast<const T*>(a.k) + b * a.ks.b + h * a.ks.h, a.ks.t, k0, BK, a.Tk);
  stage<T, D>(Vs, KLD, static_cast<const T*>(a.v) + b * a.vs.b + h * a.vs.h, a.vs.t, k0, BK, a.Tk);

  const int ty = tid >> 4, tx = tid & 15;
  const int krow = tid >> 2, part = tid & 3;  // dk/dv phase: one key, a quarter of D
  float dk[DP], dv[DP];
#pragma unroll
  for (int j = 0; j < DP; ++j) dk[j] = dv[j] = 0.f;

  const int nqb = (a.Tq + BQ - 1) / BQ;
  const int qb0 = a.causal ? k0 / BQ : 0;     // rows before k0 see none of these keys
  for (int qb = qb0; qb < nqb; ++qb) {
    const int q0 = qb * BQ;
    __syncthreads();                   // the last tile's dk/dv phase is done with Qs..dSs
    stage<T, D>(Qs, D, qp, a.qs.t, q0, BQ, a.Tq);
    stage<T, D>(dOs, D, dop, a.dos.t, q0, BQ, a.Tq);
    if (tid < BQ) {
      const bool ok = q0 + tid < a.Tq;
      const long long at = (long long)bh * a.Tq + q0 + tid;
      lse_s[tid] = ok ? static_cast<const float*>(a.lse)[at] : 0.f;
      delta_s[tid] = ok ? static_cast<const float*>(a.delta)[at] : 0.f;
    }
    __syncthreads();

    float sacc[4][4], pacc[4][4];
    two_products<D>(Qs, dOs, D, Ks, Vs, KLD, sacc, pacc);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = ty * 4 + i, c = tx + 16 * j;
        const int qpos = q0 + r, kpos = k0 + c;
        float pv = 0.f, ds = 0.f;      // rows past Tq contribute nothing
        if (qpos < a.Tq) {
          const float p = prob(sacc[i][j], a, mrow, qpos, kpos, lse_s[r]);
          const float km = keep_mul(a, seed, bh, qpos, kpos);
          pv = p * km;
          ds = p * (pacc[i][j] * km - delta_s[r]) * a.scale;
        }
        Ps[r * SLD + c] = pv;
        dSs[r * SLD + c] = ds;
      }
    }
    __syncthreads();

    const float* ocol = dOs + part * DP;
    const float* qcol = Qs + part * DP;
#pragma unroll 2
    for (int i = 0; i < BQ; ++i) {
      const float pv = Ps[i * SLD + krow], ds = dSs[i * SLD + krow];
#pragma unroll
      for (int j = 0; j < DP; ++j) {
        dv[j] = fmaf(pv, ocol[i * D + j], dv[j]);
        dk[j] = fmaf(ds, qcol[i * D + j], dk[j]);
      }
    }
  }

  const int kpos = k0 + krow;
  if (kpos < a.Tk) {
    const long long at = b * a.os.b + h * a.os.h + kpos * a.os.t + part * DP;
    T* dkp = static_cast<T*>(a.out0) + at;
    T* dvp = static_cast<T*>(a.out1) + at;
#pragma unroll
    for (int j = 0; j < DP; ++j) {
      dkp[j] = from_f32<T>(dk[j]);
      dvp[j] = from_f32<T>(dv[j]);
    }
  }
}

template <typename T, int D>
int launch(bool dkv, const BwdArgs& a, int B, cudaStream_t stream) {
  constexpr int KLD = D + 1, SLD = BK + 1;
  const size_t smem =
      dkv ? sizeof(float) * (2 * BK * KLD + 2 * BQ * D + 2 * BQ * SLD + 2 * BQ)
          : sizeof(float) * (2 * BQ * D + 2 * BK * KLD + BQ * SLD + 2 * BQ);
  auto kernel = dkv ? flash_bwd_dkv_kernel<T, D> : flash_bwd_dq_kernel<T, D>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(B * a.H, dkv ? (a.Tk + BK - 1) / BK : (a.Tq + BQ - 1) / BQ);
  kernel<<<grid, THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_d(bool dkv, int D, const BwdArgs& a, int B, cudaStream_t stream) {
  switch (D) {
    case 8: return launch<T, 8>(dkv, a, B, stream);
    case 16: return launch<T, 16>(dkv, a, B, stream);
    case 32: return launch<T, 32>(dkv, a, B, stream);
    case 64: return launch<T, 64>(dkv, a, B, stream);
    case 128: return launch<T, 128>(dkv, a, B, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}


// which: 0 = dq, 1 = dk/dv
int run(int which, int dtype, int D, const void* q, const void* k, const void* v,
        const void* kmask, const void* dout, const void* lse, const void* delta, void* out0,
        void* out1, int B, int H, int Tq, int Tk, const long long* st, int mask_div, float scale,
        int causal, const unsigned int* seed, unsigned int thresh, float keep_scale,
        int use_dropout, unsigned int bh_base, void* stream) {
  const BwdArgs a = flash_bwd_tc::make_args(q, k, v, kmask, dout, lse, delta, out0, out1, H, Tq,
                                            Tk, st, mask_div, scale, causal, seed, thresh,
                                            keep_scale, use_dropout, bh_base);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_d<float>(which == 1, D, a, B, s);
  if (dtype == 1) return dispatch_d<__nv_bfloat16>(which == 1, D, a, B, s);
  if (dtype == 2) return dispatch_d<__half>(which == 1, D, a, B, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16. kmask may be null (no mask); its row for
// batch*head bh is bh / mask_div. lse and delta are (B*H, Tq) float32,
// contiguous. strides holds 15 (batch, head, seq) element strides: q, k, v,
// dO, then the output(s) (dq; or dk and dv, which share one layout). seed
// points at the dropout seed on the device (its first 32-bit word), read
// once per block and only when use_dropout is set, so a seed drawn on the
// device and a replayed CUDA graph never pass through the host. bh_base is
// added to each block's batch*head index in the dropout hash (a rank's
// first global batch*head under data parallelism; 0 otherwise).
// Returns cudaGetLastError().
extern "C" int mxtt_flash_attn_bwd_dq(int dtype, int D, const void* q, const void* k,
                                      const void* v, const void* kmask, const void* dout,
                                      const void* lse, const void* delta, void* dq, int B, int H,
                                      int Tq, int Tk, const long long* strides, int mask_div,
                                      float scale, int causal, const unsigned int* seed,
                                      unsigned int thresh, float keep_scale, int use_dropout,
                                      unsigned int bh_base, void* stream) {
  return run(0, dtype, D, q, k, v, kmask, dout, lse, delta, dq, nullptr, B, H, Tq, Tk,
             strides, mask_div, scale, causal, seed, thresh, keep_scale, use_dropout, bh_base,
             stream);
}

extern "C" int mxtt_flash_attn_bwd_dkv(int dtype, int D, const void* q, const void* k,
                                       const void* v, const void* kmask, const void* dout,
                                       const void* lse, const void* delta, void* dk, void* dv,
                                       int B, int H, int Tq, int Tk, const long long* strides,
                                       int mask_div, float scale, int causal,
                                       const unsigned int* seed, unsigned int thresh,
                                       float keep_scale, int use_dropout, unsigned int bh_base,
                                       void* stream) {
  return run(1, dtype, D, q, k, v, kmask, dout, lse, delta, dk, dv, B, H, Tq, Tk, strides,
             mask_div, scale, causal, seed, thresh, keep_scale, use_dropout, bh_base, stream);
}
