// The tensor-core flash-attention forward (flash_fwd_tc_kernel) as a
// template over the element type, the head dim and the tile: BQ q rows per
// block (one warp per 16 rows, so BQ / 16 warps) and BK keys per step of
// the key loop. Included by flash_attn_fwd.cu, which builds the default
// tile (64, 64) for every tensor-core head dim, and by
// flash_attn_fwd_tiles.cu, which builds the other tiles the autotuner
// (ops/autotune.py) may pick. Each includer lists its tiles in
// MXTT_FWD_TILES, a sequence of MXTT_TILE(D, BQ, BK), before including this
// header; ops/flash_attention.py TILES must list the same (a CPU test
// reads both). The kernel's design and what bounds it are described in
// flash_attn_fwd.cu; the tile changes only how much of Q a block keeps in
// registers (BQ) and how many keys one step of the online softmax takes
// (BK), so the same arithmetic runs in another order of f32 sums.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

#include "counter_keep.cuh"
#include "mma_tiles.cuh"

namespace flash_fwd_tc {

constexpr float NEG_INF = -1e30f;

struct Strides {
  long long b, h, t;
};

// one launch's arguments, as mxtt_flash_attn_fwd_tc takes them
struct FwdCall {
  const void *q, *k, *v, *kmask;
  void *o, *lse;
  int B, H, Tq, Tk;
  Strides qs, ks, vs, os;
  int mask_div;
  float scale;
  int causal;
  const uint32_t* seed;
  uint32_t thresh;
  float keep_scale;
  int use_dropout;
  uint32_t bh_base;
  cudaStream_t stream;
};

template <typename E, int D, int BQ, int BK>
__global__ void __launch_bounds__(2 * BQ)
flash_fwd_tc_kernel(const E* __restrict__ q, const E* __restrict__ k,
                    const E* __restrict__ v, const float* __restrict__ kmask,
                    E* __restrict__ o, float* __restrict__ lse, int H, int Tq, int Tk,
                    Strides qs, Strides ks, Strides vs, Strides os, int mask_div, float scale,
                    int causal, const uint32_t* __restrict__ seed_ptr, uint32_t thresh,
                    float keep_scale, int use_dropout, uint32_t bh_base) {
  using namespace mma_tiles;
  static_assert(D % 16 == 0, "D must be a multiple of 16");
  static_assert(BQ % 16 == 0 && BK % 16 == 0, "tiles are multiples of 16");
  constexpr int TC_THREADS = 2 * BQ;  // one warp per 16 q rows
  const uint32_t seed = use_dropout ? *seed_ptr : 0u;  // the dropout seed, read once
  constexpr int LD = D + 8;    // padded row
  constexpr int KD = D / 16;   // k-steps of Q.K^T
  constexpr int ND = D / 8;    // n-tiles of P.V
  constexpr int NK = BK / 8;   // n-tiles of Q.K^T, one per 8 keys
  constexpr float LOG2E = 1.4426950408889634f;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  E* Qs = reinterpret_cast<E*>(smem_raw);                  // BQ x LD
  E* Ks = Qs + BQ * LD;                                    // 2 x BK x LD
  E* Vs = Ks + 2 * BK * LD;                                // 2 x BK x LD
  float* Ms = reinterpret_cast<float*>(Vs + 2 * BK * LD);  // 2 x BK

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * BQ;
  const int b = bh / H, h = bh % H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t = lane & 3;
  const E* kp = k + b * ks.b + h * ks.h;
  const E* vp = v + b * vs.b + h * vs.h;
  const float* mrow = kmask ? kmask + (long long)(bh / mask_div) * Tk : nullptr;

  // one commit group per key tile: K, V and the mask row into a stage
  auto load_kv = [&](int kb, int stage) {
    const int k0 = kb * BK;
    load_tile<BK, D, TC_THREADS>(Ks + stage * BK * LD, kp, ks.t, k0, Tk);
    load_tile<BK, D, TC_THREADS>(Vs + stage * BK * LD, vp, vs.t, k0, Tk);
    if (mrow != nullptr) load_row<TC_THREADS>(Ms + stage * BK, mrow, k0, BK, Tk);
    cp_async_commit();
  };
  load_tile<BQ, D, TC_THREADS>(Qs, q + b * qs.b + h * qs.h, qs.t, q0, Tq);
  load_kv(0, 0);                       // the first group holds Q too

  // the warp's rows wrow + {g, g + 8}; Q's A fragments, loaded once
  const int wrow = q0 + warp * 16;
  const int row0 = wrow + (lane >> 2);
  uint32_t qf[KD][4];
  float acc[ND][4];
  float m_i[2] = {NEG_INF, NEG_INF}, l_i[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  const int nkb = (Tk + BK - 1) / BK;
  for (int kb = 0; kb < nkb; ++kb) {
    const int stage = kb & 1, k0 = kb * BK;
    if (kb + 1 < nkb) {
      load_kv(kb + 1, stage ^ 1);      // in flight while this tile is multiplied
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (kb == 0) {
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) ldsm_x4(qf[kk], a_addr(Qs, LD, warp * 16, kk * 16, lane));
    }
    const E* Kt = Ks + stage * BK * LD;
    const E* Vt = Vs + stage * BK * LD;
    const float* Mt = Ms + stage * BK;

    // S = Q.K^T: 16-bit operands, f32 sums
    float s[NK][4];
#pragma unroll
    for (int j = 0; j < NK; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
#pragma unroll
      for (int p = 0; p < NK / 2; ++p) {
        uint32_t bf[4];
        ldsm_x4(bf, b_addr_nk(Kt, LD, p * 16, kk * 16, lane));
        mma16<E>(s[2 * p], qf[kk], bf[0], bf[1]);
        mma16<E>(s[2 * p + 1], qf[kk], bf[2], bf[3]);
      }
    }

    // _masked_scores in its order: scale; keys at or past Tk get -1e30
    // (only the last tile has any); the additive mask (staged as 0 past Tk,
    // so those keys stay at -1e30); the causal cut (only tiles that reach
    // past the warp's first row). Each branch is uniform over the warp.
#pragma unroll
    for (int j = 0; j < NK; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = __fmul_rn(s[j][e], scale);  // not fused with + mask
    if (k0 + BK > Tk) {
#pragma unroll
      for (int j = 0; j < NK; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (k0 + j * 8 + 2 * t + (e & 1) >= Tk) s[j][e] = NEG_INF;
    }
    if (mrow != nullptr) {
#pragma unroll
      for (int j = 0; j < NK; ++j) {
        const float2 mv = *reinterpret_cast<const float2*>(Mt + j * 8 + 2 * t);
        s[j][0] += mv.x;
        s[j][1] += mv.y;
        s[j][2] += mv.x;
        s[j][3] += mv.y;
      }
    }
    if (causal && k0 + BK - 1 > wrow) {
#pragma unroll
      for (int j = 0; j < NK; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (row0 + (e >> 1) * 8 < k0 + j * 8 + 2 * t + (e & 1)) s[j][e] = NEG_INF;
    }

    // the online softmax: the tile's row max, shuffled across the four
    // lanes of a row; l sums the undropped p. exp(x) is taken as
    // exp2(x * log2(e)): one MUFU.EX2 and a multiply where expf adds a
    // range reduction, within a few f32 ulps of expf (x = s - m is exact,
    // and 0 for a row that is all -1e30, as in the reference)
    float mc[2] = {NEG_INF, NEG_INF}, alpha[2], psum[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < NK; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) mc[e >> 1] = fmaxf(mc[e >> 1], s[j][e]);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mc[i] = fmaxf(mc[i], __shfl_xor_sync(0xffffffffu, mc[i], 1));
      mc[i] = fmaxf(mc[i], __shfl_xor_sync(0xffffffffu, mc[i], 2));
      const float m_new = fmaxf(m_i[i], mc[i]);
      alpha[i] = exp2f((m_i[i] - m_new) * LOG2E);
      m_i[i] = m_new;
    }
#pragma unroll
    for (int j = 0; j < NK; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f((s[j][e] - m_i[e >> 1]) * LOG2E);
        psum[e >> 1] += p;
        s[j][e] = p;
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      psum[i] += __shfl_xor_sync(0xffffffffu, psum[i], 1);
      psum[i] += __shfl_xor_sync(0xffffffffu, psum[i], 2);
      l_i[i] = l_i[i] * alpha[i] + psum[i];
    }
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }
    // dropout scales only what P.V sees
    if (use_dropout) {
#pragma unroll
      for (int j = 0; j < NK; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const uint32_t row = (uint32_t)(row0 + (e >> 1) * 8);
          const uint32_t col = (uint32_t)(k0 + j * 8 + 2 * t + (e & 1));
          s[j][e] = counter_keep(seed, bh_base + (uint32_t)bh, row, col, thresh)
                        ? s[j][e] * keep_scale
                        : 0.f;
        }
    }

    // P.V: P cast to v's dtype; the S fragments of keys 16kk.. are the A
    // fragment of k-step kk
#pragma unroll
    for (int kk = 0; kk < NK / 2; ++kk) {
      uint32_t pa[4];
      pa[0] = pack2<E>(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack2<E>(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack2<E>(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack2<E>(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int p = 0; p < ND / 2; ++p) {
        uint32_t bf[4];
        ldsm_x4_t(bf, b_addr_kn(Vt, LD, kk * 16, p * 16, lane));
        mma16<E>(acc[2 * p], pa, bf[0], bf[1]);
        mma16<E>(acc[2 * p + 1], pa, bf[2], bf[3]);
      }
    }
    __syncthreads();                   // every warp is done with this stage
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + i * 8;
    if (row < Tq) {
      const float safe_l = fmaxf(l_i[i], 1e-30f);
      E* orow = o + b * os.b + h * os.h + (long long)row * os.t + 2 * t;
#pragma unroll
      for (int n = 0; n < ND; ++n)
        store2<E>(orow + n * 8, acc[n][2 * i] / safe_l, acc[n][2 * i + 1] / safe_l);
      if (t == 0) lse[(long long)bh * Tq + row] = m_i[i] + logf(safe_l);
    }
  }
}

// dynamic shared memory of one block: Q, a two-stage ring of K and V
// tiles (rows padded to D + 8) and the mask rows; ops/autotune.py
// smem_bytes is the same formula
template <typename E, int D, int BQ, int BK>
constexpr size_t smem_bytes() {
  return sizeof(E) * (BQ * (D + 8) + 4 * BK * (D + 8)) + sizeof(float) * 2 * BK;
}

template <typename E, int D, int BQ, int BK>
int launch_tc(const FwdCall& c) {
  constexpr size_t smem = smem_bytes<E, D, BQ, BK>();
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_tc_kernel<E, D, BQ, BK>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(c.B * c.H, (c.Tq + BQ - 1) / BQ);
  flash_fwd_tc_kernel<E, D, BQ, BK><<<grid, 2 * BQ, smem, c.stream>>>(
      static_cast<const E*>(c.q), static_cast<const E*>(c.k), static_cast<const E*>(c.v),
      static_cast<const float*>(c.kmask), static_cast<E*>(c.o), static_cast<float*>(c.lse),
      c.H, c.Tq, c.Tk, c.qs, c.ks, c.vs, c.os, c.mask_div, c.scale, c.causal, c.seed, c.thresh,
      c.keep_scale, c.use_dropout, c.bh_base);
  return (int)cudaGetLastError();
}

// the includer's tiles; cudaErrorInvalidValue for one it did not build
template <typename E>
int dispatch_tile(int D, int bq, int bk, const FwdCall& c) {
#define MXTT_TILE(DD, Q, K) \
  if (D == DD && bq == Q && bk == K) return launch_tc<E, DD, Q, K>(c);
  MXTT_FWD_TILES
#undef MXTT_TILE
  return (int)cudaErrorInvalidValue;
}

// registers, local (spill) bytes and the most threads a block may have,
// of one built tile (cudaFuncGetAttributes)
template <typename E, int D, int BQ, int BK>
int attrs_tc(int* out) {
  cudaFuncAttributes fa;
  cudaError_t err = cudaFuncGetAttributes(&fa, flash_fwd_tc_kernel<E, D, BQ, BK>);
  if (err != cudaSuccess) return (int)err;
  out[0] = fa.numRegs;
  out[1] = (int)fa.localSizeBytes;
  out[2] = fa.maxThreadsPerBlock;
  return 0;
}

template <typename E>
int attrs_tile(int D, int bq, int bk, int* out) {
#define MXTT_TILE(DD, Q, K) \
  if (D == DD && bq == Q && bk == K) return attrs_tc<E, DD, Q, K>(out);
  MXTT_FWD_TILES
#undef MXTT_TILE
  return (int)cudaErrorInvalidValue;
}

}  // namespace flash_fwd_tc

// The tensor-core forward at tile (bq, bk): dtype 1 (bfloat16) or 2
// (float16), D and the tile one of the includer's MXTT_FWD_TILES; q, k, v
// and o rows 16-byte aligned. The other arguments as for
// mxtt_flash_attn_fwd (flash_attn_fwd.cu). Returns cudaGetLastError(), or
// cudaErrorInvalidValue for a dtype, D or tile this library does not hold.
extern "C" int mxtt_flash_attn_fwd_tc(int dtype, int D, int bq, int bk, const void* q,
                                      const void* k, const void* v, const void* kmask, void* o,
                                      void* lse, int B, int H, int Tq, int Tk, long long q_sb,
                                      long long q_sh, long long q_st, long long k_sb,
                                      long long k_sh, long long k_st, long long v_sb,
                                      long long v_sh, long long v_st, long long o_sb,
                                      long long o_sh, long long o_st, int mask_div, float scale,
                                      int causal, const unsigned int* seed, unsigned int thresh,
                                      float keep_scale, int use_dropout, unsigned int bh_base,
                                      void* stream) {
  using flash_fwd_tc::Strides;
  const flash_fwd_tc::FwdCall c{q, k, v, kmask, o, lse, B, H, Tq, Tk,
                                Strides{q_sb, q_sh, q_st}, Strides{k_sb, k_sh, k_st},
                                Strides{v_sb, v_sh, v_st}, Strides{o_sb, o_sh, o_st},
                                mask_div, scale, causal, seed, thresh, keep_scale,
                                use_dropout, bh_base, static_cast<cudaStream_t>(stream)};
  if (dtype == 1) return flash_fwd_tc::dispatch_tile<__nv_bfloat16>(D, bq, bk, c);
  if (dtype == 2) return flash_fwd_tc::dispatch_tile<__half>(D, bq, bk, c);
  return (int)cudaErrorInvalidValue;
}

// out[0..2] = registers a thread, local bytes a thread (spills), the most
// threads a block may have, of the tensor-core forward at tile (bq, bk);
// the autotuner prunes a tile that spills before it times any
extern "C" int mxtt_flash_attn_fwd_tc_attrs(int dtype, int D, int bq, int bk, int* out) {
  if (dtype == 1) return flash_fwd_tc::attrs_tile<__nv_bfloat16>(D, bq, bk, out);
  if (dtype == 2) return flash_fwd_tc::attrs_tile<__half>(D, bq, bk, out);
  return (int)cudaErrorInvalidValue;
}
