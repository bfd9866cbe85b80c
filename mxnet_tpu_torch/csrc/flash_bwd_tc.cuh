// The tensor-core flash-attention backward kernels (flash_bwd_dq_tc_kernel,
// flash_bwd_dkv_tc_kernel) as templates over the element type, the head dim
// and the tile (BQ q rows, BK keys): the dq kernel gives each block BQ q
// rows (one warp per 16) and loops over BK-key tiles; the dk/dv kernel
// gives each block BK keys (one warp per 16) and loops over BQ-row q
// tiles. Included by flash_attn_bwd.cu, which builds the default tile
// (64, 64) for every tensor-core head dim, and by flash_attn_dq_tiles.cu
// and flash_attn_dkv_tiles.cu, which build the other tiles the autotuner
// (ops/autotune.py) may pick. Each includer lists its tiles as
// MXTT_TILE(D, BQ, BK) in MXTT_DQ_TILES and/or MXTT_DKV_TILES before
// including this header; ops/flash_attention.py TILES must list the same
// (a CPU test reads both). The kernels' design and what bounds them are
// described in flash_attn_bwd.cu; the tile changes only how the work is
// cut, so the same arithmetic runs in another order of f32 sums.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

#include "counter_keep.cuh"
#include "mma_tiles.cuh"

namespace flash_bwd_tc {

constexpr float NEG_INF = -1e30f;

struct Strides {
  long long b, h, t;
};

struct BwdArgs {
  const void *q, *k, *v, *kmask, *dout, *lse, *delta;
  void *out0, *out1;           // dq; or dk and dv
  int H, Tq, Tk;
  Strides qs, ks, vs, dos, os;  // os: the output(s)
  int mask_div;
  float scale;
  int causal;
  const uint32_t* seed;  // device pointer, read once per block
  uint32_t thresh;
  float keep_scale;
  int use_dropout;
  uint32_t bh_base;  // added to the local bh in the dropout hash
};

// the dropout multiplier of one element: keep/(1-rate), or 1 without dropout
__device__ __forceinline__ float keep_mul(const BwdArgs& a, uint32_t seed, int bh, int qpos,
                                          int kpos) {
  if (!a.use_dropout) return 1.f;
  return counter_keep(seed, a.bh_base + (uint32_t)bh, (uint32_t)qpos, (uint32_t)kpos,
                      a.thresh)
             ? a.keep_scale
             : 0.f;
}

template <typename E, int D, int BQ, int BK>
__global__ void __launch_bounds__(2 * BK) flash_bwd_dkv_tc_kernel(const BwdArgs a) {
  using namespace mma_tiles;
  static_assert(D % 16 == 0, "D must be a multiple of 16");
  static_assert(BQ % 16 == 0 && BK % 16 == 0, "tiles are multiples of 16");
  constexpr int TC_THREADS = 2 * BK;  // one warp per 16 keys
  const uint32_t seed = a.use_dropout ? *a.seed : 0u;  // the dropout seed, read once
  constexpr int LD = D + 8;    // padded row
  constexpr int KD = D / 16;   // k-steps of K.Q^T and V.dO^T
  constexpr int ND = D / 8;    // n-tiles of dK and dV
  constexpr int NQ = BQ / 8;   // n-tiles of S^T and dP^T, one per 8 q rows
  extern __shared__ __align__(16) unsigned char smem_raw[];
  E* Ks = reinterpret_cast<E*>(smem_raw);                   // BK x LD
  E* Vs = Ks + BK * LD;                                     // BK x LD
  E* Qs = Vs + BK * LD;                                     // 2 x BQ x LD
  E* dOs = Qs + 2 * BQ * LD;                                // 2 x BQ x LD
  float* Ls = reinterpret_cast<float*>(dOs + 2 * BQ * LD);  // 2 x BQ: lse
  float* Dl = Ls + 2 * BQ;                                           // 2 x BQ: delta

  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * BK;
  const int b = bh / a.H, h = bh % a.H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t = lane & 3;
  const E* qp = static_cast<const E*>(a.q) + b * a.qs.b + h * a.qs.h;
  const E* dop = static_cast<const E*>(a.dout) + b * a.dos.b + h * a.dos.h;
  const float* lsep = static_cast<const float*>(a.lse) + (long long)bh * a.Tq;
  const float* delp = static_cast<const float*>(a.delta) + (long long)bh * a.Tq;
  const float* mrow =
      a.kmask ? static_cast<const float*>(a.kmask) + (long long)(bh / a.mask_div) * a.Tk : nullptr;

  // this thread's keys, rows g and g + 8 of the warp's 16: past Tk a key's
  // score is -1e30 (no mask added); else the mask is added
  const int key0 = k0 + warp * 16 + (lane >> 2);
  bool kvalid[2];
  float mval[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    kvalid[i] = key0 + 8 * i < a.Tk;
    mval[i] = (mrow != nullptr && kvalid[i]) ? mrow[key0 + 8 * i] : 0.f;
  }

  // one commit group per q tile: Q, dO, lse and delta into a stage
  auto load_q = [&](int qb, int stage) {
    const int q0 = qb * BQ;
    load_tile<BQ, D, TC_THREADS>(Qs + stage * BQ * LD, qp, a.qs.t, q0, a.Tq);
    load_tile<BQ, D, TC_THREADS>(dOs + stage * BQ * LD, dop, a.dos.t, q0, a.Tq);
    load_row<TC_THREADS>(Ls + stage * BQ, lsep, q0, BQ, a.Tq);
    load_row<TC_THREADS>(Dl + stage * BQ, delp, q0, BQ, a.Tq);
    cp_async_commit();
  };
  load_tile<BK, D, TC_THREADS>(Ks, static_cast<const E*>(a.k) + b * a.ks.b + h * a.ks.h,
                               a.ks.t, k0, a.Tk);
  load_tile<BK, D, TC_THREADS>(Vs, static_cast<const E*>(a.v) + b * a.vs.b + h * a.vs.h,
                               a.vs.t, k0, a.Tk);
  const int nqb = (a.Tq + BQ - 1) / BQ;
  const int qb0 = a.causal ? k0 / BQ : 0;     // rows before k0 see none of these keys
  if (qb0 < nqb)
    load_q(qb0, 0);                   // the first group holds K and V too
  else
    cp_async_commit();

  float dk[ND][4], dv[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;
  // f16 only: each key's exponents of ds and p*keep so far (f16_rescale)
  int ek[2] = {F16_MIN_EXP, F16_MIN_EXP}, ev[2] = {F16_MIN_EXP, F16_MIN_EXP};

  for (int qb = qb0; qb < nqb; ++qb) {
    const int stage = (qb - qb0) & 1, q0 = qb * BQ;
    if (qb + 1 < nqb) {
      load_q(qb + 1, stage ^ 1);       // in flight while this tile is multiplied
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const E* Qt = Qs + stage * BQ * LD;
    const E* dOt = dOs + stage * BQ * LD;
    const float* Lt = Ls + stage * BQ;
    const float* Dt = Dl + stage * BQ;

    // S^T = K.Q^T and dP^T = V.dO^T: exact 16-bit operands, f32 sums
    float s[NQ][4], dp[NQ][4];
#pragma unroll
    for (int j = 0; j < NQ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t kf[4], vf[4];
      ldsm_x4(kf, a_addr(Ks, LD, warp * 16, kk * 16, lane));
      ldsm_x4(vf, a_addr(Vs, LD, warp * 16, kk * 16, lane));
#pragma unroll
      for (int p = 0; p < NQ / 2; ++p) {
        uint32_t bf[4];
        ldsm_x4(bf, b_addr_nk(Qt, LD, p * 16, kk * 16, lane));
        mma16<E>(s[2 * p], kf, bf[0], bf[1]);
        mma16<E>(s[2 * p + 1], kf, bf[2], bf[3]);
        ldsm_x4(bf, b_addr_nk(dOt, LD, p * 16, kk * 16, lane));
        mma16<E>(dp[2 * p], vf, bf[0], bf[1]);
        mma16<E>(dp[2 * p + 1], vf, bf[2], bf[3]);
      }
    }

    // per element (fragment rows are keys, columns q rows): prob()'s
    // masking in its order and exp(s - lse), then p*keep and ds in place.
    // The causal cut and the rows past Tq touch only some steps; those
    // branches are uniform over the block.
    const bool cut = a.causal && q0 < k0 + BK - 1;
#pragma unroll
    for (int j = 0; j < NQ; ++j) {
      const float2 lv = *reinterpret_cast<const float2*>(Lt + j * 8 + 2 * t);
      const float2 dv2 = *reinterpret_cast<const float2*>(Dt + j * 8 + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1, qpos = q0 + j * 8 + 2 * t + (e & 1);
        float x = kvalid[i] ? __fmul_rn(s[j][e], a.scale) + mval[i] : NEG_INF;
        if (cut && qpos < key0 + 8 * i) x = NEG_INF;
        const float p = expf(x - ((e & 1) ? lv.y : lv.x));
        const float km = keep_mul(a, seed, bh, qpos, key0 + 8 * i);
        s[j][e] = p * km;
        dp[j][e] = p * (dp[j][e] * km - ((e & 1) ? dv2.y : dv2.x)) * a.scale;
      }
    }
    if (q0 + BQ > a.Tq) {             // rows past Tq contribute nothing
#pragma unroll
      for (int j = 0; j < NQ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (q0 + j * 8 + 2 * t + (e & 1) >= a.Tq) s[j][e] = dp[j][e] = 0.f;
    }

    // dV += (P*keep)^T.dO and dK += dS^T.Q. The reference multiplies
    // these f32 operands in f32: each is split into two 16-bit terms, hi +
    // lo, both multiplied against the exact dO or Q with f32 sums (in f16
    // after each key's scale, see the header). The S^T and dP^T fragments
    // of q rows 16kk.. are the A fragments of k-step kk.
    if constexpr (is_f16<E>) {
      f16_rescale(s, dv, ev);
      f16_rescale(dp, dk, ek);
    }
#pragma unroll
    for (int kk = 0; kk < NQ / 2; ++kk) {
      uint32_t ph[4], pl[4], sh[4], sl[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int j = 2 * kk + (i >> 1), e = (i & 1) * 2;
        split2<E>(s[j][e], s[j][e + 1], ph[i], pl[i]);
        split2<E>(dp[j][e], dp[j][e + 1], sh[i], sl[i]);
      }
#pragma unroll
      for (int p = 0; p < ND / 2; ++p) {
        uint32_t bf[4];
        ldsm_x4_t(bf, b_addr_kn(dOt, LD, kk * 16, p * 16, lane));
        mma16<E>(dv[2 * p], ph, bf[0], bf[1]);
        mma16<E>(dv[2 * p], pl, bf[0], bf[1]);
        mma16<E>(dv[2 * p + 1], ph, bf[2], bf[3]);
        mma16<E>(dv[2 * p + 1], pl, bf[2], bf[3]);
        ldsm_x4_t(bf, b_addr_kn(Qt, LD, kk * 16, p * 16, lane));
        mma16<E>(dk[2 * p], sh, bf[0], bf[1]);
        mma16<E>(dk[2 * p], sl, bf[0], bf[1]);
        mma16<E>(dk[2 * p + 1], sh, bf[2], bf[3]);
        mma16<E>(dk[2 * p + 1], sl, bf[2], bf[3]);
      }
    }
    __syncthreads();                   // every warp is done with this stage
  }
  cp_async_wait<0>();                  // nothing left in flight (no q tile at all)

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int kpos = key0 + 8 * i;
    if (kpos < a.Tk) {
      const long long at = b * a.os.b + h * a.os.h + kpos * a.os.t + 2 * t;
      E* dkp = static_cast<E*>(a.out0) + at;
      E* dvp = static_cast<E*>(a.out1) + at;
      float uk = 1.f, uv = 1.f;        // f16: the sums' units
      if constexpr (is_f16<E>) {
        uk = exp2i(ek[i] - F16_TOP);
        uv = exp2i(ev[i] - F16_TOP);
      }
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        store2<E>(dkp + n * 8, dk[n][2 * i] * uk, dk[n][2 * i + 1] * uk);
        store2<E>(dvp + n * 8, dv[n][2 * i] * uv, dv[n][2 * i + 1] * uv);
      }
    }
  }
}

template <typename E, int D, int BQ, int BK>
__global__ void __launch_bounds__(2 * BQ) flash_bwd_dq_tc_kernel(const BwdArgs a) {
  using namespace mma_tiles;
  static_assert(D % 16 == 0, "D must be a multiple of 16");
  static_assert(BQ % 16 == 0 && BK % 16 == 0, "tiles are multiples of 16");
  constexpr int TC_THREADS = 2 * BQ;  // one warp per 16 q rows
  const uint32_t seed = a.use_dropout ? *a.seed : 0u;  // the dropout seed, read once
  constexpr int LD = D + 8;    // padded row
  constexpr int KD = D / 16;   // k-steps of Q.K^T and dO.V^T
  constexpr int ND = D / 8;    // n-tiles of dQ
  constexpr int NK = BK / 8;   // n-tiles of S and dP, one per 8 keys
  extern __shared__ __align__(16) unsigned char smem_raw[];
  E* Qs = reinterpret_cast<E*>(smem_raw);                  // BQ x LD
  E* dOs = Qs + BQ * LD;                                   // BQ x LD
  E* Ks = dOs + BQ * LD;                                   // 2 x BK x LD
  E* Vs = Ks + 2 * BK * LD;                                // 2 x BK x LD
  float* Ms = reinterpret_cast<float*>(Vs + 2 * BK * LD);  // 2 x BK: mask
  float* Ls = Ms + 2 * BK;                                           // BQ: lse
  float* Dl = Ls + BQ;                                               // BQ: delta

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * BQ;
  const int b = bh / a.H, h = bh % a.H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t = lane & 3;
  const E* kp = static_cast<const E*>(a.k) + b * a.ks.b + h * a.ks.h;
  const E* vp = static_cast<const E*>(a.v) + b * a.vs.b + h * a.vs.h;
  const float* mrow =
      a.kmask ? static_cast<const float*>(a.kmask) + (long long)(bh / a.mask_div) * a.Tk : nullptr;

  // one commit group per key tile: K, V and the mask row into a stage
  auto load_kv = [&](int kb, int stage) {
    const int k0 = kb * BK;
    load_tile<BK, D, TC_THREADS>(Ks + stage * BK * LD, kp, a.ks.t, k0, a.Tk);
    load_tile<BK, D, TC_THREADS>(Vs + stage * BK * LD, vp, a.vs.t, k0, a.Tk);
    if (mrow != nullptr) load_row<TC_THREADS>(Ms + stage * BK, mrow, k0, BK, a.Tk);
    cp_async_commit();
  };
  load_tile<BQ, D, TC_THREADS>(Qs, static_cast<const E*>(a.q) + b * a.qs.b + h * a.qs.h,
                               a.qs.t, q0, a.Tq);
  load_tile<BQ, D, TC_THREADS>(dOs, static_cast<const E*>(a.dout) + b * a.dos.b + h * a.dos.h,
                               a.dos.t, q0, a.Tq);
  load_row<TC_THREADS>(Ls, static_cast<const float*>(a.lse) + (long long)bh * a.Tq, q0, BQ, a.Tq);
  load_row<TC_THREADS>(Dl, static_cast<const float*>(a.delta) + (long long)bh * a.Tq, q0, BQ,
                       a.Tq);
  int nkb = (a.Tk + BK - 1) / BK;
  if (a.causal) nkb = min(nkb, (min(q0 + BQ, a.Tq) + BK - 1) / BK);  // later keys are cut
  if (nkb > 0)
    load_kv(0, 0);                     // the first group holds Q, dO, lse and delta too
  else
    cp_async_commit();

  // the warp's rows wrow + {g, g + 8}: Q's and dO's A fragments, lse and
  // delta, loaded once
  const int wrow = q0 + warp * 16;
  const int row0 = wrow + (lane >> 2);
  uint32_t qf[KD][4], of[KD][4];
  float lse_r[2], del_r[2];
  float dq[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[n][e] = 0.f;
  int eq[2] = {F16_MIN_EXP, F16_MIN_EXP};   // f16 only: each row's ds exponent so far

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
      for (int kk = 0; kk < KD; ++kk) {
        ldsm_x4(qf[kk], a_addr(Qs, LD, warp * 16, kk * 16, lane));
        ldsm_x4(of[kk], a_addr(dOs, LD, warp * 16, kk * 16, lane));
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        lse_r[i] = Ls[warp * 16 + (lane >> 2) + 8 * i];
        del_r[i] = Dl[warp * 16 + (lane >> 2) + 8 * i];
      }
    }
    const E* Kt = Ks + stage * BK * LD;
    const E* Vt = Vs + stage * BK * LD;
    const float* Mt = Ms + stage * BK;

    // S = Q.K^T and dP = dO.V^T: exact 16-bit operands, f32 sums
    float s[NK][4], dp[NK][4];
#pragma unroll
    for (int j = 0; j < NK; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
#pragma unroll
      for (int p = 0; p < NK / 2; ++p) {
        uint32_t bf[4];
        ldsm_x4(bf, b_addr_nk(Kt, LD, p * 16, kk * 16, lane));
        mma16<E>(s[2 * p], qf[kk], bf[0], bf[1]);
        mma16<E>(s[2 * p + 1], qf[kk], bf[2], bf[3]);
        ldsm_x4(bf, b_addr_nk(Vt, LD, p * 16, kk * 16, lane));
        mma16<E>(dp[2 * p], of[kk], bf[0], bf[1]);
        mma16<E>(dp[2 * p + 1], of[kk], bf[2], bf[3]);
      }
    }

    // per element (fragment rows are q rows, columns keys): _masked_scores
    // in its order (scale; keys at or past Tk get -1e30; the additive mask,
    // staged as 0 past Tk; the causal cut), p = exp(s - lse), dp *= keep,
    // ds = p * (dp - delta) * scale, left in s. The edge and cut branches
    // are uniform over the warp.
    const bool edge = k0 + BK > a.Tk;
    const bool cut = a.causal && k0 + BK - 1 > wrow;
#pragma unroll
    for (int j = 0; j < NK; ++j) {
      const float2 mv = mrow != nullptr ? *reinterpret_cast<const float2*>(Mt + j * 8 + 2 * t)
                                        : make_float2(0.f, 0.f);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1, qpos = row0 + 8 * i, kpos = k0 + j * 8 + 2 * t + (e & 1);
        float x = __fmul_rn(s[j][e], a.scale);   // not fused with + mask
        if (edge && kpos >= a.Tk) x = NEG_INF;
        x += (e & 1) ? mv.y : mv.x;
        if (cut && qpos < kpos) x = NEG_INF;
        const float p = expf(x - lse_r[i]);
        s[j][e] = p * (dp[j][e] * keep_mul(a, seed, bh, qpos, kpos) - del_r[i]) * a.scale;
      }
    }

    // dQ += dS.K. The reference multiplies f32 ds by K in f32: ds is split
    // into two 16-bit terms, hi + lo, both multiplied against the exact K
    // with f32 sums (in f16 after each row's scale, see the header). The
    // dS fragments of keys 16kk.. are the A fragments of k-step kk; K
    // (keys by D) is B by ldmatrix.trans.
    if constexpr (is_f16<E>) f16_rescale(s, dq, eq);
#pragma unroll
    for (int kk = 0; kk < NK / 2; ++kk) {
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int j = 2 * kk + (i >> 1), e = (i & 1) * 2;
        split2<E>(s[j][e], s[j][e + 1], hi[i], lo[i]);
      }
#pragma unroll
      for (int p = 0; p < ND / 2; ++p) {
        uint32_t bf[4];
        ldsm_x4_t(bf, b_addr_kn(Kt, LD, kk * 16, p * 16, lane));
        mma16<E>(dq[2 * p], hi, bf[0], bf[1]);
        mma16<E>(dq[2 * p], lo, bf[0], bf[1]);
        mma16<E>(dq[2 * p + 1], hi, bf[2], bf[3]);
        mma16<E>(dq[2 * p + 1], lo, bf[2], bf[3]);
      }
    }
    __syncthreads();                   // every warp is done with this stage
  }
  cp_async_wait<0>();                  // nothing left in flight (no key tile at all)

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
    if (row < a.Tq) {
      E* dst = static_cast<E*>(a.out0) + b * a.os.b + h * a.os.h + (long long)row * a.os.t +
               2 * t;
      float u = 1.f;                   // f16: the sums' unit
      if constexpr (is_f16<E>) u = exp2i(eq[i] - F16_TOP);
#pragma unroll
      for (int n = 0; n < ND; ++n) store2<E>(dst + n * 8, dq[n][2 * i] * u, dq[n][2 * i + 1] * u);
    }
  }
}

// dynamic shared memory of one block (rows padded to D + 8);
// ops/autotune.py smem_bytes is the same formula
template <typename E, int D, int BQ, int BK>
constexpr size_t dkv_smem_bytes() {
  return sizeof(E) * (2 * BK * (D + 8) + 4 * BQ * (D + 8)) + sizeof(float) * 4 * BQ;
}

template <typename E, int D, int BQ, int BK>
constexpr size_t dq_smem_bytes() {
  return sizeof(E) * (2 * BQ * (D + 8) + 4 * BK * (D + 8)) + sizeof(float) * (2 * BK + 2 * BQ);
}

template <typename E, int D, int BQ, int BK>
int launch_dkv_tc(const BwdArgs& a, int B, cudaStream_t stream) {
  constexpr size_t smem = dkv_smem_bytes<E, D, BQ, BK>();
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkv_tc_kernel<E, D, BQ, BK>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(B * a.H, (a.Tk + BK - 1) / BK);
  flash_bwd_dkv_tc_kernel<E, D, BQ, BK><<<grid, 2 * BK, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename E, int D, int BQ, int BK>
int launch_dq_tc(const BwdArgs& a, int B, cudaStream_t stream) {
  constexpr size_t smem = dq_smem_bytes<E, D, BQ, BK>();
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_tc_kernel<E, D, BQ, BK>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(B * a.H, (a.Tq + BQ - 1) / BQ);
  flash_bwd_dq_tc_kernel<E, D, BQ, BK><<<grid, 2 * BQ, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

inline BwdArgs make_args(const void* q, const void* k, const void* v, const void* kmask,
                         const void* dout, const void* lse, const void* delta, void* out0,
                         void* out1, int H, int Tq, int Tk, const long long* st, int mask_div,
                         float scale, int causal, const unsigned int* seed, unsigned int thresh,
                         float keep_scale, int use_dropout, unsigned int bh_base) {
  return BwdArgs{q, k, v, kmask, dout, lse, delta, out0, out1, H, Tq, Tk,
                 Strides{st[0], st[1], st[2]}, Strides{st[3], st[4], st[5]},
                 Strides{st[6], st[7], st[8]}, Strides{st[9], st[10], st[11]},
                 Strides{st[12], st[13], st[14]}, mask_div, scale, causal, seed, thresh,
                 keep_scale, use_dropout, bh_base};
}

#ifdef MXTT_DQ_TILES
template <typename E>
int dispatch_dq_tile(int D, int bq, int bk, const BwdArgs& a, int B, cudaStream_t s) {
#define MXTT_TILE(DD, Q, K) \
  if (D == DD && bq == Q && bk == K) return launch_dq_tc<E, DD, Q, K>(a, B, s);
  MXTT_DQ_TILES
#undef MXTT_TILE
  return (int)cudaErrorInvalidValue;
}
#endif

#ifdef MXTT_DKV_TILES
template <typename E>
int dispatch_dkv_tile(int D, int bq, int bk, const BwdArgs& a, int B, cudaStream_t s) {
#define MXTT_TILE(DD, Q, K) \
  if (D == DD && bq == Q && bk == K) return launch_dkv_tc<E, DD, Q, K>(a, B, s);
  MXTT_DKV_TILES
#undef MXTT_TILE
  return (int)cudaErrorInvalidValue;
}
#endif

// registers, local (spill) bytes and the most threads a block may have,
// of one built kernel (cudaFuncGetAttributes)
template <typename K>
int attrs_of(K* kernel, int* out) {
  cudaFuncAttributes fa;
  cudaError_t err = cudaFuncGetAttributes(&fa, kernel);
  if (err != cudaSuccess) return (int)err;
  out[0] = fa.numRegs;
  out[1] = (int)fa.localSizeBytes;
  out[2] = fa.maxThreadsPerBlock;
  return 0;
}

#ifdef MXTT_DQ_TILES
template <typename E>
int dq_attrs_tile(int D, int bq, int bk, int* out) {
#define MXTT_TILE(DD, Q, K) \
  if (D == DD && bq == Q && bk == K) return attrs_of(flash_bwd_dq_tc_kernel<E, DD, Q, K>, out);
  MXTT_DQ_TILES
#undef MXTT_TILE
  return (int)cudaErrorInvalidValue;
}
#endif

#ifdef MXTT_DKV_TILES
template <typename E>
int dkv_attrs_tile(int D, int bq, int bk, int* out) {
#define MXTT_TILE(DD, Q, K) \
  if (D == DD && bq == Q && bk == K) return attrs_of(flash_bwd_dkv_tc_kernel<E, DD, Q, K>, out);
  MXTT_DKV_TILES
#undef MXTT_TILE
  return (int)cudaErrorInvalidValue;
}
#endif

}  // namespace flash_bwd_tc

// The tensor-core dq and dk/dv kernels at tile (bq, bk): dtype 1
// (bfloat16) or 2 (float16), D and the tile one of the includer's
// MXTT_DQ_TILES / MXTT_DKV_TILES; q, k, v, dO and the outputs' rows
// 16-byte aligned. The other arguments as for mxtt_flash_attn_bwd_dq /
// _dkv (flash_attn_bwd.cu). Return cudaGetLastError(), or
// cudaErrorInvalidValue for a dtype, D or tile this library does not hold.
#ifdef MXTT_DQ_TILES
extern "C" int mxtt_flash_attn_bwd_dq_tc(int dtype, int D, int bq, int bk, const void* q,
                                         const void* k, const void* v, const void* kmask,
                                         const void* dout, const void* lse, const void* delta,
                                         void* dq, int B, int H, int Tq, int Tk,
                                         const long long* strides, int mask_div, float scale,
                                         int causal, const unsigned int* seed,
                                         unsigned int thresh, float keep_scale, int use_dropout,
                                         unsigned int bh_base, void* stream) {
  const flash_bwd_tc::BwdArgs a = flash_bwd_tc::make_args(
      q, k, v, kmask, dout, lse, delta, dq, nullptr, H, Tq, Tk, strides, mask_div, scale, causal,
      seed, thresh, keep_scale, use_dropout, bh_base);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return flash_bwd_tc::dispatch_dq_tile<__nv_bfloat16>(D, bq, bk, a, B, s);
  if (dtype == 2) return flash_bwd_tc::dispatch_dq_tile<__half>(D, bq, bk, a, B, s);
  return (int)cudaErrorInvalidValue;
}
#endif

#ifdef MXTT_DKV_TILES
extern "C" int mxtt_flash_attn_bwd_dkv_tc(int dtype, int D, int bq, int bk, const void* q,
                                          const void* k, const void* v, const void* kmask,
                                          const void* dout, const void* lse, const void* delta,
                                          void* dk, void* dv, int B, int H, int Tq, int Tk,
                                          const long long* strides, int mask_div, float scale,
                                          int causal, const unsigned int* seed,
                                          unsigned int thresh, float keep_scale,
                                          int use_dropout, unsigned int bh_base, void* stream) {
  const flash_bwd_tc::BwdArgs a = flash_bwd_tc::make_args(
      q, k, v, kmask, dout, lse, delta, dk, dv, H, Tq, Tk, strides, mask_div, scale, causal, seed,
      thresh, keep_scale, use_dropout, bh_base);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return flash_bwd_tc::dispatch_dkv_tile<__nv_bfloat16>(D, bq, bk, a, B, s);
  if (dtype == 2) return flash_bwd_tc::dispatch_dkv_tile<__half>(D, bq, bk, a, B, s);
  return (int)cudaErrorInvalidValue;
}
#endif

// out[0..2] = registers a thread, local bytes a thread (spills), the most
// threads a block may have, of the dq / dk/dv kernel at tile (bq, bk); the
// autotuner prunes a tile that spills before it times any
#ifdef MXTT_DQ_TILES
extern "C" int mxtt_flash_attn_bwd_dq_tc_attrs(int dtype, int D, int bq, int bk, int* out) {
  if (dtype == 1) return flash_bwd_tc::dq_attrs_tile<__nv_bfloat16>(D, bq, bk, out);
  if (dtype == 2) return flash_bwd_tc::dq_attrs_tile<__half>(D, bq, bk, out);
  return (int)cudaErrorInvalidValue;
}
#endif

#ifdef MXTT_DKV_TILES
extern "C" int mxtt_flash_attn_bwd_dkv_tc_attrs(int dtype, int D, int bq, int bk, int* out) {
  if (dtype == 1) return flash_bwd_tc::dkv_attrs_tile<__nv_bfloat16>(D, bq, bk, out);
  if (dtype == 2) return flash_bwd_tc::dkv_attrs_tile<__half>(D, bq, bk, out);
  return (int)cudaErrorInvalidValue;
}
#endif
