// Tensor-core tile helpers shared by the 16-bit (bfloat16 and float16)
// flash-attention kernels (flash_attn_fwd.cu, flash_attn_bwd.cu): 16-byte
// cp.async copies into padded shared-memory tiles, ldmatrix fragment loads,
// the mma.sync.m16n8k16 bf16 or f16 -> f32 product, and the two-term split
// of an f32 operand (bf16 as it is; f16 after a per-row power-of-two scale,
// see f16_rescale).
//
// Fragment layout of mma.sync.m16n8k16 (lane = 4 * g + t, g = lane / 4,
// t = lane % 4), the same for both element types:
//  - A (16 x 16, row major), 4 registers of two 16-bit values: a0 = (g, 2t..2t+1),
//    a1 = (g+8, 2t..), a2 = (g, 2t+8..), a3 = (g+8, 2t+8..);
//  - B (16 x 8, k by n), 2 registers: b0 = (k 2t..2t+1, n g),
//    b1 = (k 2t+8.., n g);
//  - C (16 x 8 f32), 4 floats: c0, c1 = (g, 2t..2t+1), c2, c3 = (g+8, 2t..).
// So the C fragments of two neighbouring n-tiles are, after a cast to
// 16 bits, the A fragment of one 16-deep k-step: a product's output feeds
// the next product from registers.
//
// A tile of R rows of D 16-bit values lies in shared memory with a row
// stride of
// D + 8 elements: the 16 bytes of padding move each row 4 banks on, so the
// eight 16-byte rows an ldmatrix reads hit 32 distinct banks for every D
// that is a multiple of 16.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

#include <type_traits>

namespace mma_tiles {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; valid == false zero-fills
// (the source is then not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// 4 bytes global -> shared, asynchronously; valid == false zero-fills
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// rows [r0, r0 + R) of a (seq, D) 16-bit head slice with row stride st
// (in elements) into a padded R x (D + 8) tile; rows at or past len are
// zero
template <int R, int D, int THREADS, typename E>
__device__ __forceinline__ void load_tile(E* dst, const E* src, long long st, int r0, int len) {
  constexpr int CH = D / 8;  // 16-byte chunks per row
  constexpr int LD = D + 8;
  for (int i = threadIdx.x; i < R * CH; i += THREADS) {
    const int r = i / CH, c = i % CH;
    const bool ok = r0 + r < len;
    cp_async16(dst + r * LD + c * 8, src + (ok ? (long long)(r0 + r) * st : 0) + c * 8, ok);
  }
}

// n f32 values [r0, r0 + n) of a row into shared memory; zero at or past len
template <int THREADS>
__device__ __forceinline__ void load_row(float* dst, const float* src, int r0, int n, int len) {
  for (int i = threadIdx.x; i < n; i += THREADS) {
    const bool ok = r0 + i < len;
    cp_async4(dst + i, src + (ok ? r0 + i : 0), ok);
  }
}

// four 8 x 8 16-bit matrices; lane i gives the address of row i % 8 of
// matrix i / 8
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

// the same, each matrix transposed
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

// Fragment addresses in a padded tile of row stride LD, for lane `lane`.
// A operand (16 rows x 16 k, rows r0.., k from k0) with ldsm_x4 gives
// a0..a3 in order.
template <typename E>
__device__ __forceinline__ const E* a_addr(const E* tile, int LD, int r0, int k0, int lane) {
  return tile + (r0 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + k0 + (lane >> 4) * 8;
}

// B operand of two n-tiles from a tile stored n by k (row = n, k
// contiguous: K for Q.K^T), n from n0, k from k0, with ldsm_x4: r[0], r[1]
// are b0, b1 of n-tile n0..n0+7 and r[2], r[3] those of n0+8..n0+15.
template <typename E>
__device__ __forceinline__ const E* b_addr_nk(const E* tile, int LD, int n0, int k0, int lane) {
  return tile + (n0 + (lane & 7) + (lane >> 4) * 8) * LD + k0 + ((lane >> 3) & 1) * 8;
}

// B operand of two n-tiles from a tile stored k by n (row = k, n
// contiguous: V for P.V), with ldsm_x4_t: r[0], r[1] are b0, b1 of n-tile
// n0..n0+7 and r[2], r[3] those of n0+8..n0+15.
template <typename E>
__device__ __forceinline__ const E* b_addr_kn(const E* tile, int LD, int k0, int n0, int lane) {
  return tile + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + n0 + (lane >> 4) * 8;
}

// d += a.b on the tensor cores, bf16 operands, f32 sums
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two f32 -> one register of two bf16 (round to nearest even), x0 in the
// low half: the element with the smaller column index
__device__ __forceinline__ uint32_t pack_bf16(float x0, float x1) {
  __nv_bfloat162 v = __floats2bfloat162_rn(x0, x1);
  return *reinterpret_cast<uint32_t*>(&v);
}

// x = hi + lo + e with hi = bf16(x), lo = bf16(x - hi) (x - hi is exact
// in f32), |e| <= 2^-8 |x - hi| <= 2^-16 |x|: the two terms keep 16 of
// f32's 24 significand bits, and two bf16 products with f32 sums stand in
// for one f32 product
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat16 h0 = __float2bfloat16_rn(x0), h1 = __float2bfloat16_rn(x1);
  const float r0 = x0 - __bfloat162float(h0), r1 = x1 - __bfloat162float(h1);
  __nv_bfloat162 h;
  h.x = h0;
  h.y = h1;
  hi = *reinterpret_cast<uint32_t*>(&h);
  lo = pack_bf16(r0, r1);
}

// ---- float16: the same products, and the scaled split
template <typename E>
constexpr bool is_f16 = std::is_same<E, __half>::value;

// d += a.b on the tensor cores, f16 operands, f32 sums
__device__ __forceinline__ void mma_f16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                        uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two f32 -> one register of two f16 (round to nearest even), x0 low
__device__ __forceinline__ uint32_t pack_f16(float x0, float x1) {
  __half2 v = __floats2half2_rn(x0, x1);
  return *reinterpret_cast<uint32_t*>(&v);
}

// the element type's product and packing
template <typename E>
__device__ __forceinline__ void mma16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                      uint32_t b1) {
  if constexpr (is_f16<E>)
    mma_f16(d, a, b0, b1);
  else
    mma_bf16(d, a, b0, b1);
}

template <typename E>
__device__ __forceinline__ uint32_t pack2(float x0, float x1) {
  if constexpr (is_f16<E>)
    return pack_f16(x0, x1);
  else
    return pack_bf16(x0, x1);
}

// x = hi + lo + e with hi = f16(x), lo = f16(x - hi): |e| <= 2^-11 |x - hi|
// <= 2^-22 |x| while x is a normal f16 (below 65504: f16_rescale sees to
// that), and 2^-25 at most where it is subnormal
__device__ __forceinline__ void split_f16(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const __half h0 = __float2half_rn(x0), h1 = __float2half_rn(x1);
  const float r0 = x0 - __half2float(h0), r1 = x1 - __half2float(h1);
  __half2 h;
  h.x = h0;
  h.y = h1;
  hi = *reinterpret_cast<uint32_t*>(&h);
  lo = pack_f16(r0, r1);
}

template <typename E>
__device__ __forceinline__ void split2(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  if constexpr (is_f16<E>)
    split_f16(x0, x1, hi, lo);
  else
    split_bf16(x0, x1, hi, lo);
}

// 2^k for an integer k in [-126, 127], exactly
__device__ __forceinline__ float exp2i(int k) { return __int_as_float((k + 127) << 23); }

constexpr int F16_TOP = 14;        // a row's largest |x| is scaled below 2^15
constexpr int F16_MIN_EXP = -100;  // the least row exponent (flash_attention.py F16_MIN_EXP)

// The float16 split of an f32 operand x whose A-fragment rows are this
// thread's C-fragment rows g and g + 8 (i = e >> 1), as are those of the
// sums acc that its product feeds. E[i] is the largest exponent of a row's
// values seen so far (floor(log2 max |x|), at least F16_MIN_EXP), and acc
// holds that row's sums in units of 2^(E[i] - F16_TOP). Here E grows to
// this tile's row maxima (shuffled over the row's four lanes), the sums
// are rescaled by the exact power of two that moves them to the new unit,
// and x is scaled into that unit: every |x| < 2^15, so its two f16 terms
// neither overflow nor, down to 2^-40 of the row's largest, flush.
// flash_attention.split_f16 is the same split in PyTorch.
template <int NT, int ND>
__device__ __forceinline__ void f16_rescale(float (&x)[NT][4], float (&acc)[ND][4], int (&E)[2]) {
  float m[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) m[e >> 1] = fmaxf(m[e >> 1], fabsf(x[j][e]));
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    m[i] = fmaxf(m[i], __shfl_xor_sync(0xffffffffu, m[i], 1));
    m[i] = fmaxf(m[i], __shfl_xor_sync(0xffffffffu, m[i], 2));
    // m >= 0: its exponent bits; 0 and f32 subnormals give -127, inf 128
    const int e_t = (__float_as_int(m[i]) >> 23) - 127;
    if (e_t > E[i]) {
      const int d = E[i] - e_t;
      const float f = d < -126 ? 0.f : exp2i(d);
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        acc[n][2 * i] *= f;
        acc[n][2 * i + 1] *= f;
      }
      E[i] = e_t;
    }
    const float s = exp2i(F16_TOP - E[i]);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      x[j][2 * i] *= s;
      x[j][2 * i + 1] *= s;
    }
  }
}

// two f32 -> two adjacent 16-bit values in memory (round to nearest even)
template <typename E>
__device__ __forceinline__ void store2(E* dst, float x0, float x1) {
  *reinterpret_cast<uint32_t*>(dst) = pack2<E>(x0, x1);
}

}  // namespace mma_tiles
