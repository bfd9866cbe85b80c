// Tensor-core tile helpers shared by the bf16 flash-attention kernels
// (flash_attn_fwd.cu, flash_attn_bwd.cu): 16-byte cp.async copies into
// padded shared-memory tiles, ldmatrix fragment loads, the
// mma.sync.m16n8k16 bf16 -> f32 product, and the two-term bf16 split of an
// f32 operand.
//
// Fragment layout of mma.sync.m16n8k16 (lane = 4 * g + t, g = lane / 4,
// t = lane % 4):
//  - A (16 x 16, row major), 4 registers of two bf16: a0 = (g, 2t..2t+1),
//    a1 = (g+8, 2t..), a2 = (g, 2t+8..), a3 = (g+8, 2t+8..);
//  - B (16 x 8, k by n), 2 registers: b0 = (k 2t..2t+1, n g),
//    b1 = (k 2t+8.., n g);
//  - C (16 x 8 f32), 4 floats: c0, c1 = (g, 2t..2t+1), c2, c3 = (g+8, 2t..).
// So the C fragments of two neighbouring n-tiles are, after a cast to
// bf16, the A fragment of one 16-deep k-step: a product's output feeds the
// next product from registers.
//
// A tile of R rows of D bf16 lies in shared memory with a row stride of
// D + 8 elements: the 16 bytes of padding move each row 4 banks on, so the
// eight 16-byte rows an ldmatrix reads hit 32 distinct banks for every D
// that is a multiple of 16.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

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

// rows [r0, r0 + R) of a (seq, D) bf16 head slice with row stride st (in
// elements) into a padded R x (D + 8) tile; rows at or past len are zero
template <int R, int D, int THREADS>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          long long st, int r0, int len) {
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

// four 8 x 8 bf16 matrices; lane i gives the address of row i % 8 of
// matrix i / 8
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

// the same, each matrix transposed
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

// Fragment addresses in a padded tile of row stride LD, for lane `lane`.
// A operand (16 rows x 16 k, rows r0.., k from k0) with ldsm_x4 gives
// a0..a3 in order.
__device__ __forceinline__ const __nv_bfloat16* a_addr(const __nv_bfloat16* tile, int LD,
                                                       int r0, int k0, int lane) {
  return tile + (r0 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + k0 + (lane >> 4) * 8;
}

// B operand of two n-tiles from a tile stored n by k (row = n, k
// contiguous: K for Q.K^T), n from n0, k from k0, with ldsm_x4: r[0], r[1]
// are b0, b1 of n-tile n0..n0+7 and r[2], r[3] those of n0+8..n0+15.
__device__ __forceinline__ const __nv_bfloat16* b_addr_nk(const __nv_bfloat16* tile, int LD,
                                                          int n0, int k0, int lane) {
  return tile + (n0 + (lane & 7) + (lane >> 4) * 8) * LD + k0 + ((lane >> 3) & 1) * 8;
}

// B operand of two n-tiles from a tile stored k by n (row = k, n
// contiguous: V for P.V), with ldsm_x4_t: r[0], r[1] are b0, b1 of n-tile
// n0..n0+7 and r[2], r[3] those of n0+8..n0+15.
__device__ __forceinline__ const __nv_bfloat16* b_addr_kn(const __nv_bfloat16* tile, int LD,
                                                          int k0, int n0, int lane) {
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

}  // namespace mma_tiles
