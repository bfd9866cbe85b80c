// Fused FFN1 for Hopper (sm_90a): out = gelu_erf(x . W^T + b), with plain C
// entry points loaded through ctypes by mxnet_tpu_torch/ops/fused_ffn.py.
//
// Replaces: mxnet_tpu/ops/pallas_ffn.py _ffn_kernel (:48-55, launched by
// _fwd_impl). As there, the matrix product runs in the kernel's own body
// with bf16, f16 (or f32) operands and f32 sums, the bias is added in f32, the
// exact GELU 0.5*s*(1+erf(s/sqrt(2))) is taken in f32, and the result is
// stored once in x's dtype, so the (M, N) pre-activation never goes to
// device memory.
//
// What bounds it on the H100: at the BERT-base shapes (M = B*T = 4096,
// K = 768, N = 3072, bf16) the product is 19.3 GFLOP, 19.5 us at the
// 989 TFLOP/s bf16 tensor-core peak, against 36.2 MB of traffic (10.8 us at
// 3.35 TB/s): the bound is operations, and only wgmma reaches that rate.
//
// Three kernels, routed by the wrapper on dtype and K (not a fallback: a
// CUDA tensor always launches one of them, or the wrapper raises):
//
// dense_gelu_tc_kernel, bf16 or f16 (one template over the element type)
// with K a multiple of 8 (a tensor map's rows must be 16-byte strided):
// one block per 128 x 128 output tile, of two
// consumer warpgroups and one producer warp. The producer's one thread
// issues TMA loads (cp.async.bulk.tensor.2d) of 64-deep K slices of x
// (128 x 64) and W (128 x 64) into a ring of three stages, each slice
// 128-byte swizzled, completion counted by an mbarrier per stage ("full").
// Each consumer owns 64 rows: per k16 step one
// wgmma.mma_async.m64n128k16.f32.bf16.bf16 (or .f16.f16) with A and B read
// from shared
// memory through descriptors in the same swizzle mode, both K-major (W's
// (N, K) Dense layout is K-major for B), and frees a stage through a second
// mbarrier ("empty") once the wgmma group that read it has completed. The
// epilogue adds the bias and takes erf-GELU on the accumulators in
// registers, in f32, and packs 16-bit pairs into a 128-byte-swizzled tile in
// shared memory (ring stage 0, free by then) that two TMA stores write out:
// no f32 value goes through shared memory, and the stores are whole
// 128-byte rows. The block uses 97 KB of shared memory and at most 112
// registers a thread (__launch_bounds__(288, 2)), so two blocks share an SM
// and one's epilogue, which costs about as much as its products, runs
// while the other's products do. The TMA
// zero-fills rows past M and K columns past K; the stores write nothing
// past M and N, and where N is no multiple of 8 (out's rows are then not
// 16-byte strided) the epilogue stores from the registers with masks
// instead. So any M, N and ragged K are exact. The tensor maps are encoded
// on the host for each call (cuTensorMapEncodeTiled, looked up at run
// time through the CUDA runtime: no -lcuda link) and passed as
// __grid_constant__ parameters.
//
// dense_gelu_16_kernel (the first design, bf16 or f16 at any K): one block
// per 64x64 tile, K stepped by 32 through shared memory with plain loads,
// four warps of WMMA 16x16x16 16-bit fragments, accumulators through
// shared memory to the epilogue. No pipelining.
//
// float16 changes nothing in the designs: its operands are exact in the
// products' f32 sums as bf16's are, and the epilogue is the same f32 math
// before the cast to x's dtype (a result above 65504 becomes inf there,
// as it does in the JAX kernel's cast).
//
// dense_gelu_f32_kernel, f32: the same tiling, 256 threads each owning a
// 4x4 block of outputs in scalar FMAs.

#include <cuda.h>   // CUtensorMap and its enums only; no libcuda link
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BKS = 32;   // K step staged through shared memory

__device__ __forceinline__ float gelu_erf(float s) {
  return 0.5f * s * (1.0f + erff(s * 0.70710678118654752440f));
}

template <typename T>
constexpr bool is_f16 = std::is_same<T, __half>::value;

__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

// round to nearest even, as astype does
template <typename T>
__device__ __forceinline__ T from_f32(float x) {
  if constexpr (is_f16<T>)
    return __float2half_rn(x);
  else
    return __float2bfloat16(x);
}

// two f32 -> one register of two 16-bit values (round to nearest even),
// x0 in the low half
template <typename T>
__device__ __forceinline__ uint32_t pack2(float x0, float x1) {
  if constexpr (is_f16<T>) {
    __half2 v = __floats2half2_rn(x0, x1);
    return *reinterpret_cast<uint32_t*>(&v);
  } else {
    __nv_bfloat162 v = __floats2bfloat162_rn(x0, x1);
    return *reinterpret_cast<uint32_t*>(&v);
  }
}

// ---------------------------------------------------- bfloat16 and float16
constexpr int LDS = BKS + 8;   // 16-bit row stride: 80 bytes, keeps 32-byte fragment alignment
constexpr int LDC = BN + 4;    // f32 accumulator tile stride

template <typename T>
__global__ void __launch_bounds__(128)
dense_gelu_16_kernel(const T* __restrict__ x, const T* __restrict__ w, const T* __restrict__ bias,
                     T* __restrict__ out, int M, int N, int K) {
  using namespace nvcuda;
  __shared__ __align__(128) T As[BM * LDS];
  __shared__ __align__(128) T Bs[BN * LDS];
  __shared__ __align__(128) float Cs[BM * LDC];

  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int warp = threadIdx.x >> 5;
  const int wm = warp >> 1, wn = warp & 1;
  const T zero = from_f32<T>(0.f);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> c[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(c[i][j], 0.f);

  for (int k0 = 0; k0 < K; k0 += BKS) {
    for (int i = threadIdx.x; i < BM * BKS; i += 128) {
      const int r = i / BKS, kk = i % BKS;
      const int gk = k0 + kk;
      const int gm = m0 + r, gn = n0 + r;
      As[r * LDS + kk] = (gm < M && gk < K) ? x[(long long)gm * K + gk] : zero;
      Bs[r * LDS + kk] = (gn < N && gk < K) ? w[(long long)gn * K + gk] : zero;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BKS; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::col_major> b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], As + (wm * 32 + i * 16) * LDS + kk, LDS);
      // B(k, n) = W[n][k]: W's rows, stored k-contiguous, are B's columns
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], Bs + (wn * 32 + j * 16) * LDS + kk, LDS);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(c[i][j], a[i], b[j], c[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wm * 32 + i * 16) * LDC + wn * 32 + j * 16, c[i][j], LDC,
                              wmma::mem_row_major);
  __syncthreads();
  for (int i = threadIdx.x; i < BM * BN; i += 128) {
    const int r = i / BN, cc = i % BN;
    const int gm = m0 + r, gn = n0 + cc;
    if (gm < M && gn < N) {
      const float s = Cs[r * LDC + cc] + to_f32(bias[gn]);
      out[(long long)gm * N + gn] = from_f32<T>(gelu_erf(s));
    }
  }
}

// ---------------------------------------------------------------- float32
constexpr int LDF = BM + 4;

__global__ void __launch_bounds__(256)
dense_gelu_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                      const float* __restrict__ bias, float* __restrict__ out, int M, int N,
                      int K) {
  __shared__ float As[BKS * LDF];   // k-major: As[k][m]
  __shared__ float Bs[BKS * LDF];   // k-major: Bs[k][n]
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BKS) {
    for (int i = threadIdx.x; i < BM * BKS; i += 256) {
      const int r = i / BKS, kk = i % BKS;
      const int gk = k0 + kk;
      const int gm = m0 + r, gn = n0 + r;
      As[kk * LDF + r] = (gm < M && gk < K) ? x[(long long)gm * K + gk] : 0.f;
      Bs[kk * LDF + r] = (gn < N && gk < K) ? w[(long long)gn * K + gk] : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < BKS; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk * LDF + ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[kk * LDF + tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gm = m0 + ty * 4 + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tx * 4 + j;
      if (gm < M && gn < N) out[(long long)gm * N + gn] = gelu_erf(acc[i][j] + bias[gn]);
    }
  }
}

// ------------------------------------------------------------- wgmma + TMA
namespace tc {

constexpr int TM = 128;           // a block's output tile: 128 x 128
constexpr int TN = 128;
constexpr int BKT = 64;           // K slice: 64 16-bit values = 128 bytes, one swizzle row
constexpr int STAGES = 3;
constexpr int THREADS = 288;      // warpgroups 0, 1: consumers (64 rows each); warp 8: producer
constexpr int A_BYTES = TM * BKT * 2;                  // 16 KB of x
constexpr int B_BYTES = TN * BKT * 2;                  // 16 KB of W
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
constexpr int OUT_BOX = TM * 128;                      // 128 rows x 64 values of out
constexpr int BAR_OFFSET = STAGES * STAGE_BYTES;
// the ring (stage 0 doubles as the out tile once the products are done),
// two mbarriers a stage, and 1 KB to align the base to 1024 bytes, as the
// 128-byte swizzle needs: 97 KB, so two blocks share an SM
constexpr int SMEM_BYTES = BAR_OFFSET + 2 * STAGES * 8 + 1024;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// spin until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// one 2-D tile global -> shared; coordinates innermost first (k, row)
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                         int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// one 2-D tile shared -> global (rows and columns past the edges are not
// written), in this thread's bulk group
__device__ __forceinline__ void tma_store(const CUtensorMap* map, const void* src, int c0, int c1) {
  asm volatile("cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map)),
               "r"(smem_u32(src)), "r"(c0), "r"(c1)
               : "memory");
}

// wgmma shared-memory descriptor of a K-major tile of 128-byte rows in the
// 128-byte swizzle: start address >> 4 in bits 0-13, the leading offset
// (unused by a swizzled K-major tile) 1, the stride between 8-row groups
// (1024 bytes) >> 4 in bits 32-45, layout 1 (128-byte swizzle) in bits
// 62-63. A k16 step inside the 64-wide slice advances the start by 32
// bytes (+2): the swizzle is a function of the address bits, and every
// tile starts on 1024 bytes.
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void st_shared(void* p, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(smem_u32(p)), "r"(v) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// d (64 x 128, f32, the warpgroup's fragment) += A (64 x 16) . B (16 x 128),
// A and B 16-bit (TY: bf16 or f16) from shared memory, both K-major
#define MXTT_WGMMA_M64N128K16(TY)                                                         \
  asm volatile(                                                                           \
      "{\n"                                                                               \
      ".reg .pred p;\n"                                                                   \
      "setp.ne.b32 p, %66, 0;\n"                                                          \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " "                        \
      "{%0, %1, %2, %3, %4, %5, %6, %7, "                                                 \
      " %8, %9, %10, %11, %12, %13, %14, %15, "                                           \
      " %16, %17, %18, %19, %20, %21, %22, %23, "                                         \
      " %24, %25, %26, %27, %28, %29, %30, %31, "                                         \
      " %32, %33, %34, %35, %36, %37, %38, %39, "                                         \
      " %40, %41, %42, %43, %44, %45, %46, %47, "                                         \
      " %48, %49, %50, %51, %52, %53, %54, %55, "                                         \
      " %56, %57, %58, %59, %60, %61, %62, %63}, "                                        \
      "%64, %65, p, 1, 1, 0, 0;\n"                                                        \
      "}\n"                                                                               \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),\
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),\
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),     \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),     \
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),     \
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),     \
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),     \
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),     \
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),     \
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),     \
        "+f"(d[62]), "+f"(d[63])                                                          \
      : "l"(da), "l"(db), "r"(1))

template <typename T>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da, uint64_t db) {
  if constexpr (is_f16<T>)
    MXTT_WGMMA_M64N128K16("f16");
  else
    MXTT_WGMMA_M64N128K16("bf16");
}
#undef MXTT_WGMMA_M64N128K16

// One block per 128 x 128 output tile; two blocks share an SM, so one's
// epilogue runs while the other's products do.
template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
dense_gelu_tc_kernel(const __grid_constant__ CUtensorMap xmap,
                     const __grid_constant__ CUtensorMap wmap,
                     const __grid_constant__ CUtensorMap omap, const T* __restrict__ bias,
                     T* __restrict__ out, int M, int N, int K, int tma_out) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + BAR_OFFSET);
  uint64_t* empty = full + STAGES;
  const int wg = threadIdx.x >> 7;
  const int m0 = blockIdx.y * TM, n0 = blockIdx.x * TN;
  const int nk = (K + BKT - 1) / BKT;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);          // the producer's arrive + the TMA's bytes
      mbar_init(&empty[s], 2);         // one arrive per consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // ---- producer: one thread keeps STAGES slices in flight
    if (threadIdx.x == 256) {
      int stage = 0;
      uint32_t phase = 0;
      for (int kb = 0; kb < nk; ++kb) {
        mbar_wait(&empty[stage], phase ^ 1);   // the first round passes at once
        unsigned char* st = smem + stage * STAGE_BYTES;
        mbar_expect_tx(&full[stage], STAGE_BYTES);
        tma_load(st, &xmap, &full[stage], kb * BKT, m0);
        tma_load(st + A_BYTES, &wmap, &full[stage], kb * BKT, n0);
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg computes rows m0 + 64 wg ..
  const int lane = threadIdx.x & 31;
  const int wrow = ((threadIdx.x >> 5) & 3) * 16 + (lane >> 2);   // row in the 64-row half
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  int stage = 0, prev = 0;
  uint32_t phase = 0;
  for (int kb = 0; kb < nk; ++kb) {
    mbar_wait(&full[stage], phase);
    const unsigned char* st = smem + stage * STAGE_BYTES;
    // this warpgroup's 64 rows of x start 8 KB further on
    const uint64_t da = sw128_desc(st + wg * 64 * 128), db = sw128_desc(st + A_BYTES);
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BKT / 16; ++kk) wgmma_m64n128k16<T>(acc, da + 2 * kk, db + 2 * kk);
    wgmma_commit();
    fence_regs(acc);
    // the previous slice's products have completed: free its stage
    wgmma_wait<1>();
    if (kb > 0 && (threadIdx.x & 127) == 0) mbar_arrive(&empty[prev]);
    prev = stage;
    if (++stage == STAGES) {
      stage = 0;
      phase ^= 1;
    }
  }
  wgmma_wait<0>();
  fence_regs(acc);

  // epilogue on the accumulators: element 4n + 2i + e of the 64 x 128
  // product is row 16 * warp + g + 8i, column 8n + 2t + e (g = lane / 4,
  // t = lane % 4). Bias, then GELU, in f32; one 16-bit pair per (n, i). One
  // column group n at a time: its accumulators pass through an asm after
  // the last group's stores, so the groups' temporaries never overlap.
  if (tma_out) {
    // both consumers are done with every stage: the out tile goes to stage
    // 0 as two boxes of 64 columns in the 128-byte swizzle (16-byte chunk c
    // of row r at chunk c ^ (r % 8): a warp's 4-byte writes hit 32
    // distinct banks), then out by two TMA stores
    asm volatile("bar.sync 1, 256;\n" ::: "memory");
#pragma unroll
    for (int n = 0; n < 16; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(acc[4 * n + e]));
      const int col = n0 + n * 8 + 2 * (lane & 3);
      const float b0 = col < N ? to_f32(bias[col]) : 0.f;
      const float b1 = col + 1 < N ? to_f32(bias[col + 1]) : 0.f;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = 64 * wg + wrow + 8 * i;
        st_shared(smem + (n >> 3) * OUT_BOX + r * 128 + (((n & 7) ^ (r & 7)) << 4) +
                      (lane & 3) * 4,
                  pack2<T>(gelu_erf(acc[4 * n + 2 * i] + b0),
                           gelu_erf(acc[4 * n + 2 * i + 1] + b1)));
      }
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync 1, 256;\n" ::: "memory");
    if (threadIdx.x == 0) {
      tma_store(&omap, smem, n0, m0);
      tma_store(&omap, smem + OUT_BOX, n0 + 64, m0);
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      // shared memory stays valid until the stores have read it
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    }
  } else {
    // N is no multiple of 8 (out's rows are not 16-byte strided): masked
    // stores straight from the registers
#pragma unroll
    for (int n = 0; n < 16; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(acc[4 * n + e]));
      const int col = n0 + n * 8 + 2 * (lane & 3);
      if (col >= N) continue;
      const float b0 = to_f32(bias[col]);
      const float b1 = col + 1 < N ? to_f32(bias[col + 1]) : 0.f;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = m0 + 64 * wg + wrow + 8 * i;
        if (row >= M) continue;
        T* dst = out + (long long)row * N + col;
        dst[0] = from_f32<T>(gelu_erf(acc[4 * n + 2 * i] + b0));
        if (col + 1 < N) dst[1] = from_f32<T>(gelu_erf(acc[4 * n + 2 * i + 1] + b1));
      }
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_fn() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &q);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a (rows, cols) row-major 16-bit matrix of type dt, moved in boxes of
// box_rows x 64, 128-byte swizzled; loads read zero past its edges, stores
// write nothing
bool encode(CUtensorMap* map, CUtensorMapDataType dt, const void* base, int rows, int cols,
            int box_rows) {
  EncodeTiled fn = encode_fn();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {(cuuint32_t)BKT, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, dt, 2, const_cast<void*>(base), dims, strides, box,
            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T>
int launch(const void* x, const void* w, const void* bias, void* out, int M, int N, int K,
           cudaStream_t stream) {
  const CUtensorMapDataType dt =
      is_f16<T> ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  // out goes through TMA stores where its rows are 16-byte strided
  const int tma_out = N % 8 == 0;
  CUtensorMap xmap, wmap, omap;
  if (!encode(&xmap, dt, x, M, K, TM) || !encode(&wmap, dt, w, N, K, TN) ||
      (tma_out && !encode(&omap, dt, out, M, N, TM)))
    return (int)cudaErrorInvalidValue;
  if (!tma_out) omap = xmap;           // not read
  cudaError_t err = cudaFuncSetAttribute(dense_gelu_tc_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((N + TN - 1) / TN, (M + TM - 1) / TM);
  dense_gelu_tc_kernel<T><<<grid, THREADS, SMEM_BYTES, stream>>>(
      xmap, wmap, omap, static_cast<const T*>(bias), static_cast<T*>(out), M, N, K, tma_out);
  return (int)cudaGetLastError();
}

}  // namespace tc

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16. x (M, K), w (N, K), bias
// (N), out (M, N), all contiguous and of one dtype. Returns
// cudaGetLastError().
extern "C" int mxtt_dense_gelu(int dtype, const void* x, const void* w, const void* bias,
                               void* out, int M, int N, int K, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  if (dtype == 0) {
    dense_gelu_f32_kernel<<<grid, 256, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<const float*>(bias), static_cast<float*>(out), M, N, K);
  } else if (dtype == 1) {
    dense_gelu_16_kernel<__nv_bfloat16><<<grid, 128, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
        static_cast<const __nv_bfloat16*>(bias), static_cast<__nv_bfloat16*>(out), M, N, K);
  } else if (dtype == 2) {
    dense_gelu_16_kernel<__half><<<grid, 128, 0, st>>>(
        static_cast<const __half*>(x), static_cast<const __half*>(w),
        static_cast<const __half*>(bias), static_cast<__half*>(out), M, N, K);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// The wgmma + TMA kernel: dtype 1 (bfloat16) or 2 (float16); x (M, K), w
// (N, K), bias (N), out (M, N), contiguous, x and w 16-byte aligned, K a
// multiple of 8. Returns cudaGetLastError() (or cudaErrorInvalidValue where
// a tensor map cannot be encoded).
extern "C" int mxtt_dense_gelu_tc(int dtype, const void* x, const void* w, const void* bias,
                                  void* out, int M, int N, int K, void* stream) {
  if (K % 8 != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return tc::launch<__nv_bfloat16>(x, w, bias, out, M, N, K, st);
  if (dtype == 2) return tc::launch<__half>(x, w, bias, out, M, N, K, st);
  return (int)cudaErrorInvalidValue;
}
