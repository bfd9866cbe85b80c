// Fused FFN1 for Hopper (sm_90a): out = gelu_erf(x . W^T + b), with a plain C
// entry point loaded through ctypes by mxnet_tpu_torch/ops/fused_ffn.py.
//
// Replaces: mxnet_tpu/ops/pallas_ffn.py _ffn_kernel (launched by _fwd_impl).
// As there, the matrix product runs in the kernel's own body with f32
// accumulation, and the epilogue (bias, then 0.5*s*(1+erf(s/sqrt(2))) in
// f32) is applied in registers before the single store in x's dtype, so the
// (M, N) pre-activation never goes to device memory.
//
// What bounds it on the H100: at the BERT-base serving shape (M = B*T =
// 4096, K = 768, N = 3072, bf16) the product is 19.3 GFLOP, 19.5 us at the
// 989 TFLOP/s bf16 tensor-core peak, against 36.2 MB of traffic (10.8 us at
// 3.35 TB/s): the bound is operations, so the bf16 path runs on the tensor
// cores. Design: one block per 64x64 output tile, K stepped by 32 through
// shared memory. For bf16, four warps each own a 32x32 quarter and use
// WMMA 16x16x16 bf16 fragments with f32 accumulators; the accumulators go
// through shared memory to the epilogue. For f32, 256 threads each own a
// 4x4 block of outputs and use scalar FMAs. Rows and columns that do not
// divide the tile are masked. No TMA, no wgmma, no pipelining yet: this is
// the simple kernel that is right; making it fast is later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BKS = 32;   // K step staged through shared memory

__device__ __forceinline__ float gelu_erf(float s) {
  return 0.5f * s * (1.0f + erff(s * 0.70710678118654752440f));
}

// ---------------------------------------------------------------- bfloat16
constexpr int LDS = BKS + 8;   // bf16 row stride: 80 bytes, keeps 32-byte fragment alignment
constexpr int LDC = BN + 4;    // f32 accumulator tile stride

__global__ void __launch_bounds__(128)
dense_gelu_bf16_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                       const __nv_bfloat16* __restrict__ bias, __nv_bfloat16* __restrict__ out,
                       int M, int N, int K) {
  using namespace nvcuda;
  __shared__ __align__(128) __nv_bfloat16 As[BM * LDS];
  __shared__ __align__(128) __nv_bfloat16 Bs[BN * LDS];
  __shared__ __align__(128) float Cs[BM * LDC];

  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int warp = threadIdx.x >> 5;
  const int wm = warp >> 1, wn = warp & 1;
  const __nv_bfloat16 zero = __float2bfloat16(0.f);

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
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> b[2];
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
      const float s = Cs[r * LDC + cc] + __bfloat162float(bias[gn]);
      out[(long long)gm * N + gn] = __float2bfloat16(gelu_erf(s));
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

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. x (M, K), w (N, K), bias (N), out (M, N),
// all contiguous and of one dtype. Returns cudaGetLastError().
extern "C" int mxtt_dense_gelu(int dtype, const void* x, const void* w, const void* bias,
                               void* out, int M, int N, int K, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  if (dtype == 0) {
    dense_gelu_f32_kernel<<<grid, 256, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<const float*>(bias), static_cast<float*>(out), M, N, K);
  } else if (dtype == 1) {
    dense_gelu_bf16_kernel<<<grid, 128, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
        static_cast<const __nv_bfloat16*>(bias), static_cast<__nv_bfloat16*>(out), M, N, K);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
