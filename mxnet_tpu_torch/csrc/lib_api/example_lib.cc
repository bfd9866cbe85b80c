/* Example external operator library (analog of the reference's
 * example/extensions/lib_custom_op): builds against mxtpu_lib_api.h only.
 *
 *   my_relu   — elementwise max(x, 0), any supported dtype
 *   my_gemm   — (M,K)x(K,N) float32 matmul
 *   my_split2 — splits (N, 2C) into two (N, C) halves (multi-output)
 */
#include <cstring>
#include <string>

#include "mxtpu_lib_api.h"

namespace {

std::string g_err;

struct OpDef {
  const char* name;
  int n_out;
};

const OpDef kOps[] = {
    {"my_relu", 1},
    {"my_gemm", 1},
    {"my_split2", 2},
};
const int kNumOps = sizeof(kOps) / sizeof(kOps[0]);

int fail(const std::string& msg) {
  g_err = msg;
  return 1;
}

int64_t numel(const MXTPUTensor& t) {
  int64_t n = 1;
  for (int i = 0; i < t.ndim; ++i) n *= t.shape[i];
  return n;
}

int dtype_size(int dtype) {
  switch (dtype) {
    case kMXTPUFloat64: case kMXTPUInt64: return 8;
    case kMXTPUFloat32: case kMXTPUInt32: return 4;
    case kMXTPUFloat16: return 2;
    case kMXTPUUint8: case kMXTPUInt8: return 1;
    default: return -1;
  }
}

template <typename T>
void relu(const T* in, T* out, int64_t n) {
  for (int64_t i = 0; i < n; ++i) out[i] = in[i] > T(0) ? in[i] : T(0);
}

}  // namespace

extern "C" {

int MXTPULibVersion(void) { return MXTPU_LIB_API_VERSION; }

int MXTPULibOpCount(void) { return kNumOps; }

const char* MXTPULibOpName(int idx) {
  return (idx >= 0 && idx < kNumOps) ? kOps[idx].name : nullptr;
}

int MXTPULibOpNumOutputs(int idx) {
  return (idx >= 0 && idx < kNumOps) ? kOps[idx].n_out : -1;
}

const char* MXTPULibLastError(void) { return g_err.c_str(); }

int MXTPULibOpInferShape(int idx, const MXTPUTensor* ins, int n_in,
                         MXTPUTensor* outs, int n_out) {
  switch (idx) {
    case 0:  /* my_relu: shape/dtype pass-through */
      if (n_in != 1 || n_out != 1) return fail("my_relu: arity");
      outs[0].ndim = ins[0].ndim;
      std::memcpy(outs[0].shape, ins[0].shape, sizeof(ins[0].shape));
      outs[0].dtype = ins[0].dtype;
      return 0;
    case 1:  /* my_gemm: (M,K)x(K,N) -> (M,N) */
      if (n_in != 2 || n_out != 1) return fail("my_gemm: arity");
      if (ins[0].ndim != 2 || ins[1].ndim != 2 ||
          ins[0].shape[1] != ins[1].shape[0])
        return fail("my_gemm: need (M,K)x(K,N)");
      if (ins[0].dtype != kMXTPUFloat32 || ins[1].dtype != kMXTPUFloat32)
        return fail("my_gemm: float32 only");
      outs[0].ndim = 2;
      outs[0].shape[0] = ins[0].shape[0];
      outs[0].shape[1] = ins[1].shape[1];
      outs[0].dtype = kMXTPUFloat32;
      return 0;
    case 2:  /* my_split2: (N, 2C) -> 2x (N, C) */
      if (n_in != 1 || n_out != 2) return fail("my_split2: arity");
      if (ins[0].ndim != 2 || ins[0].shape[1] % 2 != 0)
        return fail("my_split2: need (N, even)");
      for (int o = 0; o < 2; ++o) {
        outs[o].ndim = 2;
        outs[o].shape[0] = ins[0].shape[0];
        outs[o].shape[1] = ins[0].shape[1] / 2;
        outs[o].dtype = ins[0].dtype;
      }
      return 0;
    default:
      return fail("bad op index");
  }
}

int MXTPULibOpCompute(int idx, const MXTPUTensor* ins, int n_in,
                      MXTPUTensor* outs, int n_out) {
  switch (idx) {
    case 0: {
      const int64_t n = numel(ins[0]);
      switch (ins[0].dtype) {
        case kMXTPUFloat32:
          relu(static_cast<const float*>(ins[0].data),
               static_cast<float*>(outs[0].data), n);
          return 0;
        case kMXTPUFloat64:
          relu(static_cast<const double*>(ins[0].data),
               static_cast<double*>(outs[0].data), n);
          return 0;
        case kMXTPUInt32:
          relu(static_cast<const int32_t*>(ins[0].data),
               static_cast<int32_t*>(outs[0].data), n);
          return 0;
        default:
          return fail("my_relu: unsupported dtype");
      }
    }
    case 1: {
      const int64_t M = ins[0].shape[0], K = ins[0].shape[1],
                    N = ins[1].shape[1];
      const float* a = static_cast<const float*>(ins[0].data);
      const float* b = static_cast<const float*>(ins[1].data);
      float* c = static_cast<float*>(outs[0].data);
      for (int64_t i = 0; i < M; ++i)
        for (int64_t j = 0; j < N; ++j) {
          float acc = 0.f;
          for (int64_t k = 0; k < K; ++k) acc += a[i * K + k] * b[k * N + j];
          c[i * N + j] = acc;
        }
      return 0;
    }
    case 2: {
      const int64_t N = ins[0].shape[0], C2 = ins[0].shape[1];
      const int64_t C = C2 / 2;
      const int esize = dtype_size(ins[0].dtype);
      if (esize < 0) return fail("my_split2: unsupported dtype");
      const char* src = static_cast<const char*>(ins[0].data);
      for (int o = 0; o < 2; ++o) {
        char* dst = static_cast<char*>(outs[o].data);
        for (int64_t i = 0; i < N; ++i)
          std::memcpy(dst + i * C * esize,
                      src + (i * C2 + o * C) * esize, C * esize);
      }
      return 0;
    }
    default:
      return fail("bad op index");
  }
}

}  /* extern "C" */
