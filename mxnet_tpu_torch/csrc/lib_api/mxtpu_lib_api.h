/* MXTPU external operator library ABI (the port's copy; the
 * declarations are the JAX package's, so one library loads into both).
 *
 * The runtime op-library interface (ref: include/mxnet/lib_api.h:626
 * REGISTER_OP and the MXLoadLib C API): a shared object built against
 * ONLY this header can be loaded at runtime with
 * `mxnet_tpu_torch.library.load("libfoo.so")` — no framework recompile.
 * Loaded ops register into the op registry; their compute runs on the
 * host (a device tensor is copied there and back), with shapes/dtypes
 * resolved through MXTPULibOpInferShape.
 *
 * ABI rules: plain C, no callbacks across the boundary; the framework
 * drives everything through the five exported functions below. Tensors
 * are dense, row-major, host memory. dtype codes match the framework's
 * (and the reference's) NDArray type codes.
 */
#ifndef MXTPU_LIB_API_H_
#define MXTPU_LIB_API_H_

#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

#define MXTPU_LIB_API_VERSION 1
#define MXTPU_MAX_NDIM 8

/* NDArray dtype codes (parity with the reference's mshadow type flags) */
enum MXTPUDType {
  kMXTPUFloat32 = 0,
  kMXTPUFloat64 = 1,
  kMXTPUFloat16 = 2,
  kMXTPUUint8 = 3,
  kMXTPUInt32 = 4,
  kMXTPUInt8 = 5,
  kMXTPUInt64 = 6,
};

typedef struct {
  void* data;                   /* host pointer; NULL during shape infer */
  int64_t shape[MXTPU_MAX_NDIM];
  int32_t ndim;
  int32_t dtype;                /* MXTPUDType */
} MXTPUTensor;

/* A conforming library exports these five symbols.
 * All int-returning entry points: 0 = success, nonzero = failure
 * (use MXTPULibLastError for the message, may return NULL). */

/* ABI version — must equal MXTPU_LIB_API_VERSION. */
int MXTPULibVersion(void);

/* Number of operators provided. */
int MXTPULibOpCount(void);

/* Name of operator `idx` (static storage). */
const char* MXTPULibOpName(int idx);

/* Number of outputs of operator `idx`. */
int MXTPULibOpNumOutputs(int idx);

/* Fill outs[i].shape/ndim/dtype from the input shapes/dtypes.
 * ins[i].data is NULL here (trace time). */
int MXTPULibOpInferShape(int idx, const MXTPUTensor* ins, int n_in,
                         MXTPUTensor* outs, int n_out);

/* Run the operator on host buffers. outs are pre-allocated per the
 * shapes produced by MXTPULibOpInferShape. */
int MXTPULibOpCompute(int idx, const MXTPUTensor* ins, int n_in,
                      MXTPUTensor* outs, int n_out);

/* Optional: last error message (static storage), or NULL. */
const char* MXTPULibLastError(void);

#ifdef __cplusplus
}
#endif

#endif  /* MXTPU_LIB_API_H_ */
