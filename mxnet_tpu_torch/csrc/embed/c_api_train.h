/*
 * C TRAINING API of mxnet_tpu_torch (the same declarations as the JAX
 * package's src/train/c_api_train.h) — the reference c_api.h groups a C
 * embedder needs to
 * train: NDArray create/copy, imperative op invocation, autograd
 * record/mark/backward, CachedOp over a symbol JSON, and KVStore
 * init/push/pull (ref: include/mxnet/c_api.h:1251 MXAutogradBackwardEx,
 * :1341 MXInvokeCachedOpEx, :1405 MXImperativeInvokeEx, :2670
 * MXKVStorePush).
 *
 * Implementation embeds CPython and drives mxnet_tpu_torch._train_embed,
 * so C training runs the exact same registry/autograd/kvstore as the
 * Python frontend (the analog of the reference C API sitting on its C++
 * engine). NDArrays are made on the caller's current context: the card
 * unless a `with mx.cpu():` scope is open on the calling thread. Handles
 * are opaque; every function returns 0 on success,
 * -1 on failure with MXTrainGetLastError() describing the fault.
 *
 * NOTE: this library's NDArrayHandle wraps the runtime's live NDArray
 * (autograd-capable, device-backed). The separate NDArray library
 * (c_api_ndarray.cc) is the dependency-free offline file inspector; the
 * two do not mix.
 */
#ifndef MXTPU_C_API_TRAIN_H_
#define MXTPU_C_API_TRAIN_H_

#include <stddef.h>
#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

typedef void *NDArrayHandle;
typedef void *SymbolHandle;
typedef void *CachedOpHandle;
typedef void *KVStoreHandle;

const char *MXTrainGetLastError(void);

/* ---- NDArray ---- */
int MXTrainNDArrayCreate(const uint32_t *shape, uint32_t ndim, int dtype,
                         NDArrayHandle *out);
int MXTrainNDArrayFree(NDArrayHandle h);
int MXTrainNDArraySyncCopyFromCPU(NDArrayHandle h, const void *data,
                                  size_t nbytes);
int MXTrainNDArraySyncCopyToCPU(NDArrayHandle h, void *data, size_t nbytes);
int MXTrainNDArrayGetShape(NDArrayHandle h, uint32_t *out_ndim,
                           uint32_t *out_shape /* >= 8 slots */);

/* ---- imperative ops (any registered op or reference alias name) ---- */
int MXTrainImperativeInvoke(const char *op_name, uint32_t num_inputs,
                            NDArrayHandle *inputs, uint32_t *num_outputs,
                            NDArrayHandle *outputs /* caller buffer */,
                            uint32_t max_outputs, uint32_t num_params,
                            const char **param_keys,
                            const char **param_vals);

/* ---- autograd ---- */
int MXTrainAutogradSetIsRecording(int is_recording, int *prev);
int MXTrainAutogradSetIsTraining(int is_training, int *prev);
/* grad_reqs: 0 = null, 1 = write (per variable); grads are caller-made
 * NDArrays that receive the gradients */
int MXTrainAutogradMarkVariables(uint32_t num, NDArrayHandle *vars,
                                 const uint32_t *grad_reqs,
                                 NDArrayHandle *grads);
int MXTrainAutogradBackward(uint32_t num_outputs, NDArrayHandle *outputs,
                            NDArrayHandle *out_grads /* or NULL */,
                            int retain_graph);
int MXTrainNDArrayGetGrad(NDArrayHandle h, NDArrayHandle *out);

/* ---- symbol + CachedOp ---- */
int MXTrainSymbolCreateFromJSON(const char *json, SymbolHandle *out);
int MXTrainSymbolFree(SymbolHandle h);
int MXTrainSymbolGetNumOutputs(SymbolHandle h, uint32_t *out);
/* inputs bind positionally in list_inputs() order; call
 * MXTrainSymbolListInputs to discover it */
int MXTrainSymbolListInputs(SymbolHandle h, uint32_t *num,
                            const char ***out_names /* freed by lib on
                                                       symbol free */);
int MXTrainCreateCachedOp(SymbolHandle sym, CachedOpHandle *out);
int MXTrainFreeCachedOp(CachedOpHandle h);
int MXTrainInvokeCachedOp(CachedOpHandle h, uint32_t num_inputs,
                          NDArrayHandle *inputs, uint32_t *num_outputs,
                          NDArrayHandle *outputs /* caller buffer */,
                          uint32_t max_outputs);

/* ---- KVStore ---- */
int MXTrainKVStoreCreate(const char *type, KVStoreHandle *out);
int MXTrainKVStoreFree(KVStoreHandle h);
int MXTrainKVStoreInit(KVStoreHandle h, uint32_t num, const int *keys,
                       NDArrayHandle *vals);
int MXTrainKVStorePush(KVStoreHandle h, uint32_t num, const int *keys,
                       NDArrayHandle *vals, int priority);
int MXTrainKVStorePull(KVStoreHandle h, uint32_t num, const int *keys,
                       NDArrayHandle *outs, int priority);

#ifdef __cplusplus
}
#endif

#endif  /* MXTPU_C_API_TRAIN_H_ */
