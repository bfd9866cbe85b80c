/*
 * C predict API of mxnet_tpu_torch — native deployment surface
 * (ref: include/mxnet/c_predict_api.h). The same declarations as the JAX
 * package's src/predict/c_predict_api.h.
 *
 * A C/C++ application links libmxtpu_torch_predict (built by
 * mxnet_tpu_torch/_capi.py), loads a model exported by HybridBlock.export
 * (symbol JSON + params file bytes), and runs inference. The
 * implementation embeds CPython and drives mxnet_tpu_torch._predict_embed:
 * the same SymbolBlock forward, and the same kernels, as the Python
 * frontend.
 */
#ifndef MXTPU_C_PREDICT_API_H_
#define MXTPU_C_PREDICT_API_H_

#ifdef __cplusplus
extern "C" {
#endif

typedef void *PredictorHandle;

/* All functions return 0 on success, -1 on failure (see MXGetLastError). */

/* Create a predictor.
 * symbol_json_str : contents of the *-symbol.json file
 * param_bytes/param_size : contents of the *-0000.params file
 * dev_type : 1 = cpu, 2 = gpu (CUDA device dev_id; fails when there is
 *            no such card); any other code fails  (ref: c_predict_api.h)
 * num_input_nodes / input_keys : graph input names (e.g. {"data"})
 * input_shape_indptr / input_shape_data : CSR-packed input shapes
 */
int MXPredCreate(const char *symbol_json_str, const void *param_bytes,
                 int param_size, int dev_type, int dev_id,
                 unsigned num_input_nodes, const char **input_keys,
                 const unsigned *input_shape_indptr,
                 const unsigned *input_shape_data, PredictorHandle *out);

int MXPredSetInput(PredictorHandle handle, const char *key,
                   const float *data, unsigned size);

int MXPredForward(PredictorHandle handle);

int MXPredGetOutputShape(PredictorHandle handle, unsigned index,
                         unsigned **shape_data, unsigned *shape_ndim);

int MXPredGetOutput(PredictorHandle handle, unsigned index, float *data,
                    unsigned size);

int MXPredFree(PredictorHandle handle);

const char *MXGetLastError(void);

#ifdef __cplusplus
}
#endif

#endif  /* MXTPU_C_PREDICT_API_H_ */
