// C training API implementation — embeds CPython and drives
// mxnet_tpu_torch._train_embed (see c_api_train.h for the contract; ref:
// src/c_api/c_api.cc autograd/cachedop/kvstore groups).
//
// Built without libpython: loaded into a Python process (ctypes) it
// resolves the running interpreter's symbols; a standalone program links
// libpython itself.
//
// Thread-model identical to the predict lib: every entry point takes
// the GIL via PyGILState_Ensure, so it works both inside an existing
// Python process (ctypes hosts) and from a standalone C program (lazy
// Py_InitializeEx).

#include "c_api_train.h"

#include <Python.h>

#include <cstring>
#include <mutex>
#include <string>
#include <vector>

namespace {

thread_local std::string g_last_error;

void set_error(const std::string &msg) { g_last_error = msg; }

void set_error_from_python() {
  PyObject *type = nullptr, *value = nullptr, *tb = nullptr;
  PyErr_Fetch(&type, &value, &tb);
  PyErr_NormalizeException(&type, &value, &tb);
  std::string msg = "python error";
  if (value) {
    PyObject *s = PyObject_Str(value);
    if (s) {
      const char *utf8 = PyUnicode_AsUTF8(s);
      if (utf8) msg = utf8;
      else PyErr_Clear();
      Py_DECREF(s);
    }
  }
  Py_XDECREF(type);
  Py_XDECREF(value);
  Py_XDECREF(tb);
  set_error(msg);
}

std::once_flag g_init_flag;

void ensure_python() {
  std::call_once(g_init_flag, []() {
    if (!Py_IsInitialized()) {
      Py_InitializeEx(0);
      PyEval_SaveThread();
    }
  });
}

class GIL {
 public:
  GIL() { state_ = PyGILState_Ensure(); }
  ~GIL() { PyGILState_Release(state_); }

 private:
  PyGILState_STATE state_;
};

PyObject *embed_module() {
  static PyObject *mod = nullptr;
  if (mod == nullptr) {
    mod = PyImport_ImportModule("mxnet_tpu_torch._train_embed");
  }
  return mod;
}

// Handles are owned PyObject references; a Symbol handle additionally
// owns the C-string block ListInputs may have handed out.
struct SymbolBox {
  PyObject *obj = nullptr;
  std::vector<std::string> input_names;
  std::vector<const char *> input_ptrs;
};

PyObject *as_py(NDArrayHandle h) { return static_cast<PyObject *>(h); }

PyObject *handle_list(uint32_t n, NDArrayHandle *hs) {
  PyObject *lst = PyList_New(n);
  for (uint32_t i = 0; i < n; ++i) {
    PyObject *o = as_py(hs[i]);
    Py_INCREF(o);
    PyList_SetItem(lst, i, o);
  }
  return lst;
}

// Unpack a python list of NDArrays into caller-provided handle slots
// (each slot becomes an owned reference the caller frees with
// MXTrainNDArrayFree).
int unpack_outputs(PyObject *res, uint32_t *num_outputs,
                   NDArrayHandle *outputs, uint32_t max_outputs) {
  if (!PyList_Check(res)) {
    set_error("embed call did not return a list");
    return -1;
  }
  Py_ssize_t n = PyList_Size(res);
  if (static_cast<uint32_t>(n) > max_outputs) {
    set_error("output buffer too small: need " + std::to_string(n) +
              " slots, got " + std::to_string(max_outputs));
    return -1;
  }
  for (Py_ssize_t i = 0; i < n; ++i) {
    PyObject *o = PyList_GetItem(res, i);
    Py_INCREF(o);
    outputs[i] = o;
  }
  *num_outputs = static_cast<uint32_t>(n);
  return 0;
}

}  // namespace

extern "C" {

const char *MXTrainGetLastError(void) { return g_last_error.c_str(); }

/* ---------------- NDArray ---------------- */

int MXTrainNDArrayCreate(const uint32_t *shape, uint32_t ndim, int dtype,
                         NDArrayHandle *out) {
  ensure_python();
  GIL gil;
  PyObject *mod = embed_module();
  if (!mod) { set_error_from_python(); return -1; }
  PyObject *shp = PyTuple_New(ndim);
  for (uint32_t i = 0; i < ndim; ++i)
    PyTuple_SetItem(shp, i, PyLong_FromUnsignedLong(shape[i]));
  PyObject *res = PyObject_CallMethod(mod, "create_ndarray", "Oi", shp,
                                      dtype);
  Py_DECREF(shp);
  if (!res) { set_error_from_python(); return -1; }
  *out = res;
  return 0;
}

int MXTrainNDArrayFree(NDArrayHandle h) {
  if (!h) return 0;
  GIL gil;
  Py_DECREF(as_py(h));
  return 0;
}

int MXTrainNDArraySyncCopyFromCPU(NDArrayHandle h, const void *data,
                                  size_t nbytes) {
  GIL gil;
  PyObject *mod = embed_module();
  PyObject *buf = PyBytes_FromStringAndSize(
      static_cast<const char *>(data), static_cast<Py_ssize_t>(nbytes));
  PyObject *res = PyObject_CallMethod(mod, "copy_from_bytes", "OO",
                                      as_py(h), buf);
  Py_DECREF(buf);
  if (!res) { set_error_from_python(); return -1; }
  Py_DECREF(res);
  return 0;
}

int MXTrainNDArraySyncCopyToCPU(NDArrayHandle h, void *data, size_t nbytes) {
  GIL gil;
  PyObject *mod = embed_module();
  PyObject *arr = PyObject_CallMethod(mod, "copy_to_numpy", "O", as_py(h));
  if (!arr) { set_error_from_python(); return -1; }
  PyObject *bytes = PyObject_CallMethod(arr, "tobytes", nullptr);
  Py_DECREF(arr);
  if (!bytes) { set_error_from_python(); return -1; }
  char *src = nullptr;
  Py_ssize_t len = 0;
  PyBytes_AsStringAndSize(bytes, &src, &len);
  if (static_cast<size_t>(len) != nbytes) {
    Py_DECREF(bytes);
    set_error("size mismatch: array holds " + std::to_string(len) +
              " bytes, caller buffer is " + std::to_string(nbytes) +
              " (dtype or shape disagreement)");
    return -1;
  }
  memcpy(data, src, static_cast<size_t>(len));
  Py_DECREF(bytes);
  return 0;
}

int MXTrainNDArrayGetShape(NDArrayHandle h, uint32_t *out_ndim,
                           uint32_t *out_shape) {
  GIL gil;
  PyObject *mod = embed_module();
  PyObject *shp = PyObject_CallMethod(mod, "get_shape", "O", as_py(h));
  if (!shp) { set_error_from_python(); return -1; }
  Py_ssize_t n = PyTuple_Size(shp);
  if (n > 8) {
    Py_DECREF(shp);
    set_error("ndim " + std::to_string(n) +
              " exceeds the 8-slot shape buffer contract");
    return -1;
  }
  *out_ndim = static_cast<uint32_t>(n);
  for (Py_ssize_t i = 0; i < n; ++i)
    out_shape[i] = static_cast<uint32_t>(
        PyLong_AsUnsignedLong(PyTuple_GetItem(shp, i)));
  Py_DECREF(shp);
  return 0;
}

/* ---------------- imperative invoke ---------------- */

int MXTrainImperativeInvoke(const char *op_name, uint32_t num_inputs,
                            NDArrayHandle *inputs, uint32_t *num_outputs,
                            NDArrayHandle *outputs, uint32_t max_outputs,
                            uint32_t num_params, const char **param_keys,
                            const char **param_vals) {
  ensure_python();
  GIL gil;
  PyObject *mod = embed_module();
  if (!mod) { set_error_from_python(); return -1; }
  PyObject *ins = handle_list(num_inputs, inputs);
  PyObject *keys = PyList_New(num_params);
  PyObject *vals = PyList_New(num_params);
  for (uint32_t i = 0; i < num_params; ++i) {
    PyList_SetItem(keys, i, PyUnicode_FromString(param_keys[i]));
    PyList_SetItem(vals, i, PyUnicode_FromString(param_vals[i]));
  }
  PyObject *res = PyObject_CallMethod(mod, "imperative_invoke", "sOOO",
                                      op_name, ins, keys, vals);
  Py_DECREF(ins);
  Py_DECREF(keys);
  Py_DECREF(vals);
  if (!res) { set_error_from_python(); return -1; }
  int rc = unpack_outputs(res, num_outputs, outputs, max_outputs);
  Py_DECREF(res);
  return rc;
}

/* ---------------- autograd ---------------- */

int MXTrainAutogradSetIsRecording(int is_recording, int *prev) {
  ensure_python();
  GIL gil;
  PyObject *mod = embed_module();
  PyObject *res = PyObject_CallMethod(mod, "set_recording", "i",
                                      is_recording);
  if (!res) { set_error_from_python(); return -1; }
  if (prev) *prev = static_cast<int>(PyLong_AsLong(res));
  Py_DECREF(res);
  return 0;
}

int MXTrainAutogradSetIsTraining(int is_training, int *prev) {
  ensure_python();
  GIL gil;
  PyObject *mod = embed_module();
  PyObject *res = PyObject_CallMethod(mod, "set_training", "i",
                                      is_training);
  if (!res) { set_error_from_python(); return -1; }
  if (prev) *prev = static_cast<int>(PyLong_AsLong(res));
  Py_DECREF(res);
  return 0;
}

int MXTrainAutogradMarkVariables(uint32_t num, NDArrayHandle *vars,
                                 const uint32_t *grad_reqs,
                                 NDArrayHandle *grads) {
  GIL gil;
  PyObject *mod = embed_module();
  PyObject *vs = handle_list(num, vars);
  PyObject *gs = handle_list(num, grads);
  PyObject *reqs = PyList_New(num);
  for (uint32_t i = 0; i < num; ++i)
    PyList_SetItem(reqs, i, PyLong_FromUnsignedLong(
        grad_reqs ? grad_reqs[i] : 1));
  PyObject *res = PyObject_CallMethod(mod, "mark_variables", "OOO", vs,
                                      reqs, gs);
  Py_DECREF(vs);
  Py_DECREF(gs);
  Py_DECREF(reqs);
  if (!res) { set_error_from_python(); return -1; }
  Py_DECREF(res);
  return 0;
}

int MXTrainAutogradBackward(uint32_t num_outputs, NDArrayHandle *outputs,
                            NDArrayHandle *out_grads, int retain_graph) {
  GIL gil;
  PyObject *mod = embed_module();
  PyObject *outs = handle_list(num_outputs, outputs);
  PyObject *ogs = out_grads ? handle_list(num_outputs, out_grads)
                            : (Py_INCREF(Py_None), Py_None);
  PyObject *res = PyObject_CallMethod(mod, "backward", "OOi", outs, ogs,
                                      retain_graph);
  Py_DECREF(outs);
  Py_DECREF(ogs);
  if (!res) { set_error_from_python(); return -1; }
  Py_DECREF(res);
  return 0;
}

int MXTrainNDArrayGetGrad(NDArrayHandle h, NDArrayHandle *out) {
  GIL gil;
  PyObject *mod = embed_module();
  PyObject *res = PyObject_CallMethod(mod, "get_grad", "O", as_py(h));
  if (!res) { set_error_from_python(); return -1; }
  if (res == Py_None) {
    Py_DECREF(res);
    set_error("array has no gradient (not marked / backward not run)");
    return -1;
  }
  *out = res;
  return 0;
}

/* ---------------- symbol + CachedOp ---------------- */

int MXTrainSymbolCreateFromJSON(const char *json, SymbolHandle *out) {
  ensure_python();
  GIL gil;
  PyObject *mod = embed_module();
  if (!mod) { set_error_from_python(); return -1; }
  PyObject *res = PyObject_CallMethod(mod, "symbol_from_json", "s", json);
  if (!res) { set_error_from_python(); return -1; }
  SymbolBox *box = new SymbolBox();
  box->obj = res;
  *out = box;
  return 0;
}

int MXTrainSymbolFree(SymbolHandle h) {
  if (!h) return 0;
  GIL gil;
  SymbolBox *box = static_cast<SymbolBox *>(h);
  Py_XDECREF(box->obj);
  delete box;
  return 0;
}

int MXTrainSymbolGetNumOutputs(SymbolHandle h, uint32_t *out) {
  GIL gil;
  PyObject *mod = embed_module();
  SymbolBox *box = static_cast<SymbolBox *>(h);
  PyObject *res = PyObject_CallMethod(mod, "symbol_num_outputs", "O",
                                      box->obj);
  if (!res) { set_error_from_python(); return -1; }
  *out = static_cast<uint32_t>(PyLong_AsUnsignedLong(res));
  Py_DECREF(res);
  return 0;
}

int MXTrainSymbolListInputs(SymbolHandle h, uint32_t *num,
                            const char ***out_names) {
  GIL gil;
  PyObject *mod = embed_module();
  SymbolBox *box = static_cast<SymbolBox *>(h);
  PyObject *res = PyObject_CallMethod(mod, "symbol_list_inputs", "O",
                                      box->obj);
  if (!res) { set_error_from_python(); return -1; }
  Py_ssize_t n = PySequence_Size(res);
  box->input_names.clear();
  box->input_ptrs.clear();
  for (Py_ssize_t i = 0; i < n; ++i) {
    PyObject *item = PySequence_GetItem(res, i);
    const char *s = PyUnicode_AsUTF8(item);
    box->input_names.emplace_back(s ? s : "");
    Py_DECREF(item);
  }
  Py_DECREF(res);
  for (auto &s : box->input_names) box->input_ptrs.push_back(s.c_str());
  *num = static_cast<uint32_t>(n);
  *out_names = box->input_ptrs.data();
  return 0;
}

int MXTrainCreateCachedOp(SymbolHandle sym, CachedOpHandle *out) {
  GIL gil;
  PyObject *mod = embed_module();
  SymbolBox *box = static_cast<SymbolBox *>(sym);
  PyObject *res = PyObject_CallMethod(mod, "create_cached_op", "O",
                                      box->obj);
  if (!res) { set_error_from_python(); return -1; }
  *out = res;
  return 0;
}

int MXTrainFreeCachedOp(CachedOpHandle h) {
  if (!h) return 0;
  GIL gil;
  Py_DECREF(as_py(h));
  return 0;
}

int MXTrainInvokeCachedOp(CachedOpHandle h, uint32_t num_inputs,
                          NDArrayHandle *inputs, uint32_t *num_outputs,
                          NDArrayHandle *outputs, uint32_t max_outputs) {
  GIL gil;
  PyObject *mod = embed_module();
  PyObject *ins = handle_list(num_inputs, inputs);
  PyObject *res = PyObject_CallMethod(mod, "invoke_cached_op", "OO",
                                      as_py(h), ins);
  Py_DECREF(ins);
  if (!res) { set_error_from_python(); return -1; }
  int rc = unpack_outputs(res, num_outputs, outputs, max_outputs);
  Py_DECREF(res);
  return rc;
}

/* ---------------- KVStore ---------------- */

int MXTrainKVStoreCreate(const char *type, KVStoreHandle *out) {
  ensure_python();
  GIL gil;
  PyObject *mod = embed_module();
  if (!mod) { set_error_from_python(); return -1; }
  PyObject *res = PyObject_CallMethod(mod, "kvstore_create", "s", type);
  if (!res) { set_error_from_python(); return -1; }
  *out = res;
  return 0;
}

int MXTrainKVStoreFree(KVStoreHandle h) {
  if (!h) return 0;
  GIL gil;
  Py_DECREF(as_py(h));
  return 0;
}

namespace {
int kv_call(const char *method, KVStoreHandle h, uint32_t num,
            const int *keys, NDArrayHandle *vals, int priority,
            bool with_priority) {
  GIL gil;
  PyObject *mod = embed_module();
  PyObject *ks = PyList_New(num);
  for (uint32_t i = 0; i < num; ++i)
    PyList_SetItem(ks, i, PyLong_FromLong(keys[i]));
  PyObject *vs = handle_list(num, vals);
  PyObject *res = with_priority
      ? PyObject_CallMethod(mod, method, "OOOi", as_py(h), ks, vs,
                            priority)
      : PyObject_CallMethod(mod, method, "OOO", as_py(h), ks, vs);
  Py_DECREF(ks);
  Py_DECREF(vs);
  if (!res) { set_error_from_python(); return -1; }
  Py_DECREF(res);
  return 0;
}
}  // namespace

int MXTrainKVStoreInit(KVStoreHandle h, uint32_t num, const int *keys,
                       NDArrayHandle *vals) {
  return kv_call("kvstore_init", h, num, keys, vals, 0, false);
}

int MXTrainKVStorePush(KVStoreHandle h, uint32_t num, const int *keys,
                       NDArrayHandle *vals, int priority) {
  return kv_call("kvstore_push", h, num, keys, vals, priority, true);
}

int MXTrainKVStorePull(KVStoreHandle h, uint32_t num, const int *keys,
                       NDArrayHandle *outs, int priority) {
  return kv_call("kvstore_pull", h, num, keys, outs, priority, true);
}

}  // extern "C"
