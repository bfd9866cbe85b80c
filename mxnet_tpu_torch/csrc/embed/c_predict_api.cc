// C predict API implementation — embeds CPython and drives
// mxnet_tpu_torch._predict_embed (ref: src/c_api/c_predict_api.cc).
//
// Built without libpython: loaded into a Python process (ctypes) it
// resolves the running interpreter's symbols; a standalone program links
// libpython itself.
//
// Thread-model: every entry point takes the GIL via PyGILState_Ensure, so
// the library works both inside an existing Python process (ctypes/pybind
// hosts) and from a standalone C program (lazy Py_InitializeEx).

#include "c_predict_api.h"

#include <Python.h>

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
      else PyErr_Clear();  // non-UTF8-representable error text
      Py_DECREF(s);
    }
  }
  Py_XDECREF(type);
  Py_XDECREF(value);
  Py_XDECREF(tb);
  set_error(msg);
}

struct Predictor {
  PyObject *py_predictor = nullptr;          // _predict_embed.Predictor
  std::vector<std::vector<unsigned>> out_shapes;  // filled by GetOutputShape
};

std::once_flag g_init_flag;

void ensure_python() {
  std::call_once(g_init_flag, []() {
    if (!Py_IsInitialized()) {
      Py_InitializeEx(0);
      // release the GIL acquired by Py_InitializeEx so PyGILState_Ensure
      // works uniformly below
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
    mod = PyImport_ImportModule("mxnet_tpu_torch._predict_embed");
  }
  return mod;
}

}  // namespace

extern "C" {

const char *MXGetLastError(void) { return g_last_error.c_str(); }

int MXPredCreate(const char *symbol_json_str, const void *param_bytes,
                 int param_size, int dev_type, int dev_id,
                 unsigned num_input_nodes, const char **input_keys,
                 const unsigned *input_shape_indptr,
                 const unsigned *input_shape_data, PredictorHandle *out) {
  ensure_python();
  GIL gil;
  PyObject *mod = embed_module();
  if (mod == nullptr) {
    set_error_from_python();
    return -1;
  }
  PyObject *keys = PyList_New(num_input_nodes);
  PyObject *shapes = PyList_New(num_input_nodes);
  for (unsigned i = 0; i < num_input_nodes; ++i) {
    PyList_SetItem(keys, i, PyUnicode_FromString(input_keys[i]));
    unsigned lo = input_shape_indptr[i], hi = input_shape_indptr[i + 1];
    PyObject *shape = PyTuple_New(hi - lo);
    for (unsigned j = lo; j < hi; ++j) {
      PyTuple_SetItem(shape, j - lo, PyLong_FromUnsignedLong(
          input_shape_data[j]));
    }
    PyList_SetItem(shapes, i, shape);
  }
  PyObject *params = PyBytes_FromStringAndSize(
      static_cast<const char *>(param_bytes), param_size);
  PyObject *res = PyObject_CallMethod(
      mod, "create", "sOOOii", symbol_json_str, params, keys, shapes,
      dev_type, dev_id);
  Py_DECREF(params);
  Py_DECREF(keys);
  Py_DECREF(shapes);
  if (res == nullptr) {
    set_error_from_python();
    return -1;
  }
  Predictor *p = new Predictor();
  p->py_predictor = res;
  *out = p;
  return 0;
}

int MXPredSetInput(PredictorHandle handle, const char *key, const float *data,
                   unsigned size) {
  GIL gil;
  Predictor *p = static_cast<Predictor *>(handle);
  PyObject *buf = PyBytes_FromStringAndSize(
      reinterpret_cast<const char *>(data),
      static_cast<Py_ssize_t>(size) * sizeof(float));
  PyObject *res = PyObject_CallMethod(p->py_predictor, "set_input", "sO",
                                      key, buf);
  Py_DECREF(buf);
  if (res == nullptr) {
    set_error_from_python();
    return -1;
  }
  Py_DECREF(res);
  return 0;
}

int MXPredForward(PredictorHandle handle) {
  GIL gil;
  Predictor *p = static_cast<Predictor *>(handle);
  PyObject *res = PyObject_CallMethod(p->py_predictor, "forward", nullptr);
  if (res == nullptr) {
    set_error_from_python();
    return -1;
  }
  Py_DECREF(res);
  return 0;
}

int MXPredGetOutputShape(PredictorHandle handle, unsigned index,
                         unsigned **shape_data, unsigned *shape_ndim) {
  GIL gil;
  Predictor *p = static_cast<Predictor *>(handle);
  PyObject *res = PyObject_CallMethod(p->py_predictor, "output_shape", "I",
                                      index);
  if (res == nullptr) {
    set_error_from_python();
    return -1;
  }
  Py_ssize_t n = PyTuple_Size(res);
  if (p->out_shapes.size() <= index) p->out_shapes.resize(index + 1);
  auto &dims = p->out_shapes[index];
  dims.resize(n);
  for (Py_ssize_t i = 0; i < n; ++i) {
    dims[i] = static_cast<unsigned>(
        PyLong_AsUnsignedLong(PyTuple_GetItem(res, i)));
  }
  Py_DECREF(res);
  *shape_data = dims.data();
  *shape_ndim = static_cast<unsigned>(n);
  return 0;
}

int MXPredGetOutput(PredictorHandle handle, unsigned index, float *data,
                    unsigned size) {
  GIL gil;
  Predictor *p = static_cast<Predictor *>(handle);
  PyObject *res = PyObject_CallMethod(p->py_predictor, "output_bytes", "I",
                                      index);
  if (res == nullptr) {
    set_error_from_python();
    return -1;
  }
  char *buf = nullptr;
  Py_ssize_t len = 0;
  if (PyBytes_AsStringAndSize(res, &buf, &len) != 0) {
    Py_DECREF(res);
    set_error_from_python();
    return -1;
  }
  if (static_cast<Py_ssize_t>(size) * sizeof(float) <
      static_cast<size_t>(len)) {
    Py_DECREF(res);
    set_error("MXPredGetOutput: buffer too small");
    return -1;
  }
  memcpy(data, buf, len);
  Py_DECREF(res);
  return 0;
}

int MXPredFree(PredictorHandle handle) {
  GIL gil;
  Predictor *p = static_cast<Predictor *>(handle);
  Py_XDECREF(p->py_predictor);
  delete p;
  return 0;
}

}  // extern "C"
