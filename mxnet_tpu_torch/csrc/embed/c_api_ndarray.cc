/*
 * NDArray C API of mxnet_tpu_torch (ref: include/mxnet/c_api.h NDArray
 * block, src/c_api/c_api.cc MXNDArray*).
 *
 * A pure-C ABI over host tensors plus the dmlc-stream binary container
 * (ref: src/ndarray/ndarray.cc NDArray::Save/Load), byte-compatible with
 * the port's serializer (mxnet_tpu_torch/serialization.py), with the JAX
 * package's, and with files the reference ecosystem publishes. No Python,
 * no device runtime: this is the artifact/interchange layer a C/C++
 * application links to create, fill, save and load .params/.ndarray
 * blobs; compute stays with the predict API (c_predict_api.cc) or the
 * Python frontend.
 */
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

thread_local std::string g_last_error;

void set_error(const std::string &msg) { g_last_error = msg; }

void clear_error() { g_last_error.clear(); }

constexpr uint64_t kListMagic = 0x112;
constexpr uint32_t kV2Magic = 0xF993FAC9;
constexpr uint32_t kV3Magic = 0xF993FACA;

/* mshadow type flags (ref: mshadow/base.h:333-345) */
int dtype_size(int flag) {
  switch (flag) {
    case 0: return 4;   /* float32 */
    case 1: return 8;   /* float64 */
    case 2: return 2;   /* float16 */
    case 3: return 1;   /* uint8 */
    case 4: return 4;   /* int32 */
    case 5: return 1;   /* int8 */
    case 6: return 8;   /* int64 */
    case 7: return 1;   /* bool */
    case 8: return 2;   /* int16 */
    case 12: return 2;  /* bfloat16 */
    default: return -1;
  }
}

struct Tensor {
  std::vector<int64_t> shape;
  int dtype = 0;
  bool is_none = false;   /* "none array" list entry (np semantics) */
  std::vector<uint8_t> data;

  int64_t num_elems() const {
    int64_t n = 1;
    for (int64_t d : shape) n *= d;
    return n;
  }
  size_t nbytes() const {
    return static_cast<size_t>(num_elems()) * dtype_size(dtype);
  }
};

bool write_all(FILE *f, const void *p, size_t n) {
  return fwrite(p, 1, n, f) == n;
}

bool read_all(FILE *f, void *p, size_t n) {
  return fread(p, 1, n, f) == n;
}

bool write_tensor(FILE *f, const Tensor &t) {
  if (t.is_none) {
    uint32_t magic = kV3Magic;
    int32_t stype = 0, ndim = -1;
    return write_all(f, &magic, 4) && write_all(f, &stype, 4) &&
           write_all(f, &ndim, 4);
  }
  uint32_t magic = t.shape.empty() ? kV3Magic : kV2Magic;
  int32_t stype = 0, dev_type = 1, dev_id = 0;
  int32_t ndim = static_cast<int32_t>(t.shape.size());
  if (!write_all(f, &magic, 4) || !write_all(f, &stype, 4) ||
      !write_all(f, &ndim, 4))
    return false;
  for (int64_t d : t.shape)
    if (!write_all(f, &d, 8)) return false;
  int32_t flag = t.dtype;
  if (!write_all(f, &dev_type, 4) || !write_all(f, &dev_id, 4) ||
      !write_all(f, &flag, 4))
    return false;
  return write_all(f, t.data.data(), t.data.size());
}

constexpr int32_t kMaxNdim = 32;          /* reference caps shapes here */
constexpr int64_t kMaxElems = int64_t(1) << 40;

bool read_tensor(FILE *f, Tensor *t) {
  uint32_t magic;
  if (!read_all(f, &magic, 4)) return false;
  if (magic != kV2Magic && magic != kV3Magic) {
    set_error("unsupported NDArray magic (legacy V1/pre-V1 streams are "
              "handled by the python reader)");
    return false;
  }
  int32_t stype;
  if (!read_all(f, &stype, 4)) return false;
  if (stype != 0) {
    set_error("sparse payloads not supported by the C loader");
    return false;
  }
  int32_t ndim;
  if (!read_all(f, &ndim, 4)) return false;
  /* none-array entries: unknown shape under V3, empty shape under V2 —
   * the stream carries NO further fields for them (matches the python
   * reader, serialization.py read_ndarray, and NDArray::Load's early
   * return) */
  if (ndim < 0 || (magic == kV2Magic && ndim == 0)) {
    t->is_none = true;
    return true;
  }
  if (ndim > kMaxNdim) {
    set_error("corrupt NDArray stream: ndim " + std::to_string(ndim));
    return false;
  }
  t->shape.assign(ndim, 0);
  int64_t elems = 1;
  for (auto &d : t->shape) {
    if (!read_all(f, &d, 8)) return false;
    if (d < 0 || (d > 0 && elems > kMaxElems / d)) {
      set_error("corrupt NDArray stream: bad dimension " +
                std::to_string(d));
      return false;
    }
    elems *= d;
  }
  int32_t dev_type, dev_id, flag;
  if (!read_all(f, &dev_type, 4) || !read_all(f, &dev_id, 4) ||
      !read_all(f, &flag, 4))
    return false;
  if (dtype_size(flag) < 0) {
    set_error("unknown dtype flag " + std::to_string(flag));
    return false;
  }
  t->dtype = flag;
  t->data.assign(t->nbytes(), 0);
  return read_all(f, t->data.data(), t->data.size());
}

}  // namespace

extern "C" {

typedef void *NDArrayHandle;

const char *MXGetLastError() { return g_last_error.c_str(); }

int MXGetVersion(int *out) {
  *out = 20000;  /* 2.0.0 */
  return 0;
}

int MXNotifyShutdown() { return 0; }

int MXNDArrayCreate(const uint32_t *shape, uint32_t ndim, int dev_type,
                    int dev_id, int delay_alloc, int dtype,
                    NDArrayHandle *out) {
  clear_error();
  (void)dev_type; (void)dev_id; (void)delay_alloc;
  if (dtype_size(dtype) < 0) {
    set_error("unknown dtype flag " + std::to_string(dtype));
    return -1;
  }
  try {
    Tensor *t = new Tensor();
    t->dtype = dtype;
    t->shape.assign(shape, shape + ndim);
    t->data.assign(t->nbytes(), 0);
    *out = t;
    return 0;
  } catch (const std::exception &e) {
    set_error(std::string("allocation failed: ") + e.what());
    return -1;
  }
}

int MXNDArrayCreateEx(const uint32_t *shape, uint32_t ndim, int dev_type,
                      int dev_id, int delay_alloc, int dtype,
                      NDArrayHandle *out) {
  return MXNDArrayCreate(shape, ndim, dev_type, dev_id, delay_alloc,
                         dtype, out);
}

int MXNDArrayFree(NDArrayHandle handle) {
  delete static_cast<Tensor *>(handle);
  return 0;
}

int MXNDArrayGetShape(NDArrayHandle handle, uint32_t *out_dim,
                      const int64_t **out_pdata) {
  Tensor *t = static_cast<Tensor *>(handle);
  *out_dim = static_cast<uint32_t>(t->shape.size());
  *out_pdata = t->shape.data();
  return 0;
}

int MXNDArrayGetDType(NDArrayHandle handle, int *out) {
  *out = static_cast<Tensor *>(handle)->dtype;
  return 0;
}

int MXNDArrayGetData(NDArrayHandle handle, void **out) {
  *out = static_cast<Tensor *>(handle)->data.data();
  return 0;
}

int MXNDArraySyncCopyFromCPU(NDArrayHandle handle, const void *data,
                             size_t size) {
  clear_error();
  Tensor *t = static_cast<Tensor *>(handle);
  size_t bytes = size * dtype_size(t->dtype);
  if (bytes != t->data.size()) {
    set_error("size mismatch in SyncCopyFromCPU");
    return -1;
  }
  std::memcpy(t->data.data(), data, bytes);
  return 0;
}

int MXNDArraySyncCopyToCPU(NDArrayHandle handle, void *data, size_t size) {
  clear_error();
  Tensor *t = static_cast<Tensor *>(handle);
  size_t bytes = size * dtype_size(t->dtype);
  if (bytes != t->data.size()) {
    set_error("size mismatch in SyncCopyToCPU");
    return -1;
  }
  std::memcpy(data, t->data.data(), bytes);
  return 0;
}

int MXNDArraySave(const char *fname, uint32_t num_args,
                  NDArrayHandle *args, const char **keys) try {
  clear_error();
  FILE *f = fopen(fname, "wb");
  if (!f) {
    set_error(std::string("cannot open ") + fname);
    return -1;
  }
  uint64_t magic = kListMagic, reserved = 0, n = num_args;
  uint64_t m = keys ? num_args : 0;
  bool ok = write_all(f, &magic, 8) && write_all(f, &reserved, 8) &&
            write_all(f, &n, 8);
  for (uint32_t i = 0; ok && i < num_args; ++i)
    ok = write_tensor(f, *static_cast<Tensor *>(args[i]));
  ok = ok && write_all(f, &m, 8);
  for (uint64_t i = 0; ok && i < m; ++i) {
    uint64_t len = std::strlen(keys[i]);
    ok = write_all(f, &len, 8) && write_all(f, keys[i], len);
  }
  /* buffered writes surface ENOSPC at flush time — fclose failing means
   * the file on disk is NOT the file we think we wrote */
  ok = (fclose(f) == 0) && ok;
  if (!ok) set_error("write failed");
  return ok ? 0 : -1;
} catch (const std::exception &e) {
  set_error(std::string("save failed: ") + e.what());
  return -1;
}

int MXNDArrayIsNone(NDArrayHandle handle, int *out) {
  *out = static_cast<Tensor *>(handle)->is_none ? 1 : 0;
  return 0;
}

int MXNDArrayLoad(const char *fname, uint32_t *out_size,
                  NDArrayHandle **out_arr, uint32_t *out_name_size,
                  const char ***out_names) try {
  clear_error();
  FILE *f = fopen(fname, "rb");
  if (!f) {
    set_error(std::string("cannot open ") + fname);
    return -1;
  }
  uint64_t magic, reserved, n;
  if (!read_all(f, &magic, 8) || magic != kListMagic ||
      !read_all(f, &reserved, 8) || !read_all(f, &n, 8)) {
    set_error("not an NDArray list file");
    fclose(f);
    return -1;
  }
  std::vector<Tensor *> arrays;
  bool ok = true;
  try {
    for (uint64_t i = 0; ok && i < n; ++i) {
      Tensor *t = new Tensor();
      try {
        ok = read_tensor(f, t);
      } catch (...) {
        delete t;
        throw;
      }
      if (ok) arrays.push_back(t);
      else delete t;
    }
  } catch (...) {
    /* allocation failures (corrupt sizes) must not leak the file handle
     * or the tensors read so far */
    for (Tensor *t : arrays) delete t;
    fclose(f);
    throw;  /* function-level catch converts to -1 */
  }
  uint64_t m = 0;
  std::vector<std::string> names;
  /* the name block is mandatory in the container — a missing count means
   * a truncated file (the python reader raises FormatError here too) */
  ok = ok && read_all(f, &m, 8);
  constexpr uint64_t kMaxNameLen = uint64_t(1) << 20;
  for (uint64_t i = 0; ok && i < m; ++i) {
    uint64_t len;
    ok = read_all(f, &len, 8);
    if (ok && len > kMaxNameLen) {
      set_error("corrupt NDArray list: name length " +
                std::to_string(len));
      ok = false;
    }
    if (ok) {
      std::string s(len, '\0');
      ok = read_all(f, s.data(), len);
      if (ok) names.push_back(std::move(s));
    }
  }
  fclose(f);
  if (!ok) {
    for (Tensor *t : arrays) delete t;
    if (g_last_error.empty()) set_error("truncated NDArray list file");
    return -1;
  }
  /* caller frees via MXNDArrayFree + the handle/name blocks stay owned
   * by a per-load allocation released on MXNDArrayFree of... keep it
   * simple: leak-free contract is MXNDArrayListFree below. */
  NDArrayHandle *harr = new NDArrayHandle[arrays.size()];
  for (size_t i = 0; i < arrays.size(); ++i) harr[i] = arrays[i];
  const char **nm = nullptr;
  if (!names.empty()) {
    nm = new const char *[names.size()];
    for (size_t i = 0; i < names.size(); ++i) {
      char *c = new char[names[i].size() + 1];
      std::memcpy(c, names[i].c_str(), names[i].size() + 1);
      nm[i] = c;
    }
  }
  *out_size = static_cast<uint32_t>(arrays.size());
  *out_arr = harr;
  *out_name_size = static_cast<uint32_t>(names.size());
  *out_names = nm;
  return 0;
} catch (const std::exception &e) {
  /* exceptions must not cross the C ABI */
  set_error(std::string("load failed: ") + e.what());
  return -1;
}

int MXNDArrayListFree(uint32_t size, NDArrayHandle *arr,
                      uint32_t name_size, const char **names) {
  /* releases the blocks MXNDArrayLoad allocated (handles themselves are
   * freed individually with MXNDArrayFree) */
  (void)size;
  delete[] arr;
  for (uint32_t i = 0; i < name_size; ++i) delete[] names[i];
  delete[] names;
  return 0;
}

}  /* extern "C" */
