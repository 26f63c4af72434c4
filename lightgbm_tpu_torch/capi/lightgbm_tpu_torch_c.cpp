// C API for lightgbm_tpu_torch: the reference's LGBM_* surface over an
// embedded CPython interpreter.
//
// The reference exports 51 C functions from its C++ core (c_api.h,
// src/c_api.cpp).  The port's core is a PyTorch program, so the native
// boundary inverts, as in the JAX package's shim
// (lightgbm_tpu/capi/lightgbm_tpu_c.cpp): this shim hosts a Python
// interpreter and forwards each call to lightgbm_tpu_torch.capi_bridge
// with integer handles and raw buffer addresses.  The whole surface keeps
// the reference's function names, argument shapes and 0/-1 return
// convention (c_api.h:41-760); LGBM_GetLastError matches c_api.h:38.
// Sparse (CSR/CSC) inputs are densified at the boundary.
//
// Thread-safety contract: every entry point serializes on one global
// mutex, then takes the GIL (the reference's per-Booster mutex,
// src/c_api.cpp:67,102,163, strengthened to one global lock): concurrent
// calls from several host threads are safe but never parallel.
// Reentrancy (calling back into the API from a Python callback) is NOT
// supported and deadlocks, as the reference's non-recursive mutex does.
//
// Environment:
//   LGBM_TPU_PYHOME        - interpreter prefix (venv) to embed (optional)
//   LGBM_TPU_PYPATH        - extra sys.path entry for the package (optional)
//   LGBM_TPU_TORCH_DEVICE  - a handle's device when its parameters name
//                            none: cpu or cuda (default cuda; see the
//                            header)
//
// Build: python -m lightgbm_tpu_torch.capi.build (g++ against this
// interpreter's headers and libpython, into lightgbm_tpu_torch/_build/),
// or by hand:
//   g++ -O2 -shared -fPIC lightgbm_tpu_torch_c.cpp -o liblightgbm_tpu_torch_c.so \
//       $(python3-config --includes) -L$LIBDIR -lpython3.X -Wl,-rpath,$LIBDIR
#include <Python.h>

#include <cstdio>
#include <cstring>
#include <mutex>
#include <string>
#include <vector>

// public prototypes — including them makes the compiler enforce that
// every definition below matches the ABI the header promises
#include "lightgbm_tpu_torch_c.h"

namespace {

std::mutex g_mutex;
std::string g_last_error = "";
PyObject* g_bridge = nullptr;

void set_error_from_python() {
  PyObject *type = nullptr, *value = nullptr, *tb = nullptr;
  PyErr_Fetch(&type, &value, &tb);
  PyErr_NormalizeException(&type, &value, &tb);
  g_last_error = "unknown python error";
  if (value != nullptr) {
    PyObject* s = PyObject_Str(value);
    if (s != nullptr) {
      const char* c = PyUnicode_AsUTF8(s);
      if (c != nullptr) g_last_error = c;
      Py_DECREF(s);
    }
  }
  Py_XDECREF(type);
  Py_XDECREF(value);
  Py_XDECREF(tb);
}

// Initialize the interpreter + import the bridge once.
bool ensure_bridge() {
  if (g_bridge != nullptr) return true;
  if (!Py_IsInitialized()) {
    PyConfig config;
    PyConfig_InitPythonConfig(&config);
    const char* home = std::getenv("LGBM_TPU_PYHOME");
    if (home != nullptr) {
      std::string exe = std::string(home) + "/bin/python";
      PyConfig_SetBytesString(&config, &config.program_name, exe.c_str());
    }
    PyStatus status = Py_InitializeFromConfig(&config);
    PyConfig_Clear(&config);
    if (PyStatus_Exception(status)) {
      g_last_error = "failed to initialize python";
      return false;
    }
    // hand the GIL to the PyGILState system: the init thread holds it
    // implicitly after Py_InitializeFromConfig, and Ensure/Release pairs
    // on that hidden thread state corrupt the interpreter
    PyEval_SaveThread();
  }
  PyGILState_STATE gil = PyGILState_Ensure();
  const char* extra = std::getenv("LGBM_TPU_PYPATH");
  if (extra != nullptr) {
    PyObject* sys_path = PySys_GetObject("path");  // borrowed
    PyObject* p = PyUnicode_FromString(extra);
    if (sys_path != nullptr && p != nullptr) PyList_Insert(sys_path, 0, p);
    Py_XDECREF(p);
  }
  g_bridge = PyImport_ImportModule("lightgbm_tpu_torch.capi_bridge");
  if (g_bridge == nullptr) set_error_from_python();
  PyGILState_Release(gil);
  return g_bridge != nullptr;
}

// Call bridge.<fn>(args...); returns new ref or nullptr (error recorded).
PyObject* bridge_call(const char* fn, PyObject* args) {
  PyObject* f = PyObject_GetAttrString(g_bridge, fn);
  if (f == nullptr) {
    set_error_from_python();
    Py_XDECREF(args);
    return nullptr;
  }
  PyObject* out = PyObject_CallObject(f, args);
  Py_DECREF(f);
  Py_XDECREF(args);
  if (out == nullptr) set_error_from_python();
  return out;
}

// Run `fn(<args built from format>)`, store the integer result in *out
// (if non-null).  The argument tuple is built INSIDE the GIL scope —
// Py_BuildValue before interpreter init would crash.
int call_int(const char* fn, long long* out, const char* format, ...) {
  std::lock_guard<std::mutex> lock(g_mutex);
  if (!ensure_bridge()) return -1;
  PyGILState_STATE gil = PyGILState_Ensure();
  va_list va;
  va_start(va, format);
  PyObject* args = Py_VaBuildValue(format, va);
  va_end(va);
  int rc = -1;
  if (args == nullptr) {
    set_error_from_python();
  } else {
    PyObject* r = bridge_call(fn, args);
    if (r != nullptr) {
      rc = 0;
      if (out != nullptr) {
        if (PyFloat_Check(r)) {
          // leaf-value getters return float; round-trip through the
          // integer slot is not meaningful for them (call_f64 is used)
          *out = (long long)PyFloat_AsDouble(r);
        } else {
          *out = PyLong_AsLongLong(r);
        }
        if (*out == -1 && PyErr_Occurred()) {
          // record AND clear the pending exception: leaving the error
          // indicator set would poison the next CPython call
          set_error_from_python();
          rc = -1;
        }
      }
      Py_DECREF(r);
    }
  }
  PyGILState_Release(gil);
  return rc;
}

// Run `fn(...)` expecting a float result.
int call_f64(const char* fn, double* out, const char* format, ...) {
  std::lock_guard<std::mutex> lock(g_mutex);
  if (!ensure_bridge()) return -1;
  PyGILState_STATE gil = PyGILState_Ensure();
  va_list va;
  va_start(va, format);
  PyObject* args = Py_VaBuildValue(format, va);
  va_end(va);
  int rc = -1;
  if (args == nullptr) {
    set_error_from_python();
  } else {
    PyObject* r = bridge_call(fn, args);
    if (r != nullptr) {
      *out = PyFloat_AsDouble(r);
      if (*out == -1.0 && PyErr_Occurred()) {
        set_error_from_python();
      } else {
        rc = 0;
      }
      Py_DECREF(r);
    }
  }
  PyGILState_Release(gil);
  return rc;
}

// Run `fn(...)` expecting a str result, copied into the caller's buffer
// with the reference's (buffer_len, out_len) truncation contract
// (c_api.h:681-708: out_len is the FULL length; the copy stops at
// buffer_len - 1 and is NUL-terminated).
int call_str(const char* fn, int64_t buffer_len, int64_t* out_len,
             char* out_str, const char* format, ...) {
  std::lock_guard<std::mutex> lock(g_mutex);
  if (!ensure_bridge()) return -1;
  PyGILState_STATE gil = PyGILState_Ensure();
  va_list va;
  va_start(va, format);
  PyObject* args = Py_VaBuildValue(format, va);
  va_end(va);
  int rc = -1;
  if (args == nullptr) {
    set_error_from_python();
  } else {
    PyObject* r = bridge_call(fn, args);
    if (r != nullptr) {
      Py_ssize_t len = 0;
      const char* s = PyUnicode_AsUTF8AndSize(r, &len);
      if (s == nullptr) {
        set_error_from_python();
      } else {
        if (out_len != nullptr) *out_len = (int64_t)len + 1;
        if (out_str != nullptr && buffer_len > 0) {
          int64_t n = (int64_t)len < buffer_len - 1 ? (int64_t)len
                                                    : buffer_len - 1;
          std::memcpy(out_str, s, (size_t)n);
          out_str[n] = '\0';
        }
        rc = 0;
      }
      Py_DECREF(r);
    }
  }
  PyGILState_Release(gil);
  return rc;
}

// Run `fn(...)` expecting an (addr, len, dtype) tuple (DatasetGetField).
int call_field(const char* fn, const void** out_ptr, int* out_len,
               int* out_type, const char* format, ...) {
  std::lock_guard<std::mutex> lock(g_mutex);
  if (!ensure_bridge()) return -1;
  PyGILState_STATE gil = PyGILState_Ensure();
  va_list va;
  va_start(va, format);
  PyObject* args = Py_VaBuildValue(format, va);
  va_end(va);
  int rc = -1;
  if (args == nullptr) {
    set_error_from_python();
  } else {
    PyObject* r = bridge_call(fn, args);
    if (r != nullptr) {
      long long addr = 0, len = 0, type = 0;
      if (PyArg_ParseTuple(r, "LLL", &addr, &len, &type)) {
        *out_ptr = (const void*)(intptr_t)addr;
        *out_len = (int)len;
        *out_type = (int)type;
        rc = 0;
      } else {
        set_error_from_python();
      }
      Py_DECREF(r);
    }
  }
  PyGILState_Release(gil);
  return rc;
}

// Append a unicode code point as UTF-8.
void append_utf8(std::string* s, unsigned cp) {
  if (cp < 0x80) {
    s->push_back((char)cp);
  } else if (cp < 0x800) {
    s->push_back((char)(0xC0 | (cp >> 6)));
    s->push_back((char)(0x80 | (cp & 0x3F)));
  } else {
    s->push_back((char)(0xE0 | (cp >> 12)));
    s->push_back((char)(0x80 | ((cp >> 6) & 0x3F)));
    s->push_back((char)(0x80 | (cp & 0x3F)));
  }
}

// JSON-array-of-strings -> (char** buffer, count) copy helper for the
// GetFeatureNames / GetEvalNames calls (reference copies into
// caller-provided char** out_strs, c_api.h:243-251,450-456).  Full JSON
// string unescaping incl. \uXXXX (json.dumps emits ensure_ascii output).
//
// The v2.1.0 API carries no per-string buffer length, so callers must
// provide at least LGBM_TPU_MAX_NAME_LEN bytes per name (the caller
// contract, declared in the public header; the later reference API grew
// buffer_len parameters for exactly this hazard); names longer than that
// are truncated with explicit NUL-termination instead of overflowing the
// caller's buffers.  Truncation never splits a multi-byte UTF-8 sequence
// (copy_names itself decodes \uXXXX escapes into UTF-8, and e.g. JNI's
// strict UTF-8 conversion rejects malformed strings).
static const size_t kMaxNameLen = LGBM_TPU_MAX_NAME_LEN;

int copy_names(const char* json_names, int* out_len, char** out_strs) {
  std::vector<std::string> names;
  const char* p = json_names;
  while (*p != '\0') {
    if (*p == '"') {
      std::string cur;
      ++p;
      while (*p != '\0' && *p != '"') {
        if (*p == '\\' && p[1] != '\0') {
          ++p;
          switch (*p) {
            case 'n': cur.push_back('\n'); break;
            case 't': cur.push_back('\t'); break;
            case 'r': cur.push_back('\r'); break;
            case 'b': cur.push_back('\b'); break;
            case 'f': cur.push_back('\f'); break;
            case 'u': {
              unsigned cp = 0;
              int k = 0;
              for (; k < 4 && p[1] != '\0'; ++k) {
                char c = p[1];
                unsigned d;
                if (c >= '0' && c <= '9') d = (unsigned)(c - '0');
                else if (c >= 'a' && c <= 'f') d = (unsigned)(c - 'a' + 10);
                else if (c >= 'A' && c <= 'F') d = (unsigned)(c - 'A' + 10);
                else break;
                cp = (cp << 4) | d;
                ++p;
              }
              if (k == 4) append_utf8(&cur, cp);
              break;
            }
            default: cur.push_back(*p);  // \" \\ \/ and anything else
          }
          ++p;
        } else {
          cur.push_back(*p++);
        }
      }
      names.push_back(cur);
    }
    if (*p != '\0') ++p;
  }
  *out_len = (int)names.size();
  if (out_strs != nullptr) {
    for (size_t i = 0; i < names.size(); ++i) {
      size_t n = names[i].size();
      if (n >= kMaxNameLen) {
        n = kMaxNameLen - 1;
        // back off any UTF-8 continuation bytes so the cut lands on a
        // codepoint boundary
        while (n > 0 && (names[i][n] & 0xC0) == 0x80) --n;
      }
      std::memcpy(out_strs[i], names[i].data(), n);
      out_strs[i][n] = '\0';  // writes exactly n+1 bytes, never past cap
    }
  }
  return 0;
}

}  // namespace

extern "C" {

typedef void* DatasetHandle;
typedef void* BoosterHandle;

const char* LGBM_GetLastError() { return g_last_error.c_str(); }

// ---------------------------------------------------------------------
// datasets
// ---------------------------------------------------------------------
int LGBM_DatasetCreateFromFile(const char* filename, const char* parameters,
                               const DatasetHandle reference,
                               DatasetHandle* out) {
  long long h = 0;
  if (call_int("dataset_from_file", &h, "(ssL)", filename,
               parameters ? parameters : "",
               (long long)(intptr_t)reference) != 0) return -1;
  *out = (DatasetHandle)(intptr_t)h;
  return 0;
}

int LGBM_DatasetCreateFromSampledColumn(double** /*sample_data*/,
                                        int** /*sample_indices*/,
                                        int32_t ncol,
                                        const int* /*num_per_col*/,
                                        int32_t /*num_sample_row*/,
                                        int32_t num_total_row,
                                        const char* parameters,
                                        DatasetHandle* out) {
  // the sampled values only pre-size bin mappers in the reference
  // (c_api.h:70-84); our bin finding runs on the full pushed data
  // (capi_bridge._StreamingDataset), so only the shape matters here
  long long h = 0;
  if (call_int("dataset_from_sampled_column", &h, "(iis)",
               (int)num_total_row, (int)ncol,
               parameters ? parameters : "") != 0) return -1;
  *out = (DatasetHandle)(intptr_t)h;
  return 0;
}

int LGBM_DatasetCreateByReference(const DatasetHandle reference,
                                  int64_t num_total_row,
                                  DatasetHandle* out) {
  long long h = 0;
  if (call_int("dataset_create_by_reference", &h, "(LL)",
               (long long)(intptr_t)reference,
               (long long)num_total_row) != 0) return -1;
  *out = (DatasetHandle)(intptr_t)h;
  return 0;
}

int LGBM_DatasetPushRows(DatasetHandle dataset, const void* data,
                         int data_type, int32_t nrow, int32_t ncol,
                         int32_t start_row) {
  return call_int("dataset_push_rows", nullptr, "(LLiiii)",
                  (long long)(intptr_t)dataset, (long long)(intptr_t)data,
                  data_type, (int)nrow, (int)ncol, (int)start_row);
}

int LGBM_DatasetPushRowsByCSR(DatasetHandle dataset, const void* indptr,
                              int indptr_type, const int32_t* indices,
                              const void* data, int data_type,
                              int64_t nindptr, int64_t nelem,
                              int64_t num_col, int64_t start_row) {
  return call_int("dataset_push_rows_by_csr", nullptr, "(LLiLLiLLLL)",
                  (long long)(intptr_t)dataset, (long long)(intptr_t)indptr,
                  indptr_type, (long long)(intptr_t)indices,
                  (long long)(intptr_t)data, data_type, (long long)nindptr,
                  (long long)nelem, (long long)num_col,
                  (long long)start_row);
}

int LGBM_DatasetCreateFromCSR(const void* indptr, int indptr_type,
                              const int32_t* indices, const void* data,
                              int data_type, int64_t nindptr, int64_t nelem,
                              int64_t num_col, const char* parameters,
                              const DatasetHandle reference,
                              DatasetHandle* out) {
  long long h = 0;
  if (call_int("dataset_from_csr", &h, "(LiLLiLLLsL)",
               (long long)(intptr_t)indptr, indptr_type,
               (long long)(intptr_t)indices, (long long)(intptr_t)data,
               data_type, (long long)nindptr, (long long)nelem,
               (long long)num_col, parameters ? parameters : "",
               (long long)(intptr_t)reference) != 0) return -1;
  *out = (DatasetHandle)(intptr_t)h;
  return 0;
}

int LGBM_DatasetCreateFromCSC(const void* col_ptr, int col_ptr_type,
                              const int32_t* indices, const void* data,
                              int data_type, int64_t ncol_ptr, int64_t nelem,
                              int64_t num_row, const char* parameters,
                              const DatasetHandle reference,
                              DatasetHandle* out) {
  long long h = 0;
  if (call_int("dataset_from_csc", &h, "(LiLLiLLLsL)",
               (long long)(intptr_t)col_ptr, col_ptr_type,
               (long long)(intptr_t)indices, (long long)(intptr_t)data,
               data_type, (long long)ncol_ptr, (long long)nelem,
               (long long)num_row, parameters ? parameters : "",
               (long long)(intptr_t)reference) != 0) return -1;
  *out = (DatasetHandle)(intptr_t)h;
  return 0;
}

int LGBM_DatasetCreateFromMat(const void* data, int data_type,
                              int32_t nrow, int32_t ncol, int is_row_major,
                              const char* parameters,
                              const DatasetHandle reference,
                              DatasetHandle* out) {
  long long h = 0;
  if (call_int("dataset_from_mat", &h, "(LiiiisL)",
               (long long)(intptr_t)data, data_type, (int)nrow, (int)ncol,
               is_row_major, parameters ? parameters : "",
               (long long)(intptr_t)reference) != 0) return -1;
  *out = (DatasetHandle)(intptr_t)h;
  return 0;
}

int LGBM_DatasetGetSubset(const DatasetHandle handle,
                          const int32_t* used_row_indices,
                          int32_t num_used_row_indices,
                          const char* parameters, DatasetHandle* out) {
  long long h = 0;
  if (call_int("dataset_get_subset", &h, "(LLis)",
               (long long)(intptr_t)handle,
               (long long)(intptr_t)used_row_indices,
               (int)num_used_row_indices,
               parameters ? parameters : "") != 0) return -1;
  *out = (DatasetHandle)(intptr_t)h;
  return 0;
}

int LGBM_DatasetSetFeatureNames(DatasetHandle handle,
                                const char** feature_names, int num) {
  std::string js = "[";
  for (int i = 0; i < num; ++i) {
    if (i) js += ",";
    js += "\"";
    for (const char* p = feature_names[i]; *p != '\0'; ++p) {
      if (*p == '"' || *p == '\\') js += '\\';
      js += *p;
    }
    js += "\"";
  }
  js += "]";
  return call_int("dataset_set_feature_names", nullptr, "(Ls)",
                  (long long)(intptr_t)handle, js.c_str());
}

int LGBM_DatasetGetFeatureNames(DatasetHandle handle, char** feature_names,
                                int* num_feature_names) {
  // size the buffer from the real JSON length (silent truncation would
  // hand back wrong names for wide datasets)
  int64_t need = 0;
  if (call_str("dataset_get_feature_names", 0, &need, nullptr,
               "(L)", (long long)(intptr_t)handle) != 0) return -1;
  std::vector<char> buf((size_t)need + 1);
  int64_t out_len = 0;
  if (call_str("dataset_get_feature_names", (int64_t)buf.size(), &out_len,
               buf.data(), "(L)", (long long)(intptr_t)handle) != 0)
    return -1;
  return copy_names(buf.data(), num_feature_names, feature_names);
}

int LGBM_DatasetFree(DatasetHandle handle) {
  return call_int("free_handle", nullptr, "(L)",
                  (long long)(intptr_t)handle);
}

int LGBM_DatasetSaveBinary(DatasetHandle handle, const char* filename) {
  return call_int("dataset_save_binary", nullptr, "(Ls)",
                  (long long)(intptr_t)handle, filename);
}

int LGBM_DatasetSetField(DatasetHandle handle, const char* field_name,
                         const void* field_data, int num_element,
                         int type) {
  return call_int("dataset_set_field", nullptr, "(LsLii)",
                  (long long)(intptr_t)handle, field_name,
                  (long long)(intptr_t)field_data, num_element, type);
}

int LGBM_DatasetGetField(DatasetHandle handle, const char* field_name,
                         int* out_len, const void** out_ptr,
                         int* out_type) {
  return call_field("dataset_get_field", out_ptr, out_len, out_type,
                    "(Ls)", (long long)(intptr_t)handle, field_name);
}

int LGBM_DatasetGetNumData(DatasetHandle handle, int* out) {
  long long v = 0;
  if (call_int("dataset_num_data", &v, "(L)",
               (long long)(intptr_t)handle) != 0) return -1;
  *out = (int)v;
  return 0;
}

int LGBM_DatasetGetNumFeature(DatasetHandle handle, int* out) {
  long long v = 0;
  if (call_int("dataset_num_feature", &v, "(L)",
               (long long)(intptr_t)handle) != 0) return -1;
  *out = (int)v;
  return 0;
}

// ---------------------------------------------------------------------
// boosters
// ---------------------------------------------------------------------
int LGBM_BoosterCreate(const DatasetHandle train_data,
                       const char* parameters, BoosterHandle* out) {
  long long h = 0;
  if (call_int("booster_create", &h, "(Ls)",
               (long long)(intptr_t)train_data,
               parameters ? parameters : "") != 0) return -1;
  *out = (BoosterHandle)(intptr_t)h;
  return 0;
}

int LGBM_BoosterCreateFromModelfile(const char* filename, int* out_num_iters,
                                    BoosterHandle* out) {
  long long h = 0;
  if (call_int("booster_create_from_modelfile", &h, "(s)", filename) != 0)
    return -1;
  if (out_num_iters != nullptr) {
    long long it = 0;
    if (call_int("booster_current_iteration", &it, "(L)", h) != 0) {
      // don't leak the booster on the partial-failure path
      call_int("free_handle", nullptr, "(L)", h);
      return -1;
    }
    *out_num_iters = (int)it;
  }
  *out = (BoosterHandle)(intptr_t)h;
  return 0;
}

int LGBM_BoosterLoadModelFromString(const char* model_str,
                                    int* out_num_iterations,
                                    BoosterHandle* out) {
  long long h = 0;
  if (call_int("booster_load_model_from_string", &h, "(s)", model_str) != 0)
    return -1;
  if (out_num_iterations != nullptr) {
    long long it = 0;
    if (call_int("booster_current_iteration", &it, "(L)", h) != 0) {
      call_int("free_handle", nullptr, "(L)", h);
      return -1;
    }
    *out_num_iterations = (int)it;
  }
  *out = (BoosterHandle)(intptr_t)h;
  return 0;
}

int LGBM_BoosterFree(BoosterHandle handle) {
  return call_int("free_handle", nullptr, "(L)",
                  (long long)(intptr_t)handle);
}

int LGBM_BoosterMerge(BoosterHandle handle,
                      BoosterHandle other_handle) {
  return call_int("booster_merge", nullptr, "(LL)",
                  (long long)(intptr_t)handle,
                  (long long)(intptr_t)other_handle);
}

int LGBM_BoosterAddValidData(BoosterHandle handle,
                             const DatasetHandle valid_data) {
  // empty name -> bridge generates the reference's "valid_N" convention
  return call_int("booster_add_valid", nullptr, "(LLs)",
                  (long long)(intptr_t)handle,
                  (long long)(intptr_t)valid_data, "");
}

int LGBM_BoosterResetTrainingData(BoosterHandle handle,
                                  const DatasetHandle train_data) {
  return call_int("booster_reset_training_data", nullptr, "(LL)",
                  (long long)(intptr_t)handle,
                  (long long)(intptr_t)train_data);
}

int LGBM_BoosterResetParameter(BoosterHandle handle,
                               const char* parameters) {
  return call_int("booster_reset_parameter", nullptr, "(Ls)",
                  (long long)(intptr_t)handle,
                  parameters ? parameters : "");
}

int LGBM_BoosterGetNumClasses(BoosterHandle handle, int* out_len) {
  long long v = 0;
  if (call_int("booster_num_classes", &v, "(L)",
               (long long)(intptr_t)handle) != 0) return -1;
  *out_len = (int)v;
  return 0;
}

int LGBM_BoosterUpdateOneIter(BoosterHandle handle, int* is_finished) {
  long long fin = 0;
  if (call_int("booster_update_one_iter", &fin, "(L)",
               (long long)(intptr_t)handle) != 0) return -1;
  *is_finished = (int)fin;
  return 0;
}

int LGBM_BoosterUpdateOneIterCustom(BoosterHandle handle, const float* grad,
                                    const float* hess, int* is_finished) {
  long long n = 0;
  // the gradient length is num_data * num_class; the bridge reads it
  // from the booster itself
  if (call_int("booster_get_num_predict", &n, "(Li)",
               (long long)(intptr_t)handle, 0) != 0) return -1;
  long long fin = 0;
  if (call_int("booster_update_one_iter_custom", &fin, "(LLLi)",
               (long long)(intptr_t)handle, (long long)(intptr_t)grad,
               (long long)(intptr_t)hess, (int)n) != 0) return -1;
  *is_finished = (int)fin;
  return 0;
}

int LGBM_BoosterRollbackOneIter(BoosterHandle handle) {
  return call_int("booster_rollback_one_iter", nullptr, "(L)",
                  (long long)(intptr_t)handle);
}

int LGBM_BoosterGetCurrentIteration(BoosterHandle handle, int* out) {
  long long v = 0;
  if (call_int("booster_current_iteration", &v, "(L)",
               (long long)(intptr_t)handle) != 0) return -1;
  *out = (int)v;
  return 0;
}

int LGBM_BoosterNumberOfTotalModel(BoosterHandle handle, int* out_models) {
  long long v = 0;
  if (call_int("booster_number_of_total_model", &v, "(L)",
               (long long)(intptr_t)handle) != 0) return -1;
  *out_models = (int)v;
  return 0;
}

int LGBM_BoosterGetEvalCounts(BoosterHandle handle, int* out_len) {
  long long v = 0;
  if (call_int("booster_get_eval_counts", &v, "(L)",
               (long long)(intptr_t)handle) != 0) return -1;
  *out_len = (int)v;
  return 0;
}

int LGBM_BoosterGetEvalNames(BoosterHandle handle, int* out_len,
                             char** out_strs) {
  int64_t need = 0;
  if (call_str("booster_get_eval_names", 0, &need, nullptr, "(L)",
               (long long)(intptr_t)handle) != 0) return -1;
  std::vector<char> buf((size_t)need + 1);
  int64_t n = 0;
  if (call_str("booster_get_eval_names", (int64_t)buf.size(), &n,
               buf.data(), "(L)", (long long)(intptr_t)handle) != 0)
    return -1;
  return copy_names(buf.data(), out_len, out_strs);
}

int LGBM_BoosterGetFeatureNames(BoosterHandle handle, int* out_len,
                                char** out_strs) {
  int64_t need = 0;
  if (call_str("booster_get_feature_names", 0, &need, nullptr, "(L)",
               (long long)(intptr_t)handle) != 0) return -1;
  std::vector<char> buf((size_t)need + 1);
  int64_t n = 0;
  if (call_str("booster_get_feature_names", (int64_t)buf.size(), &n,
               buf.data(), "(L)", (long long)(intptr_t)handle) != 0)
    return -1;
  return copy_names(buf.data(), out_len, out_strs);
}

int LGBM_BoosterGetNumFeature(BoosterHandle handle, int* out_len) {
  long long v = 0;
  if (call_int("booster_get_num_feature", &v, "(L)",
               (long long)(intptr_t)handle) != 0) return -1;
  *out_len = (int)v;
  return 0;
}

int LGBM_BoosterGetEval(BoosterHandle handle, int data_idx, int* out_len,
                        double* out_results) {
  long long v = 0;
  if (call_int("booster_get_eval", &v, "(LiL)",
               (long long)(intptr_t)handle, data_idx,
               (long long)(intptr_t)out_results) != 0) return -1;
  *out_len = (int)v;
  return 0;
}

int LGBM_BoosterGetNumPredict(BoosterHandle handle, int data_idx,
                              int64_t* out_len) {
  long long v = 0;
  if (call_int("booster_get_num_predict", &v, "(Li)",
               (long long)(intptr_t)handle, data_idx) != 0) return -1;
  *out_len = (int64_t)v;
  return 0;
}

int LGBM_BoosterGetPredict(BoosterHandle handle, int data_idx,
                           int64_t* out_len, double* out_result) {
  long long v = 0;
  if (call_int("booster_get_predict", &v, "(LiL)",
               (long long)(intptr_t)handle, data_idx,
               (long long)(intptr_t)out_result) != 0) return -1;
  *out_len = (int64_t)v;
  return 0;
}

int LGBM_BoosterPredictForFile(BoosterHandle handle, const char* data_filename,
                               int data_has_header,
                               const char* result_filename, int predict_type,
                               int num_iteration) {
  return call_int("booster_predict_for_file", nullptr, "(Lsisii)",
                  (long long)(intptr_t)handle, data_filename,
                  data_has_header, result_filename, predict_type,
                  num_iteration);
}

int LGBM_BoosterCalcNumPredict(BoosterHandle handle, int num_row,
                               int predict_type, int num_iteration,
                               int64_t* out_len) {
  long long v = 0;
  if (call_int("booster_calc_num_predict", &v, "(Liii)",
               (long long)(intptr_t)handle, num_row, predict_type,
               num_iteration) != 0) return -1;
  *out_len = (int64_t)v;
  return 0;
}

int LGBM_BoosterPredictForCSR(BoosterHandle handle, const void* indptr,
                              int indptr_type, const int32_t* indices,
                              const void* data, int data_type,
                              int64_t nindptr, int64_t nelem,
                              int64_t num_col, int predict_type,
                              int num_iteration, const char* /*parameter*/,
                              int64_t* out_len, double* out_result) {
  long long v = 0;
  if (call_int("booster_predict_for_csr", &v, "(LLiLLiLLLiiL)",
               (long long)(intptr_t)handle, (long long)(intptr_t)indptr,
               indptr_type, (long long)(intptr_t)indices,
               (long long)(intptr_t)data, data_type, (long long)nindptr,
               (long long)nelem, (long long)num_col, predict_type,
               num_iteration, (long long)(intptr_t)out_result) != 0)
    return -1;
  *out_len = (int64_t)v;
  return 0;
}

int LGBM_BoosterPredictForCSC(BoosterHandle handle, const void* col_ptr,
                              int col_ptr_type, const int32_t* indices,
                              const void* data, int data_type,
                              int64_t ncol_ptr, int64_t nelem,
                              int64_t num_row, int predict_type,
                              int num_iteration, const char* /*parameter*/,
                              int64_t* out_len, double* out_result) {
  long long v = 0;
  if (call_int("booster_predict_for_csc", &v, "(LLiLLiLLLiiL)",
               (long long)(intptr_t)handle, (long long)(intptr_t)col_ptr,
               col_ptr_type, (long long)(intptr_t)indices,
               (long long)(intptr_t)data, data_type, (long long)ncol_ptr,
               (long long)nelem, (long long)num_row, predict_type,
               num_iteration, (long long)(intptr_t)out_result) != 0)
    return -1;
  *out_len = (int64_t)v;
  return 0;
}

int LGBM_BoosterPredictForMat(BoosterHandle handle, const void* data,
                              int data_type, int32_t nrow, int32_t ncol,
                              int is_row_major, int predict_type,
                              int num_iteration, const char* /*parameter*/,
                              int64_t* out_len, double* out_result) {
  long long n = 0;
  if (call_int("booster_predict_for_mat", &n, "(LLiiiiiiL)",
               (long long)(intptr_t)handle, (long long)(intptr_t)data,
               data_type, (int)nrow, (int)ncol, is_row_major, predict_type,
               num_iteration, (long long)(intptr_t)out_result) != 0)
    return -1;
  *out_len = (int64_t)n;
  return 0;
}

int LGBM_BoosterSaveModel(BoosterHandle handle, int /*start_iteration*/,
                          int num_iteration, const char* filename) {
  return call_int("booster_save_model", nullptr, "(Lsi)",
                  (long long)(intptr_t)handle, filename, num_iteration);
}

int LGBM_BoosterSaveModelToString(BoosterHandle handle,
                                  int /*start_iteration*/, int num_iteration,
                                  int64_t buffer_len, int64_t* out_len,
                                  char* out_str) {
  return call_str("booster_model_to_string", buffer_len, out_len, out_str,
                  "(Li)", (long long)(intptr_t)handle, num_iteration);
}

int LGBM_BoosterDumpModel(BoosterHandle handle, int /*start_iteration*/,
                          int num_iteration, int64_t buffer_len,
                          int64_t* out_len, char* out_str) {
  return call_str("booster_dump_model", buffer_len, out_len, out_str,
                  "(Li)", (long long)(intptr_t)handle, num_iteration);
}

int LGBM_BoosterGetLeafValue(BoosterHandle handle, int tree_idx,
                             int leaf_idx, double* out_val) {
  return call_f64("booster_get_leaf_value", out_val, "(Lii)",
                  (long long)(intptr_t)handle, tree_idx, leaf_idx);
}

int LGBM_BoosterSetLeafValue(BoosterHandle handle, int tree_idx,
                             int leaf_idx, double val) {
  return call_int("booster_set_leaf_value", nullptr, "(Liid)",
                  (long long)(intptr_t)handle, tree_idx, leaf_idx, val);
}

int LGBM_BoosterFeatureImportance(BoosterHandle handle, int num_iteration,
                                  int importance_type, double* out_results) {
  return call_int("booster_feature_importance", nullptr, "(LiiL)",
                  (long long)(intptr_t)handle, num_iteration,
                  importance_type, (long long)(intptr_t)out_results);
}

// ---------------------------------------------------------------------
// network (c_api.h:749-760)
// ---------------------------------------------------------------------
int LGBM_NetworkInit(const char* machines, int local_listen_port,
                     int listen_time_out, int num_machines) {
  return call_int("network_init", nullptr, "(siii)",
                  machines ? machines : "", local_listen_port,
                  listen_time_out, num_machines);
}

int LGBM_NetworkFree() {
  return call_int("network_free", nullptr, "()");
}

int LGBM_NetworkInitWithFunctions(int num_machines, int rank,
                                  void* reduce_scatter_ext_fun,
                                  void* allgather_ext_fun) {
  return call_int("network_init_with_functions", nullptr, "(iiLL)",
                  num_machines, rank,
                  (long long)(intptr_t)reduce_scatter_ext_fun,
                  (long long)(intptr_t)allgather_ext_fun);
}

}  // extern "C"
