/* R bindings for lightgbm_tpu_torch: the reference R package's .Call
 * surface (the reference's include/LightGBM/lightgbm_R.h, 38 LGBM_*_R
 * entry points) over the port's complete C API
 * (capi/lightgbm_tpu_torch_c.h); a copy of the JAX package's
 * rpkg/src/lightgbm_tpu_R.cpp.
 *
 * Calling conventions match the reference glue so the reference's R
 * package code (R-package/R/*.R, lgb.call / lgb.call.return.str) drives
 * this library unchanged:
 *   - every argument is an R object (LGBM_SE); scalars are length-1
 *     INTSXP/REALSXP vectors, strings are char buffers,
 *   - handles ride in an int64 payload,
 *   - `call_state` is a length-1 integer the wrapper sets to -1 on
 *     error (message via LGBM_GetLastError_R),
 *   - string vectors (feature/eval names) travel tab-joined in single
 *     buffers.
 * No R headers are used: see r_object.h (the reference takes the same
 * approach).  tests/test_torch_r_api.py compiles this file and drives it
 * end to end with mock R objects of the same layout.  The device choice
 * is the C API's (see its header): "device=cpu" in a Booster's
 * parameters, or LGBM_TPU_TORCH_DEVICE=cpu.
 */
#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

#include "../../capi/lightgbm_tpu_torch_c.h"
#include "r_object.h"

#define LTPU_R_EXPORT extern "C"

namespace {

/* error text for LGBM_GetLastError_R; the C API keeps its own */
void copy_out_str(LGBM_SE dest, LGBM_SE buf_len, LGBM_SE actual_len,
                  const char* src, size_t len_with_nul) {
  ltpu_r_int(actual_len)[0] = static_cast<int>(len_with_nul);
  if (ltpu_r_as_int(buf_len) < static_cast<int>(len_with_nul)) return;
  std::memcpy(ltpu_r_char(dest), src, len_with_nul);
}

std::vector<std::string> split_tabs(const char* joined) {
  std::vector<std::string> out;
  std::string cur;
  for (const char* p = joined; ; ++p) {
    if (*p == '\t' || *p == '\0') {
      out.push_back(cur);
      cur.clear();
      if (*p == '\0') break;
    } else {
      cur.push_back(*p);
    }
  }
  return out;
}

int predict_type(LGBM_SE is_rawscore, LGBM_SE is_leafidx,
                 LGBM_SE is_predcontrib) {
  if (ltpu_r_as_int(is_predcontrib)) return C_API_PREDICT_CONTRIB;
  if (ltpu_r_as_int(is_leafidx)) return C_API_PREDICT_LEAF_INDEX;
  if (ltpu_r_as_int(is_rawscore)) return C_API_PREDICT_RAW_SCORE;
  return C_API_PREDICT_NORMAL;
}

}  // namespace

/* CALL(x): run a C-API call; on failure flag call_state and bail */
#define CALL(x)                                  \
  do {                                           \
    if ((x) != 0) {                              \
      ltpu_r_int(call_state)[0] = -1;            \
      return call_state;                         \
    }                                            \
  } while (0)

LTPU_R_EXPORT LGBM_SE LGBM_GetLastError_R(LGBM_SE buf_len,
                                          LGBM_SE actual_len,
                                          LGBM_SE err_msg) {
  const char* msg = LGBM_GetLastError();
  copy_out_str(err_msg, buf_len, actual_len, msg, std::strlen(msg) + 1);
  return err_msg;
}

/* ---------------- datasets ---------------- */

LTPU_R_EXPORT LGBM_SE LGBM_DatasetCreateFromFile_R(
    LGBM_SE filename, LGBM_SE parameters, LGBM_SE reference, LGBM_SE out,
    LGBM_SE call_state) {
  DatasetHandle handle = nullptr;
  CALL(LGBM_DatasetCreateFromFile(ltpu_r_char(filename),
                                  ltpu_r_char(parameters),
                                  ltpu_r_get_ptr(reference), &handle));
  ltpu_r_set_ptr(out, handle);
  return call_state;
}

LTPU_R_EXPORT LGBM_SE LGBM_DatasetCreateFromCSC_R(
    LGBM_SE indptr, LGBM_SE indices, LGBM_SE data, LGBM_SE nindptr,
    LGBM_SE nelem, LGBM_SE num_row, LGBM_SE parameters, LGBM_SE reference,
    LGBM_SE out, LGBM_SE call_state) {
  DatasetHandle handle = nullptr;
  CALL(LGBM_DatasetCreateFromCSC(
      ltpu_r_int(indptr), C_API_DTYPE_INT32,
      reinterpret_cast<const int32_t*>(ltpu_r_int(indices)),
      ltpu_r_real(data), C_API_DTYPE_FLOAT64, ltpu_r_as_int(nindptr),
      ltpu_r_as_int(nelem), ltpu_r_as_int(num_row), ltpu_r_char(parameters),
      ltpu_r_get_ptr(reference), &handle));
  ltpu_r_set_ptr(out, handle);
  return call_state;
}

LTPU_R_EXPORT LGBM_SE LGBM_DatasetCreateFromMat_R(
    LGBM_SE data, LGBM_SE nrow, LGBM_SE ncol, LGBM_SE parameters,
    LGBM_SE reference, LGBM_SE out, LGBM_SE call_state) {
  DatasetHandle handle = nullptr;
  /* R matrices are column-major */
  CALL(LGBM_DatasetCreateFromMat(ltpu_r_real(data), C_API_DTYPE_FLOAT64,
                                 ltpu_r_as_int(nrow), ltpu_r_as_int(ncol),
                                 0 /* col-major */, ltpu_r_char(parameters),
                                 ltpu_r_get_ptr(reference), &handle));
  ltpu_r_set_ptr(out, handle);
  return call_state;
}

LTPU_R_EXPORT LGBM_SE LGBM_DatasetGetSubset_R(
    LGBM_SE handle, LGBM_SE used_row_indices, LGBM_SE len_used_row_indices,
    LGBM_SE parameters, LGBM_SE out, LGBM_SE call_state) {
  int len = ltpu_r_as_int(len_used_row_indices);
  /* R indices are 1-based */
  std::vector<int32_t> idx(static_cast<size_t>(len));
  const int* src = ltpu_r_int(used_row_indices);
  for (int i = 0; i < len; ++i) idx[static_cast<size_t>(i)] = src[i] - 1;
  DatasetHandle res = nullptr;
  CALL(LGBM_DatasetGetSubset(ltpu_r_get_ptr(handle), idx.data(), len,
                             ltpu_r_char(parameters), &res));
  ltpu_r_set_ptr(out, res);
  return call_state;
}

LTPU_R_EXPORT LGBM_SE LGBM_DatasetSetFeatureNames_R(LGBM_SE handle,
                                                    LGBM_SE feature_names,
                                                    LGBM_SE call_state) {
  auto names = split_tabs(ltpu_r_char(feature_names));
  std::vector<const char*> ptrs;
  ptrs.reserve(names.size());
  for (const auto& s : names) ptrs.push_back(s.c_str());
  CALL(LGBM_DatasetSetFeatureNames(ltpu_r_get_ptr(handle), ptrs.data(),
                                   static_cast<int>(ptrs.size())));
  return call_state;
}

LTPU_R_EXPORT LGBM_SE LGBM_DatasetGetFeatureNames_R(
    LGBM_SE handle, LGBM_SE buf_len, LGBM_SE actual_len,
    LGBM_SE feature_names, LGBM_SE call_state) {
  int len = 0;
  CALL(LGBM_DatasetGetNumFeature(ltpu_r_get_ptr(handle), &len));
  std::vector<std::vector<char>> bufs(
      static_cast<size_t>(len), std::vector<char>(LGBM_TPU_MAX_NAME_LEN));
  std::vector<char*> ptrs(static_cast<size_t>(len));
  for (int i = 0; i < len; ++i) ptrs[static_cast<size_t>(i)] = bufs[i].data();
  int out_len = 0;
  CALL(LGBM_DatasetGetFeatureNames(ltpu_r_get_ptr(handle), ptrs.data(),
                                   &out_len));
  std::string joined;
  for (int i = 0; i < out_len; ++i) {
    if (i) joined.push_back('\t');
    joined += ptrs[static_cast<size_t>(i)];
  }
  copy_out_str(feature_names, buf_len, actual_len, joined.c_str(),
               joined.size() + 1);
  return call_state;
}

LTPU_R_EXPORT LGBM_SE LGBM_DatasetSaveBinary_R(LGBM_SE handle,
                                               LGBM_SE filename,
                                               LGBM_SE call_state) {
  CALL(LGBM_DatasetSaveBinary(ltpu_r_get_ptr(handle),
                              ltpu_r_char(filename)));
  return call_state;
}

LTPU_R_EXPORT LGBM_SE LGBM_DatasetFree_R(LGBM_SE handle,
                                         LGBM_SE call_state) {
  if (!ltpu_r_is_null(handle) && ltpu_r_get_ptr(handle) != nullptr) {
    CALL(LGBM_DatasetFree(ltpu_r_get_ptr(handle)));
    ltpu_r_set_ptr(handle, nullptr);
  }
  return call_state;
}

LTPU_R_EXPORT LGBM_SE LGBM_DatasetSetField_R(
    LGBM_SE handle, LGBM_SE field_name, LGBM_SE field_data,
    LGBM_SE num_element, LGBM_SE call_state) {
  int len = ltpu_r_as_int(num_element);
  const char* name = ltpu_r_char(field_name);
  if (!std::strcmp(name, "group") || !std::strcmp(name, "query")) {
    /* R hands group SIZES as ints; the C API takes them the same way */
    CALL(LGBM_DatasetSetField(ltpu_r_get_ptr(handle), name,
                              ltpu_r_int(field_data), len,
                              C_API_DTYPE_INT32));
  } else {
    /* label/weight/init_score arrive as doubles; convert to f32 where
     * the C API expects it (init_score stays f64) */
    if (!std::strcmp(name, "init_score")) {
      CALL(LGBM_DatasetSetField(ltpu_r_get_ptr(handle), name,
                                ltpu_r_real(field_data), len,
                                C_API_DTYPE_FLOAT64));
    } else {
      std::vector<float> vals(static_cast<size_t>(len));
      const double* src = ltpu_r_real(field_data);
      for (int i = 0; i < len; ++i)
        vals[static_cast<size_t>(i)] = static_cast<float>(src[i]);
      CALL(LGBM_DatasetSetField(ltpu_r_get_ptr(handle), name, vals.data(),
                                len, C_API_DTYPE_FLOAT32));
    }
  }
  return call_state;
}

namespace {
int get_field_common(LGBM_SE handle, LGBM_SE field_name, int* out_len,
                     const void** out_ptr, int* out_type) {
  return LGBM_DatasetGetField(ltpu_r_get_ptr(handle),
                              ltpu_r_char(field_name), out_len, out_ptr,
                              out_type);
}
}  // namespace

LTPU_R_EXPORT LGBM_SE LGBM_DatasetGetFieldSize_R(LGBM_SE handle,
                                                 LGBM_SE field_name,
                                                 LGBM_SE out,
                                                 LGBM_SE call_state) {
  int len = 0, type = 0;
  const void* ptr = nullptr;
  CALL(get_field_common(handle, field_name, &len, &ptr, &type));
  const char* name = ltpu_r_char(field_name);
  if (!std::strcmp(name, "group") || !std::strcmp(name, "query"))
    len -= 1;                /* boundaries -> group count */
  ltpu_r_int(out)[0] = len;
  return call_state;
}

LTPU_R_EXPORT LGBM_SE LGBM_DatasetGetField_R(LGBM_SE handle,
                                             LGBM_SE field_name,
                                             LGBM_SE field_data,
                                             LGBM_SE call_state) {
  int len = 0, type = 0;
  const void* ptr = nullptr;
  CALL(get_field_common(handle, field_name, &len, &ptr, &type));
  const char* name = ltpu_r_char(field_name);
  if (!std::strcmp(name, "group") || !std::strcmp(name, "query")) {
    const int32_t* b = static_cast<const int32_t*>(ptr);
    for (int i = 0; i + 1 < len; ++i)
      ltpu_r_int(field_data)[i] = b[i + 1] - b[i];   /* sizes */
  } else if (type == C_API_DTYPE_FLOAT64) {
    const double* d = static_cast<const double*>(ptr);
    for (int i = 0; i < len; ++i) ltpu_r_real(field_data)[i] = d[i];
  } else {
    const float* d = static_cast<const float*>(ptr);
    for (int i = 0; i < len; ++i)
      ltpu_r_real(field_data)[i] = static_cast<double>(d[i]);
  }
  return call_state;
}

LTPU_R_EXPORT LGBM_SE LGBM_DatasetGetNumData_R(LGBM_SE handle, LGBM_SE out,
                                               LGBM_SE call_state) {
  int n = 0;
  CALL(LGBM_DatasetGetNumData(ltpu_r_get_ptr(handle), &n));
  ltpu_r_int(out)[0] = n;
  return call_state;
}

LTPU_R_EXPORT LGBM_SE LGBM_DatasetGetNumFeature_R(LGBM_SE handle,
                                                  LGBM_SE out,
                                                  LGBM_SE call_state) {
  int n = 0;
  CALL(LGBM_DatasetGetNumFeature(ltpu_r_get_ptr(handle), &n));
  ltpu_r_int(out)[0] = n;
  return call_state;
}

/* ---------------- boosters ---------------- */

LTPU_R_EXPORT LGBM_SE LGBM_BoosterCreate_R(LGBM_SE train_data,
                                           LGBM_SE parameters, LGBM_SE out,
                                           LGBM_SE call_state) {
  BoosterHandle handle = nullptr;
  CALL(LGBM_BoosterCreate(ltpu_r_get_ptr(train_data),
                          ltpu_r_char(parameters), &handle));
  ltpu_r_set_ptr(out, handle);
  return call_state;
}

LTPU_R_EXPORT LGBM_SE LGBM_BoosterFree_R(LGBM_SE handle,
                                         LGBM_SE call_state) {
  if (!ltpu_r_is_null(handle) && ltpu_r_get_ptr(handle) != nullptr) {
    CALL(LGBM_BoosterFree(ltpu_r_get_ptr(handle)));
    ltpu_r_set_ptr(handle, nullptr);
  }
  return call_state;
}

LTPU_R_EXPORT LGBM_SE LGBM_BoosterCreateFromModelfile_R(LGBM_SE filename,
                                                        LGBM_SE out,
                                                        LGBM_SE call_state) {
  int num_iters = 0;
  BoosterHandle handle = nullptr;
  CALL(LGBM_BoosterCreateFromModelfile(ltpu_r_char(filename), &num_iters,
                                       &handle));
  ltpu_r_set_ptr(out, handle);
  return call_state;
}

LTPU_R_EXPORT LGBM_SE LGBM_BoosterLoadModelFromString_R(LGBM_SE model_str,
                                                        LGBM_SE out,
                                                        LGBM_SE call_state) {
  int num_iters = 0;
  BoosterHandle handle = nullptr;
  CALL(LGBM_BoosterLoadModelFromString(ltpu_r_char(model_str), &num_iters,
                                       &handle));
  ltpu_r_set_ptr(out, handle);
  return call_state;
}

LTPU_R_EXPORT LGBM_SE LGBM_BoosterMerge_R(LGBM_SE handle,
                                          LGBM_SE other_handle,
                                          LGBM_SE call_state) {
  CALL(LGBM_BoosterMerge(ltpu_r_get_ptr(handle),
                         ltpu_r_get_ptr(other_handle)));
  return call_state;
}

LTPU_R_EXPORT LGBM_SE LGBM_BoosterAddValidData_R(LGBM_SE handle,
                                                 LGBM_SE valid_data,
                                                 LGBM_SE call_state) {
  CALL(LGBM_BoosterAddValidData(ltpu_r_get_ptr(handle),
                                ltpu_r_get_ptr(valid_data)));
  return call_state;
}

LTPU_R_EXPORT LGBM_SE LGBM_BoosterResetTrainingData_R(LGBM_SE handle,
                                                      LGBM_SE train_data,
                                                      LGBM_SE call_state) {
  CALL(LGBM_BoosterResetTrainingData(ltpu_r_get_ptr(handle),
                                     ltpu_r_get_ptr(train_data)));
  return call_state;
}

LTPU_R_EXPORT LGBM_SE LGBM_BoosterResetParameter_R(LGBM_SE handle,
                                                   LGBM_SE parameters,
                                                   LGBM_SE call_state) {
  CALL(LGBM_BoosterResetParameter(ltpu_r_get_ptr(handle),
                                  ltpu_r_char(parameters)));
  return call_state;
}

LTPU_R_EXPORT LGBM_SE LGBM_BoosterGetNumClasses_R(LGBM_SE handle,
                                                  LGBM_SE out,
                                                  LGBM_SE call_state) {
  int n = 0;
  CALL(LGBM_BoosterGetNumClasses(ltpu_r_get_ptr(handle), &n));
  ltpu_r_int(out)[0] = n;
  return call_state;
}

LTPU_R_EXPORT LGBM_SE LGBM_BoosterUpdateOneIter_R(LGBM_SE handle,
                                                  LGBM_SE call_state) {
  int is_finished = 0;
  CALL(LGBM_BoosterUpdateOneIter(ltpu_r_get_ptr(handle), &is_finished));
  return call_state;
}

LTPU_R_EXPORT LGBM_SE LGBM_BoosterUpdateOneIterCustom_R(
    LGBM_SE handle, LGBM_SE grad, LGBM_SE hess, LGBM_SE len,
    LGBM_SE call_state) {
  int n = ltpu_r_as_int(len);
  std::vector<float> g(static_cast<size_t>(n)), h(static_cast<size_t>(n));
  const double* gs = ltpu_r_real(grad);
  const double* hs = ltpu_r_real(hess);
  for (int i = 0; i < n; ++i) {
    g[static_cast<size_t>(i)] = static_cast<float>(gs[i]);
    h[static_cast<size_t>(i)] = static_cast<float>(hs[i]);
  }
  int is_finished = 0;
  CALL(LGBM_BoosterUpdateOneIterCustom(ltpu_r_get_ptr(handle), g.data(),
                                       h.data(), &is_finished));
  return call_state;
}

LTPU_R_EXPORT LGBM_SE LGBM_BoosterRollbackOneIter_R(LGBM_SE handle,
                                                    LGBM_SE call_state) {
  CALL(LGBM_BoosterRollbackOneIter(ltpu_r_get_ptr(handle)));
  return call_state;
}

LTPU_R_EXPORT LGBM_SE LGBM_BoosterGetCurrentIteration_R(LGBM_SE handle,
                                                        LGBM_SE out,
                                                        LGBM_SE call_state) {
  int it = 0;
  CALL(LGBM_BoosterGetCurrentIteration(ltpu_r_get_ptr(handle), &it));
  ltpu_r_int(out)[0] = it;
  return call_state;
}

LTPU_R_EXPORT LGBM_SE LGBM_BoosterGetEvalNames_R(
    LGBM_SE handle, LGBM_SE buf_len, LGBM_SE actual_len, LGBM_SE eval_names,
    LGBM_SE call_state) {
  int len = 0;
  CALL(LGBM_BoosterGetEvalCounts(ltpu_r_get_ptr(handle), &len));
  std::vector<std::vector<char>> bufs(
      static_cast<size_t>(len), std::vector<char>(LGBM_TPU_MAX_NAME_LEN));
  std::vector<char*> ptrs(static_cast<size_t>(len));
  for (int i = 0; i < len; ++i) ptrs[static_cast<size_t>(i)] = bufs[i].data();
  int out_len = 0;
  CALL(LGBM_BoosterGetEvalNames(ltpu_r_get_ptr(handle), &out_len,
                                ptrs.data()));
  std::string joined;
  for (int i = 0; i < out_len; ++i) {
    if (i) joined.push_back('\t');
    joined += ptrs[static_cast<size_t>(i)];
  }
  copy_out_str(eval_names, buf_len, actual_len, joined.c_str(),
               joined.size() + 1);
  return call_state;
}

LTPU_R_EXPORT LGBM_SE LGBM_BoosterGetEval_R(LGBM_SE handle, LGBM_SE data_idx,
                                            LGBM_SE out_result,
                                            LGBM_SE call_state) {
  int out_len = 0;
  CALL(LGBM_BoosterGetEval(ltpu_r_get_ptr(handle), ltpu_r_as_int(data_idx),
                           &out_len, ltpu_r_real(out_result)));
  return call_state;
}

LTPU_R_EXPORT LGBM_SE LGBM_BoosterGetNumPredict_R(LGBM_SE handle,
                                                  LGBM_SE data_idx,
                                                  LGBM_SE out,
                                                  LGBM_SE call_state) {
  int64_t len = 0;
  CALL(LGBM_BoosterGetNumPredict(ltpu_r_get_ptr(handle),
                                 ltpu_r_as_int(data_idx), &len));
  ltpu_r_int(out)[0] = static_cast<int>(len);
  return call_state;
}

LTPU_R_EXPORT LGBM_SE LGBM_BoosterGetPredict_R(LGBM_SE handle,
                                               LGBM_SE data_idx,
                                               LGBM_SE out_result,
                                               LGBM_SE call_state) {
  int64_t len = 0;
  CALL(LGBM_BoosterGetPredict(ltpu_r_get_ptr(handle),
                              ltpu_r_as_int(data_idx), &len,
                              ltpu_r_real(out_result)));
  return call_state;
}

LTPU_R_EXPORT LGBM_SE LGBM_BoosterPredictForFile_R(
    LGBM_SE handle, LGBM_SE data_filename, LGBM_SE data_has_header,
    LGBM_SE is_rawscore, LGBM_SE is_leafidx, LGBM_SE is_predcontrib,
    LGBM_SE num_iteration, LGBM_SE parameter, LGBM_SE result_filename,
    LGBM_SE call_state) {
  (void)parameter;
  CALL(LGBM_BoosterPredictForFile(
      ltpu_r_get_ptr(handle), ltpu_r_char(data_filename),
      ltpu_r_as_int(data_has_header), ltpu_r_char(result_filename),
      predict_type(is_rawscore, is_leafidx, is_predcontrib),
      ltpu_r_as_int(num_iteration)));
  return call_state;
}

LTPU_R_EXPORT LGBM_SE LGBM_BoosterCalcNumPredict_R(
    LGBM_SE handle, LGBM_SE num_row, LGBM_SE is_rawscore, LGBM_SE is_leafidx,
    LGBM_SE is_predcontrib, LGBM_SE num_iteration, LGBM_SE out_len,
    LGBM_SE call_state) {
  int64_t len = 0;
  CALL(LGBM_BoosterCalcNumPredict(
      ltpu_r_get_ptr(handle), ltpu_r_as_int(num_row),
      predict_type(is_rawscore, is_leafidx, is_predcontrib),
      ltpu_r_as_int(num_iteration), &len));
  ltpu_r_int(out_len)[0] = static_cast<int>(len);
  return call_state;
}

LTPU_R_EXPORT LGBM_SE LGBM_BoosterPredictForCSC_R(
    LGBM_SE handle, LGBM_SE indptr, LGBM_SE indices, LGBM_SE data,
    LGBM_SE nindptr, LGBM_SE nelem, LGBM_SE num_row, LGBM_SE is_rawscore,
    LGBM_SE is_leafidx, LGBM_SE is_predcontrib, LGBM_SE num_iteration,
    LGBM_SE parameter, LGBM_SE out_result, LGBM_SE call_state) {
  int64_t out_len = 0;
  CALL(LGBM_BoosterPredictForCSC(
      ltpu_r_get_ptr(handle), ltpu_r_int(indptr), C_API_DTYPE_INT32,
      reinterpret_cast<const int32_t*>(ltpu_r_int(indices)),
      ltpu_r_real(data), C_API_DTYPE_FLOAT64, ltpu_r_as_int(nindptr),
      ltpu_r_as_int(nelem), ltpu_r_as_int(num_row),
      predict_type(is_rawscore, is_leafidx, is_predcontrib),
      ltpu_r_as_int(num_iteration), ltpu_r_char(parameter), &out_len,
      ltpu_r_real(out_result)));
  return call_state;
}

LTPU_R_EXPORT LGBM_SE LGBM_BoosterPredictForMat_R(
    LGBM_SE handle, LGBM_SE data, LGBM_SE nrow, LGBM_SE ncol,
    LGBM_SE is_rawscore, LGBM_SE is_leafidx, LGBM_SE is_predcontrib,
    LGBM_SE num_iteration, LGBM_SE parameter, LGBM_SE out_result,
    LGBM_SE call_state) {
  int64_t out_len = 0;
  CALL(LGBM_BoosterPredictForMat(
      ltpu_r_get_ptr(handle), ltpu_r_real(data), C_API_DTYPE_FLOAT64,
      ltpu_r_as_int(nrow), ltpu_r_as_int(ncol), 0 /* col-major */,
      predict_type(is_rawscore, is_leafidx, is_predcontrib),
      ltpu_r_as_int(num_iteration), ltpu_r_char(parameter), &out_len,
      ltpu_r_real(out_result)));
  return call_state;
}

LTPU_R_EXPORT LGBM_SE LGBM_BoosterSaveModel_R(LGBM_SE handle,
                                              LGBM_SE num_iteration,
                                              LGBM_SE filename,
                                              LGBM_SE call_state) {
  CALL(LGBM_BoosterSaveModel(ltpu_r_get_ptr(handle), 0,
                             ltpu_r_as_int(num_iteration),
                             ltpu_r_char(filename)));
  return call_state;
}

LTPU_R_EXPORT LGBM_SE LGBM_BoosterSaveModelToString_R(
    LGBM_SE handle, LGBM_SE num_iteration, LGBM_SE buffer_len,
    LGBM_SE actual_len, LGBM_SE out_str, LGBM_SE call_state) {
  int64_t out_len = 0;
  int cap = ltpu_r_as_int(buffer_len);
  std::vector<char> buf(static_cast<size_t>(cap > 0 ? cap : 1));
  CALL(LGBM_BoosterSaveModelToString(ltpu_r_get_ptr(handle), 0,
                                     ltpu_r_as_int(num_iteration),
                                     static_cast<int64_t>(buf.size()),
                                     &out_len, buf.data()));
  copy_out_str(out_str, buffer_len, actual_len, buf.data(),
               static_cast<size_t>(out_len));
  return call_state;
}

LTPU_R_EXPORT LGBM_SE LGBM_BoosterDumpModel_R(
    LGBM_SE handle, LGBM_SE num_iteration, LGBM_SE buffer_len,
    LGBM_SE actual_len, LGBM_SE out_str, LGBM_SE call_state) {
  int64_t out_len = 0;
  int cap = ltpu_r_as_int(buffer_len);
  std::vector<char> buf(static_cast<size_t>(cap > 0 ? cap : 1));
  CALL(LGBM_BoosterDumpModel(ltpu_r_get_ptr(handle), 0,
                             ltpu_r_as_int(num_iteration),
                             static_cast<int64_t>(buf.size()), &out_len,
                             buf.data()));
  copy_out_str(out_str, buffer_len, actual_len, buf.data(),
               static_cast<size_t>(out_len));
  return call_state;
}
