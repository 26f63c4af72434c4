/* C API for lightgbm_tpu_torch: the reference's LGBM_* surface.
 *
 * Mirrors the reference's include/LightGBM/c_api.h:41-760 (51 exported
 * functions + LGBM_GetLastError); implemented by lightgbm_tpu_torch_c.cpp
 * over an embedded CPython interpreter that imports
 * lightgbm_tpu_torch.capi_bridge.  This header is the binding surface for
 * host applications, for the R shim (rpkg/src/) and for the SWIG JVM
 * wrapper (swig/lightgbm_tpu_torch_lib.i).
 *
 * One process loads one shim: the JAX package's shim
 * (lightgbm_tpu/capi/lightgbm_tpu_c.h) exports the same LGBM_* symbols.
 *
 * Device: a Booster trains and predicts on the device its parameter
 * string names ("device=cpu" or "device=cuda", LGBM_BoosterCreate).  The
 * calls that take no parameter string (LGBM_BoosterCreateFromModelfile,
 * LGBM_BoosterLoadModelFromString, LGBM_NetworkInit), and a string that
 * names no device, use the LGBM_TPU_TORCH_DEVICE environment variable
 * ("cpu" or "cuda"), else the card ("cuda").  A caller on a host without
 * a card asks for the CPU that way; without the request the first use of
 * the card fails and the call returns -1 (LGBM_GetLastError says why):
 * the library never carries on on the CPU by itself.  The parameter
 * string of the LGBM_BoosterPredictFor* calls is not read: a Booster
 * predicts on its own device (the card's compiled model, or the CPU's
 * host walk).
 *
 * Environment: LGBM_TPU_PYHOME, the prefix (a venv) of the interpreter
 * to embed, and LGBM_TPU_PYPATH, a sys.path entry that holds the
 * lightgbm_tpu_torch package (both optional).
 *
 * Thread-safety: every call serializes on one global mutex + the GIL;
 * concurrent host threads are safe but never parallel; reentrancy from
 * Python callbacks is not supported.
 */
#ifndef LIGHTGBM_TPU_TORCH_C_H_
#define LIGHTGBM_TPU_TORCH_C_H_

#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

typedef void* DatasetHandle;
typedef void* BoosterHandle;

/* C_API_DTYPE_* / C_API_PREDICT_* constants match the reference
 * (c_api.h:22-36). */
#define C_API_DTYPE_FLOAT32 (0)
#define C_API_DTYPE_FLOAT64 (1)
#define C_API_DTYPE_INT32   (2)
#define C_API_DTYPE_INT64   (3)
#define C_API_PREDICT_NORMAL     (0)
#define C_API_PREDICT_RAW_SCORE  (1)
#define C_API_PREDICT_LEAF_INDEX (2)
#define C_API_PREDICT_CONTRIB    (3)

const char* LGBM_GetLastError();

/* datasets */
int LGBM_DatasetCreateFromFile(const char* filename, const char* parameters,
                               const DatasetHandle reference,
                               DatasetHandle* out);
int LGBM_DatasetCreateFromSampledColumn(double** sample_data,
                                        int** sample_indices, int32_t ncol,
                                        const int* num_per_col,
                                        int32_t num_sample_row,
                                        int32_t num_total_row,
                                        const char* parameters,
                                        DatasetHandle* out);
int LGBM_DatasetCreateByReference(const DatasetHandle reference,
                                  int64_t num_total_row,
                                  DatasetHandle* out);
int LGBM_DatasetPushRows(DatasetHandle dataset, const void* data,
                         int data_type, int32_t nrow, int32_t ncol,
                         int32_t start_row);
int LGBM_DatasetPushRowsByCSR(DatasetHandle dataset, const void* indptr,
                              int indptr_type, const int32_t* indices,
                              const void* data, int data_type,
                              int64_t nindptr, int64_t nelem,
                              int64_t num_col, int64_t start_row);
int LGBM_DatasetCreateFromCSR(const void* indptr, int indptr_type,
                              const int32_t* indices, const void* data,
                              int data_type, int64_t nindptr, int64_t nelem,
                              int64_t num_col, const char* parameters,
                              const DatasetHandle reference,
                              DatasetHandle* out);
int LGBM_DatasetCreateFromCSC(const void* col_ptr, int col_ptr_type,
                              const int32_t* indices, const void* data,
                              int data_type, int64_t ncol_ptr, int64_t nelem,
                              int64_t num_row, const char* parameters,
                              const DatasetHandle reference,
                              DatasetHandle* out);
int LGBM_DatasetCreateFromMat(const void* data, int data_type, int32_t nrow,
                              int32_t ncol, int is_row_major,
                              const char* parameters,
                              const DatasetHandle reference,
                              DatasetHandle* out);
int LGBM_DatasetGetSubset(const DatasetHandle handle,
                          const int32_t* used_row_indices,
                          int32_t num_used_row_indices,
                          const char* parameters, DatasetHandle* out);
int LGBM_DatasetSetFeatureNames(DatasetHandle handle,
                                const char** feature_names, int num);
/* The name-returning calls (DatasetGetFeatureNames, BoosterGetEvalNames,
 * BoosterGetFeatureNames) copy into caller-provided char** buffers with
 * no per-string length parameter (v2.1.0 API shape).  Each buffer must
 * be at least LGBM_TPU_MAX_NAME_LEN bytes; longer names are truncated at
 * a UTF-8 codepoint boundary and NUL-terminated. */
#define LGBM_TPU_MAX_NAME_LEN 256
int LGBM_DatasetGetFeatureNames(DatasetHandle handle, char** feature_names,
                                int* num_feature_names);
int LGBM_DatasetFree(DatasetHandle handle);
int LGBM_DatasetSaveBinary(DatasetHandle handle, const char* filename);
int LGBM_DatasetSetField(DatasetHandle handle, const char* field_name,
                         const void* field_data, int num_element, int type);
int LGBM_DatasetGetField(DatasetHandle handle, const char* field_name,
                         int* out_len, const void** out_ptr, int* out_type);
int LGBM_DatasetGetNumData(DatasetHandle handle, int* out);
int LGBM_DatasetGetNumFeature(DatasetHandle handle, int* out);

/* boosters */
int LGBM_BoosterCreate(const DatasetHandle train_data,
                       const char* parameters, BoosterHandle* out);
int LGBM_BoosterCreateFromModelfile(const char* filename, int* out_num_iters,
                                    BoosterHandle* out);
int LGBM_BoosterLoadModelFromString(const char* model_str,
                                    int* out_num_iterations,
                                    BoosterHandle* out);
int LGBM_BoosterFree(BoosterHandle handle);
int LGBM_BoosterMerge(BoosterHandle handle, BoosterHandle other_handle);
int LGBM_BoosterAddValidData(BoosterHandle handle,
                             const DatasetHandle valid_data);
int LGBM_BoosterResetTrainingData(BoosterHandle handle,
                                  const DatasetHandle train_data);
int LGBM_BoosterResetParameter(BoosterHandle handle, const char* parameters);
int LGBM_BoosterGetNumClasses(BoosterHandle handle, int* out_len);
int LGBM_BoosterUpdateOneIter(BoosterHandle handle, int* is_finished);
int LGBM_BoosterUpdateOneIterCustom(BoosterHandle handle, const float* grad,
                                    const float* hess, int* is_finished);
int LGBM_BoosterRollbackOneIter(BoosterHandle handle);
int LGBM_BoosterGetCurrentIteration(BoosterHandle handle, int* out);
int LGBM_BoosterNumberOfTotalModel(BoosterHandle handle, int* out_models);
int LGBM_BoosterGetEvalCounts(BoosterHandle handle, int* out_len);
int LGBM_BoosterGetEvalNames(BoosterHandle handle, int* out_len,
                             char** out_strs);
int LGBM_BoosterGetFeatureNames(BoosterHandle handle, int* out_len,
                                char** out_strs);
int LGBM_BoosterGetNumFeature(BoosterHandle handle, int* out_len);
int LGBM_BoosterGetEval(BoosterHandle handle, int data_idx, int* out_len,
                        double* out_results);
int LGBM_BoosterGetNumPredict(BoosterHandle handle, int data_idx,
                              int64_t* out_len);
int LGBM_BoosterGetPredict(BoosterHandle handle, int data_idx,
                           int64_t* out_len, double* out_result);
int LGBM_BoosterPredictForFile(BoosterHandle handle, const char* data_filename,
                               int data_has_header,
                               const char* result_filename, int predict_type,
                               int num_iteration);
int LGBM_BoosterCalcNumPredict(BoosterHandle handle, int num_row,
                               int predict_type, int num_iteration,
                               int64_t* out_len);
int LGBM_BoosterPredictForCSR(BoosterHandle handle, const void* indptr,
                              int indptr_type, const int32_t* indices,
                              const void* data, int data_type,
                              int64_t nindptr, int64_t nelem, int64_t num_col,
                              int predict_type, int num_iteration,
                              const char* parameter, int64_t* out_len,
                              double* out_result);
int LGBM_BoosterPredictForCSC(BoosterHandle handle, const void* col_ptr,
                              int col_ptr_type, const int32_t* indices,
                              const void* data, int data_type,
                              int64_t ncol_ptr, int64_t nelem, int64_t num_row,
                              int predict_type, int num_iteration,
                              const char* parameter, int64_t* out_len,
                              double* out_result);
int LGBM_BoosterPredictForMat(BoosterHandle handle, const void* data,
                              int data_type, int32_t nrow, int32_t ncol,
                              int is_row_major, int predict_type,
                              int num_iteration, const char* parameter,
                              int64_t* out_len, double* out_result);
int LGBM_BoosterSaveModel(BoosterHandle handle, int start_iteration,
                          int num_iteration, const char* filename);
int LGBM_BoosterSaveModelToString(BoosterHandle handle, int start_iteration,
                                  int num_iteration, int64_t buffer_len,
                                  int64_t* out_len, char* out_str);
int LGBM_BoosterDumpModel(BoosterHandle handle, int start_iteration,
                          int num_iteration, int64_t buffer_len,
                          int64_t* out_len, char* out_str);
int LGBM_BoosterGetLeafValue(BoosterHandle handle, int tree_idx,
                             int leaf_idx, double* out_val);
int LGBM_BoosterSetLeafValue(BoosterHandle handle, int tree_idx,
                             int leaf_idx, double val);
int LGBM_BoosterFeatureImportance(BoosterHandle handle, int num_iteration,
                                  int importance_type, double* out_results);

/* network */
int LGBM_NetworkInit(const char* machines, int local_listen_port,
                     int listen_time_out, int num_machines);
int LGBM_NetworkFree();
int LGBM_NetworkInitWithFunctions(int num_machines, int rank,
                                  void* reduce_scatter_ext_fun,
                                  void* allgather_ext_fun);

#ifdef __cplusplus
}
#endif

#endif  /* LIGHTGBM_TPU_TORCH_C_H_ */
