// A C host of the port's C API (lightgbm_tpu_torch/capi/): trains a binary
// model on rows read from raw float32 files, predicts, and saves the model,
// all through LGBM_* calls.  chip_smoke.py's phase 30 and the card test of
// tests/test_torch_cuda.py build and run it.
//
//   capi_train ROWS.f32 LABELS.f32 NROW NCOL ITERS DATASET_PARAMS
//              BOOSTER_PARAMS MODEL_OUT PRED_OUT NPRED [BEFORE AFTER]
//
// ROWS.f32 holds NROW x NCOL row-major float32 values, LABELS.f32 NROW
// float32 labels.  The Booster trains ITERS iterations
// (LGBM_BoosterUpdateOneIter), then predicts the first NPRED rows
// (LGBM_BoosterPredictForMat, float32 input) into PRED_OUT as float64 and
// saves the model (LGBM_BoosterSaveModel).  BEFORE and AFTER, when given,
// are Python statements run in the library's embedded interpreter just
// before LGBM_BoosterCreate and just after the last update (the smoke
// resets and reads its kernel launch counters there).  Prints
// "iterations=<n> train_s=<s> ms_per_iter=<ms> predict_s=<s>
// call_us=<us>" (call_us: the mean of 1,000 LGBM_BoosterGetCurrentIteration
// calls, the shim's own cost a call) and "CAPI_TRAIN_OK".
#include <Python.h>

#include <chrono>
#include <cstdio>
#include <cstdlib>
#include <vector>

#include "../lightgbm_tpu_torch/capi/lightgbm_tpu_torch_c.h"

#define CHECK(x)                                                      \
  do {                                                                \
    if ((x) != 0) {                                                   \
      std::fprintf(stderr, "FAIL %s: %s\n", #x, LGBM_GetLastError()); \
      return 1;                                                       \
    }                                                                 \
  } while (0)

static bool read_f32(const char* path, std::vector<float>* out) {
  FILE* f = std::fopen(path, "rb");
  if (f == nullptr) return false;
  size_t got = std::fread(out->data(), sizeof(float), out->size(), f);
  std::fclose(f);
  return got == out->size();
}

// Run Python statements in the library's interpreter (initialized by the
// first LGBM_* call); false when they raise.
static bool run_python(const char* code) {
  PyGILState_STATE gil = PyGILState_Ensure();
  int rc = PyRun_SimpleString(code);
  PyGILState_Release(gil);
  return rc == 0;
}

static double seconds_since(std::chrono::steady_clock::time_point t0) {
  return std::chrono::duration<double>(std::chrono::steady_clock::now() - t0)
      .count();
}

int main(int argc, char** argv) {
  if (argc != 11 && argc != 13) {
    std::fprintf(stderr, "usage: %s ROWS LABELS NROW NCOL ITERS DPARAMS "
                 "BPARAMS MODEL_OUT PRED_OUT NPRED [BEFORE AFTER]\n",
                 argv[0]);
    return 2;
  }
  const int nrow = std::atoi(argv[3]), ncol = std::atoi(argv[4]);
  const int iters = std::atoi(argv[5]), npred = std::atoi(argv[10]);
  if (nrow <= 0 || ncol <= 0 || iters <= 0 || npred < 0 || npred > nrow) {
    std::fprintf(stderr, "bad sizes\n");
    return 2;
  }
  std::vector<float> X((size_t)nrow * ncol), y((size_t)nrow);
  if (!read_f32(argv[1], &X) || !read_f32(argv[2], &y)) {
    std::fprintf(stderr, "cannot read %s or %s\n", argv[1], argv[2]);
    return 2;
  }

  DatasetHandle ds = nullptr;
  CHECK(LGBM_DatasetCreateFromMat(X.data(), C_API_DTYPE_FLOAT32, nrow, ncol,
                                  1, argv[6], nullptr, &ds));
  CHECK(LGBM_DatasetSetField(ds, "label", y.data(), nrow,
                             C_API_DTYPE_FLOAT32));
  if (argc == 13 && !run_python(argv[11])) return 1;
  auto t0 = std::chrono::steady_clock::now();
  BoosterHandle bst = nullptr;
  CHECK(LGBM_BoosterCreate(ds, argv[7], &bst));
  int finished = 0;
  for (int it = 0; it < iters && !finished; ++it)
    CHECK(LGBM_BoosterUpdateOneIter(bst, &finished));
  // the model's text waits for every tree: the clock stops there
  int64_t text_len = 0;
  CHECK(LGBM_BoosterSaveModelToString(bst, 0, -1, 0, &text_len, nullptr));
  double train_s = seconds_since(t0);
  if (argc == 13 && !run_python(argv[12])) return 1;
  // the shim's cost a call: the mutex, the GIL, one Python call
  const int kCalls = 1000;
  int cur = 0;
  auto tc = std::chrono::steady_clock::now();
  for (int i = 0; i < kCalls; ++i)
    CHECK(LGBM_BoosterGetCurrentIteration(bst, &cur));
  double call_us = 1e6 * seconds_since(tc) / kCalls;

  auto t1 = std::chrono::steady_clock::now();
  std::vector<double> pred((size_t)npred);
  int64_t out_len = 0;
  if (npred > 0)
    CHECK(LGBM_BoosterPredictForMat(bst, X.data(), C_API_DTYPE_FLOAT32,
                                    npred, ncol, 1, C_API_PREDICT_NORMAL, -1,
                                    "", &out_len, pred.data()));
  double predict_s = seconds_since(t1);
  if (out_len != npred) {
    std::fprintf(stderr, "predicted %lld values for %d rows\n",
                 (long long)out_len, npred);
    return 1;
  }
  FILE* pf = std::fopen(argv[9], "wb");
  if (pf == nullptr ||
      std::fwrite(pred.data(), sizeof(double), pred.size(), pf) !=
          pred.size()) {
    std::fprintf(stderr, "cannot write %s\n", argv[9]);
    return 1;
  }
  std::fclose(pf);
  CHECK(LGBM_BoosterSaveModel(bst, 0, -1, argv[8]));
  CHECK(LGBM_BoosterFree(bst));
  CHECK(LGBM_DatasetFree(ds));
  std::printf("iterations=%d train_s=%.6f ms_per_iter=%.4f predict_s=%.6f "
              "call_us=%.3f\n", cur, train_s,
              1e3 * train_s / (cur > 0 ? cur : 1), predict_s, call_us);
  std::printf("CAPI_TRAIN_OK\n");
  return 0;
}
