"""The port's C API (``lightgbm_tpu_torch/capi/``): build the
embedded-interpreter shim and drive it from C programs on the CPU.

The C drivers are copies of ``tests/test_c_api.py``'s, with
``device=cpu`` in the Booster parameter strings and
``LGBM_TPU_TORCH_DEVICE=cpu`` in the environment (the CPU request for a
model loaded without a parameter string).  Every printed field is held
as the JAX package's test holds it, and the model the first driver saves
is held to ``lightgbm_tpu.train`` on the same LCG rows and parameters,
its kernels in Pallas interpret mode.  Without the CPU request a loaded
model's first prediction fails (this host has no card): the library does
not carry on on the CPU by itself.  ``LGBM_NetworkInitWithFunctions``
installs a one-rank allgather written in C, which the port's bin
finding then calls when it is handed it (no file load reaches it, as in
the JAX package: ROADMAP C34).
"""
import ctypes
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import lightgbm_tpu as jlgb
from lightgbm_tpu.io import distributed as jdist

import lightgbm_tpu_torch as tlgb
from lightgbm_tpu_torch import capi_bridge
from lightgbm_tpu_torch.capi import build as capi_build
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.io import distributed as tdist

torch.set_num_threads(1)   # tiny tensors: more threads only spin

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "lightgbm_tpu_torch")
DRIVER_TIMEOUT_S = 500
N_EXPORTS = 51

DRIVER = r"""
#include <stdio.h>
#include <stdlib.h>
#include <stdint.h>

typedef void* DatasetHandle;
typedef void* BoosterHandle;
#ifdef __cplusplus
extern "C" {
#endif
extern const char* LGBM_GetLastError();
extern int LGBM_DatasetCreateFromMat(const void*, int, int32_t, int32_t,
                                     int, const char*, DatasetHandle,
                                     DatasetHandle*);
extern int LGBM_DatasetSetField(DatasetHandle, const char*, const void*,
                                int, int);
extern int LGBM_DatasetGetNumData(DatasetHandle, int*);
extern int LGBM_DatasetGetNumFeature(DatasetHandle, int*);
extern int LGBM_BoosterCreate(DatasetHandle, const char*, BoosterHandle*);
extern int LGBM_BoosterUpdateOneIter(BoosterHandle, int*);
extern int LGBM_BoosterGetCurrentIteration(BoosterHandle, int*);
extern int LGBM_BoosterPredictForMat(BoosterHandle, const void*, int,
                                     int32_t, int32_t, int, int, int,
                                     const char*, int64_t*, double*);
extern int LGBM_BoosterSaveModel(BoosterHandle, int, int, const char*);
extern int LGBM_BoosterCreateFromModelfile(const char*, int*, BoosterHandle*);
extern int LGBM_BoosterFree(BoosterHandle);
extern int LGBM_DatasetFree(DatasetHandle);
#ifdef __cplusplus
}
#endif

#define CHECK(x) do { if ((x) != 0) { \
    fprintf(stderr, "FAIL %s: %s\n", #x, LGBM_GetLastError()); return 1; \
  } } while (0)

int main(int argc, char** argv) {
  const int n = 600, f = 4;
  double* X = (double*)malloc(sizeof(double) * n * f);
  float* y = (float*)malloc(sizeof(float) * n);
  unsigned s = 12345;
  for (int i = 0; i < n; ++i) {
    double row0 = 0;
    for (int j = 0; j < f; ++j) {
      s = s * 1103515245u + 12345u;
      double v = ((double)(s >> 8) / (1u << 24)) * 2.0 - 1.0;
      X[i * f + j] = v;
      if (j == 0) row0 = v;
    }
    y[i] = row0 > 0.0 ? 1.0f : 0.0f;
  }

  DatasetHandle ds = NULL;
  CHECK(LGBM_DatasetCreateFromMat(X, 1, n, f, 1, "max_bin=31", NULL, &ds));
  CHECK(LGBM_DatasetSetField(ds, "label", y, n, 0));
  int nd = 0, nf = 0;
  CHECK(LGBM_DatasetGetNumData(ds, &nd));
  CHECK(LGBM_DatasetGetNumFeature(ds, &nf));
  printf("num_data=%d num_feature=%d\n", nd, nf);

  BoosterHandle bst = NULL;
  CHECK(LGBM_BoosterCreate(ds,
        "objective=binary num_leaves=7 verbose=-1 device=cpu", &bst));
  int fin = 0;
  for (int it = 0; it < 5; ++it) CHECK(LGBM_BoosterUpdateOneIter(bst, &fin));
  int cur = 0;
  CHECK(LGBM_BoosterGetCurrentIteration(bst, &cur));
  printf("iterations=%d\n", cur);

  int64_t out_len = 0;
  double* pred = (double*)malloc(sizeof(double) * n);
  CHECK(LGBM_BoosterPredictForMat(bst, X, 1, n, f, 1, 0, -1, "",
                                  &out_len, pred));
  int correct = 0;
  for (int i = 0; i < n; ++i)
    if ((pred[i] > 0.5) == (y[i] > 0.5f)) ++correct;
  printf("out_len=%lld acc=%.4f\n", (long long)out_len,
         (double)correct / n);

  CHECK(LGBM_BoosterSaveModel(bst, 0, -1, argv[1]));
  BoosterHandle bst2 = NULL;
  int iters2 = 0;
  CHECK(LGBM_BoosterCreateFromModelfile(argv[1], &iters2, &bst2));
  double* pred2 = (double*)malloc(sizeof(double) * n);
  CHECK(LGBM_BoosterPredictForMat(bst2, X, 1, n, f, 1, 0, -1, "",
                                  &out_len, pred2));
  double maxdiff = 0;
  for (int i = 0; i < n; ++i) {
    double d = pred[i] - pred2[i];
    if (d < 0) d = -d;
    if (d > maxdiff) maxdiff = d;
  }
  printf("reload_iters=%d maxdiff=%.8f\n", iters2, maxdiff);

  CHECK(LGBM_BoosterFree(bst2));
  CHECK(LGBM_BoosterFree(bst));
  CHECK(LGBM_DatasetFree(ds));
  printf("C_API_OK\n");
  return 0;
}
"""


DRIVER_EXT = r"""
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <stdint.h>

typedef void* DatasetHandle;
typedef void* BoosterHandle;
#ifdef __cplusplus
extern "C" {
#endif
extern const char* LGBM_GetLastError();
extern int LGBM_DatasetCreateFromCSR(const void*, int, const int32_t*,
                                     const void*, int, int64_t, int64_t,
                                     int64_t, const char*, DatasetHandle,
                                     DatasetHandle*);
extern int LGBM_DatasetCreateFromSampledColumn(double**, int**, int32_t,
                                               const int*, int32_t, int32_t,
                                               const char*, DatasetHandle*);
extern int LGBM_DatasetPushRows(DatasetHandle, const void*, int, int32_t,
                                int32_t, int32_t);
extern int LGBM_DatasetSetField(DatasetHandle, const char*, const void*,
                                int, int);
extern int LGBM_DatasetGetField(DatasetHandle, const char*, int*,
                                const void**, int*);
extern int LGBM_DatasetGetNumData(DatasetHandle, int*);
extern int LGBM_DatasetGetSubset(DatasetHandle, const int32_t*, int32_t,
                                 const char*, DatasetHandle*);
extern int LGBM_DatasetSetFeatureNames(DatasetHandle, const char**, int);
extern int LGBM_DatasetGetFeatureNames(DatasetHandle, char**, int*);
extern int LGBM_DatasetSaveBinary(DatasetHandle, const char*);
extern int LGBM_DatasetFree(DatasetHandle);
extern int LGBM_BoosterCreate(DatasetHandle, const char*, BoosterHandle*);
extern int LGBM_BoosterAddValidData(BoosterHandle, DatasetHandle);
extern int LGBM_BoosterUpdateOneIter(BoosterHandle, int*);
extern int LGBM_BoosterUpdateOneIterCustom(BoosterHandle, const float*,
                                           const float*, int*);
extern int LGBM_BoosterRollbackOneIter(BoosterHandle);
extern int LGBM_BoosterGetCurrentIteration(BoosterHandle, int*);
extern int LGBM_BoosterNumberOfTotalModel(BoosterHandle, int*);
extern int LGBM_BoosterGetEvalCounts(BoosterHandle, int*);
extern int LGBM_BoosterGetEvalNames(BoosterHandle, int*, char**);
extern int LGBM_BoosterGetEval(BoosterHandle, int, int*, double*);
extern int LGBM_BoosterGetNumPredict(BoosterHandle, int, int64_t*);
extern int LGBM_BoosterGetPredict(BoosterHandle, int, int64_t*, double*);
extern int LGBM_BoosterCalcNumPredict(BoosterHandle, int, int, int,
                                      int64_t*);
extern int LGBM_BoosterPredictForCSR(BoosterHandle, const void*, int,
                                     const int32_t*, const void*, int,
                                     int64_t, int64_t, int64_t, int, int,
                                     const char*, int64_t*, double*);
extern int LGBM_BoosterPredictForFile(BoosterHandle, const char*, int,
                                      const char*, int, int);
extern int LGBM_BoosterSaveModelToString(BoosterHandle, int, int, int64_t,
                                         int64_t*, char*);
extern int LGBM_BoosterDumpModel(BoosterHandle, int, int, int64_t,
                                 int64_t*, char*);
extern int LGBM_BoosterLoadModelFromString(const char*, int*,
                                           BoosterHandle*);
extern int LGBM_BoosterMerge(BoosterHandle, BoosterHandle);
extern int LGBM_BoosterResetParameter(BoosterHandle, const char*);
extern int LGBM_BoosterGetLeafValue(BoosterHandle, int, int, double*);
extern int LGBM_BoosterSetLeafValue(BoosterHandle, int, int, double);
extern int LGBM_BoosterFeatureImportance(BoosterHandle, int, int, double*);
extern int LGBM_BoosterFree(BoosterHandle);
#ifdef __cplusplus
}
#endif

#define CHECK(x) do { if ((x) != 0) { \
    fprintf(stderr, "FAIL %s: %s\n", #x, LGBM_GetLastError()); return 1; \
  } } while (0)

int main(int argc, char** argv) {
  const int n = 400, f = 4;
  /* dense data for labels + CSR buffers (fully dense CSR) */
  double* X = (double*)malloc(sizeof(double) * n * f);
  float* y = (float*)malloc(sizeof(float) * n);
  int32_t* indptr = (int32_t*)malloc(sizeof(int32_t) * (n + 1));
  int32_t* indices = (int32_t*)malloc(sizeof(int32_t) * n * f);
  unsigned s = 7;
  indptr[0] = 0;
  for (int i = 0; i < n; ++i) {
    double row0 = 0;
    for (int j = 0; j < f; ++j) {
      s = s * 1103515245u + 12345u;
      double v = ((double)(s >> 8) / (1u << 24)) * 2.0 - 1.0;
      X[i * f + j] = v;
      indices[i * f + j] = j;
      if (j == 0) row0 = v;
    }
    indptr[i + 1] = (i + 1) * f;
    y[i] = row0 > 0.0 ? 1.0f : 0.0f;
  }

  /* ---- dataset from CSR ---- */
  DatasetHandle ds = NULL;
  CHECK(LGBM_DatasetCreateFromCSR(indptr, 2 /*int32*/, indices, X,
                                  1 /*f64*/, n + 1, (int64_t)n * f, f,
                                  "max_bin=31", NULL, &ds));
  CHECK(LGBM_DatasetSetField(ds, "label", y, n, 0));
  int nd = 0;
  CHECK(LGBM_DatasetGetNumData(ds, &nd));
  printf("csr_num_data=%d\n", nd);

  /* field round-trip */
  int flen = 0, ftype = 0;
  const void* fptr = NULL;
  CHECK(LGBM_DatasetGetField(ds, "label", &flen, &fptr, &ftype));
  printf("label_len=%d label0=%.1f\n", flen, ((const float*)fptr)[0]);

  /* feature names round-trip */
  const char* names_in[4] = {"a", "b", "c", "d"};
  CHECK(LGBM_DatasetSetFeatureNames(ds, names_in, f));
  char name_bufs[4][256];  /* LGBM_TPU_MAX_NAME_LEN */
  char* names_out[4] = {name_bufs[0], name_bufs[1], name_bufs[2],
                        name_bufs[3]};
  int n_names = 0;
  CHECK(LGBM_DatasetGetFeatureNames(ds, names_out, &n_names));
  printf("names=%d first=%s\n", n_names, names_out[0]);

  /* ---- streaming: sampled-column + push rows in two chunks ---- */
  DatasetHandle sds = NULL;
  CHECK(LGBM_DatasetCreateFromSampledColumn(NULL, NULL, f, NULL, 0, n,
                                            "max_bin=31", &sds));
  CHECK(LGBM_DatasetPushRows(sds, X, 1, n / 2, f, 0));
  CHECK(LGBM_DatasetPushRows(sds, X + (n / 2) * f, 1, n - n / 2, f,
                             n / 2));
  CHECK(LGBM_DatasetSetField(sds, "label", y, n, 0));
  int snd = 0;
  CHECK(LGBM_DatasetGetNumData(sds, &snd));
  printf("stream_num_data=%d\n", snd);

  /* ---- subset ---- */
  int32_t idx[100];
  for (int i = 0; i < 100; ++i) idx[i] = i * 2;
  DatasetHandle sub = NULL;
  CHECK(LGBM_DatasetGetSubset(ds, idx, 100, "", &sub));
  int subn = 0;
  CHECK(LGBM_DatasetGetNumData(sub, &subn));
  printf("subset_num_data=%d\n", subn);

  /* ---- booster with valid set + eval ---- */
  BoosterHandle bst = NULL;
  CHECK(LGBM_BoosterCreate(ds,
        "objective=binary num_leaves=7 metric=binary_logloss,auc verbose=-1 "
        "device=cpu",
        &bst));
  CHECK(LGBM_BoosterAddValidData(bst, sds));
  int fin = 0;
  for (int it = 0; it < 4; ++it) CHECK(LGBM_BoosterUpdateOneIter(bst, &fin));

  int eval_counts = 0;
  CHECK(LGBM_BoosterGetEvalCounts(bst, &eval_counts));
  char ename_bufs[8][256];  /* LGBM_TPU_MAX_NAME_LEN */
  char* enames[8];
  for (int i = 0; i < 8; ++i) enames[i] = ename_bufs[i];
  int n_enames = 0;
  CHECK(LGBM_BoosterGetEvalNames(bst, &n_enames, enames));
  double evals[8];
  int n_evals = 0;
  CHECK(LGBM_BoosterGetEval(bst, 1, &n_evals, evals));
  printf("eval_counts=%d eval_names=%d first_eval_name=%s valid_evals=%d\n",
         eval_counts, n_enames, enames[0], n_evals);

  /* ---- rollback ---- */
  int cur = 0;
  CHECK(LGBM_BoosterRollbackOneIter(bst));
  CHECK(LGBM_BoosterGetCurrentIteration(bst, &cur));
  int total_model = 0;
  CHECK(LGBM_BoosterNumberOfTotalModel(bst, &total_model));
  printf("after_rollback_iter=%d total_model=%d\n", cur, total_model);

  /* ---- custom-gradient update (plain logistic grads) ---- */
  int64_t npred = 0;
  CHECK(LGBM_BoosterGetNumPredict(bst, 0, &npred));
  double* train_pred = (double*)malloc(sizeof(double) * npred);
  int64_t got = 0;
  CHECK(LGBM_BoosterGetPredict(bst, 0, &got, train_pred));
  float* grad = (float*)malloc(sizeof(float) * npred);
  float* hess = (float*)malloc(sizeof(float) * npred);
  for (int64_t i = 0; i < npred; ++i) {
    double p = train_pred[i];
    grad[i] = (float)(p - y[i]);
    hess[i] = (float)(p * (1.0 - p));
  }
  CHECK(LGBM_BoosterUpdateOneIterCustom(bst, grad, hess, &fin));
  CHECK(LGBM_BoosterGetCurrentIteration(bst, &cur));
  printf("after_custom_iter=%d npred=%lld\n", cur, (long long)npred);

  /* ---- model string + dump + reload + merge ---- */
  int64_t out_len = 0;
  char* model_buf = (char*)malloc(1 << 20);
  CHECK(LGBM_BoosterSaveModelToString(bst, 0, -1, 1 << 20, &out_len,
                                      model_buf));
  printf("model_len=%lld\n", (long long)out_len);
  char* dump_buf = (char*)malloc(1 << 22);
  CHECK(LGBM_BoosterDumpModel(bst, 0, -1, 1 << 22, &out_len, dump_buf));
  printf("dump_starts_ok=%d\n", strncmp(dump_buf, "{", 1) == 0 ? 1 : 0);

  BoosterHandle bst2 = NULL;
  int iters2 = 0;
  CHECK(LGBM_BoosterLoadModelFromString(model_buf, &iters2, &bst2));
  int before_merge = 0, after_merge = 0;
  CHECK(LGBM_BoosterNumberOfTotalModel(bst2, &before_merge));
  CHECK(LGBM_BoosterMerge(bst2, bst2));
  CHECK(LGBM_BoosterNumberOfTotalModel(bst2, &after_merge));
  printf("reload_iters=%d merge=%d->%d\n", iters2, before_merge,
         after_merge);

  /* ---- leaf get/set ---- */
  double leaf = 0;
  CHECK(LGBM_BoosterGetLeafValue(bst, 0, 0, &leaf));
  CHECK(LGBM_BoosterSetLeafValue(bst, 0, 0, leaf * 2.0));
  double leaf2 = 0;
  CHECK(LGBM_BoosterGetLeafValue(bst, 0, 0, &leaf2));
  double lerr = leaf2 - 2.0 * leaf;
  if (lerr < 0) lerr = -lerr;
  double lmag = leaf < 0 ? -leaf : leaf;
  printf("leaf_doubled=%d\n", (lerr < 1e-9 + 1e-6 * lmag) ? 1 : 0);
  CHECK(LGBM_BoosterSetLeafValue(bst, 0, 0, leaf));

  /* ---- feature importance ---- */
  double imp[4];
  CHECK(LGBM_BoosterFeatureImportance(bst, -1, 0, imp));
  double imp_sum = imp[0] + imp[1] + imp[2] + imp[3];
  printf("imp_sum_pos=%d\n", imp_sum > 0 ? 1 : 0);

  /* ---- reset parameter ---- */
  CHECK(LGBM_BoosterResetParameter(bst, "learning_rate=0.05"));

  /* ---- predict for CSR + calc-num-predict ---- */
  int64_t calc = 0;
  CHECK(LGBM_BoosterCalcNumPredict(bst, n, 0, -1, &calc));
  double* predc = (double*)malloc(sizeof(double) * calc);
  int64_t lenc = 0;
  CHECK(LGBM_BoosterPredictForCSR(bst, indptr, 2, indices, X, 1, n + 1,
                                  (int64_t)n * f, f, 0, -1, "", &lenc,
                                  predc));
  int correct = 0;
  for (int i = 0; i < n; ++i)
    if ((predc[i] > 0.5) == (y[i] > 0.5f)) ++correct;
  printf("csr_pred_len=%lld csr_acc=%.4f\n", (long long)lenc,
         (double)correct / n);

  /* ---- predict for file ---- */
  FILE* df = fopen(argv[1], "w");
  for (int i = 0; i < 40; ++i) {
    fprintf(df, "%.1f", (double)y[i]);
    for (int j = 0; j < f; ++j) fprintf(df, ",%.6f", X[i * f + j]);
    fprintf(df, "\n");
  }
  fclose(df);
  CHECK(LGBM_BoosterPredictForFile(bst, argv[1], 0, argv[2], 0, -1));
  FILE* rf = fopen(argv[2], "r");
  int result_lines = 0;
  char line[256];
  while (fgets(line, sizeof(line), rf) != NULL) ++result_lines;
  fclose(rf);
  printf("file_pred_lines=%d\n", result_lines);

  /* ---- save binary ---- */
  CHECK(LGBM_DatasetSaveBinary(ds, argv[3]));

  CHECK(LGBM_BoosterFree(bst2));
  CHECK(LGBM_BoosterFree(bst));
  CHECK(LGBM_DatasetFree(sub));
  CHECK(LGBM_DatasetFree(sds));
  CHECK(LGBM_DatasetFree(ds));
  printf("C_API_EXT_OK\n");
  return 0;
}
"""


DRIVER_NET = r"""
#include <stdio.h>
#include <string.h>

extern "C" {
extern const char* LGBM_GetLastError();
extern int LGBM_NetworkInitWithFunctions(int, int, void*, void*);
extern int LGBM_NetworkInit(const char*, int, int, int);
extern int LGBM_NetworkFree();
}

/* a world of one: the only block is this rank's input */
static void allgather(char* input, int input_size, const int* block_start,
                      const int* block_len, int num_block, char* output,
                      int output_size) {
  memcpy(output + block_start[0], input, (size_t)block_len[0]);
}

#define CHECK(x) do { if ((x) != 0) { \
    fprintf(stderr, "FAIL %s: %s\n", #x, LGBM_GetLastError()); return 1; \
  } } while (0)

int main() {
  CHECK(LGBM_NetworkInitWithFunctions(1, 0, NULL, (void*)allgather));
  CHECK(LGBM_NetworkInit("", 0, 0, 1));
  CHECK(LGBM_NetworkFree());
  printf("NET_OK\n");
  return 0;
}
"""

ALLGATHER_LIB = r"""
#include <string.h>
int calls = 0;
extern "C" void allgather(char* input, int input_size,
                          const int* block_start, const int* block_len,
                          int num_block, char* output, int output_size) {
  ++calls;
  memcpy(output + block_start[0], input, (size_t)block_len[0]);
}
extern "C" int allgather_calls() { return calls; }
"""


@pytest.fixture(scope="module")
def shim():
    return capi_build.build()


def _driver(tmp_path, src_text, lib, name="driver"):
    src = tmp_path / f"{name}.cpp"
    src.write_text(src_text)
    exe = tmp_path / name
    subprocess.run(["g++", "-O2", str(src), "-o", str(exe)]
                   + capi_build.link_args(lib), check=True,
                   timeout=DRIVER_TIMEOUT_S)
    return exe


def _fields(stdout: str) -> dict:
    return dict(kv.split("=", 1) for ln in stdout.splitlines()
                for kv in ln.split() if "=" in kv)


def lcg_rows(n: int, f: int, seed: int):
    """The drivers' rows: ``s = s * 1103515245 + 12345`` (mod 2^32),
    ``((s >> 8) / 2^24) * 2 - 1`` per value, label ``x0 > 0``."""
    s = seed
    X = np.empty((n, f))
    for i in range(n):
        for j in range(f):
            s = (s * 1103515245 + 12345) & 0xFFFFFFFF
            X[i, j] = ((s >> 8) / float(1 << 24)) * 2.0 - 1.0
    return X, (X[:, 0] > 0).astype(np.float32)


def test_c_api_end_to_end(tmp_path, shim, monkeypatch):
    driver = _driver(tmp_path, DRIVER, shim)
    model_path = tmp_path / "model.txt"
    out = subprocess.run([str(driver), str(model_path)], env=capi_build.host_env(cpu=True),
                         capture_output=True, text=True,
                         timeout=DRIVER_TIMEOUT_S)
    assert out.returncode == 0, (out.stdout[-800:], out.stderr[-800:])
    assert "C_API_OK" in out.stdout
    lines = _fields(out.stdout)
    assert lines["num_data"] == "600" and lines["num_feature"] == "4"
    assert lines["iterations"] == "5"
    assert float(lines["acc"]) > 0.9
    assert float(lines["maxdiff"]) < 1e-5
    # the model is the JAX package's on the same rows and parameters
    monkeypatch.setenv("LGBM_TPU_HIST_BACKEND", "compact")
    monkeypatch.setenv("LGBM_TPU_SPLIT_INTERPRET", "1")
    X, y = lcg_rows(600, 4, 12345)
    jb = jlgb.train({"objective": "binary", "num_leaves": 7, "verbose": -1},
                    jlgb.Dataset(X, label=y, params={"max_bin": 31}), 5)
    got = tlgb.Booster(model_file=str(model_path), device="cpu")
    want = tlgb.Booster(model_str=jb.model_to_string(), device="cpu")
    assert got.digest() == want.digest()


def test_c_api_extended(tmp_path, shim):
    """CSR, streaming push-rows, eval, rollback, custom gradients, model
    string / dump / merge, leaf get and set, importance, prediction for
    CSR and for a file, through the port."""
    driver = _driver(tmp_path, DRIVER_EXT, shim, name="driver_ext")
    data_path = tmp_path / "pred_in.csv"
    result_path = tmp_path / "pred_out.tsv"
    bin_path = tmp_path / "ds_cache"
    out = subprocess.run(
        [str(driver), str(data_path), str(result_path), str(bin_path)],
        env=capi_build.host_env(cpu=True), capture_output=True, text=True,
        timeout=DRIVER_TIMEOUT_S)
    assert out.returncode == 0, (out.stdout[-1500:], out.stderr[-1500:])
    assert "C_API_EXT_OK" in out.stdout
    lines = _fields(out.stdout)
    assert lines["csr_num_data"] == "400"
    assert lines["stream_num_data"] == "400"
    assert lines["subset_num_data"] == "100"
    assert lines["label_len"] == "400" and lines["first"] == "a"
    assert int(lines["eval_counts"]) == 2          # logloss + auc
    assert int(lines["valid_evals"]) == 2
    assert lines["after_rollback_iter"] == "3"
    assert lines["total_model"] == "3"
    assert lines["after_custom_iter"] == "4"
    assert int(lines["model_len"]) > 100
    assert lines["dump_starts_ok"] == "1"
    assert lines["reload_iters"] == "4"
    assert lines["merge"] == "4->8"
    assert lines["leaf_doubled"] == "1"
    assert lines["imp_sum_pos"] == "1"
    assert lines["csr_pred_len"] == "400"
    assert float(lines["csr_acc"]) > 0.9
    assert lines["file_pred_lines"] == "40"
    assert result_path.exists()


def test_loaded_model_without_cpu_request_fails(tmp_path, shim):
    """A model loaded with no device request lives on the card: on a
    host without one its first prediction fails and the call returns
    -1."""
    if torch.cuda.is_available():
        pytest.skip("the host has a card: the loaded model predicts there")
    driver = _driver(tmp_path, DRIVER, shim)
    out = subprocess.run([str(driver), str(tmp_path / "model.txt")],
                         env=capi_build.host_env(), capture_output=True,
                         text=True, timeout=DRIVER_TIMEOUT_S)
    assert out.returncode == 1
    assert "FAIL LGBM_BoosterPredictForMat(bst2" in out.stderr
    assert "C_API_OK" not in out.stdout


def test_network_init_with_functions(tmp_path, shim):
    driver = _driver(tmp_path, DRIVER_NET, shim, name="driver_net")
    out = subprocess.run([str(driver)], env=capi_build.host_env(cpu=True), capture_output=True,
                         text=True, timeout=DRIVER_TIMEOUT_S)
    assert out.returncode == 0, (out.stdout[-800:], out.stderr[-800:])
    assert "NET_OK" in out.stdout


def test_external_allgather_carries_bin_finding(tmp_path):
    """The C allgather installed through the bridge carries the bin
    finding's collective when it is handed one: a world of one bins as
    the JAX package does through its own wrapper of the same C function.
    No file load reaches it, in either package (ROADMAP C34)."""
    src = tmp_path / "ag.cpp"
    src.write_text(ALLGATHER_LIB)
    lib_path = tmp_path / "libag.so"
    subprocess.run(["g++", "-O2", "-shared", "-fPIC", str(src), "-o",
                    str(lib_path)], check=True, timeout=DRIVER_TIMEOUT_S)
    lib = ctypes.CDLL(str(lib_path))
    addr = ctypes.cast(lib.allgather, ctypes.c_void_p).value
    try:
        capi_bridge.network_init_with_functions(1, 0, 0, addr)
        ext = tdist.external_collectives()
        assert ext.allgather({"rows": [1, 2]}) == [{"rows": [1, 2]}]
        assert lib.allgather_calls() == 2      # sizes, then payloads
        rng = np.random.RandomState(0)
        X = rng.normal(size=(300, 4))
        cfg = Config.from_params({"max_bin": 15})
        got = tdist.find_bins_distributed(X, cfg, 0, 1, ext.allgather)
        jext = jdist.ExternalCollectives(1, 0, 0, addr)
        want = jdist.find_bins_distributed(X, cfg, 0, 1, jext.allgather)
        assert [m.to_dict() for m in got] == [m.to_dict() for m in want]
    finally:
        tdist._external[0] = None


def test_shim_exports_the_header():
    """The header declares the JAX package's functions (the reference's
    51 and more) and the shim defines each."""
    header = open(os.path.join(PKG, "capi", "lightgbm_tpu_torch_c.h")).read()
    exported = re.findall(r"int (LGBM_\w+)\(", header)
    jax_header = open(os.path.join(REPO, "lightgbm_tpu", "capi",
                                   "lightgbm_tpu_c.h")).read()
    assert exported == re.findall(r"int (LGBM_\w+)\(", jax_header)
    assert len(exported) >= N_EXPORTS
    syms = subprocess.run(["nm", "-D", str(capi_build.build())],
                          capture_output=True, text=True,
                          timeout=DRIVER_TIMEOUT_S).stdout
    missing = [fn for fn in exported + ["LGBM_GetLastError"]
               if f" T {fn}" not in syms]
    assert not missing, missing


def test_port_names_no_jax_module():
    """No file of the port imports or names the JAX package as a module
    (the shim's import string is the likeliest to be copied wrong)."""
    pat = re.compile(r"\blightgbm_tpu\.[A-Za-z_]|"
                     r"^\s*(import|from)\s+(jax|lightgbm_tpu)\b")
    bad = []
    for root, _, files in os.walk(PKG):
        if "_build" in root or "__pycache__" in root:
            continue
        for name in files:
            if name.endswith((".py", ".cpp", ".h", ".i", ".cu", ".cuh")):
                path = os.path.join(root, name)
                for i, line in enumerate(open(path, errors="replace"), 1):
                    if pat.search(line):
                        bad.append(f"{os.path.relpath(path, REPO)}:{i}: "
                                   f"{line.strip()}")
    assert not bad, bad
