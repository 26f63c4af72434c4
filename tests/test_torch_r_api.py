"""The port's R shim (``lightgbm_tpu_torch/rpkg/src/``), compiled and
driven without an R toolchain.

The shim mirrors R's in-memory SEXP layout instead of including R's
headers (``r_object.h``, as the reference's ``R_object_helper.h``), so a
mock-R driver (a copy of ``tests/test_r_api.py``'s, with ``device=cpu``
in the Booster's parameters and ``LGBM_TPU_TORCH_DEVICE=cpu`` for the
reloaded model) builds the dataset, trains, evaluates, predicts and
reloads through the 38 ``LGBM_*_R`` entry points over the port's C API.
The model it saves is held to ``lightgbm_tpu.train`` on the same
column-major LCG rows and parameters, its kernels in Pallas interpret
mode.
"""
import os
import re
import subprocess

import numpy as np
import torch

import lightgbm_tpu as jlgb

import lightgbm_tpu_torch as tlgb
from lightgbm_tpu_torch.capi import build as capi_build

from tests.test_torch_capi import DRIVER_TIMEOUT_S

torch.set_num_threads(1)   # tiny tensors: more threads only spin

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
R_SRC = os.path.join(REPO, "lightgbm_tpu_torch", "rpkg", "src")
N_R_EXPORTS = 38

DRIVER = r"""
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>
#include "r_object.h"

/* the R entry points under test */
extern "C" {
LGBM_SE LGBM_GetLastError_R(LGBM_SE, LGBM_SE, LGBM_SE);
LGBM_SE LGBM_DatasetCreateFromMat_R(LGBM_SE, LGBM_SE, LGBM_SE, LGBM_SE,
                                    LGBM_SE, LGBM_SE, LGBM_SE);
LGBM_SE LGBM_DatasetSetField_R(LGBM_SE, LGBM_SE, LGBM_SE, LGBM_SE, LGBM_SE);
LGBM_SE LGBM_DatasetGetFieldSize_R(LGBM_SE, LGBM_SE, LGBM_SE, LGBM_SE);
LGBM_SE LGBM_DatasetGetNumData_R(LGBM_SE, LGBM_SE, LGBM_SE);
LGBM_SE LGBM_DatasetGetNumFeature_R(LGBM_SE, LGBM_SE, LGBM_SE);
LGBM_SE LGBM_DatasetSetFeatureNames_R(LGBM_SE, LGBM_SE, LGBM_SE);
LGBM_SE LGBM_DatasetGetFeatureNames_R(LGBM_SE, LGBM_SE, LGBM_SE, LGBM_SE,
                                      LGBM_SE);
LGBM_SE LGBM_BoosterCreate_R(LGBM_SE, LGBM_SE, LGBM_SE, LGBM_SE);
LGBM_SE LGBM_BoosterUpdateOneIter_R(LGBM_SE, LGBM_SE);
LGBM_SE LGBM_BoosterGetCurrentIteration_R(LGBM_SE, LGBM_SE, LGBM_SE);
LGBM_SE LGBM_BoosterGetEvalNames_R(LGBM_SE, LGBM_SE, LGBM_SE, LGBM_SE,
                                   LGBM_SE);
LGBM_SE LGBM_BoosterGetEval_R(LGBM_SE, LGBM_SE, LGBM_SE, LGBM_SE);
LGBM_SE LGBM_BoosterCalcNumPredict_R(LGBM_SE, LGBM_SE, LGBM_SE, LGBM_SE,
                                     LGBM_SE, LGBM_SE, LGBM_SE, LGBM_SE);
LGBM_SE LGBM_BoosterPredictForMat_R(LGBM_SE, LGBM_SE, LGBM_SE, LGBM_SE,
                                    LGBM_SE, LGBM_SE, LGBM_SE, LGBM_SE,
                                    LGBM_SE, LGBM_SE, LGBM_SE);
LGBM_SE LGBM_BoosterSaveModelToString_R(LGBM_SE, LGBM_SE, LGBM_SE, LGBM_SE,
                                        LGBM_SE, LGBM_SE);
LGBM_SE LGBM_BoosterLoadModelFromString_R(LGBM_SE, LGBM_SE, LGBM_SE);
LGBM_SE LGBM_BoosterFree_R(LGBM_SE, LGBM_SE);
LGBM_SE LGBM_DatasetFree_R(LGBM_SE, LGBM_SE);
}

/* ---- mock R allocator: same layout R uses for atomic vectors ---- */
static LGBM_SE mk(size_t payload_bytes, unsigned int type) {
  ltpu_ralign* p = (ltpu_ralign*)std::calloc(
      1, sizeof(ltpu_ralign) + payload_bytes);
  p->hdr.type = type;        /* non-zero: not R NULL */
  return (LGBM_SE)p;
}
static LGBM_SE mk_null() { return mk(8, 0); }          /* NILSXP */
static LGBM_SE mk_int(int v) {
  LGBM_SE x = mk(sizeof(int), 13);                     /* INTSXP */
  *ltpu_r_int(x) = v;
  return x;
}
static LGBM_SE mk_reals(size_t n) { return mk(n * 8, 14); } /* REALSXP */
static LGBM_SE mk_ints(size_t n) { return mk(n * 4, 13); }
static LGBM_SE mk_str(const char* s) {
  LGBM_SE x = mk(std::strlen(s) + 1, 9);               /* CHARSXP-ish */
  std::strcpy(ltpu_r_char(x), s);
  return x;
}
static LGBM_SE mk_buf(size_t n) { return mk(n, 9); }
static LGBM_SE mk_handle() { return mk(8, 13); }

static LGBM_SE cs;           /* shared call_state */
#define CHECK_R(call)                                            \
  do {                                                           \
    *ltpu_r_int(cs) = 0;                                         \
    (void)(call);                                                \
    if (*ltpu_r_int(cs) != 0) {                                  \
      LGBM_SE bl = mk_int(4096), al = mk_int(0), eb = mk_buf(4096); \
      LGBM_GetLastError_R(bl, al, eb);                           \
      std::printf("R_CALL_FAILED %s: %s\n", #call,               \
                  ltpu_r_char(eb));                              \
      return 1;                                                  \
    }                                                            \
  } while (0)

int main(int argc, char** argv) {
  if (argc < 2) return 2;
  cs = mk_int(0);
  const int n = 600, f = 4;
  /* column-major matrix, separable signal */
  LGBM_SE data = mk_reals((size_t)n * f);
  double* d = ltpu_r_real(data);
  LGBM_SE label = mk_reals(n);
  double* y = ltpu_r_real(label);
  unsigned int seed = 123;
  for (int i = 0; i < n; ++i) {
    double s = 0.0;
    for (int j = 0; j < f; ++j) {
      seed = seed * 1103515245u + 12345u;
      double v = ((seed >> 16) % 1000) / 500.0 - 1.0;
      d[(size_t)j * n + i] = v;        /* col-major */
      if (j < 2) s += v;
    }
    y[i] = s > 0 ? 1.0 : 0.0;
  }

  LGBM_SE ds = mk_handle();
  CHECK_R(LGBM_DatasetCreateFromMat_R(
      data, mk_int(n), mk_int(f),
      mk_str("max_bin=31 verbose=-1"), mk_null(), ds, cs));
  CHECK_R(LGBM_DatasetSetField_R(ds, mk_str("label"), label, mk_int(n),
                                 cs));
  LGBM_SE out_i = mk_int(0);
  CHECK_R(LGBM_DatasetGetNumData_R(ds, out_i, cs));
  std::printf("num_data=%d\n", *ltpu_r_int(out_i));
  CHECK_R(LGBM_DatasetGetNumFeature_R(ds, out_i, cs));
  std::printf("num_feature=%d\n", *ltpu_r_int(out_i));
  CHECK_R(LGBM_DatasetSetFeatureNames_R(ds, mk_str("a\tb\tc\tdd"), cs));
  LGBM_SE nbuf = mk_buf(4096);
  CHECK_R(LGBM_DatasetGetFeatureNames_R(ds, mk_int(4096), mk_int(0), nbuf,
                                        cs));
  std::printf("names=%s\n", ltpu_r_char(nbuf));
  CHECK_R(LGBM_DatasetGetFieldSize_R(ds, mk_str("label"), out_i, cs));
  std::printf("label_len=%d\n", *ltpu_r_int(out_i));

  LGBM_SE bst = mk_handle();
  CHECK_R(LGBM_BoosterCreate_R(
      ds, mk_str("objective=binary metric=binary_logloss num_leaves=7 "
                 "min_data_in_leaf=5 verbose=-1 device=cpu"), bst, cs));
  for (int it = 0; it < 5; ++it)
    CHECK_R(LGBM_BoosterUpdateOneIter_R(bst, cs));
  CHECK_R(LGBM_BoosterGetCurrentIteration_R(bst, out_i, cs));
  std::printf("iterations=%d\n", *ltpu_r_int(out_i));

  LGBM_SE ebuf = mk_buf(4096);
  CHECK_R(LGBM_BoosterGetEvalNames_R(bst, mk_int(4096), mk_int(0), ebuf,
                                     cs));
  std::printf("eval_names=%s\n", ltpu_r_char(ebuf));
  LGBM_SE evals = mk_reals(8);
  CHECK_R(LGBM_BoosterGetEval_R(bst, mk_int(0), evals, cs));
  std::printf("train_logloss=%.4f\n", ltpu_r_real(evals)[0]);

  LGBM_SE plen = mk_int(0);
  CHECK_R(LGBM_BoosterCalcNumPredict_R(bst, mk_int(n), mk_int(0),
                                       mk_int(0), mk_int(0), mk_int(-1),
                                       plen, cs));
  std::printf("pred_len=%d\n", *ltpu_r_int(plen));
  LGBM_SE preds = mk_reals((size_t)*ltpu_r_int(plen));
  CHECK_R(LGBM_BoosterPredictForMat_R(
      bst, data, mk_int(n), mk_int(f), mk_int(0), mk_int(0), mk_int(0),
      mk_int(-1), mk_str(""), preds, cs));
  int correct = 0;
  for (int i = 0; i < n; ++i)
    if ((ltpu_r_real(preds)[i] > 0.5) == (y[i] > 0.5)) ++correct;
  std::printf("acc=%.3f\n", (double)correct / n);

  /* save -> reload -> identical predictions */
  LGBM_SE mbuf = mk_buf(1 << 20);
  LGBM_SE alen = mk_int(0);
  CHECK_R(LGBM_BoosterSaveModelToString_R(bst, mk_int(-1),
                                          mk_int(1 << 20), alen, mbuf,
                                          cs));
  std::printf("model_len=%d\n", *ltpu_r_int(alen));
  FILE* mf = std::fopen(argv[1], "w");
  if (!mf) return 1;
  std::fputs(ltpu_r_char(mbuf), mf);
  std::fclose(mf);
  LGBM_SE bst2 = mk_handle();
  CHECK_R(LGBM_BoosterLoadModelFromString_R(mbuf, bst2, cs));
  LGBM_SE preds2 = mk_reals((size_t)*ltpu_r_int(plen));
  CHECK_R(LGBM_BoosterPredictForMat_R(
      bst2, data, mk_int(n), mk_int(f), mk_int(0), mk_int(0), mk_int(0),
      mk_int(-1), mk_str(""), preds2, cs));
  double maxdiff = 0.0;
  for (int i = 0; i < n; ++i) {
    double diff = ltpu_r_real(preds)[i] - ltpu_r_real(preds2)[i];
    if (diff < 0) diff = -diff;
    if (diff > maxdiff) maxdiff = diff;
  }
  std::printf("maxdiff=%.2e\n", maxdiff);

  CHECK_R(LGBM_BoosterFree_R(bst2, cs));
  CHECK_R(LGBM_BoosterFree_R(bst, cs));
  CHECK_R(LGBM_DatasetFree_R(ds, cs));
  std::printf("R_API_OK\n");
  return 0;
}
"""


def r_rows(n: int, f: int, seed: int):
    """The mock-R driver's rows: ``s = s * 1103515245 + 12345`` (mod
    2^32), ``((s >> 16) % 1000) / 500 - 1`` per value in row order (the
    driver stores them column-major), label ``x0 + x1 > 0``."""
    s = seed
    X = np.empty((n, f))
    for i in range(n):
        for j in range(f):
            s = (s * 1103515245 + 12345) & 0xFFFFFFFF
            X[i, j] = ((s >> 16) % 1000) / 500.0 - 1.0
    return X, (X[:, 0] + X[:, 1] > 0).astype(np.float32)


def test_r_shim_exports_every_entry_point():
    """The shim exports the 38 ``LGBM_*_R`` functions its source
    defines (the reference R package's ``.Call`` surface)."""
    src = open(os.path.join(R_SRC, "lightgbm_tpu_torch_R.cpp")).read()
    wanted = sorted(set(re.findall(r"LTPU_R_EXPORT LGBM_SE (LGBM_\w+_R)\(",
                                   src)))
    assert len(wanted) == N_R_EXPORTS
    syms = subprocess.run(["nm", "-D", str(capi_build.build(r=True))],
                          capture_output=True, text=True,
                          timeout=DRIVER_TIMEOUT_S).stdout
    missing = [w for w in wanted if f" T {w}" not in syms]
    assert not missing, missing


def test_r_shim_end_to_end(tmp_path, monkeypatch):
    """Mock-R driver: dataset from a column-major matrix, label field,
    feature names, training, eval, predict, save/reload through the R
    calling conventions (tab-joined strings, int64 handle payloads, the
    call_state error flag); the saved model is the JAX package's on the
    same rows and parameters."""
    lib = capi_build.build(r=True)
    src = tmp_path / "r_driver.cpp"
    src.write_text(DRIVER)
    driver = tmp_path / "r_driver"
    subprocess.run(["g++", "-O2", str(src), "-o", str(driver), f"-I{R_SRC}"]
                   + capi_build.link_args(lib), check=True,
                   timeout=DRIVER_TIMEOUT_S)
    model_path = tmp_path / "model.txt"
    out = subprocess.run([str(driver), str(model_path)],
                         env=capi_build.host_env(cpu=True),
                         capture_output=True, text=True,
                         timeout=DRIVER_TIMEOUT_S)
    assert out.returncode == 0, (out.stdout[-1000:], out.stderr[-800:])
    assert "R_API_OK" in out.stdout
    lines = dict(ln.split("=", 1) for ln in out.stdout.splitlines()
                 if "=" in ln)
    assert lines["num_data"] == "600" and lines["num_feature"] == "4"
    assert lines["names"] == "a\tb\tc\tdd"
    assert lines["label_len"] == "600"
    assert lines["iterations"] == "5"
    assert lines["pred_len"] == "600"
    assert float(lines["acc"]) > 0.9
    assert int(lines["model_len"]) > 100
    assert float(lines["maxdiff"]) < 1e-6
    # the model is the JAX package's on the same rows and parameters
    monkeypatch.setenv("LGBM_TPU_HIST_BACKEND", "compact")
    monkeypatch.setenv("LGBM_TPU_SPLIT_INTERPRET", "1")
    X, y = r_rows(600, 4, 123)
    jb = jlgb.train({"objective": "binary", "metric": "binary_logloss",
                     "num_leaves": 7, "min_data_in_leaf": 5, "verbose": -1},
                    jlgb.Dataset(X, label=y, params={"max_bin": 31}), 5)
    got = tlgb.Booster(model_file=str(model_path), device="cpu")
    want = tlgb.Booster(model_str=jb.model_to_string(), device="cpu")
    assert got.digest() == want.digest()
