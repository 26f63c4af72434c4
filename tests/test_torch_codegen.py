"""Model -> C++ if-else code generation of the port
(``lightgbm_tpu_torch/models/codegen.py``), on port-trained models.

The reference CI's gate (``.travis/test.sh:60-64``), as
``tests/test_codegen.py`` runs it for the JAX package: emit, compile
with ``g++ -shared``, call through ctypes, and hold the compiled
prediction to ``predict(raw_score=True)`` within ``CODEGEN_TOL`` (1e-5,
the reference CI's).  The emitted text must also be the JAX emitter's
on the same model string.
"""
import ctypes
import os
import shutil
import subprocess
import tempfile

import numpy as np
import pytest
import torch

from lightgbm_tpu.basic import Booster as JaxBooster
from lightgbm_tpu.models.codegen import model_to_ifelse as jax_ifelse

import lightgbm_tpu_torch as tlgb
from lightgbm_tpu_torch.models.codegen import model_to_ifelse

torch.set_num_threads(1)   # tiny tensors: more threads only spin

CODEGEN_TOL = 1e-5          # the reference CI's gate
COMPILE_TIMEOUT_S = 300


def compile_and_predict(code: str, X: np.ndarray, K: int) -> np.ndarray:
    """``Predict(row, out)`` of the emitted C++ on every row of ``X``."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed")
    with tempfile.TemporaryDirectory() as d:
        src = os.path.join(d, "model.cc")
        lib = os.path.join(d, "model.so")
        with open(src, "w") as f:
            f.write(code)
        subprocess.run(["g++", "-O1", "-shared", "-fPIC", "-o", lib, src],
                       check=True, timeout=COMPILE_TIMEOUT_S)
        so = ctypes.CDLL(lib)
        so.Predict.argtypes = [ctypes.POINTER(ctypes.c_double),
                               ctypes.POINTER(ctypes.c_double)]
        out = np.zeros((len(X), K))
        row = np.zeros(X.shape[1], np.float64)
        obuf = np.zeros(K, np.float64)
        for r in range(len(X)):
            row[:] = X[r]
            so.Predict(row.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                       obuf.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
            out[r] = obuf
        return out


def _check(bst, Xt, K):
    code = model_to_ifelse(bst._gbdt)
    text = bst.model_to_string()
    assert code == jax_ifelse(JaxBooster(model_str=text)._gbdt)
    got = compile_and_predict(code, Xt, K)
    want = bst.predict(Xt, raw_score=True).reshape(len(Xt), K)
    np.testing.assert_allclose(got, want, rtol=0, atol=CODEGEN_TOL)
    # a loaded model emits the same text
    assert model_to_ifelse(tlgb.Booster(model_str=text,
                                        device="cpu")._gbdt) == code


def test_codegen_binary_with_nans():
    rng = np.random.RandomState(0)
    n = 1500
    X = rng.normal(size=(n, 6))
    X[rng.rand(n, 6) < 0.1] = np.nan          # missing-value handling
    y = (np.nan_to_num(X[:, 0]) + np.nan_to_num(X[:, 1]) > 0).astype(
        np.float32)
    bst = tlgb.train({"objective": "binary", "num_leaves": 15,
                      "num_iterations": 5, "verbose": -1},
                     tlgb.Dataset(X, label=y), device="cpu")
    Xt = rng.normal(size=(300, 6))
    Xt[rng.rand(300, 6) < 0.1] = np.nan
    _check(bst, Xt, 1)


def test_codegen_multiclass_categorical():
    rng = np.random.RandomState(1)
    n = 1200
    Xnum = rng.normal(size=(n, 3))
    Xcat = rng.randint(0, 6, size=(n, 1)).astype(np.float64)
    X = np.concatenate([Xnum, Xcat], axis=1)
    y = ((Xcat[:, 0] % 3).astype(np.int32)
         + (Xnum[:, 0] > 1).astype(np.int32)) % 3
    bst = tlgb.train({"objective": "multiclass", "num_class": 3,
                      "num_leaves": 7, "num_iterations": 3, "verbose": -1},
                     tlgb.Dataset(X, label=y.astype(np.float32),
                                  categorical_feature=[3]), device="cpu")
    assert any(t.num_cat > 0 for t in bst._gbdt.models)
    Xt = np.concatenate([rng.normal(size=(200, 3)),
                         rng.randint(0, 8, size=(200, 1)).astype(np.float64)],
                        axis=1)
    _check(bst, Xt, 3)
