"""SHAP contributions (``pred_contrib``) through the native TreeSHAP
recursion (``lightgbm_tpu_torch/native``: ``treeshap_patterns`` over
``ltpu_treeshap``, the JAX package's C++ compiled into the port's own
library).

* With the native library present, the port's ``pred_contrib`` of a
  model the JAX package trained (loaded from its model text) is the JAX
  package's, bit for bit: both run the same C++ on the same decision
  patterns (binary with NaN-missing features, 3 classes, a truncation,
  and 127-leaf trees, whose decision patterns pack into more than one
  64-bit key: ``contrib._unique_rows``).
* The native and the Python recursions (the fallback of a host that
  cannot build the library) agree within ``tol("f64_chain")``, and each
  row's phis plus its expected value are the raw score.
"""
import numpy as np
import pytest
import torch

from tools.numcheck.tolerance_registry import tol

import lightgbm_tpu as jlgb

import lightgbm_tpu_torch as tlgb
from lightgbm_tpu_torch import native

torch.set_num_threads(1)   # tiny tensors: more threads only spin


def _pair(objective="binary", num_class=1, n=1500, f=6, seed=0,
          num_leaves=15):
    rng = np.random.RandomState(seed)
    X = rng.normal(size=(n, f))
    X[rng.rand(n, f) < 0.05] = np.nan
    z = np.nan_to_num(X[:, 0]) - 0.7 * np.nan_to_num(X[:, 1])
    if num_class > 1:
        y = np.digitize(z, [-0.5, 0.5]).astype(np.float32)
    else:
        y = (z + 0.3 * rng.normal(size=n) > 0).astype(np.float32)
    params = {"objective": objective, "num_leaves": num_leaves,
              "max_bin": 63,
              "min_data_in_leaf": 10, "verbose": -1}
    if num_class > 1:
        params["num_class"] = num_class
    jb = jlgb.train(params, jlgb.Dataset(X, label=y), 6)
    tb = tlgb.Booster(model_str=jb.model_to_string(), device="cpu")
    return jb, tb, X[:400]


@pytest.mark.parametrize("case,num_iteration", [
    (("binary", 1), -1), (("binary", 1), 3), (("multiclass", 3), -1),
    (("binary", 1, 1500, 6, 0, 127), -1)],
    ids=["binary", "binary_truncated", "multiclass3", "binary_127_leaves"])
def test_native_pred_contrib_equals_jax(case, num_iteration):
    assert native.available()
    jb, tb, X = _pair(*case)
    got = tb.predict(X, pred_contrib=True, num_iteration=num_iteration)
    want = jb.predict(X, pred_contrib=True, num_iteration=num_iteration)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", [("binary", 1), ("multiclass", 3)],
                         ids=["binary", "multiclass3"])
def test_native_and_python_recursions_agree(case, monkeypatch):
    assert native.available()
    _, tb, X = _pair(*case)
    got = tb.predict(X, pred_contrib=True)
    K = case[1]
    raw = tb.predict(X, raw_score=True).reshape(len(X), K)
    np.testing.assert_allclose(got.reshape(len(X), K, -1).sum(axis=2), raw,
                               rtol=0, atol=tol("f64_chain"))
    monkeypatch.setattr(native, "treeshap_patterns", lambda *a, **k: None)
    python = tb.predict(X, pred_contrib=True)
    np.testing.assert_allclose(got, python, rtol=0, atol=tol("f64_chain"))
