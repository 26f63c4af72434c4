"""The reproducibility contract of lightgbm_tpu_torch
(``obs/determinism.py``, ``LGBM_TPU_DETERMINISM=1``) against the JAX
package's, on the CPU.

The RNG ledger's site counts equal the JAX package's for bagging,
feature fraction, DART, GOSS, random forests and ``cv`` (the JAX
package's GOSS records its draws on its per-iteration path,
``LGBM_TPU_NO_BLOCK=1``; its fused block draws them inside the scan
without a ledger entry).  Two port runs give equal window-digest
ledgers; a ``det.rng_drift`` fault makes the first divergent window the
JAX package's; the legacy DART stream (``LGBM_TPU_DART_HOST_RNG=1``)
trains the JAX package's L2 model.  The JAX side runs its reference
kernels in interpret mode (``LGBM_TPU_HIST_BACKEND=compact``,
``LGBM_TPU_SPLIT_INTERPRET=1``), as the port's parity tests do.
"""
import numpy as np
import pytest
import torch

import lightgbm_tpu as jlgb
from lightgbm_tpu.obs import determinism as jdet
from lightgbm_tpu.utils import faults as jfaults

import lightgbm_tpu_torch as tlgb
from lightgbm_tpu_torch import obs as tobs
from lightgbm_tpu_torch.obs import determinism as tdet
from lightgbm_tpu_torch.utils import faults as tfaults

torch.set_num_threads(1)   # tiny tensors: more threads only spin

BASE = {"num_leaves": 7, "max_bin": 63, "min_data_in_leaf": 20,
        "verbose": -1}
DART = {"boosting": "dart", "drop_rate": 0.3, "skip_drop": 0.2}
SITES = {
    "bagging": {"bagging_freq": 1, "bagging_fraction": 0.7},
    "feature_fraction": {"feature_fraction": 0.6},
    "dart": DART,
    "goss": {"boosting": "goss"},
    "rf": {"boosting": "rf", "bagging_freq": 1, "bagging_fraction": 0.7},
}
ROUNDS = 6


@pytest.fixture(autouse=True)
def _contract(monkeypatch):
    monkeypatch.setenv("LGBM_TPU_DETERMINISM", "1")
    monkeypatch.setenv("LGBM_TPU_HIST_BACKEND", "compact")
    monkeypatch.setenv("LGBM_TPU_SPLIT_INTERPRET", "1")
    monkeypatch.delenv("LGBM_TPU_DART_HOST_RNG", raising=False)
    for m in (jdet, tdet):
        m.reset()
    jfaults.clear()
    tfaults.clear()
    yield
    jfaults.clear()
    tfaults.clear()
    tobs.reset()


def _data(objective="binary", n=600, f=6, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.normal(size=(n, f)).astype(np.float32)
    z = X[:, 0] * 2 + X[:, 1] - X[:, 2] + rng.normal(size=n)
    if objective == "binary":
        return X, (z > 0).astype(np.float32), {"objective": "binary"}
    return X, z.astype(np.float32), {"objective": "regression"}


def _port(params, X, y, rounds=ROUNDS):
    tdet.reset()
    bst = tlgb.train(dict(params), tlgb.Dataset(X, label=y), rounds,
                     verbose_eval=False, device="cpu")
    return bst, tdet.section()


def _jax(params, X, y, rounds=ROUNDS):
    jdet.reset()
    bst = jlgb.train(dict(params), jlgb.Dataset(X, label=y), rounds,
                     verbose_eval=False)
    return bst, jdet.section()


@pytest.mark.parametrize("case", list(SITES))
def test_rng_ledger_sites_match_reference(case, monkeypatch):
    X, y, p = _data()
    params = {**BASE, **p, **SITES[case]}
    if case == "goss":
        monkeypatch.setenv("LGBM_TPU_NO_BLOCK", "1")
    _, js = _jax(params, X, y)
    _, ts = _port(params, X, y)
    assert js["sites"], "the reference recorded no site"
    assert ts["sites"] == js["sites"]


def test_rng_ledger_cv_matches_reference():
    X, y, p = _data()
    params = {**BASE, **p}
    jlgb.cv(dict(params), jlgb.Dataset(X, label=y), 3, nfold=3)
    tlgb.cv(dict(params), tlgb.Dataset(X, label=y), 3, nfold=3,
            device="cpu")
    assert tdet.section()["sites"] == jdet.section()["sites"] == {
        "engine.cv_folds": {"key_path": "seed/salt", "count": 1}}


@pytest.mark.parametrize("case", ["bagging", "dart", "goss"])
def test_two_port_runs_give_equal_ledgers(case):
    X, y, p = _data()
    params = {**BASE, **p, **SITES[case]}
    _, a = _port(params, X, y)
    _, b = _port(params, X, y)
    assert len(a["digests"]) == ROUNDS
    assert [it for it, _ in a["digests"]] == list(range(1, ROUNDS + 1))
    assert tdet.first_divergence(a["digests"], b["digests"]) is None
    assert a == b


def test_l2_window_ledger_equals_reference():
    """L2 scores are bitwise (C8): with a valid set evaluated every
    iteration the JAX package's windows are single iterations, and its
    digest ledger equals the port's entry for entry."""
    X, y, p = _data("regression")
    params = {**BASE, **p, "metric": "l2"}
    jdet.reset()
    jlgb.train(dict(params), jlgb.Dataset(X, label=y), ROUNDS,
               valid_sets=[jlgb.Dataset(X[:200], label=y[:200])],
               verbose_eval=False)
    tdet.reset()
    tlgb.train(dict(params), tlgb.Dataset(X, label=y), ROUNDS,
               valid_sets=[tlgb.Dataset(X[:200], label=y[:200])],
               verbose_eval=False, device="cpu")
    assert tdet.section()["digests"] == jdet.section()["digests"]


@pytest.mark.parametrize("skip", [2, 4])
def test_rng_drift_first_divergence_matches_reference(skip):
    X, y, p = _data("regression")
    params = {**BASE, **p, **DART, "drop_rate": 0.5, "skip_drop": 0.0}
    rounds = 8
    _, jclean = _jax(params, X, y, rounds)
    jfaults.inject("det.rng_drift", times=1, skip=skip)
    _, jdrift = _jax(params, X, y, rounds)
    _, tclean = _port(params, X, y, rounds)
    tfaults.inject("det.rng_drift", times=1, skip=skip)
    _, tdrift = _port(params, X, y, rounds)
    assert tfaults.fired("det.rng_drift") == 1
    jdiv = jdet.first_divergence(jclean["digests"], jdrift["digests"])
    tdiv = tdet.first_divergence(tclean["digests"], tdrift["digests"])
    assert jdiv is not None and tdiv is not None
    assert tdiv[0] == jdiv[0]
    # the clean ledgers agree up to the drift, the packages' L2 DART
    # models being bitwise
    assert tclean["digests"] == jclean["digests"]


def test_dart_host_rng_l2_matches_reference(monkeypatch):
    monkeypatch.setenv("LGBM_TPU_DART_HOST_RNG", "1")
    X, y, p = _data("regression", n=1000)
    params = {**BASE, **p, **DART}
    jb, _ = _jax(params, X, y, 10)
    tb, ts = _port(params, X, y, 10)
    assert tb.model_to_string() == jb.model_to_string()
    assert tb.digest() == jb.digest()
    # the legacy stream is not a keyed site
    assert "dart.drop" not in ts["sites"]
    monkeypatch.delenv("LGBM_TPU_DART_HOST_RNG")
    kb, _ = _port(params, X, y, 10)
    assert kb.digest() != tb.digest()


def test_first_divergence_is_reference():
    a = [[1, "x"], [2, "y"], [3, "z"]]
    for b in ([[1, "x"], [2, "y"], [3, "z"]], [[1, "x"], [2, "q"]],
              [[1, "x"]], [[1, "x"], [2, "y"], [3, "z"], [4, "w"]]):
        assert tdet.first_divergence(a, b) == jdet.first_divergence(a, b)
