"""Validation sets, metrics, early stopping, bagging and feature fraction
through ``lgb.train`` in both packages, at toy size on the CPU.

The JAX side runs its histogram, route and split kernels in Pallas
interpret mode (``LGBM_TPU_HIST_BACKEND=compact``,
``LGBM_TPU_SPLIT_INTERPRET=1``); the port runs their plain versions.

Two JAX runs serve as references.  With ``evals_result`` the JAX
package takes its per-iteration callback loop, the loop the port
implements: its per-iteration metrics are the reference for the port's
``evals_result`` (within ``tol("metric_coarse")``).  Without
``evals_result`` it takes its default fused-window path, whose compiled
score update is the fused multiply-add the port's update also makes
(the callback loop rounds the product first, an ulp apart): that run's
model is the reference for the port's digest, which must be equal, or
differ first at a near-tie classified by
``lightgbm_tpu.parallel.envelope.model_flip_report``.  ``best_iteration``
must be equal to both.
"""
import numpy as np
import pytest
import torch

from tools.numcheck.tolerance_registry import tol

import lightgbm_tpu as jlgb
from lightgbm_tpu.parallel.envelope import model_flip_report

import lightgbm_tpu_torch as tlgb
from lightgbm_tpu_torch.ops import histogram as t_hist
from lightgbm_tpu_torch.ops import route as t_route
from lightgbm_tpu_torch.ops import split_kernel as t_split

torch.set_num_threads(1)   # tiny tensors: more threads only spin

# examples/binary_classification/train.conf of the upstream project, as
# bench.py restates it, with its min_data_in_leaf / min_sum_hessian_in_leaf
TRAIN_CONF = {"objective": "binary", "metric": "binary_logloss,auc",
              "metric_freq": 1, "is_training_metric": True,
              "num_leaves": 63, "max_bin": 255, "learning_rate": 0.1,
              "feature_fraction": 0.8, "bagging_freq": 5,
              "bagging_fraction": 0.8, "min_data_in_leaf": 50,
              "min_sum_hessian_in_leaf": 5.0, "verbose": -1}


def _data(seed=0, n=3000, nv=600, f=6, noise=1.0):
    rng = np.random.RandomState(seed)
    X = rng.normal(size=(n + nv, f)).astype(np.float32)
    y = (X[:, 0] * 2 + X[:, 1] - X[:, 2]
         + rng.normal(scale=noise, size=n + nv) > 0).astype(np.float32)
    return X[:n], y[:n], X[n:], y[n:]


def _train(lgb, params, data, rounds, es, evals, **kw):
    X, y, Xv, yv = data
    ds = lgb.Dataset(X, label=y)
    vs = lgb.Dataset(Xv, label=yv, reference=ds)
    return lgb.train(dict(params), ds, num_boost_round=rounds,
                     valid_sets=[vs], valid_names=["valid"],
                     early_stopping_rounds=es, evals_result=evals,
                     verbose_eval=False, **kw)


def _check_against_reference(params, data, rounds, es):
    ref_evals, evals = {}, {}
    jcb = _train(jlgb, params, data, rounds, es, ref_evals)
    jfast = _train(jlgb, params, data, rounds, es, None)
    tb = _train(tlgb, params, data, rounds, es, evals, device="cpu")
    assert tb.best_iteration == jcb.best_iteration == jfast.best_iteration
    assert tb.current_iteration() == jcb.current_iteration
    assert set(evals) == set(ref_evals)
    for name, per_metric in ref_evals.items():
        assert set(evals[name]) == set(per_metric)
        for metric, ref in per_metric.items():
            np.testing.assert_allclose(evals[name][metric], ref,
                                       rtol=tol("metric_coarse"),
                                       atol=tol("metric_coarse"))
    dj = jfast.digest(include_scores=False)
    if tb.digest(include_scores=False) != dj:
        rep = model_flip_report(jfast.model_to_string(),
                                tb.model_to_string())
        assert rep["near_tie"], rep
    # best_iteration truncates prediction in both packages
    Xv = data[2]
    np.testing.assert_allclose(tb.predict(Xv), jfast.predict(Xv), rtol=0,
                               atol=tol("prob_coarse"))
    return tb, evals


def test_train_conf_slice_matches_reference(monkeypatch):
    """The reference example's configuration at toy size: both metrics on
    the training and the valid set, bagging re-drawn at iteration 5,
    feature fraction, early stopping armed."""
    monkeypatch.setenv("LGBM_TPU_HIST_BACKEND", "compact")
    monkeypatch.setenv("LGBM_TPU_SPLIT_INTERPRET", "1")
    calls = {w: w.plain_calls for w in (
        t_hist.hist_route_raw, t_route.route_rows_values_raw,
        t_split.find_best_splits_kernel)}
    tb, evals = _check_against_reference(TRAIN_CONF, _data(), 8, 10)
    assert all(w.plain_calls > c for w, c in calls.items())
    assert tb.best_iteration == 8
    assert set(evals) == {"training", "valid"}
    assert len(evals["valid"]["auc"]) == 8
    assert evals["valid"]["auc"][-1] > 0.9


def test_early_stopping_bagged_matches_reference(monkeypatch):
    """Bagging re-drawn every 2 iterations and feature fraction, on noisy
    labels at a high learning rate, so the valid metrics turn and early
    stopping ends the run."""
    monkeypatch.setenv("LGBM_TPU_HIST_BACKEND", "compact")
    monkeypatch.setenv("LGBM_TPU_SPLIT_INTERPRET", "1")
    params = {**TRAIN_CONF, "bagging_freq": 2, "learning_rate": 1.0,
              "num_leaves": 31, "max_bin": 63, "min_data_in_leaf": 5,
              "min_sum_hessian_in_leaf": 1e-3, "is_training_metric": False}
    tb, evals = _check_against_reference(
        params, _data(seed=1, n=2000, nv=400, noise=3.0), 12, 2)
    assert tb.best_iteration < tb.current_iteration() < 12
    assert set(evals) == {"valid"}


def test_early_stopping_needs_a_valid_set():
    X, y, _, _ = _data(n=500, nv=0)
    with pytest.raises(ValueError, match="validation set"):
        tlgb.train(TRAIN_CONF, tlgb.Dataset(X, label=y), num_boost_round=2,
                   early_stopping_rounds=2, verbose_eval=False,
                   device="cpu")
