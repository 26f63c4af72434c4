"""The port's scikit-learn estimators (``lightgbm_tpu_torch/sklearn.py``)
held against the JAX package's at toy size on the CPU, and against the
port's own ``lgb.train``.

The estimators record ``evals_result``, so the JAX package trains them
on its per-iteration loop, whose score update rounds ``lr * value``
before the add, where the port makes the fused multiply-add (ROADMAP
C3): models are compared as ``tests/test_torch_valid.py`` compares that
loop's (equal digests, or a first divergence that ``model_flip_report``
classifies as a near tie), predictions within ``tol("prob_coarse")``.
Against the port's ``lgb.train`` with the parameters the estimator maps
to, the model is bitwise the same.
"""
import numpy as np
import pytest
import torch

from tools.numcheck.tolerance_registry import tol

import lightgbm_tpu as jlgb
from lightgbm_tpu.parallel.envelope import model_flip_report

import lightgbm_tpu_torch as tlgb

torch.set_num_threads(1)   # tiny tensors: more threads only spin

EST = {"n_estimators": 6, "num_leaves": 15, "max_bin": 63, "verbose": -1}


@pytest.fixture(autouse=True)
def _reference_kernels(monkeypatch):
    monkeypatch.setenv("LGBM_TPU_HIST_BACKEND", "compact")
    monkeypatch.setenv("LGBM_TPU_SPLIT_INTERPRET", "1")


def _xy(n=1500, f=6, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.normal(size=(n, f)).astype(np.float32)
    y = (X[:, 0] * 2 + X[:, 1] - X[:, 2]
         + 0.5 * rng.normal(size=n)).astype(np.float32)
    return X, y


def _same_model(jm, tm):
    jb, tb = jm.booster_, tm.booster_
    if tb.digest(include_scores=False) != jb.digest(include_scores=False):
        rep = model_flip_report(jb.model_to_string(), tb.model_to_string())
        assert rep["near_tie"], rep


def _pair(name, **kw):
    return (getattr(jlgb, name)(**kw),
            getattr(tlgb, name)(device="cpu", **kw))


def _train_params(**extra):
    """What ``LGBMModel._process_params`` maps ``EST`` to."""
    p = {"boosting_type": "gbdt", "num_leaves": 15, "max_depth": -1,
         "learning_rate": 0.1, "bin_construct_sample_cnt": 200000,
         "min_gain_to_split": 0.0, "min_sum_hessian_in_leaf": 1e-3,
         "min_data_in_leaf": 20, "bagging_fraction": 1.0, "bagging_freq": 0,
         "feature_fraction": 1.0, "lambda_l1": 0.0, "lambda_l2": 0.0,
         "max_bin": 63, "verbose": -1}
    p.update(extra)
    return p


def test_regressor_matches_reference_and_train():
    X, y = _xy()
    jm, tm = _pair("LGBMRegressor", **EST)
    jm.fit(X, y)
    tm.fit(X, y)
    _same_model(jm, tm)
    np.testing.assert_allclose(tm.predict(X), jm.predict(X), rtol=0,
                               atol=tol("prob_coarse"))
    ref = tlgb.train(_train_params(objective="regression"),
                     tlgb.Dataset(X, label=y), 6, verbose_eval=False,
                     device="cpu")
    assert tm.booster_.digest() == ref.digest()
    np.testing.assert_array_equal(tm.predict(X), ref.predict(X))


@pytest.mark.parametrize("classes", [2, 3])
def test_classifier_matches_reference_and_train(classes):
    X, y = _xy(seed=1)
    if classes == 2:
        yc = np.where(y > 0, "pos", "neg")
    else:
        yc = np.digitize(y, np.quantile(y, [1 / 3, 2 / 3])) + 10
    jm, tm = _pair("LGBMClassifier", **EST)
    jm.fit(X, yc)
    tm.fit(X, yc)
    _same_model(jm, tm)
    assert list(tm.classes_) == list(jm.classes_)
    assert tm.n_classes_ == classes
    np.testing.assert_allclose(tm.predict_proba(X), jm.predict_proba(X),
                               rtol=0, atol=tol("prob_coarse"))
    assert np.mean(tm.predict(X) == jm.predict(X)) > 0.99
    label = np.searchsorted(tm.classes_, yc).astype(np.float32)
    extra = ({"objective": "binary"} if classes == 2 else
             {"objective": "multiclass", "num_class": classes})
    ref = tlgb.train(_train_params(**extra), tlgb.Dataset(X, label=label), 6,
                     verbose_eval=False, device="cpu")
    assert tm.booster_.digest() == ref.digest()
    proba = tm.predict_proba(X)
    if classes == 2:
        np.testing.assert_array_equal(proba[:, 1], ref.predict(X))
    else:
        np.testing.assert_array_equal(proba, ref.predict(X))


def test_ranker_matches_reference():
    rng = np.random.RandomState(5)
    nq, per = 30, 20
    X = rng.normal(size=(nq * per, 5)).astype(np.float32)
    y = np.clip((X[:, 0] * 2 + rng.normal(size=nq * per)).round(), 0, 3)
    group = np.full(nq, per)
    jm, tm = _pair("LGBMRanker", **EST)
    jm.fit(X, y, group=group)
    tm.fit(X, y, group=group)
    _same_model(jm, tm)
    np.testing.assert_allclose(tm.predict(X), jm.predict(X), rtol=0,
                               atol=tol("prob_coarse"))
    with pytest.raises(ValueError, match="group"):
        tlgb.LGBMRanker(device="cpu").fit(X, y)


def test_callable_objective():
    """A scikit-learn style ``objective(y_true, y_pred)``: the JAX
    package's model, and the built-in L2 model bitwise (no
    ``boost_from_average`` for a custom objective)."""
    X, y = _xy()

    def l2(y_true, y_pred):
        return y_pred - y_true, np.ones_like(y_pred)

    jm, tm = _pair("LGBMRegressor", objective=l2, **EST)
    jm.fit(X, y)
    tm.fit(X, y)
    _same_model(jm, tm)
    builtin = tlgb.LGBMRegressor(device="cpu", boost_from_average=False,
                                 **EST).fit(X, y)
    assert tm.booster_.digest() == builtin.booster_.digest()


def test_eval_set_early_stopping_matches_reference():
    X, y = _xy(seed=1)
    Xv, yv = _xy(n=400, seed=2)
    kw = dict(EST, n_estimators=60, learning_rate=0.5, min_child_samples=5)
    jm, tm = _pair("LGBMRegressor", **kw)
    fit = dict(eval_set=[(Xv, yv)], eval_metric="l2",
               early_stopping_rounds=3)
    jm.fit(X, y, **fit)
    tm.fit(X, y, **fit)
    assert tm.best_iteration_ == jm.best_iteration_ < 60
    ref = jm.evals_result_["valid_0"]["l2"]
    got = tm.evals_result_["valid_0"]["l2"]
    np.testing.assert_allclose(got, ref, rtol=tol("metric_coarse"),
                               atol=tol("metric_coarse"))
    _same_model(jm, tm)


def test_eval_metric_callable():
    X, y = _xy()

    def mae(y_true, y_pred):
        return "mae", float(np.mean(np.abs(y_true - y_pred))), False
    tm = tlgb.LGBMRegressor(device="cpu", **EST).fit(
        X, y, eval_set=[(X, y)], eval_metric=mae)
    assert list(tm.evals_result_["valid_0"]) == ["l2", "mae"]


def test_class_weight_matches_reference():
    X, y = _xy(seed=3)
    yc = (y > 0.5).astype(int)
    jm, tm = _pair("LGBMClassifier", class_weight={0: 1.0, 1: 3.0}, **EST)
    jm.fit(X, yc)
    tm.fit(X, yc)
    _same_model(jm, tm)
    w = np.where(yc == 1, 3.0, 1.0)
    ref = tlgb.LGBMClassifier(device="cpu", **EST).fit(X, yc,
                                                       sample_weight=w)
    assert tm.booster_.digest() == ref.booster_.digest()


def test_set_params_changes_constructor_kwargs():
    """A parameter given through ``**kwargs`` changes on ``set_params``,
    as ``GridSearchCV`` needs (the JAX package keeps the old value,
    ROADMAP C24), and reaches training."""
    tm = tlgb.LGBMRegressor(max_bin=31, device="cpu")
    tm.set_params(max_bin=63, min_data_in_bin=2)
    assert tm.get_params()["max_bin"] == 63
    assert tm.get_params()["min_data_in_bin"] == 2
    assert tm._process_params("regression")["max_bin"] == 63


def test_params_round_trip_and_importances():
    tm = tlgb.LGBMRegressor(n_estimators=7, num_leaves=9, device="cpu",
                            max_bin=31)
    params = tm.get_params()
    assert params["device"] == "cpu" and params["max_bin"] == 31
    again = tlgb.LGBMRegressor(**params)
    assert again.get_params() == params
    tm.set_params(num_leaves=5)
    assert tm.get_params()["num_leaves"] == 5
    X, y = _xy()
    tm.fit(X, y)
    assert tm.n_features_ == X.shape[1]
    assert tm.feature_importances_.sum() > 0


def test_sklearn_clone_and_grid_search():
    pytest.importorskip("sklearn")
    from sklearn.base import clone
    from sklearn.model_selection import GridSearchCV
    tm = tlgb.LGBMRegressor(device="cpu", **EST)
    c = clone(tm)
    assert c.get_params() == tm.get_params() and c is not tm
    X, y = _xy(n=600)
    gs = GridSearchCV(tlgb.LGBMRegressor(device="cpu", **EST),
                      {"num_leaves": [4, 8], "max_bin": [15, 63]}, cv=2,
                      scoring="neg_mean_squared_error")
    gs.fit(X, y)
    assert gs.best_params_["num_leaves"] in (4, 8)
    best = gs.best_estimator_.get_params()
    assert best["max_bin"] == gs.best_params_["max_bin"]
    assert gs.predict(X).shape == (len(X),)
