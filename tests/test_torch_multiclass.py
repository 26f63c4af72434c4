"""Multiclass training (K trees an iteration) in lightgbm_tpu_torch
against the JAX package, on the CPU.

The JAX side runs its histogram, route and split kernels in Pallas
interpret mode (``LGBM_TPU_HIST_BACKEND=compact``,
``LGBM_TPU_SPLIT_INTERPRET=1``); the port runs their plain versions.
Its softmax goes through torch's ``exp``, an ulp from XLA's, so a
multiclass digest may differ from the JAX package's: then the first
divergence must be a near-tie (``model_flip_report``), with the same
stop and best iteration.  Covered: ``multiclass`` and ``multiclassova``
with a valid set, early stopping, bagging and ``feature_fraction``
(one bagging mask an iteration, the feature mask keyed on ``iter * K +
k``), class-major ``init_score``, the all-stumps stop, a streamed
multiclass run equal to in memory, and a trained multiclass model
served ``[n, K]`` as the host walk predicts.
"""
import numpy as np
import pytest
import torch

from tools.numcheck.tolerance_registry import tol

import lightgbm_tpu as jlgb
from lightgbm_tpu.parallel.envelope import model_flip_report

import lightgbm_tpu_torch as tlgb
from lightgbm_tpu_torch.boosting.streaming import StreamTrainer
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.io.dataset import BinnedDataset, Metadata
from lightgbm_tpu_torch.serve import compile_model

torch.set_num_threads(1)   # tiny tensors: more threads only spin

K = 5
BASE = {"objective": "multiclass", "num_class": K, "num_leaves": 15,
        "max_bin": 63, "learning_rate": 0.1, "min_data_in_leaf": 20,
        "verbose": -1}


def _data(seed=0, n=3000, nv=600, noise=1.0, classes=K):
    rng = np.random.RandomState(seed)
    X = rng.normal(size=(n + nv, 6)).astype(np.float32)
    z = X[:, 0] * 2 + X[:, 1] - X[:, 2] + rng.normal(scale=noise,
                                                     size=n + nv)
    cuts = np.quantile(z, np.arange(1, classes) / classes)
    y = np.digitize(z, cuts).astype(np.float32)
    return X[:n], y[:n], X[n:], y[n:]


def _both(params, data, rounds, es=None, init=None):
    X, y, Xv, yv = data
    out = []
    for lgb, kw in ((jlgb, {}), (tlgb, {"device": "cpu"})):
        ds = lgb.Dataset(X, label=y, init_score=init)
        vs = lgb.Dataset(Xv, label=yv, reference=ds)
        out.append(lgb.train(dict(params), ds, num_boost_round=rounds,
                             valid_sets=[vs], early_stopping_rounds=es,
                             verbose_eval=False, **kw))
    return out


def _same_model(jb, tb):
    assert tb.current_iteration() == jb.current_iteration
    assert tb.best_iteration == jb.best_iteration
    if tb.digest(include_scores=False) != jb.digest(include_scores=False):
        rep = model_flip_report(jb.model_to_string(), tb.model_to_string())
        assert rep["near_tie"], rep


@pytest.mark.parametrize("objective", ["multiclass", "multiclassova"])
@pytest.mark.parametrize("sampled", [False, True],
                         ids=["plain", "bagged_ff_early_stop"])
def test_multiclass_model_matches_reference(monkeypatch, objective,
                                            sampled):
    monkeypatch.setenv("LGBM_TPU_HIST_BACKEND", "compact")
    monkeypatch.setenv("LGBM_TPU_SPLIT_INTERPRET", "1")
    params = dict(BASE, objective=objective)
    rounds, es, data = 4, None, _data()
    if sampled:
        params.update(bagging_freq=2, bagging_fraction=0.7,
                      feature_fraction=0.7, learning_rate=0.8,
                      min_data_in_leaf=5)
        rounds, es, data = 20, 2, _data(seed=1, n=2000, nv=400, noise=3.0)
    jb, tb = _both(params, data, rounds, es)
    _same_model(jb, tb)
    assert len(tb._gbdt.models) == K * tb.current_iteration()
    if sampled:
        assert tb.best_iteration < tb.current_iteration() < rounds
    Xv, yv = data[2], data[3]
    pj, pt = jb.predict(Xv), tb.predict(Xv)
    assert pt.shape == (len(Xv), K)
    np.testing.assert_allclose(pt, pj, rtol=0, atol=tol("prob_coarse"))
    if objective == "multiclass":
        np.testing.assert_allclose(pt.sum(axis=1), 1.0, rtol=0,
                                   atol=tol("f32_tight"))


def test_multiclass_metrics_match_reference(monkeypatch):
    """``evals_result`` of ``multi_logloss`` and ``multi_error`` on the
    training and a valid set, against the JAX package's callback loop."""
    monkeypatch.setenv("LGBM_TPU_HIST_BACKEND", "compact")
    monkeypatch.setenv("LGBM_TPU_SPLIT_INTERPRET", "1")
    X, y, Xv, yv = _data()
    params = dict(BASE, metric="multi_logloss,multi_error",
                  is_training_metric=True)
    evals = [{}, {}]
    for lgb, ev, kw in ((jlgb, evals[0], {}),
                        (tlgb, evals[1], {"device": "cpu"})):
        ds = lgb.Dataset(X, label=y)
        lgb.train(dict(params), ds, num_boost_round=3,
                  valid_sets=[lgb.Dataset(Xv, label=yv, reference=ds)],
                  valid_names=["valid"], evals_result=ev,
                  verbose_eval=False, **kw)
    ref, got = evals
    assert set(got) == set(ref) == {"training", "valid"}
    for name in ref:
        assert list(got[name]) == ["multi_logloss", "multi_error"]
        for metric, want in ref[name].items():
            np.testing.assert_allclose(got[name][metric], want,
                                       rtol=tol("metric_coarse"),
                                       atol=tol("metric_coarse"))
    ll = got["training"]["multi_logloss"]
    assert ll[-1] < ll[0] < np.log(K)


def test_init_score_is_class_major(monkeypatch):
    """``init_score`` of ``n * K`` values is class-major (the reference's
    layout), and the init scores start both packages' training."""
    monkeypatch.setenv("LGBM_TPU_HIST_BACKEND", "compact")
    monkeypatch.setenv("LGBM_TPU_SPLIT_INTERPRET", "1")
    data = _data(n=2000, nv=300)
    n = len(data[0])
    init = np.random.RandomState(9).normal(size=n * K) * 0.5
    jb, tb = _both(BASE, data, 3, init=init)
    _same_model(jb, tb)
    start = np.asarray(init, np.float32).reshape(-1, K, order="F")
    bst = tlgb.train(dict(BASE), tlgb.Dataset(data[0], label=data[1],
                                              init_score=init),
                     num_boost_round=0, device="cpu")
    np.testing.assert_array_equal(bst._gbdt.scores.numpy(), start)


def test_all_stump_iteration_stops_and_is_dropped(monkeypatch):
    """A class no row holds has a constant gradient at the first
    iteration: its tree is a stump and stays (zero output) while the
    other classes split.  An iteration whose K trees are all stumps ends
    training and leaves no trees, as in the JAX package."""
    monkeypatch.setenv("LGBM_TPU_HIST_BACKEND", "compact")
    monkeypatch.setenv("LGBM_TPU_SPLIT_INTERPRET", "1")
    X, y, Xv, yv = _data(classes=3)
    params = dict(BASE, num_class=4)        # class 3 is never a label
    jb, tb = _both(params, (X, y, Xv, yv), 2)
    _same_model(jb, tb)
    models = tb._gbdt.models
    assert len(models) == 8 and models[3].num_leaves == 1
    assert models[3].leaf_value[0] == 0.0
    assert all(models[k].num_leaves > 1 for k in range(3))
    jb, tb = _both(dict(params, min_data_in_leaf=4000), (X, y, Xv, yv), 3)
    assert tb.current_iteration() == jb.current_iteration == 0
    assert len(tb._gbdt.models) == len(jb._gbdt.models) == 0


@pytest.mark.parametrize("objective", ["multiclass", "huber"])
def test_stream_equals_in_memory(objective):
    """A streamed run (blocks of 8,192 rows, K trees an iteration) builds
    the in-memory model, scores included, bitwise."""
    X, y, _, _ = _data(n=20000, nv=0, classes=3)
    params = dict(BASE, objective=objective, num_class=3, num_leaves=31)
    if objective == "huber":
        params.pop("num_class")
        y = y + 0.1 * X[:, 3]
    cfg = Config.from_params(params)
    md = Metadata()
    md.set_field("label", y)
    res = BinnedDataset.from_raw(X, cfg, metadata=md)
    st = StreamTrainer(cfg, res, block_rows=8192, device="cpu").train(3)
    mem = tlgb.train(dict(params), tlgb.Dataset(X, label=y),
                     num_boost_round=3, device="cpu")._gbdt
    assert st.num_tree_per_iteration == mem.num_tree_per_iteration
    assert len(st.models) == 3 * mem.num_tree_per_iteration
    assert st.digest() == mem.digest()
    assert st.save_model_to_string() == mem.save_model_to_string()


@pytest.mark.parametrize("objective", ["regression_l1", "lambdarank"])
def test_stream_refuses_renewal_and_ranking(objective):
    X, y, _, _ = _data(n=8192, nv=0)
    cfg = Config.from_params({"objective": objective, "verbose": -1})
    md = Metadata()
    md.set_field("label", y)
    res = BinnedDataset.from_raw(X, cfg, metadata=md)
    with pytest.raises(ValueError, match="renewal" if objective ==
                       "regression_l1" else "rank"):
        StreamTrainer(cfg, res, device="cpu")


def test_trained_multiclass_serves_n_by_k():
    X, y, Xv, _ = _data(n=2000, nv=300)
    bst = tlgb.train(dict(BASE), tlgb.Dataset(X, label=y),
                     num_boost_round=3, device="cpu")
    cm = compile_model(bst)
    host_raw = bst.predict(Xv, raw_score=True, device=False)
    assert host_raw.shape == (len(Xv), K)
    np.testing.assert_array_equal(
        cm.leaf_indices(Xv), bst.predict(Xv, pred_leaf=True, device=False))
    np.testing.assert_allclose(cm.predict_raw(Xv), host_raw, rtol=0,
                               atol=tol("f32_accum_2x"))
    prob = bst.predict(Xv, device=True)
    np.testing.assert_allclose(prob, bst.predict(Xv, device=False), rtol=0,
                               atol=tol("f32_accum_2x"))
    np.testing.assert_allclose(prob.sum(axis=1), 1.0, rtol=0,
                               atol=tol("f32_tight"))
    # truncation: num_iteration x K trees
    np.testing.assert_allclose(
        bst.predict(Xv, num_iteration=1, raw_score=True, device=True),
        bst.predict(Xv, num_iteration=1, raw_score=True, device=False),
        rtol=0, atol=tol("f32_accum_2x"))
