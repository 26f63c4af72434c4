"""The slice as a whole: ``lgb.train`` in both packages at toy size.

The JAX side is forced onto the kernel backend
(``LGBM_TPU_HIST_BACKEND=compact`` and ``LGBM_TPU_SPLIT_INTERPRET=1``:
its histogram, route and split kernels in Pallas interpret mode on the
CPU); the port runs its kernels' plain versions on the CPU.  One config
runs every wave fused (15 leaves), the other route + leaf-compacted
histogram (127 leaves; at <= 65,536 rows every wave runs at the tail
width); a third trains the L2 regression objective.  At these sizes
every wave's split scan is the fused split kernel in both packages,
except in the "lane_unaligned" config (6 features x 16 bins): there the
reference keeps its XLA scan (``F*B`` is not a multiple of 128 lanes)
while the port, which has no lane condition, takes the kernel.  The digests
(``include_scores=False``) must match, or the first divergence must be
a near-tie flip by
``lightgbm_tpu.parallel.envelope.model_flip_report`` with train AUC in
agreement.  A model the JAX package saved and the port loaded through
``convert`` predicts what the JAX package predicts.
"""
import numpy as np
import pytest
import torch

from tools.numcheck.tolerance_registry import tol

import lightgbm_tpu as jlgb
from lightgbm_tpu.basic import Booster as JBooster
from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.metric.metrics import BinaryLoglossMetric, binary_auc
from lightgbm_tpu.parallel.envelope import model_flip_report

import lightgbm_tpu_torch as tlgb
from lightgbm_tpu_torch.convert import booster_from_model_string
from lightgbm_tpu_torch.metric import metrics as t_metrics
from lightgbm_tpu_torch.ops import compact as t_compact
from lightgbm_tpu_torch.ops import histogram as t_hist
from lightgbm_tpu_torch.ops import route as t_route
from lightgbm_tpu_torch.ops import split_kernel as t_split

torch.set_num_threads(1)   # tiny tensors: more threads only spin

ITERS = 4


def _data(seed=0, n=3000, f=6):
    rng = np.random.RandomState(seed)
    X = rng.normal(size=(n, f)).astype(np.float32)
    y = (X[:, 0] * 2 + X[:, 1] - X[:, 2] + rng.normal(size=n)
         > 0).astype(np.float32)
    return X, y


def _params(leaves, objective="binary", max_bin=63):
    return {"objective": objective, "num_leaves": leaves,
            "max_bin": max_bin, "learning_rate": 0.1,
            "min_data_in_leaf": 20, "verbose": -1}


WRAPPERS = (t_hist.hist_route_raw, t_compact.hist_compact_raw,
            t_route.route_rows_raw, t_route.route_rows_values_raw,
            t_split.find_best_splits_kernel)


FUSED = {t_hist.hist_route_raw, t_route.route_rows_values_raw,
         t_split.find_best_splits_kernel}
COMPACT = {t_compact.hist_compact_raw, t_route.route_rows_raw,
           t_route.route_rows_values_raw, t_split.find_best_splits_kernel}


@pytest.mark.parametrize("leaves,objective,max_bin,expect", [
    (15, "binary", 63, FUSED), (127, "binary", 63, COMPACT),
    (15, "regression", 63, FUSED), (15, "binary", 15, FUSED),
], ids=["fused", "compact", "regression", "lane_unaligned"])
def test_train_matches_reference(monkeypatch, leaves, objective, max_bin,
                                 expect):
    monkeypatch.setenv("LGBM_TPU_HIST_BACKEND", "compact")
    monkeypatch.setenv("LGBM_TPU_SPLIT_INTERPRET", "1")
    X, y = _data()
    if objective == "regression":
        y = (X[:, 0] * 2 + X[:, 1] - X[:, 2]).astype(np.float32)
    params = _params(leaves, objective, max_bin)
    jb = jlgb.train(dict(params), jlgb.Dataset(X, label=y),
                    num_boost_round=ITERS)
    before = {w: w.plain_calls for w in WRAPPERS}
    tb = tlgb.train(dict(params), tlgb.Dataset(X, label=y),
                    num_boost_round=ITERS, device="cpu")
    moved = {w for w in WRAPPERS if w.plain_calls > before[w]}
    assert moved == expect
    assert tb.current_iteration() == ITERS
    dj = jb.digest(include_scores=False)
    dt = tb.digest(include_scores=False)
    if dj != dt:
        rep = model_flip_report(jb.model_to_string(), tb.model_to_string())
        assert rep["near_tie"], rep
    pj, pt = jb.predict(X), tb.predict(X)
    if objective == "binary":
        assert abs(binary_auc(y, pj) - binary_auc(y, pt)) <= tol(
            "metric_coarse")
        # the port's copied metrics agree with the reference's
        raw = tb.predict(X, raw_score=True)
        assert t_metrics.binary_auc(y, raw) == binary_auc(y, raw)
        ref_ll = BinaryLoglossMetric(JConfig()).eval(y, raw)[0][1]
        assert t_metrics.binary_logloss(y, raw) == ref_ll
    if dj == dt:
        # same trees: the same model text; the two predictors differ
        # only in float32 summation
        assert tb.model_to_string() == jb.model_to_string()
        np.testing.assert_allclose(pt, pj, rtol=0, atol=tol("f32_accum"))


def test_efb_bundled_matches_reference(monkeypatch):
    """Three sparse, mutually exclusive columns that EFB bundles into one
    group column (8 features, so ``F * B`` is lane-aligned and both
    packages take their split kernel): the same digest.  The bundled
    features' default cells are rebuilt from the leaf totals minus a
    sum in the reference's compiled order (``ops/histogram.py:
    fixed_sum``)."""
    monkeypatch.setenv("LGBM_TPU_HIST_BACKEND", "compact")
    monkeypatch.setenv("LGBM_TPU_SPLIT_INTERPRET", "1")
    rng = np.random.RandomState(0)
    n = 3000
    X = rng.normal(size=(n, 8)).astype(np.float32)
    rows = np.arange(n)
    on = rng.rand(n) < 0.3
    for i, f in enumerate((4, 5, 6)):
        X[:, f] = np.where((rows % 3 == i) & on, X[:, f], 0.0)
    y = (X[:, 0] + X[:, 4] - X[:, 5] + 0.5 * rng.normal(size=n)
         > 0).astype(np.float32)
    params = _params(15)
    jb = jlgb.train(dict(params), jlgb.Dataset(X, label=y),
                    num_boost_round=ITERS)
    before = t_split.find_best_splits_kernel.plain_calls
    tb = tlgb.train(dict(params), tlgb.Dataset(X, label=y),
                    num_boost_round=ITERS, device="cpu")
    assert t_split.find_best_splits_kernel.plain_calls > before
    assert tb._gbdt.train_set.bundle.is_bundled
    assert tb.digest() == jb.digest()


def test_model_string_round_trip():
    X, y = _data(seed=1)
    jb = jlgb.train(_params(15), jlgb.Dataset(X, label=y),
                    num_boost_round=ITERS)
    text = jb.model_to_string()
    tb = booster_from_model_string(text, device="cpu")
    jl = JBooster(model_str=text)
    # raw scores: the same host tree walk in float64 -> bitwise
    np.testing.assert_array_equal(tb.predict(X, raw_score=True),
                                  jl.predict(X, raw_score=True))
    # probabilities: each package's float32 sigmoid (an ulp apart)
    np.testing.assert_allclose(tb.predict(X), jl.predict(X), rtol=0,
                               atol=tol("f32_tight"))
    # a loaded model writes the same text in both packages
    assert tb.model_to_string() == jl.model_to_string()


@pytest.mark.parametrize("mode,leaves,kernel", [
    ("hhilo", 15, t_hist.hist_route_float_raw),
    ("hilo", 127, t_compact.hist_compact_float_raw),
    ("bf16", 127, t_compact.hist_compact_float_raw),
], ids=["hhilo_fused", "hilo_compact", "bf16_compact"])
def test_float_train_matches_reference(monkeypatch, mode, leaves, kernel):
    """In-memory training on a float histogram mode in both packages:
    the port's float K1 / K3 (plain versions) sum in the float K5's
    fixed order, the reference's kernels in their MXU order, so the
    ladder holds: the same trees with leaf values within
    ``tol("f32_eps_few")``, or a first divergence that
    ``model_flip_report`` classifies as a near-tie; train AUC within
    ``tol("metric_coarse")``."""
    monkeypatch.setenv("LGBM_TPU_HIST_BACKEND", "compact")
    monkeypatch.setenv("LGBM_TPU_SPLIT_INTERPRET", "1")
    X, y = _data(seed=4)
    params = dict(_params(leaves), hist_mode=mode)
    jb = jlgb.train(dict(params), jlgb.Dataset(X, label=y),
                    num_boost_round=ITERS)
    before = kernel.plain_calls
    tb = tlgb.train(dict(params), tlgb.Dataset(X, label=y),
                    num_boost_round=ITERS, device="cpu")
    assert kernel.plain_calls > before
    assert tb.current_iteration() == ITERS
    rep = model_flip_report(jb.model_to_string(), tb.model_to_string())
    assert rep["near_tie"], rep
    if rep["flip_tree"] is None:
        assert rep["max_leaf_value_gap"] <= tol("f32_eps_few"), rep
    assert abs(binary_auc(y, jb.predict(X)) - binary_auc(y, tb.predict(X))
               ) <= tol("metric_coarse")
