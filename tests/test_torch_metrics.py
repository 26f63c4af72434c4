"""Metrics of lightgbm_tpu_torch against the JAX package's, on the CPU.

The port's ``metric/metrics.py`` is a copy of the JAX package's (host
numpy): every metric name and alias evaluates to the same value on the
same seeded labels, raw scores (``[n]``, or ``[n, K]`` for the
multiclass metrics), weights and query boundaries; each objective's
default metric is the JAX package's.
"""
import numpy as np
import pytest
import torch

from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.metric import metrics as jmet

from lightgbm_tpu_torch.config import Config as TConfig
from lightgbm_tpu_torch.metric import metrics as tmet
from lightgbm_tpu_torch.objective.objectives import OBJECTIVES

import lightgbm_tpu_torch as tlgb

torch.set_num_threads(1)   # tiny tensors: more threads only spin

N = 700
K = 3
PARAMS = {"alpha": 0.7, "fair_c": 0.9, "tweedie_variance_power": 1.4,
          "sigmoid": 0.8, "ndcg_eval_at": [1, 3, 10]}
SIZES = np.array([1, 2, 17, 40, 5, 3, 90, 12, 30] * 10)[:30]


def _inputs(name, weighted):
    rng = np.random.RandomState(len(name))
    n = int(SIZES.sum()) if name in ("ndcg", "map", "lambdarank",
                                     "mean_average_precision") else N
    z = rng.normal(size=n)
    multi = name in ("multi_logloss", "multiclass", "softmax",
                     "multiclassova", "multi_error")
    if multi:
        label = rng.randint(0, K, size=n)
        score = rng.normal(size=(n, K))
    elif name in ("ndcg", "map", "lambdarank", "mean_average_precision"):
        label = rng.randint(0, 5, size=n)
        label[:1] = 0
        score = z
    elif name in ("xentropy", "cross_entropy", "kldiv", "kullback_leibler",
                  "xentlambda", "cross_entropy_lambda"):
        label = rng.rand(n)
        score = 0.3 * z
    elif name in ("binary_logloss", "binary", "binary_error", "auc"):
        label = z + rng.normal(size=n) > 0
        score = z
    else:
        label = np.abs(z) + 0.1 if name not in ("l1", "l2") else z
        score = 0.3 * rng.normal(size=n)
    weight = rng.uniform(0.2, 2.0, size=n).astype(np.float32)
    query = np.concatenate([[0], np.cumsum(SIZES)])
    return (np.asarray(label, np.float32), np.asarray(score, np.float32),
            weight if weighted else None, query)


@pytest.mark.parametrize("weighted", [False, True], ids=["plain", "weighted"])
@pytest.mark.parametrize("name", sorted(jmet.METRICS))
def test_metric_matches_reference(name, weighted):
    label, score, weight, query = _inputs(name, weighted)
    jm = jmet.create_metric(name, JConfig.from_params(PARAMS))
    tm = tmet.create_metric(name, TConfig.from_params(PARAMS))
    assert tuple(tm.names) == tuple(jm.names)
    want = jm.eval(label, score, weight, query)
    got = tm.eval(label, score, weight, query)
    assert [(n, h) for n, _, h in got] == [(n, h) for n, _, h in want]
    np.testing.assert_array_equal([v for _, v, _ in got],
                                  [v for _, v, _ in want])
    assert all(np.isfinite(v) for _, v, _ in got)


@pytest.mark.parametrize("objective", sorted(OBJECTIVES))
def test_default_metric_matches_reference(objective):
    assert (tmet.default_metric_for_objective(objective)
            == jmet.default_metric_for_objective(objective))


@pytest.mark.parametrize("name", ["none", "", "na", "null"])
def test_no_metric(name):
    assert tmet.create_metric(name, TConfig()) is None


def test_training_reports_the_default_metric():
    """Each trained objective evaluates with its own default metric (the
    port used to report ``l2`` for every objective but binary)."""
    rng = np.random.RandomState(0)
    X = rng.normal(size=(400, 3)).astype(np.float32)
    y = X[:, 0] + 0.3 * rng.normal(size=400)
    for obj, metric in (("regression_l1", "l1"), ("poisson", "poisson"),
                        ("huber", "huber"), ("quantile", "quantile")):
        evals = {}
        ds = tlgb.Dataset(X, label=np.abs(y) if obj == "poisson" else y)
        tlgb.train({"objective": obj, "num_leaves": 4, "verbose": -1},
                   ds, num_boost_round=2, valid_sets=[ds],
                   valid_names=["train"], evals_result=evals,
                   verbose_eval=False, device="cpu")
        assert list(evals["train"]) == [metric]
