"""Evaluation metrics -- host numpy, copied from the JAX package's
``metric/metrics.py`` (which imports no JAX).

Counterparts of the reference metric classes (factory
``src/metric/metric.cpp:11-57``; ``regression_metric.hpp``,
``binary_metric.hpp``, ``multiclass_metric.hpp``, ``rank_metric.hpp``,
``map_metric.hpp``, ``xentropy_metric.hpp``).  Each metric is
``eval(label, score, weight, query) -> [(name, value, higher_better)]``
over the RAW model score (``[n]``, or ``[n, K]`` for the multiclass
metrics); the link is applied inside, as the reference passes the
objective into ``Metric::Eval``.  The ranking metrics read the query
boundaries.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..config import Config
from ..utils.log import log_warning

EvalResult = Tuple[str, float, bool]   # (name, value, higher_is_better)


def _wmean(values: np.ndarray, weight: Optional[np.ndarray]) -> float:
    if weight is None:
        return float(np.mean(values))
    return float(np.sum(values * weight) / np.sum(weight))


def _sigmoid(x):
    return 1.0 / (1.0 + np.exp(-x))


def binary_auc(label, score, weight=None) -> float:
    """Tie-aware rank-sum AUC with weights (reference
    binary_metric.hpp:157-234 semantics, by sort + cumulative sums)."""
    label = np.asarray(label)
    score = np.asarray(score)
    if len(label) == 0:
        log_warning("AUC over an empty set is undefined; returning NaN")
        return float("nan")
    order = np.argsort(score, kind="mergesort")
    s = score[order]
    y = label[order]
    # f64 throughout: the rank-sum area is O(n^2 / 4)
    w = (np.asarray(weight)[order].astype(np.float64)
         if weight is not None else np.ones(len(y), np.float64))
    wp = w * (y > 0)
    wn = w * (y <= 0)
    boundaries = np.nonzero(np.diff(s))[0]
    starts = np.concatenate([[0], boundaries + 1])
    bp = np.add.reduceat(wp, starts)
    bn = np.add.reduceat(wn, starts)
    cum_before = np.concatenate([[0.0], np.cumsum(bn)[:-1]])
    area = float(np.sum(bp * (cum_before + 0.5 * bn)))
    total_pos = wp.sum()
    total_neg = wn.sum()
    if total_pos == 0 or total_neg == 0:
        log_warning("AUC over a single-class set is degenerate; "
                    "reporting 1.0")
        return 1.0
    return float(area / (total_pos * total_neg))


def binary_logloss(label, score, sigmoid: float = 1.0,
                   weight=None) -> float:
    p = np.clip(_sigmoid(sigmoid * np.asarray(score, np.float64)),
                1e-15, 1 - 1e-15)
    label = np.asarray(label)
    loss = -(label * np.log(p) + (1 - label) * np.log(1 - p))
    return _wmean(loss, weight)


def l2(label, score, weight=None) -> float:
    return _wmean((np.asarray(score) - np.asarray(label)) ** 2, weight)


class Metric:
    names: Sequence[str] = ()
    higher_better = False

    def __init__(self, config: Config):
        self.config = config

    def eval(self, label, score, weight=None, query=None) -> List[EvalResult]:
        raise NotImplementedError


# --- regression metrics (regression_metric.hpp:16+) ------------------------
class L2Metric(Metric):
    names = ("l2",)

    def eval(self, label, score, weight=None, query=None):
        return [("l2", _wmean((score - label) ** 2, weight), False)]


class RMSEMetric(Metric):
    names = ("rmse",)

    def eval(self, label, score, weight=None, query=None):
        return [("rmse", float(np.sqrt(_wmean((score - label) ** 2, weight))),
                 False)]


class L1Metric(Metric):
    names = ("l1",)

    def eval(self, label, score, weight=None, query=None):
        return [("l1", _wmean(np.abs(score - label), weight), False)]


class QuantileMetric(Metric):
    names = ("quantile",)

    def eval(self, label, score, weight=None, query=None):
        a = self.config.alpha
        d = label - score
        loss = np.where(d >= 0, a * d, (a - 1.0) * d)
        return [("quantile", _wmean(loss, weight), False)]


class HuberMetric(Metric):
    names = ("huber",)

    def eval(self, label, score, weight=None, query=None):
        a = self.config.alpha
        d = np.abs(score - label)
        loss = np.where(d <= a, 0.5 * d * d, a * (d - 0.5 * a))
        return [("huber", _wmean(loss, weight), False)]


class FairMetric(Metric):
    names = ("fair",)

    def eval(self, label, score, weight=None, query=None):
        c = self.config.fair_c
        x = np.abs(score - label)
        loss = c * x - c * c * np.log1p(x / c)
        return [("fair", _wmean(loss, weight), False)]


class PoissonMetric(Metric):
    names = ("poisson",)

    def eval(self, label, score, weight=None, query=None):
        # score is raw (log link)
        loss = np.exp(score) - label * score
        return [("poisson", _wmean(loss, weight), False)]


class MapeMetric(Metric):
    names = ("mape",)

    def eval(self, label, score, weight=None, query=None):
        loss = np.abs((label - score) / np.maximum(1.0, np.abs(label)))
        return [("mape", _wmean(loss, weight), False)]


class GammaMetric(Metric):
    names = ("gamma",)

    def eval(self, label, score, weight=None, query=None):
        # negative log-likelihood of Gamma with log link (regression_metric.hpp)
        psi = 1.0
        theta = -1.0 / np.maximum(np.exp(score), 1e-15)
        a = psi
        b = -np.log(-theta)
        loss = -(label * theta - b) / a
        return [("gamma", _wmean(loss, weight), False)]


class GammaDevianceMetric(Metric):
    names = ("gamma_deviance", "gamma-deviance")

    def eval(self, label, score, weight=None, query=None):
        eps = 1e-9
        mu = np.maximum(np.exp(score), eps)
        frac = np.maximum(label, eps) / mu
        loss = 2.0 * (-np.log(frac) + frac - 1.0)
        return [("gamma-deviance", _wmean(loss, weight), False)]


class TweedieMetric(Metric):
    names = ("tweedie",)

    def eval(self, label, score, weight=None, query=None):
        rho = self.config.tweedie_variance_power
        mu = np.maximum(np.exp(score), 1e-15)
        a = label * np.power(mu, 1.0 - rho) / (1.0 - rho)
        b = np.power(mu, 2.0 - rho) / (2.0 - rho)
        return [("tweedie", _wmean(-a + b, weight), False)]


# --- binary metrics (binary_metric.hpp:20+) --------------------------------
class BinaryLoglossMetric(Metric):
    names = ("binary_logloss",)

    def eval(self, label, score, weight=None, query=None):
        p = np.clip(_sigmoid(self.config.sigmoid * score), 1e-15, 1 - 1e-15)
        loss = -(label * np.log(p) + (1 - label) * np.log(1 - p))
        return [("binary_logloss", _wmean(loss, weight), False)]


class BinaryErrorMetric(Metric):
    names = ("binary_error",)

    def eval(self, label, score, weight=None, query=None):
        pred = (score > 0).astype(np.float64)
        return [("binary_error", _wmean((pred != label).astype(np.float64),
                                        weight), False)]


class AucMetric(Metric):
    names = ("auc",)
    higher_better = True

    def eval(self, label, score, weight=None, query=None):
        return [("auc", binary_auc(label, score, weight), True)]


# --- multiclass (multiclass_metric.hpp:16+) --------------------------------
class MultiLoglossMetric(Metric):
    names = ("multi_logloss",)

    def eval(self, label, score, weight=None, query=None):
        # score [n, K] raw
        s = score - score.max(axis=1, keepdims=True)
        p = np.exp(s)
        p /= p.sum(axis=1, keepdims=True)
        idx = label.astype(np.int64)
        loss = -np.log(np.clip(p[np.arange(len(label)), idx], 1e-15, None))
        return [("multi_logloss", _wmean(loss, weight), False)]


class MultiErrorMetric(Metric):
    names = ("multi_error",)

    def eval(self, label, score, weight=None, query=None):
        pred = np.argmax(score, axis=1)
        err = (pred != label.astype(np.int64)).astype(np.float64)
        return [("multi_error", _wmean(err, weight), False)]


# --- ranking (rank_metric.hpp, map_metric.hpp, dcg_calculator.cpp) ---------
class NDCGMetric(Metric):
    higher_better = True

    def __init__(self, config):
        super().__init__(config)
        self.eval_at = tuple(config.ndcg_eval_at) or (1, 2, 3, 4, 5)
        gains = config.label_gain
        if not gains:
            gains = tuple(float((1 << i) - 1) for i in range(31))
        self.label_gain = np.asarray(gains)
        self.names = tuple(f"ndcg@{k}" for k in self.eval_at)

    def eval(self, label, score, weight=None, query=None):
        assert query is not None, "ndcg requires query boundaries"
        qb = np.asarray(query)
        results = {k: [] for k in self.eval_at}
        qw = np.ones(len(qb) - 1)
        for q in range(len(qb) - 1):
            l = label[qb[q]:qb[q + 1]].astype(np.int64)
            s = score[qb[q]:qb[q + 1]]
            order = np.argsort(-s, kind="mergesort")
            gains = self.label_gain[l[order]]
            ideal = np.sort(self.label_gain[l])[::-1]
            disc = 1.0 / np.log2(np.arange(len(l)) + 2.0)
            for k in self.eval_at:
                kk = min(k, len(l))
                idcg = np.sum(ideal[:kk] * disc[:kk])
                if idcg <= 0:
                    results[k].append(1.0)   # all-zero-gain query counts 1
                else:
                    results[k].append(np.sum(gains[:kk] * disc[:kk]) / idcg)
        return [(f"ndcg@{k}", float(np.average(results[k], weights=qw)), True)
                for k in self.eval_at]


class MapMetric(Metric):
    higher_better = True

    def __init__(self, config):
        super().__init__(config)
        self.eval_at = tuple(config.ndcg_eval_at) or (1, 2, 3, 4, 5)
        self.names = tuple(f"map@{k}" for k in self.eval_at)

    def eval(self, label, score, weight=None, query=None):
        assert query is not None, "map requires query boundaries"
        qb = np.asarray(query)
        results = {k: [] for k in self.eval_at}
        for q in range(len(qb) - 1):
            l = (label[qb[q]:qb[q + 1]] > 0).astype(np.float64)
            s = score[qb[q]:qb[q + 1]]
            order = np.argsort(-s, kind="mergesort")
            rel = l[order]
            hits = np.cumsum(rel)
            prec = hits / (np.arange(len(rel)) + 1)
            for k in self.eval_at:
                kk = min(k, len(rel))
                npos = rel[:kk].sum()
                ap = (np.sum(prec[:kk] * rel[:kk]) / npos) if npos > 0 else 0.0
                results[k].append(ap)
        return [(f"map@{k}", float(np.mean(results[k])), True)
                for k in self.eval_at]


# --- cross-entropy family (xentropy_metric.hpp:68-300) ---------------------
class XentropyMetric(Metric):
    names = ("xentropy",)

    def eval(self, label, score, weight=None, query=None):
        p = np.clip(_sigmoid(score), 1e-15, 1 - 1e-15)
        loss = -(label * np.log(p) + (1 - label) * np.log(1 - p))
        return [("xentropy", _wmean(loss, weight), False)]


class XentLambdaMetric(Metric):
    names = ("xentlambda",)

    def eval(self, label, score, weight=None, query=None):
        w = weight if weight is not None else 1.0
        p = np.clip(1.0 - np.exp(-w * np.exp(score)), 1e-15, 1 - 1e-15)
        loss = -(label * np.log(p) + (1 - label) * np.log(1 - p))
        return [("xentlambda", float(np.mean(loss)), False)]


class KlDivMetric(Metric):
    names = ("kldiv",)

    def eval(self, label, score, weight=None, query=None):
        p = np.clip(_sigmoid(score), 1e-15, 1 - 1e-15)
        y = np.clip(label, 1e-15, 1 - 1e-15)
        kl = (y * np.log(y / p) + (1 - y) * np.log((1 - y) / (1 - p)))
        return [("kldiv", _wmean(kl, weight), False)]


METRICS = {
    "l2": L2Metric, "mse": L2Metric, "mean_squared_error": L2Metric,
    "regression": L2Metric, "regression_l2": L2Metric,
    "l2_root": RMSEMetric, "rmse": RMSEMetric,
    "root_mean_squared_error": RMSEMetric,
    "l1": L1Metric, "mae": L1Metric, "mean_absolute_error": L1Metric,
    "regression_l1": L1Metric,
    "quantile": QuantileMetric,
    "huber": HuberMetric,
    "fair": FairMetric,
    "poisson": PoissonMetric,
    "mape": MapeMetric, "mean_absolute_percentage_error": MapeMetric,
    "gamma": GammaMetric,
    "gamma_deviance": GammaDevianceMetric, "gamma-deviance": GammaDevianceMetric,
    "tweedie": TweedieMetric,
    "binary_logloss": BinaryLoglossMetric, "binary": BinaryLoglossMetric,
    "binary_error": BinaryErrorMetric,
    "auc": AucMetric,
    "multi_logloss": MultiLoglossMetric, "multiclass": MultiLoglossMetric,
    "softmax": MultiLoglossMetric, "multiclassova": MultiLoglossMetric,
    "multi_error": MultiErrorMetric,
    "ndcg": NDCGMetric, "lambdarank": NDCGMetric,
    "map": MapMetric, "mean_average_precision": MapMetric,
    "xentropy": XentropyMetric, "cross_entropy": XentropyMetric,
    "xentlambda": XentLambdaMetric, "cross_entropy_lambda": XentLambdaMetric,
    "kldiv": KlDivMetric, "kullback_leibler": KlDivMetric,
}


def create_metric(name: str, config: Config) -> Optional[Metric]:
    """Factory (reference src/metric/metric.cpp:11-57)."""
    key = name.strip().lower()
    if key in ("", "none", "null", "na"):
        return None
    cls = METRICS.get(key)
    if cls is None:
        raise ValueError(f"unknown metric {name!r}")
    return cls(config)


def default_metric_for_objective(objective: str) -> str:
    return {
        "regression": "l2", "regression_l1": "l1", "huber": "huber",
        "fair": "fair", "poisson": "poisson", "quantile": "quantile",
        "mape": "mape", "gamma": "gamma", "tweedie": "tweedie",
        "binary": "binary_logloss", "multiclass": "multi_logloss",
        "multiclassova": "multi_logloss", "xentropy": "xentropy",
        "xentlambda": "xentlambda", "lambdarank": "ndcg",
    }.get(objective, "l2")
