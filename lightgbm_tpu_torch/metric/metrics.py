"""Evaluation metrics (the slice's subset): AUC and binary logloss.

Copied from the JAX package's ``metric/metrics.py`` (host numpy, no
JAX).  Each metric takes the RAW model score and applies the link
itself, as the reference's ``Metric::Eval`` does.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from ..utils.log import log_warning


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


