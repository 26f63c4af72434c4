"""SHAP feature contributions (TreeSHAP), on the host.

A copy of the JAX package's ``boosting/contrib.py`` (numpy only;
reference ``Tree::PredictContrib``, ``src/io/tree.cpp`` TreeSHAP): the
exact polynomial-time TreeSHAP algorithm (Lundberg et al.) over the flat
tree arrays.  Output layout as the reference's ``pred_contrib=True``:
``[n, num_features + 1]`` with the expected value in the last column
(per class for multiclass).  The recursion runs once per distinct
pattern of node decisions, in Python: the JAX package's compiled
recursion is not ported.
"""
from __future__ import annotations

from typing import List

import numpy as np

from ..io.binning import MISSING_NAN, MISSING_ZERO
from ..models.tree import (K_CATEGORICAL_MASK, K_DEFAULT_LEFT_MASK,
                           _K_ZERO_THRESHOLD, _bitset_to_values)


class _PathElement:
    __slots__ = ("feature_index", "zero_fraction", "one_fraction", "pweight")

    def __init__(self, f, z, o, w):
        self.feature_index = f
        self.zero_fraction = z
        self.one_fraction = o
        self.pweight = w


def _extend_path(path: List[_PathElement], unique_depth, zero_fraction,
                 one_fraction, feature_index):
    path.append(_PathElement(feature_index, zero_fraction, one_fraction,
                             1.0 if unique_depth == 0 else 0.0))
    for i in range(unique_depth - 1, -1, -1):
        path[i + 1].pweight += (one_fraction * path[i].pweight * (i + 1)
                                / (unique_depth + 1))
        path[i].pweight = (zero_fraction * path[i].pweight
                           * (unique_depth - i) / (unique_depth + 1))


def _unwind_path(path: List[_PathElement], unique_depth, path_index):
    one_fraction = path[path_index].one_fraction
    zero_fraction = path[path_index].zero_fraction
    next_one_portion = path[unique_depth].pweight
    for i in range(unique_depth - 1, -1, -1):
        if one_fraction != 0:
            tmp = path[i].pweight
            path[i].pweight = (next_one_portion * (unique_depth + 1)
                               / ((i + 1) * one_fraction))
            next_one_portion = tmp - path[i].pweight * zero_fraction \
                * (unique_depth - i) / (unique_depth + 1)
        else:
            path[i].pweight = (path[i].pweight * (unique_depth + 1)
                               / (zero_fraction * (unique_depth - i)))
    for i in range(path_index, unique_depth):
        path[i].feature_index = path[i + 1].feature_index
        path[i].zero_fraction = path[i + 1].zero_fraction
        path[i].one_fraction = path[i + 1].one_fraction
    path.pop()


def _unwound_path_sum(path: List[_PathElement], unique_depth, path_index):
    one_fraction = path[path_index].one_fraction
    zero_fraction = path[path_index].zero_fraction
    next_one_portion = path[unique_depth].pweight
    total = 0.0
    for i in range(unique_depth - 1, -1, -1):
        if one_fraction != 0:
            tmp = (next_one_portion * (unique_depth + 1)
                   / ((i + 1) * one_fraction))
            total += tmp
            next_one_portion = (path[i].pweight - tmp * zero_fraction
                                * ((unique_depth - i) / (unique_depth + 1)))
        else:
            total += (path[i].pweight / zero_fraction
                      / ((unique_depth - i) / (unique_depth + 1)))
    return total


def _tree_shap(tree, x, phi, node, unique_depth, parent_path,
               parent_zero_fraction, parent_one_fraction,
               parent_feature_index):
    path = [(_PathElement(p.feature_index, p.zero_fraction, p.one_fraction,
                          p.pweight)) for p in parent_path]
    _extend_path(path, unique_depth, parent_zero_fraction,
                 parent_one_fraction, parent_feature_index)

    if node < 0:   # leaf
        leaf = ~node
        for i in range(1, unique_depth + 1):
            w = _unwound_path_sum(path, unique_depth, i)
            el = path[i]
            phi[el.feature_index] += (w * (el.one_fraction - el.zero_fraction)
                                      * tree.leaf_value[leaf])
        return

    hot, cold = _decide(tree, x, node)
    w = float(tree.internal_count[node])
    hot_count = _node_count(tree, hot)
    cold_count = _node_count(tree, cold)

    incoming_zero_fraction = 1.0
    incoming_one_fraction = 1.0
    feature = int(tree.split_feature[node])
    # if this feature was already on the path, undo it
    path_index = next((i for i in range(1, unique_depth + 1)
                       if path[i].feature_index == feature), None)
    if path_index is not None:
        incoming_zero_fraction = path[path_index].zero_fraction
        incoming_one_fraction = path[path_index].one_fraction
        _unwind_path(path, unique_depth, path_index)
        unique_depth -= 1

    _tree_shap(tree, x, phi, hot, unique_depth + 1, path,
               hot_count / w * incoming_zero_fraction,
               incoming_one_fraction, feature)
    _tree_shap(tree, x, phi, cold, unique_depth + 1, path,
               cold_count / w * incoming_zero_fraction, 0.0, feature)


def _decide(tree, x, node):
    """(hot, cold) children of ``node`` for the per-node go-left decision
    vector ``x``."""
    nxt = tree.left_child[node] if x[node] else tree.right_child[node]
    other = (tree.right_child[node] if nxt == tree.left_child[node]
             else tree.left_child[node])
    return int(nxt), int(other)


def _decision_matrix(tree, X: np.ndarray) -> np.ndarray:
    """Vectorized per-(row, node) go-left decisions -> bool [n, m].

    Lets the exact TreeSHAP recursion run once per *distinct* decision
    pattern instead of once per row (rows that decide identically at
    every internal node get identical phi)."""
    n = X.shape[0]
    m = tree.num_leaves - 1
    D = np.zeros((n, m), bool)
    for node in range(m):
        f = int(tree.split_feature[node])
        fval = X[:, f]
        dt = int(tree.decision_type[node])
        mt = (dt >> 2) & 3
        nan = np.isnan(fval)
        if dt & K_CATEGORICAL_MASK:
            ci = int(tree.threshold_bin[node])
            members = np.asarray(_bitset_to_values(
                tree.cat_threshold[tree.cat_boundaries[ci]:
                                   tree.cat_boundaries[ci + 1]]))
            ok = ~nan & (fval >= 0)
            cats = np.where(ok, fval, -1).astype(np.int64)
            D[:, node] = np.isin(cats, members) & ok
            continue
        fval0 = np.where(nan & (mt != MISSING_NAN), 0.0, fval)
        is_missing = (((mt == MISSING_ZERO)
                       & (np.abs(fval0) <= _K_ZERO_THRESHOLD))
                      | ((mt == MISSING_NAN) & nan))
        dl = bool(dt & K_DEFAULT_LEFT_MASK)
        D[:, node] = np.where(is_missing, dl,
                              fval0 <= float(tree.threshold[node]))
    return D


def _node_count(tree, node):
    if node < 0:
        return float(tree.leaf_count[~node])
    return float(tree.internal_count[node])


def _expected_value(tree, node=0):
    if tree.num_leaves == 1:
        return float(tree.leaf_value[0])
    return _expected(tree, 0)


def _expected(tree, node):
    if node < 0:
        return float(tree.leaf_value[~node])
    w = float(tree.internal_count[node])
    l, r = int(tree.left_child[node]), int(tree.right_child[node])
    return (_node_count(tree, l) / w * _expected(tree, l)
            + _node_count(tree, r) / w * _expected(tree, r))


def predict_contrib(gbdt, X: np.ndarray, num_iteration: int = -1) -> np.ndarray:
    """[n, F+1] SHAP values (+ expected value last column)."""
    X = np.asarray(X, np.float64)
    n = X.shape[0]
    F = gbdt.max_feature_idx + 1
    K = max(1, gbdt.num_tree_per_iteration)
    T = len(gbdt.models)
    if num_iteration and num_iteration > 0:
        T = min(T, num_iteration * K)
    out = np.zeros((n, K, F + 1))
    for i in range(T):
        t = gbdt.models[i]
        k = i % K
        if t.num_leaves == 1:
            out[:, k, F] += float(t.leaf_value[0])
            continue
        ev = _expected_value(t)
        out[:, k, F] += ev
        D = _decision_matrix(t, X)
        patterns, inverse = np.unique(D, axis=0, return_inverse=True)
        phis = np.zeros((len(patterns), F + 1))
        for p in range(len(patterns)):
            _tree_shap(t, patterns[p], phis[p], 0, 0, [], 1.0, 1.0, -1)
        out[:, k, :F] += phis[inverse.reshape(-1), :F]
    if K == 1:
        return out[:, 0, :]
    return out.reshape(n, K * (F + 1))
