"""Decision tree model — host structure-of-arrays, text model format and
host prediction (the oracle that ``serve/compiler.py`` is held to).

Port of the JAX package's ``models/tree.py`` (reference ``Tree``,
`include/LightGBM/tree.h:15-300`, `src/io/tree.cpp`): the same flat
layout (split_feature / threshold / left_child / right_child /
leaf_value; children ``>=0`` internal node, ``~leaf`` for leaves) and the
same text format keys, so model files move between the two packages.
``decision_type`` bits: bit0 categorical, bit1 default_left, bits2-3
missing type (`tree.h:15-16,197-205`).
"""
from __future__ import annotations

import math
from typing import List, Sequence

import numpy as np

from ..io.binning import MISSING_NAN, MISSING_ZERO

K_CATEGORICAL_MASK = 1     # decision_type bit0 (tree.h:15)
K_DEFAULT_LEFT_MASK = 2    # decision_type bit1 (tree.h:16)
_K_ZERO_THRESHOLD = 1e-35


def _fmt_double(v: float) -> str:
    """Locale-independent double formatting at digits10+2 precision, like
    ``Common::ArrayToString<double>`` in the reference."""
    if math.isinf(v):
        return "inf" if v > 0 else "-inf"
    if math.isnan(v):
        return "nan"
    return repr(float(v))


class Tree:
    """Host-side tree: model text (de)serialization and host prediction."""

    def __init__(self, max_leaves: int) -> None:
        m = max(max_leaves - 1, 1)
        self.max_leaves = max_leaves
        self.num_leaves = 1
        self.num_cat = 0
        # internal-node arrays [max_leaves - 1]
        self.split_feature = np.zeros(m, np.int32)        # original feature idx
        self.split_feature_inner = np.zeros(m, np.int32)  # used-column idx
        self.split_gain = np.zeros(m, np.float32)
        self.threshold = np.zeros(m, np.float64)          # real-valued (numerical)
        self.threshold_bin = np.zeros(m, np.int32)
        self.decision_type = np.zeros(m, np.int8)
        self.left_child = np.full(m, -1, np.int32)
        self.right_child = np.full(m, -1, np.int32)
        self.internal_value = np.zeros(m, np.float64)
        self.internal_count = np.zeros(m, np.int32)
        # leaf arrays [max_leaves]
        self.leaf_value = np.zeros(max_leaves, np.float64)
        self.leaf_count = np.zeros(max_leaves, np.int32)
        self.leaf_depth = np.zeros(max_leaves, np.int32)
        # categorical bitsets over raw values, and each categorical
        # node's left bins (binned serving)
        self.cat_boundaries: List[int] = [0]
        self.cat_threshold: List[int] = []               # uint32 words (values)
        self.cat_left_bins: List[np.ndarray] = []        # per cat node, bin ids
        self.shrinkage_rate = 1.0

    def shrinkage(self, rate: float) -> None:
        """Scale outputs (reference Tree::Shrinkage)."""
        self.leaf_value[:self.num_leaves] *= rate
        self.shrinkage_rate *= rate

    def add_bias(self, bias: float) -> None:
        self.leaf_value[:self.num_leaves] += bias

    def set_leaf_output(self, leaf: int, value: float) -> None:
        """Set one leaf's output; a non-finite value becomes 0.0 (the
        reference's ``Tree::SetLeafOutput`` sanitisation)."""
        self.leaf_value[leaf] = float(value) if math.isfinite(value) else 0.0

    @property
    def max_depth(self) -> int:
        return int(self.leaf_depth[:self.num_leaves].max()) if self.num_leaves > 1 else 0

    def predict_leaf_batch(self, X: np.ndarray) -> np.ndarray:
        """Vectorized numpy traversal over all rows -> leaf index [n].

        The loaded-model fast path (reference `gbdt_prediction.cpp` per-row
        walk, vectorized here): per depth step, one gather per node array;
        categorical nodes resolve their bitset membership per unique node.
        """
        n = X.shape[0]
        if self.num_leaves == 1:
            return np.zeros(n, np.int64)
        m = self.num_leaves - 1
        sf = np.asarray(self.split_feature[:m], np.int64)
        thr = np.asarray(self.threshold[:m], np.float64)
        dt = np.asarray(self.decision_type[:m], np.int64)
        lc = np.asarray(self.left_child[:m], np.int64)
        rc = np.asarray(self.right_child[:m], np.int64)
        tb = np.asarray(self.threshold_bin[:m], np.int64)
        is_cat = (dt & K_CATEGORICAL_MASK) != 0
        mt = (dt >> 2) & 3
        dl = (dt & K_DEFAULT_LEFT_MASK) != 0
        cat_members = None
        if is_cat.any():
            cat_members = [np.asarray(_bitset_to_values(
                self.cat_threshold[self.cat_boundaries[ci]:
                                   self.cat_boundaries[ci + 1]]))
                for ci in range(len(self.cat_boundaries) - 1)]

        node = np.zeros(n, np.int64)
        active = np.arange(n)
        while active.size:
            nd = node[active]
            f = sf[nd]
            fval = X[active, f].astype(np.float64)
            nan = np.isnan(fval)
            fval0 = np.where(nan & (mt[nd] != MISSING_NAN), 0.0, fval)
            is_missing = (((mt[nd] == MISSING_ZERO)
                           & (np.abs(fval0) <= _K_ZERO_THRESHOLD))
                          | ((mt[nd] == MISSING_NAN) & nan))
            go_left = np.where(is_missing, dl[nd], fval0 <= thr[nd])
            ic = is_cat[nd]
            if ic.any():
                cat_left = np.zeros(ic.sum(), bool)
                sub_nd = nd[ic]
                sub_val = fval[ic]
                ok = ~np.isnan(sub_val) & (sub_val >= 0)
                cats = np.where(ok, sub_val, -1).astype(np.int64)
                for u in np.unique(sub_nd):
                    rows = sub_nd == u
                    cat_left[rows] = np.isin(cats[rows],
                                             cat_members[tb[u]])
                cat_left &= ok
                go_left = np.where(ic, False, go_left)
                go_left[ic] = cat_left
            node[active] = np.where(go_left, lc[nd], rc[nd])
            active = active[node[active] >= 0]
        return ~node

    def predict_batch(self, X: np.ndarray) -> np.ndarray:
        """Vectorized tree output per row -> float64 [n]."""
        return np.asarray(self.leaf_value)[self.predict_leaf_batch(X)]

    # -- text serialization (reference tree.cpp:209-242) -----------------
    def to_string(self) -> str:
        n = self.num_leaves
        m = n - 1
        lines = [f"num_leaves={n}", f"num_cat={self.num_cat}"]

        def arr(name, a, cnt, fmt=str):
            lines.append(f"{name}=" + " ".join(fmt(v) for v in a[:cnt]))

        arr("split_feature", self.split_feature, m)
        arr("split_gain", self.split_gain, m, lambda v: _fmt_float(v))
        arr("threshold", self.threshold, m, _fmt_double)
        arr("decision_type", self.decision_type, m)
        arr("left_child", self.left_child, m)
        arr("right_child", self.right_child, m)
        arr("leaf_value", self.leaf_value, n, _fmt_double)
        arr("leaf_count", self.leaf_count, n)
        arr("internal_value", self.internal_value, m, lambda v: _fmt_float(v))
        arr("internal_count", self.internal_count, m)
        if self.num_cat > 0:
            arr("cat_boundaries", np.asarray(self.cat_boundaries),
                self.num_cat + 1)
            arr("cat_threshold", np.asarray(self.cat_threshold, np.uint32),
                len(self.cat_threshold))
        lines.append(f"shrinkage={_fmt_float(self.shrinkage_rate)}")
        lines.append("")
        return "\n".join(lines)

    @classmethod
    def from_string(cls, text: str) -> "Tree":
        kv = {}
        for line in text.splitlines():
            line = line.strip()
            if "=" in line:
                k, v = line.split("=", 1)
                kv[k] = v
        n = int(kv["num_leaves"])
        t = cls(max(n, 2))
        t.num_leaves = n
        t.num_cat = int(kv.get("num_cat", 0))
        m = n - 1

        def parse(name, dtype, cnt):
            if cnt == 0 or not kv.get(name):
                return np.zeros(cnt, dtype)
            vals = kv[name].split()
            return np.asarray([float(v) for v in vals[:cnt]]).astype(dtype)

        t.split_feature[:m] = parse("split_feature", np.int32, m)
        t.split_feature_inner[:m] = t.split_feature[:m]
        t.split_gain[:m] = parse("split_gain", np.float32, m)
        t.threshold[:m] = parse("threshold", np.float64, m)
        t.decision_type[:m] = parse("decision_type", np.int8, m)
        t.left_child[:m] = parse("left_child", np.int32, m)
        t.right_child[:m] = parse("right_child", np.int32, m)
        t.leaf_value[:n] = parse("leaf_value", np.float64, n)
        t.leaf_count[:n] = parse("leaf_count", np.int32, n)
        t.internal_value[:m] = parse("internal_value", np.float64, m)
        t.internal_count[:m] = parse("internal_count", np.int32, m)
        if t.num_cat > 0:
            t.cat_boundaries = [int(v) for v in kv["cat_boundaries"].split()]
            t.cat_threshold = [int(v) for v in kv["cat_threshold"].split()]
        t.shrinkage_rate = float(kv.get("shrinkage", 1.0))
        # categorical thresholds are cat-node indices stored as doubles;
        # numerical threshold_bin / cat_left_bins need bin mappers — see
        # align_with_mappers
        cat_nodes = (t.decision_type[:m] & K_CATEGORICAL_MASK) != 0
        t.threshold_bin[:m] = np.where(cat_nodes,
                                       t.threshold[:m].astype(np.int32), 0)
        t._recompute_depth()
        return t

    def align_with_mappers(self, mappers, feature_to_inner=None) -> None:
        """Recover the bin-space thresholds (``threshold_bin``,
        ``cat_left_bins``) of a loaded tree from its real-valued ones
        through the training set's BinMappers (per ORIGINAL feature),
        so the tree can serve binned rows."""
        m = self.num_leaves - 1
        self.cat_left_bins = [np.zeros(0, np.int32)] * self.num_cat
        for node in range(m):
            f = int(self.split_feature[node])
            if feature_to_inner is not None:
                self.split_feature_inner[node] = feature_to_inner.get(f, 0)
            mapper = mappers[f]
            if self.decision_type[node] & K_CATEGORICAL_MASK:
                ci = int(self.threshold[node])
                self.threshold_bin[node] = ci
                words = self.cat_threshold[self.cat_boundaries[ci]:
                                           self.cat_boundaries[ci + 1]]
                bins = [mapper.categorical_2_bin[v]
                        for v in _bitset_to_values(words)
                        if v in mapper.categorical_2_bin]
                self.cat_left_bins[ci] = np.asarray(sorted(bins), np.int32)
            else:
                ub = mapper.bin_upper_bound
                if mapper.missing_type == MISSING_NAN:
                    ub = ub[:-1]
                # the model text holds ub[t] exactly (repr), so a
                # left bisection finds t
                self.threshold_bin[node] = min(
                    int(np.searchsorted(ub, self.threshold[node],
                                        side="left")),
                    max(len(ub) - 1, 0))

    def _recompute_depth(self) -> None:
        if self.num_leaves <= 1:
            return
        depth = np.zeros(self.num_leaves - 1, np.int32)
        for node in range(self.num_leaves - 1):
            for child in (self.left_child[node], self.right_child[node]):
                if child >= 0:
                    depth[child] = depth[node] + 1
                else:
                    self.leaf_depth[~child] = depth[node] + 1


def predict_leaf(trees: Sequence[Tree], X: np.ndarray) -> np.ndarray:
    """Per-tree leaf index per row over raw values -> ``[n, T]`` int32
    (PredictLeafIndex; the JAX package's ``GBDT.predict_leaf``): the
    host oracle that the compiled predictor (``serve/compiler.py``) is
    held to, categorical and missing-value nodes included."""
    X = np.asarray(X, np.float64)
    out = np.zeros((X.shape[0], len(trees)), np.int32)
    for i, t in enumerate(trees):
        out[:, i] = t.predict_leaf_batch(X)
    return out


def _fmt_float(v) -> str:
    return repr(round(float(v), 8)) if np.isfinite(v) else str(v)


def _construct_bitset(values: Sequence[int]) -> List[int]:
    """``Common::ConstructBitset`` (utils/common.h): uint32 words with
    bit ``v`` set for every ``v`` in ``values``."""
    if len(values) == 0:
        return [0]
    words = [0] * (max(values) // 32 + 1)
    for v in values:
        words[v // 32] |= (1 << (v % 32))
    return words


def _bitset_to_values(words: Sequence[int]) -> List[int]:
    """Expand a LightGBM uint32 bitset into its member values."""
    out = []
    for wi, w in enumerate(words):
        w = int(w)
        base = wi * 32
        while w:
            b = (w & -w).bit_length() - 1
            out.append(base + b)
            w &= w - 1
    return out
