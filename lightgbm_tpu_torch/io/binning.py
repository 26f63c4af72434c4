"""Feature binning (quantization) — a copy of the JAX package's
``io/binning.py`` (which imports no JAX); BinMappers are byte-identical.

Behavioral parity with the reference's ``BinMapper``
(reference `include/LightGBM/bin.h:89-215`, `src/io/bin.cpp:72-330`):
greedy bin-boundary search over sampled distinct values
(``GreedyFindBin`` `bin.cpp:72-149`), zero-as-one-bin handling
(``FindBinWithZeroAsOneBin`` `bin.cpp:151-206`), missing-value types
None/Zero/NaN (`bin.h:20-24`), and count-sorted categorical mapping
(`bin.cpp:300-330`).

Binning runs once at ingest on the host (numpy); the result feeds the
device-resident binned matrix (`io/dataset.py`, `io/device.py`).  There
are no per-storage-format Bin subclasses (dense/sparse/4-bit/ordered):
one dense uint8 column store feeds the kernels, so ``value_to_bin`` is
vectorized over whole columns.
"""
from __future__ import annotations

import bisect
import math
from typing import List, Optional, Sequence, Tuple

import numpy as np

K_ZERO_THRESHOLD = 1e-35          # reference bin.h kZeroThreshold
_K_SPARSE_THRESHOLD = 0.8

# MissingType (reference bin.h:20-24)
MISSING_NONE = 0
MISSING_ZERO = 1
MISSING_NAN = 2

# BinType (reference bin.h)
BIN_NUMERICAL = 0
BIN_CATEGORICAL = 1


def _double_upper_bound(x: float) -> float:
    """Next representable float32-safe upper bound (reference uses
    ``Common::GetDoubleUpperBound`` = std::nextafter towards +inf)."""
    return float(np.nextafter(np.float64(x), np.float64(np.inf)))


def greedy_find_bin(distinct_values: np.ndarray, counts: np.ndarray,
                    max_bin: int, total_cnt: int,
                    min_data_in_bin: int) -> List[float]:
    """Greedy bin boundary search (reference bin.cpp:72-149).

    Returns upper bounds; last is +inf.  When there are few distinct values
    each gets its own bin (subject to min_data_in_bin); otherwise boundaries
    are placed to even out per-bin counts, with over-represented single
    values ("big" values) pinned to their own bins.
    """
    num_distinct = len(distinct_values)
    assert max_bin > 0
    bin_upper_bound: List[float] = []
    if num_distinct <= max_bin:
        cur_cnt = 0
        for i in range(num_distinct - 1):
            cur_cnt += int(counts[i])
            if cur_cnt >= min_data_in_bin:
                val = _double_upper_bound((distinct_values[i] + distinct_values[i + 1]) / 2.0)
                if not bin_upper_bound or val > bin_upper_bound[-1]:
                    bin_upper_bound.append(val)
                    cur_cnt = 0
        bin_upper_bound.append(math.inf)
        return bin_upper_bound

    if min_data_in_bin > 0:
        max_bin = min(max_bin, max(1, total_cnt // min_data_in_bin))
    mean_bin_size = total_cnt / max_bin
    rest_bin_cnt = max_bin
    rest_sample_cnt = total_cnt
    is_big = counts >= mean_bin_size
    rest_bin_cnt -= int(is_big.sum())
    rest_sample_cnt -= int(counts[is_big].sum())
    if rest_bin_cnt > 0:
        mean_bin_size = rest_sample_cnt / rest_bin_cnt

    upper_bounds = [math.inf] * max_bin
    lower_bounds = [math.inf] * max_bin
    bin_cnt = 0
    lower_bounds[0] = float(distinct_values[0])
    # the reference walks the distinct values one by one, adding each
    # count to the current bin until a boundary; here each boundary is
    # found by binary searches over the prefix counts (the same walk)
    last = num_distinct - 1            # candidates i < last
    cum = [0] + np.cumsum(counts, dtype=np.int64).tolist()
    small = [0] + np.cumsum(np.where(is_big, 0, counts),
                            dtype=np.int64).tolist()
    big = np.flatnonzero(is_big)

    def first_reaching(start, need):
        # first i in [start, last) whose current count reaches ``need``
        return bisect.bisect_left(range(start, last), True,
                                  key=lambda i: cum[i + 1] - cum[start]
                                  >= need) + start

    def first_big(at):
        k = int(np.searchsorted(big, at))
        return int(big[k]) if k < len(big) else num_distinct

    start = 0
    while start < last:
        half = max(1.0, mean_bin_size * 0.5)
        i = min(first_big(start), first_reaching(start, mean_bin_size),
                first_big(first_reaching(start, half) + 1) - 1)
        if i >= last:
            break
        rest_sample_cnt -= small[i + 1] - small[start]
        upper_bounds[bin_cnt] = float(distinct_values[i])
        bin_cnt += 1
        lower_bounds[bin_cnt] = float(distinct_values[i + 1])
        if bin_cnt >= max_bin - 1:
            break
        if not is_big[i]:
            rest_bin_cnt -= 1
            # C++ double division tolerates rest_bin_cnt==0 (yields inf)
            mean_bin_size = (rest_sample_cnt / rest_bin_cnt
                             if rest_bin_cnt > 0 else math.inf)
        start = i + 1
    bin_cnt += 1
    for i in range(bin_cnt - 1):
        val = _double_upper_bound((upper_bounds[i] + lower_bounds[i + 1]) / 2.0)
        if not bin_upper_bound or val > bin_upper_bound[-1]:
            bin_upper_bound.append(val)
    bin_upper_bound.append(math.inf)
    return bin_upper_bound


def _distinct_counts(values: np.ndarray, zero_cnt: int):
    """Distinct sorted values and their counts, with zero (``zero_cnt``
    of it) spliced at its sorted position (reference bin.cpp FindBin):
    before the first value when every value is positive, between the
    last negative and the first positive, after the last when every
    value is negative.  A run of equal values keeps its last."""
    zero = (np.array([0.0]), np.array([zero_cnt], np.int64))
    if len(values) == 0:
        return zero
    n = len(values)
    starts = np.flatnonzero(np.concatenate([[True],
                                            values[1:] > values[:-1]]))
    ends = np.append(starts[1:], n)
    dv, cnts = values[ends - 1], (ends - starts).astype(np.int64)
    cross = np.flatnonzero((dv[:-1] < 0.0) & (dv[1:] > 0.0)) + 1
    at = None
    if values[0] > 0.0 and zero_cnt > 0:
        at = 0
    elif len(cross):
        at = int(cross[0])
    elif values[-1] < 0.0 and zero_cnt > 0:
        at = len(dv)
    if at is not None:
        dv = np.insert(dv, at, 0.0)
        cnts = np.insert(cnts, at, zero_cnt)
    return dv, cnts


def find_bin_with_zero_as_one_bin(distinct_values: np.ndarray, counts: np.ndarray,
                                  max_bin: int, total_sample_cnt: int,
                                  min_data_in_bin: int) -> List[float]:
    """Reserve a dedicated bin straddling zero (reference bin.cpp:151-206)."""
    dv = np.asarray(distinct_values, dtype=np.float64)
    cnts = np.asarray(counts, dtype=np.int64)
    left_mask = dv <= -K_ZERO_THRESHOLD
    right_mask = dv > K_ZERO_THRESHOLD
    zero_mask = ~left_mask & ~right_mask
    left_cnt_data = int(cnts[left_mask].sum())
    cnt_zero = int(cnts[zero_mask].sum())
    right_cnt_data = int(cnts[right_mask].sum())

    left_idx = np.nonzero(~left_mask)[0]
    left_cnt = int(left_idx[0]) if len(left_idx) else len(dv)

    bin_upper_bound: List[float] = []
    if left_cnt > 0:
        denom = max(1, total_sample_cnt - cnt_zero)
        left_max_bin = max(1, int(left_cnt_data / denom * (max_bin - 1)))
        bin_upper_bound = greedy_find_bin(dv[:left_cnt], cnts[:left_cnt],
                                          left_max_bin, left_cnt_data, min_data_in_bin)
        bin_upper_bound[-1] = -K_ZERO_THRESHOLD

    right_idx = np.nonzero(right_mask[left_cnt:])[0]
    right_start = left_cnt + int(right_idx[0]) if len(right_idx) else -1

    if right_start >= 0:
        right_max_bin = max_bin - 1 - len(bin_upper_bound)
        assert right_max_bin > 0
        right_bounds = greedy_find_bin(dv[right_start:], cnts[right_start:],
                                       right_max_bin, right_cnt_data, min_data_in_bin)
        bin_upper_bound.append(K_ZERO_THRESHOLD)
        bin_upper_bound.extend(right_bounds)
    else:
        bin_upper_bound.append(math.inf)
    return bin_upper_bound


class BinMapper:
    """Per-feature value→bin mapping (reference bin.h:89-215)."""

    def __init__(self) -> None:
        self.num_bin: int = 1
        self.missing_type: int = MISSING_NONE
        self.is_trivial: bool = True
        self.sparse_rate: float = 0.0
        self.bin_type: int = BIN_NUMERICAL
        self.bin_upper_bound: np.ndarray = np.array([math.inf])
        self.categorical_2_bin: dict = {}
        self.bin_2_categorical: List[int] = []
        self.min_val: float = 0.0
        self.max_val: float = 0.0
        self.default_bin: int = 0

    # ------------------------------------------------------------------
    def find_bin(self, values: np.ndarray, total_sample_cnt: int, max_bin: int,
                 min_data_in_bin: int = 3, min_split_data: int = 0,
                 bin_type: int = BIN_NUMERICAL, use_missing: bool = True,
                 zero_as_missing: bool = False) -> None:
        """Compute bin boundaries from sampled values (reference bin.cpp:208-330).

        ``values`` are the sampled *non-zero* values (zeros are implied by
        ``total_sample_cnt - len(values)``, matching the reference's sparse
        sampling contract).
        """
        from ..obs import span
        with span("io.find_bin"):
            self._find_bin(values, total_sample_cnt, max_bin,
                           min_data_in_bin, min_split_data, bin_type,
                           use_missing, zero_as_missing)

    def _find_bin(self, values, total_sample_cnt, max_bin, min_data_in_bin,
                  min_split_data, bin_type, use_missing,
                  zero_as_missing) -> None:
        values = np.asarray(values, dtype=np.float64)
        nan_mask = np.isnan(values)
        na_cnt = int(nan_mask.sum())
        values = values[~nan_mask]

        if not use_missing:
            self.missing_type = MISSING_NONE
        elif zero_as_missing:
            self.missing_type = MISSING_ZERO
        else:
            self.missing_type = MISSING_NAN if na_cnt > 0 else MISSING_NONE

        self.bin_type = bin_type
        self.default_bin = 0
        zero_cnt = int(total_sample_cnt - len(values) - na_cnt)

        dv, cnts = _distinct_counts(np.sort(values), zero_cnt)
        if len(dv) == 0:
            dv = np.array([0.0])
            cnts = np.array([max(0, zero_cnt)], dtype=np.int64)
        self.min_val = float(dv[0])
        self.max_val = float(dv[-1])
        num_distinct = len(dv)

        if bin_type == BIN_NUMERICAL:
            if self.missing_type == MISSING_ZERO:
                bub = find_bin_with_zero_as_one_bin(dv, cnts, max_bin,
                                                    total_sample_cnt, min_data_in_bin)
                if len(bub) == 2:
                    self.missing_type = MISSING_NONE
            elif self.missing_type == MISSING_NONE:
                bub = find_bin_with_zero_as_one_bin(dv, cnts, max_bin,
                                                    total_sample_cnt, min_data_in_bin)
            else:
                bub = find_bin_with_zero_as_one_bin(dv, cnts, max_bin - 1,
                                                    total_sample_cnt - na_cnt,
                                                    min_data_in_bin)
                bub.append(math.nan)     # last bin reserved for NaN
            self.bin_upper_bound = np.asarray(bub, dtype=np.float64)
            self.num_bin = len(bub)
            # default bin = bin containing 0.0
            finite = self.bin_upper_bound.copy()
            if self.missing_type == MISSING_NAN:
                finite = finite[:-1]
            self.default_bin = int(np.searchsorted(finite, 0.0, side="left"))
            cnt_in_bin = self._count_in_bin(dv, cnts, na_cnt)
        else:
            # categorical: non-negative ints, sorted by count desc (bin.cpp:300-330)
            ints = dv.astype(np.int64)
            neg = ints < 0
            na_cnt += int(cnts[neg].sum())
            ints, cnts2 = ints[~neg], cnts[~neg]
            # merge duplicate ints (possible after float->int cast)
            uniq, inv = np.unique(ints, return_inverse=True)
            merged = np.zeros(len(uniq), dtype=np.int64)
            np.add.at(merged, inv, cnts2)
            order = np.argsort(-merged, kind="stable")
            cats = uniq[order]
            ccnt = merged[order]
            # avoid category 0 landing in bin 0 (reference bin.cpp:321-329)
            if len(cats) and cats[0] == 0:
                if len(cats) == 1:
                    cats = np.append(cats, cats[0] + 1)
                    ccnt = np.append(ccnt, 0)
                cats[[0, 1]] = cats[[1, 0]]
                ccnt[[0, 1]] = ccnt[[1, 0]]
            # drop rare categories: keep 99% of data (reference cut_cnt logic)
            if len(cats) == 0:
                cats = np.array([0], dtype=np.int64)
                ccnt = np.array([max(0, total_sample_cnt - na_cnt)], dtype=np.int64)
            cut = int(0.99 * (total_sample_cnt - na_cnt))
            keep = 0
            acc = 0
            for i in range(len(cats)):
                if acc >= cut or keep >= max_bin:
                    break
                acc += int(ccnt[i])
                keep += 1
            keep = max(1, keep)
            cats, ccnt = cats[:keep], ccnt[:keep]
            self.bin_2_categorical = [int(c) for c in cats]
            self.categorical_2_bin = {int(c): i for i, c in enumerate(cats)}
            self.num_bin = len(cats)
            self.missing_type = MISSING_NAN if na_cnt > 0 else MISSING_NONE
            self.default_bin = int(self.categorical_2_bin.get(0, 0))
            cnt_in_bin = ccnt

        # trivial / sparse-rate bookkeeping (bin.cpp tail of FindBin)
        self.is_trivial = self.num_bin <= 1
        if total_sample_cnt > 0 and len(cnt_in_bin) > self.default_bin:
            self.sparse_rate = float(cnt_in_bin[self.default_bin]) / total_sample_cnt
        else:
            self.sparse_rate = 0.0

    def _count_in_bin(self, dv: np.ndarray, cnts: np.ndarray, na_cnt: int) -> np.ndarray:
        cnt_in_bin = np.zeros(self.num_bin, dtype=np.int64)
        finite_bounds = self.bin_upper_bound
        if self.missing_type == MISSING_NAN:
            finite_bounds = finite_bounds[:-1]
        idx = np.searchsorted(finite_bounds, dv, side="left")
        idx = np.minimum(idx, self.num_bin - 1)
        np.add.at(cnt_in_bin, idx, cnts)
        if self.missing_type == MISSING_NAN:
            cnt_in_bin[self.num_bin - 1] = na_cnt
        return cnt_in_bin

    # ------------------------------------------------------------------
    def value_to_bin(self, values: np.ndarray,
                     prediction_mode: bool = False) -> np.ndarray:
        """Vectorized value→bin (reference bin.h:450-486 binary search).

        ``prediction_mode`` affects categorical features only: unseen /
        negative / NaN categories map to the sentinel bin ``num_bin``
        (beyond every split mask, so they go RIGHT — the reference's
        raw-value ``CategoricalDecision`` semantics, `tree.h:252-271`)
        instead of the train-binning miss bin ``num_bin - 1``
        (`bin.h:470-485`).
        """
        values = np.asarray(values, dtype=np.float64)
        if self.bin_type == BIN_CATEGORICAL:
            ints = np.where(np.isnan(values), -1, values).astype(np.int64)
            cats = np.asarray(self.bin_2_categorical, dtype=np.int64)
            sorter = np.argsort(cats)
            pos = np.searchsorted(cats[sorter], ints)
            pos = np.clip(pos, 0, len(cats) - 1)
            hit = cats[sorter[pos]] == ints
            miss_bin = self.num_bin if prediction_mode else self.num_bin - 1
            out = np.where(hit, sorter[pos], miss_bin).astype(np.int32)
            return out

        nan_mask = np.isnan(values)
        if self.missing_type != MISSING_NAN:
            # reference ValueToBin converts NaN to 0.0 when the feature has no
            # NaN bin (MissingType None/Zero)
            values = np.where(nan_mask, 0.0, values)
            nan_mask = np.zeros_like(nan_mask)
        finite_bounds = self.bin_upper_bound
        if self.missing_type == MISSING_NAN:
            finite_bounds = finite_bounds[:-1]
        # bin = first i with value <= upper_bound[i]
        out = np.searchsorted(finite_bounds, values, side="left").astype(np.int32)
        out = np.minimum(out, self.num_bin - 1)
        if self.missing_type == MISSING_NAN:
            out[nan_mask] = self.num_bin - 1
        return out

    def bin_to_value(self, bin_idx: int) -> float:
        """Representative value for a bin (reference bin.h:107-113)."""
        if self.bin_type == BIN_CATEGORICAL:
            return float(self.bin_2_categorical[bin_idx])
        if bin_idx >= len(self.bin_upper_bound):
            return self.max_val
        return float(self.bin_upper_bound[bin_idx])

    def threshold_value(self, threshold_bin: int) -> float:
        """Real-valued split threshold for model serialization: the bin upper
        bound (left subtree takes value <= threshold)."""
        ub = self.bin_upper_bound
        if self.missing_type == MISSING_NAN:
            ub = ub[:-1]
        t = min(threshold_bin, len(ub) - 1)
        v = float(ub[t])
        return v

    # serialization ----------------------------------------------------
    def to_dict(self) -> dict:
        return {
            "num_bin": self.num_bin,
            "missing_type": self.missing_type,
            "is_trivial": self.is_trivial,
            "sparse_rate": self.sparse_rate,
            "bin_type": self.bin_type,
            "bin_upper_bound": [float(v) for v in self.bin_upper_bound],
            "bin_2_categorical": list(self.bin_2_categorical),
            "min_val": self.min_val,
            "max_val": self.max_val,
            "default_bin": self.default_bin,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "BinMapper":
        m = cls()
        m.num_bin = int(d["num_bin"])
        m.missing_type = int(d["missing_type"])
        m.is_trivial = bool(d["is_trivial"])
        m.sparse_rate = float(d["sparse_rate"])
        m.bin_type = int(d["bin_type"])
        m.bin_upper_bound = np.asarray(d["bin_upper_bound"], dtype=np.float64)
        m.bin_2_categorical = [int(c) for c in d["bin_2_categorical"]]
        m.categorical_2_bin = {c: i for i, c in enumerate(m.bin_2_categorical)}
        m.min_val = float(d["min_val"])
        m.max_val = float(d["max_val"])
        m.default_bin = int(d["default_bin"])
        return m
