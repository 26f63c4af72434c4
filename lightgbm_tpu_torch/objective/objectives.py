"""Objective functions: gradients and hessians as torch transforms.

Port of the JAX package's ``objective/objectives.py`` (reference
``regression_objective.hpp``, ``binary_objective.hpp``,
``multiclass_objective.hpp``, ``rank_objective.hpp``,
``xentropy_objective.hpp``; factory ``objective_function.cpp:10-47``),
with labels, weights and the ranking tables as tensors on the training
device.  Arithmetic follows the reference's operation order: a division
by a tensor is written as a tensor division (torch's ``scalar / tensor``
multiplies by a reciprocal, another rounding), and sums over a short
axis are written out in order.

Interface, as in the reference:

* ``get_gradients(score)`` -> ``(grad, hess)``; ``score`` is ``[n]``, or
  ``[n, K]`` for the multiclass objectives (``num_model_per_iteration``
  trees an iteration); ``get_gradients_k`` takes and returns ``[n, K]``
  for every objective.
* ``boost_from_score()`` -- the initial score (``BoostFromScore``).
* ``renew_tree_output(score, row_leaf, num_leaves)`` -- the leaf re-fit
  of L1, quantile and MAPE (``RenewTreeOutput``), a per-leaf percentile
  of the residuals (:func:`leaf_percentile`).
* ``convert_output(score)`` -- the link inversion for prediction.

A loaded model's objective line goes through :func:`load_objective`:
the same classes, which write the line back as they read it.
"""
from __future__ import annotations

import math
import os
from typing import Optional

import numpy as np
import torch

from ..config import Config, _canonical_objective
from ..ops.split import prefix_sum, sort_key

# pair-grid entries of one lambdarank dispatch (the JAX package's
# LGBM_TPU_RANK_CHUNK_PAIRS): bounds the [C, T, M] intermediates
RANK_CHUNK_PAIRS = 8_000_000


# numpy 2.0's float reduction order (``pairwise_sum`` of
# numpy/_core/src/umath/loops_utils.h.src, called on 8,192-element
# buffers): 8 running sums over blocks of up to 128 values, blocks halved
# at multiples of 8, and the buffers' sums added in order from 0
HOST_SUM_BUFFER = 8192
HOST_SUM_BLOCK = 128
HOST_SUM_UNROLL = 8


def _pairwise_rows(a: np.ndarray) -> np.ndarray:
    """numpy's ``pairwise_sum`` of each row of ``a`` ``[k, n]``, in
    ``a``'s dtype."""
    n = a.shape[1]
    u = HOST_SUM_UNROLL
    if n < u:
        acc = np.zeros(a.shape[0], a.dtype)
        for i in range(n):
            acc = acc + a[:, i]
        return acc
    if n <= HOST_SUM_BLOCK:
        m = n - n % u
        r = a[:, :u].copy()
        for i in range(u, m, u):
            r += a[:, i:i + u]
        acc = (((r[:, 0] + r[:, 1]) + (r[:, 2] + r[:, 3]))
               + ((r[:, 4] + r[:, 5]) + (r[:, 6] + r[:, 7])))
        for i in range(m, n):
            acc = acc + a[:, i]
        return acc
    half = n // 2
    half -= half % u
    return _pairwise_rows(a[:, :half]) + _pairwise_rows(a[:, half:])


def host_sum(a: np.ndarray):
    """The sum of a host array in one fixed order, in its dtype: the order
    numpy 2.0 sums in, whatever numpy this host has.

    A label mean taken with ``ndarray.mean`` follows the installed
    numpy's reduction, and that order changed between numpy builds (a
    newer numpy on an AVX-512 host rounds the headline's f32 latent mean
    an ulp away), so an init score, and every leaf value after it, would
    depend on the host.  The JAX package's models were trained with
    numpy 2.0's order."""
    a = np.ascontiguousarray(a).ravel()
    n, B = a.shape[0], HOST_SUM_BUFFER
    full = n // B
    parts = []
    if full:
        parts.extend(_pairwise_rows(a[:full * B].reshape(full, B)))
    if n % B:
        parts.extend(_pairwise_rows(a[full * B:][None, :]))
    acc = a.dtype.type(0)
    for p in parts:
        acc = a.dtype.type(acc + p)
    return acc


def host_mean(a: np.ndarray):
    """``a.mean()`` in :func:`host_sum`'s order."""
    a = np.asarray(a)
    return host_sum(a) / a.dtype.type(a.size)


def _apply_weight(grad, hess, weight):
    if weight is None:
        return grad, hess
    return grad * weight, hess * weight


def _div(num: float, den: torch.Tensor) -> torch.Tensor:
    """``num / den`` rounded once, as the reference divides (torch's
    ``float / tensor`` takes the reciprocal first)."""
    return torch.div(torch.full_like(den, num), den)


def _row_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last (short) axis, in order from the first column,
    keeping it: the reference's compiled reduction over K classes."""
    acc = x[..., 0]
    for k in range(1, x.shape[-1]):
        acc = acc + x[..., k]
    return acc[..., None]


class ObjectiveFunction:
    """Base class (reference include/LightGBM/objective_function.h)."""
    name = "none"
    num_model_per_iteration = 1
    need_renew_tree_output = False
    # a loaded model's objective line, written back unchanged
    text: Optional[str] = None

    def __init__(self, config: Config):
        self.config = config
        self.label: Optional[torch.Tensor] = None
        self.weight: Optional[torch.Tensor] = None
        self.query_boundaries: Optional[np.ndarray] = None
        self.num_data = 0
        # the renewal's weights over every rank's rows (globalize_rows)
        self.global_renew_weight: Optional[torch.Tensor] = None

    def init(self, metadata, num_data: int, device="cpu") -> None:
        self.num_data = num_data
        self._label_np = (np.asarray(metadata.label, np.float32)
                          if metadata.label is not None
                          else np.zeros(num_data, np.float32))
        self._weight_np = (np.asarray(metadata.weight, np.float32)
                           if metadata.weight is not None else None)
        self.label = torch.as_tensor(self._label_np, device=device)
        self.weight = (torch.as_tensor(self._weight_np, device=device)
                       if self._weight_np is not None else None)
        qb = getattr(metadata, "query_boundaries", None)
        if qb is not None:
            self.query_boundaries = np.asarray(qb)
        self._check_label()

    def _host_label_mean(self) -> float:
        y = self._label_np
        if self._weight_np is not None:
            w = self._weight_np
            return float(host_sum(y * w) / host_sum(w))
        return float(host_mean(y))

    # True when boost_from_score keys on the weighted label mean
    # (xentlambda uses the plain one): multi-process init picks the
    # global statistic by it
    boost_mean_weighted = True

    def globalize_rows(self, allgather) -> None:
        """Multi-process training (the JAX package's ``globalize_rows``):
        recompute dataset-level statistics over every rank's rows.  Each
        rank's per-row state for the gradients stays its own rows; an
        objective that renews its leaves also lays the percentile's
        per-row weights (:meth:`renew_weight`: MAPE's ``label_weight``)
        over the global row axis (every rank's rows, rank-major: the JAX
        package's mesh order), which :meth:`renew_tree_output` reads
        under a process group.  ``allgather(obj) -> per-rank list``.
        Subclasses with dataset-level scalars override (and call
        super)."""
        w = self.renew_weight() if self.need_renew_tree_output else None
        if w is not None:
            self.global_renew_weight = torch.as_tensor(
                np.concatenate(allgather(w.cpu().numpy())), device=w.device)

    def boost_from_score_global(self, allgather) -> float:
        """Cross-process ``BoostFromScore``: the init score of every
        objective here is a function of the (weighted) label mean, so the
        mean's sufficient statistics are allgathered (float64 sums) and
        the objective's own link evaluated on a one-row stand-in."""
        y = np.asarray(self._label_np, np.float64)
        use_w = self.boost_mean_weighted and self._weight_np is not None
        w = (np.asarray(self._weight_np, np.float64) if use_w
             else np.ones_like(y))
        sums = allgather([float(host_sum(y * w)), float(host_sum(w))])
        gmean = (sum(s[0] for s in sums)
                 / max(sum(s[1] for s in sums), 1e-30))
        saved = (self._label_np, self._weight_np)
        try:
            self._label_np = np.array([gmean], np.float64)
            self._weight_np = None
            return self.boost_from_score()
        finally:
            self._label_np, self._weight_np = saved

    def _check_label(self) -> None:
        pass

    def get_gradients(self, score: torch.Tensor):
        raise NotImplementedError

    def get_gradients_k(self, score: torch.Tensor):
        """``(grad, hess)``, each ``[n, K]``, of scores ``[n, K]``: the
        trainers' one shape, whatever ``K``."""
        if self.num_model_per_iteration > 1:
            return self.get_gradients(score)
        g, h = self.get_gradients(score[:, 0])
        return g[:, None], h[:, None]

    def boost_from_score(self) -> float:
        return 0.0

    def convert_output(self, score: torch.Tensor) -> torch.Tensor:
        return score

    # the percentile a renewing objective reads (need_renew_tree_output)
    renew_alpha = 0.5

    def renew_tree_output(self, score, row_leaf, num_leaves,
                          gather_rows=None):
        """Per-leaf output of the renewed tree, or None: the
        :func:`leaf_percentile` at ``renew_alpha`` of ``label - score``
        in each leaf, weighted by :meth:`renew_weight`.  Under a process
        group ``gather_rows(t) -> t`` lays a per-row tensor of this rank
        over the global row axis, and each leaf's percentile runs over
        every rank's rows (the weights then the global ones
        :meth:`globalize_rows` laid out)."""
        if not self.need_renew_tree_output:
            return None
        resid, weight = self.label - score, self.renew_weight()
        if gather_rows is not None:
            resid, row_leaf = gather_rows(resid), gather_rows(row_leaf)
            weight = self.global_renew_weight
        return leaf_percentile(resid, row_leaf, num_leaves,
                               self.renew_alpha, weight)

    def renew_weight(self) -> Optional[torch.Tensor]:
        """The per-row weights of the renewal's percentile (None: every
        row weighs 1)."""
        return self.weight

    def describe(self) -> str:
        return self.name

    def to_string(self) -> str:
        return self.text or self.describe()


# ---------------------------------------------------------------------------
# Regression family (reference regression_objective.hpp)
# ---------------------------------------------------------------------------
class RegressionL2(ObjectiveFunction):
    name = "regression"

    def __init__(self, config: Config):
        super().__init__(config)
        self.sqrt = bool(config.reg_sqrt)

    def init(self, metadata, num_data, device="cpu"):
        super().init(metadata, num_data, device)
        if self.sqrt:
            # the model learns sign(y) * sqrt(|y|)
            self._label_np = (np.sign(self._label_np)
                              * np.sqrt(np.abs(self._label_np)))
            self.label = torch.as_tensor(self._label_np, device=device)

    def get_gradients(self, score):
        grad = score - self.label
        hess = torch.ones_like(score)
        return _apply_weight(grad, hess, self.weight)

    def boost_from_score(self):
        return self._host_label_mean()

    def convert_output(self, score):
        if self.sqrt:
            return torch.sign(score) * score * score
        return score

    def describe(self):
        return "regression sqrt" if self.sqrt else "regression"


class RegressionL1(ObjectiveFunction):
    name = "regression_l1"
    need_renew_tree_output = True

    def get_gradients(self, score):
        grad = torch.sign(score - self.label)
        hess = torch.ones_like(score)
        return _apply_weight(grad, hess, self.weight)


class Huber(ObjectiveFunction):
    name = "huber"

    def __init__(self, config: Config):
        super().__init__(config)
        self.alpha = float(config.alpha)

    def get_gradients(self, score):
        grad = torch.clamp(score - self.label, -self.alpha, self.alpha)
        hess = torch.ones_like(score)
        return _apply_weight(grad, hess, self.weight)


class Fair(ObjectiveFunction):
    name = "fair"

    def __init__(self, config: Config):
        super().__init__(config)
        self.c = float(config.fair_c)

    def get_gradients(self, score):
        diff = score - self.label
        denom = torch.abs(diff) + self.c
        grad = self.c * diff / denom
        hess = _div(self.c * self.c, denom * denom)
        return _apply_weight(grad, hess, self.weight)


class Poisson(ObjectiveFunction):
    name = "poisson"

    def __init__(self, config: Config):
        super().__init__(config)
        self.max_delta_step = float(config.poisson_max_delta_step)

    def _check_label(self):
        if (self._label_np < 0).any():
            raise ValueError("poisson objective requires non-negative labels")

    def get_gradients(self, score):
        grad = torch.exp(score) - self.label
        hess = torch.exp(score + self.max_delta_step)
        return _apply_weight(grad, hess, self.weight)

    def boost_from_score(self):
        return float(np.log(max(self._host_label_mean(), 1e-20)))

    def convert_output(self, score):
        return torch.exp(score)


class Quantile(ObjectiveFunction):
    name = "quantile"
    need_renew_tree_output = True

    def __init__(self, config: Config):
        super().__init__(config)
        self.alpha = self.renew_alpha = float(config.alpha)

    def get_gradients(self, score):
        diff = score - self.label
        grad = torch.where(diff >= 0, 1.0 - self.alpha, -self.alpha)
        hess = torch.ones_like(score)
        return _apply_weight(grad, hess, self.weight)


class Mape(ObjectiveFunction):
    name = "mape"
    need_renew_tree_output = True

    def init(self, metadata, num_data, device="cpu"):
        super().init(metadata, num_data, device)
        lw = _div(1.0, torch.clamp(torch.abs(self.label), min=1.0))
        self.label_weight = lw if self.weight is None else lw * self.weight

    def get_gradients(self, score):
        grad = torch.sign(score - self.label) * self.label_weight
        hess = torch.ones_like(score) * (
            self.label_weight if self.weight is None else self.weight)
        return grad, hess

    def renew_weight(self):
        # realigned over the global row axis by globalize_rows
        return self.label_weight


class Gamma(Poisson):
    name = "gamma"

    def get_gradients(self, score):
        ems = torch.exp(-score)
        grad = 1.0 - self.label * ems
        hess = self.label * ems
        return _apply_weight(grad, hess, self.weight)


class Tweedie(Poisson):
    name = "tweedie"

    def __init__(self, config: Config):
        super().__init__(config)
        self.rho = float(config.tweedie_variance_power)

    def get_gradients(self, score):
        e1 = torch.exp((1.0 - self.rho) * score)
        e2 = torch.exp((2.0 - self.rho) * score)
        grad = -self.label * e1 + e2
        hess = (-self.label * (1.0 - self.rho) * e1
                + (2.0 - self.rho) * e2)
        return _apply_weight(grad, hess, self.weight)


# ---------------------------------------------------------------------------
# Binary (reference binary_objective.hpp:13-157)
# ---------------------------------------------------------------------------
class BinaryLogloss(ObjectiveFunction):
    name = "binary"

    def __init__(self, config: Config):
        super().__init__(config)
        self.sigmoid = float(config.sigmoid)
        self.is_unbalance = bool(config.is_unbalance)
        self.scale_pos_weight = float(config.scale_pos_weight)
        self.label_weights = (1.0, 1.0)

    def _check_label(self):
        u = np.unique(self._label_np)
        if not np.all(np.isin(u, [0.0, 1.0])):
            raise ValueError("binary objective requires labels in {0, 1}")

    def init(self, metadata, num_data, device="cpu"):
        super().init(metadata, num_data, device)
        cnt_pos = float((self._label_np > 0).sum())
        cnt_neg = float(num_data - cnt_pos)
        self._cnt_pos, self._cnt_neg = cnt_pos, cnt_neg
        if self.is_unbalance and cnt_pos > 0 and cnt_neg > 0:
            if cnt_pos > cnt_neg:
                self.label_weights = (1.0, cnt_pos / cnt_neg)
            else:
                self.label_weights = (cnt_neg / cnt_pos, 1.0)
        else:
            self.label_weights = (1.0, self.scale_pos_weight)

    def globalize_rows(self, allgather):
        super().globalize_rows(allgather)
        if self.is_unbalance:
            # class counts are a global statistic: per-rank counts would
            # weight the ranks' gradients differently
            counts = allgather([self._cnt_pos, self._cnt_neg])
            cnt_pos = sum(c[0] for c in counts)
            cnt_neg = sum(c[1] for c in counts)
            self._cnt_pos, self._cnt_neg = cnt_pos, cnt_neg
            if cnt_pos > 0 and cnt_neg > 0:
                self.label_weights = ((1.0, cnt_pos / cnt_neg)
                                      if cnt_pos > cnt_neg
                                      else (cnt_neg / cnt_pos, 1.0))

    def get_gradients(self, score):
        y = self.label
        p = torch.sigmoid(self.sigmoid * score)
        w_cls = torch.where(
            y > 0, torch.tensor(self.label_weights[1], dtype=torch.float32,
                                device=y.device),
            torch.tensor(self.label_weights[0], dtype=torch.float32,
                         device=y.device))
        grad = self.sigmoid * (p - y) * w_cls
        hess = self.sigmoid * self.sigmoid * p * (1.0 - p) * w_cls
        return _apply_weight(grad, hess, self.weight)

    def boost_from_score(self):
        pavg = min(max(self._host_label_mean(), 1e-15), 1.0 - 1e-15)
        return float(np.log(pavg / (1.0 - pavg)) / self.sigmoid)

    def convert_output(self, score):
        return torch.sigmoid(self.sigmoid * score)

    def describe(self):
        return f"binary sigmoid:{self.sigmoid}"


# ---------------------------------------------------------------------------
# Multiclass (reference multiclass_objective.hpp:16-225)
# ---------------------------------------------------------------------------
def softmax(score: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softmax`` over the last axis, in its operation order: the
    max subtracted, ``exp``, the sum over classes in order, one divide."""
    u = torch.exp(score - score.max(dim=-1, keepdim=True).values)
    return u / _row_sum(u)


def _one_hot(label: torch.Tensor, K: int) -> torch.Tensor:
    return torch.nn.functional.one_hot(label.to(torch.int64), K).to(
        torch.float32)


class MulticlassSoftmax(ObjectiveFunction):
    name = "multiclass"

    def __init__(self, config: Config):
        super().__init__(config)
        self.num_class = int(config.num_class)
        self.num_model_per_iteration = self.num_class

    def _check_label(self):
        lab = self._label_np
        if lab.min() < 0 or lab.max() >= self.num_class:
            raise ValueError(
                f"multiclass labels must be in [0, {self.num_class})")

    def get_gradients(self, score):
        """``score`` ``[n, K]`` raw -> grad, hess ``[n, K]``."""
        p = softmax(score)
        grad = p - _one_hot(self.label, self.num_class)
        hess = 2.0 * p * (1.0 - p)      # the reference's factor-2 bound
        if self.weight is not None:
            grad = grad * self.weight[:, None]
            hess = hess * self.weight[:, None]
        return grad, hess

    def convert_output(self, score):
        return softmax(score)

    def describe(self):
        return f"multiclass num_class:{self.num_class}"


class MulticlassOVA(ObjectiveFunction):
    name = "multiclassova"

    def __init__(self, config: Config):
        super().__init__(config)
        self.num_class = int(config.num_class)
        self.num_model_per_iteration = self.num_class
        self.sigmoid = float(config.sigmoid)

    def get_gradients(self, score):
        y = _one_hot(self.label, self.num_class)
        p = torch.sigmoid(self.sigmoid * score)
        grad = self.sigmoid * (p - y)
        hess = self.sigmoid * self.sigmoid * p * (1.0 - p)
        if self.weight is not None:
            grad = grad * self.weight[:, None]
            hess = hess * self.weight[:, None]
        return grad, hess

    def convert_output(self, score):
        return torch.sigmoid(self.sigmoid * score)

    def describe(self):
        return (f"multiclassova num_class:{self.num_class} "
                f"sigmoid:{self.sigmoid}")


# ---------------------------------------------------------------------------
# Cross-entropy (reference xentropy_objective.hpp:39-270)
# ---------------------------------------------------------------------------
class CrossEntropy(ObjectiveFunction):
    name = "xentropy"

    def _check_label(self):
        lab = self._label_np
        if lab.min() < 0 or lab.max() > 1:
            raise ValueError("xentropy labels must be in [0, 1]")

    def get_gradients(self, score):
        p = torch.sigmoid(score)
        grad = p - self.label
        hess = p * (1.0 - p)
        return _apply_weight(grad, hess, self.weight)

    def boost_from_score(self):
        pavg = min(max(self._host_label_mean(), 1e-15), 1.0 - 1e-15)
        return float(np.log(pavg / (1.0 - pavg)))

    def convert_output(self, score):
        return torch.sigmoid(score)


class CrossEntropyLambda(ObjectiveFunction):
    name = "xentlambda"
    boost_mean_weighted = False   # boost_from_score uses the plain mean

    def get_gradients(self, score):
        # intensity parameterisation: p = 1 - exp(-w * exp(score))
        es = torch.exp(score)
        z = es if self.weight is None else self.weight * es
        emz = torch.exp(-z)
        p = torch.clamp(1.0 - emz, 1e-15, 1 - 1e-15)
        grad = z * (1.0 - self.label / p * emz)
        hess = z * (1.0 - self.label / p * emz * (1.0 - z * (1 - p) / p))
        return grad, torch.clamp(hess, min=1e-15)

    def boost_from_score(self):
        pavg = min(max(float(host_mean(self._label_np)), 1e-15),
                   1.0 - 1e-15)
        return float(np.log(-np.log1p(-pavg)))

    def convert_output(self, score):
        return 1.0 - torch.exp(-torch.exp(score))


# ---------------------------------------------------------------------------
# LambdaRank (reference rank_objective.hpp:19-245)
# ---------------------------------------------------------------------------
class LambdarankNDCG(ObjectiveFunction):
    """Pairwise NDCG lambdas over query-size buckets.

    Queries are bucketed by the ceil-pow2 of their size (at least 16),
    so a bucket's queries pad to one width ``M``.  Per query the docs
    sort by score, descending (stably, as the reference's ``argsort``:
    at the first iteration every score ties and the docs keep their
    order); the pair grid is ``[T, M]`` over sorted positions, ``T =
    min(max_position, M)`` rows, a pair live when its column is past
    its row, both docs are real and their labels differ
    (``rank_objective.hpp:75-81``).  The grids fold to per-position rows
    and go back to the docs through the sort permutation by a plain
    scatter (each real doc has one slot; padding slots write a spare
    element past the last doc), exact and without float atomics.  A
    bucket's queries run in chunks of at most ``RANK_CHUNK_PAIRS`` grid
    entries (``LGBM_TPU_RANK_CHUNK_PAIRS`` overrides it)."""
    name = "lambdarank"

    def __init__(self, config: Config):
        super().__init__(config)
        self.sigmoid = float(config.sigmoid)
        self.max_position = int(config.max_position)
        gains = config.label_gain
        if not gains:
            gains = tuple(float((1 << i) - 1) for i in range(31))
        self.label_gain = np.asarray(gains, np.float64)

    def globalize_rows(self, allgather):
        raise NotImplementedError(
            "lambdarank is not supported with MULTI-PROCESS training "
            "(documented descope, as in the JAX package): its per-query "
            "pair structures address rows by position, which the "
            "cross-process row-block layout breaks; use "
            "tree_learner=feature, whose ranks hold every row")

    def init(self, metadata, num_data, device="cpu"):
        super().init(metadata, num_data, device)
        if self.query_boundaries is None:
            raise ValueError("lambdarank requires query data")
        qb = self.query_boundaries
        sizes = (qb[1:] - qb[:-1]).astype(np.int64)
        labels = self._label_np
        by_size: dict = {}
        for q, s in enumerate(sizes):
            Mb = 1 << max(4, int(s - 1).bit_length())
            by_size.setdefault(Mb, []).append(q)
        self.discounts = torch.as_tensor(
            (1.0 / np.log2(np.arange(max(by_size) + 1) + 2.0)).astype(
                np.float32), device=device)
        self.buckets = []
        for Mb in sorted(by_size):
            qs = np.asarray(by_size[Mb], np.int64)
            T = min(self.max_position, Mb)
            idx = qb[:-1][qs, None] + np.arange(Mb)[None, :]
            valid = np.arange(Mb)[None, :] < sizes[qs, None]
            idx = np.where(valid, idx, 0)
            lab = np.where(valid, labels[idx.astype(np.int64)], -1)
            gain = np.where(valid,
                            self.label_gain[lab.astype(int) * (lab >= 0)],
                            0.0)
            # inverse max DCG at the truncation (rank_objective.hpp:46-73)
            disc = 1.0 / np.log2(np.arange(T) + 2.0)
            top = -np.sort(-np.where(valid, lab, -1), axis=1)[:, :T]
            ideal = np.where(top >= 0,
                             self.label_gain[top.astype(int) * (top >= 0)],
                             0.0)
            dcg = (ideal * disc[None, :]).sum(axis=1)
            imd = np.where(dcg > 0, 1.0 / np.maximum(dcg, 1e-300), 0.0)

            def dev(a, dtype):
                return torch.as_tensor(np.ascontiguousarray(a).astype(dtype),
                                       device=device)
            self.buckets.append({
                "M": Mb, "T": T,
                "idx": dev(idx, np.int64),
                # scatter targets: padding slots write the spare element
                "dst": dev(np.where(valid, idx, num_data), np.int64),
                "valid": dev(valid, np.bool_),
                "label": dev(np.where(valid, lab, -1), np.float32),
                "gain": dev(gain, np.float32),
                "imd": dev(imd, np.float32),
            })

    def get_gradients(self, score):
        n = score.shape[0]
        grad = score.new_zeros(n + 1)
        hess = score.new_zeros(n + 1)
        budget = int(os.environ.get("LGBM_TPU_RANK_CHUNK_PAIRS",
                                    RANK_CHUNK_PAIRS))
        for bk in self.buckets:
            Mb, T = bk["M"], bk["T"]
            nq = bk["idx"].shape[0]
            C = max(1, min(nq, budget // max(1, T * Mb)))
            for lo in range(0, nq, C):
                sl = slice(lo, min(lo + C, nq))
                g, h = lambdarank_bucket_grads(
                    score[bk["idx"][sl]], bk["valid"][sl], bk["label"][sl],
                    bk["gain"][sl], bk["imd"][sl], self.discounts[:Mb],
                    self.sigmoid, T)
                # ``0.0 +`` is the reference's scatter-add into zeros
                # (it turns -0.0 into +0.0)
                dst = bk["dst"][sl]
                grad[dst] = 0.0 + g
                hess[dst] = 0.0 + h
        return grad[:n], hess[:n]


def lambdarank_bucket_grads(s, valid, label, gain, imd, disc, sigma: float,
                            T: int):
    """(grad, hess) per padded doc slot ``[C, M]`` of one chunk of a
    bucket's queries (the JAX package's ``_lambdarank_bucket_grads``):
    sort each query by score descending, build the ``[C, T, M]`` pair
    grid over sorted positions, fold it to ``[C, M]`` per-position rows
    and send them back through the permutation."""
    C, M = s.shape
    dev = s.device
    sm = torch.where(valid, s, torch.full_like(s, -torch.inf))
    order = torch.sort(sort_key(-sm), dim=1, stable=True).indices
    s_s = sm.gather(1, order)
    lab_s = label.gather(1, order)
    gain_s = gain.gather(1, order)
    val_s = valid.gather(1, order)
    dl = lab_s[:, :T, None] - lab_s[:, None, :]
    live = (torch.arange(M, device=dev)[None, :]
            > torch.arange(T, device=dev)[:, None])
    pv = live[None] & val_s[:, None, :] & val_s[:, :T, None] & (dl != 0)
    delta = torch.abs((gain_s[:, :T, None] - gain_s[:, None, :])
                      * (disc[:T, None] - disc[None, :])) * imd[:, None, None]
    better_row = dl > 0
    sd = s_s[:, :T, None] - s_s[:, None, :]
    sig = torch.sigmoid(-sigma * torch.where(better_row, sd, -sd))
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    sig_t = torch.tensor(sigma, dtype=torch.float32, device=dev)
    lam = torch.where(pv, -sig_t * sig * delta, zero)
    hh = torch.where(pv, sig_t * sig_t * sig * (1.0 - sig) * delta, zero)
    signed = lam * torch.where(better_row, 1.0, -1.0)
    g_sorted, h_sorted = fold_pair_grid(signed, hh, T, M)
    g = torch.empty_like(g_sorted).scatter_(1, order, g_sorted)
    h = torch.empty_like(h_sorted).scatter_(1, order, h_sorted)
    return g, h


def fold_pair_grid(signed, hh, T: int, M: int):
    """Fold ``[C, T, M]`` pair grids to per-position rows ``[C, M]``: a
    row's pairs add to its position, a column's subtract (gradients) or
    add (hessians).  Every sum adds in the JAX package's compiled order
    on the CPU, written out, so that each device gives the same bits
    (``torch.sum`` adds in another order on each; ROADMAP C40): past
    ``RANK_LANES`` documents a row in sequential blocks of 32
    (``fixed_sum``) and a column in row order; at most ``RANK_LANES``
    (a bucket of 16 or 32) a row folded into ``RANK_LANES`` lanes and
    the lanes halved, a column's first ``RANK_LANES`` rows halved and
    the rest added in order."""
    from ..ops.histogram import fixed_sum
    pad = (0, M - T)
    if M <= 2 * RANK_LANES:
        rows = _lane_sum
        lanes = RANK_LANES if T >= RANK_LANES else 0
    else:
        rows, lanes = (lambda x: fixed_sum(x, 2)), 0

    def cols(x):
        acc = _halve(x[:, :lanes].movedim(1, -1)) if lanes else \
            torch.zeros_like(x[:, 0])
        for t in range(lanes, T):
            acc = acc + x[:, t]
        return acc
    return (torch.nn.functional.pad(rows(signed), pad) - cols(signed),
            torch.nn.functional.pad(rows(hh), pad) + cols(hh))


# the JAX package's vector width in its compiled lambdarank folds on the
# CPU (f32 lanes): buckets of at most 2 x this many documents fold by
# lanes (:func:`fold_pair_grid`)
RANK_LANES = 16


def _halve(x):
    """Sum over the last axis (a power of two) by halving: the first half
    plus the second, until one is left."""
    while x.shape[-1] > 1:
        h = x.shape[-1] // 2
        x = x[..., :h] + x[..., h:]
    return x[..., 0]


def _lane_sum(x):
    """Sum over the last axis (a multiple of ``RANK_LANES``): its blocks of
    ``RANK_LANES`` added in order into one, then halved."""
    acc = x[..., :RANK_LANES]
    for i in range(RANK_LANES, x.shape[-1], RANK_LANES):
        acc = acc + x[..., i:i + RANK_LANES]
    return _halve(acc)


# torch's parallel grain: an elementwise call on at most this many
# elements runs on one thread
_CONVERT_ELEMS = 32768
# a multiple of every vector loop's step: no element takes a scalar tail
_CONVERT_STEP = 64


def convert_rows(objective, raw) -> np.ndarray:
    """``objective.convert_output`` of host scores (``[n]`` or ``[n, K]``)
    as float32, in blocks of at most ``_CONVERT_ELEMS`` elements, the
    last padded with zero rows to a multiple of ``_CONVERT_STEP``
    elements: each block is one thread's call and a whole number of
    vector steps, so every row takes the same code path in any batch.
    On the CPU torch's transcendentals take a scalar path at the tail of
    a thread's chunk, an ulp away from the vector one, and where the
    tails fall follows the batch's length."""
    raw = np.ascontiguousarray(raw, np.float32)
    k = int(np.prod(raw.shape[1:], dtype=np.int64))
    rows = max(32, _CONVERT_ELEMS // max(1, k) // 32 * 32)
    step = _CONVERT_STEP // math.gcd(_CONVERT_STEP, max(1, k))
    out = np.empty_like(raw)
    for r0 in range(0, raw.shape[0], rows):
        block = raw[r0:r0 + rows]
        m = block.shape[0]
        if m % step:
            block = np.concatenate([block, np.zeros(
                (step - m % step,) + raw.shape[1:], np.float32)])
        out[r0:r0 + m] = objective.convert_output(
            torch.from_numpy(block)).numpy()[:m]
    return out


def leaf_percentile(values: torch.Tensor, row_leaf: torch.Tensor,
                    num_leaves: int, alpha: float,
                    weight: Optional[torch.Tensor]) -> torch.Tensor:
    """Per-leaf (weighted) percentile of ``values`` -- RenewTreeOutput's
    kernel (``regression_objective.hpp`` PercentileFun /
    WeightedPercentileFun), the JAX package's ``_leaf_percentile``.

    Rows sort by (leaf, value), stably, as its ``lexsort`` (-0.0 and
    +0.0 tie); a leaf's percentile
    is read at the interpolated offset, or, weighted, at the first row
    whose cumulative weight reaches ``alpha`` of the leaf's.  Every row
    takes part, bagged out or not.  Empty leaves give 0."""
    dev = values.device
    n = values.shape[0]
    leaf = row_leaf.to(torch.int64)
    vkey = sort_key(values).to(torch.int64) + (1 << 31)
    order = torch.sort((leaf << 32) | vkey, stable=True).indices
    sv = values[order]
    sl = leaf[order]
    lid = torch.arange(num_leaves, device=dev)
    start = torch.searchsorted(sl, lid, side="left")
    end = torch.searchsorted(sl, lid, side="right")
    cnt = end - start
    if weight is None:
        pos = alpha * (cnt - 1).to(torch.float32)
        lo = torch.floor(pos).to(torch.int64)
        hi = torch.ceil(pos).to(torch.int64)
        frac = pos - lo
        vlo = sv[torch.clamp(start + lo, 0, n - 1)]
        vhi = sv[torch.clamp(start + hi, 0, n - 1)]
        out = vlo * (1 - frac) + vhi * frac
    else:
        cum_w = prefix_sum(weight[order])
        zero = torch.zeros((), dtype=torch.float32, device=dev)
        base = torch.where(start > 0, cum_w[torch.clamp(start - 1, min=0)],
                           zero)
        total = torch.where(end > 0, cum_w[torch.clamp(end - 1, min=0)],
                            zero) - base
        target = base + alpha * total
        pos = torch.searchsorted(cum_w, target, side="left")
        pos = torch.minimum(torch.maximum(pos, start),
                            torch.maximum(end - 1, start))
        out = sv[torch.clamp(pos, 0, n - 1)]
    return torch.where(cnt > 0, out, torch.zeros((), dtype=out.dtype,
                                                 device=dev))


OBJECTIVES = {
    "regression": RegressionL2,
    "regression_l1": RegressionL1,
    "huber": Huber,
    "fair": Fair,
    "poisson": Poisson,
    "quantile": Quantile,
    "mape": Mape,
    "gamma": Gamma,
    "tweedie": Tweedie,
    "binary": BinaryLogloss,
    "multiclass": MulticlassSoftmax,
    "multiclassova": MulticlassOVA,
    "xentropy": CrossEntropy,
    "xentlambda": CrossEntropyLambda,
    "lambdarank": LambdarankNDCG,
}


def create_objective(config: Config) -> Optional[ObjectiveFunction]:
    """Factory (reference objective_function.cpp:10-47)."""
    if config.objective == "none":
        return None
    cls = OBJECTIVES.get(config.objective)
    if cls is None:
        raise ValueError(f"unknown objective {config.objective!r}")
    return cls(config)


def load_objective(text: str) -> Optional[ObjectiveFunction]:
    """The objective of a model file's ``objective=`` line (for example
    ``binary sigmoid:1``, ``multiclass num_class:3`` or ``regression
    sqrt``), which it writes back unchanged; ``None`` for a custom
    objective (raw scores).  A name the port cannot resolve raises
    ``NotImplementedError``."""
    tokens = text.split()
    try:
        name = _canonical_objective(tokens[0] if tokens else "")
    except ValueError:
        raise NotImplementedError(
            f"model objective {text!r} is not known to "
            f"lightgbm_tpu_torch: its output conversion cannot be "
            f"applied") from None
    if name == "none":
        return None
    params = {"objective": name, "reg_sqrt": "sqrt" in tokens[1:]}
    params.update(t.split(":", 1) for t in tokens[1:] if ":" in t)
    obj = OBJECTIVES[name](Config.from_params(params))
    obj.text = text
    return obj
