"""DART, GOSS and random forests: the boosting variants.

Port of the JAX package's ``boosting/variants.py`` (reference
``src/boosting/dart.hpp``, ``goss.hpp``, ``rf.hpp``; the factory
``boosting.cpp:30-63``).  Each variant is a :class:`GBDT` that overrides
the seams of one iteration:

* **DART** drops a random subset of past iterations from the training
  scores before the new trees are built, shrinks the new trees to ``lr /
  (1 + k)`` (``lr / (lr + k)`` in xgboost mode), then rescales the
  dropped trees and patches the training and valid scores.  The draws
  are pure in ``(drop_seed, iteration)`` on the keyed threefry
  (``utils/random.py``), so a resumed run draws what the uninterrupted
  one drew.  ``LGBM_TPU_DART_HOST_RNG=1`` takes the JAX package's legacy
  stateful stream instead (``np.random.RandomState(drop_seed)``, drawn
  in sequence; not stable across a resume).  The dropped set's output is
  one replay of its trees on the device, summed in the JAX package's
  order (``GBDT._replay_sum``).
* **GOSS** keeps the rows of the largest ``sum_k |g*h|`` (``top_rate``),
  samples ``other_rate`` of the rest and scales their gradients by ``(1
  - a) / b``; the kept rows are the tree's bag.
* **RF** takes every tree's gradients at the constant initial score,
  shrinks nothing, and averages the trees' outputs (``average_output``).

The JAX package trains GOSS on the fused-window loop of plain GBDT (a
fused score update) and DART and RF on its per-iteration loop (the
product rounded before the add); the port's flags follow each.
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np
import torch

from ..config import Config
from ..utils import random as keyed
from .gbdt import GBDT


def _dart_host_rng() -> bool:
    """``LGBM_TPU_DART_HOST_RNG=1``: the legacy stateful drop stream,
    kept for A/B against the keyed draws (the JAX package's escape
    hatch, the same stream)."""
    return os.environ.get("LGBM_TPU_DART_HOST_RNG", "0") == "1"


def _drop_uniforms(drop_seed: int, it: int):
    """DART's draws of iteration ``it`` (the JAX package's
    ``_drop_uniforms``): the skip-drop uniform from ``fold_in(key, 0)``
    and one uniform per past iteration from ``fold_in(key, 1)``, drawn
    at the next power of two and cut to ``it``; ``key = fold_in(
    PRNGKey(drop_seed), it)``.  -> ``(float, [it] float32 numpy)``."""
    key = keyed.fold_in(keyed.PRNGKey(drop_seed), it)
    u_skip = float(keyed.uniform(keyed.fold_in(key, 0), ())[()])
    pad = 1
    while pad < it:
        pad *= 2
    u = keyed.uniform(keyed.fold_in(key, 1), (pad,)).numpy()
    return u_skip, u[:it]


class DART(GBDT):
    """Dropout trees (reference ``dart.hpp:23-199``; the JAX package's
    ``DART``)."""

    boosting_name = "dart"
    fused_update = False

    def __init__(self, config: Config, train_set, device="cuda"):
        super().__init__(config, train_set, device)
        self._rng_drop = None
        if _dart_host_rng():
            # the legacy stateful stream: not replay- or rank-stable
            self._rng_drop = np.random.RandomState(config.drop_seed)
        self._tree_weights: List[float] = []   # per-iteration weight
        self._sum_weight = 0.0

    def train_one_iter(self, grad=None, hess=None) -> bool:
        c = self.config
        K = self.num_tree_per_iteration
        lr = c.learning_rate
        drop_iters = self._select_drop()
        k = float(len(drop_iters))
        # the dropped set's summed output per class and data set, used
        # for the drop and again for the rescale (dart.hpp:146-186)
        drop_tp: List[Optional[torch.Tensor]] = [None] * K
        drop_vp = [[None] * len(self._valid_device) for _ in range(K)]
        if k:
            models = self.models
            for cls in range(K):
                trees = [models[int(di) * K + cls] for di in drop_iters]
                drop_tp[cls] = self._replay_sum(trees, self.device_data)
                self.scores[:, cls] -= drop_tp[cls]
                for vi, vd in enumerate(self._valid_device):
                    drop_vp[cls][vi] = self._replay_sum(trees, vd)
        # the new trees' shrinkage (dart.hpp:127-134)
        if not c.xgboost_dart_mode:
            self.shrinkage_rate = lr / (1.0 + k)
        else:
            self.shrinkage_rate = lr if k == 0 else lr / (lr + k)
        if super().train_one_iter(grad, hess):
            return True
        # Normalize (dart.hpp:146-186): each dropped tree's weight times
        # factor; the training score lost the trees whole and gets factor
        # of them back, the valid scores still hold them and get factor - 1
        factor = (k / (k + 1.0)) if not c.xgboost_dart_mode else (
            k / (k + lr) if k > 0 else 1.0)
        if k:
            f = torch.tensor(factor, dtype=torch.float32, device=self.device)
            f1 = torch.tensor(factor - 1.0, dtype=torch.float32,
                              device=self.device)
            for cls in range(K):
                self.scores[:, cls] += f * drop_tp[cls]
                for vi, score in enumerate(self._valid_scores):
                    score[:, cls] += f1 * drop_vp[cls][vi]
        models = self.models
        for di in drop_iters:
            di = int(di)
            for cls in range(K):
                models[di * K + cls].shrinkage(factor)
            if not c.uniform_drop:
                self._sum_weight -= self._tree_weights[di] * (
                    1.0 / (k + 1.0) if not c.xgboost_dart_mode
                    else 1.0 / (k + lr))
                self._tree_weights[di] *= factor
        if not c.uniform_drop:
            self._tree_weights.append(self.shrinkage_rate)
            self._sum_weight += self.shrinkage_rate
        return False

    def merge_from(self, other: GBDT) -> None:
        if not self.config.uniform_drop:
            raise ValueError(
                "boosting=dart cannot continue from init_model with weighted "
                "drops: the loaded trees carry no DART weights (the JAX "
                "package fails on its second iteration); set "
                "uniform_drop=true")
        super().merge_from(other)

    def snapshot_extra_state(self) -> Dict:
        """The drop weights in the JAX package's keys, and each tree's
        exact shrinkage: the model text rounds it to 8 digits, and a
        later drop rescales the restored tree (ROADMAP C9)."""
        return {"dart_tree_weights": [float(w) for w in self._tree_weights],
                "dart_sum_weight": float(self._sum_weight),
                "dart_tree_shrinkage": [float(t.shrinkage_rate)
                                        for t in self.models]}

    def load_snapshot_extra_state(self, extra: Dict) -> None:
        if "dart_tree_weights" in extra:
            self._tree_weights = [float(w)
                                  for w in extra["dart_tree_weights"]]
            self._sum_weight = float(extra.get("dart_sum_weight", 0.0))
        rates = extra.get("dart_tree_shrinkage")
        if rates is not None and len(rates) == len(self.models):
            for t, r in zip(self.models, rates):
                t.shrinkage_rate = float(r)

    def _select_drop(self) -> np.ndarray:
        """The iterations to drop (reference ``DroppingTrees``,
        ``dart.hpp:85-125``), from :func:`_drop_uniforms` (or the legacy
        stream, :meth:`_select_drop_host`).  The ``det.rng_drift`` fault
        draws the next iteration's uniforms instead."""
        c = self.config
        iters = self.iter
        if self._rng_drop is not None:
            return self._select_drop_host(iters)
        if iters == 0:
            return np.zeros(0, np.int64)
        from ..obs import determinism
        determinism.rng_site("dart.drop", "drop_seed/iteration")
        u_skip, u = _drop_uniforms(c.drop_seed, iters)
        from ..utils import faults
        if faults.armed() and faults.fault_flag("det.rng_drift"):
            u_skip, u = _drop_uniforms(c.drop_seed, iters + 1)
            u = u[:iters]
        if u_skip < c.skip_drop:
            return np.zeros(0, np.int64)
        return self._drop_from_uniforms(u, iters)

    def _drop_from_uniforms(self, u: np.ndarray, iters: int) -> np.ndarray:
        """Bernoulli drops at ``drop_rate``, scaled by each iteration's
        weight unless ``uniform_drop``, at most ``max_drop`` in order."""
        c = self.config
        out = []
        if not c.uniform_drop and self._sum_weight > 0:
            inv_avg = len(self._tree_weights) / self._sum_weight
            rate = c.drop_rate
            if c.max_drop > 0:
                rate = min(rate, c.max_drop * inv_avg / self._sum_weight)
            for i in range(iters):
                if u[i] < rate * self._tree_weights[i] * inv_avg:
                    out.append(i)
                    if c.max_drop > 0 and len(out) >= c.max_drop:
                        break
        else:
            rate = c.drop_rate
            if c.max_drop > 0:
                rate = min(rate, c.max_drop / max(1.0, float(iters)))
            for i in range(iters):
                if u[i] < rate:
                    out.append(i)
                    if c.max_drop > 0 and len(out) >= c.max_drop:
                        break
        return np.asarray(out, np.int64)

    def _select_drop_host(self, iters: int) -> np.ndarray:
        """The legacy stream, verbatim (the JAX package's
        ``_select_drop_host``): sequential ``RandomState`` draws, the early
        ``max_drop`` break included, which stops consuming draws."""
        c = self.config
        if iters == 0 or self._rng_drop.rand() < c.skip_drop:
            return np.zeros(0, np.int64)
        out = []
        if not c.uniform_drop and self._sum_weight > 0:
            inv_avg = len(self._tree_weights) / self._sum_weight
            rate = c.drop_rate
            if c.max_drop > 0:
                rate = min(rate, c.max_drop * inv_avg / self._sum_weight)
            for i in range(iters):
                if (self._rng_drop.rand()
                        < rate * self._tree_weights[i] * inv_avg):
                    out.append(i)
                    if c.max_drop > 0 and len(out) >= c.max_drop:
                        break
        else:
            rate = c.drop_rate
            if c.max_drop > 0:
                rate = min(rate, c.max_drop / max(1.0, float(iters)))
            for i in range(iters):
                if self._rng_drop.rand() < rate:
                    out.append(i)
                    if c.max_drop > 0 and len(out) >= c.max_drop:
                        break
        return np.asarray(out, np.int64)


def goss_sample(grad: torch.Tensor, hess: torch.Tensor, it: int,
                top_rate: float, other_rate: float, seed: int):
    """Gradient-based one-side sampling of ``[n, K]`` gradients (the JAX
    package's ``GOSS._block_sample``): the importance ``sum_k |g*h|``
    (summed from 0.0 in class order), the rows at or above the
    ``max(1, int(n * top_rate))``-th largest, and of the rest those whose
    uniform (``fold_in(PRNGKey(seed), it)``, one per row) falls below
    ``b / (1 - a)`` in float32; those get gradients and hessians times
    ``(1 - a) / b``.  -> ``(grad, hess, bag [n] bool)``."""
    n, K = grad.shape
    a, b = top_rate, other_rate
    top_k = max(1, int(n * a))
    gh = (grad * hess).abs()
    imp = torch.zeros_like(gh[:, 0])
    for k in range(K):
        imp = imp + gh[:, k]
    threshold = torch.sort(imp).values[n - top_k]
    is_top = imp >= threshold
    rnd = keyed.uniform(keyed.fold_in(keyed.PRNGKey(seed), it), (n,),
                        grad.device)
    f32 = dict(dtype=torch.float32, device=grad.device)
    is_other = ~is_top & (rnd < torch.tensor(b / max(1e-12, 1.0 - a), **f32))
    mult = torch.tensor((1.0 - a) / max(b, 1e-12), **f32)
    scale = torch.where(is_other, mult, torch.ones((), **f32))[:, None]
    return grad * scale, hess * scale, is_top | is_other


class GOSS(GBDT):
    """Gradient-based one-side sampling (reference ``goss.hpp:36-214``;
    the JAX package's ``GOSS``).  As its ``_train_with_bag``, an
    iteration of stumps is kept and counted before training ends; the
    trailing ones go at the end (:meth:`GBDT.trim_trailing_stumps`)."""

    boosting_name = "goss"
    keeps_stump_iterations = True

    def _row_sample(self, grad, hess):
        c = self.config
        from ..obs import determinism
        determinism.rng_site("goss.sample", "bagging_seed/iteration")
        if self._pr is not None:
            return goss_sample_mp(grad, hess, self.iter, c.top_rate,
                                  c.other_rate, c.bagging_seed,
                                  self.mesh_ctx, self._pr)
        return goss_sample(grad, hess, self.iter, c.top_rate, c.other_rate,
                           c.bagging_seed)


def goss_sample_mp(grad: torch.Tensor, hess: torch.Tensor, it: int,
                   top_rate: float, other_rate: float, seed: int, comm, pr):
    """Multi-process GOSS from global gradients (the JAX package's
    ``_goss_mp_sample``, ``boosting/variants.py:257-315``): the top-rate
    threshold over every rank's importances (each rank's padded block,
    padding at -1, all-gathered), ``top_k`` counting real rows only, and
    the uniforms drawn over the original row order of the mod-rank
    layout (row ``i * world + rank`` of the global order is this rank's
    ``i``-th), so that each rank draws its rows' numbers of one global
    draw."""
    from ..obs.flight_recorder import record as fr_record
    n, K = grad.shape
    a, b = top_rate, other_rate
    top_k = max(1, int(pr.n_global * a))
    gh = (grad * hess).abs()
    imp = torch.zeros_like(gh[:, 0])
    for k in range(K):
        imp = imp + gh[:, k]
    block = torch.full((pr.per,), -1.0, dtype=torch.float32,
                       device=grad.device)
    block[:n] = imp
    fr_record("boosting.goss.importance_gather", "all_gather",
              comm.data_axis, block)
    everyone = comm.all_gather(block).reshape(-1)
    threshold = torch.sort(everyone).values[everyone.shape[0] - top_k]
    is_top = imp >= threshold
    rnd = keyed.uniform(keyed.fold_in(keyed.PRNGKey(seed), it),
                        (pr.n_global,), grad.device)
    orig = torch.arange(n, device=grad.device) * pr.world + pr.rank
    rnd = rnd[orig.clamp(max=pr.n_global - 1)]
    f32 = dict(dtype=torch.float32, device=grad.device)
    is_other = ~is_top & (rnd < torch.tensor(b / max(1e-12, 1.0 - a), **f32))
    mult = torch.tensor((1.0 - a) / max(b, 1e-12), **f32)
    scale = torch.where(is_other, mult, torch.ones((), **f32))[:, None]
    return grad * scale, hess * scale, is_top | is_other


class RF(GBDT):
    """Random forest (reference ``rf.hpp:15-207``; the JAX package's
    ``RF``): bagging is required (``Config.check``), every tree's
    gradients are taken at the constant initial score, the shrinkage is
    1 (so the fused and the rounded score updates agree), the training
    and valid scores hold raw sums and the metrics see them divided by
    the number of iterations; predictions average the trees."""

    boosting_name = "rf"
    fused_update = False
    # the scores and the base score the gradients are taken at
    score_state_tensors = 2

    def __init__(self, config: Config, train_set, device="cuda"):
        super().__init__(config, train_set, device)
        self.shrinkage_rate = 1.0
        self.average_output = True
        if train_set is not None:
            # this rank's rows at the (global, in a multi-process run)
            # init score, as the live scores
            self._base_score = torch.full(
                (self.num_data, self.num_tree_per_iteration),
                self.init_score_value, dtype=torch.float32,
                device=self.device)

    def gradients(self):
        live = self.scores
        self.scores = self._base_score
        try:
            return super().gradients()
        finally:
            self.scores = live

    def eval_train(self):
        return self._eval_avg(super().eval_train)

    def eval_valid(self):
        return self._eval_avg(super().eval_valid)

    def _eval_avg(self, fn):
        """``fn`` on the scores divided by the number of iterations (f32)."""
        T = max(1, len(self.models) // max(1, self.num_tree_per_iteration))
        live, valid = self.scores, list(self._valid_scores)
        self.scores = self.scores / T
        self._valid_scores = [v / T for v in valid]
        try:
            return fn()
        finally:
            self.scores, self._valid_scores = live, valid


BOOSTERS = {"gbdt": GBDT, "dart": DART, "goss": GOSS, "rf": RF}


def create_boosting(config: Config, train_set=None, device="cuda") -> GBDT:
    """The booster of ``config.boosting_type`` (reference
    ``Boosting::CreateBoosting``, ``boosting.cpp:30-63``).  With
    ``input_model`` set, the booster loads that model's trees, as the JAX
    package's ``create_boosting`` does: a training booster then grows its
    new trees after them, its training scores untouched by them
    (ROADMAP C33)."""
    booster = BOOSTERS[config.boosting_type](config, train_set, device)
    if config.input_model:
        from ..utils.file_io import open_read
        with open_read(config.input_model) as f:
            booster.load_model_from_string(f.read())
    return booster
