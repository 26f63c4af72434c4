"""GBDT — the boosting engine (the port's subset).

Port of the JAX package's ``boosting/gbdt.py`` (reference
``src/boosting/gbdt.cpp``; model text IO ``gbdt_model_text.cpp``).  One
iteration mirrors ``TrainOneIter`` (`gbdt.cpp:377-472`): gradients
``[n, K]`` from the objective, one bagging mask for the iteration, then
K trees (one per class) through the serial learner, each with its own
feature mask, the leaf renewal of L1 / quantile / MAPE, stumps zeroed,
shrinkage, and the score update of class k from the kernel-emitted
per-row leaf values (renewed trees: their leaf values gathered per
row); validation sets are scored by walking each new tree over their
bins.  An iteration whose K trees are all stumps ends training and is
dropped.  The reference's ``lax.scan`` windows are a TPU dispatch
mechanism and are not ported: iterations run one at a time.

Bagging and feature fraction draw from the reference's keyed RNG
(``utils/random.py``), so both packages sample the same rows and
features from the same seeds.

Trees exist as device ``BuiltTree`` tensors right after training and as
host ``Tree`` objects for the model file; host trees are made on first
access.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..config import Config
from ..io.dataset import BinnedDataset
from ..io.device import DeviceData, to_device
from ..learner.serial import (BuiltTree, GrowthParams, build_tree,
                              predict_built_tree)
from ..metric.metrics import (Metric, create_metric,
                              default_metric_for_objective)
from ..models.tree import (K_CATEGORICAL_MASK, K_DEFAULT_LEFT_MASK, Tree,
                           _construct_bitset, predict_leaf)
from ..objective.objectives import (ObjectiveFunction, create_objective,
                                    load_objective)
from ..ops.split import SplitParams
from ..utils import random as keyed
from ..utils.log import log_info, log_warning

K_MODEL_VERSION = "v2"     # reference gbdt_model_text.cpp:13


def split_params_from_config(c: Config) -> SplitParams:
    return SplitParams(
        lambda_l1=c.lambda_l1, lambda_l2=c.lambda_l2,
        min_data_in_leaf=c.min_data_in_leaf,
        min_sum_hessian_in_leaf=c.min_sum_hessian_in_leaf,
        min_gain_to_split=c.min_gain_to_split,
        max_cat_threshold=c.max_cat_threshold,
        cat_smooth=c.cat_smooth, cat_l2=c.cat_l2,
        max_cat_to_onehot=c.max_cat_to_onehot)


def growth_params_from_config(c: Config) -> GrowthParams:
    return GrowthParams(
        num_leaves=c.num_leaves, max_depth=c.max_depth,
        wave_size=1 if c.growth_mode == "leafwise" else 0,
        split=split_params_from_config(c))


def bag_mask(seed: int, epoch: int, n: int, fraction: float,
             device) -> torch.Tensor:
    """Bernoulli row mask, pure in (seed, bagging epoch): the reference's
    ``_device_bag_mask`` (``gbdt.py:103-109``)."""
    key = keyed.fold_in(keyed.PRNGKey(seed), epoch)
    return keyed.uniform(key, (n,), device) < fraction


def feature_mask(seed: int, tree_idx: int, F: int, k: int) -> torch.Tensor:
    """Exactly-k feature mask, pure in (seed, global tree index): the
    reference's ``_device_feature_mask`` (``gbdt.py:112-123``).  Its
    ``top_k`` breaks ties by the lowest index; a stable descending sort
    does the same."""
    r = keyed.uniform(keyed.fold_in(keyed.PRNGKey(seed), tree_idx), (F,))
    idx = torch.sort(r, descending=True, stable=True).indices[:k]
    mask = torch.zeros(F, dtype=torch.bool)
    mask[idx] = True
    return mask


def _check_supported(c: Config) -> None:
    """Options outside this slice raise instead of training something
    else."""
    if c.boosting_type != "gbdt":
        raise NotImplementedError(f"boosting={c.boosting_type}")
    if c.tree_learner != "serial" or c.num_machines > 1:
        raise NotImplementedError(f"tree_learner={c.tree_learner}")
    check_unported_options(c)


def check_unported_options(c: Config) -> None:
    """Options the reference acts on and the port does not read yet
    raise, in memory and streamed alike, rather than train or predict
    something else."""
    if c.snapshot_freq > 0:
        raise NotImplementedError(
            f"snapshot_freq={c.snapshot_freq}: snapshots are not ported "
            f"yet (ROADMAP A6)")
    if c.pred_early_stop:
        raise NotImplementedError(
            "pred_early_stop: prediction early stopping is not ported yet "
            "(ROADMAP A6)")
    if c.mesh_shape:
        raise NotImplementedError(
            f"mesh_shape={c.mesh_shape}: the device mesh is not ported yet "
            f"(ROADMAP A11)")


class GBDT:
    """Gradient Boosting Decision Tree booster."""

    boosting_name = "gbdt"

    def __init__(self, config: Config, train_set: Optional[BinnedDataset],
                 device="cuda"):
        self.config = config
        self.train_set = train_set
        self.device = torch.device(device)
        self.objective: Optional[ObjectiveFunction] = None
        self._host_models: List[Tree] = []
        # device trees waiting for host conversion: (tree, lr, bias);
        # the init score is the bias of each class's first tree
        self._pending: List[Tuple[BuiltTree, float, float]] = []
        self.iter = 0
        self.init_score_value = 0.0
        self.shrinkage_rate = config.learning_rate
        self.num_class = max(1, config.num_class)
        self.num_tree_per_iteration = config.num_tree_per_iteration
        self.average_output = False
        self.feature_names: List[str] = []
        self.max_feature_idx = 0
        self.scores: Optional[torch.Tensor] = None
        self.valid_sets: List[BinnedDataset] = []
        self.valid_names: List[str] = []
        self._valid_device: List[DeviceData] = []
        self._valid_scores: List[torch.Tensor] = []
        self.metrics: List[Metric] = []
        self._bag: Optional[Tuple[int, torch.Tensor]] = None
        if train_set is not None:
            self._init_train(train_set)

    def _init_train(self, train_set: BinnedDataset) -> None:
        c = self.config
        _check_supported(c)
        n = train_set.num_data
        self.num_data = n
        self.device_data = to_device(train_set, self.device)
        self.feature_names = train_set.feature_names
        self.max_feature_idx = train_set.num_total_features - 1
        self.objective = create_objective(c)
        if self.objective is None:
            raise NotImplementedError("custom objectives")
        self.objective.init(train_set.metadata, n, self.device)
        K = self.num_tree_per_iteration = \
            self.objective.num_model_per_iteration
        scores = np.zeros((n, K), np.float32)
        ms = train_set.metadata.init_score
        if ms is not None:
            # class-major, as the reference stores [n * K] init scores
            # numcheck: disable=NUM002 -- ingest cast of user-supplied
            # init_score to the f32 score dtype, not an accumulation
            scores = np.asarray(ms, np.float64).reshape(
                -1, K, order="F").astype(np.float32)
        elif c.boost_from_average:
            v = self.objective.boost_from_score()
            if v != 0.0:
                self.init_score_value = v
                scores = np.full_like(scores, v)
                log_info(f"boost from average: init score = {v:.6f}")
        self.scores = torch.as_tensor(scores, device=self.device)
        self.growth = growth_params_from_config(c)
        self.hist_mode = c.hist_mode or None
        self._setup_metrics()

    def _setup_metrics(self) -> None:
        c = self.config
        names = list(c.metric)
        if not names and c.objective != "none":
            names = [default_metric_for_objective(c.objective)]
        seen = set()
        for nm in names:
            m = create_metric(nm, c)
            if m is not None and m.names[0] not in seen:
                self.metrics.append(m)
                seen.add(m.names[0])

    def add_valid(self, valid_set: BinnedDataset, name: str) -> None:
        """Reference GBDT::AddValidDataset (``gbdt.cpp:124+``): the set,
        binned with the training set's mappers, is scored on the device
        after every tree."""
        if self._num_models():
            raise NotImplementedError(
                "add_valid after training has started (replaying trees "
                "into valid scores) is not ported yet")
        K = self.num_tree_per_iteration
        ms = valid_set.metadata.init_score
        if ms is not None:
            score = np.asarray(ms, np.float64).reshape(-1, K, order="F")
            # numcheck: disable=NUM002 -- ingest cast of init_score
            score = torch.as_tensor(score.astype(np.float32),
                                    device=self.device)
        else:
            score = torch.full((valid_set.num_data, K),
                               self.init_score_value, dtype=torch.float32,
                               device=self.device)
        self.valid_sets.append(valid_set)
        self.valid_names.append(name)
        self._valid_device.append(to_device(valid_set, self.device))
        self._valid_scores.append(score)

    def _bagging_mask(self, it: int) -> Optional[torch.Tensor]:
        """Row subsampling mask of iteration ``it`` (reference Bagging,
        ``gbdt.cpp:225-286``): pure in (``bagging_seed``, ``it //
        bagging_freq``), made once per bagging epoch."""
        c = self.config
        if c.bagging_freq <= 0 or c.bagging_fraction >= 1.0:
            return None
        epoch = it // c.bagging_freq
        if self._bag is None or self._bag[0] != epoch:
            self._bag = (epoch, bag_mask(c.bagging_seed, epoch,
                                         self.num_data, c.bagging_fraction,
                                         self.device))
        return self._bag[1]

    def _feature_mask(self, tree_idx: int) -> Optional[torch.Tensor]:
        """Per-tree feature subsampling (``serial_tree_learner.cpp:240-266``),
        pure in (``feature_fraction_seed``, global tree index)."""
        c = self.config
        if c.feature_fraction >= 1.0:
            return None
        F = self.device_data.num_features
        k = max(1, int(c.feature_fraction * F))
        return feature_mask(c.feature_fraction_seed, tree_idx, F,
                            k).to(self.device)

    # -- host trees ------------------------------------------------------
    @property
    def models(self) -> List[Tree]:
        """Host tree list; converts pending device trees on access."""
        for bt, lr, bias in self._pending:
            host = self._to_host_tree(bt)
            host.shrinkage(lr)
            if bias:
                host.add_bias(bias)   # init score: each class's first tree
            self._host_models.append(host)
        self._pending = []
        return self._host_models

    @models.setter
    def models(self, value: List[Tree]) -> None:
        self._pending = []
        self._host_models = list(value)

    def _num_models(self) -> int:
        return len(self._host_models) + len(self._pending)

    # -- training ---------------------------------------------------------
    def _first_tree_bias(self) -> float:
        """The bias of the next tree: the init score goes into each
        class's first tree (reference TrainOneIter's AddBias)."""
        if (self._num_models() < self.num_tree_per_iteration
                and abs(self.init_score_value) > 1e-15):
            return self.init_score_value
        return 0.0

    def gradients(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(grad, hess), each ``[n, K]`` (reference Boosting())."""
        return self.objective.get_gradients_k(self.scores)

    def train_one_iter(self) -> bool:
        """One boosting iteration (reference TrainOneIter).  Returns True
        when training should stop: the K trees are all stumps (no split
        meets the requirements), and the iteration is dropped."""
        grad, hess = self.gradients()
        K = self.num_tree_per_iteration
        bag = self._bagging_mask(self.iter)
        trees = []
        for k in range(K):
            bt = build_tree(self.device_data, grad[:, k].contiguous(),
                            hess[:, k].contiguous(), self.growth,
                            bag_mask=bag,
                            feature_mask=self._feature_mask(
                                self.iter * K + k),
                            hist_mode=self.hist_mode)
            bt = self._renew_leaves(bt, k)
            nl, depth = torch.stack([bt.num_leaves,
                                     bt.leaf_depth.max()]).tolist()
            if nl <= 1:
                # a stump adds nothing (reference gbdt.cpp:435-460)
                bt.leaf_value = torch.zeros_like(bt.leaf_value)
            trees.append((bt, nl, depth))
        if all(nl <= 1 for _, nl, _ in trees):
            log_warning("stopped training because there are no more leaves "
                        f"that meet the split requirements (iteration "
                        f"{self.iter + 1})")
            return True
        for k, (bt, _, depth) in enumerate(trees):
            self._update_scores(bt, k, depth)
            self._pending.append((BuiltTree(**{
                **bt.__dict__, "row_leaf": bt.row_leaf[:0],
                "row_value": bt.row_value[:0]}), self.shrinkage_rate,
                self._first_tree_bias()))
        self.iter += 1
        return False

    def _renew_leaves(self, bt: BuiltTree, k: int) -> BuiltTree:
        """The objective's leaf re-fit (RenewTreeOutput,
        ``serial_tree_learner.cpp:592-622``): each leaf of the tree takes
        the objective's percentile of its rows' residuals against class
        k's scores."""
        if not self.objective.need_renew_tree_output:
            return bt
        L = self.growth.num_leaves
        new = self.objective.renew_tree_output(self.scores[:, k],
                                               bt.row_leaf, L)
        bt.leaf_value = torch.where(
            torch.arange(L, device=self.device) < bt.num_leaves,
            new.to(torch.float32), bt.leaf_value)
        return bt

    def _update_scores(self, bt: BuiltTree, k: int, depth: int) -> None:
        """Add the shrunk kernel-emitted per-row leaf values: one fused
        multiply-add per row, as the reference's compiled update.  A
        renewed tree's values are gathered per row and the product is
        rounded before the add, as the reference's per-iteration loop
        (the only one renewal takes) does.  Valid scores add the shrunk
        values of a device walk of the tree, ``depth`` levels deep (the
        product rounded, then the add, as the reference's eager
        update)."""
        lr = torch.tensor(self.shrinkage_rate, dtype=torch.float32,
                          device=self.device)
        if self.objective.need_renew_tree_output:
            self.scores[:, k] += lr * bt.leaf_value[bt.row_leaf.long()]
        else:
            self.scores[:, k].add_(bt.row_value, alpha=self.shrinkage_rate)
        for vd, score in zip(self._valid_device, self._valid_scores):
            score[:, k] += lr * predict_built_tree(bt, vd, depth)

    # -- evaluation ----------------------------------------------------------
    def eval_train(self) -> List[Tuple[str, str, float, bool]]:
        return self._eval_set("training", self.scores,
                              self.train_set.metadata)

    def eval_valid(self) -> List[Tuple[str, str, float, bool]]:
        out = []
        for name, vs, score in zip(self.valid_names, self.valid_sets,
                                   self._valid_scores):
            out.extend(self._eval_set(name, score, vs.metadata))
        return out

    def _eval_set(self, name, scores, md):
        """``[(set name, metric name, value, higher_is_better)]`` over the
        raw scores, ``[n]`` or ``[n, K]``, with the set's query
        boundaries for the ranking metrics (reference
        ``gbdt.cpp:OutputMetric``)."""
        if md.label is None:
            return []
        s = scores.cpu().numpy()
        if s.shape[1] == 1:
            s = s[:, 0]
        label = np.asarray(md.label)
        return [(name, mname, val, hib) for m in self.metrics
                for mname, val, hib in m.eval(label, s, md.weight,
                                              md.query_boundaries)]

    def _to_host_tree(self, bt: BuiltTree) -> Tree:
        """Device BuiltTree -> host Tree with real-valued thresholds."""
        ds = self.train_set
        nl = int(bt.num_leaves)
        t = Tree(max(self.growth.num_leaves, 2))
        t.num_leaves = nl
        m = nl - 1
        lv = bt.leaf_value.cpu().numpy()
        if m == 0:
            t.leaf_value[0] = float(lv[0])
            t.leaf_count[0] = int(bt.leaf_count[0])
            return t

        def host(x):
            return x.cpu().numpy()[:m]

        feat_inner = host(bt.feature)
        thr_bin = host(bt.threshold_bin)
        dl = host(bt.default_left)
        is_cat = host(bt.is_categorical)
        # the masks come to the host once a tree, and only when a node
        # is categorical
        cat_mask = host(bt.cat_mask) if is_cat.any() else None
        t.split_feature_inner[:m] = feat_inner
        t.left_child[:m] = host(bt.left_child)
        t.right_child[:m] = host(bt.right_child)
        t.split_gain[:m] = host(bt.gain)
        t.internal_value[:m] = host(bt.internal_value)
        t.internal_count[:m] = host(bt.internal_count)
        t.leaf_value[:nl] = lv[:nl]
        t.leaf_count[:nl] = bt.leaf_count.cpu().numpy()[:nl]
        t.leaf_depth[:nl] = bt.leaf_depth.cpu().numpy()[:nl]
        for node in range(m):
            inner = int(feat_inner[node])
            orig = ds.used_features[inner]
            mapper = ds.mappers[orig]
            t.split_feature[node] = orig
            mt = mapper.missing_type
            if is_cat[node]:
                # a value bitset of the left categories (bins past the
                # feature's own are padding); threshold holds the
                # categorical node's index
                bins = np.nonzero(cat_mask[node])[0]
                bins = bins[bins < mapper.num_bin]
                values = sorted(int(mapper.bin_2_categorical[b])
                                for b in bins)
                ci = t.num_cat
                t.decision_type[node] = np.int8(
                    K_CATEGORICAL_MASK | ((mt & 3) << 2))
                t.threshold[node] = float(ci)
                t.threshold_bin[node] = ci
                t.cat_threshold.extend(_construct_bitset(values))
                t.cat_boundaries.append(len(t.cat_threshold))
                t.cat_left_bins.append(np.asarray(sorted(bins), np.int32))
                t.num_cat += 1
                continue
            dt = np.int8((mt & 3) << 2)
            if dl[node]:
                dt |= np.int8(K_DEFAULT_LEFT_MASK)
            t.decision_type[node] = dt
            t.threshold_bin[node] = int(thr_bin[node])
            t.threshold[node] = mapper.threshold_value(int(thr_bin[node]))
        return t

    # -- prediction ---------------------------------------------------------
    def _num_trees(self, num_iteration: int) -> int:
        """Trees used by a prediction: ``num_iteration * K`` when
        ``num_iteration > 0``, else all (K trees per iteration)."""
        T = len(self.models)
        if num_iteration is not None and num_iteration > 0:
            T = min(T, num_iteration * max(1, self.num_tree_per_iteration))
        return T

    def predict_raw(self, X: np.ndarray, num_iteration: int = -1
                    ) -> np.ndarray:
        """Raw scores float64, ``[n]`` (or ``[n, K]`` with K trees per
        iteration): the host walk over raw values, tree ``t`` adding
        into class ``t % K`` (the JAX package's ``_predict_loaded``), for
        a trained and a loaded model alike.  The device path is the
        compiled predictor (``serve/compiler.py``), held to this walk."""
        models = self.models
        T = self._num_trees(num_iteration)
        K = max(1, self.num_tree_per_iteration)
        X = np.asarray(X, np.float64)
        out = np.zeros((X.shape[0], K))
        if T == 0:
            out[:] = self.init_score_value
        for i in range(T):
            out[:, i % K] += models[i].predict_batch(X)
        return out if K > 1 else out[:, 0]

    def predict(self, X: np.ndarray, raw_score: bool = False,
                num_iteration: int = -1) -> np.ndarray:
        raw = self.predict_raw(X, num_iteration)
        if raw_score or self.objective is None:
            return raw
        if self.average_output:
            raw = raw / max(1, len(self.models)
                            // max(1, self.num_tree_per_iteration))
        return self.objective.convert_output(
            torch.as_tensor(raw, dtype=torch.float32)).numpy()

    def predict_leaf(self, X: np.ndarray,
                     num_iteration: int = -1) -> np.ndarray:
        """Per-tree leaf indices ``[n, T]`` int32 (PredictLeafIndex),
        truncated as :meth:`predict_raw` is; the host walk over raw
        values (``models/tree.py:predict_leaf``)."""
        return predict_leaf(self.models[:self._num_trees(num_iteration)],
                            X)

    def digest(self, include_scores: bool = True) -> str:
        from ..obs import determinism
        return determinism.model_digest(self, include_scores=include_scores)

    # -- model text IO (reference gbdt_model_text.cpp:235-315) ---------------
    def feature_importance(self, num_iteration: int = -1) -> np.ndarray:
        imp = np.zeros(self.max_feature_idx + 1)
        T = self._num_trees(num_iteration)
        for t in self.models[:T]:
            for node in range(t.num_leaves - 1):
                imp[int(t.split_feature[node])] += 1
        return imp

    def save_model_to_string(self, num_iteration: int = -1) -> str:
        lines = ["tree", f"version={K_MODEL_VERSION}",
                 f"num_class={self.num_class}",
                 f"num_tree_per_iteration={self.num_tree_per_iteration}",
                 "label_index=0", f"max_feature_idx={self.max_feature_idx}"]
        if self.objective is not None:
            lines.append(f"objective={self.objective.to_string()}")
        lines.append("feature_names=" + " ".join(self.feature_names))
        lines.append("feature_infos=" + " ".join(self._feature_infos()))
        T = self._num_trees(num_iteration)
        tree_strs = [f"Tree={i}\n" + self.models[i].to_string() + "\n"
                     for i in range(T)]
        lines.append("tree_sizes=" + " ".join(str(len(s)) for s in tree_strs))
        lines.append("")
        body = "\n".join(lines) + "\n" + "".join(tree_strs)
        imp = self.feature_importance(num_iteration)
        pairs = sorted([(int(imp[i]), self.feature_names[i])
                        for i in range(len(imp)) if imp[i] > 0],
                       key=lambda p: -p[0])
        body += "\nfeature importances:\n"
        body += "".join(f"{nm}={v}\n" for v, nm in pairs)
        return body

    def load_model_from_string(self, text: str) -> None:
        """Reference LoadModelFromString (gbdt_model_text.cpp:317+)."""
        header, _, rest = text.partition("Tree=")
        kv: Dict[str, str] = {}
        for line in header.splitlines():
            line = line.strip()
            if "=" in line:
                k, v = line.split("=", 1)
                kv[k] = v
            elif line:
                kv[line] = ""
        self.num_class = int(kv.get("num_class", 1))
        self.num_tree_per_iteration = int(
            kv.get("num_tree_per_iteration", self.num_class))
        self.max_feature_idx = int(kv.get("max_feature_idx", 0))
        self.feature_names = kv.get("feature_names", "").split()
        self.average_output = "average_output" in kv
        obj_str = kv.get("objective", "")
        if obj_str and self.objective is None:
            self.objective = load_objective(obj_str)
        models = []
        if rest:
            for blk in ("Tree=" + rest).split("Tree="):
                blk = blk.strip()
                if not blk or blk.startswith("feature importances"):
                    continue
                body = blk.split("\n", 1)[1] if "\n" in blk else ""
                body = body.split("feature importances:")[0]
                if "num_leaves=" in body:
                    models.append(Tree.from_string(body))
        self.models = models
        self.iter = len(models) // max(1, self.num_tree_per_iteration)

    def _feature_infos(self) -> List[str]:
        if self.train_set is None:
            return ["none"] * (self.max_feature_idx + 1)
        infos = []
        for m in self.train_set.mappers:
            if m.is_trivial:
                infos.append("none")
            elif m.bin_type == 1:
                infos.append(":".join(str(c) for c in m.bin_2_categorical))
            else:
                infos.append(f"[{m.min_val!r}:{m.max_val!r}]")
        return infos
