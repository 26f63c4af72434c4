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
access.  A host tree goes back onto the card as node tables
(:func:`replay_tables`) walked over binned rows by the learner's walk
(``learner/serial.py:built_tree_leaves``): rollback, resume without a
score sidecar, ``add_valid`` after training started and refit rest on
that replay.  Snapshots and exact resume: ``boosting/snapshot.py``.

Inside a process group of more than one rank, ``tree_learner`` data,
feature or voting builds each tree through ``parallel/learners.py``
(the JAX package's distributed setup, ``gbdt.py:281-330``): a
data/voting rank holds its own rows (``ProcessRows``), draws its block
of the global bagging mask, and takes the init score and the
objective's dataset-level statistics over every rank's rows.
"""
from __future__ import annotations

import os
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..config import Config, canonicalize_params
from ..io.dataset import BinnedDataset
from ..io.device import DeviceData, to_device
from ..learner.serial import (BuiltTree, GrowthParams, build_tree,
                              predict_built_tree, resolve_backend)
from ..metric.metrics import (Metric, create_metric,
                              default_metric_for_objective)
from ..models.tree import (K_CATEGORICAL_MASK, K_DEFAULT_LEFT_MASK, Tree,
                           _construct_bitset, predict_leaf)
from ..objective.objectives import (ObjectiveFunction, convert_rows,
                                    create_objective, load_objective)
from ..obs import span as obs_span
from ..ops.split import SplitParams
from ..utils import random as keyed
from ..utils.file_io import open_read, open_write
from ..utils.log import log_info, log_warning
from ..utils.timetag import tag

K_MODEL_VERSION = "v2"     # reference gbdt_model_text.cpp:13

# mem.leak fault sink: while the fault point is armed, the training loop
# keeps one fresh device tensor an iteration here, a module-lifetime leak
# the memory watermark contract (obs/mem_contract.py) must catch and name
_MEM_LEAK_SINK: List[torch.Tensor] = []
# elements leaked an iteration (float32): past the contract's default
# 1 MiB tolerance, so one armed iteration shows above it
_MEM_LEAK_ELEMS = int(os.environ.get("LGBM_TPU_MEM_LEAK_ELEMS", 1 << 19))


def mem_leak_fault(it: int, device) -> None:
    """The ``mem.leak`` fault seam: while armed, one fresh device tensor
    an iteration goes into :data:`_MEM_LEAK_SINK`."""
    from ..utils import faults
    if faults.armed() and faults.fault_flag("mem.leak"):
        _MEM_LEAK_SINK.append(torch.full((_MEM_LEAK_ELEMS,), float(it),
                                         dtype=torch.float32,
                                         device=device))


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


def ordered_tree_sum(values: List[torch.Tensor],
                     block: int = 32) -> torch.Tensor:
    """Sum per-tree outputs (each ``[n]`` f32) in the order of the JAX
    package's ``jnp.sum`` over a tree axis padded to a power of two on
    the CPU: from 0.0 in tree order within blocks of ``block`` trees,
    then the block totals the same way (recursively).  The zero stumps
    of the padding add +0.0 to a partial sum that never holds -0.0, so
    they are skipped; only the block boundaries they fix remain."""
    if len(values) > block:
        return ordered_tree_sum([ordered_tree_sum(values[i:i + block], block)
                                 for i in range(0, len(values), block)],
                                block)
    acc = torch.zeros_like(values[0])
    for v in values:
        acc = acc + v
    return acc


def early_stop_mask(raw, margin: float):
    """Rows of ``raw`` ``[rows, K]`` whose margin exceeds ``margin``:
    2|s| for one tree an iteration, top1 - top2 for K > 1 (reference
    ``prediction_early_stop.cpp:38``, ``:60``); numpy or torch."""
    if raw.shape[1] == 1:
        return 2.0 * abs(raw[:, 0]) > margin
    if isinstance(raw, torch.Tensor):
        top = torch.topk(raw, 2, dim=1).values
        return (top[:, 0] - top[:, 1]) > margin
    part = np.partition(raw, raw.shape[1] - 2, axis=1)
    return (part[:, -1] - part[:, -2]) > margin


class ReplayTables(NamedTuple):
    """A host tree's node tables on the device, in the fields of a
    ``BuiltTree`` that ``learner/serial.py:built_tree_leaves`` walks."""
    feature: torch.Tensor          # [M] int32 inner (used-column) feature
    threshold_bin: torch.Tensor    # [M] int32
    default_left: torch.Tensor     # [M] bool
    is_categorical: torch.Tensor   # [M] bool
    cat_mask: torch.Tensor         # [M, B] bool left bins
    left_child: torch.Tensor       # [M] int32
    right_child: torch.Tensor      # [M] int32
    leaf_value: torch.Tensor       # [L] f32


def replay_tables(tree: Tree, max_bins: int, device) -> ReplayTables:
    """The device tables of a bin-aligned host ``tree`` (trained on the
    dataset's mappers, or loaded and given ``Tree.align_with_mappers``):
    the JAX package's ``stack_trees`` for one tree.  Leaf values are the
    tree's rounded to f32, as the JAX package's stacked trees hold
    them; categorical nodes send the bins of ``cat_left_bins`` left (a
    mask ``max_bins`` wide, only when the tree has a categorical
    node)."""
    nl = tree.num_leaves
    m = max(nl - 1, 1)
    dt = np.asarray(tree.decision_type[:m], np.int64)
    ic = (dt & K_CATEGORICAL_MASK) != 0
    cm = np.zeros((m, max_bins if ic.any() else 1), bool)
    for node in np.nonzero(ic)[0]:
        bins = np.asarray(tree.cat_left_bins[int(tree.threshold_bin[node])],
                          np.int64)
        cm[node, bins[bins < cm.shape[1]]] = True

    def dev(a, dtype=None):
        return torch.as_tensor(np.ascontiguousarray(a, dtype),
                               device=device)
    return ReplayTables(
        feature=dev(tree.split_feature_inner[:m], np.int32),
        threshold_bin=dev(tree.threshold_bin[:m], np.int32),
        default_left=dev((dt & K_DEFAULT_LEFT_MASK) != 0),
        is_categorical=dev(ic), cat_mask=dev(cm),
        left_child=dev(tree.left_child[:m], np.int32),
        right_child=dev(tree.right_child[:m], np.int32),
        leaf_value=dev(tree.leaf_value[:max(nl, 1)], np.float32))


def feature_infos(mappers) -> List[str]:
    """The model text's ``feature_infos`` of a dataset's bin mappers."""
    infos = []
    for m in mappers:
        if m.is_trivial:
            infos.append("none")
        elif m.bin_type == 1:
            infos.append(":".join(str(c) for c in m.bin_2_categorical))
        else:
            infos.append(f"[{m.min_val!r}:{m.max_val!r}]")
    return infos


class GBDT:
    """Gradient Boosting Decision Tree booster.

    The boosting variants (``boosting/variants.py``) override the seams
    of one iteration: :meth:`gradients`, :meth:`_row_sample` (the rows
    and the gradients a tree sees) and the two class flags below."""

    boosting_name = "gbdt"
    # the score update adds lr * value as one fused multiply-add, as the
    # JAX package's fused-window loop does; a variant that the JAX
    # package trains on its per-iteration loop rounds the product first
    fused_update = True
    # an iteration whose trees are all stumps is dropped and ends
    # training (False), or kept and counted before training ends (True;
    # the trailing stumps go at the end, :meth:`trim_trailing_stumps`)
    keeps_stump_iterations = False
    # live tensors of the score state's shape, dtype and device at an
    # iteration boundary: the scores themselves, updated in place
    # (obs/mem_contract.py)
    score_state_tensors = 1

    def __init__(self, config: Config, train_set: Optional[BinnedDataset],
                 device="cuda"):
        self.config = config
        # the process group's view and this rank's row block (set by
        # _setup_mesh in a distributed run)
        self.mesh_ctx = None
        self._pr = None
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
        self._loaded_feature_infos: Optional[List[str]] = None
        # early stopping's bookkeeping (callback.early_stopping), in the
        # snapshot manifest's keys: a resumed run keeps counting
        self._es_state = {"best_scores": {}, "best_iter": {},
                          "key_order": []}
        if train_set is not None:
            self._init_train(train_set)

    def _init_train(self, train_set: BinnedDataset) -> None:
        c = self.config
        if c.boosting_type != self.boosting_name:
            raise ValueError(
                f"boosting={c.boosting_type} on a {self.boosting_name} "
                f"booster: make it with boosting.variants.create_boosting")
        n = train_set.num_data
        self.num_data = n
        self._setup_mesh(n)
        self.device_data = to_device(train_set, self.device)
        if self.mesh_ctx is not None:
            self.device_data = self.mesh_ctx.place_data(self.device_data)
        self.feature_names = train_set.feature_names
        self.max_feature_idx = train_set.num_total_features - 1
        self.objective = create_objective(c)
        if self.objective is not None:
            self.objective.init(train_set.metadata, n, self.device)
            self.num_tree_per_iteration = \
                self.objective.num_model_per_iteration
            if self._pr is not None:
                # dataset-level statistics over every rank's rows
                self.objective.globalize_rows(self.mesh_ctx.allgather_host)
        K = self.num_tree_per_iteration
        scores = np.zeros((n, K), np.float32)
        ms = train_set.metadata.init_score
        if ms is not None:
            # class-major, as the reference stores [n * K] init scores
            # numcheck: disable=NUM002 -- ingest cast of user-supplied
            # init_score to the f32 score dtype, not an accumulation
            scores = np.asarray(ms, np.float64).reshape(
                -1, K, order="F").astype(np.float32)
        elif c.boost_from_average and self.objective is not None:
            if self._pr is not None:
                # the init score from every rank's labels (ranks would
                # diverge on their own shards')
                v = self.objective.boost_from_score_global(
                    self.mesh_ctx.allgather_host)
            else:
                v = self.objective.boost_from_score()
            if v != 0.0:
                self.init_score_value = v
                scores = np.full_like(scores, v)
                log_info(f"boost from average: init score = {v:.6f}")
        self.scores = torch.as_tensor(scores, device=self.device)
        self.growth = growth_params_from_config(c)
        self.hist_mode = c.hist_mode or None
        self._setup_metrics()
        if resolve_backend(self.device_data, c.num_leaves) == "scatter":
            log_info(f"{self.device_data.group_max_bins} bins in a group, "
                     f"{c.num_leaves} leaves: past the histogram kernels' "
                     f"domain, every wave takes the exact-f32 wide "
                     f"histogram (hist_mode does not apply)")

    def _setup_mesh(self, n: int) -> None:
        """The distributed setup of the JAX package's ``_init_train``
        (``gbdt.py:281-330``): with ``tree_learner`` data, feature or
        voting inside a process group of more than one rank, the group's
        ``MeshContext``, and for data/voting this rank's block of the
        global row axis (``ProcessRows``; every rank passes its own rows).
        With one rank the reference's warning, and serial training."""
        c = self.config
        self.mesh_ctx = None
        self._pr = None
        if c.tree_learner == "serial":
            return
        from ..parallel.mesh import MeshContext, ProcessRows, rank_world
        if rank_world()[1] > 1 or c.mesh_shape:
            self.mesh_ctx = MeshContext(c, self.device)
        if self.mesh_ctx is None or self.mesh_ctx.world == 1:
            self.mesh_ctx = None
            log_warning(f"tree_learner={c.tree_learner} requested but "
                        f"only one device is visible; running serial")
            return
        if c.tree_learner in ("data", "voting"):
            if self.boosting_name == "dart":
                raise NotImplementedError(
                    "boosting=dart is not supported with "
                    "multi-process training (documented "
                    "descope: per-tree drop/renormalize "
                    "score patching assumes addressable "
                    "scores); use gbdt/goss/rf, or "
                    "single-process multi-device meshes")
            self._pr = ProcessRows(self.mesh_ctx, n)

    def _build(self, grad: torch.Tensor, hess: torch.Tensor, bag,
               fmask) -> BuiltTree:
        """One tree: the serial learner, or this rank's part of the
        distributed build (``parallel/learners.py``)."""
        if self.mesh_ctx is None:
            return build_tree(self.device_data, grad, hess, self.growth,
                              bag_mask=bag, feature_mask=fmask,
                              hist_mode=self.hist_mode)
        from ..ops.overlap import overlap_enabled
        from ..parallel.learners import build_tree_distributed
        return build_tree_distributed(
            self.mesh_ctx, self.config.tree_learner, self.device_data, grad,
            hess, self.growth, bag_mask=bag, feature_mask=fmask,
            top_k=self.config.top_k, hist_mode=self.hist_mode,
            overlap=overlap_enabled())

    def _setup_metrics(self) -> None:
        c = self.config
        self.metrics = []
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
        after every tree.  Added after training started, the existing
        trees are replayed into its scores (the first tree of each class
        carries the init score)."""
        K = self.num_tree_per_iteration
        ms = valid_set.metadata.init_score
        if ms is not None:
            score = np.asarray(ms, np.float64).reshape(-1, K, order="F")
            # numcheck: disable=NUM002 -- ingest cast of init_score
            score = torch.as_tensor(score.astype(np.float32),
                                    device=self.device)
        else:
            init = 0.0 if self._num_models() else self.init_score_value
            score = torch.full((valid_set.num_data, K), init,
                               dtype=torch.float32, device=self.device)
        vd = to_device(valid_set, self.device)
        for j, tree in enumerate(self.models):
            score[:, j % K] += self._replay(tree, vd)
        self.valid_sets.append(valid_set)
        self.valid_names.append(name)
        self._valid_device.append(vd)
        self._valid_scores.append(score)

    def _bagging_mask(self, it: int) -> Optional[torch.Tensor]:
        """Row subsampling mask of iteration ``it`` (reference Bagging,
        ``gbdt.cpp:225-286``): pure in (``bagging_seed``, ``it //
        bagging_freq``), made once per bagging epoch."""
        c = self.config
        if c.bagging_freq <= 0 or c.bagging_fraction >= 1.0:
            return None
        epoch = it // c.bagging_freq
        from ..obs import determinism
        determinism.rng_site("gbdt.bag_mask", "bagging_seed/epoch")
        if self._bag is None or self._bag[0] != epoch:
            if self._pr is not None:
                # the mask over the global padded row axis, pure in
                # (seed, epoch): this rank keeps its block's real rows
                pr = self._pr
                full = bag_mask(c.bagging_seed, epoch, pr.n_pad,
                                c.bagging_fraction, self.device)
                mask = full[pr.offset:pr.offset + pr.n_local].contiguous()
            else:
                mask = bag_mask(c.bagging_seed, epoch, self.num_data,
                                c.bagging_fraction, self.device)
            self._bag = (epoch, mask)
        return self._bag[1]

    def _feature_mask(self, tree_idx: int) -> Optional[torch.Tensor]:
        """Per-tree feature subsampling (``serial_tree_learner.cpp:240-266``),
        pure in (``feature_fraction_seed``, global tree index)."""
        c = self.config
        if c.feature_fraction >= 1.0:
            return None
        F = self.device_data.num_features
        k = max(1, int(c.feature_fraction * F))
        from ..obs import determinism
        determinism.rng_site("gbdt.feature_mask",
                             "feature_fraction_seed/tree_idx")
        return feature_mask(c.feature_fraction_seed, tree_idx, F,
                            k).to(self.device)

    # -- host trees ------------------------------------------------------
    @property
    def models(self) -> List[Tree]:
        """Host tree list; converts pending device trees on access."""
        if self._pending:
            with obs_span("gbdt.to_host_trees"), tag("to_host_tree"):
                for bt, lr, bias in self._pending:
                    host = self._to_host_tree(bt)
                    host.shrinkage(lr)
                    if bias:
                        # init score: each class's first tree
                        host.add_bias(bias)
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
        """(grad, hess), each ``[n, K]`` (reference Boosting()).

        The ``health.nan_grad`` fault seam: while armed, one gradient
        element becomes NaN, which the numerics sentinels
        (``obs/health.py``) must catch at the right iteration."""
        g, h = self.objective.get_gradients_k(self.scores)
        from ..utils import faults
        if faults.armed() and faults.fault_flag("health.nan_grad"):
            g = g.clone()
            g[0, 0] = float("nan")
        return g, h

    def custom_gradients(self, fobj, dataset
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``fobj(scores, dataset) -> (grad, hess)`` on the host, as the
        JAX package calls it (``gbdt.py:704-716``): the scores come to the
        host, flattened class-major (``[n * K]``, class k's rows together)
        when K > 1, ``[n]`` otherwise; a 1-D grad or hess is read
        class-major the same way, a 2-D one as ``[n, K]``.  Each becomes
        an f32 ``[n, K]`` tensor on this booster's device in one copy."""
        K = self.num_tree_per_iteration
        s = self.scores.cpu().numpy()
        g, h = fobj(s.reshape(-1, order="F") if K > 1 else s[:, 0], dataset)

        def dev(a):
            a = np.asarray(a, np.float32)
            a = a.reshape(-1, K, order="F") if a.ndim == 1 else a.reshape(
                -1, K)
            return torch.as_tensor(a, device=self.device)
        return dev(g), dev(h)

    def train_one_iter(self, grad: Optional[torch.Tensor] = None,
                       hess: Optional[torch.Tensor] = None) -> bool:
        """One boosting iteration (reference TrainOneIter), on the
        objective's gradients or the given ``[n, K]`` ones.  Returns True
        when training should stop: the K trees are all stumps (no split
        meets the requirements), and the iteration is dropped."""
        dev = self.device
        with tag("boosting(grad)", dev):
            if grad is None or hess is None:
                grad, hess = self.gradients()
        K = self.num_tree_per_iteration
        grad, hess, bag = self._row_sample(grad, hess)
        trees = []
        raw_leaf_values = []
        for k in range(K):
            with tag("tree", dev):
                bt = self._build(grad[:, k].contiguous(),
                                 hess[:, k].contiguous(), bag,
                                 self._feature_mask(self.iter * K + k))
            bt = self._renew_leaves(bt, k)
            with tag("stump_check", dev):
                nl, depth = torch.stack([bt.num_leaves,
                                         bt.leaf_depth.max()]).tolist()
            # the values before a stump's zeroing: a non-finite gradient
            # makes a stump with a non-finite root value, which the
            # zeroing below would hide from every later check
            raw_leaf_values.append(bt.leaf_value)
            if nl <= 1:
                # a stump adds nothing (reference gbdt.cpp:435-460)
                bt.leaf_value = torch.zeros_like(bt.leaf_value)
            trees.append((bt, nl, depth))
        stumps = all(nl <= 1 for _, nl, _ in trees)
        if stumps:
            from ..obs import health
            if health.sentinels_enabled():
                health.check_leaf_values(
                    [v.cpu().numpy() for v in raw_leaf_values],
                    window=self.iter)
        if stumps and not self.keeps_stump_iterations:
            log_warning("stopped training because there are no more leaves "
                        f"that meet the split requirements (iteration "
                        f"{self.iter + 1})")
            return True
        for k, (bt, _, depth) in enumerate(trees):
            with tag("score", dev):
                self._update_scores(bt, k, depth)
            # empty tensors, not [:0] views: a view would keep the [n]
            # per-row storage of every pending tree alive
            self._pending.append((BuiltTree(**{
                **bt.__dict__, "row_leaf": bt.row_leaf.new_empty(0),
                "row_value": bt.row_value.new_empty(0)}),
                self.shrinkage_rate, self._first_tree_bias()))
        self.iter += 1
        return stumps

    def _row_sample(self, grad: torch.Tensor, hess: torch.Tensor):
        """The gradients the iteration's trees see and their bag mask
        (None: every row): the bagging mask of this iteration here;
        GOSS samples by gradient instead."""
        return grad, hess, self._bagging_mask(self.iter)

    def trim_trailing_stumps(self) -> None:
        """Drop trailing iterations whose trees are all stumps (the JAX
        package's ``trim_trailing_stumps``, reference
        ``gbdt.cpp:462-468``): only a booster that
        :attr:`keeps_stump_iterations` holds any."""
        if not self.keeps_stump_iterations:
            return
        K = self.num_tree_per_iteration
        models = self.models
        trimmed = 0
        while (len(models) >= K
               and all(t.num_leaves <= 1 for t in models[-K:])):
            del models[-K:]
            self.iter -= 1
            trimmed += 1
        if trimmed:
            log_warning(f"dropped {trimmed} trailing iteration(s) with no "
                        f"splittable leaves")

    def _renew_leaves(self, bt: BuiltTree, k: int) -> BuiltTree:
        """The objective's leaf re-fit (RenewTreeOutput,
        ``serial_tree_learner.cpp:592-622``): each leaf of the tree takes
        the objective's percentile of its rows' residuals against class
        k's scores; under data- or voting-parallel training, of every
        rank's rows."""
        if not self._renews():
            return bt
        L = self.growth.num_leaves
        gather = None
        if self._pr is not None:
            # each leaf's percentile over every rank's rows, rank-major
            # (the JAX package's mesh order): every rank renews alike
            from ..obs.flight_recorder import record as fr_record
            ctx, counts = self.mesh_ctx, self._pr.counts

            def gather(t):
                # no operand: a rank's row count is its own
                fr_record("boosting.gbdt.renew_gather", "all_gather",
                          ctx.data_axis)
                return ctx.all_gather_rows(t, counts)
        new = self.objective.renew_tree_output(self.scores[:, k],
                                               bt.row_leaf, L,
                                               gather_rows=gather)
        bt.leaf_value = torch.where(
            torch.arange(L, device=self.device) < bt.num_leaves,
            new.to(torch.float32), bt.leaf_value)
        return bt

    def _renews(self) -> bool:
        return (self.objective is not None
                and self.objective.need_renew_tree_output)

    def _update_scores(self, bt: BuiltTree, k: int, depth: int) -> None:
        """Add the shrunk kernel-emitted per-row leaf values: one fused
        multiply-add per row, as the reference's compiled update.  A
        renewed tree's values are gathered per row and the product is
        rounded before the add, as the reference's per-iteration loop
        (the only one renewal takes) does; in a distributed run the add
        is a fused multiply-add again, as the reference's jitted mesh
        update (``_mesh_score_update``) compiles.  Valid scores add the
        shrunk values of a device walk of the tree, ``depth`` levels
        deep (the product rounded, then the add, as the reference's
        eager update)."""
        lr = torch.tensor(self.shrinkage_rate, dtype=torch.float32,
                          device=self.device)
        if self._renews():
            vals = bt.leaf_value[bt.row_leaf.long()]
            if self.mesh_ctx is not None:
                self.scores[:, k].add_(vals, alpha=self.shrinkage_rate)
            else:
                self.scores[:, k] += lr * vals
        elif self.fused_update:
            self.scores[:, k].add_(bt.row_value, alpha=self.shrinkage_rate)
        else:
            self.scores[:, k] += lr * bt.row_value
        for vd, score in zip(self._valid_device, self._valid_scores):
            score[:, k] += lr * predict_built_tree(bt, vd, depth)

    # -- host trees on the card -------------------------------------------
    def _replay(self, tree: Tree, dd: DeviceData) -> torch.Tensor:
        """A bin-aligned host tree's f32 output per row of ``dd``, walked
        on the device (the JAX package's ``_predict_host_tree_binned``)."""
        return predict_built_tree(
            replay_tables(tree, dd.max_bins, self.device), dd,
            tree.max_depth)

    def _replay_sum(self, trees: List[Tree], dd: DeviceData) -> torch.Tensor:
        """The summed f32 output per row of ``dd`` of several bin-aligned
        host trees, in the JAX package's order
        (``_predict_host_trees_binned``: the tree axis padded with zero
        stumps to a power of two and reduced by XLA; on the CPU that sum
        runs from 0.0 in tree order within blocks of 32 trees, then over
        the block totals the same way, :func:`ordered_tree_sum`)."""
        return ordered_tree_sum([self._replay(t, dd) for t in trees])

    def merge_from(self, other: "GBDT") -> None:
        """Put deep copies of ``other``'s trees in front of this booster's
        (reference ``GBDT::MergeFrom``, ``gbdt.h:50-67``; the JAX
        package's ``merge_from``): iteration numbering continues after
        them, and each one's replay on the device is added, in tree
        order, to the training and valid scores.  ``other``'s trees must
        be bin-aligned to this booster's training set
        (``Tree.align_with_mappers``).  The scores keep what they held:
        a booster made with ``boost_from_average`` holds the average
        already, and the first merged tree carries its own bias too, as
        in the JAX package (ROADMAP C23)."""
        import copy
        if other.num_tree_per_iteration != self.num_tree_per_iteration:
            raise ValueError("cannot merge boosters with different "
                             "num_tree_per_iteration")
        new = [copy.deepcopy(t) for t in other.models]
        self.models = new + list(self.models)
        K = max(1, self.num_tree_per_iteration)
        self.iter = len(self._host_models) // K
        if self.train_set is None:
            return
        for j, tree in enumerate(new):
            self.scores[:, j % K] += self._replay(tree, self.device_data)
            for vd, score in zip(self._valid_device, self._valid_scores):
                score[:, j % K] += self._replay(tree, vd)

    def rollback_one_iter(self) -> None:
        """Reference RollbackOneIter (``gbdt.cpp:474-490``): drop the last
        iteration's K trees and subtract their replayed outputs from the
        training and valid scores."""
        if self.iter <= 0:
            return
        K = self.num_tree_per_iteration
        models = self.models
        for k in range(K):
            tree = models.pop()
            kk = K - 1 - k
            if self.train_set is not None:
                self.scores[:, kk] -= self._replay(tree, self.device_data)
            for vd, score in zip(self._valid_device, self._valid_scores):
                score[:, kk] -= self._replay(tree, vd)
        self.iter -= 1

    def reset_config(self, params: Dict) -> None:
        """Reference ResetConfig: re-read the training hyper-parameters,
        keeping the dataset and the model."""
        self.config.update(canonicalize_params(dict(params)))
        self.config.check()
        self.shrinkage_rate = self.config.learning_rate
        if self.train_set is not None:
            self.growth = growth_params_from_config(self.config)
            self.hist_mode = self.config.hist_mode or None
            self._setup_metrics()

    def refit_rows(self, X: np.ndarray, metadata,
                   decay_rate: float = 0.9) -> np.ndarray:
        """Re-estimate every tree's leaf values on new rows keeping the
        structures (reference RefitTree, ``gbdt.cpp:268-280``).  Each
        row's leaf in every tree comes from the compiled predictor's walk
        on this booster's device (``serve/compiler.py``, routing exactly
        as the host walk over raw values, as the reference's
        ``predict(pred_leaf=True)`` does); the objective, kept when the
        model has one, takes its labels from ``metadata``.  Returns the
        ``[n, T]`` leaf indices."""
        from ..serve import compile_model
        X = np.asarray(X)
        pred_leaf = compile_model(self).leaf_indices(X)
        n = X.shape[0]
        self.num_data = n
        if self.objective is None:
            self.objective = create_objective(self.config)
        self.objective.init(metadata, n, self.device)
        self.refit(pred_leaf, decay_rate, metadata)
        return pred_leaf

    def refit(self, pred_leaf: np.ndarray, decay_rate: float = 0.9,
              metadata=None) -> None:
        """Refit the leaf outputs from each row's leaf ``pred_leaf[:, t]``
        (the JAX package's ``GBDT.refit``; reference RefitTree,
        ``gbdt.cpp:329-351``): ``new = decay_rate * old + (1 -
        decay_rate) * shrinkage * refit_output``, a leaf no row reaches
        keeping its output.  Iteration by iteration as the reference's
        refit task: gradients at the current scores on the device, one
        host copy of them, per-leaf sums in float64 on the host in row
        order (``np.add.at``; no float atomics), then the refitted
        trees' f32 outputs join the scores the next iteration's
        gradients see."""
        K = self.num_tree_per_iteration
        models = self.models
        c = self.config
        n = pred_leaf.shape[0]
        scores = torch.zeros((n, K), dtype=torch.float32, device=self.device)
        ms = metadata.init_score if metadata is not None else None
        if ms is not None:
            # numcheck: disable=NUM002 -- ingest cast of init_score
            scores = torch.as_tensor(np.asarray(ms, np.float64).reshape(
                -1, K, order="F").astype(np.float32), device=self.device)
        leaves_dev = torch.as_tensor(np.asarray(pred_leaf, np.int64),
                                     device=self.device)
        for it in range(len(models) // K):
            self.scores = scores
            grad, hess = self.gradients()
            g = grad.cpu().numpy()
            h = hess.cpu().numpy()
            for k in range(K):
                i = it * K + k
                tree = models[i]
                leaves = pred_leaf[:, i]
                nl = tree.num_leaves
                sg = np.zeros(nl)
                sh = np.zeros(nl)
                cnt = np.zeros(nl)
                np.add.at(sg, leaves, g[:, k])
                np.add.at(sh, leaves, h[:, k])
                np.add.at(cnt, leaves, 1.0)
                old = np.asarray(tree.leaf_value[:nl], np.float64)
                with np.errstate(divide="ignore", invalid="ignore"):
                    out = (-(np.sign(sg)
                             * np.maximum(np.abs(sg) - c.lambda_l1, 0.0))
                           / (sh + c.lambda_l2))
                new_vals = np.where(
                    cnt > 0,
                    decay_rate * old
                    + (1.0 - decay_rate) * out * self.shrinkage_rate,
                    old)
                for leaf in range(nl):
                    tree.set_leaf_output(leaf, float(new_vals[leaf]))
                lv = torch.as_tensor(
                    np.asarray(tree.leaf_value[:nl], np.float32),
                    device=self.device)
                scores[:, k] += lv[leaves_dev[:, i]]
        self.scores = scores

    # -- snapshots and exact resume -----------------------------------------
    def save_snapshot(self, iteration: Optional[int] = None
                      ) -> Optional[str]:
        """Write an atomic snapshot (model, f32 score state, manifest)
        under the ``output_model`` prefix and prune to ``snapshot_keep``
        (``boosting/snapshot.py``); returns the model path (None on the
        ranks other than 0 of a multi-process run).

        In a multi-process run every rank calls it at the same iteration
        and the write goes through a cross-rank commit barrier (the JAX
        package's): the ranks first gather ``(iteration, digest of the
        trees)`` and the write goes ahead only when every rank reports the
        same pair; rank 0 then writes the model and the manifest, and a
        second gather keeps the other ranks from running past a snapshot
        that is not on disk yet.  Each rank's own scores go to its rank
        state file before the first gather."""
        it = self.iter if iteration is None else iteration
        if self.mesh_ctx is not None:
            ctx = self.mesh_ctx
            return self._snapshot_barrier(it, ctx.all_gather_object,
                                          ctx.rank, ctx.feature_index == 0,
                                          ctx.feature_shards)
        from .snapshot import write_snapshot
        return write_snapshot(self, it)

    def _snapshot_barrier(self, iteration: int, allgather,
                          rank: int, writes: bool = True,
                          replicas: int = 1) -> Optional[str]:
        """The commit barrier over ``allgather(obj) -> [obj of each
        rank]``.  Every rank's ack is compared.  Under a 2-D mesh the
        ``replicas`` ranks of a data index ack in a row and the first
        ``writes`` the data index's state; the others take part in the
        gathers only."""
        from ..obs import event
        from .snapshot import write_rank_state, write_snapshot
        digest = self.digest(include_scores=False)
        sha = write_rank_state(self, iteration, rank) if writes else ""
        acks = allgather({"iteration": int(iteration), "digest": digest,
                          "state_sha256": sha})
        heads = [(a["iteration"], a["digest"]) for a in acks]
        if any(h != heads[0] for h in heads[1:]):
            event("elastic", "barrier_mismatch", iteration=int(iteration),
                  acks=len(acks))
            raise RuntimeError(
                f"snapshot commit barrier at iteration {iteration} "
                f"refused: ranks disagree on (iteration, digest): {heads}")
        path = None
        if rank == 0 and writes:
            path = write_snapshot(self, iteration,
                                  rank_states=[a["state_sha256"]
                                               for a in acks[::replicas]])
        # commit confirmation: no rank goes on (or treats the snapshot as
        # durable) before rank 0's manifest is on disk
        allgather({"committed": int(iteration)})
        return path

    def resume_from_snapshot(self, path_or_dir: str) -> int:
        """Restore trees, scores and early-stopping state from the latest
        valid snapshot under ``path_or_dir`` (a manifest, a snapshot
        model path, an ``output_model`` prefix or a directory), so that
        training on continues where the dead run stopped; returns the
        restored iteration.  Scores come back bit for bit from the f32
        sidecar when it fits; otherwise the trees are replayed, a
        last-ulp approximation."""
        from .snapshot import config_hash, resolve_snapshot
        manifest = resolve_snapshot(path_or_dir)
        if manifest is None:
            raise FileNotFoundError(
                f"no valid snapshot found at {path_or_dir!r}")
        if self.train_set is None:
            raise ValueError("resume_from_snapshot needs a booster with "
                             "an attached training set")
        if manifest["config_hash"] != config_hash(self.config):
            log_warning("resuming with a DIFFERENT config than the "
                        "snapshot was written with; the continued run "
                        "will not match an uninterrupted one")
        # the world must match: another world has another row layout
        snap_world = manifest.get("world_size")
        live_world = self.mesh_ctx.world if self.mesh_ctx is not None else 1
        if snap_world is None:
            if live_world > 1:
                log_warning("snapshot manifest predates world-size "
                            "tracking; cannot verify it matches this "
                            f"{live_world}-process mesh")
        elif int(snap_world) != live_world:
            raise ValueError(
                f"cannot resume: snapshot was written on a "
                f"{int(snap_world)}-process mesh, this run has "
                f"{live_world} process(es); re-shard via elastic "
                f"training (parallel/elastic.py) or restart training")
        with open_read(manifest["model_path"]) as f:
            text = f.read()
        donor = GBDT(self.config, None, self.device)
        donor.load_model_from_string(text)
        if donor.num_tree_per_iteration != self.num_tree_per_iteration:
            raise ValueError("cannot resume: num_tree_per_iteration "
                             "differs between snapshot and config")
        fmap = {f: i for i, f in enumerate(self.train_set.used_features)}
        for t in donor.models:
            t.align_with_mappers(self.train_set.mappers, fmap)
        self.models = list(donor.models)
        self.iter = int(manifest["iteration"])
        self.init_score_value = float(manifest.get("init_score_value", 0.0))
        self._es_state = {
            "best_scores": dict(manifest.get("best_scores", {})),
            "best_iter": {k: int(v) for k, v in
                          manifest.get("best_iter", {}).items()},
            "key_order": list(manifest.get("key_order", []))}
        self._restore_scores(manifest)
        self.load_snapshot_extra_state(manifest.get("extra_state", {}))
        self._bag = None            # rebuilt for the restored epoch
        log_info(f"resumed from snapshot {manifest['model_path']} at "
                 f"iteration {self.iter} ({len(self._host_models)} trees)")
        return self.iter

    def snapshot_extra_state(self) -> Dict:
        """Variant bookkeeping a snapshot carries beyond trees, scores and
        early stopping (DART's drop weights, ROADMAP A8); JSON."""
        return {}

    def load_snapshot_extra_state(self, extra: Dict) -> None:
        """Inverse of :meth:`snapshot_extra_state` on resume."""

    def _restore_scores(self, manifest: Dict) -> None:
        """The exact f32 scores of the sidecar when they fit this booster
        (same training rows, the same valid sets); tree replay
        otherwise."""
        K = max(1, self.num_tree_per_iteration)
        state = None
        path = manifest.get("state_path")
        if self.mesh_ctx is not None:
            # a multi-process snapshot: this rank's own rows
            path = (manifest.get("rank_state_paths") or {}).get(
                self.mesh_ctx.rank, "")
        if path:
            state = np.load(path)
            s = state.get("scores")
            want = (self.num_data, K)
            if s is None or s.shape != want:
                log_warning(f"snapshot score state has shape "
                            f"{None if s is None else s.shape}, booster "
                            f"needs {want}; replaying trees instead")
                state = None
        if state is not None:
            self.scores = torch.tensor(np.asarray(state["scores"],
                                                  np.float32),
                                       device=self.device)
            for i, vscore in enumerate(self._valid_scores):
                vs = state.get(f"valid_scores_{i}")
                if vs is not None and vs.shape == tuple(vscore.shape):
                    self._valid_scores[i] = torch.tensor(
                        np.asarray(vs, np.float32), device=self.device)
                else:
                    self._replay_valid_scores(i)
            return
        # the first tree of each class carries the init score: replay
        # from zero
        self.scores = torch.zeros_like(self.scores)
        for j, tree in enumerate(self._host_models):
            self.scores[:, j % K] += self._replay(tree, self.device_data)
        for i in range(len(self._valid_scores)):
            self._replay_valid_scores(i)

    def _replay_valid_scores(self, i: int) -> None:
        K = max(1, self.num_tree_per_iteration)
        vd = self._valid_device[i]
        score = torch.zeros_like(self._valid_scores[i])
        for j, tree in enumerate(self._host_models):
            score[:, j % K] += self._replay(tree, vd)
        self._valid_scores[i] = score

    def num_trees(self) -> int:
        return self._num_models()

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
        a trained and a loaded model alike; with ``pred_early_stop`` in
        rounds (:meth:`predict_raw_early_stop`).  The device path is the
        compiled predictor (``serve/compiler.py``), held to this walk."""
        models = self.models
        T = self._num_trees(num_iteration)
        K = max(1, self.num_tree_per_iteration)
        X = np.asarray(X, np.float64)
        if T > 0 and self.config.pred_early_stop:
            out = self.predict_raw_early_stop(X, T)[0]
        else:
            out = np.zeros((X.shape[0], K))
            if T == 0:
                out[:] = self.init_score_value
            for i in range(T):
                out[:, i % K] += models[i].predict_batch(X)
        return out if K > 1 else out[:, 0]

    def predict_raw_early_stop(self, X: np.ndarray, T: int
                               ) -> Tuple[np.ndarray, np.ndarray]:
        """Prediction early stopping on the host walk (the JAX package's
        ``_predict_raw_early_stop``; reference
        ``prediction_early_stop.cpp``): the first ``T`` trees in rounds
        of ``pred_early_stop_freq`` iterations; after each round a row
        whose margin exceeds ``pred_early_stop_margin`` takes no more
        trees.  Margin: binary 2|s|, multiclass top1 - top2.  Each row's
        trees add in order in float64.  -> ``(raw [n, K] f64, rounds
        taken per row [n] int32)``; the oracle of the compiled
        predictor's rounds on the card
        (``serve/compiler.py:CompiledModel.predict_raw_early_stop``)."""
        c = self.config
        freq = max(1, c.pred_early_stop_freq)
        K = max(1, self.num_tree_per_iteration)
        X = np.asarray(X, np.float64)
        n = X.shape[0]
        out = np.zeros((n, K))
        taken = np.zeros(n, np.int32)
        active = np.ones(n, bool)
        rounds = -(-(T // K) // freq)
        for r in range(rounds):
            rows = np.nonzero(active)[0]
            if rows.size == 0:
                break
            Xr = X[rows]
            for i in range(r * freq * K, min(T, (r + 1) * freq * K)):
                out[rows, i % K] += self.models[i].predict_batch(Xr)
            taken[rows] += 1
            active[rows[early_stop_mask(out[rows],
                                        c.pred_early_stop_margin)]] = False
        return out, taken

    def predict(self, X: np.ndarray, raw_score: bool = False,
                num_iteration: int = -1) -> np.ndarray:
        raw = self.predict_raw(X, num_iteration)
        if raw_score or self.objective is None:
            return raw
        if self.average_output:
            raw = raw / max(1, len(self.models)
                            // max(1, self.num_tree_per_iteration))
        return convert_rows(self.objective, raw)

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
    def feature_importance(self, importance_type: str = "split",
                           num_iteration: int = -1) -> np.ndarray:
        """Reference FeatureImportance (``gbdt_model_text.cpp:284+``): per
        original feature, its splits (``"split"``) or their summed
        non-negative gains (``"gain"``)."""
        imp = np.zeros(self.max_feature_idx + 1)
        T = self._num_trees(num_iteration)
        for t in self.models[:T]:
            for node in range(t.num_leaves - 1):
                f = int(t.split_feature[node])
                if importance_type == "split":
                    imp[f] += 1
                else:
                    imp[f] += max(0.0, float(t.split_gain[node]))
        return imp

    def save_model_to_string(self, num_iteration: int = -1) -> str:
        """The reference text format; the first line names the boosting
        variant (``tree`` for gbdt), and an averaging model (random
        forest) carries ``average_output``."""
        lines = [self.boosting_name if self.boosting_name != "gbdt"
                 else "tree", f"version={K_MODEL_VERSION}",
                 f"num_class={self.num_class}",
                 f"num_tree_per_iteration={self.num_tree_per_iteration}",
                 "label_index=0", f"max_feature_idx={self.max_feature_idx}"]
        if self.objective is not None:
            lines.append(f"objective={self.objective.to_string()}")
        if self.average_output:
            lines.append("average_output")
        lines.append("feature_names=" + " ".join(self.feature_names))
        lines.append("feature_infos=" + " ".join(self._feature_infos()))
        T = self._num_trees(num_iteration)
        tree_strs = [f"Tree={i}\n" + self.models[i].to_string() + "\n"
                     for i in range(T)]
        lines.append("tree_sizes=" + " ".join(str(len(s)) for s in tree_strs))
        lines.append("")
        body = "\n".join(lines) + "\n" + "".join(tree_strs)
        imp = self.feature_importance("split", num_iteration)
        pairs = sorted([(int(imp[i]), self.feature_names[i])
                        for i in range(len(imp)) if imp[i] > 0],
                       key=lambda p: -p[0])
        body += "\nfeature importances:\n"
        body += "".join(f"{nm}={v}\n" for v, nm in pairs)
        return body

    def save_model(self, path: str, num_iteration: int = -1) -> None:
        with open_write(path) as f:
            f.write(self.save_model_to_string(num_iteration))

    def load_model_from_string(self, text: str,
                               keep_feature_infos: bool = False) -> None:
        """Reference LoadModelFromString (gbdt_model_text.cpp:317+).  A
        loaded model writes ``feature_infos`` as ``none`` (the JAX
        package's loaded model) unless ``keep_feature_infos``: a copy or
        a pickle of a Booster keeps the text's."""
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
        if keep_feature_infos and "feature_infos" in kv:
            self._loaded_feature_infos = kv["feature_infos"].split()
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
            return (self._loaded_feature_infos
                    or ["none"] * (self.max_feature_idx + 1))
        return feature_infos(self.train_set.mappers)
