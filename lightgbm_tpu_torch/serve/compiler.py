"""Model compiler: a trained booster packed for serving on the card.

Port of the JAX package's ``serve/compiler.py``.  The host walk
(``models/tree.py predict_leaf_batch``; ``Booster.predict`` on the CPU
or with ``device=False``) goes tree by tree in numpy; here
the whole forest becomes a few device tensors (:class:`ServePack`) and a
``[batch, F]`` block walks every tree at once with one gather per node
table per depth step, node state ``[T, rows]``.  The JAX package jits
that walk; on the card :meth:`CompiledModel.warm` captures it once per
padding bucket as a CUDA graph, and a warmed bucket then copies its rows
in and replays, with no host work per operation.

Exactness contract (``tests/test_torch_serve.py``; on the card,
``chip_smoke.py`` phase 12):

* **Leaf routing is bit-exact** against the host oracle
  (``models/tree.py:predict_leaf``) for float32 inputs.  The device
  compares in f32 against thresholds rounded TOWARD -inf to f32
  (:func:`_f32_floor`): for any f32 ``x`` and f64 ``t``, ``x <= t``
  iff ``x <= floor_f32(t)``, the reference's f64 ``NumericalDecision``
  exactly.  float64 inputs are cast to f32 first (documented narrowing).
* **Scores are within 1 ulp (f32)** of the f64 sequential host sum.  The
  JAX package carries each leaf value as an f32 hi/lo pair and adds
  them with Neumaier compensation in tree order, because the TPU has no
  f64.  The card has: leaf values stay f64, each class's trees are
  summed in f64 (a fixed-order reduction, no atomics) and the sum is
  rounded to f32 once.

Node tables hold the internal nodes and then the leaves of each tree
(``N = 2L - 1`` entries a tree, flattened over trees); a leaf entry
routes to itself, so the walk needs no "reached a leaf" select, and the
state is the flat entry index.  Two input paths share the walk:

* **raw** — ``[n, F]`` float rows, original feature indices,
  categorical membership through the model file's value bitsets (one
  flattened word table for the whole forest);
* **binned** — ``[n, Fi]`` uint8/int32 rows binned through the TRAINING
  bin mappers (:meth:`CompiledModel.bin_rows`): integer ``bin <=
  threshold_bin`` compares, a node's missing bin (its feature's NaN or
  zero bin) going to its default side, and categorical membership
  through each node's left BINS (``Tree.cat_left_bins``) as bitsets; an
  unseen category bins to the sentinel ``num_bin``, in no set, and goes
  right.
"""
from __future__ import annotations

import os
import threading
from dataclasses import dataclass
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..io.binning import MISSING_NAN, MISSING_ZERO
from ..models.tree import (K_CATEGORICAL_MASK, K_DEFAULT_LEFT_MASK,
                           _K_ZERO_THRESHOLD, Tree)
from ..utils.log import log_info


def _f32_floor(values: np.ndarray) -> np.ndarray:
    """Largest float32 <= each (float64) value.

    For f32 ``x`` and f64 ``t``: ``x <= t`` iff ``x <= _f32_floor(t)``,
    which is what makes the device's f32 threshold compare bit-exact
    against the reference's f64 decision.  +-inf and NaN pass through.
    """
    v = np.asarray(values, np.float64)
    v32 = v.astype(np.float32)
    over = v32.astype(np.float64) > v
    return np.where(over, np.nextafter(v32, np.float32(-np.inf)), v32)


# floor-rounded f32 image of the reference kZeroThreshold: |x| <= 1e-35
# in f64 iff |x| <= this in f32, for f32 x
_ZERO_EPS_F32 = float(
    _f32_floor(np.array([_K_ZERO_THRESHOLD], np.float64))[0])


@dataclass
class ServePack:
    """The forest as device tensors.

    Node tables are flat ``[T * N]`` over trees (``N = 2L - 1``: the
    ``L - 1`` internal nodes, then the ``L`` leaves, of each tree; T is
    padded to a multiple of the class count with zero-valued stumps).
    A walk starts at ``root`` and steps ``max_depth`` times through
    ``child[entry, side]`` (side 0 left, 1 right; a leaf's children are
    itself).  Binned-path tables are None when the pack was built
    without mappers; categorical tables are None when no tree has a
    categorical node (both, for the binned path's bin bitsets).
    """

    root: torch.Tensor                 # [T] int64 entry of each tree's root
    child: torch.Tensor                # [T*N, 2] int64 (left, right) entries
    split_feature: torch.Tensor        # [T*N] int64, ORIGINAL feature idx
    threshold: torch.Tensor            # [T*N] f32, floor-rounded
    default_left: torch.Tensor         # [T*N] bool
    miss_zero: torch.Tensor            # [T*N] bool (missing_type == Zero)
    nan_left: torch.Tensor             # [T*N] bool: where a NaN goes
    leaf_value: torch.Tensor           # [T*N] f64 (leaf entries)
    leaf_index: torch.Tensor           # [T*N] int32 (leaf entries)
    is_cat: Optional[torch.Tensor]     # [T*N] bool
    cat_offset: Optional[torch.Tensor]  # [T*N] int64 into cat_words
    cat_nwords: Optional[torch.Tensor]  # [T*N] int32
    cat_words: Optional[torch.Tensor]  # [W] int32 (uint32 value bitsets)
    split_feature_inner: Optional[torch.Tensor]  # [T*N] int64 used column
    threshold_bin: Optional[torch.Tensor]        # [T*N] int32
    missing_bin: Optional[torch.Tensor]  # [T*N] int32 NaN/zero bin or -1
    catbin_offset: Optional[torch.Tensor]  # [T*N] int64 into catbin_words
    catbin_nwords: Optional[torch.Tensor]  # [T*N] int32
    catbin_words: Optional[torch.Tensor]   # [W] int32 (left-bin bitsets)
    num_trees: int                     # trees of the model (before padding)
    num_class: int
    max_depth: int                     # walk steps


def build_pack(trees: Sequence[Tree], mappers=None,
               used_features: Optional[Sequence[int]] = None,
               num_class: int = 1, device="cuda") -> ServePack:
    """Pack host trees into a :class:`ServePack` on ``device`` (the card
    unless the caller asks for the CPU).

    ``mappers`` (per ORIGINAL feature, with ``used_features`` giving the
    inner-column order) also builds the binned path; trees must then be
    bin-aligned: trained on those mappers, or loaded and given
    ``Tree.align_with_mappers``.
    """
    K = max(1, num_class)
    T = len(trees)
    T_pad = -(-T // K) * K
    L = max(max((t.num_leaves for t in trees), default=2), 2)
    M = L - 1
    N = M + L
    E = T_pad * N
    base = np.arange(T_pad, dtype=np.int64)[:, None] * N
    # every entry starts as a zero-valued leaf routing to itself
    child = np.broadcast_to((base + np.arange(N))[..., None],
                            (T_pad, N, 2)).copy()
    root = base[:, 0] + M
    sf = np.zeros((T_pad, N), np.int64)
    thr = np.zeros((T_pad, N), np.float32)
    dl = np.zeros((T_pad, N), bool)
    mz = np.zeros((T_pad, N), bool)
    nanl = np.zeros((T_pad, N), bool)
    ic = np.zeros((T_pad, N), bool)
    lv = np.zeros((T_pad, N), np.float64)
    li = np.zeros((T_pad, N), np.int32)
    li[:, M:] = np.arange(L)
    co = np.zeros((T_pad, N), np.int64)
    cn = np.zeros((T_pad, N), np.int32)
    cat_words = []
    sfi = np.zeros((T_pad, N), np.int64)
    tb = np.zeros((T_pad, N), np.int32)
    mb = np.full((T_pad, N), -1, np.int32)
    bo = np.zeros((T_pad, N), np.int64)
    bn = np.zeros((T_pad, N), np.int32)
    catbin_words = []
    binned = mappers is not None
    inner = (list(used_features) if used_features is not None
             else list(range(len(mappers)))) if binned else []
    depth = 1
    for i, t in enumerate(trees):
        n = t.num_leaves
        m = n - 1
        lv[i, M:M + max(n, 1)] = np.asarray(t.leaf_value[:max(n, 1)],
                                            np.float64)
        if m == 0:
            continue                   # a stump: its root is leaf 0
        depth = max(depth, t.max_depth)
        root[i] = base[i, 0]
        for side, kids in enumerate((t.left_child[:m], t.right_child[:m])):
            kids = np.asarray(kids, np.int64)
            child[i, :m, side] = base[i, 0] + np.where(kids >= 0, kids,
                                                       M + ~kids)
        dt = np.asarray(t.decision_type[:m], np.int64)
        t64 = np.asarray(t.threshold[:m], np.float64)
        mt = (dt >> 2) & 3
        sf[i, :m] = t.split_feature[:m]
        thr[i, :m] = _f32_floor(t64)
        dl[i, :m] = (dt & K_DEFAULT_LEFT_MASK) != 0
        ic[i, :m] = (dt & K_CATEGORICAL_MASK) != 0
        mz[i, :m] = mt == MISSING_ZERO
        # NumericalDecision: a NaN is missing on NaN and Zero nodes (the
        # latter as 0.0), else it compares as 0.0
        nanl[i, :m] = np.where(mt != 0, dl[i, :m], 0.0 <= t64)
        for node in np.nonzero(ic[i, :m])[0]:
            ci = int(t.threshold_bin[node])
            words = t.cat_threshold[t.cat_boundaries[ci]:
                                    t.cat_boundaries[ci + 1]]
            co[i, node] = len(cat_words)
            cn[i, node] = len(words)
            cat_words.extend(int(w) for w in words)
            if binned:
                bins = np.asarray(t.cat_left_bins[ci], np.int64)
                bwords = [0] * (int(bins.max()) // 32 + 1 if len(bins)
                                else 1)
                for b in bins:
                    bwords[int(b) // 32] |= 1 << (int(b) % 32)
                bo[i, node] = len(catbin_words)
                bn[i, node] = len(bwords)
                catbin_words.extend(bwords)
        if binned:
            sfi[i, :m] = t.split_feature_inner[:m]
            tb[i, :m] = t.threshold_bin[:m]
            for node in range(m):
                mp = mappers[inner[int(sfi[i, node])]]
                if mp.missing_type == MISSING_NAN:
                    mb[i, node] = mp.num_bin - 1
                elif mp.missing_type == MISSING_ZERO:
                    mb[i, node] = mp.default_bin

    def dev(a):
        return torch.as_tensor(np.ascontiguousarray(a).reshape(
            (E,) + a.shape[2:]), device=device)

    has_cat = bool(ic.any())
    words = np.asarray(cat_words or [0], np.uint32).view(np.int32)
    bwords = np.asarray(catbin_words or [0], np.uint32).view(np.int32)
    bin_cat = binned and has_cat
    return ServePack(
        root=torch.as_tensor(root, device=device), child=dev(child),
        split_feature=dev(sf), threshold=dev(thr), default_left=dev(dl),
        miss_zero=dev(mz), nan_left=dev(nanl), leaf_value=dev(lv),
        leaf_index=dev(li),
        is_cat=dev(ic) if has_cat else None,
        cat_offset=dev(co) if has_cat else None,
        cat_nwords=dev(cn) if has_cat else None,
        cat_words=torch.as_tensor(words, device=device) if has_cat else None,
        split_feature_inner=dev(sfi) if binned else None,
        threshold_bin=dev(tb) if binned else None,
        missing_bin=dev(mb) if binned else None,
        catbin_offset=dev(bo) if bin_cat else None,
        catbin_nwords=dev(bn) if bin_cat else None,
        catbin_words=(torch.as_tensor(bwords, device=device) if bin_cat
                      else None),
        num_trees=T, num_class=K, max_depth=depth)


# ---------------------------------------------------------------------------
# the walk
# ---------------------------------------------------------------------------
def _bitset_member(words, offset, nwords, v):
    """``v in bitset`` per element (reference ``Common::FindInBitset``):
    ``v < 0`` or beyond the node's words is a miss."""
    w = v.clamp(min=0) >> 5
    ok = (v >= 0) & (w < nwords)
    word = words[torch.where(ok, offset + w, 0)]
    return ok & (((word >> (v & 31)) & 1) == 1)


def _leaf_entries_block(pack: ServePack, Xb: torch.Tensor, binned: bool,
                        trees: slice = slice(None)) -> torch.Tensor:
    """Leaf entry per (tree, row) of one row block -> ``[T, rows]``
    int64 (flat entries; ``pack.leaf_index`` / ``pack.leaf_value`` read
    them), over the pack's trees or the slice ``trees`` of them.

    The per-depth step is the reference ``Tree::GetLeaf`` decision
    (``tree.h:112-119``, ``NumericalDecision`` / ``CategoricalDecision``)
    over all trees at once: one gather per node table, one select per
    rule.
    """
    root = pack.root[trees]
    rows = Xb.shape[0]
    Xt = (Xb.to(torch.int32) if binned else Xb).t().contiguous()  # [F, r]
    node = root[:, None].expand(root.shape[0], rows)
    for _ in range(pack.max_depth):
        if binned:
            b = torch.gather(Xt, 0, pack.split_feature_inner[node])
            left = torch.where(b == pack.missing_bin[node],
                               pack.default_left[node],
                               b <= pack.threshold_bin[node])
            if pack.catbin_words is not None:
                cat_left = _bitset_member(pack.catbin_words,
                                          pack.catbin_offset[node],
                                          pack.catbin_nwords[node], b)
                left = torch.where(pack.is_cat[node], cat_left, left)
        else:
            v = torch.gather(Xt, 0, pack.split_feature[node])
            left = torch.where(
                pack.miss_zero[node] & (v.abs() <= _ZERO_EPS_F32),
                pack.default_left[node], v <= pack.threshold[node])
            nan = torch.isnan(v)
            left = torch.where(nan, pack.nan_left[node], left)
            if pack.is_cat is not None:
                # CategoricalDecision: NaN / negative / huge -> not in set
                cat = torch.where(nan | (v < 0) | (v >= 2.0 ** 31), -1.0,
                                  v).to(torch.int32)
                cat_left = _bitset_member(pack.cat_words,
                                          pack.cat_offset[node],
                                          pack.cat_nwords[node], cat)
                left = torch.where(pack.is_cat[node], cat_left, left)
        node = pack.child[node, (~left).long()]
    return node


def _sum_block(pack: ServePack, Xb: torch.Tensor, binned: bool,
               trees: slice = slice(None)) -> torch.Tensor:
    """Each class's f64 leaf values summed over its trees (of the slice
    ``trees``, whole iterations) for one row block -> ``[rows, K]``
    f64."""
    vals = pack.leaf_value[_leaf_entries_block(pack, Xb, binned, trees)]
    K = pack.num_class
    return vals.view(-1, K, vals.shape[1]).sum(0).t()


def _score_block(pack: ServePack, Xb: torch.Tensor,
                 binned: bool) -> torch.Tensor:
    """Raw scores of one row block -> ``[rows, K]`` f32: each class's
    f64 leaf values summed over its trees, rounded once."""
    return _sum_block(pack, Xb, binned).to(torch.float32)


def _row_chunks(n: int, rchunk: int):
    for c0 in range(0, n, rchunk):
        yield c0, min(n, c0 + rchunk)


def _score_batch(pack: ServePack, X: torch.Tensor, binned: bool,
                 rchunk: int) -> torch.Tensor:
    """Raw scores ``[n, K]`` f32 of a batch on the pack's device, in row
    chunks of ``rchunk`` (bounding the ``[T, rchunk]`` walk state)."""
    out = torch.empty((X.shape[0], pack.num_class), dtype=torch.float32,
                      device=X.device)
    for c0, c1 in _row_chunks(X.shape[0], rchunk):
        out[c0:c1] = _score_block(pack, X[c0:c1], binned)
    return out


def _leaf_batch(pack: ServePack, X: torch.Tensor, binned: bool,
                rchunk: int) -> torch.Tensor:
    """Per-tree leaf index per row -> ``[n, T]`` int32."""
    out = torch.empty((X.shape[0], pack.num_trees), dtype=torch.int32,
                      device=X.device)
    for c0, c1 in _row_chunks(X.shape[0], rchunk):
        ent = _leaf_entries_block(pack, X[c0:c1], binned)
        out[c0:c1] = pack.leaf_index[ent[:pack.num_trees]].t()
    return out


# ---------------------------------------------------------------------------
# user-facing compiled model
# ---------------------------------------------------------------------------
# rows per walk block: the [T, rows] state is a few int64/f64/bool
# tensors, about 40 bytes per (tree, row); 65,536 rows at 100 trees keep
# it near 260 MB of the card's memory and each operation wide enough
DEFAULT_ROW_CHUNK = 65536


def _default_rchunk() -> int:
    try:
        return int(os.environ.get("LGBM_TPU_SERVE_ROW_CHUNK",
                                  DEFAULT_ROW_CHUNK))
    except ValueError:
        return DEFAULT_ROW_CHUNK


def next_bucket(n: int, min_bucket: int = 256) -> int:
    """Smallest power-of-two bucket >= n (>= min_bucket): padding every
    batch to a bucket keeps the set of captured graphs finite, so
    steady-state serving replays graphs only."""
    return max(min_bucket, 1 << max(n - 1, 0).bit_length())


class _Graph:
    """One captured bucket: static input rows, the graph, its output."""
    __slots__ = ("rows", "graph", "out")

    def __init__(self, rows, graph, out):
        self.rows = rows
        self.graph = graph
        self.out = out


class CompiledModel:
    """A booster compiled for scoring on one device.

    Construct via :func:`compile_model` (boosters) or
    :func:`compile_trees` (bare tree lists).  Entry points pad the batch
    to a power-of-two bucket by default (``pad=True``).  On ``cuda``,
    :meth:`warm` captures one CUDA graph per bucket; a batch of a warmed
    size replays it, any other size runs eagerly on the card (counted in
    ``eager_calls``).  ``captures`` counts graph captures.
    """

    def __init__(self, pack: ServePack, *, objective=None,
                 average_output: bool = False, base_score: float = 0.0,
                 mappers=None, used_features: Optional[Sequence[int]] = None,
                 num_features: Optional[int] = None,
                 rchunk: Optional[int] = None, min_bucket: int = 256):
        self.pack = pack
        self.num_class = pack.num_class
        self.device = pack.root.device
        self.objective = objective
        self.average_output = average_output
        self.base_score = float(base_score)
        self.mappers = mappers
        self.used_features = (list(used_features)
                              if used_features is not None else None)
        sf_max = int(pack.split_feature.max()) if pack.num_trees else 0
        self.num_features = int(num_features if num_features is not None
                                else sf_max + 1)
        self.rchunk = int(rchunk or _default_rchunk())
        self.min_bucket = int(min_bucket)
        self.captures = 0
        self.eager_calls = 0
        self._graphs: Dict[Tuple[int, bool], _Graph] = {}
        self._lock = threading.Lock()

    # -- helpers ---------------------------------------------------------
    @property
    def num_trees(self) -> int:
        return self.pack.num_trees

    @property
    def has_binned(self) -> bool:
        return self.mappers is not None

    def _inner(self):
        return (self.used_features if self.used_features is not None
                else list(range(len(self.mappers))))

    def _check_binned(self) -> None:
        if self.mappers is None:
            raise ValueError("model was compiled without bin mappers; "
                             "the binned path is unavailable")

    def _bin_dtype(self):
        top = max((self.mappers[f].num_bin for f in self._inner()),
                  default=0)
        return np.uint8 if top <= np.iinfo(np.uint8).max else np.int32

    def bin_rows(self, X: np.ndarray) -> np.ndarray:
        """Bin raw rows through the TRAINING mappers (prediction-mode
        sentinels for unseen categories) -> ``[n, Fi]`` uint8 (int32 past
        255 bins) for the binned path."""
        self._check_binned()
        X = np.asarray(X, np.float64)
        inner = self._inner()
        out = np.zeros((X.shape[0], max(len(inner), 1)), np.int32)
        for j, f in enumerate(inner):
            out[:, j] = self.mappers[f].value_to_bin(X[:, f],
                                                     prediction_mode=True)
        return out.astype(self._bin_dtype())

    def _width(self, binned: bool) -> int:
        return (len(self._inner()) if binned else self.num_features)

    def _prepare(self, X: np.ndarray, binned: bool, pad: bool):
        if binned:
            self._check_binned()
        X = np.asarray(X)
        if X.ndim == 1:
            X = X[None, :]
        want = self._width(binned)
        if X.shape[1] < want:
            raise ValueError(f"expected >= {want} feature columns, "
                             f"got {X.shape[1]}")
        X = X[:, :want]
        if not binned:
            X = np.ascontiguousarray(X, np.float32)
        n = X.shape[0]
        if pad:
            bucket = next_bucket(n, self.min_bucket)
            if bucket != n:
                X = np.concatenate(
                    [X, np.zeros((bucket - n,) + X.shape[1:], X.dtype)])
        return X, n

    def _score(self, Xp: np.ndarray, binned: bool) -> np.ndarray:
        """Raw ``[rows, K]`` f32 scores of prepared rows: a warmed
        bucket's graph replay, else one eager walk."""
        g = self._graphs.get((Xp.shape[0], binned))
        if g is not None:
            with self._lock:
                g.rows.copy_(torch.from_numpy(Xp))
                g.graph.replay()
                return g.out.cpu().numpy()
        if self.device.type == "cuda":
            with self._lock:
                self.eager_calls += 1
        X = torch.from_numpy(np.ascontiguousarray(Xp)).to(self.device)
        return _score_batch(self.pack, X, binned,
                            self.rchunk).cpu().numpy()

    # -- scoring ---------------------------------------------------------
    def predict_raw(self, X: np.ndarray, *, binned: bool = False,
                    pad: bool = True) -> np.ndarray:
        """Raw scores ``[n]`` (or ``[n, K]`` multiclass), f32."""
        Xp, n = self._prepare(X, binned, pad)
        if self.num_trees == 0:
            out = np.full((n, self.num_class), self.base_score, np.float32)
        else:
            out = self._score(Xp, binned)[:n]
        return out if self.num_class > 1 else out[:, 0]

    def predict_raw_early_stop(self, X: np.ndarray, freq: int,
                               margin: float, *, binned: bool = False
                               ) -> Tuple[np.ndarray, np.ndarray]:
        """Prediction early stopping on the device (the rounds of the host
        oracle ``GBDT.predict_raw_early_stop``): the trees in rounds of
        ``freq`` iterations over the rows still active, each round's
        rows gathered on the device and padded to :func:`next_bucket`
        (so that the walk meets a few row counts, not one a round);
        each class's leaf values accumulate in f64 on the device and
        round to f32 once.  After a round a row whose margin (binary
        2|s|, multiclass top1 - top2) exceeds ``margin`` stops.  ->
        ``(raw [n] or [n, K] f32, rounds taken per row [n] int32)``."""
        from ..boosting.gbdt import early_stop_mask
        X, n = self._prepare(X, binned, pad=False)
        K = self.num_class
        if self.num_trees == 0:
            raw = np.full((n, K), self.base_score, np.float32)
            return (raw if K > 1 else raw[:, 0]), np.zeros(n, np.int32)
        Xd = torch.from_numpy(np.ascontiguousarray(X)).to(self.device)
        acc = torch.zeros((n, K), dtype=torch.float64, device=self.device)
        taken = torch.zeros(n, dtype=torch.int32, device=self.device)
        active = torch.ones(n, dtype=torch.bool, device=self.device)
        per_round = max(1, int(freq)) * K
        T_pad = self.pack.root.shape[0]
        for t0 in range(0, self.num_trees, per_round):
            rows = torch.nonzero(active).view(-1)
            m = rows.shape[0]
            if m == 0:
                break
            bucket = next_bucket(m, self.min_bucket)
            rows_pad = torch.cat([rows, rows.new_zeros(bucket - m)])
            Xb = Xd[rows_pad]
            trees = slice(t0, min(T_pad, t0 + per_round))
            part = torch.empty((bucket, K), dtype=torch.float64,
                               device=self.device)
            for c0, c1 in _row_chunks(bucket, self.rchunk):
                part[c0:c1] = _sum_block(self.pack, Xb[c0:c1], binned, trees)
            acc[rows] += part[:m]
            taken[rows] += 1
            active[rows[early_stop_mask(acc[rows], margin)]] = False
        raw = acc.to(torch.float32).cpu().numpy()
        return (raw if K > 1 else raw[:, 0]), taken.cpu().numpy()

    def predict(self, X: np.ndarray, raw_score: bool = False,
                *, binned: bool = False, pad: bool = True,
                early_stop: Optional[Tuple[int, float]] = None
                ) -> np.ndarray:
        """Objective-transformed prediction (the ``Booster.predict``
        contract: sigmoid/softmax applied unless ``raw_score``); the
        conversion runs on the host's copy of the raw scores.
        ``early_stop=(freq, margin)`` scores through
        :meth:`predict_raw_early_stop`."""
        if early_stop is not None:
            raw = self.predict_raw_early_stop(X, *early_stop,
                                              binned=binned)[0]
        else:
            raw = self.predict_raw(X, binned=binned, pad=pad)
        if raw_score or self.objective is None:
            return raw
        if self.average_output:
            raw = raw / max(1, self.num_trees // self.num_class)
        return self.objective.convert_output(torch.as_tensor(raw)).numpy()

    def leaf_indices(self, X: np.ndarray, *, binned: bool = False,
                     pad: bool = True) -> np.ndarray:
        """Per-tree leaf index per row -> ``[n, T]`` int32
        (PredictLeafIndex), one eager walk."""
        Xp, n = self._prepare(X, binned, pad)
        if self.num_trees == 0:
            return np.zeros((n, 0), np.int32)
        X = torch.from_numpy(np.ascontiguousarray(Xp)).to(self.device)
        return _leaf_batch(self.pack, X, binned,
                           self.rchunk).cpu().numpy()[:n]

    def warm(self, buckets: Sequence[int], *, binned: bool = False) -> None:
        """Capture the scorer of each bucket size as a CUDA graph (the
        JAX package compiles one program per bucket here).  A failed
        capture raises.  On the CPU there are no graphs: a no-op."""
        if self.device.type != "cuda" or self.num_trees == 0:
            return
        if binned:
            self._check_binned()
        dtype = torch.from_numpy(np.zeros(0, self._bin_dtype())).dtype \
            if binned else torch.float32
        F = self._width(binned)
        for b in sorted(set(int(v) for v in buckets)):
            if (b, binned) in self._graphs:
                continue
            rows = torch.zeros((b, F), dtype=dtype, device=self.device)
            # one run outside the capture, on a side stream, as
            # torch.cuda.graphs asks
            side = torch.cuda.Stream(self.device)
            side.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(side):
                _score_batch(self.pack, rows, binned, self.rchunk)
            torch.cuda.current_stream(self.device).wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                out = _score_batch(self.pack, rows, binned, self.rchunk)
            with self._lock:
                self.captures += 1
                self._graphs[(b, binned)] = _Graph(rows, graph, out)


def compile_trees(trees: Sequence[Tree], *, num_class: int = 1,
                  objective=None, average_output: bool = False,
                  base_score: float = 0.0, mappers=None,
                  used_features: Optional[Sequence[int]] = None,
                  num_features: Optional[int] = None, device="cuda",
                  rchunk: Optional[int] = None,
                  min_bucket: int = 256) -> CompiledModel:
    """Compile a bare tree list (see :func:`compile_model` for boosters)
    onto ``device``, the card unless the caller asks for the CPU."""
    pack = build_pack(trees, mappers=mappers, used_features=used_features,
                      num_class=num_class, device=torch.device(device))
    return CompiledModel(pack, objective=objective,
                         average_output=average_output,
                         base_score=base_score, mappers=mappers,
                         used_features=used_features,
                         num_features=num_features, rchunk=rchunk,
                         min_bucket=min_bucket)


def compile_model(model: Any, num_iteration: int = -1, *, device=None,
                  rchunk: Optional[int] = None,
                  min_bucket: int = 256) -> CompiledModel:
    """Compile a trained model for serving.

    ``model`` is a ``Booster`` (trained in-process or loaded from the
    reference text format) or a ``GBDT``.  ``num_iteration > 0``
    truncates to the first ``num_iteration * num_tree_per_iteration``
    trees, as every predict surface does.  The pack lands on ``device``,
    by default the model's own.  The binned path is built when the model
    still carries its training dataset (bin mappers); loaded models
    serve the raw path.
    """
    g = getattr(model, "_gbdt", model)
    K = max(1, g.num_tree_per_iteration)
    trees = list(g.models)
    if num_iteration is not None and num_iteration > 0:
        trees = trees[:num_iteration * K]
    mappers = used = None
    if g.train_set is not None:
        mappers = g.train_set.mappers
        used = g.train_set.used_features
    cm = compile_trees(
        trees, num_class=K, objective=g.objective,
        average_output=g.average_output,
        base_score=float(g.init_score_value or 0.0), mappers=mappers,
        used_features=used, num_features=g.max_feature_idx + 1,
        device=device if device is not None else g.device, rchunk=rchunk,
        min_bucket=min_bucket)
    log_info(f"serve: compiled {len(trees)} trees on {cm.device} (depth "
             f"{cm.pack.max_depth}, binned={'yes' if cm.has_binned else 'no'})")
    return cm
