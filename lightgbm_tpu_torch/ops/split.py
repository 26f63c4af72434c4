"""Vectorized best-split search over histograms.

Port of the JAX package's ``ops/split.py``: prefix sums over the bin
axis for every (leaf, feature) pair at once, both missing-value
directions evaluated in parallel, and one masked argmax with first-max
tie-breaks (reference ``FindBestThresholdSequence``,
`feature_histogram.hpp:312-452`; ``GetLeafSplitGain`` /
``CalculateSplittedLeafOutput``, `feature_histogram.hpp:291-308`).
Categorical features take one-vs-rest splits up to
``max_cat_to_onehot`` bins and the sorted many-vs-many search above
(`feature_histogram.hpp:104-259`); the winner's left bins are its
``cat_mask``.

Threshold ``t`` sends ``bin <= t`` left; missing values (the NaN bin for
MissingType::NaN, the zero/default bin for MissingType::Zero) go to the
side chosen by ``default_left``.  The reported gain is the improvement
over the parent.

Summation order: the prefix sums run in one fixed order,
:func:`prefix_sum` — sequential within blocks of 16 bins, then the
block totals' exclusive prefix added on — which is the order the
reference's compiled scan uses on the CPU, so the two packages' gains
agree bitwise on identical histograms.  The many-vs-many sort is stable
in the reference's order of floats (:func:`sort_key`).
"""
from __future__ import annotations

from dataclasses import dataclass, fields, replace
from typing import NamedTuple, Optional

import torch

from ..io.binning import MISSING_NAN, MISSING_ZERO

K_EPSILON = 1e-15          # reference kEpsilon (feature_histogram.hpp)
K_MIN_SCORE = -1e30        # reference kMinScore
PREFIX_BLOCK = 16

# live bytes the split scan may hold (the reference's HBM budget for the
# same scan; features are chunked past it)
SPLIT_SCAN_BUDGET = 512 * (1 << 20)
_SPLIT_SCAN_LIVE_GRIDS = 10


class SplitParams(NamedTuple):
    """Static split hyper-parameters (subset of TreeConfig)."""
    lambda_l1: float = 0.0
    lambda_l2: float = 0.0
    min_data_in_leaf: int = 20
    min_sum_hessian_in_leaf: float = 1e-3
    min_gain_to_split: float = 0.0
    max_cat_threshold: int = 32
    cat_smooth: float = 10.0
    cat_l2: float = 10.0
    max_cat_to_onehot: int = 4


@dataclass
class SplitResult:
    """Best split per leaf — the SplitInfo analog; every field is ``[L]``
    (``[L, B]`` for the categorical mask)."""
    gain: torch.Tensor           # f32, improvement over parent; <=0: none
    feature: torch.Tensor        # int32 used-feature index
    threshold: torch.Tensor      # int32 bin threshold
    default_left: torch.Tensor   # bool missing direction
    is_categorical: torch.Tensor  # bool
    cat_mask: torch.Tensor       # bool [L, B]: bins going left
    left_sum_grad: torch.Tensor
    left_sum_hess: torch.Tensor
    left_count: torch.Tensor     # f32
    right_sum_grad: torch.Tensor
    right_sum_hess: torch.Tensor
    right_count: torch.Tensor
    left_output: torch.Tensor
    right_output: torch.Tensor

    def map(self, fn, *others: "SplitResult") -> "SplitResult":
        """Field-wise ``fn(self.x, *(o.x for o in others))``."""
        return SplitResult(**{
            f.name: fn(getattr(self, f.name),
                       *(getattr(o, f.name) for o in others))
            for f in fields(self)})

    def replace(self, **kw) -> "SplitResult":
        return replace(self, **kw)


def prefix_sum(x: torch.Tensor, base: int = PREFIX_BLOCK) -> torch.Tensor:
    """Inclusive prefix sum over the last axis in a fixed order:
    sequential within blocks of ``base``, plus the (recursively summed)
    exclusive prefix of the block totals."""
    n = x.shape[-1]
    if n <= base:
        out = torch.empty_like(x)
        acc = x[..., 0]
        out[..., 0] = acc
        for i in range(1, n):
            acc = acc + x[..., i]
            out[..., i] = acc
        return out
    nb = -(-n // base)
    if nb * base != n:
        x = torch.cat([x, x.new_zeros(x.shape[:-1] + (nb * base - n,))], -1)
    blk = x.reshape(x.shape[:-1] + (nb, base))
    within = prefix_sum(blk, base)
    incl = prefix_sum(within[..., -1], base)
    excl = torch.cat([incl.new_zeros(incl.shape[:-1] + (1,)),
                      incl[..., :-1]], -1)
    out = within + excl[..., None]
    return out.reshape(x.shape)[..., :n]


def threshold_l1(s: torch.Tensor, l1: float) -> torch.Tensor:
    return torch.sign(s) * torch.clamp(s.abs() - l1, min=0.0)


def leaf_split_gain(sum_grad, sum_hess, l1: float, l2: float):
    t = threshold_l1(sum_grad, l1)
    return t * t / (sum_hess + l2)


def leaf_output(sum_grad, sum_hess, l1: float, l2: float):
    return -threshold_l1(sum_grad, l1) / (sum_hess + l2)


def _split_gain(lg, lh, rg, rh, l1, l2):
    return leaf_split_gain(lg, lh, l1, l2) + leaf_split_gain(rg, rh, l1, l2)


def split_scan_chunk_features(slots: int, num_features: int, B: int,
                              any_missing: bool = True) -> int:
    """Features per scan chunk so the live stack fits the budget."""
    per_f = (_SPLIT_SCAN_LIVE_GRIDS * (2 if any_missing else 1)
             * slots * B * 4)
    return min(num_features, max(1, SPLIT_SCAN_BUDGET // max(1, per_f)))


def _take_last(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return torch.gather(x, -1, idx[..., None])[..., 0]


def find_best_splits(hist: torch.Tensor, leaf_sum_grad, leaf_sum_hess,
                     leaf_count, num_bins, missing_types, default_bins,
                     params: SplitParams,
                     feature_mask: Optional[torch.Tensor] = None,
                     any_missing: bool = True,
                     feature_chunk: Optional[int] = None,
                     is_categorical: Optional[torch.Tensor] = None,
                     any_categorical: bool = False) -> SplitResult:
    """Best split for every leaf over every feature.

    ``hist`` is ``[L, F, B, 3]`` (grad, hess, count); the leaf sums are
    the authoritative ``[L]`` totals.  ``is_categorical`` ``[F]`` marks
    the categorical features; ``any_categorical`` False skips their
    search statically, as the reference does for all-numerical data.
    ``feature_chunk`` scans the feature axis in chunks whose winners
    merge with the argmax's first-max tie-break (chunked == unchunked
    bitwise).  The per-feature tables (``num_bins``, ``missing_types``,
    ``default_bins``, ``is_categorical``) are ``[F]``, or ``[L, F]`` when
    each leaf scans its own features (the voting learner's winners: the
    JAX package's per-leaf ``vmap`` of this scan)."""
    F = hist.shape[1]
    l1, l2 = params.lambda_l1, params.lambda_l2
    parent_gain = leaf_split_gain(leaf_sum_grad, leaf_sum_hess, l1, l2)
    gain_shift = parent_gain + params.min_gain_to_split

    def block(s, e):
        fm = feature_mask[s:e] if feature_mask is not None else None
        ic = (is_categorical[..., s:e] if any_categorical
              and is_categorical is not None else None)
        return _find_best_splits_block(
            hist[:, s:e], leaf_sum_grad, leaf_sum_hess, leaf_count,
            num_bins[..., s:e], missing_types[..., s:e],
            default_bins[..., s:e], params, fm, any_missing, ic)

    if feature_chunk is None or feature_chunk >= F:
        res = block(0, F)
    else:
        res = None
        for s in range(0, F, feature_chunk):
            r = block(s, min(F, s + feature_chunk))
            r = r.replace(feature=(r.feature + s).to(torch.int32))
            if res is None:
                res = r
            else:
                take = r.gain > res.gain
                res = res.map(
                    lambda cur, new: torch.where(
                        take.reshape((-1,) + (1,) * (cur.dim() - 1)),
                        new, cur), r)
    return res.replace(gain=(res.gain - gain_shift).float())


def _find_best_splits_block(hist, leaf_sum_grad, leaf_sum_hess, leaf_count,
                            num_bins, missing_types, default_bins,
                            params: SplitParams, feature_mask,
                            any_missing: bool,
                            is_categorical=None) -> SplitResult:
    """One feature block: the winner per leaf with its RAW gain
    (``is_categorical`` None: no categorical search).  The per-feature
    tables are ``[F]`` or ``[L, F]``; both are read as ``[L', F]``."""
    L, F, B, _ = hist.shape
    num_bins, missing_types, default_bins = (
        t if t.dim() == 2 else t[None]
        for t in (num_bins, missing_types, default_bins))
    if is_categorical is not None and is_categorical.dim() == 1:
        is_categorical = is_categorical[None]
    dev = hist.device
    g = hist[..., 0]
    h = hist[..., 1]
    c = hist[..., 2]
    bin_ids = torch.arange(B, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    min_score = torch.full((), K_MIN_SCORE, dtype=torch.float32, device=dev)

    tg = leaf_sum_grad[:, None]
    th = leaf_sum_hess[:, None]
    tc = leaf_count[:, None]

    l1, l2 = params.lambda_l1, params.lambda_l2
    min_d = params.min_data_in_leaf * 1.0
    min_h = params.min_sum_hessian_in_leaf + K_EPSILON

    valid_bin = bin_ids < num_bins[..., None]                      # [L', F, B]
    has_nan = missing_types == MISSING_NAN
    is_zero_missing = missing_types == MISSING_ZERO
    minus1 = torch.full_like(num_bins, -1)
    nan_bin = torch.where(has_nan, num_bins - 1, minus1)
    miss_bin = torch.where(has_nan, nan_bin,
                           torch.where(is_zero_missing, default_bins,
                                       minus1))
    is_miss_cell = bin_ids == miss_bin[..., None]                  # [L', F, B]
    has_missing = miss_bin >= 0

    vb = valid_bin & ~is_miss_cell
    g_scan = torch.where(vb, g, zero)
    h_scan = torch.where(vb, h, zero)
    c_scan = torch.where(vb, c, zero)
    # single-nonzero selection of the missing cell: exact in any order
    miss_g = torch.where(is_miss_cell, g, zero).sum(-1)
    miss_h = torch.where(is_miss_cell, h, zero).sum(-1)
    miss_c = torch.where(is_miss_cell, c, zero).sum(-1)

    cl = prefix_sum(torch.stack([g_scan, h_scan, c_scan]))
    cl_g, cl_h, cl_c = cl[0], cl[1], cl[2]

    max_t = torch.where(has_nan, num_bins - 2, num_bins - 1)
    t_ok = bin_ids < max_t[..., None]                              # [L', F, B]

    if not any_missing:
        lg, lh, lc = cl_g, cl_h, cl_c
        rg = tg[:, :, None] - lg
        rh = th[:, :, None] - lh
        rc = tc[:, :, None] - lc
        num_gain = _split_gain(lg, lh, rg, rh, l1, l2)
        ok = ((lc >= min_d) & (rc >= min_d) & (lh >= min_h) & (rh >= min_h))
        ok &= t_ok
        num_gain = torch.where(ok, num_gain, min_score)
        best_bin = torch.argmax(num_gain, dim=-1)                    # [L, F]
        num_best_gain = _take_last(num_gain, best_bin)
        num_lg, num_lh, num_lc = (_take_last(lg, best_bin),
                                  _take_last(lh, best_bin),
                                  _take_last(lc, best_bin))
        num_default_left = torch.zeros_like(best_bin, dtype=torch.bool)
    else:
        # variant 0: missing right; variant 1: missing left
        lg = torch.stack([cl_g, cl_g + miss_g[..., None]])       # [2, L, F, B]
        lh = torch.stack([cl_h, cl_h + miss_h[..., None]])
        lc = torch.stack([cl_c, cl_c + miss_c[..., None]])
        rg = tg[None, :, :, None] - lg
        rh = th[None, :, :, None] - lh
        rc = tc[None, :, :, None] - lc
        num_gain = _split_gain(lg, lh, rg, rh, l1, l2)
        ok = ((lc >= min_d) & (rc >= min_d) & (lh >= min_h) & (rh >= min_h))
        ok &= t_ok[None]
        ok &= torch.stack([torch.ones_like(has_missing),
                           has_missing])[..., None]
        ok &= ~(is_miss_cell & is_zero_missing[..., None])[None]
        num_gain = torch.where(ok, num_gain, min_score)
        var_best = torch.argmax(num_gain, dim=0)                     # [L, F, B]
        num_gain_b = num_gain.max(dim=0).values
        best_bin = torch.argmax(num_gain_b, dim=-1)                  # [L, F]
        num_best_gain = _take_last(num_gain_b, best_bin)
        best_var = _take_last(var_best, best_bin)

        def sel(x):   # [2, L, F, B] -> [L, F] at (best_var, best_bin)
            xb = torch.gather(x, -1, best_bin[None, ..., None].expand(
                2, L, F, 1))[..., 0]
            return torch.gather(xb, 0, best_var[None])[0]

        num_lg, num_lh, num_lc = sel(lg), sel(lh), sel(lc)
        num_default_left = best_var.bool()

    if is_categorical is not None:
        cat_gain, cat_mask_lr, cat_lg, cat_lh, cat_lc = _categorical_splits(
            g, h, c, tg, th, tc, num_bins, valid_bin, params)
        use_cat = is_categorical                                     # [L', F]
        feat_gain = torch.where(use_cat, cat_gain, num_best_gain)    # [L, F]
    else:
        feat_gain = num_best_gain
    if feature_mask is not None:
        feat_gain = torch.where(feature_mask[None, :], feat_gain, min_score)
    best_feat = torch.argmax(feat_gain, dim=-1)                      # [L]
    best_gain = _take_last(feat_gain, best_feat)
    b_lg = _take_last(num_lg, best_feat)
    b_lh = _take_last(num_lh, best_feat)
    b_lc = _take_last(num_lc, best_feat)
    dl = _take_last(num_default_left, best_feat)
    if is_categorical is not None:
        bf_cat = _take_last(is_categorical.expand(L, F), best_feat)
        b_lg = torch.where(bf_cat, _take_last(cat_lg, best_feat), b_lg)
        b_lh = torch.where(bf_cat, _take_last(cat_lh, best_feat), b_lh)
        b_lc = torch.where(bf_cat, _take_last(cat_lc, best_feat), b_lc)
        dl = dl & ~bf_cat
        cat_mask = torch.gather(
            cat_mask_lr, 1,
            best_feat[:, None, None].expand(L, 1, B))[:, 0]          # [L, B]
        eff_l2 = torch.where(bf_cat, l2 + params.cat_l2, l2)
    else:
        bf_cat = torch.zeros(L, dtype=torch.bool, device=dev)
        cat_mask = torch.zeros((L, B), dtype=torch.bool, device=dev)
        eff_l2 = l2
    b_rg = leaf_sum_grad - b_lg
    b_rh = leaf_sum_hess - b_lh
    b_rc = leaf_count - b_lc
    left_out = -threshold_l1(b_lg, l1) / (b_lh + eff_l2)
    right_out = -threshold_l1(b_rg, l1) / (b_rh + eff_l2)
    return SplitResult(
        gain=best_gain.float(),
        feature=best_feat.to(torch.int32),
        threshold=_take_last(best_bin, best_feat).to(torch.int32),
        default_left=dl,
        is_categorical=bf_cat,
        cat_mask=cat_mask,
        left_sum_grad=b_lg, left_sum_hess=b_lh, left_count=b_lc,
        right_sum_grad=b_rg, right_sum_hess=b_rh, right_count=b_rc,
        left_output=left_out, right_output=right_out)


def sort_key(x: torch.Tensor) -> torch.Tensor:
    """int32 keys that order float32 values as the reference's compiled
    sort does (both zeros and the denormals tie: it compares with
    denormals flushed to zero; NaNs last), so a stable sort of the keys
    is its stable argsort: the bit patterns in IEEE total order, after
    +0.0 replaces zeros and denormals and one NaN every NaN."""
    tiny = torch.finfo(torch.float32).tiny
    x = torch.where(torch.isnan(x), torch.full_like(x, torch.nan),
                    torch.where(torch.abs(x) < tiny, torch.zeros_like(x), x))
    bits = x.contiguous().view(torch.int32)
    return bits ^ ((bits >> 31) & 0x7FFFFFFF)


def _categorical_splits(g, h, c, tg, th, tc, num_bins, valid_bin,
                        params: SplitParams):
    """One-vs-rest + sorted many-vs-many categorical search
    (`feature_histogram.hpp:104-259`): per (leaf, feature) the best gain,
    the left-going bin mask ``[L, F, B]`` and the left sums.  The gain
    and the outputs use ``lambda_l2 + cat_l2``."""
    L, F, B = g.shape
    dev = g.device
    l1 = params.lambda_l1
    l2 = params.lambda_l2 + params.cat_l2
    min_d = params.min_data_in_leaf * 1.0
    min_h = params.min_sum_hessian_in_leaf + K_EPSILON
    min_score = torch.full((), K_MIN_SCORE, dtype=torch.float32, device=dev)
    tg3, th3, tc3 = tg[..., None], th[..., None], tc[..., None]  # [L, 1, 1]

    occupied = valid_bin & (c > 0)                                   # [L, F, B]

    # --- one-vs-rest: left = the single category k ----------------------
    oh_gain = _split_gain(g, h, tg3 - g, th3 - h, l1, l2)
    oh_ok = (occupied & (c >= min_d) & (tc3 - c >= min_d)
             & (h >= min_h) & (th3 - h >= min_h))
    oh_gain = torch.where(oh_ok, oh_gain, min_score)
    oh_best = torch.argmax(oh_gain, dim=-1)                          # [L, F]
    oh_best_gain = _take_last(oh_gain, oh_best)

    # --- many-vs-many: sort by grad / (hess + cat_smooth), scan both ends
    ratio = g / (h + params.cat_smooth)
    inf = torch.full((), float("inf"), dtype=torch.float32, device=dev)
    key = torch.where(occupied, ratio, inf)
    order = torch.argsort(sort_key(key), dim=-1, stable=True)
    sg = torch.gather(g, -1, order)
    sh = torch.gather(h, -1, order)
    sc = torch.gather(c, -1, order)
    occ_sorted = torch.gather(occupied, -1, order)
    n_occ = occupied.sum(-1, dtype=torch.int32)                      # [L, F]

    def direction(sg, sh, sc, occ):
        cs = prefix_sum(torch.stack([sg, sh, sc]))
        csg, csh, csc = cs[0], cs[1], cs[2]
        # count OCCUPIED categories in the prefix: the backward prefix
        # starts with the unoccupied inf-key slots
        k_occ = torch.cumsum(occ.to(torch.int32), dim=-1, dtype=torch.int32)
        mg = _split_gain(csg, csh, tg3 - csg, th3 - csh, l1, l2)
        okk = ((csc >= min_d) & (tc3 - csc >= min_d) & (csh >= min_h)
               & (th3 - csh >= min_h) & occ
               & (k_occ <= params.max_cat_threshold)
               & (k_occ < n_occ[..., None]))
        mg = torch.where(okk, mg, min_score)
        best_k = torch.argmax(mg, dim=-1)
        return (_take_last(mg, best_k), best_k, _take_last(csg, best_k),
                _take_last(csh, best_k), _take_last(csc, best_k))

    fw = direction(sg, sh, sc, occ_sorted)
    bw = direction(sg.flip(-1), sh.flip(-1), sc.flip(-1),
                   occ_sorted.flip(-1))
    use_bw = bw[0] > fw[0]
    mv_gain, mv_lg, mv_lh, mv_lc = (torch.where(use_bw, b, f) for b, f in
                                    zip(bw[:1] + bw[2:], fw[:1] + fw[2:]))

    # the winning direction's left bins over the original bin ids: each
    # bin's rank in the sort (the inverse permutation, by a scatter)
    pos = torch.empty_like(order).scatter_(
        -1, order, torch.arange(B, device=dev).expand(L, F, B))
    in_fw = pos <= fw[1][..., None]
    in_bw = (B - 1 - pos) <= bw[1][..., None]
    mv_mask = torch.where(use_bw[..., None], in_bw, in_fw) & occupied

    # --- one-hot below max_cat_to_onehot bins, else many-vs-many --------
    use_onehot = num_bins <= params.max_cat_to_onehot                # [L', F]
    bin_ids = torch.arange(B, device=dev)
    oh_mask = bin_ids[None, None, :] == oh_best[..., None]
    return (torch.where(use_onehot, oh_best_gain, mv_gain),
            torch.where(use_onehot[..., None], oh_mask, mv_mask),
            torch.where(use_onehot, _take_last(g, oh_best), mv_lg),
            torch.where(use_onehot, _take_last(h, oh_best), mv_lh),
            torch.where(use_onehot, _take_last(c, oh_best), mv_lc))
