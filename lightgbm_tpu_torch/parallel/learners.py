"""Distributed tree learners: data-, feature- and voting-parallel.

Port of the JAX package's ``parallel/learners.py`` (reference
``feature_parallel_tree_learner.cpp``, ``data_parallel_tree_learner.cpp``,
``voting_parallel_tree_learner.cpp``; the shared sync helpers of
``parallel_tree_learner.h:184-207``).  The JAX package runs each
strategy as a wave closure inside one ``shard_map``; here each rank is a
process that runs the same wave closure on its own rows or columns, and
the collectives are ``torch.distributed`` calls through the group's
``MeshContext`` (NCCL or gloo):

* **data-parallel** — rows split over the ranks; each wave's local
  active-leaf histograms are summed over the ranks (one all-reduce of
  the wave's ``[A, G, B, 3]`` block, issued as overlapped column chunks
  by default, ``ops/overlap.py``), then every rank subtracts siblings
  and scans the same sums;
* **feature-parallel** — rows replicated, an equal static column slice
  per rank (``feature_parallel_tree_learner.cpp:31-50``); each rank
  keeps histogram state for its own columns only, and the ranks' best
  splits are gathered and the best by gain taken everywhere (first
  rank on a tie, the ``SyncUpGlobalBestSplit`` reducer);
* **voting-parallel (PV-Tree)** — rows split; each rank votes its top-k
  features per changed leaf by local gain, the ``(feature, gain)`` votes
  are gathered and the 2k winners by summed gain selected, and only the
  winners' histogram columns are summed over the ranks before the final
  scan (``voting_parallel_tree_learner.cpp:164-193``).

Every rank builds the same tree (the reference's distributed-determinism
requirement, ``application.cpp:249-254``): the all-reduce gives every
rank the same bits, and every rank takes the same decisions from them.
Each collective site records its fingerprint into the flight recorder
(``obs/flight_recorder.py``) before it is issued, under the JAX
package's site names.

A data-parallel rank quantizes its own rows with its own scales (the
reference's shard does, ``ops/pallas_histogram.py:243-246``) and what is
summed is the unpacked f32 histogram, so a data-parallel int8h model is
not the serial one; at two ranks it is the reference's 2-device mesh
model bit for bit.
"""
from __future__ import annotations

from dataclasses import fields, replace
from typing import Optional

import torch

from ..io.device import DeviceData
from ..learner.serial import (BuiltTree, GrowthParams, apply_hist_wave,
                              build_tree, make_hist_fn, tree_phase)
from ..obs import span as obs_span
from ..obs.flight_recorder import record as _fr_record
from ..ops.histogram import bin_stride, unbundle_grid
from ..ops.split import (K_MIN_SCORE, SplitParams, SplitResult, _split_gain,
                         find_best_splits, leaf_split_gain, prefix_sum,
                         split_scan_chunk_features)


def _psum(comm):
    """The histogram (and root-statistics) sum over the ranks: a tensor,
    or a tuple of scalars summed as one stacked all-reduce."""
    def psum_fn(x):
        _fr_record("parallel.learners.hist_psum", "psum", comm.data_axis, x)
        if isinstance(x, tuple):
            t = torch.stack([torch.as_tensor(v, dtype=torch.float32,
                                             device=comm.device)
                             for v in x])
            comm.all_reduce_sum(t)
            return tuple(t.unbind())
        t = x.contiguous()
        comm.all_reduce_sum(t)
        return t
    return psum_fn


# the SplitResult fields gathered by _sync_global_best, in order, as
# float32 columns (int and bool fields are exact there)
_SPLIT_FIELDS = [f.name for f in fields(SplitResult)]


def _sync_global_best(best: SplitResult, comm) -> SplitResult:
    """All-gather every rank's per-leaf best splits and keep the one of
    greatest gain, the first rank on a tie (``SyncUpGlobalBestSplit``,
    ``parallel_tree_learner.h:184-207``).  The fields travel as one
    ``[2A, 14 + B - 1]`` f32 block; gains and sums keep their bits."""
    _fr_record("parallel.learners.sync_global_best", "all_gather",
               comm.data_axis, best.gain)
    cols = []
    for name in _SPLIT_FIELDS:
        v = getattr(best, name)
        cols.append(v.float() if v.dim() == 2 else v.float()[:, None])
    packed = torch.cat(cols, dim=1)
    with obs_span("collective.sync_global_best"):
        g = comm.all_gather(packed)                        # [W, 2A, C]
    win = torch.argmax(g[:, :, 0], dim=0)                  # [2A]
    pick = g[win, torch.arange(g.shape[1], device=g.device)]
    out = {}
    j = 0
    for name in _SPLIT_FIELDS:
        ref = getattr(best, name)
        w = ref.shape[1] if ref.dim() == 2 else 1
        v = pick[:, j:j + w]
        out[name] = (v if ref.dim() == 2 else v[:, 0]).to(ref.dtype)
        j += w
    return SplitResult(**out)


# ---------------------------------------------------------------------------
# feature-parallel
# ---------------------------------------------------------------------------
def feature_slice(F: int, rank: int, world: int):
    """``(start, f_local)``: this rank's static column slice (an equal
    ``ceil(F / world)`` each, the last one clamped to end at ``F``)."""
    f_local = -(-F // world)
    return min(rank * f_local, F - f_local), f_local


def make_feature_parallel_strategy(data: DeviceData, grad, hess,
                                   params: GrowthParams, feature_mask, comm,
                                   hist_mode=None):
    """Features statically sliced per rank; the rank's histogram state
    covers its own columns; the best split by ``all_gather`` + argmax.
    EFB composes: features are sliced in logical order and a rank
    histograms its features' group columns, each feature its own copy.
    Returns ``(wave, f_local)``."""
    F = data.num_features
    L = params.num_leaves
    start, f_local = feature_slice(F, comm.rank, comm.world)
    sl = slice(start, start + f_local)
    dev = data.device
    if data.is_bundled:
        bins_loc = data.bins_t[data.feat_group[sl].long()].contiguous()
        off_loc = data.feat_offset[sl]
    else:
        bins_loc = data.bins_t[sl].contiguous()
        off_loc = torch.full((f_local,), -1, dtype=torch.int32, device=dev)
    nb_loc = data.num_bins[sl]
    db_loc = data.default_bins[sl]
    mt_loc = data.missing_types[sl]
    ic_loc = data.is_categorical[sl]
    data_loc = replace(
        data, bins_t=bins_loc,
        bin_offsets=torch.zeros(f_local, dtype=torch.int32, device=dev),
        num_bins=nb_loc, default_bins=db_loc, missing_types=mt_loc,
        is_categorical=ic_loc, nan_bins=data.nan_bins[sl],
        feat_group=torch.arange(f_local, dtype=torch.int32, device=dev),
        feat_offset=off_loc, is_bundled=False)
    hist_fn = make_hist_fn(data_loc, grad, hess, L, hist_mode)
    # the end-clamped last slice repeats columns of the previous rank's
    owned = (start + torch.arange(f_local, device=dev)) >= comm.rank * f_local
    fmask = owned if feature_mask is None else owned & feature_mask[sl]
    B = bin_stride(data.max_bins)

    def wave(s, hist_leaf):
        with tree_phase("tree.hist", data.device):
            new_h = hist_fn(hist_leaf, s.act_small)
            ids, grid = apply_hist_wave(s.hist_state, new_h, s.act_small,
                                        s.act_parent, s.act_sibling, L)
        with tree_phase("tree.split_find", data.device):
            safe = ids.clamp(0, L - 1).long()
            lsg, lsh, lc = (s.leaf_sum_grad[safe], s.leaf_sum_hess[safe],
                            s.leaf_count[safe])
            if data.is_bundled:
                grid = unbundle_grid(
                    grid, lsg, lsh, lc,
                    torch.arange(f_local, dtype=torch.int32, device=dev),
                    off_loc, nb_loc, db_loc, B)
            fc = split_scan_chunk_features(grid.shape[0], f_local,
                                           grid.shape[2], data.has_missing)
            best = find_best_splits(grid, lsg, lsh, lc, nb_loc, mt_loc,
                                    db_loc, params.split, fmask,
                                    any_missing=data.has_missing,
                                    feature_chunk=fc,
                                    is_categorical=ic_loc,
                                    any_categorical=data.has_categorical)
            best = best.replace(feature=(best.feature + start).to(
                torch.int32))
            return ids, _sync_global_best(best, comm)

    return wave, f_local


# ---------------------------------------------------------------------------
# voting-parallel (PV-Tree)
# ---------------------------------------------------------------------------
def top_k_stable(x: torch.Tensor, k: int):
    """``(values, indices)`` of the ``k`` largest along the last axis, the
    lower index first among equals (``jax.lax.top_k``'s order)."""
    v, i = torch.sort(x, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


def make_voting_parallel_strategy(data: DeviceData, grad, hess,
                                  params: GrowthParams, feature_mask, comm,
                                  top_k: int, hist_mode=None):
    """PV-Tree: local active-leaf histograms -> local vote -> global 2k
    winners -> the winners' columns summed over the ranks -> final scan
    (the reference's ``make_voting_parallel_strategy``)."""
    F = data.num_features
    L = params.num_leaves
    k2 = min(2 * top_k, F)
    kk = min(top_k, F)
    W = comm.world
    hist_fn = make_hist_fn(data, grad, hess, L, hist_mode)
    # local constraints scaled 1/W (voting_parallel_tree_learner.cpp:55-56)
    local_params = params.split._replace(
        min_data_in_leaf=max(1, params.split.min_data_in_leaf // W),
        min_sum_hessian_in_leaf=params.split.min_sum_hessian_in_leaf / W)
    B = bin_stride(data.max_bins)

    def wave(s, hist_leaf):
        with tree_phase("tree.hist", data.device):
            new_h = hist_fn(hist_leaf, s.act_small)
            ids, grid = apply_hist_wave(s.hist_state, new_h, s.act_small,
                                        s.act_parent, s.act_sibling, L)
        with tree_phase("tree.split_find", data.device):
            safe = ids.clamp(0, L - 1).long()
            # local leaf totals: column 0's bins hold every in-bag local
            # row once
            loc_sum_g = grid[:, 0, :, 0].sum(-1)
            loc_sum_h = grid[:, 0, :, 1].sum(-1)
            loc_cnt = grid[:, 0, :, 2].sum(-1)
            if data.is_bundled:
                grid = unbundle_grid(grid, loc_sum_g, loc_sum_h, loc_cnt,
                                     data.feat_group, data.feat_offset,
                                     data.num_bins, data.default_bins, B)
            local_gain = per_feature_gains(grid, loc_sum_g, loc_sum_h,
                                           loc_cnt, data.num_bins,
                                           local_params, feature_mask)
            local_vals, local_top = top_k_stable(local_gain, kk)
            local_vals = torch.where(
                torch.isfinite(local_vals) & (local_vals > K_MIN_SCORE / 2),
                local_vals, torch.zeros_like(local_vals))
            _fr_record("parallel.learners.voting.vote_gather", "all_gather",
                       comm.data_axis, local_top.to(torch.int32))
            _fr_record("parallel.learners.voting.vote_gather", "all_gather",
                       comm.data_axis, local_vals)
            with obs_span("collective.vote_gather"):
                g_top = comm.all_gather(local_top)          # [W, 2A, k]
                g_val = comm.all_gather(local_vals)
            # the weighted-gain vote tally, scattered locally in rank
            # order (each (leaf, feature) takes at most one vote a rank)
            votes = torch.zeros_like(local_gain)
            for r in range(W):
                votes.scatter_add_(1, g_top[r], g_val[r])
            _, sel = top_k_stable(votes, k2)                 # [2A, k2]
            sel_grid = torch.gather(
                grid, 1, sel[:, :, None, None].expand(
                    -1, -1, grid.shape[2], grid.shape[3])).contiguous()
            _fr_record("parallel.learners.voting.sel_psum", "psum",
                       comm.data_axis, sel_grid)
            with obs_span("collective.sel_psum"):
                comm.all_reduce_sum(sel_grid)
            best = find_best_splits(
                sel_grid, s.leaf_sum_grad[safe], s.leaf_sum_hess[safe],
                s.leaf_count[safe], data.num_bins[sel],
                data.missing_types[sel], data.default_bins[sel],
                params.split, None, any_missing=data.has_missing,
                is_categorical=data.is_categorical[sel],
                any_categorical=data.has_categorical)
            gfeat = torch.gather(sel, 1, best.feature.long()[:, None])[:, 0]
            return ids, best.replace(feature=gfeat.to(torch.int32))

    return wave


def per_feature_gains(grid, lsg, lsh, lc, num_bins, sp: SplitParams,
                      feature_mask):
    """Best gain per (changed leaf, feature): the voting criterion, a
    simplified numerical scan with missing values right (votes only rank
    features; the exact scan runs on the merged winners)."""
    cl = prefix_sum(torch.stack([grid[..., 0], grid[..., 1],
                                 grid[..., 2]]))
    clg, clh, clc = cl[0], cl[1], cl[2]
    tg = lsg[:, None, None]
    th = lsh[:, None, None]
    tc = lc[:, None, None]
    gains = _split_gain(clg, clh, tg - clg, th - clh, sp.lambda_l1,
                        sp.lambda_l2)
    ok = ((clc >= sp.min_data_in_leaf) & (tc - clc >= sp.min_data_in_leaf)
          & (clh >= sp.min_sum_hessian_in_leaf)
          & (th - clh >= sp.min_sum_hessian_in_leaf))
    bin_ids = torch.arange(grid.shape[2], device=grid.device)
    ok &= bin_ids[None, None, :] < (num_bins - 1)[None, :, None]
    min_score = torch.full((), K_MIN_SCORE, dtype=torch.float32,
                           device=grid.device)
    per_feat = torch.where(ok, gains, min_score).max(dim=-1).values
    per_feat = per_feat - leaf_split_gain(lsg, lsh, sp.lambda_l1,
                                          sp.lambda_l2)[:, None]
    if feature_mask is not None:
        per_feat = torch.where(feature_mask[None, :], per_feat, min_score)
    return per_feat


# ---------------------------------------------------------------------------
# the per-rank build
# ---------------------------------------------------------------------------
def build_tree_distributed(comm, learner_type: str, data: DeviceData,
                           grad, hess, params: GrowthParams,
                           bag_mask=None, feature_mask=None,
                           top_k: int = 20, hist_mode=None,
                           overlap: Optional[bool] = None) -> BuiltTree:
    """Grow this rank's copy of one tree of a distributed build (the
    reference's ``build_tree_distributed``; ``comm`` is the group's
    ``MeshContext``).  Data/voting: ``data``, ``grad``, ``hess`` and
    ``bag_mask`` are this rank's rows; feature: every rank holds every
    row.  The tree fields come out identical on every rank; ``row_leaf``
    and ``row_value`` cover the rank's rows.

    ``overlap`` (data-parallel only; default ``LGBM_TPU_OVERLAP``, off)
    issues each wave's histogram sum as the overlapped chunked
    reduction of ``ops/overlap.py``, bitwise the plain one."""
    from ..ops.overlap import overlap_enabled
    if overlap is None:
        overlap = overlap_enabled()
    num_hist_features = None
    psum_axis = None
    if learner_type == "data":
        strategy = None
        psum_fn = _psum(comm)
        if overlap:
            psum_axis = comm
    elif learner_type == "feature":
        strategy, num_hist_features = make_feature_parallel_strategy(
            data, grad, hess, params, feature_mask, comm, hist_mode)
        psum_fn = None
    elif learner_type == "voting":
        strategy = make_voting_parallel_strategy(
            data, grad, hess, params, feature_mask, comm, top_k, hist_mode)
        psum_fn = _psum(comm)
    else:
        raise ValueError(learner_type)
    return build_tree(data, grad, hess, params, bag_mask=bag_mask,
                      feature_mask=feature_mask, hist_mode=hist_mode,
                      strategy=strategy, psum_fn=psum_fn,
                      psum_axis=psum_axis,
                      num_hist_features=num_hist_features)
