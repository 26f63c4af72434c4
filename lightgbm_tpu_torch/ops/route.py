"""Row routing: the route (K2) and route-values (K4) kernels with their
plain versions.

Counterpart of the JAX package's ``ops/pallas_route.py``.  Per wave,
every row looks up its leaf's chosen split (group column, threshold,
default direction, EFB layout, missing metadata), reads its bin in that
column, and moves to the right child when it goes right.  Two leaf
vectors ride together in ``leaf2 [2, n_pad]`` int32: row 0 is the leaf of
every row, row 1 the hist leaf with bagged-out rows parked at -1;
padding rows are -1 in both.  The kernels are ``csrc/route.cu`` (one
thread per row, ``csrc/route_row.cuh``); the plain version mirrors the
reference's ``route_rows_xla``.

Every wrapper runs its kernel for CUDA tensors and its plain version for
CPU tensors; it counts kernel launches in ``.launches`` and plain calls
in ``.plain_calls``.  The bins are uint8, or int32 where a group holds
more than 256 bins (``io/device.py``); the int32 instantiations of K2
and K4 count into :data:`ROUTE_I32` and :data:`ROUTE_VALUES_I32`.
"""
from __future__ import annotations

import math

import torch

from ..io.binning import MISSING_NAN, MISSING_ZERO

# row order of the [ROUTE_TAB_ROWS, L] int32 table (csrc/route_row.cuh)
T_GROUP, T_THR, T_DL, T_ISCAT, T_SEL, T_NEWID = 0, 1, 2, 3, 4, 5
T_OFF, T_NB, T_DB, T_MT, T_NANB = 6, 7, 8, 9, 10
ROUTE_TAB_ROWS = 11
ROUTE_BLOCK = 512


class LaunchCount:
    """The launch and plain-call counts of a kernel instantiation that
    shares its wrapper with another."""

    def __init__(self, name: str):
        self.name = name
        self.launches = 0
        self.plain_calls = 0


ROUTE_I32 = LaunchCount("route_i32")
ROUTE_VALUES_I32 = LaunchCount("route_values_i32")


def leaf_tables(feature, threshold, default_left, is_categorical, cat_mask,
                sel, new_id, missing_types, nan_bins, default_bins,
                feat_group, feat_offset, num_bins):
    """Pack the per-leaf decision tables (tiny ``[L]`` gathers):
    -> ``(tabs [ROUTE_TAB_ROWS, L] int32, cat [L, Bcat] uint8)``."""
    f = feature.long()
    rows = [None] * ROUTE_TAB_ROWS
    rows[T_GROUP] = feat_group[f]
    rows[T_THR] = threshold
    rows[T_DL] = default_left
    rows[T_ISCAT] = is_categorical
    rows[T_SEL] = sel
    rows[T_NEWID] = new_id
    rows[T_OFF] = feat_offset[f]
    rows[T_NB] = num_bins[f]
    rows[T_DB] = default_bins[f]
    rows[T_MT] = missing_types[f]
    rows[T_NANB] = nan_bins[f]
    tabs = torch.stack([r.to(torch.int32) for r in rows]).contiguous()
    return tabs, cat_mask.to(torch.uint8).contiguous()


def unbundle_bin(col, off, nb, db):
    """EFB inverse mapping: stored column value -> feature bin
    (``io/dataset.py`` BundleInfo encoding; identity when ``off < 0``)."""
    rank = col - off
    in_range = (rank >= 0) & (rank < nb - 1)
    b_bundled = torch.where(in_range, rank + (rank >= db).to(rank.dtype),
                            db)
    return torch.where(off < 0, col, b_bundled)


def route_plain(bins_t, leaf2, tabs, cat_mask):
    """Plain version of the route kernel (the reference's
    ``route_rows_xla`` on the transposed bins): -> leaf2'."""
    rl = leaf2[0]
    hl = leaf2[1]
    safe = rl.clamp(min=0).long()
    t = tabs[:, safe]                                   # [ROWS, n_pad]
    g = t[T_GROUP].long()
    c = bins_t.gather(0, g[None, :])[0].int()
    db = t[T_DB]
    b = unbundle_bin(c, t[T_OFF], t[T_NB], db)
    mt = t[T_MT]
    is_missing = (((mt == MISSING_NAN) & (b == t[T_NANB]))
                  | ((mt == MISSING_ZERO) & (b == db)))
    num_left = torch.where(is_missing, t[T_DL] != 0, b <= t[T_THR])
    Bcat = cat_mask.shape[1]
    cat_left = (cat_mask[safe, b.clamp(0, Bcat - 1).long()] != 0) & (b < Bcat)
    go_left = torch.where(t[T_ISCAT] != 0, cat_left, num_left)
    moved = (t[T_SEL] != 0) & ~go_left & (rl >= 0)
    rl2 = torch.where(moved, t[T_NEWID], rl)
    hl2 = torch.where(hl >= 0, rl2, hl)
    return torch.stack([rl2, hl2])


def _check_route_inputs(bins_t, leaf2, tabs, cat_mask):
    from .histogram import _check
    dev = bins_t.device
    n_pad = bins_t.shape[1]
    L = tabs.shape[1]
    if bins_t.dtype not in (torch.uint8, torch.int32):
        raise TypeError(f"bins_t: expected uint8 or int32, got "
                        f"{bins_t.dtype}")
    _check(bins_t, "bins_t", bins_t.dtype)
    _check(leaf2, "leaf2", torch.int32, (2, n_pad), dev)
    _check(tabs, "tabs", torch.int32, (ROUTE_TAB_ROWS, L), dev)
    _check(cat_mask, "cat_mask", torch.uint8, (L, cat_mask.shape[1]), dev)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev, n_pad, L


def _route_grid(n_pad: int, dev) -> int:
    from .cuda_build import multiprocessor_count
    return max(1, min(math.ceil(n_pad / ROUTE_BLOCK),
                      4 * multiprocessor_count(dev)))


def route_entry(lib, bins_t, values: bool):
    """The C entry point of K2 (``values``: K4) in the ``route`` library
    for the bins' type: ``lgbm_route_rows[_values]`` on uint8 bins, its
    ``_i32`` instantiation on int32 bins (groups past 256 bins)."""
    name = "lgbm_route_rows_values" if values else "lgbm_route_rows"
    return getattr(lib, name + ("_i32" if bins_t.dtype == torch.int32
                                else ""))


def route_rows_raw(bins_t, leaf2, tabs, cat_mask):
    """Route kernel (K2): apply one wave's per-leaf tables to both leaf
    vectors -> leaf2' ``[2, n_pad]`` int32.  Rows whose leaf is
    unselected, bagged out or padding keep their leaves."""
    dev, n_pad, L = _check_route_inputs(bins_t, leaf2, tabs, cat_mask)
    wide = bins_t.dtype == torch.int32
    count = ROUTE_I32 if wide else route_rows_raw
    if dev.type == "cpu":
        count.plain_calls += 1
        return route_plain(bins_t, leaf2, tabs, cat_mask)
    from .cuda_build import check_launch, library
    out = torch.empty_like(leaf2)
    fn = route_entry(library("route"), bins_t, False)
    code = fn(bins_t.data_ptr(), n_pad, leaf2.data_ptr(), out.data_ptr(),
              tabs.data_ptr(), L, cat_mask.data_ptr(), cat_mask.shape[1],
              _route_grid(n_pad, dev), ROUTE_BLOCK,
              torch.cuda.current_stream(dev).cuda_stream)
    check_launch(code, "route_rows")
    count.launches += 1
    return out


route_rows_raw.launches = 0
route_rows_raw.plain_calls = 0


def route_values_plain(bins_t, leaf2, tabs, cat_mask, leaf_values):
    """Plain version of the route-values kernel: -> (leaf2', values)."""
    out = route_plain(bins_t, leaf2, tabs, cat_mask)
    rl = out[0]
    vals = torch.where(rl >= 0, leaf_values[rl.clamp(min=0).long()],
                       torch.zeros((), dtype=leaf_values.dtype,
                                   device=leaf_values.device))
    return out, vals


def route_rows_values_raw(bins_t, leaf2, tabs, cat_mask, leaf_values):
    """Route-values kernel (K4), the final route of a tree: apply the
    pending splits AND emit each row's post-route leaf value (0 for rows
    outside the tree) -> ``(leaf2' [2, n_pad] int32, values [n_pad]
    f32)``.  A direct float32 gather: bitwise ``leaf_values[leaf]``."""
    dev, n_pad, L = _check_route_inputs(bins_t, leaf2, tabs, cat_mask)
    from .histogram import _check
    _check(leaf_values, "leaf_values", torch.float32, (L,), dev)
    wide = bins_t.dtype == torch.int32
    count = ROUTE_VALUES_I32 if wide else route_rows_values_raw
    if dev.type == "cpu":
        count.plain_calls += 1
        return route_values_plain(bins_t, leaf2, tabs, cat_mask,
                                  leaf_values)
    from .cuda_build import check_launch, library
    out = torch.empty_like(leaf2)
    vals = torch.empty(n_pad, dtype=torch.float32, device=dev)
    fn = route_entry(library("route"), bins_t, True)
    code = fn(bins_t.data_ptr(), n_pad, leaf2.data_ptr(), out.data_ptr(),
              tabs.data_ptr(), L, cat_mask.data_ptr(), cat_mask.shape[1],
              leaf_values.data_ptr(), vals.data_ptr(),
              _route_grid(n_pad, dev), ROUTE_BLOCK,
              torch.cuda.current_stream(dev).cuda_stream)
    check_launch(code, "route_rows_values")
    count.launches += 1
    return out, vals


route_rows_values_raw.launches = 0
route_rows_values_raw.plain_calls = 0


def route_rows(bins_t, leaf2, feature, threshold, default_left,
               is_categorical, cat_mask, sel, new_id, missing_types,
               nan_bins, default_bins, feat_group, feat_offset, num_bins):
    """Apply this wave's splits to both leaf vectors (the reference's
    ``route_rows_pallas`` contract): -> ``[2, n_pad]``."""
    tabs, cat = leaf_tables(feature, threshold, default_left,
                            is_categorical, cat_mask, sel, new_id,
                            missing_types, nan_bins, default_bins,
                            feat_group, feat_offset, num_bins)
    return route_rows_raw(bins_t, leaf2, tabs, cat)


def route_rows_values(bins_t, leaf2, feature, threshold, default_left,
                      is_categorical, cat_mask, sel, new_id, missing_types,
                      nan_bins, default_bins, feat_group, feat_offset,
                      num_bins, leaf_values):
    """Final per-tree route (the reference's
    ``route_rows_values_pallas`` contract): -> ``(leaf2, values)``."""
    tabs, cat = leaf_tables(feature, threshold, default_left,
                            is_categorical, cat_mask, sel, new_id,
                            missing_types, nan_bins, default_bins,
                            feat_group, feat_offset, num_bins)
    return route_rows_values_raw(bins_t, leaf2, tabs, cat,
                                 leaf_values.float().contiguous())
