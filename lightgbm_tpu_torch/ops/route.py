"""Row routing: the route (K2) and route-values (K4) kernels with their
plain versions.

Counterpart of the JAX package's ``ops/pallas_route.py``.  Per wave,
every row looks up its leaf's chosen split (group column, threshold,
default direction, EFB layout, missing metadata), reads its bin in that
column, and moves to the right child when it goes right.  Two leaf
vectors ride together in ``leaf2 [2, n_pad]`` int32: row 0 is the leaf of
every row, row 1 the hist leaf with bagged-out rows parked at -1;
padding rows are -1 in both.  The kernels are ``csrc/route.cu`` (a
selection bit, then one 32-byte record per row of a split leaf, staged in
shared memory by a persistent grid or, past what shared memory holds,
packed once into scratch; ``csrc/route_row.cuh``); the plain version
mirrors the reference's ``route_rows_xla``.

Every wrapper runs its kernel for CUDA tensors and its plain version for
CPU tensors; it counts kernel launches in ``.launches`` and plain calls
in ``.plain_calls``.  The bins are uint8, or int32 where a group holds
more than 256 bins (``io/device.py``); the int32 instantiations of K2
and K4 count into :data:`ROUTE_I32` and :data:`ROUTE_VALUES_I32`.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ..io.binning import MISSING_NAN, MISSING_ZERO

# row order of the [ROUTE_TAB_ROWS, L] int32 table (csrc/route_row.cuh)
T_GROUP, T_THR, T_DL, T_ISCAT, T_SEL, T_NEWID = 0, 1, 2, 3, 4, 5
T_OFF, T_NB, T_DB, T_MT, T_NANB = 6, 7, 8, 9, 10
ROUTE_TAB_ROWS = 11


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


# flags of a leaf record (csrc/route_row.cuh REC_*)
REC_CAT, REC_DEFAULT_LEFT, REC_MT_SHIFT = 1, 2, 2


def route_records(tabs):
    """Plain form of the per-leaf layout K2 and K4 route by
    (``csrc/route_row.cuh`` ``RecordLeaf``): -> ``(records [L, 8] int32,
    sel_bits [ceil(L / 32)] int32)``.  A record holds the leaf's group,
    threshold, right child, flags, EFB offset, bin count, default bin
    and NaN bin, each at full width; the flags hold the categorical and
    default-left bits and, from bit ``REC_MT_SHIFT``, the missing type
    (NaN or zero; any other value as 0).  Leaf ``i`` is bit ``i % 32`` of
    word ``i // 32`` of the selection map.  The kernels write the records
    of selected leaves only (the others are never read); here those rows
    are 0."""
    L = tabs.shape[1]
    mt = tabs[T_MT]
    kind = torch.where((mt == MISSING_NAN) | (mt == MISSING_ZERO), mt, 0)
    flags = (torch.where(tabs[T_ISCAT] != 0, REC_CAT, 0)
             | torch.where(tabs[T_DL] != 0, REC_DEFAULT_LEFT, 0)
             | (kind << REC_MT_SHIFT))
    rec = torch.stack([tabs[T_GROUP], tabs[T_THR], tabs[T_NEWID], flags,
                       tabs[T_OFF], tabs[T_NB], tabs[T_DB], tabs[T_NANB]], 1)
    sel = tabs[T_SEL] != 0
    rec = torch.where(sel[:, None], rec, 0).to(torch.int32)
    W = -(-L // 32)
    bits = torch.zeros(W * 32, dtype=torch.int64, device=tabs.device)
    bits[:L] = sel.long()
    words = (bits.view(W, 32) << torch.arange(32, device=tabs.device)).sum(1)
    words = torch.where(words >= 2 ** 31, words - 2 ** 32, words)
    return rec, words.to(torch.int32)


def route_by_records(bins_t, leaf2, records, sel_bits, cat_mask):
    """Plain form of K2's per-row route over :func:`route_records`' layout
    (a selection bit, then one record per row of a split leaf): ->
    leaf2'; equal to :func:`route_plain`."""
    rl, hl = leaf2[0], leaf2[1]
    safe = rl.clamp(min=0).long()
    moves = (rl >= 0) & (((sel_bits.long()[safe >> 5] >> (safe & 31)) & 1)
                         != 0)
    r = records[safe].t()                               # [8, n_pad]
    c = bins_t.gather(0, r[0].long()[None, :])[0].int()
    db = r[6]
    b = unbundle_bin(c, r[4], r[5], db)
    mt = r[3] >> REC_MT_SHIFT
    missing = (((mt == MISSING_NAN) & (b == r[7]))
               | ((mt == MISSING_ZERO) & (b == db)))
    num_left = torch.where(missing, (r[3] & REC_DEFAULT_LEFT) != 0, b <= r[1])
    Bcat = cat_mask.shape[1]
    cat_left = (cat_mask[safe, b.clamp(0, Bcat - 1).long()] != 0) & (b < Bcat)
    go_left = torch.where((r[3] & REC_CAT) != 0, cat_left, num_left)
    rl2 = torch.where(moves & ~go_left, r[2], rl)
    return torch.stack([rl2, torch.where(hl >= 0, rl2, hl)])


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


class RoutePlan(NamedTuple):
    """How K2/K4 launch at one table size (``csrc/route.cu``)."""
    scratch_bytes: int      # 0: the tables stage in shared memory
    threads: int            # a block
    max_grid: int           # blocks resident at once on the device


_PLANS = {}


def route_plan(lib, dev, L: int, values: bool, i32: bool) -> RoutePlan:
    """K2's (``values``: K4's) launch plan at ``L`` leaves on ``dev``, as
    the ``route`` library ``lib`` reports it; kept per library, device
    and shape."""
    key = (id(lib), dev.index, L, values, i32)
    plan = _PLANS.get(key)
    if plan is None:
        from .cuda_build import check_launch, multiprocessor_count
        out = (ctypes.c_int * 3)()
        with torch.cuda.device(dev):
            check_launch(lib.lgbm_route_plan(L, int(values), int(i32), out),
                         "route plan")
        plan = _PLANS[key] = RoutePlan(
            out[1], out[2], max(1, out[0]) * multiprocessor_count(dev))
    return plan


def route_grid(n_pad: int, plan: RoutePlan) -> int:
    """Blocks of a route launch: one a block's worth of rows, at most
    those resident at once (the grid is persistent, each thread then
    takes several rows)."""
    return max(1, min(-(-n_pad // plan.threads), plan.max_grid))


def route_entry(lib, bins_t, values: bool):
    """The C entry point of K2 (``values``: K4) in the ``route`` library
    for the bins' type: ``lgbm_route_rows[_values]`` on uint8 bins, its
    ``_i32`` instantiation on int32 bins (groups past 256 bins)."""
    name = "lgbm_route_rows_values" if values else "lgbm_route_rows"
    return getattr(lib, name + ("_i32" if bins_t.dtype == torch.int32
                                else ""))


def route_launch(bins_t, leaf2, out, tabs, cat_mask, leaf_values=None,
                 values_out=None, scratch=None, lib=None) -> int:
    """Launch K2 into ``out`` (with ``leaf_values``: K4, also into
    ``values_out``) on the current stream, with the scratch the plan asks
    for allocated here unless ``scratch`` is given, through ``lib`` (by
    default the loaded ``route`` library): -> the CUDA error code (0:
    launched).  What the wrappers, the smoke and the A/B time."""
    if lib is None:
        from .cuda_build import library
        lib = library("route")
    dev = bins_t.device
    n_pad, L = bins_t.shape[1], tabs.shape[1]
    values = leaf_values is not None
    plan = route_plan(lib, dev, L, values, bins_t.dtype == torch.int32)
    if scratch is None and plan.scratch_bytes:
        scratch = torch.empty(plan.scratch_bytes, dtype=torch.uint8,
                              device=dev)
    extra = (leaf_values.data_ptr(), values_out.data_ptr()) if values else ()
    return route_entry(lib, bins_t, values)(
        bins_t.data_ptr(), n_pad, leaf2.data_ptr(), out.data_ptr(),
        tabs.data_ptr(), L, cat_mask.data_ptr(), cat_mask.shape[1], *extra,
        None if scratch is None else scratch.data_ptr(),
        route_grid(n_pad, plan), plan.threads,
        torch.cuda.current_stream(dev).cuda_stream)


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
    from .cuda_build import check_launch
    out = torch.empty_like(leaf2)
    check_launch(route_launch(bins_t, leaf2, out, tabs, cat_mask),
                 "route_rows")
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
    from .cuda_build import check_launch
    out = torch.empty_like(leaf2)
    vals = torch.empty(n_pad, dtype=torch.float32, device=dev)
    check_launch(route_launch(bins_t, leaf2, out, tabs, cat_mask,
                              leaf_values, vals), "route_rows_values")
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
