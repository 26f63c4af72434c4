"""Leaf-compacted histograms for deep waves (K3) and their plain version.

Counterpart of the JAX package's ``ops/compact.py``.  Waves with more
active slots than :func:`compact_slot_threshold` take this kernel after
the route kernel has applied the wave's pending splits.  On the TPU the
reference regroups rows into 32-slot leaf groups (a stable sort plus a
gather) so that each MXU pass contracts 32 columns instead of all of
them; on Hopper the per-row cost of the atomic histogram
(``csrc/hist_compact.cu``) does not depend on the slot count, so rows
stay in dataset order (see the note in the source).  The contract is the
reference's: ``[A, G, B, 3]`` sums per active slot, with exact zeros in
``-1`` slots and nothing from rows whose leaf is not active.
"""
from __future__ import annotations

import torch

from .histogram import (HIST_BLOCK, _check, bin_stride, dequant_hist,
                        hist_launch_shape, hist_plain, slot_tables)

# leaf slots per group in the reference's compacted kernel; waves wider
# than this take K3 (the reference's dispatch threshold)
COMPACT_GROUP = 32


def compact_slot_threshold() -> int:
    return COMPACT_GROUP


def hist_compact_raw(bins_t, vals, hist_leaf, active, num_leaf_slots: int,
                     max_bins: int):
    """Leaf-compacted histogram kernel (K3) over the routed hist leaves
    ``hist_leaf [n_pad]`` int32: -> ``[A, G, B, C]`` int32."""
    G, n_pad = bins_t.shape
    C = vals.shape[0]
    A = active.shape[0]
    L = num_leaf_slots
    B = bin_stride(max_bins)
    dev = bins_t.device
    _check(bins_t, "bins_t", torch.uint8)
    _check(vals, "vals", torch.int8, (C, n_pad), dev)
    _check(hist_leaf, "hist_leaf", torch.int32, (n_pad,), dev)
    _check(active, "active", torch.int32, (A,), dev)
    if not 1 <= C <= 5:
        raise ValueError(f"vals: {C} value columns, the kernel takes 1-5")
    inv, src = slot_tables(active, L, collect_unbagged=False)
    if dev.type == "cpu":
        hist_compact_raw.plain_calls += 1
        return hist_plain(bins_t, vals, hist_leaf, inv, src, B)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    from .cuda_build import check_launch, library, multiprocessor_count
    lib = library("hist_compact")
    out = torch.zeros((A, G, B, C), dtype=torch.int32, device=dev)
    As, Ft, gx, rpb = hist_launch_shape(n_pad, G, A, B, C,
                                        multiprocessor_count(dev))
    code = lib.lgbm_hist_compact(
        bins_t.data_ptr(), n_pad, G, vals.data_ptr(), C,
        hist_leaf.data_ptr(), L, inv.data_ptr(), src.data_ptr(), A, B, Ft,
        As, gx, rpb, HIST_BLOCK, out.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    check_launch(code, "hist_compact")
    hist_compact_raw.launches += 1
    return out


hist_compact_raw.launches = 0
hist_compact_raw.plain_calls = 0


def hist_active_compact(bins_t, vals, hist_leaf, active, scales, *,
                        num_leaf_slots: int, max_bins: int, mode: str):
    """Leaf-compacted active-leaf histograms (the reference's
    ``hist_active_compact`` contract): -> ``[A, G, B, 3]`` f32."""
    raw = hist_compact_raw(bins_t, vals, hist_leaf, active, num_leaf_slots,
                           max_bins)
    return dequant_hist(raw, scales, mode)
