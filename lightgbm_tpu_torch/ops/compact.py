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

from .histogram import (_check_active_inputs, _check_vector_rows,
                        bin_stride, dequant_hist, hist_launcher, hist_plain,
                        hist_plan, hist_slab, slot_tables)

# leaf slots per group in the reference's compacted kernel; waves wider
# than this take K3 (the reference's dispatch threshold)
COMPACT_GROUP = 32


def compact_slot_threshold() -> int:
    return COMPACT_GROUP


def hist_compact_raw(bins_t, vals, hist_leaf, active, num_leaf_slots: int,
                     max_bins: int, acc=None):
    """Leaf-compacted histogram kernel (K3) over the routed hist leaves
    ``hist_leaf [n_pad]`` int32: adds into the carry ``acc`` (``[A, G, B,
    C]`` int32; zeros when None) in place and returns it.  A streamed
    fold chains per-block calls through one carry; int32 sums make the
    chain bitwise one call over all rows."""
    B = bin_stride(max_bins)
    acc = _check_active_inputs(bins_t, vals, hist_leaf, active, acc, B,
                               torch.int8, torch.int32)
    G, n_pad = bins_t.shape
    C, A, L = vals.shape[0], active.shape[0], num_leaf_slots
    dev = bins_t.device
    inv, src = slot_tables(active, L, collect_unbagged=False)
    if dev.type == "cpu":
        hist_compact_raw.plain_calls += 1
        return acc.add_(hist_plain(bins_t, vals, hist_leaf, inv, src, B))
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    from .cuda_build import check_launch, multiprocessor_count
    _check_vector_rows(n_pad, bins_t, vals, hist_leaf, acc)
    plan = hist_plan(n_pad, G, A, B, C, multiprocessor_count(dev), L, False)
    code = hist_launcher("hist_compact", bins_t, vals, hist_leaf, inv, src,
                         L, B, plan, hist_slab(plan, A, G, B, C, dev), acc)()
    check_launch(code, "hist_compact")
    hist_compact_raw.launches += 1
    return acc


hist_compact_raw.launches = 0
hist_compact_raw.plain_calls = 0


def hist_active_compact(bins_t, vals, hist_leaf, active, scales, *,
                        num_leaf_slots: int, max_bins: int, mode: str):
    """Leaf-compacted active-leaf histograms (the reference's
    ``hist_active_compact`` contract): -> ``[A, G, B, 3]`` f32."""
    raw = hist_compact_raw(bins_t, vals, hist_leaf, active, num_leaf_slots,
                           max_bins)
    return dequant_hist(raw, scales, mode)
