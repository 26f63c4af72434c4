"""Leaf-compacted histograms for deep waves (K3) and their plain versions.

Counterpart of the JAX package's ``ops/compact.py``.  Waves with more
active slots than :func:`compact_slot_threshold` take this kernel after
the route kernel has applied the wave's pending splits.  On the TPU the
reference regroups rows into 32-slot leaf groups (a stable sort plus a
gather) so that each MXU pass contracts 32 columns instead of all of
them.  On Hopper the per-row cost of the int32 atomic histogram
(``csrc/hist_compact.cu``) does not depend on the slot count, so on the
quantized modes rows stay in dataset order (see the note in the
source).  On the float modes (``csrc/hist_compact_float.cu``) the rows
are sorted by slot on the card, stably, and each slot's rows are summed
in the float K5's fixed order (``ops/histogram.py:FLOAT_CHUNK``), so a
call is bitwise the float K5 on its non-negative slots
(``csrc/hist_float_walk.cuh`` holds the design).  The contract is
the reference's: ``[A, G, B, 3]`` sums per active slot, with exact zeros
in ``-1`` slots and nothing from rows whose leaf is not active.
"""
from __future__ import annotations

import torch

from .histogram import (FloatWalkScratch, _check_active_inputs,
                        _check_vector_rows, bin_stride, combine_hist_cols,
                        float_walk_launches, float_walk_plan,
                        hist_float_plain, hist_launcher, hist_plain,
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


def hist_compact_float_raw(bins_t, vals, hist_leaf, active,
                           num_leaf_slots: int, max_bins: int, acc=None):
    """Leaf-compacted histogram kernel (K3) on float value rows
    (:func:`ops.histogram.pack_values`) over the routed hist leaves
    ``hist_leaf [n_pad]`` int32: adds the float32 sums of the
    bf16-rounded values into the carry ``acc`` (``[A, G, B, C]`` f32;
    zeros when None) in place and returns it.

    The float K5's order, so the non-negative slots are bitwise
    :func:`ops.histogram.hist_active_float_raw`'s; -1 slots get nothing
    (exact zeros from a zero carry) and rows of inactive leaves add
    nothing.  The CUDA kernel (``csrc/hist_compact_float.cu``, the design
    of ``csrc/hist_float_walk.cuh``) sorts the rows by slot on the card;
    it runs over windows of ``FLOAT_WINDOW`` rows chained through the
    carry and counts one launch per window."""
    B = bin_stride(max_bins)
    acc = _check_active_inputs(bins_t, vals, hist_leaf, active, acc, B,
                               torch.float32, torch.float32)
    G, n_pad = bins_t.shape
    C, A, L = vals.shape[0], active.shape[0], num_leaf_slots
    dev = bins_t.device
    inv, src = slot_tables(active, L, collect_unbagged=False)
    if dev.type == "cpu":
        hist_compact_float_raw.plain_calls += 1
        return hist_float_plain(bins_t, vals, hist_leaf, inv, src, B, acc)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    from .cuda_build import check_launch, multiprocessor_count
    _check_vector_rows(n_pad, bins_t, vals, hist_leaf, acc)
    plan = float_walk_plan(n_pad, A, G, B, C, L, multiprocessor_count(dev))
    scratch = FloatWalkScratch.empty(plan, A, G, B, C, dev)
    for launch in float_walk_launches(bins_t, vals, hist_leaf, inv, src, L,
                                      B, plan, scratch, acc):
        check_launch(launch(), "hist_compact_float")
        hist_compact_float_raw.launches += 1
    return acc


hist_compact_float_raw.launches = 0
hist_compact_float_raw.plain_calls = 0


def hist_active_compact(bins_t, vals, hist_leaf, active, scales, *,
                        num_leaf_slots: int, max_bins: int, mode: str):
    """Leaf-compacted active-leaf histograms (the reference's
    ``hist_active_compact`` contract): -> ``[A, G, B, 3]`` f32.  Int8
    ``vals`` take the int32 K3 and are dequantized with ``scales``;
    float32 ``vals`` take the float K3 (``scales`` is None)."""
    kernel = (hist_compact_float_raw if vals.dtype == torch.float32
              else hist_compact_raw)
    raw = kernel(bins_t, vals, hist_leaf, active, num_leaf_slots, max_bins)
    return combine_hist_cols(raw, mode, scales)
