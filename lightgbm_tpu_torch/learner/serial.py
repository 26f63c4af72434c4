"""Serial tree learner — staged wave growth on one device.

Port of the JAX package's ``learner/serial.py`` (reference
``SerialTreeLearner``, `serial_tree_learner.cpp:155-622`).  A tree grows
in *waves*; each wave

  1. applies the previous wave's pending splits to the rows and
     histograms ONLY the smaller child of every split (the fused
     route+histogram kernel on waves of <= 32 slots; the route kernel
     then the leaf-compacted histogram kernel above that),
  2. derives each sibling by parent-minus-child subtraction from the
     per-leaf histogram state ``[L, G, B, 3]`` (`feature_histogram.hpp:64-70`),
  3. re-scans only the changed leaves and caches their best splits,
  4. splits every positive-gain leaf (up to the wave's slot count),
     ranked by gain with a stable sort.

The final pass routes the last wave's splits and emits each row's leaf
value for the score update (the route-values kernel).

The slot counts follow :func:`stage_plan` (8, 8, 16, 32, ... then a
fixed-width tail), and datasets of at most ``COMPILE_LEAN_ROWS`` rows run
every wave at the tail width — the reference's plan, which decides how
many splits a wave may take and so the model.  The reference's
``lax.while_loop`` tail becomes a Python loop that reads the leaf count
and the stop flag once per wave.

State arrays carry one extra trailing slot (``[L + 1]`` per leaf,
``[L]`` per node of ``L - 1``): the reference's "drop" scatters (index
``L`` / ``L - 1``) write there, and it is sliced off at the end.  State
is updated in place.
"""
from __future__ import annotations

from contextlib import contextmanager
from dataclasses import dataclass
from typing import Callable, NamedTuple, Optional

import torch

from ..io.binning import MISSING_NAN, MISSING_ZERO
from ..io.device import DeviceData
from ..obs import span as obs_span
from ..utils import faults
from ..ops.compact import (compact_slot_threshold, hist_active_compact,
                           hist_compact_raw)
from ..ops.histogram import (bin_stride, combine_hist_cols,
                             hist_active_float_raw, hist_active_raw,
                             hist_route, hist_wide_raw,
                             hist_wide_scratch_bytes, is_quantized,
                             pack_values, pack_values_q, unbundle_grid,
                             value_cols)
from ..ops.route import route_rows, route_rows_values, unbundle_bin
from ..ops.split import (SplitParams, SplitResult, find_best_splits,
                         leaf_output, split_scan_chunk_features)
from ..ops.split_kernel import find_best_splits_kernel, split_kernel_ok
from ..utils.timetag import phases_enabled, timed

NEG_INF = -1e30

# datasets at or below this row count run every wave at the tail width
# (the reference's compile-lean plan; it changes how many splits a wave
# may take, so the port keeps it to build the same trees)
COMPILE_LEAN_ROWS = 65536

# the root statistics reduce in chunks of this many rows (the
# reference's canonical reduction tree)
STREAM_CHUNK = 8192

# int8 cells accumulate exactly in int32 while n * 127 < 2^31
_INT8_ROW_LIMIT = ((1 << 31) - 1) // 127


class GrowthParams(NamedTuple):
    """Static tree-growth parameters."""
    num_leaves: int = 31
    max_depth: int = -1
    wave_size: int = 0          # 0 => unlimited (full wave); 1 => leaf-wise
    split: SplitParams = SplitParams()


@dataclass
class BuiltTree:
    """A finished tree as device tensors (fixed shapes, dynamic leaf
    count).  Node layout matches the reference Tree (`tree.h`): internal
    nodes ``[0, num_leaves-2]``, children ``>=0`` internal, ``~leaf`` for
    leaves."""
    feature: torch.Tensor         # [L-1] int32 (used-column index)
    threshold_bin: torch.Tensor   # [L-1] int32
    default_left: torch.Tensor    # [L-1] bool
    is_categorical: torch.Tensor  # [L-1] bool
    cat_mask: torch.Tensor        # [L-1, B] bool
    left_child: torch.Tensor      # [L-1] int32
    right_child: torch.Tensor     # [L-1] int32
    gain: torch.Tensor            # [L-1] f32
    internal_value: torch.Tensor  # [L-1] f32
    internal_count: torch.Tensor  # [L-1] int32
    leaf_value: torch.Tensor      # [L] f32
    leaf_count: torch.Tensor      # [L] int32
    leaf_depth: torch.Tensor      # [L] int32
    num_leaves: torch.Tensor      # scalar int32
    row_leaf: torch.Tensor        # [n] int32 final leaf per row
    row_value: torch.Tensor       # [n] f32 leaf value per row (0 outside)


@dataclass
class _WaveState:
    leaf2: torch.Tensor           # [2, n_pad] (row_leaf; hist_leaf/-1 bagged)
    nl: torch.Tensor              # scalar int64 current leaf count
    done: torch.Tensor            # scalar bool
    leaf_sum_grad: torch.Tensor   # [L+1] f32
    leaf_sum_hess: torch.Tensor   # [L+1]
    leaf_count: torch.Tensor      # [L+1] f32 (in-bag counts)
    leaf_depth: torch.Tensor      # [L+1] int32
    leaf_value: torch.Tensor      # [L+1] f32
    leaf_parent: torch.Tensor     # [L+1] int32 node idx
    leaf_is_left: torch.Tensor    # [L+1] bool
    hist_state: torch.Tensor      # [L+1, G, B, 3] per-leaf histograms
    best: SplitResult             # [L+1] cached best split per leaf
    pend_sel: torch.Tensor        # [L] bool: splits decided last wave,
    pend_new: torch.Tensor        # [L] int32  not yet applied to the rows
    act_small: torch.Tensor       # [A] int32 leaf ids to histogram (-1 pad)
    act_parent: torch.Tensor      # [A] int32 slot holding the parent hist
    act_sibling: torch.Tensor     # [A] int32 sibling leaf id (-1: none)
    tree: dict                    # node arrays [L] (+1 dump slot)


def _round8(x: int) -> int:
    return -(-x // 8) * 8


def wide_wave_slots(L: int) -> int:
    """Active slots of every wave past the kernels' domain (the
    reference's scatter plan): ``round8(L / 2)``."""
    return _round8(max(1, L // 2))


def stage_plan(L: int, wave_size: int = 0):
    """Active-slot counts for the staged waves + the tail width (the
    reference's plan: slot counts track the doubling leaf count)."""
    if wave_size == 1:
        return [], 8
    A_full = min(_round8(max(1, L // 2)), 128)
    plan = []
    leaves = 1
    while leaves < L and len(plan) < 32:
        A = min(_round8(leaves), A_full)
        plan.append(A)
        leaves += min(A, leaves)
    return plan, A_full


def _pairwise_halve(v: torch.Tensor) -> torch.Tensor:
    """Reduce the last axis (a power of two) by repeated pairwise adds —
    a fixed reduction tree."""
    while v.shape[-1] > 1:
        half = v.shape[-1] // 2
        v = v[..., :half] + v[..., half:]
    return v[..., 0]


def root_chunk_sums(grad, hess, bag) -> torch.Tensor:
    """Per-chunk partial sums of the root statistics ``(g, h, count)``:
    ``-> [3, m]``, ``m = ceil(n / STREAM_CHUNK)``, zero-padded chunks each
    reduced by pairwise halving (the reference's order, bitwise)."""
    n = grad.shape[0]
    m = -(-n // STREAM_CHUNK)
    pad = m * STREAM_CHUNK - n
    zero = torch.zeros((), dtype=torch.float32, device=grad.device)
    g = torch.where(bag, grad.float(), zero)
    h = torch.where(bag, hess.float(), zero)
    c = bag.float()
    stacked = torch.nn.functional.pad(torch.stack([g, h, c]), (0, pad))
    return _pairwise_halve(stacked.reshape(3, m, STREAM_CHUNK))


def reduce_chunk_sums(cs: torch.Tensor):
    """``[3, m]`` chunk sums -> root ``(sum_g, sum_h, cnt)`` by pairwise
    halving over the zero-padded power-of-two chunk axis."""
    m = cs.shape[1]
    P = 1 << max(0, (m - 1).bit_length())
    v = _pairwise_halve(torch.nn.functional.pad(cs, (0, P - m)))
    return v[0], v[1], v[2]


def root_stats(grad, hess, bag):
    """Root ``(sum_g, sum_h, cnt)`` via the canonical chunked pairwise
    reduction (bitwise the reference's ``root_stats``).

    The ``num.reassoc`` fault (``utils/faults.py``, as in the JAX package)
    swaps it for a plain ``torch.sum``, whose order is torch's: the
    reassociation the ulp contract (``obs/num_contract.py``) must see.
    Unarmed, the check is two module-attribute reads."""
    if faults.armed() and faults.fault_flag("num.reassoc"):
        b = bag.to(grad.dtype)
        return torch.sum(grad * b), torch.sum(hess * b), torch.sum(b)
    return reduce_chunk_sums(root_chunk_sums(grad, hess, bag))


def default_hist_mode() -> str:
    """int8h: gradients as one int8 column, hessians as an int8 hi+lo
    pair (the reference's default)."""
    return "int8h"


def effective_hist_mode(mode: str, n: int) -> str:
    """The reference's downgrade of quantized modes past the exact-int32
    row bound (``n`` is the global row count, a stream's included) to
    the closest float mode: int8hh to hilo, the others to hhilo."""
    if is_quantized(mode) and n > _INT8_ROW_LIMIT:
        return "hilo" if mode == "int8hh" else "hhilo"
    return mode


# the reference's Pallas kernels read bins through bf16 (exact up to 256)
# and hold a leaf one-hot of at most 1,024 leaves
KERNEL_MAX_BINS = 256
KERNEL_MAX_LEAVES = 1024


def kernels_fit(group_max_bins: int, num_leaf_slots: int) -> bool:
    """Whether a configuration lies in the histogram kernels' domain (the
    reference's ``pallas_config_ok``: at most 256 bins a group and 1,024
    leaves)."""
    return (group_max_bins <= KERNEL_MAX_BINS
            and num_leaf_slots <= KERNEL_MAX_LEAVES)


def wide_hist_bytes(num_leaves: int, G: int, B: int) -> int:
    """Bytes of histograms the scatter backend holds on its device: the
    per-leaf state ``[L + 1, G, B, 3]`` f32 and one wave's grids (the new
    histogram, the parents', the siblings' and both children's together:
    six grids of ``round8(L / 2)`` slots)."""
    return (num_leaves + 1 + 6 * wide_wave_slots(num_leaves)) * G * B * 12


def _check_wide_fits(data: DeviceData, num_leaves: int) -> None:
    """Refuse at setup a scatter configuration whose histograms and one
    wave's kernel scratch exceed the card's memory (on the CPU the host's
    allocator decides)."""
    if data.device.type != "cuda":
        return
    G, Bh = data.num_groups, bin_stride(data.group_max_bins)
    hist = wide_hist_bytes(num_leaves, G, Bh)
    scratch = hist_wide_scratch_bytes(data.num_data, G,
                                      wide_wave_slots(num_leaves), Bh)
    have = torch.cuda.get_device_properties(data.device).total_memory
    if hist + scratch > have:
        raise NotImplementedError(
            f"{num_leaves} leaves over {G} columns at a {Bh}-bin stride "
            f"need {hist / 2**30:.1f} GiB of histograms and "
            f"{scratch / 2**30:.1f} GiB of a wave's kernel scratch, more "
            f"than the card's {have / 2**30:.1f} GiB")


def resolve_backend(data: DeviceData, num_leaf_slots: int) -> str:
    """The reference's choice of backend (``learner/serial.py:
    resolve_backend``), by configuration alone: ``"scatter"`` past the
    kernels' domain (:func:`kernels_fit`), where every wave takes K2 and
    the exact-f32 wide histogram (:func:`build_tree_unfused`); else
    ``"compact"`` when the tree's tail waves are wider than the
    compaction threshold (fused kernel on shallow waves, route + compact
    kernel on deep ones), else ``"fused"`` (every wave fused) — the
    reference's "compact" backend and its degradation to "pallas".  The
    quantized modes take the int32 K1 and K3, the float modes their
    fixed-order float counterparts."""
    if not kernels_fit(data.group_max_bins, num_leaf_slots):
        _check_wide_fits(data, num_leaf_slots)
        return "scatter"
    _, A_tail = stage_plan(num_leaf_slots)
    return "compact" if A_tail > compact_slot_threshold() else "fused"


def wave_uses_compact(backend: str, num_slots: int) -> bool:
    """The per-wave dispatch predicate: waves with more active slots than
    the compaction threshold take route + the leaf-compacted kernel."""
    return backend == "compact" and num_slots > compact_slot_threshold()


class HistFold(NamedTuple):
    """The streamed histogram fold built by :func:`make_hist_fold_fn`.

    ``fold(bins_t, grad, hess, hist_leaf, active, acc, scales)`` adds one
    block's rows into the carried raw accumulator ``acc`` (``[A, G, B,
    C]``, int32 on the quantized modes, float32 on the float ones) and
    returns it; ``init_acc()`` makes the zero carry; ``unpack(acc,
    scales)`` turns the finished chain into the ``[A, G, B, 3]`` f32 grid
    the split scan reads.  ``backend`` is the kernel: "wide" (K5),
    "compact" (K3) or "scatter" (the seeded exact-f32 wide histogram,
    past the kernels' domain)."""
    fold: Callable
    init_acc: Callable
    unpack: Callable
    backend: str
    hist_mode: str
    quantized: bool


def make_hist_fold_fn(data: DeviceData, num_leaf_slots: int,
                      num_active: int, hist_mode: Optional[str] = None,
                      num_data: Optional[int] = None) -> HistFold:
    """The out-of-core histogram fold (the reference's
    ``make_hist_fold_fn``): each wave of a streamed tree histograms its
    rows block by block into one carry, unpacked once per wave.

    ``num_data`` is the stream's global row count: the hist mode keys on
    it, not on the block size (int32 cells bound the rows folded through
    them), as the in-memory model this fold must equal keys on n.
    Quantized waves wider than the compaction threshold take the seeded
    K3, every other wave the seeded K5; a float wave takes K5 at any
    width (float compact folds drop to the wide kernel, as the
    reference's do).  Both kernels sum each cell in an order that does
    not depend on the block size.

    Past the kernels' domain (:func:`kernels_fit`) the fold is the
    reference's carried-f32 scatter: ``[A, G, B, 3]`` f32 zeros, each
    block added into the carry by the seeded exact-f32 wide histogram
    (``hist_wide_raw(..., acc=)``: every cell's adds in row order, across
    blocks too, so the chain is the in-memory wave's sum bitwise), the
    carry unpacked as is.  It is not quantized, whatever the hist mode
    (as :func:`build_tree_unfused` past the domain)."""
    mode = effective_hist_mode(hist_mode or default_hist_mode(),
                               data.num_data if num_data is None
                               else num_data)
    mb = data.group_max_bins
    dev = data.device
    if not kernels_fit(mb, num_leaf_slots):
        shape = (num_active, data.num_groups, bin_stride(mb), 3)

        def init_scatter():
            return torch.zeros(shape, dtype=torch.float32, device=dev)

        def fold_scatter(bins_t, grad, hess, hist_leaf, active, acc,
                         scales=None):
            return hist_wide_raw(bins_t, grad, hess, hist_leaf, active,
                                 num_leaf_slots, mb, acc=acc)

        return HistFold(fold_scatter, init_scatter,
                        lambda acc, scales=None: acc, "scatter", mode,
                        False)
    quantized = is_quantized(mode)
    compact = quantized and num_active > compact_slot_threshold()
    shape = (num_active, data.num_groups, bin_stride(mb), value_cols(mode))
    dtype = torch.int32 if quantized else torch.float32

    def init_acc():
        return torch.zeros(shape, dtype=dtype, device=dev)

    def fold(bins_t, grad, hess, hist_leaf, active, acc, scales=None):
        n_pad = bins_t.shape[1]
        if not quantized:
            vals = pack_values(grad, hess, mode, n_pad)
            return hist_active_float_raw(bins_t, vals, hist_leaf, active,
                                         num_leaf_slots, mb, acc)
        vals, _ = pack_values_q(grad, hess, mode, n_pad, scales=scales)
        kernel = hist_compact_raw if compact else hist_active_raw
        return kernel(bins_t, vals, hist_leaf, active, num_leaf_slots, mb,
                      acc)

    def unpack(acc, scales=None):
        return combine_hist_cols(acc, mode, scales)

    return HistFold(fold, init_acc, unpack,
                    "compact" if compact else "wide", mode, quantized)


def _set(dst: torch.Tensor, idx: torch.Tensor, src: torch.Tensor) -> None:
    """In-place scatter ``dst[idx] = src`` (indices past the live range
    land in ``dst``'s trailing dump slot)."""
    dst.index_put_((idx.long(),), src)


def apply_hist_wave(hist_state, new_h, act_small, act_parent, act_sibling,
                    L: int):
    """Sibling subtraction + persistence of both children into the
    per-leaf state: -> ``(ids [2A], grid [2A, G, B, 3])``.  Padding slots
    (id -1) carry garbage whose scan results the caller drops."""
    dump = torch.full_like(act_small, L)
    parent_h = hist_state[act_parent.clamp(0, L - 1).long()]
    sib_h = parent_h - new_h
    _set(hist_state, torch.where(act_small >= 0, act_small, dump), new_h)
    _set(hist_state, torch.where(act_sibling >= 0, act_sibling, dump),
         sib_h)
    ids = torch.cat([act_small, act_sibling])
    grid = torch.cat([new_h, sib_h], dim=0)
    return ids, grid


def scan_grid(data: DeviceData, params: GrowthParams, feature_mask, ids,
              grid, lsg, lsh, lc) -> SplitResult:
    """EFB unbundle + best-split scan of the changed-leaf grids: the
    fused split kernel (K6) where :func:`split_kernel_ok` holds (at most
    65,536 rows, numerical features), else the torch scan, with the
    categorical search where the data has categorical features — the
    reference's choice of scan."""
    L = params.num_leaves
    safe = ids.clamp(0, L - 1).long()
    if data.is_bundled:
        grid = unbundle_grid(grid, lsg[safe], lsh[safe], lc[safe],
                             data.feat_group, data.feat_offset,
                             data.num_bins, data.default_bins,
                             bin_stride(data.max_bins))
    if split_kernel_ok(grid.shape[1], grid.shape[2], data.has_categorical,
                       data.num_data):
        return find_best_splits_kernel(
            grid.contiguous(), lsg[safe], lsh[safe], lc[safe],
            data.num_bins, data.missing_types, data.default_bins,
            params=params.split, feature_mask=feature_mask,
            any_missing=data.has_missing)
    fc = split_scan_chunk_features(grid.shape[0], grid.shape[1],
                                   grid.shape[2], data.has_missing)
    return find_best_splits(grid, lsg[safe], lsh[safe], lc[safe],
                            data.num_bins, data.missing_types,
                            data.default_bins, params.split, feature_mask,
                            any_missing=data.has_missing, feature_chunk=fc,
                            is_categorical=data.is_categorical,
                            any_categorical=data.has_categorical)


def rescan_changed(data: DeviceData, params: GrowthParams, feature_mask,
                   s: _WaveState, new_h):
    """Post-histogram flow of every wave: sibling subtraction, EFB
    unbundle, rescan of the changed leaves -> ``(ids, SplitResult)``."""
    ids, grid = apply_hist_wave(s.hist_state, new_h, s.act_small,
                                s.act_parent, s.act_sibling,
                                params.num_leaves)
    res = scan_grid(data, params, feature_mask, ids, grid, s.leaf_sum_grad,
                    s.leaf_sum_hess, s.leaf_count)
    return ids, res


def _empty_best(L: int, B: int, dev) -> SplitResult:
    z = torch.zeros(L + 1, dtype=torch.float32, device=dev)
    return SplitResult(
        gain=torch.full((L + 1,), NEG_INF, dtype=torch.float32, device=dev),
        feature=torch.zeros(L + 1, dtype=torch.int32, device=dev),
        threshold=torch.zeros(L + 1, dtype=torch.int32, device=dev),
        default_left=torch.zeros(L + 1, dtype=torch.bool, device=dev),
        is_categorical=torch.zeros(L + 1, dtype=torch.bool, device=dev),
        cat_mask=torch.zeros((L + 1, B), dtype=torch.bool, device=dev),
        left_sum_grad=z.clone(), left_sum_hess=z.clone(),
        left_count=z.clone(), right_sum_grad=z.clone(),
        right_sum_hess=z.clone(), right_count=z.clone(),
        left_output=z.clone(), right_output=z.clone())


def _init_state(data: DeviceData, grad, hess, params: GrowthParams,
                bag_mask, A0: int, psum_fn=None,
                num_hist_features: Optional[int] = None) -> _WaveState:
    """Empty tree, root leaf statistics, root-wave active set.  With
    ``psum_fn`` the root statistics are summed over the ranks after the
    canonical chunked sums (the data- and voting-parallel root); the
    histogram state is ``num_hist_features`` columns wide when given (a
    feature-parallel rank keeps its own columns only)."""
    n = data.num_data
    leaf2 = torch.full((2, data.n_pad), -1, dtype=torch.int32,
                       device=data.device)
    leaf2[0, :n] = 0
    if bag_mask is not None:
        leaf2[1, :n] = torch.where(bag_mask, 0, -1).to(torch.int32)
    else:
        leaf2[1, :n] = 0
    bag = leaf2[1, :n] == 0
    sum_g, sum_h, cnt = root_stats(grad, hess, bag)
    if psum_fn is not None:
        sum_g, sum_h, cnt = psum_fn((sum_g, sum_h, cnt))
    return root_state(data, leaf2, sum_g, sum_h, cnt, params, A0,
                      num_hist_features)


def root_state(data: DeviceData, leaf2, sum_g, sum_h, cnt,
               params: GrowthParams, A0: int,
               num_hist_features: Optional[int] = None) -> _WaveState:
    """The one-leaf tree from the root statistics, with the root-wave
    active set (``leaf2`` as given: a streamed tree keeps its leaf
    vectors per block, outside the state)."""
    dev = data.device
    L = params.num_leaves
    Lm = max(L - 1, 1)
    B = bin_stride(data.max_bins)
    Bh = bin_stride(data.group_max_bins)
    G = data.num_groups if num_hist_features is None else num_hist_features

    def i32(shape, fill=0):
        return torch.full(shape, fill, dtype=torch.int32, device=dev)

    root_out = leaf_output(sum_g, sum_h, params.split.lambda_l1,
                           params.split.lambda_l2)

    def f32_root(v):
        out = torch.zeros(L + 1, dtype=torch.float32, device=dev)
        out[0] = v
        return out

    tree = dict(
        feature=i32((Lm + 1,)), threshold_bin=i32((Lm + 1,)),
        default_left=torch.zeros(Lm + 1, dtype=torch.bool, device=dev),
        is_categorical=torch.zeros(Lm + 1, dtype=torch.bool, device=dev),
        cat_mask=torch.zeros((Lm + 1, B), dtype=torch.bool, device=dev),
        left_child=i32((Lm + 1,), -1), right_child=i32((Lm + 1,), -1),
        gain=torch.zeros(Lm + 1, dtype=torch.float32, device=dev),
        internal_value=torch.zeros(Lm + 1, dtype=torch.float32, device=dev),
        internal_count=i32((Lm + 1,)))
    act_small = i32((A0,), -1)
    act_small[0] = 0
    return _WaveState(
        leaf2=leaf2,
        nl=torch.ones((), dtype=torch.int64, device=dev),
        done=torch.zeros((), dtype=torch.bool, device=dev),
        leaf_sum_grad=f32_root(sum_g), leaf_sum_hess=f32_root(sum_h),
        leaf_count=f32_root(cnt),
        leaf_depth=i32((L + 1,)),
        leaf_value=f32_root(root_out),
        leaf_parent=i32((L + 1,), -1),
        leaf_is_left=torch.zeros(L + 1, dtype=torch.bool, device=dev),
        hist_state=torch.zeros((L + 1, G, Bh, 3), dtype=torch.float32,
                               device=dev),
        best=_empty_best(L, B, dev),
        pend_sel=torch.zeros(L, dtype=torch.bool, device=dev),
        pend_new=i32((L,)),
        act_small=act_small, act_parent=i32((A0,), -1),
        act_sibling=i32((A0,), -1),
        tree=tree)


def _apply_wave(s: _WaveState, leaf2, ids, res: SplitResult, A_out: int,
                params: GrowthParams, wave_cap: int) -> _WaveState:
    """Merge the rescanned best splits, select this wave's splits by gain
    rank, record tree nodes, update leaf state and stage the next wave's
    active sets (the reference's ``_apply_wave``)."""
    L = params.num_leaves
    Lm = max(L - 1, 1)
    dev = leaf2.device
    best = s.best
    merge_idx = torch.where(ids >= 0, ids, torch.full_like(ids, L))
    best = best.map(lambda cur, new: cur.index_put_((merge_idx.long(),),
                                                    new), res)

    # --- select this wave's splits --------------------------------------
    lid = torch.arange(L, device=dev)
    neg = torch.full((), NEG_INF, dtype=torch.float32, device=dev)
    gain = torch.where(lid < s.nl, best.gain[:L], neg)
    if params.max_depth > 0:
        gain = torch.where(s.leaf_depth[:L] >= params.max_depth, neg, gain)
    can = gain > 0.0
    order = torch.argsort(-gain, stable=True)       # leaves by gain desc
    rank = torch.empty_like(order)
    rank[order] = lid
    budget = L - s.nl
    k = torch.minimum(torch.minimum(can.sum(), budget),
                      torch.tensor(min(wave_cap, A_out), device=dev))
    sel = can & (rank < k)
    new_id = torch.where(sel, s.nl + rank, torch.full_like(rank, L))
    node_idx = torch.where(sel, s.nl - 1 + rank, torch.full_like(rank, Lm))

    # --- record tree nodes ------------------------------------------------
    b = lambda x: x[:L]                                 # noqa: E731
    t = s.tree
    dl = torch.where(b(best.is_categorical), False, b(best.default_left))
    _set(t["feature"], node_idx, b(best.feature))
    _set(t["threshold_bin"], node_idx, b(best.threshold))
    _set(t["default_left"], node_idx, dl)
    _set(t["is_categorical"], node_idx, b(best.is_categorical))
    _set(t["cat_mask"], node_idx, b(best.cat_mask))
    _set(t["gain"], node_idx, b(best.gain))
    _set(t["internal_value"], node_idx, b(s.leaf_value))
    _set(t["internal_count"], node_idx, b(s.leaf_count).to(torch.int32))
    _set(t["left_child"], node_idx, (~lid).to(torch.int32))
    _set(t["right_child"], node_idx, (~new_id).to(torch.int32))
    # fix the parent's child pointer: leaf l was ~l, becomes node_idx
    parent = torch.where(sel, b(s.leaf_parent), -1)
    is_left = b(s.leaf_is_left)
    dump = torch.full_like(node_idx, Lm)
    fix_left = torch.where(sel & is_left & (parent >= 0), parent, dump)
    fix_right = torch.where(sel & ~is_left & (parent >= 0), parent, dump)
    _set(t["left_child"], fix_left, node_idx.to(torch.int32))
    _set(t["right_child"], fix_right, node_idx.to(torch.int32))

    # --- update leaf state: left child keeps id l, right -> new_id -------
    def upd(cur, left, right):
        out = torch.empty_like(cur)
        out[:L] = torch.where(sel, left, cur[:L])
        out[L] = cur[L]
        _set(out, new_id, right)
        return out

    depth1 = b(s.leaf_depth) + 1
    lsg = upd(s.leaf_sum_grad, b(best.left_sum_grad), b(best.right_sum_grad))
    lsh = upd(s.leaf_sum_hess, b(best.left_sum_hess), b(best.right_sum_hess))
    lc = upd(s.leaf_count, b(best.left_count), b(best.right_count))
    lv = upd(s.leaf_value, b(best.left_output), b(best.right_output))
    ld = upd(s.leaf_depth, depth1, depth1)
    node32 = node_idx.to(torch.int32)
    lp = upd(s.leaf_parent, node32, node32)
    lil = upd(s.leaf_is_left, torch.ones_like(sel), torch.zeros_like(sel))

    # --- this wave's splits become the pending route ---------------------
    pend_new = torch.where(sel, new_id, torch.zeros_like(new_id))

    # --- next wave's active sets (smaller child + subtraction) -----------
    smaller_left = b(best.left_count) <= b(best.right_count)
    small_val = torch.where(smaller_left, lid, new_id)
    sib_val = torch.where(smaller_left, new_id, lid)
    slot = torch.where(sel, rank, torch.full_like(rank, A_out))

    def actives(v):
        out = torch.full((A_out + 1,), -1, dtype=torch.int32, device=dev)
        _set(out, slot, v.to(torch.int32))
        return out[:A_out].contiguous()

    return _WaveState(
        leaf2=leaf2, nl=s.nl + k, done=(k == 0),
        leaf_sum_grad=lsg, leaf_sum_hess=lsh, leaf_count=lc,
        leaf_depth=ld, leaf_value=lv, leaf_parent=lp, leaf_is_left=lil,
        hist_state=s.hist_state, best=best,
        pend_sel=sel, pend_new=pend_new.to(torch.int32),
        act_small=actives(small_val), act_parent=actives(lid),
        act_sibling=actives(sib_val), tree=t)


def _pending_tables(data: DeviceData, s: _WaveState, L: int):
    """Route arguments of the pending splits (per-leaf ``[L]`` views)."""
    bt = s.best
    return (bt.feature[:L], bt.threshold[:L], bt.default_left[:L],
            bt.is_categorical[:L], bt.cat_mask[:L], s.pend_sel, s.pend_new,
            data.missing_types, data.nan_bins, data.default_bins,
            data.feat_group, data.feat_offset, data.num_bins)


def tree_phase(name: str, device):
    """A phase of the tree learner: its ``tree.*`` telemetry span and,
    under ``LGBM_TPU_TIMETAG=phases``, its timetag on ``device`` under
    the JAX package's ``tree:*`` name (else the span alone: this runs
    several times a wave)."""
    if not phases_enabled():
        return obs_span(name)
    return _tagged_span(name, "tree:scan" if name == "tree.split_find"
                        else name.replace(".", ":"), device)


@contextmanager
def _tagged_span(name: str, tag: str, device):
    with obs_span(name), timed(tag, device):
        yield


def build_tree(data: DeviceData, grad: torch.Tensor, hess: torch.Tensor,
               params: GrowthParams,
               bag_mask: Optional[torch.Tensor] = None,
               feature_mask: Optional[torch.Tensor] = None,
               hist_mode: Optional[str] = None,
               strategy=None, psum_fn=None, psum_axis=None,
               num_hist_features: Optional[int] = None) -> BuiltTree:
    """Grow one tree with the per-wave kernel dispatch of the reference:
    fused route+histogram on waves of <= 32 slots, route then the
    leaf-compacted histogram above that, route-values at the end.  The
    quantized modes pack int8 values (int32 kernels), the float modes
    float32 values (the fixed-order float kernels, ``scales`` None).

    The distributed learners' seams (the reference's
    ``learner/serial.py:build_tree``; ``parallel/learners.py``):
    ``psum_fn`` sums a tensor, or a tuple of them, over the ranks (the
    root statistics, and each wave's histograms unless ``psum_axis``, the
    group's ``MeshContext``, routes them through the overlapped reduction
    of ``ops/overlap.py``); ``strategy`` replaces a wave's histogram and
    scan (:func:`make_serial_strategy`'s contract); ``num_hist_features``
    is the width of the histogram state.  With ``strategy`` or
    ``psum_fn`` set, or past the kernels' domain, the build takes
    :func:`build_tree_unfused`."""
    n = data.num_data
    L = params.num_leaves
    backend = resolve_backend(data, L)
    if (strategy is not None or psum_fn is not None
            or backend == "scatter"):
        return build_tree_unfused(data, grad, hess, params, bag_mask,
                                  feature_mask, hist_mode, strategy,
                                  psum_fn, psum_axis, num_hist_features)
    mode = effective_hist_mode(hist_mode or default_hist_mode(), n)
    plan, A_tail = stage_plan(L, params.wave_size)
    if n <= COMPILE_LEAN_ROWS and params.wave_size != 1:
        plan = []
    wave_cap = params.wave_size if params.wave_size > 0 else L
    if is_quantized(mode):
        vals, scales = pack_values_q(grad, hess, mode, data.n_pad)
    else:
        vals, scales = pack_values(grad, hess, mode, data.n_pad), None

    def body(s: _WaveState, A_out: int) -> _WaveState:
        tabs = _pending_tables(data, s, L)
        if wave_uses_compact(backend, s.act_small.shape[0]):
            with tree_phase("tree.route", data.device):
                leaf2 = route_rows(data.bins_t, s.leaf2, *tabs)
            with tree_phase("tree.hist", data.device):
                new_h = hist_active_compact(
                    data.bins_t, vals, leaf2[1].contiguous(), s.act_small,
                    scales, num_leaf_slots=L, max_bins=data.group_max_bins,
                    mode=mode)
        else:
            with tree_phase("tree.hist", data.device):  # the route rides K1
                new_h, leaf2 = hist_route(
                    data.bins_t, vals, s.leaf2, s.act_small, *tabs, scales,
                    max_bins=data.group_max_bins, mode=mode)
        return _scan_and_apply(data, params, feature_mask, s, leaf2, new_h,
                               A_out, wave_cap)

    with tree_phase("tree.init", data.device):
        s = _init_state(data, grad, hess, params, bag_mask,
                        plan[0] if plan else A_tail)

    def finished(s: _WaveState) -> bool:
        done, nl = torch.stack([s.done.long(), s.nl]).tolist()
        return bool(done) or nl >= L

    # staged waves, then the fixed-width tail; a wave after the stop
    # condition would change nothing, so the loop ends there
    i = 0
    while not finished(s):
        if i < len(plan):
            A_out = plan[i + 1] if i + 1 < len(plan) else A_tail
        else:
            A_out = A_tail
        s = body(s, A_out)
        i += 1

    # apply the last wave's pending splits and emit each row's leaf value
    return _final_route(data, s, L)


def make_hist_fn(data: DeviceData, grad, hess, num_leaf_slots: int,
                 hist_mode: Optional[str] = None):
    """The per-wave active-leaf histogram ``(hist_leaf, active) -> [A, G,
    B, 3]`` f32 over routed hist leaves (the reference's
    ``make_hist_fn``): the wide kernel (K5) on waves up to the
    compaction threshold, the leaf-compacted kernel (K3) above it on the
    "compact" backend, the exact-f32 wide histogram past the kernels'
    domain.  The values are packed once, from these rows' gradients (a
    data-parallel rank quantizes with its own scales, as the reference's
    shard does), and the quantized modes' row bound
    (:func:`effective_hist_mode`) holds against these rows too: a rank's
    int32 histogram sums its own rows only, as the reference's shard
    sees its ``bins.shape[0]``."""
    L = num_leaf_slots
    mb = data.group_max_bins
    backend = resolve_backend(data, L)
    if backend == "scatter":
        g = grad.float().contiguous()
        h = hess.float().contiguous()

        def hist_scatter(hist_leaf, active):
            return hist_wide_raw(data.bins_t, g, h, hist_leaf, active, L, mb)
        return hist_scatter
    mode = effective_hist_mode(hist_mode or default_hist_mode(),
                               data.num_data)
    if is_quantized(mode):
        vals, scales = pack_values_q(grad, hess, mode, data.n_pad)
        wide = hist_active_raw
    else:
        vals, scales = pack_values(grad, hess, mode, data.n_pad), None
        wide = hist_active_float_raw

    def hist_fn(hist_leaf, active):
        if wave_uses_compact(backend, active.shape[0]):
            return hist_active_compact(data.bins_t, vals, hist_leaf, active,
                                       scales, num_leaf_slots=L,
                                       max_bins=mb, mode=mode)
        raw = wide(data.bins_t, vals, hist_leaf, active, L, mb)
        return combine_hist_cols(raw, mode, scales)
    return hist_fn


def make_serial_strategy(data: DeviceData, grad, hess, params: GrowthParams,
                         feature_mask, psum_fn=None,
                         hist_mode: Optional[str] = None, psum_axis=None):
    """The serial (and, with ``psum_fn``, data-parallel) wave strategy
    ``wave(s, hist_leaf) -> (ids, SplitResult)``: histogram the active
    leaves, sum them over the ranks, subtract siblings (``s.hist_state``
    in place), rescan the changed leaves.  ``psum_axis`` (the group's
    ``MeshContext``) issues the sum as the overlapped chunked reduction
    (``ops/overlap.py``), bitwise the same."""
    L = params.num_leaves
    hist_fn = make_hist_fn(data, grad, hess, L, hist_mode)

    def wave(s: _WaveState, hist_leaf):
        with tree_phase("tree.hist", data.device):
            new_h = hist_fn(hist_leaf, s.act_small)
            if psum_axis is not None:
                from ..ops.overlap import reduce_apply_overlapped
                ids, grid = reduce_apply_overlapped(
                    s.hist_state, new_h, s.act_small, s.act_parent,
                    s.act_sibling, L, psum_axis)
            else:
                if psum_fn is not None:
                    new_h = psum_fn(new_h)
                ids, grid = apply_hist_wave(s.hist_state, new_h, s.act_small,
                                            s.act_parent, s.act_sibling, L)
        with tree_phase("tree.split_find", data.device):
            return ids, scan_grid(data, params, feature_mask, ids, grid,
                                  s.leaf_sum_grad, s.leaf_sum_hess,
                                  s.leaf_count)
    return wave


def build_tree_unfused(data: DeviceData, grad: torch.Tensor,
                       hess: torch.Tensor, params: GrowthParams,
                       bag_mask: Optional[torch.Tensor] = None,
                       feature_mask: Optional[torch.Tensor] = None,
                       hist_mode: Optional[str] = None, strategy=None,
                       psum_fn=None, psum_axis=None,
                       num_hist_features: Optional[int] = None
                       ) -> BuiltTree:
    """Grow one tree through a wave strategy, with the fused kernels off
    (the reference's ``build_tree`` with ``psum_fn`` or ``strategy`` set,
    and its scatter backend past the kernels' domain,
    ``learner/serial.py:777-889``): every wave routes the pending splits
    (K2, on uint8 or int32 bins) and hands the hist leaves to
    ``strategy`` (default :func:`make_serial_strategy`); the last route
    emits each row's leaf value (K4), bitwise the reference's gather of
    the leaf values by ``row_leaf``.  The wave plan is the reference's
    for the backend: staged on the kernels, every wave ``round8(L / 2)``
    slots past their domain (where ``hist_mode`` does not apply)."""
    n = data.num_data
    L = params.num_leaves
    if resolve_backend(data, L) == "scatter":
        plan, A_tail = [], wide_wave_slots(L)
    else:
        plan, A_tail = stage_plan(L, params.wave_size)
        if n <= COMPILE_LEAN_ROWS and params.wave_size != 1:
            plan = []
    wave_cap = params.wave_size if params.wave_size > 0 else L
    if strategy is None:
        strategy = make_serial_strategy(data, grad, hess, params,
                                        feature_mask, psum_fn, hist_mode,
                                        psum_axis)
    with tree_phase("tree.init", data.device):
        s = _init_state(data, grad, hess, params, bag_mask,
                        plan[0] if plan else A_tail, psum_fn,
                        num_hist_features)

    def finished(s: _WaveState) -> bool:
        done, nl = torch.stack([s.done.long(), s.nl]).tolist()
        return bool(done) or nl >= L

    i = 0
    while not finished(s):
        if i < len(plan):
            A_out = plan[i + 1] if i + 1 < len(plan) else A_tail
        else:
            A_out = A_tail
        with tree_phase("tree.route", data.device):
            leaf2 = route_rows(data.bins_t, s.leaf2,
                               *_pending_tables(data, s, L))
        ids, res = strategy(s, leaf2[1].contiguous())
        with tree_phase("tree.update", data.device):
            s = _apply_wave(s, leaf2, ids, res, A_out, params, wave_cap)
        i += 1
    return _final_route(data, s, L)


def _scan_and_apply(data: DeviceData, params: GrowthParams, feature_mask,
                    s: _WaveState, leaf2, new_h, A_out: int,
                    wave_cap: int) -> _WaveState:
    """A wave's split scan and its bookkeeping, under the learner's
    ``tree.split_find`` and ``tree.update`` spans."""
    with tree_phase("tree.split_find", data.device):
        ids, res = rescan_changed(data, params, feature_mask, s, new_h)
    with tree_phase("tree.update", data.device):
        return _apply_wave(s, leaf2, ids, res, A_out, params, wave_cap)


def _final_route(data: DeviceData, s: _WaveState, L: int) -> BuiltTree:
    """The last route (K4): the last wave's splits applied, each row's
    leaf value emitted for the score update."""
    n = data.num_data
    with tree_phase("tree.route", data.device):
        leaf2, row_value = route_rows_values(
            data.bins_t, s.leaf2, *_pending_tables(data, s, L),
            final_leaf_values(s, L))
    return finished_tree(s, L, leaf2[0, :n], row_value[:n])


def final_leaf_values(s: _WaveState, L: int) -> torch.Tensor:
    """The leaf values the last route emits (zeros for a stump)."""
    return torch.where(s.nl > 1, s.leaf_value[:L],
                       torch.zeros_like(s.leaf_value[:L]))


def finished_tree(s: _WaveState, L: int, row_leaf, row_value) -> BuiltTree:
    t = {k: v[:max(L - 1, 1)] for k, v in s.tree.items()}
    return BuiltTree(
        **t,
        leaf_value=s.leaf_value[:L],
        leaf_count=s.leaf_count[:L].to(torch.int32),
        leaf_depth=s.leaf_depth[:L],
        num_leaves=s.nl.to(torch.int32),
        row_leaf=row_leaf,
        row_value=row_value)


def predict_built_tree(tree: BuiltTree, data: DeviceData,
                       depth: int) -> torch.Tensor:
    """Leaf value per row of ``data`` for a tree whose deepest leaf is
    at ``depth``: :func:`built_tree_leaves`, then one gather."""
    return tree.leaf_value[built_tree_leaves(tree, data, depth)]


def built_tree_leaves(tree, data: DeviceData, depth: int) -> torch.Tensor:
    """Leaf index per row of ``data`` (walking its ``bins_t``) ``[n]``
    int64, for a just-built :class:`BuiltTree` or the node tables of a
    host tree (``boosting/gbdt.py:replay_tables``) whose deepest leaf is
    at ``depth`` (0 for a stump): one pass per level.  A categorical
    node sends bin ``b`` left where its ``cat_mask`` holds ``min(b, B -
    1)`` (the reference walk's clamp of the mask lookup)."""
    n = data.num_data
    bins_t = data.bins_t[:, :n].long()
    node = torch.zeros(n, dtype=torch.int64, device=bins_t.device)
    if depth < 1:
        return node                          # a stump: leaf 0
    # per-node tables, cast once: node -> feature -> column tables
    feature = tree.feature.long()
    group = data.feat_group.long()[feature]
    offset = data.feat_offset.long()[feature]
    nbins = data.num_bins.long()[feature]
    dbin = data.default_bins.long()[feature]
    mtype = data.missing_types[feature]
    nanb = data.nan_bins.long()[feature]
    thr = tree.threshold_bin.long()
    left = tree.left_child.long()
    right = tree.right_child.long()
    Bcat = tree.cat_mask.shape[-1]
    for _ in range(depth):
        is_leaf = node < 0
        nidx = node.clamp(min=0)
        c = bins_t.gather(0, group[nidx][None, :])[0]
        db = dbin[nidx]
        b = unbundle_bin(c, offset[nidx], nbins[nidx], db)
        mt = mtype[nidx]
        is_missing = (((mt == MISSING_NAN) & (b == nanb[nidx]))
                      | ((mt == MISSING_ZERO) & (b == db)))
        go_left = torch.where(is_missing, tree.default_left[nidx],
                              b <= thr[nidx])
        if data.has_categorical:
            cat_left = tree.cat_mask[nidx, b.clamp(max=Bcat - 1)]
            go_left = torch.where(tree.is_categorical[nidx], cat_left,
                                  go_left)
        nxt = torch.where(go_left, left[nidx], right[nidx])
        node = torch.where(is_leaf, node, nxt)
    return ~node
