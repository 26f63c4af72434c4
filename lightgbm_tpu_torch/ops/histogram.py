"""Active-leaf histograms: value rows (quantized and float), the fused
route+histogram kernel (K1), the wide active-leaf histogram kernel (K5,
quantized and float) with their plain versions, and the helpers the
histogram kernels share.

Counterpart of the JAX package's ``ops/pallas_histogram.py`` (value
packing, dequantization, the scatter oracle, the fused and wide
kernels) and ``ops/histogram.py`` (``unbundle_grid``).  The TPU kernels
build one-hot matrices for the MXU because the TPU has no atomics; here
the quantized kernels (``csrc/hist_route.cu``, ``csrc/hist_active.cu``,
``csrc/hist_compact.cu``) add int8 values into int32 cells with
atomics, which is exact in any order.  The float modes (``bf16``,
``hilo``, ``hhilo``, ``ghilo``) sum bf16-rounded values in float32 in
one fixed order (see ``FLOAT_CHUNK``): the float K5
(``csrc/hist_float.cu``, :func:`hist_active_float_raw`) of the streamed
folds, and in memory the float K1 (``csrc/hist_route_float.cu``,
:func:`hist_route_float_raw`) and the float K3
(``csrc/hist_compact_float.cu`` + ``csrc/hist_float_walk.cuh``,
``ops/compact.py``).  Past the kernels' domain (groups of more than 256
bins, more than 1,024 leaves) the exact-f32 wide histogram
(``csrc/hist_wide.cu``, :func:`hist_wide_raw`) takes the place of the
reference's XLA scatter, in its row order.

Layout: ``bins_t`` is ``[G, n_pad]`` uint8 (``io/device.py``), ``vals``
``[C, n_pad]`` (int8, or float32 on the float modes) with padding rows
0, and a raw histogram ``[A, G, B, C]`` (int32, or float32) with
``B = bin_stride(group max bins)``.

Every wrapper runs its kernel for CUDA tensors and its plain version for
CPU tensors; it counts kernel launches in ``.launches`` and plain calls
in ``.plain_calls``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from ..obs import profiler
from .route import LaunchCount, leaf_tables, moved_rows

# shared memory one block may use on sm_90 (227 KB), and what one
# multiprocessor holds for all its resident blocks (each reserves 1 KB)
SMEM_BLOCK_MAX = 232_448
SMEM_SM = 233_472
HIST_THREADS = 1024      # threads of a histogram block (csrc/hist_smem.cuh)
HIST_MIN_ROWS = 4096     # fewest rows worth a row partition of their own
ROUTE_TAB_ROWS = 11      # rows of the per-leaf route table (route_row.cuh)


def next_pow2(x: int) -> int:
    return 1 << max(0, (x - 1).bit_length())


def bin_stride(max_bins: int) -> int:
    """Per-column bin stride of the histogram grid."""
    return max(8, next_pow2(max_bins))


QUANTIZED_MODES = ("int8", "int8h", "int8hh")
# float value rows, summed in float32 after rounding to bf16 (the TPU
# kernel's bf16 operands)
FLOAT_MODES = ("bf16", "hilo", "hhilo", "ghilo")


def is_quantized(mode: str) -> bool:
    return mode in QUANTIZED_MODES


def value_cols(mode: str) -> int:
    """Value rows ``C`` of ``mode``'s packing."""
    return {"int8": 3, "int8h": 4, "int8hh": 5, "bf16": 3, "hilo": 5,
            "hhilo": 4, "ghilo": 4}[mode]


def split_hi_lo(x: torch.Tensor):
    """``x -> (hi, lo)``: ``hi`` keeps the top 16 bits of the float32
    pattern (exact in bf16), ``lo = x - hi`` (exact).  Bit masking, as
    the reference, not a cast pair."""
    bits = x.float().contiguous().view(torch.int32)
    hi = (bits & -65536).view(torch.float32)       # 0xFFFF0000
    return hi, x.float() - hi


def pack_values(grad: torch.Tensor, hess: torch.Tensor, mode: str,
                n_pad: int) -> torch.Tensor:
    """Float value rows ``[C, n_pad]`` f32 (padding rows 0), bitwise the
    reference's ``pack_values``: "bf16" C=3 ``(g, h, 1)``; "hilo" C=5
    ``(g_hi, g_lo, h_hi, h_lo, 1)``; "hhilo" C=4 ``(g, h_hi, h_lo, 1)``;
    "ghilo" C=4 ``(g_hi, g_lo, h, 1)``."""
    if mode not in FLOAT_MODES:
        raise ValueError(f"pack_values: {mode!r} is not a float mode "
                         f"{FLOAT_MODES}")
    g = grad.float()
    h = hess.float()
    ones = torch.ones_like(g)
    if mode == "hilo":
        rows = [*split_hi_lo(g), *split_hi_lo(h), ones]
    elif mode == "ghilo":
        rows = [*split_hi_lo(g), h, ones]
    elif mode == "hhilo":
        rows = [g, *split_hi_lo(h), ones]
    else:
        rows = [g, h, ones]
    vals = torch.zeros((len(rows), n_pad), dtype=torch.float32,
                       device=g.device)
    vals[:, :g.shape[0]] = torch.stack(rows)
    return vals


# the quantization steps are computed as products with float32
# reciprocals: the reference's compiler turns ``scale / 127`` into
# ``scale * (1 / 127)``, which rounds differently for some scales
RECIP_127 = float(np.float32(1) / np.float32(127))
RECIP_16129 = float(np.float32(1) / np.float32(16129))


def _fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor
             ) -> torch.Tensor:
    """``a * b + c`` rounded once to float32 (a fused multiply-add).

    The reference compiles these multiply-adds fused; the product of two
    float32 values is exact in float64, so rounding the float64 sum to
    float32 reproduces its result."""
    return (a.double() * b.double() + c.double()).float()


def pack_values_q(grad: torch.Tensor, hess: torch.Tensor, mode: str,
                  n_pad: int, scales: torch.Tensor = None):
    """Quantized value rows: ``-> (vals int8 [C, n_pad], scales f32 [2])``.

    Port of the JAX package's ``pack_values_q`` in its exact operation
    order: ``x * (127 / scale)`` in float32 (the quotient rounded once),
    round half to even, clip to +-127; the ``hilo8`` step ``scale / 127``
    is ``scale * (1 / 127)`` and the residual ``x - hi * step`` one fused
    multiply-add, as the reference's tree build compiles them.
    mode="int8": C=3 ``(g, h, 1)``; "int8h": C=4 ``(g, h_hi, h_lo, 1)``;
    "int8hh": C=5 ``(g_hi, g_lo, h_hi, h_lo, 1)``.
    ``scales`` (``[2]`` f32 ``(sg, sh)``) replaces the scales derived
    from these rows: a streamed tree quantizes every block with the
    absmax over all its rows.
    """
    if not is_quantized(mode):
        raise ValueError(f"pack_values_q: {mode!r} is not a quantized "
                         f"mode {QUANTIZED_MODES}")
    n = grad.shape[0]
    g = grad.float()
    h = hess.float()
    if scales is None:
        tiny = torch.tensor(1e-30, dtype=torch.float32, device=g.device)
        sg = torch.maximum(g.abs().max(), tiny)
        sh = torch.maximum(h.abs().max(), tiny)
    else:
        sg, sh = scales[0], scales[1]

    def q(x, scale):
        # 127 / scale rounded once: torch's ``float / tensor`` multiplies
        # by the reciprocal, an ulp off, which moves the quantum of a row
        # that lands within an ulp of a half (one row of the 1M-row L2
        # headline's seventh tree)
        t = x * torch.div(torch.full_like(scale, 127.0), scale)
        return torch.clamp(torch.round(t), -127, 127)

    def hilo8(x, scale):
        hi = q(x, scale)
        step = scale * RECIP_127
        lo = q(_fma_f32(-hi, step, x), step)
        return hi, lo

    ones = torch.ones_like(g)
    if mode == "int8hh":
        ghi, glo = hilo8(g, sg)
        hhi, hlo = hilo8(h, sh)
        rows = [ghi, glo, hhi, hlo, ones]
    elif mode == "int8h":
        hhi, hlo = hilo8(h, sh)
        rows = [q(g, sg), hhi, hlo, ones]
    else:
        rows = [q(g, sg), q(h, sh), ones]
    vals = torch.zeros((len(rows), n_pad), dtype=torch.int8,
                       device=g.device)
    vals[:, :n] = torch.stack(rows).to(torch.int8)
    return vals, torch.stack([sg, sh])


def dequant_hist(out_i32: torch.Tensor, scales: torch.Tensor,
                 mode: str) -> torch.Tensor:
    """``[..., C] int32 (+ scales) -> [..., 3] f32`` — undo
    :func:`pack_values_q` after exact integer accumulation (the
    reference's ``dequant_hist`` as compiled: steps by reciprocal products,
    hi+lo sums as fused multiply-adds, see :func:`_fma_f32`)."""
    sg, sh = scales[0], scales[1]
    out = out_i32.float()
    g1, g2 = sg * RECIP_127, sg * RECIP_16129
    h1, h2 = sh * RECIP_127, sh * RECIP_16129
    if mode == "int8hh":
        g = _fma_f32(out[..., 0], g1, out[..., 1] * g2)
        h = _fma_f32(out[..., 2], h1, out[..., 3] * h2)
        cnt = out[..., 4]
    elif mode == "int8h":
        g = out[..., 0] * g1
        h = _fma_f32(out[..., 1], h1, out[..., 2] * h2)
        cnt = out[..., 3]
    else:
        g = out[..., 0] * g1
        h = out[..., 1] * h1
        cnt = out[..., 2]
    return torch.stack([g, h, cnt], dim=-1)


def combine_hist_cols(out: torch.Tensor, mode: str,
                      scales: torch.Tensor = None) -> torch.Tensor:
    """``[..., C]`` raw value columns -> ``[..., 3]`` f32 ``(sum_grad,
    sum_hess, count)``: dequantize (quantized modes) or add the float
    hi/lo pairs (the reference's ``combine_hist_cols``)."""
    if is_quantized(mode):
        return dequant_hist(out, scales, mode)
    if mode == "hilo":
        return torch.stack([out[..., 0] + out[..., 1],
                            out[..., 2] + out[..., 3], out[..., 4]], dim=-1)
    if mode == "hhilo":
        return torch.stack([out[..., 0], out[..., 1] + out[..., 2],
                            out[..., 3]], dim=-1)
    if mode == "ghilo":
        return torch.stack([out[..., 0] + out[..., 1], out[..., 2],
                            out[..., 3]], dim=-1)
    return out


def slot_tables(active: torch.Tensor, num_leaf_slots: int,
                collect_unbagged: bool):
    """The wave description both histogram kernels read (see
    ``csrc/hist_smem.cuh``): ``-> (inv [L+1] int32, src [A] int32)``.

    ``inv[leaf]`` is the accumulation slot of rows whose hist leaf is
    ``leaf`` (the first slot holding it); ``inv[L]`` collects rows whose
    hist leaf is -1 when ``collect_unbagged`` (the first -1 slot), else
    -1.  ``src[s]`` is the accumulation slot output slot ``s`` reads, so
    every slot holding the same id gets the same sums."""
    L = num_leaf_slots
    A = active.shape[0]
    dev = active.device
    key = torch.where(active >= 0, active,
                      torch.full_like(active, L)).long()
    inv = torch.full((L + 1,), A, dtype=torch.int64, device=dev)
    inv.scatter_reduce_(0, key, torch.arange(A, device=dev), reduce="amin")
    inv = torch.where(inv == A, torch.full_like(inv, -1), inv)
    if not collect_unbagged:
        inv[L] = -1
    src = inv[key]
    return inv.int().contiguous(), src.int().contiguous()


def hist_plain(bins_t: torch.Tensor, vals: torch.Tensor,
               hist_leaf: torch.Tensor, inv: torch.Tensor,
               src: torch.Tensor, B: int) -> torch.Tensor:
    """Plain version of the histogram both kernels compute:
    ``-> [A, G, B, C] int32`` (int32 ``index_add_`` per column)."""
    G, n_pad = bins_t.shape
    C = vals.shape[0]
    A = src.shape[0]
    L = inv.shape[0] - 1
    hl = hist_leaf.long()
    sl = inv.long()[torch.where(hl >= 0, hl, torch.full_like(hl, L))]
    keep = sl >= 0
    slot = torch.where(keep, sl, torch.full_like(sl, A))     # A = dump
    acc = torch.zeros(((A + 1) * G * B * C,), dtype=torch.int32,
                      device=bins_t.device)
    v = vals.int()                                           # [C, n_pad]
    cs = torch.arange(C, device=bins_t.device)
    for f in range(G):
        base = ((slot * G + f) * B + bins_t[f].long()) * C   # [n_pad]
        idx = base[None, :] + cs[:, None]                    # [C, n_pad]
        acc.index_add_(0, idx.reshape(-1), v.reshape(-1))
    acc = acc.view(A + 1, G, B, C)
    safe = torch.where(src >= 0, src, torch.full_like(src, A)).long()
    out = acc[safe]
    return torch.where((src >= 0)[:, None, None, None], out,
                       torch.zeros_like(out))


@dataclass(frozen=True)
class HistPlan:
    """Launch plan of the int32 histogram kernels (``csrc/hist_smem.cuh``):
    blocks of ``As`` slots x ``Ft`` columns, ``grid_x`` row partitions of
    ``rows_per_block`` rows (a multiple of 4) each, ``smem`` bytes of
    shared memory per block.  Every partition writes one slab of the
    int32 scratch ``[grid_x, A, G, B, C]``."""
    As: int
    Ft: int
    col_tiles: int
    slot_groups: int
    grid_x: int
    rows_per_block: int
    smem: int

    @property
    def blocks(self) -> int:
        return self.grid_x * self.col_tiles * self.slot_groups


def hist_smem_bytes(L: int, route: bool, As: int, Ft: int, B: int,
                    C: int) -> int:
    """Shared memory of one histogram block: the slot table, K1's route
    tables, the int32 tile (``hist_smem_bytes`` in the CUDA source)."""
    return ((L + 1) + (ROUTE_TAB_ROWS * L if route else 0)
            + As * Ft * B * C) * 4


def hist_plan(n_pad: int, G: int, A: int, B: int, C: int, sms: int,
              L: int, route: bool) -> HistPlan:
    """Tiles as large as a block's shared memory allows, balanced over
    the columns (or, when one column of all slots does not fit, over the
    slots); as many row partitions as fill every multiprocessor's
    resident blocks once, at least ``HIST_MIN_ROWS`` rows each."""
    if not 1 <= C <= 5:
        raise ValueError(f"{C} value columns, the kernels take 1-5")
    head = hist_smem_bytes(L, route, 0, 0, B, C)
    per = hist_smem_bytes(L, route, 1, 1, B, C) - head   # slot x column
    room = (SMEM_BLOCK_MAX - head) // per
    if room < 1:
        raise ValueError(f"one histogram column ({B} bins x {C} values) "
                         f"does not fit a block's shared memory")
    if A <= room:
        col_tiles = math.ceil(G / min(G, room // A))
        Ft = math.ceil(G / col_tiles)
        slot_groups = 1
        As = A
    else:
        slot_groups = math.ceil(A / room)
        As = math.ceil(A / slot_groups)
        col_tiles, Ft = G, 1
    smem = hist_smem_bytes(L, route, As, Ft, B, C)
    resident = min(2048 // HIST_THREADS, SMEM_SM // (smem + 1024))
    tiles = col_tiles * slot_groups
    gx = max(1, min(sms * resident // tiles,
                    math.ceil(n_pad / HIST_MIN_ROWS)))
    rpb = -(-math.ceil(n_pad / gx) // 4) * 4
    return HistPlan(As, Ft, col_tiles, slot_groups, math.ceil(n_pad / rpb),
                    rpb, smem)


def hist_slab(plan: HistPlan, A: int, G: int, B: int, C: int, device):
    """The int32 scratch the blocks write their tiles into (every cell is
    written, so it is not cleared)."""
    return torch.empty((plan.grid_x, A, G, B, C), dtype=torch.int32,
                       device=device)


def _check_vector_rows(n_pad: int, *tensors) -> None:
    """The CUDA histogram kernels read 4 rows at a time (16-byte hist
    leaf and value loads): ``n_pad`` a multiple of 4 and every pointer
    16-byte aligned."""
    if n_pad % 4:
        raise ValueError(f"n_pad={n_pad}: the CUDA histogram kernels take "
                         f"a multiple of 4 rows")
    for t in tensors:
        if t.data_ptr() % 16:
            raise ValueError("the CUDA histogram kernels take 16-byte "
                             "aligned tensors")


class BoundLaunch:
    """A kernel's C entry point bound to its arguments; it holds the
    tensors the arguments point into, so none of them is freed before
    the launch."""

    def __init__(self, fn, args, tensors):
        self.fn, self.args, self.tensors = fn, args, tensors

    def __call__(self) -> int:
        return self.fn(*self.args)


def hist_launcher(kind: str, bins_t, vals, leaf, inv, src, L: int, B: int,
                  plan: HistPlan, slab, out, leaf2_out=None, tabs=None,
                  cat_mask=None):
    """One of the int32 histogram kernels (``kind`` "hist_route",
    "hist_compact" or "hist_active") with its slab reduction into
    ``out``, bound to its arguments: -> a callable that launches both and
    returns the CUDA error code.  ``leaf`` is ``leaf2`` for K1, the hist
    leaves otherwise."""
    from .cuda_build import library
    G, n_pad = bins_t.shape
    C = vals.shape[0]
    A = src.shape[0]
    stream = torch.cuda.current_stream(bins_t.device).cuda_stream
    tail = (inv.data_ptr(), src.data_ptr(), A, B, plan.Ft, plan.As,
            plan.grid_x, plan.rows_per_block, slab.data_ptr(),
            out.data_ptr(), stream)
    fn = getattr(library(kind), f"lgbm_{kind}")
    tensors = (bins_t, vals, leaf, inv, src, slab, out, leaf2_out, tabs,
               cat_mask)
    if kind == "hist_route":
        return BoundLaunch(fn, (bins_t.data_ptr(), n_pad, G, vals.data_ptr(),
                                C, leaf.data_ptr(), leaf2_out.data_ptr(),
                                tabs.data_ptr(), L, cat_mask.data_ptr(),
                                cat_mask.shape[1], *tail), tensors)
    return BoundLaunch(fn, (bins_t.data_ptr(), n_pad, G, vals.data_ptr(), C,
                            leaf.data_ptr(), L, *tail), tensors)


def _check(t: torch.Tensor, name: str, dtype, shape=None, device=None):
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if device is not None and t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def slotted_rows(inv, hist_leaf, L: int):
    """Rows whose hist leaf (-1 as leaf ``L``) has a slot: a 0-d tensor."""
    return (inv.long()[torch.where(hist_leaf >= 0, hist_leaf.long(), L)]
            >= 0).sum()


def hist_cost(G: int, C: int, n_pad: int, A: int, L: int, out, n_active,
              extra=0):
    """One int32 histogram launch's traffic and operations, the numbers
    of its bound: the hist leaves read, each active row's bins and values
    read once, the histogram written once, the slot tables read; ``G *
    C`` adds an active row.  ``extra``: K1's route traffic.  -> ``(bytes,
    ops, "int32")``."""
    nbytes = 4 * n_pad + (G + C) * n_active + out.numel() * 4 \
        + (L + 1 + A) * 4 + extra
    return nbytes, G * C * n_active, "int32"


def hist_route_cost(bins_t, vals, leaf2, leaf2_out, inv, tabs, cat_mask,
                    out, L: int):
    """K1's traffic and operations (:func:`hist_cost`, plus the route's:
    both leaves read and written, the moved rows' bins, the tables)."""
    G, n_pad = bins_t.shape
    tab_bytes = 11 * L * 4 + L * cat_mask.shape[1]
    return hist_cost(G, vals.shape[0], n_pad, out.shape[0],
                     L, out, slotted_rows(inv, leaf2_out[1], L),
                     12 * n_pad + moved_rows(leaf2, tabs)
                     * bins_t.element_size() + tab_bytes)


def hist_wide_cost(bins_t, A: int, B: int, rows, seeded: bool):
    """One wide-histogram launch's traffic and operations: each of the
    ``rows`` active rows' bins and two values read once, every hist leaf
    read, the histogram written once (seeded: the carry also read); 3
    f32 adds a row and column.  -> ``(bytes, ops, "f32")``."""
    G, n_pad = bins_t.shape
    nbytes = rows * (G * bins_t.element_size() + 8) + 4 * n_pad \
        + (2 if seeded else 1) * A * G * B * 12
    return nbytes, 3 * rows * G, "f32"


def hist_route_raw(bins_t, vals, leaf2, active, tabs, cat_mask,
                   num_leaf_slots: int, max_bins: int):
    """Fused route + active-leaf histogram (K1): apply the per-leaf
    tables ``tabs`` (:func:`ops.route.leaf_tables`) to ``leaf2``, then
    histogram the routed hist leaves of the ``active`` slots.
    -> ``(raw [A, G, B, C] int32, leaf2' [2, n_pad] int32)``.

    Slots whose id is -1 collect the rows whose hist leaf is -1 (bagged
    out; padding rows carry zero values), as the TPU kernel's do."""
    G, n_pad = bins_t.shape
    C = vals.shape[0]
    A = active.shape[0]
    L = num_leaf_slots
    B = bin_stride(max_bins)
    dev = bins_t.device
    _check(bins_t, "bins_t", torch.uint8)
    _check(vals, "vals", torch.int8, (C, n_pad), dev)
    _check(leaf2, "leaf2", torch.int32, (2, n_pad), dev)
    _check(active, "active", torch.int32, (A,), dev)
    _check(tabs, "tabs", torch.int32, (tabs.shape[0], L), dev)
    _check(cat_mask, "cat_mask", torch.uint8, (L, cat_mask.shape[1]), dev)
    if not 1 <= C <= 5:
        raise ValueError(f"vals: {C} value columns, the kernel takes 1-5")
    inv, src = slot_tables(active, L, collect_unbagged=True)
    if dev.type == "cpu":
        hist_route_raw.plain_calls += 1
        return profiler.launch(
            "hist_route", lambda: hist_route_plain(
                bins_t, vals, leaf2, tabs, cat_mask, inv, src, B),
            lambda r: hist_route_cost(bins_t, vals, leaf2, r[1], inv, tabs,
                                      cat_mask, r[0], L))
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    from .cuda_build import check_launch, multiprocessor_count
    _check_vector_rows(n_pad, bins_t, vals, leaf2)
    out = torch.zeros((A, G, B, C), dtype=torch.int32, device=dev)
    leaf2_out = torch.empty_like(leaf2)
    plan = hist_plan(n_pad, G, A, B, C, multiprocessor_count(dev), L, True)
    code = profiler.launch(
        "hist_route", hist_launcher(
            "hist_route", bins_t, vals, leaf2, inv, src, L, B, plan,
            hist_slab(plan, A, G, B, C, dev), out, leaf2_out, tabs,
            cat_mask),
        lambda _: hist_route_cost(bins_t, vals, leaf2, leaf2_out, inv, tabs,
                                  cat_mask, out, L))
    check_launch(code, "hist_route")
    hist_route_raw.launches += 1
    return out, leaf2_out


hist_route_raw.launches = 0
hist_route_raw.plain_calls = 0


def hist_route_plain(bins_t, vals, leaf2, tabs, cat_mask, inv, src, B):
    """Plain version of :func:`hist_route_raw`: the plain route, then the
    plain histogram of the routed hist leaves."""
    from .route import route_plain
    leaf2_new = route_plain(bins_t, leaf2, tabs, cat_mask)
    return hist_plain(bins_t, vals, leaf2_new[1], inv, src, B), leaf2_new


def hist_route(bins_t, vals, leaf2, active, feature, threshold,
               default_left, is_categorical, cat_mask, sel, new_id,
               missing_types, nan_bins, default_bins, feat_group,
               feat_offset, num_bins_arr, scales, *, max_bins: int,
               mode: str):
    """Fused previous-wave routing + active-leaf histograms, the
    counterpart of the reference's ``hist_route_pallas``:
    -> ``(hist [A, G, B, 3] f32, leaf2_new [2, n_pad] int32)``.  Int8
    ``vals`` take the int32 K1 and are dequantized with ``scales``;
    float32 ``vals`` (:func:`pack_values`) take the float K1 and their
    hi/lo columns are added (``scales`` is None)."""
    tabs, cat = leaf_tables(feature, threshold, default_left,
                            is_categorical, cat_mask, sel, new_id,
                            missing_types, nan_bins, default_bins,
                            feat_group, feat_offset, num_bins_arr)
    kernel = (hist_route_float_raw if vals.dtype == torch.float32
              else hist_route_raw)
    raw, leaf2_new = kernel(bins_t, vals, leaf2, active, tabs, cat,
                            feature.shape[0], max_bins)
    return combine_hist_cols(raw, mode, scales), leaf2_new


def _check_active_inputs(bins_t, vals, hist_leaf, active, acc, B: int,
                         vals_dtype, acc_dtype):
    """Shape, type and device checks of the histogram wrappers over
    routed hist leaves (K5, K3); -> the carry (zeros when ``acc`` is
    None)."""
    G, n_pad = bins_t.shape
    C = vals.shape[0]
    A = active.shape[0]
    dev = bins_t.device
    _check(bins_t, "bins_t", torch.uint8)
    _check(vals, "vals", vals_dtype, (C, n_pad), dev)
    _check(hist_leaf, "hist_leaf", torch.int32, (n_pad,), dev)
    _check(active, "active", torch.int32, (A,), dev)
    if not 1 <= C <= 5:
        raise ValueError(f"vals: {C} value columns, the kernel takes 1-5")
    if acc is None:
        return torch.zeros((A, G, B, C), dtype=acc_dtype, device=dev)
    _check(acc, "acc", acc_dtype, (A, G, B, C), dev)
    return acc


def hist_active_raw(bins_t, vals, hist_leaf, active, num_leaf_slots: int,
                    max_bins: int, acc=None):
    """Wide active-leaf histogram (K5) on quantized values over the hist
    leaves ``hist_leaf [n_pad]`` int32, with no routing: adds into the
    carry ``acc`` (``[A, G, B, C]`` int32; zeros when None) in place and
    returns it.

    The counterpart of the reference's ``hist_active_pallas`` with a
    carried accumulator (``acc=``, ``raw=True``): int32 sums are exact
    in any order, so a chain of per-block calls through one carry is
    bitwise one call over all rows.  Slots whose id is -1 collect the
    rows whose hist leaf is -1 (padding and bagged-out rows), as in
    K1."""
    B = bin_stride(max_bins)
    acc = _check_active_inputs(bins_t, vals, hist_leaf, active, acc, B,
                               torch.int8, torch.int32)
    G, n_pad = bins_t.shape
    C, A, L = vals.shape[0], active.shape[0], num_leaf_slots
    dev = bins_t.device
    inv, src = slot_tables(active, L, collect_unbagged=True)
    if dev.type == "cpu":
        hist_active_raw.plain_calls += 1
        return acc.add_(hist_plain(bins_t, vals, hist_leaf, inv, src, B))
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    from .cuda_build import check_launch, multiprocessor_count
    _check_vector_rows(n_pad, bins_t, vals, hist_leaf, acc)
    plan = hist_plan(n_pad, G, A, B, C, multiprocessor_count(dev), L, False)
    code = hist_launcher("hist_active", bins_t, vals, hist_leaf, inv, src, L,
                         B, plan, hist_slab(plan, A, G, B, C, dev), acc)()
    check_launch(code, "hist_active")
    hist_active_raw.launches += 1
    return acc


hist_active_raw.launches = 0
hist_active_raw.plain_calls = 0


# The float K5 sums each cell in a fixed order, so its result does not
# depend on how rows are split into blocks: rows are cut into chunks of
# FLOAT_CHUNK (a divisor of the streamed block granularity, 8,192 rows),
# each chunk's partial sums its rows in row order from +0.0, and the
# partials are added into the carry in chunk order.
FLOAT_CHUNK = 2048
FLOAT_LANES = 32        # columns per block of the partial kernel, one a lane
FLOAT_MAX_WARPS = 16    # warps per block of the partial kernel


@dataclass(frozen=True)
class FloatPlan:
    """Launch plan of the float K5's partial kernel (``csrc/hist_float.cu``):
    ``warps`` warps per block, ``chp`` sorted positions per staged column
    row, ``smem`` bytes of shared memory per block."""
    warps: int
    chp: int
    smem: int


def float_chp(A: int) -> int:
    """Positions of one staged row of the chunk in sorted order: every
    slot's run starts at a multiple of 4, so at most 3 gaps per slot;
    ``chp % 8 == 4`` puts the 32 column rows on 32 different banks."""
    return -(-(FLOAT_CHUNK + 3 * min(A, FLOAT_CHUNK)) // 8) * 8 + 4


def float_smem_bytes(W: int, A: int, B: int, C: int, chp: int) -> int:
    """Shared memory of one partial block (``float_smem`` in the CUDA
    source): W tiles [B][32] f32, the sort's counters, the chunk's row
    slots, its values (bf16) and its bins, each region 16-byte aligned."""
    def up16(x):
        return -(-x // 16) * 16
    ints = -(-(W * A + 3 * A + 4) // 4) * 4
    return (W * B * FLOAT_LANES * 4 + ints * 4 + up16(FLOAT_CHUNK * 2)
            + up16(C * chp * 2) + FLOAT_LANES * chp)


def float_plan(A: int, B: int, C: int) -> FloatPlan:
    """As many warps (each owns one [B][32] tile) as fit a block."""
    chp = float_chp(A)
    for W in range(FLOAT_MAX_WARPS, 0, -1):
        smem = float_smem_bytes(W, A, B, C, chp)
        if smem <= SMEM_BLOCK_MAX:
            return FloatPlan(W, chp, smem)
    raise ValueError(f"float K5: {A} slots x {B} bins do not fit a block")


def float_scratch(n_pad: int, A: int, G: int, B: int, C: int, device):
    """``(partial [K, A, C, B, G] f32, counts [K, A] int32)``: the chunk
    partials at their worst case (every slot has rows in every chunk) and
    the rows of each (chunk, slot).  Written before they are read: not
    cleared."""
    K = -(-n_pad // FLOAT_CHUNK)
    return (torch.empty((K, A, C, B, G), dtype=torch.float32, device=device),
            torch.empty((K, A), dtype=torch.int32, device=device))


def hist_float_launcher(bins_t, vals, hist_leaf, inv, src, L: int, B: int,
                        plan: FloatPlan, scratch, counts, acc,
                        phase: str = "both"):
    """The float K5 (``phase`` "partial", "fold" or "both") bound to its
    arguments: -> a callable that launches it and returns the CUDA error
    code.  ``scratch`` holds the chunk partials."""
    from .cuda_build import library
    G, n_pad = bins_t.shape
    C = vals.shape[0]
    A = src.shape[0]
    K = counts.shape[0]
    lib = library("hist_float")
    stream = torch.cuda.current_stream(bins_t.device).cuda_stream
    head = (bins_t.data_ptr(), n_pad, G, vals.data_ptr(), C,
            hist_leaf.data_ptr(), L, inv.data_ptr())
    tensors = (bins_t, vals, hist_leaf, inv, src, scratch, counts, acc)
    if phase == "partial":
        return BoundLaunch(lib.lgbm_hist_float_partial,
                           (*head, A, B, FLOAT_CHUNK, plan.chp, plan.warps,
                            scratch.data_ptr(), counts.data_ptr(), stream),
                           tensors)
    if phase == "fold":
        return BoundLaunch(lib.lgbm_hist_float_fold,
                           (scratch.data_ptr(), counts.data_ptr(), K, A, C, B,
                            G, src.data_ptr(), acc.data_ptr(), stream),
                           tensors)
    return BoundLaunch(lib.lgbm_hist_float,
                       (*head, src.data_ptr(), A, B, FLOAT_CHUNK, plan.chp,
                        plan.warps, scratch.data_ptr(), counts.data_ptr(),
                        acc.data_ptr(), stream), tensors)


def hist_float_plain(bins_t, vals, hist_leaf, inv, src, B: int, acc):
    """Plain version of the float K5 in its exact order, into ``acc``.

    Values are rounded to bf16 first (the TPU kernel's operands).  Per
    chunk of ``FLOAT_CHUNK`` rows a 1-D float32 ``index_add_`` on the
    CPU, whose indices run row by row, sums every cell's rows in row
    order from +0.0 (the CPU kernel adds sequentially; the tests hold it
    to a numpy loop); then each output slot adds its accumulation
    slot's partial to the carry, chunk by chunk.  Only CPU tensors: the
    CUDA ``index_add_`` adds with atomics in no fixed order."""
    if bins_t.device.type != "cpu":
        raise ValueError("hist_float_plain runs on CPU tensors only")
    G, n_pad = bins_t.shape
    C = vals.shape[0]
    A = src.shape[0]
    L = inv.shape[0] - 1
    cells = G * B * C
    hl = hist_leaf.long()
    sl = inv.long()[torch.where(hl >= 0, hl, torch.full_like(hl, L))]
    v = vals.to(torch.bfloat16).float()
    gs = torch.arange(G)
    cs = torch.arange(C)
    has = src >= 0
    take = src.long()[has]
    flat = acc.view(A, cells)
    for k0 in range(0, n_pad, FLOAT_CHUNK):
        rows = torch.nonzero(sl[k0:k0 + FLOAT_CHUNK] >= 0)[:, 0] + k0
        part = torch.zeros(A * cells, dtype=torch.float32)
        if rows.numel():
            base = ((sl[rows][:, None] * G + gs[None, :]) * B
                    + bins_t[:, rows].t().long()) * C            # [r, G]
            idx = base[:, :, None] + cs[None, None, :]           # [r, G, C]
            val = v[:, rows].t()[:, None, :].expand(-1, G, -1)
            part.index_add_(0, idx.reshape(-1), val.reshape(-1))
        flat[has] = flat[has] + part.view(A, cells)[take]
    return acc


def hist_active_float_raw(bins_t, vals, hist_leaf, active,
                          num_leaf_slots: int, max_bins: int, acc=None):
    """Wide active-leaf histogram (K5) on float value rows
    (:func:`pack_values`): adds the float32 sums of the bf16-rounded
    values, per (slot, column, bin, value row), into the carry ``acc``
    (``[A, G, B, C]`` f32; zeros when None) in place and returns it.

    Fixed order, no float atomics (see ``FLOAT_CHUNK``): the result does
    not depend on the block size, and a chain of per-block calls whose
    boundaries are multiples of ``FLOAT_CHUNK`` is bitwise one call over
    all rows.  Slots whose id is -1 collect the rows whose hist leaf is
    -1.  The CUDA kernel (``csrc/hist_float.cu``) is bitwise its plain
    version, :func:`hist_float_plain`."""
    B = bin_stride(max_bins)
    acc = _check_active_inputs(bins_t, vals, hist_leaf, active, acc, B,
                               torch.float32, torch.float32)
    G, n_pad = bins_t.shape
    C, A, L = vals.shape[0], active.shape[0], num_leaf_slots
    dev = bins_t.device
    inv, src = slot_tables(active, L, collect_unbagged=True)
    if dev.type == "cpu":
        hist_active_float_raw.plain_calls += 1
        return hist_float_plain(bins_t, vals, hist_leaf, inv, src, B, acc)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    from .cuda_build import check_launch
    _check_vector_rows(n_pad, bins_t, vals, hist_leaf)
    scratch, counts = float_scratch(n_pad, A, G, B, C, dev)
    code = hist_float_launcher(bins_t, vals, hist_leaf, inv, src, L, B,
                               float_plan(A, B, C), scratch, counts, acc)()
    check_launch(code, "hist_float")
    hist_active_float_raw.launches += 1
    return acc


hist_active_float_raw.launches = 0
hist_active_float_raw.plain_calls = 0


# The in-memory float kernels (K1 and K3) run over windows of this many
# rows, chained through the carry, which is bitwise one call (a multiple
# of FLOAT_CHUNK): their scratch follows the window, not the row count.
FLOAT_WINDOW = 1 << 20
# the float K1's launches (csrc/hist_route_float.cu): its partial and
# fold kernels, or one alone for timing them apart
FLOAT_K1_PHASES = {"both": 3, "partial": 1, "fold": 2}
# the float K3 walks at most this many rows per chunk of a window of a
# slot (its first chunks); a larger slot's later chunks become heavy
# pairs (chunk partials, folded after the walk), and a slot with at least
# FLOAT_DENSE_ROWS_PER_CHUNK rows per chunk walks none
FLOAT_LIGHT_ROWS_PER_CHUNK = 16
FLOAT_DENSE_ROWS_PER_CHUNK = 64
# a window's partial scratch holds as many (slot, chunk) pairs as this
# many slots with rows in every chunk; the largest slots take it first
FLOAT_HEAVY_SLOTS = 16
# warps of a block of the heavy-partial kernel (FW_HEAVY_WARPS), and its
# blocks per multiprocessor in the grid-stride launch
FLOAT_HEAVY_WARPS = 4
FLOAT_HEAVY_BLOCKS_PER_SM = 8
# slots a wave of the in-memory float kernels may have (the fill block's
# per-warp counts and the plan block's slot order are in shared memory)
FLOAT_WALK_MAX_SLOTS = 4096
FLOAT_FILL_WARPS = 8     # FW_FILL_THREADS / 32
# each slot's run of sorted positions starts at a multiple of
# FLOAT_WALK_ALIGN; a walking warp loads FLOAT_WALK_BATCH rows at once
FLOAT_WALK_ALIGN = 16
FLOAT_WALK_BATCH = 32
# the float K3's kernels (csrc/hist_float_walk.cuh FW_K_* masks) in one
# window's launch: all of them, or a phase or one kernel alone, for
# timing them apart
FLOAT_WALK_KERNELS = {"count": 1, "scan": 2, "plan": 4, "fill": 8,
                      "heavy": 16, "light": 32, "fold": 64}
FLOAT_WALK_PHASES = {"both": 127, "sort": 15, "walk": 48, "fold": 64,
                     **FLOAT_WALK_KERNELS}


@dataclass(frozen=True)
class FloatWalkPlan:
    """Launch plan of the float K3 (``csrc/hist_float_walk.cuh``) for a
    call: windows of ``window`` rows
    (``chunks`` chunks each), ``pcap`` heavy (slot, chunk) partials per
    window, ``heavy_blocks`` blocks of the grid-stride heavy-partial
    kernel, and the shared memory of each kernel's block."""
    window: int
    chunks: int
    pcap: int
    heavy_blocks: int
    count_smem: int
    plan_smem: int
    fill_smem: int
    heavy_smem: int
    light_smem: int


def float_walk_plan(n_pad: int, A: int, G: int, B: int, C: int, L: int,
                    sms: int) -> FloatWalkPlan:
    """The plan of one call over ``n_pad`` rows; raises where a block
    would not fit its shared memory."""
    if not 1 <= A <= FLOAT_WALK_MAX_SLOTS:
        raise ValueError(f"{A} slots: the float K3 takes "
                         f"1-{FLOAT_WALK_MAX_SLOTS}")
    window = min(n_pad, FLOAT_WINDOW)
    chunks = -(-window // FLOAT_CHUNK)
    pcap = FLOAT_HEAVY_SLOTS * chunks
    ncg = -(-G // FLOAT_LANES)
    heavy_blocks = max(1, min(-(-pcap * C * ncg // FLOAT_HEAVY_WARPS),
                              sms * FLOAT_HEAVY_BLOCKS_PER_SM))
    plan = FloatWalkPlan(
        window, chunks, pcap, heavy_blocks,
        count_smem=A * 4,
        plan_smem=3 * A * 4,
        fill_smem=(((FLOAT_FILL_WARPS + 1) * A + 2 * FLOAT_CHUNK) * 4
                   + FLOAT_LANES * FLOAT_CHUNK),
        heavy_smem=FLOAT_HEAVY_WARPS * B * FLOAT_LANES * 4,
        light_smem=B * FLOAT_LANES * 16)
    for name in ("count_smem", "plan_smem", "fill_smem", "heavy_smem",
                 "light_smem"):
        if getattr(plan, name) > SMEM_BLOCK_MAX:
            raise ValueError(f"float walk: {name} {getattr(plan, name)} B "
                             f"exceeds a block's shared memory ({A} slots, "
                             f"{B} bins, {L} leaves)")
    return plan


def float_walk_rows(rows: int, A: int) -> int:
    """Sorted positions of a window of ``rows`` rows (``fw_rows``): each
    slot's run padded to ``FLOAT_WALK_ALIGN``, then a batch of slack."""
    al = FLOAT_WALK_ALIGN
    return -(-(rows + al * A) // al) * al + FLOAT_WALK_BATCH


def float_light_rows(rows: int) -> int:
    """The rows of a slot the float K3 walks in a window of ``rows``
    rows, at most."""
    return FLOAT_LIGHT_ROWS_PER_CHUNK * -(-rows // FLOAT_CHUNK)


def float_dense_rows(rows: int) -> int:
    """The rows from which a slot of a window of ``rows`` rows walks
    none."""
    return FLOAT_DENSE_ROWS_PER_CHUNK * -(-rows // FLOAT_CHUNK)


def float_walk_split(counts, light_rows: int, dense_rows: int, pcap: int):
    """The plan kernel's split (``fw_plan_kernel``), for the tests and the
    card's check: ``counts[s][k]`` rows of each (slot, chunk) ->
    ``(hbase, lrows, hcount)`` per slot: the slot's first heavy pair in
    the partial scratch (-1: none), the rows its walk takes and its heavy
    pairs.  A slot with more than ``light_rows`` rows keeps its first
    chunks up to that many rows for the walk (none from ``dense_rows``
    rows on) and gives its later chunks with rows to partials, largest
    slots first (ties by slot) while their pairs fit ``pcap``; every
    other slot is walked whole."""
    tot = [sum(int(x) for x in row) for row in counts]
    order = sorted(range(len(counts)), key=lambda s: (-tot[s], s))
    split = []
    for row, t in zip(counts, tot):
        run, k = 0, len(row)
        if t > light_rows:
            k = 0 if t >= dense_rows else max(
                i for i in range(len(row))
                if sum(int(x) for x in row[:i]) <= light_rows)
            run = sum(int(x) for x in row[:k])
        split.append((k, run, sum(1 for x in row[k:] if int(x) > 0)))
    hbase = [-1] * len(counts)
    lrows = list(tot)
    hcount = [0] * len(counts)
    cum = 0
    for s in order:
        k, run, c = split[s]
        if not (c > 0 and cum + c <= pcap):
            break
        hbase[s], lrows[s], hcount[s] = cum, run, c
        cum += c
    return hbase, lrows, hcount


@dataclass
class FloatWalkScratch:
    """One window's device scratch of the float K3, reused by every
    window of a call: ``ints`` int32 (rows, first sorted
    position and chunks with rows before it of each (slot, chunk) ``[3,
    A, Kw]``, the per-slot table ``[6A + 2]``, the heavy pairs
    ``[pcap]``), the window's active
    rows in sorted order, column-major over ``R = float_walk_rows(window,
    A)`` positions (``sbins [G, R]`` uint8, their bins; ``svals [C, R]``
    int32, their bf16 bits with the chunk in the high half) and the heavy
    pairs' chunk partials ``partial [pcap, C, B, G]`` f32.  Every cell
    read is written first (the walks read past a run's end only the rows
    they ignore): not cleared."""
    ints: torch.Tensor
    sbins: torch.Tensor
    svals: torch.Tensor
    partial: torch.Tensor

    @classmethod
    def empty(cls, plan: FloatWalkPlan, A: int, G: int, B: int, C: int,
              device):
        def t(shape, dtype):
            return torch.empty(shape, dtype=dtype, device=device)
        R = float_walk_rows(plan.window, A)
        return cls(t((3 * A * plan.chunks + 6 * A + 2 + plan.pcap,),
                     torch.int32),
                   t((G, R), torch.uint8), t((C, R), torch.int32),
                   t((plan.pcap, C, B, G), torch.float32))

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self.__dict__.values())

    def meta(self, A: int, rows: int):
        """The per-slot table a window of ``rows`` rows left: ``(rows,
        chunks with rows, first sorted position, first heavy pair or -1,
        rows walked, heavy pairs)`` per slot, ``[6, A]``."""
        kw = -(-rows // FLOAT_CHUNK)
        return self.ints[3 * A * kw:3 * A * kw + 6 * A].view(6, A)


def float_walk_launches(bins_t, vals, hist_leaf, inv, src, L: int, B: int,
                        plan: FloatWalkPlan, scratch: FloatWalkScratch, acc,
                        phase: str = "both"):
    """The float K3 (``csrc/hist_compact_float.cu``) over every window of
    ``plan.window`` rows, each bound to its arguments: -> one callable per
    window (it launches the window's ``phase``, a key of
    ``FLOAT_WALK_PHASES``, and returns the CUDA error code)."""
    from .cuda_build import library
    G, n_pad = bins_t.shape
    C = vals.shape[0]
    A = src.shape[0]
    fn = library("hist_compact_float").lgbm_hist_compact_float
    stream = torch.cuda.current_stream(bins_t.device).cuda_stream
    sc = scratch
    tensors = (bins_t, vals, hist_leaf, inv, src, acc, *sc.__dict__.values())
    out = []
    for w0 in range(0, n_pad, plan.window):
        rows = min(plan.window, n_pad - w0)
        out.append(BoundLaunch(fn, (
            bins_t.data_ptr() + w0, n_pad, rows, G, vals.data_ptr() + 4 * w0,
            C, hist_leaf.data_ptr() + 4 * w0, L, inv.data_ptr(),
            src.data_ptr(), A, B, FLOAT_CHUNK, float_light_rows(rows),
            float_dense_rows(rows), plan.pcap, plan.heavy_blocks, FLOAT_WALK_PHASES[phase],
            sc.ints.data_ptr(), sc.sbins.data_ptr(), sc.svals.data_ptr(),
            sc.partial.data_ptr(), acc.data_ptr(), stream), tensors))
    return out


def hist_route_float_launches(bins_t, vals, leaf2, inv, src, L: int, B: int,
                              plan: FloatPlan, scratch, counts, acc,
                              leaf2_out, tabs, cat_mask, phase: str = "both"):
    """The float K1 over every window of ``FLOAT_WINDOW`` rows, each
    bound to its arguments: -> one callable per window (it launches the
    window's ``phase`` of ``FLOAT_K1_PHASES`` and returns the CUDA error
    code).  ``scratch`` and ``counts`` hold one window's chunk
    partials."""
    from .cuda_build import library
    G, n_pad = bins_t.shape
    C = vals.shape[0]
    A = src.shape[0]
    fn = library("hist_route_float").lgbm_hist_route_float
    stream = torch.cuda.current_stream(bins_t.device).cuda_stream
    tensors = (bins_t, vals, leaf2, inv, src, scratch, counts, acc,
               leaf2_out, tabs, cat_mask)
    out = []
    for w0 in range(0, n_pad, FLOAT_WINDOW):
        rows = min(FLOAT_WINDOW, n_pad - w0)
        out.append(BoundLaunch(fn, (
            bins_t.data_ptr() + w0, n_pad, rows, G,
            vals.data_ptr() + 4 * w0, C, leaf2.data_ptr() + 4 * w0,
            leaf2_out.data_ptr() + 4 * w0, tabs.data_ptr(), L,
            cat_mask.data_ptr(), cat_mask.shape[1], inv.data_ptr(),
            src.data_ptr(), A, B, FLOAT_CHUNK, plan.chp, plan.warps,
            FLOAT_K1_PHASES[phase], scratch.data_ptr(), counts.data_ptr(),
            acc.data_ptr(), stream), tensors))
    return out


def hist_route_float_raw(bins_t, vals, leaf2, active, tabs, cat_mask,
                         num_leaf_slots: int, max_bins: int, acc=None):
    """Fused route + active-leaf histogram (K1) on float value rows
    (:func:`pack_values`): apply the per-leaf tables ``tabs`` to
    ``leaf2``, then add the float32 sums of the bf16-rounded values of
    the routed hist leaves' rows, per (slot, column, bin, value row),
    into the carry ``acc`` (``[A, G, B, C]`` f32; zeros when None).
    -> ``(acc, leaf2' [2, n_pad] int32)``.

    The float K5's order (``FLOAT_CHUNK``), so a call is bitwise
    :func:`ops.route.route_rows_raw` followed by
    :func:`hist_active_float_raw` on the routed hist leaves, and an
    in-memory float model is bitwise the streamed one.  Slots whose id
    is -1 collect the rows whose hist leaf is -1 (bagged out; padding
    rows carry zero values), as the TPU kernel's do.  The CUDA kernel
    (``csrc/hist_route_float.cu``: the float K5's partial kernel with the
    route, then a fold with one thread per (slot, value row, bin,
    column)) runs over windows of ``FLOAT_WINDOW`` rows chained through
    the carry and counts one launch per window."""
    G, n_pad = bins_t.shape
    C = vals.shape[0]
    A = active.shape[0]
    L = num_leaf_slots
    B = bin_stride(max_bins)
    dev = bins_t.device
    _check(leaf2, "leaf2", torch.int32, (2, n_pad), dev)
    _check(tabs, "tabs", torch.int32, (tabs.shape[0], L), dev)
    _check(cat_mask, "cat_mask", torch.uint8, (L, cat_mask.shape[1]), dev)
    acc = _check_active_inputs(bins_t, vals, leaf2[1], active, acc, B,
                               torch.float32, torch.float32)
    inv, src = slot_tables(active, L, collect_unbagged=True)
    if dev.type == "cpu":
        hist_route_float_raw.plain_calls += 1
        return hist_route_float_plain(bins_t, vals, leaf2, tabs, cat_mask,
                                      inv, src, B, acc)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    from .cuda_build import check_launch
    _check_vector_rows(n_pad, bins_t, vals, leaf2, acc)
    leaf2_out = torch.empty_like(leaf2)
    scratch, counts = float_scratch(min(n_pad, FLOAT_WINDOW), A, G, B, C,
                                    dev)
    for launch in hist_route_float_launches(
            bins_t, vals, leaf2, inv, src, L, B, float_plan(A, B, C),
            scratch, counts, acc, leaf2_out, tabs, cat_mask):
        check_launch(launch(), "hist_route_float")
        hist_route_float_raw.launches += 1
    return acc, leaf2_out


hist_route_float_raw.launches = 0
hist_route_float_raw.plain_calls = 0


def hist_route_float_plain(bins_t, vals, leaf2, tabs, cat_mask, inv, src,
                           B: int, acc):
    """Plain version of :func:`hist_route_float_raw` (CPU tensors only):
    the plain route, then the float K5's plain version on the routed
    hist leaves, into ``acc``."""
    from .route import route_plain
    leaf2_new = route_plain(bins_t, leaf2, tabs, cat_mask)
    return (hist_float_plain(bins_t, vals, leaf2_new[1], inv, src, B, acc),
            leaf2_new)


def wide_cells(bins_t, hist_leaf, active, n: int, num_leaf_slots: int,
               B: int):
    """The wide histogram's scatter plan: -> ``(rows, idx)``, the real
    rows whose hist leaf has a slot, in row order, and for each of them
    and each group (row-major, ``[rows x G]`` flattened) its cell in the
    flat ``[A * G * B]`` grid."""
    G = bins_t.shape[0]
    L = num_leaf_slots
    inv = slot_tables(active, L, collect_unbagged=False)[0]
    hl = hist_leaf[:n].long()
    slot = torch.where((hl >= 0) & (hl < L), inv[hl.clamp(0, L)].long(),
                       torch.full_like(hl, -1))
    rows = torch.nonzero(slot >= 0)[:, 0]
    idx = ((slot[rows][:, None] * G
            + torch.arange(G, device=bins_t.device)[None, :]) * B
           + bins_t[:, rows].t().long()).reshape(-1)
    return rows, idx


def hist_wide_plain(bins_t, grad, hess, hist_leaf, active,
                    num_leaf_slots: int, B: int, acc=None) -> torch.Tensor:
    """Plain version of :func:`hist_wide_raw`, the reference's XLA
    scatter oracle (``hist_active_scatter``) on the transposed bins: one
    sequential ``index_add_`` per value column over the rows in row order
    (on the CPU it adds in index order, as the XLA scatter does).  With
    ``acc`` the adds start from its cells and land in it in place (the
    reference stream's seeded scatter, ``acc.at[idx].add(vals)``)."""
    G = bins_t.shape[0]
    A = active.shape[0]
    rows, idx = wide_cells(bins_t, hist_leaf, active, grad.shape[0],
                           num_leaf_slots, B)
    if acc is None:
        out = torch.zeros((3, A * G * B), dtype=torch.float32,
                          device=bins_t.device)
    else:
        out = acc.reshape(A * G * B, 3).t().contiguous()
    for c, v in enumerate((grad, hess, torch.ones_like(grad))):
        out[c].index_add_(0, idx, v[rows].float()[:, None]
                          .expand(-1, G).reshape(-1))
    out = out.t().reshape(A, G, B, 3)
    if acc is None:
        return out.contiguous()
    return acc.copy_(out)


def hist_wide_raw(bins_t, grad, hess, hist_leaf, active, num_leaf_slots: int,
                  max_bins: int, acc=None) -> torch.Tensor:
    """Exact-f32 histogram ``[A, G, B, 3]`` of ``(grad, hess, 1)`` over the
    rows whose hist leaf is in ``active`` (the reference's
    ``hist_active_scatter``): uint8 or int32 ``bins_t [G, n_pad]``,
    ``grad``/``hess`` f32 over the ``n`` real rows, ``hist_leaf [n_pad]``
    int32 (-1: no slot), at any number of slots and any bin stride.
    Each cell is the row-order sum of its rows from +0.0, on the card as
    in the plain version (``csrc/hist_wide.cu``); slots whose id is -1
    stay zero.  One count per call (a slot sort, a plan, a zero pass and
    the walk).

    Seeded (``acc``, an ``[A, G, B, 3]`` f32 carry, contiguous on the
    bins' device): the rows add into ``acc`` in place, each cell's sum
    starting at its value, ``(((seed + r1) + r2) + ...)``; a count starts
    at its seed (an integer-valued float of at most 2^24, as a carry
    holds) and ends at ``min(seed + k, 2^24)``; slots with no row in this
    call (id -1 included) keep their seed.  -> ``acc``.  The seeded
    kernel counts into :data:`HIST_WIDE_SEEDED`, the unseeded one into
    ``hist_wide_raw.launches``."""
    B = bin_stride(max_bins)
    G, n_pad = bins_t.shape
    n = grad.shape[0]
    A = active.shape[0]
    L = num_leaf_slots
    dev = bins_t.device
    if bins_t.dtype not in (torch.uint8, torch.int32):
        raise TypeError(f"bins_t: expected uint8 or int32, got "
                        f"{bins_t.dtype}")
    _check(grad, "grad", torch.float32, (n,), dev)
    _check(hess, "hess", torch.float32, (n,), dev)
    _check(hist_leaf, "hist_leaf", torch.int32, (n_pad,), dev)
    _check(active, "active", torch.int32, (A,), dev)
    if acc is not None:
        _check(acc, "acc", torch.float32, (A, G, B, 3), dev)
    if A < 1 or n > n_pad:
        raise ValueError(f"hist_wide: {A} slots, {n} rows of {n_pad}")
    count = hist_wide_raw if acc is None else HIST_WIDE_SEEDED
    name = "hist_wide" if acc is None else "hist_wide_seeded"

    def cost(_):
        r = slotted_rows(slot_tables(active, L, collect_unbagged=False)[0],
                         hist_leaf, L)
        return hist_wide_cost(bins_t, A, B, r, acc is not None)
    if dev.type == "cpu":
        count.plain_calls += 1
        return profiler.launch(name, lambda: hist_wide_plain(
            bins_t, grad, hess, hist_leaf, active, L, B, acc), cost)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    from .cuda_build import check_launch
    inv = slot_tables(active, L, collect_unbagged=False)[0]
    out = (torch.empty((A, G, B, 3), dtype=torch.float32, device=dev)
           if acc is None else acc)
    check_launch(profiler.launch(name, lambda: hist_wide_launch(
        bins_t, grad, hess, hist_leaf, inv, L, B, out,
        seeded=acc is not None), cost), "hist_wide")
    count.launches += 1
    return out


hist_wide_raw.launches = 0
hist_wide_raw.plain_calls = 0
HIST_WIDE_SEEDED = LaunchCount("hist_wide_seeded")


def hist_wide_scratch_bytes(n: int, G: int, A: int, B: int) -> int:
    """Bytes of device scratch the wide histogram's kernels take for one
    wave of ``n`` rows, ``G`` columns, ``A`` slots and a ``B``-bin stride,
    as the kernel counts them (builds its library on first use)."""
    from .cuda_build import library
    return 256 * library("hist_wide").lgbm_hist_wide_scratch(n, G, A, B)


def hist_wide_launch(bins_t, grad, hess, hist_leaf, inv, L: int, B: int,
                     out, seeded: bool = False) -> int:
    """Launch the wide histogram's kernels into ``out [A, G, B, 3]`` on the
    current stream (``inv``: the leaves' slots, :func:`slot_tables`;
    ``seeded``: add into ``out``'s values), with the scratch the kernel
    asks for allocated here: -> the CUDA error code (0: launched)."""
    from .cuda_build import library
    G, n_pad = bins_t.shape
    n, A, dev = grad.shape[0], out.shape[0], bins_t.device
    scratch = torch.empty(hist_wide_scratch_bytes(n, G, A, B),
                          dtype=torch.uint8, device=dev)
    lib = library("hist_wide")
    entry = lib.lgbm_hist_wide_seeded if seeded else lib.lgbm_hist_wide
    return entry(
        bins_t.data_ptr(), int(bins_t.dtype == torch.int32), n_pad, n, G,
        grad.data_ptr(), hess.data_ptr(), hist_leaf.data_ptr(),
        inv.data_ptr(), L, A, B, scratch.data_ptr(), out.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)


SUM_BLOCK = 32


def fixed_sum(x: torch.Tensor, dim: int, base: int = SUM_BLOCK
              ) -> torch.Tensor:
    """Sum over ``dim`` in the reference's compiled order on the CPU:
    sequential from 0.0 within blocks of ``base``, then the block totals
    the same way (``torch.sum`` adds in another order).  The length is a
    bin stride: a power of two, so at most ``base`` or a multiple of
    it."""
    x = x.movedim(dim, -1)
    n = x.shape[-1]
    if n <= base:
        acc = torch.zeros_like(x[..., 0])
        for i in range(n):
            acc = acc + x[..., i]
        return acc
    blk = x.reshape(x.shape[:-1] + (n // base, base))
    return fixed_sum(fixed_sum(blk, -1, base), -1, base)


def unbundle_grid(grid, leaf_sum_grad, leaf_sum_hess, leaf_count,
                  feat_group, feat_offset, num_bins, default_bins,
                  out_stride: int):
    """Expand EFB group-column histograms ``[A, G, Bg, 3]`` into
    per-feature grids ``[A, F, B, 3]`` (port of the reference's
    ``unbundle_grid``): a bundled feature's shared default cell is
    rebuilt from the leaf totals by subtraction (``FixHistogram``), the
    other cells summed in the reference's order (:func:`fixed_sum`)."""
    A, G, Bg, _ = grid.shape
    B = out_stride
    dev = grid.device
    b = torch.arange(B, dtype=torch.int32, device=dev)[None, :]
    off = feat_offset[:, None]
    db = default_bins[:, None]
    nb = num_bins[:, None]
    ident = off < 0
    src = torch.where(ident, b, off + b - (b > db).int())
    valid = (b < nb) & (ident | (b != db))
    src = src.clamp(0, Bg - 1)
    idx = (feat_group[:, None] * Bg + src).long()
    flat = grid.reshape(A, G * Bg, 3)
    out = flat[:, idx]
    out = torch.where(valid[None, :, :, None], out, torch.zeros_like(out))
    sums = fixed_sum(out, 2)
    totals = torch.stack([leaf_sum_grad, leaf_sum_hess, leaf_count],
                         dim=-1)[:, None, :]
    fix = totals - sums
    at_default = ((b == db) & ~ident)[None, :, :, None]
    return torch.where(at_default, out + fix[:, :, None, :], out)
