"""Active-leaf histograms: quantized values, the fused route+histogram
kernel (K1) with its plain version, and the helpers both histogram
kernels share.

Counterpart of the JAX package's ``ops/pallas_histogram.py`` (value
packing, dequantization, the scatter oracle, the fused kernel) and
``ops/histogram.py`` (``unbundle_grid``).  The TPU kernels build one-hot
matrices for the MXU because the TPU has no atomics; here the kernels
(``csrc/hist_route.cu``, ``csrc/hist_compact.cu``) add int8 values into
int32 cells with atomics, which is exact in any order, so only the
quantized modes (``int8``, ``int8h``, ``int8hh``) are implemented.

Layout: ``bins_t`` is ``[G, n_pad]`` uint8 (``io/device.py``), ``vals``
``[C, n_pad]`` int8 with padding rows 0, and a raw histogram
``[A, G, B, C]`` int32 with ``B = bin_stride(group max bins)``.

Every wrapper runs its kernel for CUDA tensors and its plain version for
CPU tensors; it counts kernel launches in ``.launches`` and plain calls
in ``.plain_calls``.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .route import leaf_tables

# shared memory a histogram block may hold as int32 cells (one column of
# a 128-slot, 64-bin, 4-value histogram)
HIST_SMEM_BUDGET = 128 * 1024
HIST_BLOCK = 1024


def next_pow2(x: int) -> int:
    return 1 << max(0, (x - 1).bit_length())


def bin_stride(max_bins: int) -> int:
    """Per-column bin stride of the histogram grid."""
    return max(8, next_pow2(max_bins))


QUANTIZED_MODES = ("int8", "int8h", "int8hh")


def is_quantized(mode: str) -> bool:
    return mode in QUANTIZED_MODES


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
                  n_pad: int):
    """Quantized value rows: ``-> (vals int8 [C, n_pad], scales f32 [2])``.

    Port of the JAX package's ``pack_values_q`` in its exact operation
    order: ``x * (127 / scale)`` in float32, round half to even, clip to
    +-127; the ``hilo8`` step ``scale / 127`` is ``scale * (1 / 127)``
    and the residual ``x - hi * step`` one fused multiply-add, as the
    reference's tree build compiles them.
    mode="int8": C=3 ``(g, h, 1)``; "int8h": C=4 ``(g, h_hi, h_lo, 1)``;
    "int8hh": C=5 ``(g_hi, g_lo, h_hi, h_lo, 1)``.
    """
    if not is_quantized(mode):
        raise NotImplementedError(
            f"hist_mode {mode!r}: lightgbm_tpu_torch implements the "
            f"quantized modes {QUANTIZED_MODES} only")
    n = grad.shape[0]
    g = grad.float()
    h = hess.float()
    tiny = torch.tensor(1e-30, dtype=torch.float32, device=g.device)
    sg = torch.maximum(g.abs().max(), tiny)
    sh = torch.maximum(h.abs().max(), tiny)

    def q(x, scale):
        t = x * (127.0 / scale)
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


def hist_launch_shape(n_pad: int, G: int, A: int, B: int, C: int,
                      sms: int):
    """Kernel tiling: ``-> (As, Ft, grid_x, rows_per_block)``: slots and
    columns per block so one tile fits ``HIST_SMEM_BUDGET``, and about two
    blocks per multiprocessor in all."""
    cells = HIST_SMEM_BUDGET // 4 // (B * C)
    if cells >= A:
        As, Ft = A, min(G, cells // A)
    else:
        As, Ft = max(1, cells), 1
    tiles = math.ceil(G / Ft) * math.ceil(A / As)
    gx = max(1, min(math.ceil(n_pad / HIST_BLOCK),
                    math.ceil(2 * sms / tiles)))
    return As, Ft, gx, math.ceil(n_pad / gx)


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
        return hist_route_plain(bins_t, vals, leaf2, tabs, cat_mask, inv,
                                src, B)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    from .cuda_build import check_launch, library, multiprocessor_count
    lib = library("hist_route")
    out = torch.zeros((A, G, B, C), dtype=torch.int32, device=dev)
    leaf2_out = torch.empty_like(leaf2)
    As, Ft, gx, rpb = hist_launch_shape(n_pad, G, A, B, C,
                                        multiprocessor_count(dev))
    code = lib.lgbm_hist_route(
        bins_t.data_ptr(), n_pad, G, vals.data_ptr(), C, leaf2.data_ptr(),
        leaf2_out.data_ptr(), tabs.data_ptr(), L, cat_mask.data_ptr(),
        cat_mask.shape[1], inv.data_ptr(), src.data_ptr(), A, B, Ft, As,
        gx, rpb, HIST_BLOCK, out.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
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
    -> ``(hist [A, G, B, 3] f32, leaf2_new [2, n_pad] int32)``."""
    tabs, cat = leaf_tables(feature, threshold, default_left,
                            is_categorical, cat_mask, sel, new_id,
                            missing_types, nan_bins, default_bins,
                            feat_group, feat_offset, num_bins_arr)
    raw, leaf2_new = hist_route_raw(bins_t, vals, leaf2, active, tabs, cat,
                                    feature.shape[0], max_bins)
    return dequant_hist(raw, scales, mode), leaf2_new


def hist_active_scatter(bins, grad, hess, row_leaf, active, *,
                        max_bins: int, num_leaf_slots: int):
    """Exact-f32 scatter histogram ``-> [A, F, B, 3]`` from ``[n, F]``
    bins (port of the reference's XLA oracle; ``-1`` slots and inactive
    rows add nothing)."""
    n, F = bins.shape
    A = active.shape[0]
    B = bin_stride(max_bins)
    L = num_leaf_slots
    dev = bins.device
    key = torch.where(active >= 0, active, torch.full_like(active, L)).long()
    inv = torch.full((L + 1,), A, dtype=torch.int64, device=dev)
    inv[key] = torch.arange(A, device=dev)
    inv[L] = A
    rl = row_leaf.long()
    slot = torch.where(rl >= 0, inv[rl.clamp(0, L)], torch.full_like(rl, A))
    idx = (slot[:, None] * (F * B)
           + torch.arange(F, device=dev)[None, :] * B + bins.long())
    vals = torch.stack([grad, hess, torch.ones_like(grad)], -1).float()
    hist = torch.zeros(((A + 1) * F * B, 3), dtype=torch.float32,
                       device=dev)
    hist.index_add_(0, idx.reshape(-1),
                    vals[:, None, :].expand(n, F, 3).reshape(-1, 3))
    return hist[:A * F * B].reshape(A, F, B, 3)


def unbundle_grid(grid, leaf_sum_grad, leaf_sum_hess, leaf_count,
                  feat_group, feat_offset, num_bins, default_bins,
                  out_stride: int):
    """Expand EFB group-column histograms ``[A, G, Bg, 3]`` into
    per-feature grids ``[A, F, B, 3]`` (port of the reference's
    ``unbundle_grid``): a bundled feature's shared default cell is
    rebuilt from the leaf totals by subtraction (``FixHistogram``)."""
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
    sums = out.sum(dim=2)
    totals = torch.stack([leaf_sum_grad, leaf_sum_hess, leaf_count],
                         dim=-1)[:, None, :]
    fix = totals - sums
    at_default = ((b == db) & ~ident)[None, :, :, None]
    return torch.where(at_default, out + fix[:, :, None, :], out)
