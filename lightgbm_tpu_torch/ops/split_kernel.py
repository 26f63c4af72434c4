"""Fused numerical split scan — one kernel launch per wave (K6).

Counterpart of the JAX package's ``ops/pallas_split.py``
(``find_best_splits_pallas`` and its ``_split_kernel``).  On a wave's
changed-leaf grids ``[L2, F, B, 3]`` it computes the whole numerical
scan — both missing-direction variants, the constraints and the joint
(feature, bin, direction) argmax — and packs each leaf's winner as one
row ``(gain, feature, bin, default_left, lg, lh, lc, 0)``; the torch
epilogue of :func:`find_best_splits_kernel` turns the rows into a
:class:`~.split.SplitResult`.

Semantics (reference ``feature_histogram.hpp:312-452``, as the Pallas
kernel computes them):

* prefix sums over the bins of each feature give the left-side sums per
  threshold; they run as ``log2(B)`` Hillis-Steele steps
  ``x + (lane >= k ? x[lane - k] : 0.0)`` — the reference kernel's
  masked-roll order (``pallas_split.py:_seg_cumsum``), not the block-of-16
  order of :func:`.split.prefix_sum`;
* the missing cell (the NaN bin, or the zero bin of a MissingType::Zero
  feature) is left out of the scan; its total (a suffix scan in the same
  step order, ``_seg_suffix``) is added to every left side in the
  "missing left" variant;
* constraints: ``min_data_in_leaf`` and ``min_sum_hessian_in_leaf +
  kEpsilon`` on both sides, thresholds below ``num_bins - 1`` (``- 2``
  with a NaN bin), no split on the zero-missing cell, variant 1 only
  where the feature has a missing type, the feature mask;
* ties: variant 1 only where its gain is strictly higher, then the
  lowest ``feature * B + bin``.

:func:`split_scan_plain` is the plain PyTorch version the CPU runs; on a
CUDA tensor :func:`find_best_splits_kernel` launches ``csrc/split.cu``
or raises.  The kernel runs one block per leaf and one warp per feature
(``32 / B`` features a warp below 32 bins), each lane holding ``B / 32``
consecutive bins in registers; its scan steps are the same Hillis-Steele
steps, so the result is bitwise this plain version's.  The reference's TPU layout conditions (lane alignment of
``F*B``, the VMEM leaf tile, the per-call lane cap and its feature
chunking) change no result and have no counterpart here, nor does its
kill switch: a build or launch failure raises.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..io.binning import MISSING_NAN, MISSING_ZERO
from .histogram import _check
from .split import (K_EPSILON, K_MIN_SCORE, SplitParams, SplitResult,
                    leaf_output, leaf_split_gain)

# the reference sends datasets of at most this many rows to its fused
# split kernel (its compile-lean row threshold)
SPLIT_KERNEL_MAX_ROWS = 65536
SPLIT_MAX_BINS = 256       # the widest bin stride the kernel takes
SPLIT_THREADS = 1024       # most threads per block (a warp per feature)
PACKED = 8                 # floats per packed winner row


def _stride_ok(B: int) -> bool:
    """A bin stride the kernel takes: a power of two <= ``SPLIT_MAX_BINS``."""
    return 1 <= B <= SPLIT_MAX_BINS and not B & (B - 1)


def split_kernel_ok(num_features: int, B: int, has_categorical: bool,
                    num_rows: int) -> bool:
    """Whether the wave's split scan runs on the fused kernel: numerical
    features only, a power-of-two bin stride of at most 256, and at most
    ``SPLIT_KERNEL_MAX_ROWS`` rows (the reference's choice of scan)."""
    return (not has_categorical and num_features >= 1 and _stride_ok(B)
            and num_rows <= SPLIT_KERNEL_MAX_ROWS)


def split_masks(num_bins, missing_types, default_bins, feature_mask,
                B: int):
    """Per-cell masks ``[F, B]`` bool: ``(scanned, missing cell,
    threshold ok, feature has a missing cell, feature mask)``."""
    b = torch.arange(B, device=num_bins.device)[None, :]
    nb = num_bins.long()[:, None]
    has_nan = (missing_types == MISSING_NAN)[:, None]
    is_zero = (missing_types == MISSING_ZERO)[:, None]
    missb = torch.where(has_nan, nb - 1,
                        torch.where(is_zero, default_bins.long()[:, None],
                                    torch.full_like(nb, -1)))
    valid = b < nb
    miss = (b == missb) & valid
    max_t = torch.where(has_nan, nb - 2, nb - 1)
    ok_base = (b < max_t) & ~(miss & is_zero)
    hasmiss = (missb >= 0).expand(-1, B)
    fm = (torch.ones_like(valid) if feature_mask is None
          else feature_mask.bool()[:, None].expand(-1, B))
    return valid & ~miss, miss, ok_base, hasmiss, fm


def _shift(x: torch.Tensor, k: int) -> torch.Tensor:
    """``x[..., j - k]`` for ``j >= k``, else ``+0.0`` (within the bin
    axis)."""
    z = torch.zeros(x.shape[:-1] + (k,), dtype=x.dtype, device=x.device)
    return torch.cat([z, x[..., :-k]], -1)


def _unshift(x: torch.Tensor, k: int) -> torch.Tensor:
    """``x[..., j + k]`` for ``j < B - k``, else ``+0.0``."""
    z = torch.zeros(x.shape[:-1] + (k,), dtype=x.dtype, device=x.device)
    return torch.cat([x[..., k:], z], -1)


def seg_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum over the last axis in Hillis-Steele steps
    (the reference kernel's ``_seg_cumsum`` order, bitwise)."""
    B = x.shape[-1]
    k = 1
    while k < B:
        x = x + _shift(x, k)
        k *= 2
    return x


def seg_suffix(x: torch.Tensor) -> torch.Tensor:
    """Inclusive suffix sum in the same step order (``_seg_suffix``)."""
    B = x.shape[-1]
    k = 1
    while k < B:
        x = x + _unshift(x, k)
        k *= 2
    return x


def _f32(v, dev) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32, device=dev)


def split_hyper(params: SplitParams):
    """The kernel's float32 hyper-parameters ``(l1, l2, min_data,
    min_hessian + kEpsilon)`` as Python floats rounded to float32."""
    vals = (params.lambda_l1, params.lambda_l2,
            params.min_data_in_leaf * 1.0,
            params.min_sum_hessian_in_leaf + K_EPSILON)
    return tuple(float(torch.tensor(v, dtype=torch.float32)) for v in vals)


def split_scan_plain(grid, leaf_sum_grad, leaf_sum_hess, leaf_count,
                     num_bins, missing_types, default_bins, feature_mask,
                     hyper, any_missing: bool) -> torch.Tensor:
    """Plain version of the K6 kernel: ``[L2, F, B, 3]`` grids ->
    packed winners ``[L2, 8]`` float32, in the reference kernel's
    arithmetic order."""
    L2, F, B, _ = grid.shape
    dev = grid.device
    vmask, miss, ok_base, hasmiss, fm = split_masks(
        num_bins, missing_types, default_bins, feature_mask, B)
    l1, l2, min_d, min_he = (_f32(v, dev) for v in hyper)
    ghc = grid.permute(3, 0, 1, 2).float()                 # [3, L2, F, B]
    # masks multiply (not select) so signed zeros follow the reference
    cl0 = seg_cumsum(ghc * vmask.float())
    tg = leaf_sum_grad.float()[:, None, None]
    th = leaf_sum_hess.float()[:, None, None]
    tc = leaf_count.float()[:, None, None]
    min_score = _f32(K_MIN_SCORE, dev)

    def gain_of(g, h):
        t = torch.sign(g) * torch.clamp(g.abs() - l1, min=0.0)
        return t * t / (h + l2)

    def variant(cl, extra_ok):
        lg, lh, lc = cl[0], cl[1], cl[2]
        rg, rh, rc = tg - lg, th - lh, tc - lc
        ok = ((lc >= min_d) & (rc >= min_d) & (lh >= min_he)
              & (rh >= min_he) & ok_base & fm & extra_ok)
        return torch.where(ok, gain_of(lg, lh) + gain_of(rg, rh),
                           min_score), lg, lh, lc

    g0, lg, lh, lc = variant(cl0, True)
    var = torch.zeros_like(g0)
    gv = g0
    if any_missing:
        sfx = seg_suffix(ghc * miss.float())
        mb = seg_cumsum(torch.cat([sfx[..., :1],
                                   torch.zeros_like(sfx[..., 1:])], -1))
        g1, lg1, lh1, lc1 = variant(cl0 + mb, hasmiss)
        use1 = g1 > g0
        gv = torch.where(use1, g1, g0)
        lg = torch.where(use1, lg1, lg)
        lh = torch.where(use1, lh1, lh)
        lc = torch.where(use1, lc1, lc)
        var = use1.float()
    gv = gv.reshape(L2, F * B)
    best = gv.max(dim=1).values
    # first lane of the maximum (the reference's min-lane reduction)
    idx = torch.argmax(gv, dim=1)

    def pick(x):        # one-hot sum in the reference: x + 0.0
        return x.reshape(L2, F * B).gather(1, idx[:, None])[:, 0] + 0.0

    out = torch.zeros((L2, PACKED), dtype=torch.float32, device=dev)
    out[:, 0] = best
    out[:, 1] = torch.div(idx, B, rounding_mode="floor").float()
    out[:, 2] = (idx % B).float()
    out[:, 3] = pick(var)
    out[:, 4] = pick(lg)
    out[:, 5] = pick(lh)
    out[:, 6] = pick(lc)
    return out


def split_scan_launch(lib, grid, lsg, lsh, lc, num_bins, missing_types,
                      default_bins, fmask_u8, hyper, any_missing: bool,
                      out: torch.Tensor, threads: int = SPLIT_THREADS) -> int:
    """One launch of ``lgbm_split_scan`` into ``out`` on torch's current
    stream, with blocks of at most ``threads`` threads; -> its CUDA error
    code (0 on success)."""
    L2, F, B, _ = grid.shape
    return lib.lgbm_split_scan(
        grid.data_ptr(), L2, F, B, lsg.data_ptr(), lsh.data_ptr(),
        lc.data_ptr(), num_bins.data_ptr(), missing_types.data_ptr(),
        default_bins.data_ptr(), fmask_u8.data_ptr(), *hyper,
        int(any_missing), out.data_ptr(), threads,
        torch.cuda.current_stream(grid.device).cuda_stream)


def find_best_splits_kernel(grid, leaf_sum_grad, leaf_sum_hess, leaf_count,
                            num_bins, missing_types, default_bins, *,
                            params: SplitParams,
                            feature_mask: Optional[torch.Tensor] = None,
                            any_missing: bool = True) -> SplitResult:
    """Drop-in for :func:`.split.find_best_splits` on the numerical path
    (the counterpart of ``find_best_splits_pallas``): the fused scan on a
    ``[L2, F, B, 3]`` grid, then the reference's epilogue."""
    L2, F, B, _ = grid.shape
    dev = grid.device
    if not _stride_ok(B):
        raise ValueError(f"split kernel: bin stride {B} is not a power of "
                         f"two <= {SPLIT_MAX_BINS}")
    hyper = split_hyper(params)
    if dev.type == "cpu":
        find_best_splits_kernel.plain_calls += 1
        out = split_scan_plain(grid, leaf_sum_grad, leaf_sum_hess,
                               leaf_count, num_bins, missing_types,
                               default_bins, feature_mask, hyper,
                               any_missing)
    elif dev.type == "cuda":
        from .cuda_build import check_launch, library
        i32 = torch.int32
        _check(grid, "grid", torch.float32, (L2, F, B, 3), dev)
        for name, t in (("leaf_sum_grad", leaf_sum_grad),
                        ("leaf_sum_hess", leaf_sum_hess),
                        ("leaf_count", leaf_count)):
            _check(t, name, torch.float32, (L2,), dev)
        for name, t in (("num_bins", num_bins),
                        ("missing_types", missing_types),
                        ("default_bins", default_bins)):
            _check(t, name, i32, (F,), dev)
        fmask = (torch.ones(F, dtype=torch.uint8, device=dev)
                 if feature_mask is None
                 else feature_mask.to(torch.uint8).contiguous())
        _check(fmask, "feature_mask", torch.uint8, (F,), dev)
        out = torch.empty((L2, PACKED), dtype=torch.float32, device=dev)
        code = split_scan_launch(library("split"), grid, leaf_sum_grad,
                                 leaf_sum_hess, leaf_count, num_bins,
                                 missing_types, default_bins, fmask, hyper,
                                 any_missing, out)
        check_launch(code, "split_scan")
        find_best_splits_kernel.launches += 1
    else:
        raise ValueError(f"unsupported device {dev}")
    return split_epilogue(out, leaf_sum_grad, leaf_sum_hess, leaf_count,
                          params, B)


find_best_splits_kernel.launches = 0
find_best_splits_kernel.plain_calls = 0


def split_epilogue(out, leaf_sum_grad, leaf_sum_hess, leaf_count,
                   params: SplitParams, B: int) -> SplitResult:
    """Packed winners -> :class:`SplitResult` (``pallas_split.py:344-364``):
    gain over the parent, right sides by subtraction, leaf outputs."""
    L2 = out.shape[0]
    dev = out.device
    l1, l2 = params.lambda_l1, params.lambda_l2
    gain_shift = (leaf_split_gain(leaf_sum_grad, leaf_sum_hess, l1, l2)
                  + params.min_gain_to_split)
    b_lg, b_lh, b_lc = out[:, 4], out[:, 5], out[:, 6]
    b_rg = leaf_sum_grad - b_lg
    b_rh = leaf_sum_hess - b_lh
    b_rc = leaf_count - b_lc
    return SplitResult(
        gain=(out[:, 0] - gain_shift).float(),
        feature=out[:, 1].to(torch.int32),
        threshold=out[:, 2].to(torch.int32),
        default_left=out[:, 3] > 0.5,
        is_categorical=torch.zeros(L2, dtype=torch.bool, device=dev),
        cat_mask=torch.zeros((L2, B), dtype=torch.bool, device=dev),
        left_sum_grad=b_lg, left_sum_hess=b_lh, left_count=b_lc,
        right_sum_grad=b_rg, right_sum_hess=b_rh, right_count=b_rc,
        left_output=leaf_output(b_lg, b_lh, l1, l2),
        right_output=leaf_output(b_rg, b_rh, l1, l2))
