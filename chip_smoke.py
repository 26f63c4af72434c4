#!/usr/bin/env python3
"""Smoke run of lightgbm_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each ends in ``torch.cuda.synchronize()``; any failure raises
and the script exits non-zero):

1. build — compile the CUDA kernels from ``lightgbm_tpu_torch/csrc``
   (one ``nvcc`` per source, in parallel) into
   ``lightgbm_tpu_torch/_build/``;
2. kernels — at the headline shapes (1,000,000 rows x 28 columns,
   63 bins, 255 leaves, int8h values) run each kernel and its plain
   PyTorch version on the same CUDA inputs, at every wave width the
   headline tree uses, and require bitwise equality; time kernel, plain
   version and (where one exists) a single PyTorch library call;
3. slice — ``lgb.train`` of the headline binary GBDT (the bench's
   synthetic 1M x 28 set, 255 leaves, max_bin 63, lr 0.1,
   min_data_in_leaf 20) with every kernel launch counter reset first;
   require every kernel to have launched, train AUC >= 0.93 and finite
   predictions.  Its ms/iter is the wall of the whole ``lgb.train``
   call, the Booster's setup (upload, objective init) included.

The last lines are the kernel table as one JSON object, the card's name
and power limit, and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

HEADLINE_ROWS = 1_000_000
HEADLINE_FEATURES = 28
HEADLINE_ITERS = 32
AUC_GATE = 0.93
# memory rate of one H100 SXM (NVIDIA data sheet)
PEAK_BYTES_PER_S = 3.35e12
# 32-bit integer adds per clock per SM at compute capability 9.0 (CUDA C++
# Programming Guide, throughput of native arithmetic instructions).  The
# kernels' work is integer: compares in routing, shared-memory atomic adds
# in the histograms.  No shared-atomic rate is published, so each atomic
# counts as one int32 add and the bound is a lower one.
INT32_ADDS_PER_CLOCK_PER_SM = 64


def log(msg: str) -> None:
    print(msg, flush=True)


def _smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    return out[0].strip()


def card_line() -> str:
    return _smi("name,power.limit")


def int32_ops_per_s(sms: int) -> float:
    """The card's int32 add rate: SMs x adds per clock x max SM clock."""
    mhz = float(_smi("clocks.max.sm").split()[0])
    return sms * INT32_ADDS_PER_CLOCK_PER_SM * mhz * 1e6


def headline_data(seed: int = 0):
    """The bench's synthetic binary set (bench.py synthetic_leg)."""
    import numpy as np
    rng = np.random.RandomState(seed)
    X = rng.normal(size=(HEADLINE_ROWS, HEADLINE_FEATURES)).astype(
        np.float32)
    y = (X[:, 0] * 2 + X[:, 1] - X[:, 2]
         + rng.normal(scale=1.0, size=HEADLINE_ROWS) > 0).astype(np.float32)
    return X, y


def time_ms(fn, reps: int, warm: int = 2) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back calls."""
    import torch
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(nbytes: float, int_ops: float, int_rate: float) -> dict:
    """The least time for ``nbytes`` of traffic and ``int_ops`` int32
    adds: the larger of the two, with both parts."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = int_ops / int_rate * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bytes_bound_ms=t_bytes, ops_bound_ms=t_ops)


def wave_inputs(dd, nl: int, n_sel: int, A: int, gen, L: int = 255):
    """A mid-tree wave at the headline shapes: rows spread over ``nl``
    leaves, ``n_sel`` of them split by random numerical tables, ``A``
    active slots (two of them -1 padding when A >= 16)."""
    import torch
    from lightgbm_tpu_torch.ops.histogram import bin_stride
    from lightgbm_tpu_torch.ops.route import leaf_tables
    dev = dd.device
    n, n_pad = dd.num_data, dd.n_pad
    F = dd.num_features
    leaf2 = torch.full((2, n_pad), -1, dtype=torch.int32, device=dev)
    leaf2[0, :n] = torch.randint(0, nl, (n,), generator=gen,
                                 device=dev).int()
    leaf2[1] = leaf2[0]
    sel = torch.zeros(L, dtype=torch.bool, device=dev)
    sel[torch.randperm(nl, generator=gen, device=dev)[:n_sel]] = True
    rank = torch.cumsum(sel.int(), 0) - 1
    new_id = torch.where(sel, nl + rank, 0).int()
    feature = torch.randint(0, F, (L,), generator=gen, device=dev).int()
    threshold = torch.randint(0, dd.max_bins - 1, (L,), generator=gen,
                              device=dev).int()
    B = bin_stride(dd.max_bins)
    tabs, cat = leaf_tables(
        feature, threshold, torch.zeros(L, dtype=torch.bool, device=dev),
        torch.zeros(L, dtype=torch.bool, device=dev),
        torch.zeros((L, B), dtype=torch.bool, device=dev), sel, new_id,
        dd.missing_types, dd.nan_bins, dd.default_bins, dd.feat_group,
        dd.feat_offset, dd.num_bins)
    live = nl + n_sel
    active = torch.randperm(live, generator=gen, device=dev)[:A].int()
    if A >= 16:
        active[-2:] = -1
    return leaf2, tabs, cat, active.contiguous()


def kernel_phase(dd, vals, entries):
    """Kernel vs plain version at the headline shapes (bitwise), with
    times and bounds; appends one dict per kernel to ``entries``."""
    import torch
    from lightgbm_tpu_torch.ops import cuda_build
    from lightgbm_tpu_torch.ops.compact import hist_compact_raw
    from lightgbm_tpu_torch.ops.histogram import (
        HIST_BLOCK, bin_stride, hist_launch_shape, hist_plain,
        hist_route_plain, hist_route_raw, slot_tables)
    from lightgbm_tpu_torch.ops.route import (
        ROUTE_BLOCK, _route_grid, route_plain, route_rows_raw,
        route_rows_values_raw, route_values_plain)
    dev = dd.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    sms = cuda_build.multiprocessor_count(dev)
    int_rate = int32_ops_per_s(sms)
    log(f"int32 add rate {int_rate:.4g}/s ({sms} SMs)")
    G, n_pad = dd.bins_t.shape
    C = vals.shape[0]
    L = 255
    B = bin_stride(dd.group_max_bins)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    tab_bytes = 11 * L * 4 + L * B

    # -- K2 / K4: route and route-values at the 128-slot tail state ------
    leaf2, tabs, cat, _ = wave_inputs(dd, 127, 64, 128, gen)
    out = route_rows_raw(dd.bins_t, leaf2, tabs, cat)
    ref = route_plain(dd.bins_t, leaf2, tabs, cat)
    torch.cuda.synchronize()
    if not torch.equal(out, ref):
        raise AssertionError("route kernel != plain version")
    lv = torch.randn(L, generator=gen, device=dev)
    out2, v2 = route_rows_values_raw(dd.bins_t, leaf2, tabs, cat, lv)
    ref2, rv2 = route_values_plain(dd.bins_t, leaf2, tabs, cat, lv)
    torch.cuda.synchronize()
    if not (torch.equal(out2, ref2) and torch.equal(v2, rv2)):
        raise AssertionError("route-values kernel != plain version")
    lib = cuda_build.library("route")
    grid = _route_grid(n_pad, dev)
    buf = torch.empty_like(leaf2)
    vbuf = torch.empty(n_pad, dtype=torch.float32, device=dev)
    ms2 = time_ms(lambda: lib.lgbm_route_rows(
        dd.bins_t.data_ptr(), n_pad, leaf2.data_ptr(), buf.data_ptr(),
        tabs.data_ptr(), L, cat.data_ptr(), B, grid, ROUTE_BLOCK, stream),
        50)
    ms4 = time_ms(lambda: lib.lgbm_route_rows_values(
        dd.bins_t.data_ptr(), n_pad, leaf2.data_ptr(), buf.data_ptr(),
        tabs.data_ptr(), L, cat.data_ptr(), B, lv.data_ptr(),
        vbuf.data_ptr(), grid, ROUTE_BLOCK, stream), 50)
    plain2 = time_ms(lambda: route_plain(dd.bins_t, leaf2, tabs, cat), 5)
    plain4 = time_ms(lambda: route_values_plain(dd.bins_t, leaf2, tabs, cat,
                                                lv), 5)
    moved_rows = int((tabs[4][leaf2[0].clamp(min=0).long()] != 0).sum())
    b2 = bound(16 * n_pad + moved_rows + tab_bytes, n_pad, int_rate)
    b4 = bound(20 * n_pad + moved_rows + tab_bytes + 4 * L, n_pad,
               int_rate)
    entries.append(dict(
        name="route", route="cuda",
        source="lightgbm_tpu_torch/csrc/route.cu",
        replaces="lightgbm_tpu/ops/pallas_route.py:85",
        max_abs_err=0.0, ms=ms2, plain_ms=plain2, library_ms=None, **b2))
    entries.append(dict(
        name="route_values", route="cuda",
        source="lightgbm_tpu_torch/csrc/route.cu",
        replaces="lightgbm_tpu/ops/pallas_route.py:168",
        max_abs_err=float((v2 - rv2).abs().max()), ms=ms4, plain_ms=plain4,
        library_ms=None, **b4))
    log(f"kernel route: bitwise ok, {ms2:.4f} ms (plain {plain2:.3f} ms, "
        f"bound {b2['bound_ms']:.4f} ms)")
    log(f"kernel route_values: bitwise ok, {ms4:.4f} ms (plain "
        f"{plain4:.3f} ms, bound {b4['bound_ms']:.4f} ms)")

    # -- K1: fused route + histogram at 8, 16, 32 slots ------------------
    lib1 = cuda_build.library("hist_route")
    k1_rows = []
    for A in (8, 16, 32):
        leaf2, tabs, cat, active = wave_inputs(dd, A, A // 2, A, gen)
        raw, l2n = hist_route_raw(dd.bins_t, vals, leaf2, active, tabs, cat,
                                  L, dd.group_max_bins)
        inv, src = slot_tables(active, L, collect_unbagged=True)
        ref_raw, ref_l2 = hist_route_plain(dd.bins_t, vals, leaf2, tabs, cat,
                                           inv, src, B)
        torch.cuda.synchronize()
        if not (torch.equal(raw, ref_raw) and torch.equal(l2n, ref_l2)):
            raise AssertionError(f"hist_route kernel != plain (A={A})")
        As, Ft, gx, rpb = hist_launch_shape(n_pad, G, A, B, C, sms)
        obuf = torch.zeros_like(raw)
        lbuf = torch.empty_like(leaf2)
        ms = time_ms(lambda: lib1.lgbm_hist_route(
            dd.bins_t.data_ptr(), n_pad, G, vals.data_ptr(), C,
            leaf2.data_ptr(), lbuf.data_ptr(), tabs.data_ptr(), L,
            cat.data_ptr(), B, inv.data_ptr(), src.data_ptr(), A, B, Ft, As,
            gx, rpb, HIST_BLOCK, obuf.data_ptr(), stream), 20)
        pl = time_ms(lambda: hist_route_plain(dd.bins_t, vals, leaf2, tabs,
                                              cat, inv, src, B), 3)
        hl = ref_l2[1].long()
        n_active = int((inv.long()[torch.where(hl >= 0, hl, L)] >= 0).sum())
        moved_rows = int((tabs[4][leaf2[0].clamp(min=0).long()] != 0).sum())
        bd = bound(16 * n_pad + moved_rows + (G + C) * n_active
                   + raw.numel() * 4 + tab_bytes + (L + 1 + A) * 4,
                   G * C * n_active, int_rate)
        k1_rows.append(dict(slots=A, ms=ms, plain_ms=pl, library_ms=None,
                            **bd))
        log(f"kernel hist_route A={A}: bitwise ok, {ms:.4f} ms (plain "
            f"{pl:.3f} ms, bound {bd['bound_ms']:.4f} ms by "
            f"{bd['bound_by']}, {n_active} active rows)")
    entries.append(_widest(dict(
        name="hist_route", route="cuda",
        source="lightgbm_tpu_torch/csrc/hist_route.cu",
        replaces="lightgbm_tpu/ops/pallas_histogram.py:637",
        max_abs_err=0.0), k1_rows))

    # -- K3: leaf-compacted histogram at 64 and 128 slots -----------------
    lib3 = cuda_build.library("hist_compact")
    k3_rows = []
    for A in (64, 128):
        leaf2, tabs, cat, active = wave_inputs(dd, 127 if A == 128 else 63,
                                               A - 2, A, gen)
        hleaf = route_plain(dd.bins_t, leaf2, tabs, cat)[1].contiguous()
        raw = hist_compact_raw(dd.bins_t, vals, hleaf, active, L,
                               dd.group_max_bins)
        inv, src = slot_tables(active, L, collect_unbagged=False)
        ref_raw = hist_plain(dd.bins_t, vals, hleaf, inv, src, B)
        torch.cuda.synchronize()
        if not torch.equal(raw, ref_raw):
            raise AssertionError(f"hist_compact kernel != plain (A={A})")
        As, Ft, gx, rpb = hist_launch_shape(n_pad, G, A, B, C, sms)
        obuf = torch.zeros_like(raw)
        ms = time_ms(lambda: lib3.lgbm_hist_compact(
            dd.bins_t.data_ptr(), n_pad, G, vals.data_ptr(), C,
            hleaf.data_ptr(), L, inv.data_ptr(), src.data_ptr(), A, B, Ft,
            As, gx, rpb, HIST_BLOCK, obuf.data_ptr(), stream), 20)
        pl = time_ms(lambda: hist_plain(dd.bins_t, vals, hleaf, inv, src, B),
                     3)
        # the library yardstick: one int32 index_add_ over the active
        # rows' precomputed flat cell indices
        sl = inv.long()[torch.where(hleaf >= 0, hleaf.long(), L)]
        rows = torch.nonzero(sl >= 0)[:, 0]
        n_active = int(rows.numel())
        cells = ((sl[rows][None, :] * G
                  + torch.arange(G, device=dev)[:, None]) * B
                 + dd.bins_t[:, rows].long()) * C           # [G, r]
        idx = (cells[:, :, None]
               + torch.arange(C, device=dev)[None, None, :]).reshape(-1)
        vv = vals[:, rows].int().t()[None].expand(G, -1, -1).reshape(-1)
        vv = vv.contiguous()
        acc = torch.zeros(A * G * B * C, dtype=torch.int32, device=dev)
        lib_ms = time_ms(lambda: acc.index_add_(0, idx, vv), 5)
        bd = bound(4 * n_pad + (G + C) * n_active + raw.numel() * 4
                   + (L + 1 + A) * 4, G * C * n_active, int_rate)
        k3_rows.append(dict(slots=A, ms=ms, plain_ms=pl, library_ms=lib_ms,
                            **bd))
        log(f"kernel hist_compact A={A}: bitwise ok, {ms:.4f} ms (plain "
            f"{pl:.3f} ms, index_add_ {lib_ms:.4f} ms, bound "
            f"{bd['bound_ms']:.4f} ms by {bd['bound_by']}, {n_active} "
            f"active rows)")
    entries.append(_widest(dict(
        name="hist_compact", route="cuda",
        source="lightgbm_tpu_torch/csrc/hist_compact.cu",
        replaces="lightgbm_tpu/ops/compact.py:179", max_abs_err=0.0),
        k3_rows))


def _widest(entry: dict, by_width: list) -> dict:
    """One kernel's entry: the numbers of its widest wave, plus every
    measured wave width under ``by_width``."""
    entry.update({k: v for k, v in by_width[-1].items() if k != "slots"})
    entry["by_width"] = by_width
    return entry


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import numpy as np
    import lightgbm_tpu_torch as lgb
    from lightgbm_tpu_torch.io.device import to_device
    from lightgbm_tpu_torch.metric.metrics import binary_auc
    from lightgbm_tpu_torch.ops import cuda_build
    from lightgbm_tpu_torch.ops.compact import hist_compact_raw
    from lightgbm_tpu_torch.ops.histogram import (hist_route_raw,
                                                  pack_values_q)
    from lightgbm_tpu_torch.ops.route import (route_rows_raw,
                                              route_rows_values_raw)
    card = card_line()
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; {card}")

    # 1. build
    build_s = cuda_build.build_all()
    log(f"build_s {build_s:.2f}")
    torch.cuda.synchronize()

    # 2. kernels at the headline shapes
    t0 = time.time()
    X, y = headline_data()
    ds = lgb.Dataset(X, label=y, params={"max_bin": 63}).construct()
    log(f"headline data + binning {time.time() - t0:.1f} s")
    dd = to_device(ds._constructed, "cuda")
    g = torch.randn(dd.num_data, device="cuda") * 0.5
    h = torch.rand(dd.num_data, device="cuda") * 0.25
    vals, _ = pack_values_q(g, h, "int8h", dd.n_pad)
    entries = []
    kernel_phase(dd, vals, entries)
    torch.cuda.synchronize()

    # 3. the slice: headline training through the user entry points
    counters = {"route": route_rows_raw, "route_values": route_rows_values_raw,
                "hist_route": hist_route_raw, "hist_compact": hist_compact_raw}
    for fn in counters.values():
        fn.launches = 0
    params = {"objective": "binary", "num_leaves": 255, "max_bin": 63,
              "learning_rate": 0.1, "min_data_in_leaf": 20, "verbose": -1}
    torch.cuda.synchronize()
    t0 = time.time()
    bst = lgb.train(params, ds, num_boost_round=HEADLINE_ITERS,
                    device="cuda")
    torch.cuda.synchronize()
    train_s = time.time() - t0
    launches = {k: fn.launches for k, fn in counters.items()}
    pred = bst.predict(X)
    torch.cuda.synchronize()
    auc = binary_auc(y, pred)
    log(f"slice: {bst.current_iteration()} iterations in {train_s:.3f} s = "
        f"{1e3 * train_s / max(1, bst.current_iteration()):.2f} ms/iter "
        f"(setup included); "
        f"train auc {auc:.5f}; launches {launches}; digest "
        f"{bst.digest(include_scores=False)}")
    if pred.shape != (HEADLINE_ROWS,) or not np.isfinite(pred).all():
        raise AssertionError("predictions are not finite [n] values")
    if not auc >= AUC_GATE:
        raise AssertionError(f"train auc {auc} < {AUC_GATE}")
    missing = [k for k, v in launches.items() if v <= 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: "
                             f"{missing}")

    for e in entries:
        e["launches"] = launches[e["name"]]
    print(json.dumps({"kernels": entries}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
