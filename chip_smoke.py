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
2b. float kernels — at the headline shapes (1,001,472 padded rows, 28
   columns, 64-bin stride, 255 leaves) the float K1 at 8 / 16 / 32 slots
   on hhilo values with bagged-out rows (the -1 slots must collect them),
   at 32 slots on hilo values and on a skewed wave (every row in one
   slot), and the float K3 at 64 / 128 slots on hhilo, at 128 on hilo
   and on a skewed 128-slot wave: each held bitwise (bit patterns) to its
   plain version on CPU copies (only the CPU adds in its fixed order),
   the float K1 also to K2 followed by the float K5 and the float K3 to
   the float K5 on its non-negative slots, on the card; each timed whole
   and in its three phases apart (the sort; the walks: heavy slots'
   chunk partials and light slots' walks; the fold), its choice of heavy
   and light slots on the card held to the host rule; beside K1 that
   composition (its yardstick, with the float K5's partial and fold
   phases apart), the f32 ``index_add_`` over the active rows (the
   library call of both), the bound and, for K1, the float K5's contract
   floor (its chunk partials written and read back);
3. small-data kernels — the same for the small-data path's shapes: the
   fused route+histogram kernel at 65,536 rows, 256 bins and 32 slots
   with bagged-out rows (hist leaf -1) that the -1 slots collect, the
   route-values kernel at 63 leaves and 256 bins, and the fused split
   scan on a ``[64, 28, 256, 3]`` and a ``[64, 28, 64, 3]`` wave;
   the route, route-values and split-scan kernels are also timed as
   launches captured in a CUDA graph (their device time, no host launch
   between two kernels), and the route kernels get a second, sector
   bound: the 32-byte sectors of the bins that the wave's moved rows
   read, counted on the device, as the card reads them;
4. headline path — ``lgb.train`` of the headline binary GBDT (the
   bench's synthetic 1M x 28 set, 255 leaves, max_bin 63, lr 0.1,
   min_data_in_leaf 20) with every kernel launch counter reset first;
   require the route, histogram and route-values kernels to have
   launched and the split scan not (above 65,536 rows the torch scan
   runs), train AUC >= 0.93 and finite predictions;
5. small-data path — ``lgb.train`` of the upstream
   ``examples/binary_classification/train.conf`` configuration (binary,
   63 leaves, max_bin 255, lr 0.1, feature and bagging fraction 0.8,
   bagging_freq 5, min_data_in_leaf 50, min_sum_hessian_in_leaf 5,
   binary_logloss and auc on the training and the valid set every
   iteration) on the bench's generator at 65,536 + 13,107 rows, 100
   iterations with early stopping after 10, counters reset first;
   require the split scan, the fused route+histogram and the
   route-values kernels to have launched, valid AUC >= 0.90 and finite
   predictions;
6. float headline — the headline's ``lgb.train`` with ``gpu_use_dp``
   (so hilo values), 8 iterations, counters reset first: the float K1,
   K2, the float K3 and K4 must launch and no int8 histogram kernel;
   train AUC >= 0.93 and finite predictions;
7. stream kernels — at the stream path's shapes (a 1,048,576-row
   block, 28 columns, 64-bin stride) the wide active-leaf histogram K5
   on int8h values and on hhilo values (A = 32, C = 4), each on a
   uniform wave and on a skewed one (every row that is not padding in
   one slot, as in the first wave of every tree), and the
   leaf-compacted K3 at A = 128, each adding into the nonzero carry a
   previous block left, held bitwise against its plain version (the
   float one runs on CPU copies, compared by bit pattern: only the CPU
   adds in its fixed order); the float K5's two phases (chunk partials,
   fold) are timed apart and its contract floor (the partial traffic)
   is logged beside its bound;
8. stream identity — ``ingest_synthetic`` writes the bench's A/B store
   (4,194,304 rows x 28, max_bin 63) into a temporary directory;
   ``lgb.train_streaming`` (63 leaves, lr 0.1, blocks of 1,048,576 rows,
   2 iterations, int8h) and in-memory training on
   ``store.to_binned_dataset`` must give one digest (scores included);
   the stream must launch K5 (int8h), K2 and K4, the in-memory run K1;
9. stream scale — the bench's stream leg (``bench.py`` stream config)
   cut from 100,000,000 rows to 20,000,000: past 16,909,320 rows the
   mode is hhilo, so the float K5 must launch and the int8h K5 and K1
   must not; the scores must be finite and their AUC on the store's
   labels >= 0.93; rows per second, wall, peak device memory and the
   model's digest are logged;
10. in-memory scale — the same 20M rows (``store.to_binned_dataset``)
   trained in memory with the same parameters: hhilo there too, through
   the float K1; its digest (scores included) must be the streamed
   one's, no int8 histogram kernel may run and the peak device memory
   must stay under 4 GiB (the kernels' scratch does not grow with rows x
   slots);
11. 20M headline width — the same rows with the headline's tree (255
   leaves, ``min_data_in_leaf`` 20), streamed and in memory, 2
   iterations each: equal digests, the float K1 and K3 launched in
   memory, the same memory limit.  The temporary stores are removed at
   the end.

A path's ms/iter is the wall of the whole ``lgb.train`` call, the
Booster's setup (upload, objective init) and, on the small-data path,
the per-iteration evaluation included.  The last lines are the kernel
table as one JSON object, the card's name and power limit, and
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

HEADLINE_ROWS = 1_000_000
HEADLINE_FEATURES = 28
HEADLINE_ITERS = 32
AUC_GATE = 0.93
SMALL_ROWS = 65_536              # the most rows the split kernel takes
SMALL_VALID = SMALL_ROWS // 5    # as bench.py valid_leg
SMALL_ITERS = 100
SMALL_EARLY_STOP = 10
VALID_AUC_GATE = 0.90
# examples/binary_classification/train.conf of the upstream project
TRAIN_CONF = {"objective": "binary", "metric": "binary_logloss,auc",
              "metric_freq": 1, "is_training_metric": True,
              "num_leaves": 63, "max_bin": 255, "learning_rate": 0.1,
              "feature_fraction": 0.8, "bagging_freq": 5,
              "bagging_fraction": 0.8, "min_data_in_leaf": 50,
              "min_sum_hessian_in_leaf": 5.0, "verbose": -1}
# the bench's stream leg (bench.py stream config): 63 leaves, max_bin 63,
# blocks of 1,048,576 rows; its A/B store size; its 100M rows cut to 20M
STREAM_PARAMS = {"objective": "binary", "num_leaves": 63, "max_bin": 63,
                 "learning_rate": 0.1, "verbose": -1}
STREAM_FEATURES = 28
STREAM_BLOCK = 1 << 20
STREAM_ITERS = 2
STREAM_IDENT_ROWS = 4_194_304
STREAM_SCALE_ROWS = 20_000_000
# the headline's tree on the 20M store (max_bin 63 as the store's bins)
HEAD20_PARAMS = dict(STREAM_PARAMS, num_leaves=255, min_data_in_leaf=20)
# in-memory float runs at 20M rows: the kernels' scratch must not grow
# with rows x slots
INMEM_PEAK_LIMIT = 4 << 30
FLOAT_ITERS = 8
# memory rate of one H100 SXM (NVIDIA data sheet)
PEAK_BYTES_PER_S = 3.35e12
# float32 rate outside the tensor cores of one H100 SXM (data sheet)
FP32_OPS_PER_S = 67e12
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


def small_data(seed: int = 3):
    """The bench's synthetic generator at the small-data path's size
    (bench.py valid_leg): ``(X, y, X_valid, y_valid)``."""
    import numpy as np
    n = SMALL_ROWS + SMALL_VALID
    rng = np.random.RandomState(seed)
    X = rng.normal(size=(n, HEADLINE_FEATURES)).astype(np.float32)
    y = (X[:, 0] * 2 + X[:, 1] - X[:, 2]
         + rng.normal(scale=1.0, size=n) > 0).astype(np.float32)
    return X[:SMALL_ROWS], y[:SMALL_ROWS], X[SMALL_ROWS:], y[SMALL_ROWS:]


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


def current_stream(dev) -> int:
    """The handle of torch's current stream on ``dev`` (inside a graph
    capture: the capture stream)."""
    import torch
    return torch.cuda.current_stream(dev).cuda_stream


def graph_ms(fn, n: int = 100, reps: int = 5) -> float:
    """Device time of one call of ``fn``: ``n`` calls captured in one
    ``torch.cuda.CUDAGraph`` on the capture stream and the graph replayed
    ``reps`` times between events, so no host launch sits between two
    kernels.  ``fn`` launches on torch's current stream and returns its
    CUDA error code."""
    import torch
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        codes = [fn() for _ in range(n)]
    if any(codes):
        raise RuntimeError(f"a launch captured in the graph failed: {codes}")
    g.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        g.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * n)


def bound(nbytes: float, ops: float, ops_rate: float) -> dict:
    """The least time for ``nbytes`` of traffic and ``ops`` operations at
    ``ops_rate`` per second: the larger of the two, with both parts."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / ops_rate * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bytes_bound_ms=t_bytes, ops_bound_ms=t_ops)


def wave_inputs(dd, nl: int, n_sel: int, A: int, gen, L: int = 255,
                bag: float = 1.0):
    """A mid-tree wave on ``dd``: rows spread over ``nl`` leaves, ``n_sel``
    of them split by random numerical tables, ``A`` active slots (two of
    them -1 when A >= 16).  With ``bag`` < 1 each row is in the bag with
    that probability; out-of-bag rows carry hist leaf -1, as bagging
    leaves them."""
    import torch
    from lightgbm_tpu_torch.ops.histogram import bin_stride
    from lightgbm_tpu_torch.ops.route import leaf_tables
    dev = dd.device
    n, n_pad = dd.num_data, dd.n_pad
    F = dd.num_features
    leaf2 = torch.full((2, n_pad), -1, dtype=torch.int32, device=dev)
    leaf2[0, :n] = torch.randint(0, nl, (n,), generator=gen,
                                 device=dev).int()
    if bag < 1.0:
        keep = torch.rand(n, generator=gen, device=dev) < bag
        leaf2[1, :n] = torch.where(keep, leaf2[0, :n], -1)
    else:
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


def moved_sectors(bins_t, leaf2, tabs):
    """Rows a route wave moves and the 32-byte sectors of the transposed
    bins their split columns lie in, counted on the device: -> ``(moved
    rows, distinct sectors)``.  The card reads whole sectors, so a wave
    whose neighbouring rows split on different columns reads up to 32
    bytes for each one-byte bin."""
    import torch
    from lightgbm_tpu_torch.ops.route import T_GROUP, T_SEL
    n_pad = bins_t.shape[1]
    rl = leaf2[0].long()
    leaf = rl.clamp(min=0)
    rows = torch.nonzero((rl >= 0) & (tabs[T_SEL][leaf] != 0))[:, 0]
    addr = tabs[T_GROUP][leaf[rows]].long() * n_pad + rows
    return int(rows.numel()), int(torch.unique(addr // 32).numel())


def kernel_phase(dd, vals, entries):
    """Kernel vs plain version at the headline shapes (bitwise), with
    times and bounds; appends one dict per kernel to ``entries``."""
    import torch
    from lightgbm_tpu_torch.ops import cuda_build
    from lightgbm_tpu_torch.ops.compact import hist_compact_raw
    from lightgbm_tpu_torch.ops.histogram import (
        bin_stride, hist_launcher, hist_plain, hist_plan, hist_slab, slot_tables)
    from lightgbm_tpu_torch.ops.route import (
        ROUTE_BLOCK, _route_grid, route_plain, route_rows_raw)
    dev = dd.device
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
    lib = cuda_build.library("route")
    buf = torch.empty_like(leaf2)

    def k2_call(stream=torch.cuda.current_stream(dev).cuda_stream):
        return lib.lgbm_route_rows(
            dd.bins_t.data_ptr(), n_pad, leaf2.data_ptr(), buf.data_ptr(),
            tabs.data_ptr(), L, cat.data_ptr(), B, _route_grid(n_pad, dev),
            ROUTE_BLOCK, stream)
    ms2 = time_ms(k2_call, 50)
    dev2 = graph_ms(lambda: k2_call(current_stream(dev)))
    plain2 = time_ms(lambda: route_plain(dd.bins_t, leaf2, tabs, cat), 5)
    moved_rows, sectors = moved_sectors(dd.bins_t, leaf2, tabs)
    b2 = bound(16 * n_pad + moved_rows + tab_bytes, n_pad, int_rate)
    sec2 = bound(16 * n_pad + 32 * sectors + tab_bytes, n_pad, int_rate)
    entries.append(dict(
        name="route", route="cuda",
        source="lightgbm_tpu_torch/csrc/route.cu",
        replaces="lightgbm_tpu/ops/pallas_route.py:85",
        max_abs_err=0.0, ms=ms2, graph_ms=dev2, plain_ms=plain2,
        library_ms=None, moved_rows=moved_rows, sectors=sectors,
        sector_bound_ms=sec2["bound_ms"], **b2))
    log(f"kernel route: bitwise ok, {ms2:.4f} ms back to back, {dev2:.4f} "
        f"ms in a graph (plain {plain2:.3f} ms, bound {b2['bound_ms']:.4f} "
        f"ms; {moved_rows} moved rows touch {sectors} sectors: sector "
        f"bound {sec2['bound_ms']:.4f} ms)")
    lv = torch.randn(L, generator=gen, device=dev)
    entries.append(dict(
        name="route_values", route="cuda",
        source="lightgbm_tpu_torch/csrc/route.cu",
        replaces="lightgbm_tpu/ops/pallas_route.py:168", max_abs_err=0.0,
        **k4_measure(dd, leaf2, tabs, cat, lv, int_rate)))

    # -- K1: fused route + histogram at 8, 16, 32 slots ------------------
    k1_rows = [k1_measure(dd, vals, A, A // 2, gen, L, int_rate)
               for A in (8, 16, 32)]
    entries.append(_widest(dict(
        name="hist_route", route="cuda",
        source="lightgbm_tpu_torch/csrc/hist_route.cu",
        replaces="lightgbm_tpu/ops/pallas_histogram.py:637",
        max_abs_err=0.0), k1_rows))

    # -- K3: leaf-compacted histogram at 64 and 128 slots -----------------
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
        plan = hist_plan(n_pad, G, A, B, C, sms, L, False)
        slab = hist_slab(plan, A, G, B, C, dev)
        obuf = torch.zeros_like(raw)
        ms = time_ms(hist_launcher("hist_compact", dd.bins_t, vals, hleaf,
                                   inv, src, L, B, plan, slab, obuf), 20)
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
                            plan=plan.__dict__, **bd))
        log(f"kernel hist_compact A={A}: bitwise ok, {ms:.4f} ms (plain "
            f"{pl:.3f} ms, index_add_ {lib_ms:.4f} ms, bound "
            f"{bd['bound_ms']:.4f} ms by {bd['bound_by']}, {n_active} "
            f"active rows)")
    entries.append(_widest(dict(
        name="hist_compact", route="cuda",
        source="lightgbm_tpu_torch/csrc/hist_compact.cu",
        replaces="lightgbm_tpu/ops/compact.py:179", max_abs_err=0.0),
        k3_rows))


def k4_measure(dd, leaf2, tabs, cat, lv, int_rate: float) -> dict:
    """K4 (route + per-row leaf value, the last pass of a tree) on one
    wave's tables: kernel vs plain version bitwise, times and bound."""
    import torch
    from lightgbm_tpu_torch.ops import cuda_build
    from lightgbm_tpu_torch.ops.route import (
        ROUTE_BLOCK, _route_grid, route_rows_values_raw, route_values_plain)
    dev = dd.device
    n_pad = dd.n_pad
    L, B = cat.shape
    out, v = route_rows_values_raw(dd.bins_t, leaf2, tabs, cat, lv)
    ref, rv = route_values_plain(dd.bins_t, leaf2, tabs, cat, lv)
    torch.cuda.synchronize()
    if not (torch.equal(out, ref) and torch.equal(v, rv)):
        raise AssertionError(f"route-values kernel != plain (L={L}, B={B})")
    lib = cuda_build.library("route")
    buf = torch.empty_like(leaf2)
    vbuf = torch.empty(n_pad, dtype=torch.float32, device=dev)

    def call(stream=torch.cuda.current_stream(dev).cuda_stream):
        return lib.lgbm_route_rows_values(
            dd.bins_t.data_ptr(), n_pad, leaf2.data_ptr(), buf.data_ptr(),
            tabs.data_ptr(), L, cat.data_ptr(), B, lv.data_ptr(),
            vbuf.data_ptr(), _route_grid(n_pad, dev), ROUTE_BLOCK, stream)
    ms = time_ms(call, 50)
    gms = graph_ms(lambda: call(current_stream(dev)))
    pl = time_ms(lambda: route_values_plain(dd.bins_t, leaf2, tabs, cat,
                                            lv), 5)
    moved_rows, sectors = moved_sectors(dd.bins_t, leaf2, tabs)
    tab_bytes = 11 * L * 4 + L * B + 4 * L
    bd = bound(20 * n_pad + moved_rows + tab_bytes, n_pad, int_rate)
    sec = bound(20 * n_pad + 32 * sectors + tab_bytes, n_pad, int_rate)
    log(f"kernel route_values L={L} B={B} rows={dd.num_data}: bitwise ok, "
        f"{ms:.4f} ms back to back, {gms:.4f} ms in a graph (plain "
        f"{pl:.3f} ms, bound {bd['bound_ms']:.4f} ms; {moved_rows} moved "
        f"rows touch {sectors} sectors: sector bound "
        f"{sec['bound_ms']:.4f} ms)")
    return dict(ms=ms, graph_ms=gms, plain_ms=pl, library_ms=None,
                moved_rows=moved_rows, sectors=sectors,
                sector_bound_ms=sec["bound_ms"], **bd)


def k1_measure(dd, vals, A: int, n_sel: int, gen, L: int,
               int_rate: float, bag: float = 1.0) -> dict:
    """K1 (fused route + histogram) at ``A`` slots of a wave with
    ``n_sel`` pending splits and rows in the bag with probability
    ``bag``: kernel vs plain version bitwise, times and bound.  With
    ``bag`` < 1 the -1 slots must have collected every out-of-bag row."""
    import torch
    from lightgbm_tpu_torch.ops import cuda_build
    from lightgbm_tpu_torch.ops.histogram import (
        bin_stride, hist_launcher, hist_plan, hist_route_plain, hist_route_raw,
        hist_slab, slot_tables)
    dev = dd.device
    G, n_pad = dd.bins_t.shape
    C = vals.shape[0]
    B = bin_stride(dd.group_max_bins)
    tab_bytes = 11 * L * 4 + L * B
    leaf2, tabs, cat, active = wave_inputs(dd, A, n_sel, A, gen, L, bag)
    raw, l2n = hist_route_raw(dd.bins_t, vals, leaf2, active, tabs, cat,
                              L, dd.group_max_bins)
    inv, src = slot_tables(active, L, collect_unbagged=True)
    ref_raw, ref_l2 = hist_route_plain(dd.bins_t, vals, leaf2, tabs, cat,
                                       inv, src, B)
    torch.cuda.synchronize()
    if not (torch.equal(raw, ref_raw) and torch.equal(l2n, ref_l2)):
        raise AssertionError(f"hist_route kernel != plain (A={A}, B={B})")
    if bag < 1.0:
        # each -1 slot holds the out-of-bag rows: count column, column 0
        n_oob = int((ref_l2[1, :dd.num_data] < 0).sum())
        slot = int(torch.nonzero(active < 0)[0, 0])
        got = int(ref_raw[slot, 0, :, C - 1].sum())
        if n_oob == 0 or got != n_oob:
            raise AssertionError(f"hist_route -1 slot holds {got} rows, "
                                 f"{n_oob} are out of the bag")
    plan = hist_plan(n_pad, G, A, B, C, cuda_build.multiprocessor_count(dev),
                     L, True)
    slab = hist_slab(plan, A, G, B, C, dev)
    obuf = torch.zeros_like(raw)
    lbuf = torch.empty_like(leaf2)
    ms = time_ms(hist_launcher("hist_route", dd.bins_t, vals, leaf2, inv,
                               src, L, B, plan, slab, obuf, lbuf, tabs, cat),
                 20)
    pl = time_ms(lambda: hist_route_plain(dd.bins_t, vals, leaf2, tabs,
                                          cat, inv, src, B), 3)
    hl = ref_l2[1].long()
    n_active = int((inv.long()[torch.where(hl >= 0, hl, L)] >= 0).sum())
    moved_rows = int((tabs[4][leaf2[0].clamp(min=0).long()] != 0).sum())
    bd = bound(16 * n_pad + moved_rows + (G + C) * n_active
               + raw.numel() * 4 + tab_bytes + (L + 1 + A) * 4,
               G * C * n_active, int_rate)
    log(f"kernel hist_route A={A} B={B} rows={dd.num_data}: bitwise ok, "
        f"{ms:.4f} ms (plain {pl:.3f} ms, bound {bd['bound_ms']:.4f} ms by "
        f"{bd['bound_by']}, {n_active} active rows)")
    return dict(slots=A, ms=ms, plain_ms=pl, library_ms=None,
                plan=plan.__dict__, **bd)


def split_wave_inputs(F: int, B: int, L2: int, n: int, gen, dev):
    """A split-scan wave ``[L2, F, B, 3]``: histograms of ``n`` simulated
    rows spread over ``L2`` leaves (every feature partitions the same
    rows), their leaf totals and random per-feature bin counts and
    missing types."""
    import torch
    leaf = torch.randint(0, L2, (n,), generator=gen, device=dev)
    g = torch.randn(n, generator=gen, device=dev)
    h = torch.rand(n, generator=gen, device=dev) * 0.25 + 0.01
    num_bins = torch.randint(B // 2, B + 1, (F,), generator=gen,
                             device=dev).int()
    mt = torch.randint(0, 3, (F,), generator=gen, device=dev).int()
    db = (torch.rand(F, generator=gen, device=dev) * num_bins).int()
    bins = (torch.rand(n, F, generator=gen, device=dev) * num_bins).long()
    ghc = torch.stack([g, h, torch.ones_like(g)], -1)          # [n, 3]
    idx = (leaf[:, None] * F + torch.arange(F, device=dev)) * B + bins
    grid = torch.zeros(L2 * F * B, 3, device=dev)
    grid.index_add_(0, idx.reshape(-1),
                    ghc[:, None, :].expand(n, F, 3).reshape(-1, 3))
    tot = torch.zeros(L2, 3, device=dev).index_add_(0, leaf, ghc)
    return (grid.reshape(L2, F, B, 3), tot[:, 0].contiguous(),
            tot[:, 1].contiguous(), tot[:, 2].contiguous(), num_bins, mt,
            db)


def k6_flops_per_cell(B: int, any_missing: bool) -> int:
    """Float operations of the split scan per (leaf, feature, bin) cell:
    the 3-channel prefix scan, with missing values the suffix scan, its
    broadcast and the missing-left sums, and per variant 3 right-side
    subtractions, two gains (5 each) and their sum.  Compares and the
    argmax are not counted, so the bound is a lower one."""
    lg = B.bit_length() - 1
    per_variant = 3 + 2 * 5 + 1
    if any_missing:
        return 3 * lg + 6 * lg + 3 + 2 * per_variant
    return 3 * lg + per_variant


def small_kernel_phase(dds, vals, int_rate: float, entries) -> None:
    """The small-data path's kernels at its shapes, with the path's
    bagging fraction: K1 at 256 bins and 32 slots on 65,536 rows and K4
    at 63 leaves (added to their entries under ``small_data``), and the
    split scan K6 on a ``[64, 28, 256, 3]`` wave (its own entry) and on
    a ``[64, 28, 64, 3]`` one (under ``by_shape``)."""
    import torch
    dev = dds.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    L = TRAIN_CONF["num_leaves"]
    bag = TRAIN_CONF["bagging_fraction"]
    k1 = k1_measure(dds, vals, 32, 16, gen, L, int_rate, bag)
    # a tree's last pass: 32 leaves, 31 of them split -> 63 leaves
    leaf2, tabs, cat, _ = wave_inputs(dds, 32, 31, 32, gen, L, bag)
    lv = torch.randn(L, generator=gen, device=dev)
    k4 = k4_measure(dds, leaf2, tabs, cat, lv, int_rate)
    small = {"hist_route": dict(rows=dds.num_data, bins=256, **k1),
             "route_values": dict(rows=dds.num_data, leaves=L,
                                  bins=cat.shape[1], **k4)}
    for e in entries:
        if e["name"] in small:
            e["small_data"] = small[e["name"]]

    by_shape = [k6_measure(HEADLINE_FEATURES, B, 64, gen, dev)
                for B in (256, 64)]
    entries.append(dict(
        name="split_scan", route="cuda",
        source="lightgbm_tpu_torch/csrc/split.cu",
        replaces="lightgbm_tpu/ops/pallas_split.py:206", max_abs_err=0.0,
        **by_shape[0], by_shape=by_shape))


def k6_measure(F: int, B: int, L2: int, gen, dev) -> dict:
    """K6 on one ``[L2, F, B, 3]`` wave with the path's constraints and
    feature fraction: the wrapper's result against the plain version
    (every field bitwise), times and bound."""
    import torch
    from lightgbm_tpu_torch.ops import cuda_build
    from lightgbm_tpu_torch.ops.split import SplitParams
    from lightgbm_tpu_torch.ops.split_kernel import (
        PACKED, find_best_splits_kernel, split_epilogue, split_hyper,
        split_kernel_ok, split_scan_launch, split_scan_plain)
    if not split_kernel_ok(F, B, False, SMALL_ROWS):
        raise AssertionError(f"split_kernel_ok refuses [{L2}, {F}, {B}, 3]")
    inputs = split_wave_inputs(F, B, L2, SMALL_ROWS, gen, dev)
    params = SplitParams(
        min_data_in_leaf=TRAIN_CONF["min_data_in_leaf"],
        min_sum_hessian_in_leaf=TRAIN_CONF["min_sum_hessian_in_leaf"])
    hyper = split_hyper(params)
    fmask = torch.rand(F, generator=gen, device=dev) < 0.8
    fm8 = fmask.to(torch.uint8)
    # every packed field reaches the result unchanged through the
    # epilogue, so the wrapper's result holds the kernel's output
    res = find_best_splits_kernel(*inputs, params=params,
                                  feature_mask=fmask, any_missing=True)
    ref = split_scan_plain(*inputs, fmask, hyper, True)
    ref_res = split_epilogue(ref, *inputs[1:4], params, B)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(res.__dict__.values(),
                                                  ref_res.__dict__.values())):
        raise AssertionError(f"split scan kernel != plain version (B={B})")
    n_split = int((res.gain > 0).sum())
    if n_split < L2 // 2:
        raise AssertionError(f"split scan wave found {n_split} splits")
    lib = cuda_build.library("split")
    out = torch.empty((L2, PACKED), dtype=torch.float32, device=dev)

    def call():
        return split_scan_launch(lib, *inputs, fm8, hyper, True, out)
    ms = time_ms(call, 50)
    gms = graph_ms(call)
    pl = time_ms(lambda: split_scan_plain(*inputs, fmask, hyper, True), 5)
    nbytes = (inputs[0].numel() * 4 + 3 * L2 * 4 + 3 * F * 4 + F
              + out.numel() * 4)
    bd = bound(nbytes, L2 * F * B * k6_flops_per_cell(B, True),
               FP32_OPS_PER_S)
    log(f"kernel split_scan [{L2}, {F}, {B}, 3]: bitwise ok, {n_split} "
        f"splits, {ms:.4f} ms back to back, {gms:.4f} ms in a graph (plain "
        f"{pl:.3f} ms, bound {bd['bound_ms']:.4f} ms by {bd['bound_by']})")
    return dict(shape=[L2, F, B, 3], ms=ms, graph_ms=gms, plain_ms=pl,
                library_ms=None, splits=n_split, **bd)


def float_values(dd, mode: str, gen):
    """Float value rows (``pack_values``) of random gradients on ``dd``."""
    import torch
    from lightgbm_tpu_torch.ops.histogram import pack_values
    g = torch.randn(dd.num_data, generator=gen, device=dd.device) * 0.5
    h = torch.rand(dd.num_data, generator=gen, device=dd.device) * 0.25
    return pack_values(g, h, mode, dd.n_pad)


def skew_wave(leaf2, tabs, leaf: int):
    """Every row that is not padding in ``leaf``, which the wave's
    tables leave unsplit: the shape of every tree's first wave."""
    import torch
    from lightgbm_tpu_torch.ops.route import T_SEL
    tabs = tabs.clone()
    tabs[T_SEL, leaf] = 0
    return torch.where(leaf2 >= 0, leaf, leaf2).contiguous(), tabs


def bits_equal(a, b) -> bool:
    """Float tensors compared by bit pattern (``torch.equal`` takes -0.0
    for 0.0)."""
    import torch
    return torch.equal(a.cpu().contiguous().view(torch.int32),
                       b.cpu().contiguous().view(torch.int32))


def chunk_pairs(hl, inv, rows, A: int) -> int:
    """(chunk, accumulation slot) pairs with rows: the chunk partials the
    float K5's order writes and reads back."""
    import torch
    from lightgbm_tpu_torch.ops.histogram import FLOAT_CHUNK
    L = inv.shape[0] - 1
    slot = inv.long()[torch.where(hl >= 0, hl.long(), L)][rows]
    return int(torch.unique((rows // FLOAT_CHUNK) * A + slot).numel())


def walk_measure(dd, vals, hl, inv, src, L: int, B: int, acc_shape,
                 reps: int = 5) -> dict:
    """The float K3 launched through its window launchers: times of a
    whole call, of its three phases apart (the sort; the walks: heavy
    chunk partials and light walks; the fold of the heavy partials) and
    of each kernel in a CUDA graph, and its heavy/light choice on the
    card held against the host rule (``float_walk_split``)."""
    import torch
    from lightgbm_tpu_torch.ops import cuda_build
    from lightgbm_tpu_torch.ops.histogram import (
        FLOAT_CHUNK, FLOAT_WALK_KERNELS, FloatWalkScratch, float_dense_rows,
        float_light_rows, float_walk_launches, float_walk_plan,
        float_walk_split)
    G, n_pad = dd.bins_t.shape
    C, A = vals.shape[0], src.shape[0]
    plan = float_walk_plan(n_pad, A, G, B, C, L,
                           cuda_build.multiprocessor_count(dd.device))
    scratch = FloatWalkScratch.empty(plan, A, G, B, C, dd.device)
    obuf = torch.zeros(acc_shape, device=dd.device)

    def launches(phase):
        return float_walk_launches(dd.bins_t, vals, hl, inv, src, L, B, plan,
                                   scratch, obuf, phase)

    def run(phase):
        fns = launches(phase)
        return lambda: [f() for f in fns]

    def on_stream(phase):   # bound to the current (capture) stream
        return lambda: max(f() for f in launches(phase))
    times = {}
    for ph in ("both", "sort", "walk", "fold"):
        times[f"{ph}_ms"] = time_ms(run(ph), reps)
        times[f"{ph}_graph_ms"] = graph_ms(on_stream(ph), n=20)
    # each kernel's device time (on the scratch of the calls above)
    times["kernel_graph_ms"] = {k: graph_ms(on_stream(k), n=20)
                                for k in FLOAT_WALK_KERNELS}
    # the last window's plan, against the host rule on its rows
    run("sort")()
    torch.cuda.synchronize()
    w0 = (n_pad - 1) // plan.window * plan.window
    rows = n_pad - w0
    meta = scratch.meta(A, rows).cpu()
    hw = hl[w0:].long()
    sl = inv.long()[torch.where(hw >= 0, hw, L)]
    kw = -(-rows // FLOAT_CHUNK)
    ks = torch.arange(rows, device=hw.device) // FLOAT_CHUNK
    on = sl >= 0
    counts = torch.bincount(sl[on] * kw + ks[on], minlength=A * kw)
    hbase, lrows, hcount = float_walk_split(counts.view(A, kw).tolist(),
                                            float_light_rows(rows),
                                            float_dense_rows(rows),
                                            plan.pcap)
    if (meta[3].tolist() != hbase or meta[4].tolist() != lrows
            or meta[5].tolist() != hcount):
        raise AssertionError("hist_compact_float: the card's plan != the "
                             "host rule")
    return dict(ms=times.pop("both_ms"), graph_ms=times.pop("both_graph_ms"),
                **times, windows=-(-n_pad // plan.window),
                heavy_slots=sum(h >= 0 for h in hbase),
                light_slots=sum(h < 0 and n > 0 for h, n in zip(hbase, lrows)),
                heavy_pairs=sum(hcount), walked_rows_max=max(lrows),
                scratch_bytes=scratch.nbytes)


def kernel_line(walk: dict) -> str:
    return " ".join(f"{k} {v:.4f}" for k, v in walk["kernel_graph_ms"].items())


def k1_float_measure(dd, mode: str, A: int, gen, L: int = 255,
                     bag: float = 1.0, skew: bool = False) -> dict:
    """The float K1 at ``A`` slots of a headline wave: bitwise (bit
    patterns) against its plain version on CPU copies and against K2
    followed by the float K5 on the card; times of the kernel and of its
    partial and fold phases apart (back to back and in a CUDA graph), of
    that composition (its yardstick, with the float K5's partial and fold
    phases apart), of the plain version and of an f32 ``index_add_`` over
    the routed rows (its library call); the bound and the float K5's
    contract floor (its chunk partials written and read back)."""
    import torch
    from lightgbm_tpu_torch.ops.histogram import (
        FLOAT_WINDOW, bin_stride, float_plan, float_scratch,
        hist_active_float_raw, hist_float_launcher, hist_route_float_launches,
        hist_route_float_plain, hist_route_float_raw, slot_tables)
    from lightgbm_tpu_torch.ops.route import route_rows_raw
    dev = dd.device
    G, n_pad = dd.bins_t.shape
    B = bin_stride(dd.group_max_bins)
    vals = float_values(dd, mode, gen)
    C = vals.shape[0]
    leaf2, tabs, cat, active = wave_inputs(dd, max(A, 8), A // 2, A, gen, L,
                                           bag)
    if skew:
        leaf2, tabs = skew_wave(leaf2, tabs, int(active[0]))
    raw, l2n = hist_route_float_raw(dd.bins_t, vals, leaf2, active, tabs,
                                    cat, L, dd.group_max_bins)
    routed = route_rows_raw(dd.bins_t, leaf2, tabs, cat)
    k5 = hist_active_float_raw(dd.bins_t, vals, routed[1].contiguous(),
                               active, L, dd.group_max_bins)
    inv, src = slot_tables(active, L, collect_unbagged=True)
    cpu = [t.cpu() for t in (dd.bins_t, vals, leaf2, tabs, cat, inv, src)]
    t0 = time.time()
    ref, ref_l2 = hist_route_float_plain(*cpu, B, torch.zeros(raw.shape))
    pl = 1e3 * (time.time() - t0)
    torch.cuda.synchronize()
    err = float((raw.cpu() - ref).abs().max())
    if not (bits_equal(raw, ref) and torch.equal(l2n.cpu(), ref_l2)):
        raise AssertionError(f"hist_route_float kernel != plain version "
                             f"({mode}, A={A}, skew={skew}, max abs err "
                             f"{err})")
    if not (bits_equal(raw, k5) and torch.equal(l2n, routed)):
        raise AssertionError(f"hist_route_float != K2 + float K5 ({mode}, "
                             f"A={A}, skew={skew})")
    hl = ref_l2[1].to(dev)
    rows = _active_rows(hl, inv)
    n_active = int(rows.numel())
    if bag < 1.0 and bool((active < 0).any()):
        # each -1 slot holds the out-of-bag rows: count column, column 0
        n_oob = int((ref_l2[1, :dd.num_data] < 0).sum())
        slot = int(torch.nonzero(active < 0)[0, 0])
        got = int(ref[slot, 0, :, C - 1].sum())
        if n_oob == 0 or got != n_oob:
            raise AssertionError(f"hist_route_float -1 slot holds {got} "
                                 f"rows, {n_oob} are out of the bag")
    plan = float_plan(A, B, C)
    part, counts = float_scratch(min(n_pad, FLOAT_WINDOW), A, G, B, C, dev)
    obuf = torch.zeros_like(raw)
    lbuf = torch.empty_like(leaf2)

    def k1_call(phase):
        fns = hist_route_float_launches(dd.bins_t, vals, leaf2, inv, src, L,
                                        B, plan, part, counts, obuf, lbuf,
                                        tabs, cat, phase)
        return lambda: [f() for f in fns]

    def k1_graph(phase):   # bound to the current (capture) stream
        return lambda: max(f() for f in hist_route_float_launches(
            dd.bins_t, vals, leaf2, inv, src, L, B, plan, part, counts, obuf,
            lbuf, tabs, cat, phase))
    walk = {}
    for ph in ("both", "partial", "fold"):
        walk["ms" if ph == "both" else f"{ph}_ms"] = time_ms(k1_call(ph), 10)
        walk["graph_ms" if ph == "both" else f"{ph}_graph_ms"] = graph_ms(
            k1_graph(ph), n=20)
    walk["windows"] = -(-n_pad // FLOAT_WINDOW)
    del part
    part5, counts5 = float_scratch(n_pad, A, G, B, C, dev)
    hl5 = routed[1].contiguous()

    def k5_call(phase):
        return hist_float_launcher(dd.bins_t, vals, hl5, inv, src, L, B,
                                   plan, part5, counts5,
                                   torch.zeros_like(raw), phase)
    k5_both = k5_call("both")
    yard = time_ms(lambda: (route_rows_raw(dd.bins_t, leaf2, tabs, cat),
                            k5_both()), 10)
    k5_partial_ms = time_ms(k5_call("partial"), 10)
    k5_fold_ms = time_ms(k5_call("fold"), 10)
    del part5
    idx = _flat_cells(dd.bins_t, hl, inv, rows, B, C).reshape(-1)
    vv = vals[:, rows].t()[None].expand(G, -1, -1).reshape(-1).contiguous()
    lacc = torch.zeros(raw.numel(), device=dev)
    lib_ms = time_ms(lambda: lacc.index_add_(0, idx, vv), 5)
    del idx, vv
    tab_bytes = 11 * L * 4 + L * cat.shape[1]
    bd = bound(16 * n_pad + G * n_pad + 4 * C * n_pad + 2 * raw.numel() * 4
               + tab_bytes + (L + 1 + A) * 4, G * C * n_active + raw.numel(),
               FP32_OPS_PER_S)
    pairs = chunk_pairs(hl, inv, rows, A)
    floor_ms = 2 * pairs * G * B * C * 4 / PEAK_BYTES_PER_S * 1e3
    log(f"kernel hist_route_float ({mode}{', skewed' if skew else ''}"
        f"{', bag %.1f' % bag if bag < 1 else ''}) A={A} rows={dd.num_data}: "
        f"bitwise ok (plain, K2 + float K5), {walk['ms']:.4f} ms = "
        f"partials {walk['partial_ms']:.4f} + fold {walk['fold_ms']:.4f} "
        f"ms; in a graph {walk['graph_ms']:.4f} = "
        f"{walk['partial_graph_ms']:.4f} + {walk['fold_graph_ms']:.4f} ms "
        f"(K2 + float K5 {yard:.4f} ms with the float K5's partials "
        f"{k5_partial_ms:.4f} + fold {k5_fold_ms:.4f} ms; f32 index_add_ "
        f"{lib_ms:.4f} ms; plain on the CPU {pl:.1f} ms; bound "
        f"{bd['bound_ms']:.4f} ms by {bd['bound_by']}; the float K5's "
        f"contract floor {floor_ms:.4f} ms for {pairs} chunk partials; "
        f"{walk['windows']} windows)")
    return dict(slots=A, mode=mode, shape="skewed" if skew else "uniform",
                bag=bag, **walk, yardstick_ms=yard,
                k5_partial_ms=k5_partial_ms, k5_fold_ms=k5_fold_ms,
                plain_ms=pl, plain_device="cpu", library_ms=lib_ms,
                max_abs_err=err, active_rows=n_active, chunk_partials=pairs,
                contract_floor_ms=floor_ms, **bd)


def k3_float_measure(dd, mode: str, A: int, gen, L: int = 255,
                     skew: bool = False) -> dict:
    """The float K3 at ``A`` slots of a headline wave after its route:
    bitwise (bit patterns) against its plain version on CPU copies and
    against the float K5 on its non-negative slots on the card; times of
    the kernel and of its phases (``walk_measure``), of the plain version
    and of an f32 ``index_add_``; the bound."""
    import torch
    from lightgbm_tpu_torch.ops.compact import hist_compact_float_raw
    from lightgbm_tpu_torch.ops.histogram import (
        bin_stride, hist_active_float_raw, hist_float_plain, slot_tables)
    from lightgbm_tpu_torch.ops.route import route_rows_raw
    dev = dd.device
    G, n_pad = dd.bins_t.shape
    B = bin_stride(dd.group_max_bins)
    vals = float_values(dd, mode, gen)
    C = vals.shape[0]
    leaf2, tabs, cat, active = wave_inputs(dd, 127 if A == 128 else 63,
                                           A - 2, A, gen, L, 0.8)
    hl = route_rows_raw(dd.bins_t, leaf2, tabs, cat)[1].contiguous()
    if skew:
        hl = torch.where(hl >= 0, active[0], hl).contiguous()
    raw = hist_compact_float_raw(dd.bins_t, vals, hl, active, L,
                                 dd.group_max_bins)
    k5 = hist_active_float_raw(dd.bins_t, vals, hl, active, L,
                               dd.group_max_bins)
    inv, src = slot_tables(active, L, collect_unbagged=False)
    cpu = [t.cpu() for t in (dd.bins_t, vals, hl, inv, src)]
    t0 = time.time()
    ref = hist_float_plain(*cpu, B, torch.zeros(raw.shape))
    pl = 1e3 * (time.time() - t0)
    torch.cuda.synchronize()
    err = float((raw.cpu() - ref).abs().max())
    live = active >= 0
    if not (bits_equal(raw, ref) and bits_equal(raw[live], k5[live])
            and not raw[~live].any()):
        raise AssertionError(f"hist_compact_float kernel != plain version "
                             f"or float K5 ({mode}, A={A}, skew={skew}, max "
                             f"abs err {err})")
    rows = _active_rows(hl, inv)
    n_active = int(rows.numel())
    walk = walk_measure(dd, vals, hl, inv, src, L, B, raw.shape)
    idx = _flat_cells(dd.bins_t, hl, inv, rows, B, C).reshape(-1)
    vv = vals[:, rows].t()[None].expand(G, -1, -1).reshape(-1).contiguous()
    lacc = torch.zeros(raw.numel(), device=dev)
    lib_ms = time_ms(lambda: lacc.index_add_(0, idx, vv), 5)
    del idx, vv
    bd = bound(4 * n_pad + (G + 4 * C) * n_active + 2 * raw.numel() * 4
               + (L + 1 + A) * 4, G * C * n_active, FP32_OPS_PER_S)
    log(f"kernel hist_compact_float ({mode}{', skewed' if skew else ''}) "
        f"A={A} rows={dd.num_data}: bitwise ok (plain, float K5), "
        f"{walk['ms']:.4f} ms = sort {walk['sort_ms']:.4f} + walk "
        f"{walk['walk_ms']:.4f} + fold {walk['fold_ms']:.4f} ms; in a graph "
        f"{walk['graph_ms']:.4f} = {walk['sort_graph_ms']:.4f} + "
        f"{walk['walk_graph_ms']:.4f} + {walk['fold_graph_ms']:.4f} ms "
        f"(by kernel {kernel_line(walk)}; {walk['heavy_slots']} slots with "
        f"heavy pairs, {walk['heavy_pairs']} heavy pairs, "
        f"{walk['light_slots']} walked whole, at most "
        f"{walk['walked_rows_max']} rows a walk; plain on the CPU "
        f"{pl:.1f} ms, f32 index_add_ {lib_ms:.4f} ms, bound "
        f"{bd['bound_ms']:.4f} ms by {bd['bound_by']}, {n_active} active "
        f"rows)")
    return dict(slots=A, mode=mode, shape="skewed" if skew else "uniform",
                **walk, plain_ms=pl, plain_device="cpu", library_ms=lib_ms,
                max_abs_err=err, active_rows=n_active, **bd)


def float_kernel_phase(dd, entries) -> None:
    """The float K1 and K3 at the headline shapes (255 leaves, 64-bin
    stride) on hhilo and hilo values: K1 at 8 / 16 / 32 slots with
    bagged-out rows (and a skewed 32-slot wave), K3 at 64 / 128 slots
    (and a skewed 128-slot wave).  Appends their entries (the numbers of
    the widest uniform hhilo wave, every wave under ``by_width``)."""
    import torch
    gen = torch.Generator(device=dd.device)
    gen.manual_seed(4)
    k1 = [k1_float_measure(dd, "hhilo", A, gen, bag=0.8) for A in (8, 16, 32)]
    k1 += [k1_float_measure(dd, "hilo", 32, gen, bag=0.8),
           k1_float_measure(dd, "hhilo", 32, gen, skew=True)]
    entries.append(dict(
        name="hist_route_float", route="cuda",
        source="lightgbm_tpu_torch/csrc/hist_route_float.cu",
        replaces="lightgbm_tpu/ops/pallas_histogram.py:637",
        **{k: v for k, v in k1[2].items() if k != "slots"}, by_width=k1))
    k3 = [k3_float_measure(dd, "hhilo", A, gen) for A in (64, 128)]
    k3 += [k3_float_measure(dd, "hilo", 128, gen),
           k3_float_measure(dd, "hhilo", 128, gen, skew=True)]
    entries.append(dict(
        name="hist_compact_float", route="cuda",
        source="lightgbm_tpu_torch/csrc/hist_compact_float.cu",
        replaces="lightgbm_tpu/ops/compact.py:179",
        **{k: v for k, v in k3[1].items() if k != "slots"}, by_width=k3))
    torch.cuda.synchronize()


def stream_wave(gen, nl: int, A: int, G: int = STREAM_FEATURES,
                R: int = STREAM_BLOCK, max_bins: int = 63, skew: bool = False):
    """One streamed block of a wave: bins ``[G, R]``, gradients, hist
    leaves over ``nl`` leaves with 5% of rows at -1 (padding rows), and
    ``A`` active slots, two of them -1.  With ``skew`` every row that is
    not padding sits in the first active slot, as in the first wave of
    every tree."""
    import torch
    dev = gen.device
    bins_t = torch.randint(0, max_bins, (G, R), generator=gen, device=dev,
                           dtype=torch.uint8)
    g = torch.randn(R, generator=gen, device=dev) * 0.5
    h = torch.rand(R, generator=gen, device=dev) * 0.25
    hl = torch.randint(0, nl, (R,), generator=gen, device=dev).int()
    hl[torch.rand(R, generator=gen, device=dev) < 0.05] = -1
    active = torch.randperm(nl, generator=gen, device=dev)[:A].int()
    active[-2:] = -1
    if skew:
        hl = torch.where(hl >= 0, active[0], hl)
    return bins_t, g, h, hl, active.contiguous()


def _flat_cells(bins_t, hl, inv, rows, B: int, C: int):
    """Flat ``[A, G, B, C]`` cell indices of ``rows``, ``[G, r, C]``."""
    import torch
    G = bins_t.shape[0]
    L = inv.shape[0] - 1
    sl = inv.long()[torch.where(hl >= 0, hl.long(), L)][rows]
    cells = ((sl[None, :] * G + torch.arange(G, device=hl.device)[:, None])
             * B + bins_t[:, rows].long()) * C
    return cells[:, :, None] + torch.arange(C, device=hl.device)[None, None]


def _active_rows(hl, inv):
    import torch
    L = inv.shape[0] - 1
    return torch.nonzero(inv.long()[torch.where(hl >= 0, hl.long(), L)]
                         >= 0)[:, 0]


def k5_int8h_measure(gen, shape: str, int_rate: float) -> dict:
    """The seeded K5 on int8h values at the stream block shape, adding
    into the carry a previous block left: bitwise against the plain
    version, times and bound."""
    import torch
    from lightgbm_tpu_torch.ops import cuda_build
    from lightgbm_tpu_torch.ops.histogram import (
        bin_stride, hist_active_raw, hist_launcher, hist_plain, hist_plan,
        hist_slab, pack_values_q, slot_tables)
    dev = gen.device
    L, A, G, R = STREAM_PARAMS["num_leaves"], 32, STREAM_FEATURES, \
        STREAM_BLOCK
    B = bin_stride(63)
    skew = shape == "skewed"
    prev = stream_wave(gen, L, A)
    bins_t, g, h, hl, active = stream_wave(gen, L, A, skew=skew)
    inv, src = slot_tables(active, L, collect_unbagged=True)
    rows = _active_rows(hl, inv)
    n_active = int(rows.numel())
    vp, sc = pack_values_q(prev[1], prev[2], "int8h", R)
    vals, _ = pack_values_q(g, h, "int8h", R, scales=sc)
    C = vals.shape[0]
    carry = hist_active_raw(prev[0], vp, prev[3], active, L, 63)
    got = hist_active_raw(bins_t, vals, hl, active, L, 63, carry.clone())
    ref = carry + hist_plain(bins_t, vals, hl, inv, src, B)
    torch.cuda.synchronize()
    if not (torch.equal(got, ref) and not torch.equal(carry, ref)):
        raise AssertionError(f"hist_active kernel != plain version ({shape})")
    plan = hist_plan(R, G, A, B, C, cuda_build.multiprocessor_count(dev), L,
                     False)
    slab = hist_slab(plan, A, G, B, C, dev)
    obuf = carry.clone()
    ms = time_ms(hist_launcher("hist_active", bins_t, vals, hl, inv, src, L,
                               B, plan, slab, obuf), 20)
    pl = time_ms(lambda: carry + hist_plain(bins_t, vals, hl, inv, src, B),
                 3)
    idx = _flat_cells(bins_t, hl, inv, rows, B, C).reshape(-1)
    vv = vals[:, rows].int().t()[None].expand(G, -1, -1).reshape(-1)
    vv = vv.contiguous()
    lacc = carry.clone().reshape(-1)
    lib_ms = time_ms(lambda: lacc.index_add_(0, idx, vv), 5)
    bd = bound(G * R + C * R + 4 * R + 2 * carry.numel() * 4
               + (L + 1 + A) * 4, G * C * n_active, int_rate)
    log(f"kernel hist_active (K5 int8h, {shape}) A={A} rows={R}: bitwise "
        f"ok (seeded), {ms:.4f} ms (plain {pl:.3f} ms, int32 index_add_ "
        f"{lib_ms:.4f} ms, bound {bd['bound_ms']:.4f} ms by "
        f"{bd['bound_by']}, {n_active} active rows, slab "
        f"{slab.numel() * 4 / 2**20:.1f} MiB)")
    return dict(ms=ms, plain_ms=pl, library_ms=lib_ms, rows=R, slots=A,
                mode="int8h", shape=shape, active_rows=n_active,
                plan=plan.__dict__, slab_bytes=slab.numel() * 4, **bd)


def k5_float_measure(gen, shape: str) -> dict:
    """The seeded float K5 on hhilo values at the stream block shape:
    bitwise (bit patterns) against the plain version on CPU copies (only
    the CPU adds in its fixed order), times of the whole call and of its
    two phases, the bound and the contract's floor."""
    import torch
    from lightgbm_tpu_torch.ops.histogram import (
        FLOAT_CHUNK, bin_stride, float_plan, float_scratch,
        hist_active_float_raw, hist_float_launcher, hist_float_plain,
        pack_values, slot_tables)
    dev = gen.device
    L, A, G, R = STREAM_PARAMS["num_leaves"], 32, STREAM_FEATURES, \
        STREAM_BLOCK
    B = bin_stride(63)
    skew = shape == "skewed"
    prev = stream_wave(gen, L, A)
    bins_t, g, h, hl, active = stream_wave(gen, L, A, skew=skew)
    inv, src = slot_tables(active, L, collect_unbagged=True)
    rows = _active_rows(hl, inv)
    n_active = int(rows.numel())
    vp = pack_values(prev[1], prev[2], "hhilo", R)
    vals = pack_values(g, h, "hhilo", R)
    C = vals.shape[0]
    carry = hist_active_float_raw(prev[0], vp, prev[3], active, L, 63)
    got = hist_active_float_raw(bins_t, vals, hl, active, L, 63,
                                carry.clone())
    cpu = [t.cpu() for t in (bins_t, vals, hl, inv, src, carry)]
    t0 = time.time()
    ref = hist_float_plain(*cpu[:5], B, cpu[5].clone())
    pl = 1e3 * (time.time() - t0)
    got = got.cpu()
    err = float((got - ref).abs().max())
    same = torch.equal(got.view(torch.int32), ref.view(torch.int32))
    if not (same and not torch.equal(cpu[5], ref)):
        raise AssertionError(f"hist_float kernel != plain version ({shape}, "
                             f"max abs err {err})")
    plan = float_plan(A, B, C)
    part, counts = float_scratch(R, A, G, B, C, dev)
    obuf = carry.clone()

    def run(phase):
        return hist_float_launcher(bins_t, vals, hl, inv, src, L, B, plan,
                                   part, counts, obuf, phase)
    ms = time_ms(run("both"), 10)
    partial_ms = time_ms(run("partial"), 10)
    fold_ms = time_ms(run("fold"), 10)
    idx = _flat_cells(bins_t, hl, inv, rows, B, C).reshape(-1)
    vv = vals[:, rows].t()[None].expand(G, -1, -1).reshape(-1).contiguous()
    lacc = carry.clone().reshape(-1)
    lib_ms = time_ms(lambda: lacc.index_add_(0, idx, vv), 5)
    bd = bound(G * R + 4 * C * R + 4 * R + 2 * carry.numel() * 4
               + (L + 1 + A) * 4, G * C * n_active + carry.numel(),
               FP32_OPS_PER_S)
    # the contract's own floor: each (chunk, slot) pair with rows writes a
    # G x B x C f32 partial that the fold reads back
    slot = inv.long()[torch.where(hl >= 0, hl.long(), L)][rows]
    pairs = int(torch.unique((rows // FLOAT_CHUNK) * A + slot).numel())
    partial_bytes = 2 * pairs * G * B * C * 4
    floor_ms = partial_bytes / PEAK_BYTES_PER_S * 1e3
    log(f"kernel hist_float (K5 hhilo, {shape}) A={A} rows={R}: bitwise ok "
        f"(seeded), {ms:.4f} ms = partials {partial_ms:.4f} + fold "
        f"{fold_ms:.4f} ms (plain on the CPU {pl:.1f} ms, f32 index_add_ "
        f"{lib_ms:.4f} ms, bound {bd['bound_ms']:.4f} ms by "
        f"{bd['bound_by']}, contract floor {floor_ms:.4f} ms for "
        f"{pairs} chunk partials, {plan.warps} warps/block)")
    return dict(ms=ms, plain_ms=pl, plain_device="cpu", library_ms=lib_ms,
                max_abs_err=err, rows=R, slots=A, mode="hhilo", shape=shape,
                active_rows=n_active, partial_ms=partial_ms,
                fold_ms=fold_ms, chunk_partials=pairs,
                contract_floor_ms=floor_ms, warps=plan.warps, **bd)


def stream_kernel_phase(int_rate: float, entries) -> dict:
    """K5 on int8h and hhilo values (a uniform and a skewed wave) and the
    seeded K3 at the stream path's shapes, each adding into the carry a
    previous block left: bitwise against the plain version, times and
    bounds.  Appends the two K5 entries; -> the seeded K3 numbers."""
    import torch
    from lightgbm_tpu_torch.ops import cuda_build
    from lightgbm_tpu_torch.ops.compact import hist_compact_raw
    from lightgbm_tpu_torch.ops.histogram import (
        bin_stride, hist_launcher, hist_plain, hist_plan, hist_slab,
        pack_values_q, slot_tables)
    dev = torch.device("cuda")
    sms = cuda_build.multiprocessor_count(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    G, R = STREAM_FEATURES, STREAM_BLOCK
    B = bin_stride(63)

    uni = k5_int8h_measure(gen, "uniform", int_rate)
    entries.append(dict(
        name="hist_active", route="cuda",
        source="lightgbm_tpu_torch/csrc/hist_active.cu",
        replaces="lightgbm_tpu/ops/pallas_histogram.py:343",
        max_abs_err=0.0, **uni,
        skewed=k5_int8h_measure(gen, "skewed", int_rate)))
    uni = k5_float_measure(gen, "uniform")
    entries.append(dict(
        name="hist_float", route="cuda",
        source="lightgbm_tpu_torch/csrc/hist_float.cu",
        replaces="lightgbm_tpu/ops/pallas_histogram.py:343", **uni,
        skewed=k5_float_measure(gen, "skewed")))

    # -- K3 seeded at 128 slots (255 leaves) -------------------------------
    L3, A3 = 255, 128
    prev = stream_wave(gen, L3, A3)
    bins_t, g, h, hl, active = stream_wave(gen, L3, A3)
    active = prev[4]
    vp, sc = pack_values_q(prev[1], prev[2], "int8h", R)
    vals, _ = pack_values_q(g, h, "int8h", R, scales=sc)
    C = vals.shape[0]
    carry = hist_compact_raw(prev[0], vp, prev[3], active, L3, 63)
    got = hist_compact_raw(bins_t, vals, hl, active, L3, 63, carry.clone())
    inv, src = slot_tables(active, L3, collect_unbagged=False)
    ref = carry + hist_plain(bins_t, vals, hl, inv, src, B)
    torch.cuda.synchronize()
    if not (torch.equal(got, ref) and not torch.equal(carry, ref)):
        raise AssertionError("seeded hist_compact kernel != plain version")
    plan = hist_plan(R, G, A3, B, C, sms, L3, False)
    slab = hist_slab(plan, A3, G, B, C, dev)
    obuf = carry.clone()
    ms = time_ms(hist_launcher("hist_compact", bins_t, vals, hl, inv, src, L3,
                               B, plan, slab, obuf), 20)
    log(f"kernel hist_compact (K3 seeded) A={A3} rows={R}: bitwise ok, "
        f"{ms:.4f} ms")
    return dict(rows=R, slots=A3, ms=ms, seeded=True, plan=plan.__dict__)


def stream_paths(lgb, counters, tmp: str) -> dict:
    """The identity and scale phases of the streamed path: -> launches
    per phase."""
    import numpy as np
    import torch
    from lightgbm_tpu_torch.boosting.gbdt import GBDT
    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.metric.metrics import binary_auc
    oc = lgb.outofcore
    cfg = Config.from_params(STREAM_PARAMS)

    def run(name, store, params=STREAM_PARAMS):
        for fn in counters.values():
            fn.launches = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        bst = lgb.train_streaming(params, store,
                                  num_boost_round=STREAM_ITERS,
                                  block_rows=STREAM_BLOCK, device="cuda")
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = {k: fn.launches for k, fn in counters.items()}
        peak = torch.cuda.max_memory_allocated()
        log(f"{name}: {store.n} rows x {STREAM_ITERS} iterations in "
            f"{wall:.3f} s = {store.n * STREAM_ITERS / wall:.4g} rows/s; "
            f"peak device memory {peak / 2**20:.1f} MiB; launches "
            f"{launches}")
        return bst, launches

    # identity: streamed == in memory, digest with scores
    t0 = time.time()
    store = oc.ingest_synthetic(os.path.join(tmp, "ident"),
                                STREAM_IDENT_ROWS, STREAM_FEATURES, cfg,
                                seed=3, shard_rows=STREAM_IDENT_ROWS)
    log(f"stream identity: ingest {time.time() - t0:.1f} s")
    bst, ident = run("stream identity", store)
    for k in ("hist_active", "route", "route_values"):
        if ident[k] <= 0:
            raise AssertionError(f"{k} did not launch in the stream")
    if ident["hist_float"] != 0:
        raise AssertionError("the float K5 ran on an int8h stream")
    for fn in counters.values():
        fn.launches = 0
    mem = GBDT(cfg, store.to_binned_dataset(cfg), "cuda")
    for _ in range(STREAM_ITERS):
        mem.train_one_iter()
    torch.cuda.synchronize()
    if counters["hist_route"].launches <= 0:
        raise AssertionError("K1 did not launch in memory")
    d_str, d_mem = bst.digest(), mem.digest()
    log(f"stream identity: streamed {d_str} in memory {d_mem}")
    if d_str != d_mem:
        raise AssertionError("streamed digest != in-memory digest")
    del mem

    # scale: past the int8 row bound the stream runs hhilo
    t0 = time.time()
    store = oc.ingest_synthetic(
        os.path.join(tmp, "scale"), STREAM_SCALE_ROWS, STREAM_FEATURES, cfg,
        seed=2, shard_rows=max(STREAM_BLOCK, STREAM_SCALE_ROWS // 32))
    log(f"stream scale: ingest {time.time() - t0:.1f} s, "
        f"{len(store.manifest['shards'])} shards")
    bst, scale = run("stream scale", store)
    log(f"stream scale: digest {bst.digest()}")
    if scale["hist_float"] <= 0:
        raise AssertionError("the float K5 did not launch past the int8 "
                             "row bound")
    if scale["hist_active"] != 0 or scale["hist_route"] != 0:
        raise AssertionError("an int8h histogram kernel ran on the hhilo "
                             "stream")
    scores = bst.scores.numpy()[:, 0]
    auc = binary_auc(store.labels_array(), scores)
    log(f"stream scale: train auc {auc:.5f}")
    if not np.isfinite(scores).all():
        raise AssertionError("streamed scores are not finite")
    if not auc >= AUC_GATE:
        raise AssertionError(f"stream auc {auc} < {AUC_GATE}")

    # the same 20M rows in memory: past the int8 row bound the in-memory
    # learner runs hhilo through the float K1 (63 leaves: waves of <= 32
    # slots) and must build the streamed model, scores included
    t0 = time.time()
    ds20 = store.to_binned_dataset(cfg)
    log(f"in-memory 20M: dataset from the store {time.time() - t0:.1f} s")

    def in_memory(name, params):
        for fn in counters.values():
            fn.launches = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        mem = GBDT(Config.from_params(params), ds20, "cuda")
        for _ in range(STREAM_ITERS):
            mem.train_one_iter()
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = {k: fn.launches for k, fn in counters.items()}
        peak = torch.cuda.max_memory_allocated()
        log(f"{name}: {store.n} rows x {STREAM_ITERS} iterations in memory "
            f"in {wall:.3f} s (upload included); peak device memory "
            f"{peak / 2**20:.1f} MiB; launches {launches}")
        if not peak < INMEM_PEAK_LIMIT:
            raise AssertionError(f"{name}: peak device memory {peak} B >= "
                                 f"{INMEM_PEAK_LIMIT} B")
        for k in ("hist_route", "hist_compact", "hist_active"):
            if launches[k] != 0:
                raise AssertionError(f"{name}: the int8 kernel {k} ran on "
                                     f"the hhilo path")
        return mem, launches

    mem, inmem = in_memory("in-memory scale", STREAM_PARAMS)
    d_str, d_mem = bst.digest(), mem.digest()
    log(f"in-memory scale: streamed {d_str} in memory {d_mem}")
    if d_str != d_mem:
        raise AssertionError("in-memory 20M digest != streamed scale digest")
    if inmem["hist_route_float"] <= 0:
        raise AssertionError("the float K1 did not launch in memory")
    del mem, bst

    # the headline's width on the same rows: 255 leaves (float K3 on the
    # 64- and 128-slot waves in memory), streamed and in memory
    bst, head_str = run("stream 20M headline width", store,
                        HEAD20_PARAMS)
    mem, head_mem = in_memory("in-memory 20M headline width", HEAD20_PARAMS)
    d_str, d_mem = bst.digest(), mem.digest()
    log(f"20M headline width: streamed {d_str} in memory {d_mem}")
    if d_str != d_mem:
        raise AssertionError("in-memory 20M headline-width digest != "
                             "streamed digest")
    for k in ("hist_route_float", "hist_compact_float", "route",
              "route_values"):
        if head_mem[k] <= 0:
            raise AssertionError(f"{k} did not launch in memory at the "
                                 f"headline width")
    return {"stream_identity": ident, "stream_scale": scale,
            "inmem_scale": inmem, "stream_20m_headline": head_str,
            "inmem_20m_headline": head_mem}


def train_path(lgb, name, counters, params, ds, rounds, **kw):
    """One user-facing ``lgb.train`` with every launch counter reset just
    before and read just after: -> ``(booster, seconds, launches)``."""
    import torch
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.time()
    bst = lgb.train(dict(params), ds, num_boost_round=rounds, device="cuda",
                    **kw)
    torch.cuda.synchronize()
    seconds = time.time() - t0
    launches = {k: fn.launches for k, fn in counters.items()}
    log(f"{name}: {bst.current_iteration()} iterations in {seconds:.3f} s "
        f"= {1e3 * seconds / max(1, bst.current_iteration()):.2f} ms/iter "
        f"(setup included); launches {launches}")
    return bst, seconds, launches


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
    from lightgbm_tpu_torch.ops.compact import (hist_compact_float_raw,
                                                hist_compact_raw)
    from lightgbm_tpu_torch.ops.histogram import (hist_active_float_raw,
                                                  hist_active_raw,
                                                  hist_route_float_raw,
                                                  hist_route_raw,
                                                  pack_values_q)
    from lightgbm_tpu_torch.ops.route import (route_rows_raw,
                                              route_rows_values_raw)
    from lightgbm_tpu_torch.ops.split_kernel import find_best_splits_kernel
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
    float_kernel_phase(dd, entries)

    # 3. kernels at the small-data path's shapes
    t0 = time.time()
    Xs, ys, Xv, yv = small_data()
    ds_small = lgb.Dataset(Xs, label=ys,
                           params={"max_bin": TRAIN_CONF["max_bin"]})
    dv_small = lgb.Dataset(Xv, label=yv, reference=ds_small)
    ds_small.construct()
    dv_small.construct()
    log(f"small-data data + binning {time.time() - t0:.1f} s")
    dds = to_device(ds_small._constructed, "cuda")
    gs = torch.randn(dds.num_data, device="cuda") * 0.5
    hs = torch.rand(dds.num_data, device="cuda") * 0.25
    vals_s, _ = pack_values_q(gs, hs, "int8h", dds.n_pad)
    small_kernel_phase(dds, vals_s, int32_ops_per_s(
        cuda_build.multiprocessor_count(dds.device)), entries)
    torch.cuda.synchronize()

    counters = {"route": route_rows_raw, "route_values": route_rows_values_raw,
                "hist_route": hist_route_raw, "hist_compact": hist_compact_raw,
                "split_scan": find_best_splits_kernel,
                "hist_active": hist_active_raw,
                "hist_float": hist_active_float_raw,
                "hist_route_float": hist_route_float_raw,
                "hist_compact_float": hist_compact_float_raw}

    # 4. the headline path through the user entry points
    params = {"objective": "binary", "num_leaves": 255, "max_bin": 63,
              "learning_rate": 0.1, "min_data_in_leaf": 20, "verbose": -1}
    bst, _, head = train_path(lgb, "headline", counters, params, ds,
                              HEADLINE_ITERS)
    pred = bst.predict(X)
    torch.cuda.synchronize()
    auc = binary_auc(y, pred)
    log(f"headline: train auc {auc:.5f}; digest "
        f"{bst.digest(include_scores=False)}")
    if pred.shape != (HEADLINE_ROWS,) or not np.isfinite(pred).all():
        raise AssertionError("predictions are not finite [n] values")
    if not auc >= AUC_GATE:
        raise AssertionError(f"train auc {auc} < {AUC_GATE}")
    missing = [k for k in ("route", "route_values", "hist_route",
                           "hist_compact") if head[k] <= 0]
    if missing:
        raise AssertionError(f"kernels not launched on the headline path: "
                             f"{missing}")
    if head["split_scan"] != 0:
        raise AssertionError("the split kernel ran above 65,536 rows")

    # 5. the small-data path: train.conf with a valid set and early stop
    evals = {}
    bst, _, small = train_path(
        lgb, "small-data", counters, TRAIN_CONF, ds_small, SMALL_ITERS,
        valid_sets=[dv_small], valid_names=["valid"],
        early_stopping_rounds=SMALL_EARLY_STOP, evals_result=evals,
        verbose_eval=False)
    pred = bst.predict(Xv)
    torch.cuda.synchronize()
    vauc = binary_auc(yv, pred)
    log(f"small-data: valid auc {vauc:.5f} at best_iteration "
        f"{bst.best_iteration}; last recorded valid auc "
        f"{evals['valid']['auc'][-1]:.5f}, train auc "
        f"{evals['training']['auc'][-1]:.5f}; digest "
        f"{bst.digest(include_scores=False)}")
    if pred.shape != (SMALL_VALID,) or not np.isfinite(pred).all():
        raise AssertionError("valid predictions are not finite [n] values")
    if not vauc >= VALID_AUC_GATE:
        raise AssertionError(f"valid auc {vauc} < {VALID_AUC_GATE}")
    missing = [k for k in ("split_scan", "hist_route", "route_values")
               if small[k] <= 0]
    if missing:
        raise AssertionError(f"kernels not launched on the small-data "
                             f"path: {missing}")

    # 6. the headline through lgb.train on float values: gpu_use_dp
    # selects hilo
    fparams = dict(params, gpu_use_dp=True)
    bst, _, hfloat = train_path(lgb, "headline float (gpu_use_dp)", counters,
                                fparams, ds, FLOAT_ITERS)
    pred = bst.predict(X)
    torch.cuda.synchronize()
    auc = binary_auc(y, pred)
    log(f"headline float: hist_mode {bst._gbdt.hist_mode}, train auc "
        f"{auc:.5f}; digest {bst.digest(include_scores=False)}")
    if bst._gbdt.hist_mode != "hilo":
        raise AssertionError("gpu_use_dp did not select hilo")
    if pred.shape != (HEADLINE_ROWS,) or not np.isfinite(pred).all():
        raise AssertionError("float predictions are not finite [n] values")
    if not auc >= AUC_GATE:
        raise AssertionError(f"float train auc {auc} < {AUC_GATE}")
    missing = [k for k in ("hist_route_float", "route", "hist_compact_float",
                           "route_values") if hfloat[k] <= 0]
    if missing:
        raise AssertionError(f"kernels not launched on the float headline "
                             f"path: {missing}")
    ran = [k for k in ("hist_route", "hist_compact", "hist_active")
           if hfloat[k] != 0]
    if ran:
        raise AssertionError(f"int8 kernels ran on the float path: {ran}")
    del bst

    # 7.-11. the streamed out-of-core path
    int_rate = int32_ops_per_s(cuda_build.multiprocessor_count(dd.device))
    k3 = stream_kernel_phase(int_rate, entries)
    for e in entries:
        if e["name"] == "hist_compact":
            e["stream_seeded"] = k3
    torch.cuda.synchronize()
    tmp = tempfile.mkdtemp(prefix="lgbm_stream_")
    try:
        by_path = {"headline": head, "small_data": small,
                   "headline_float": hfloat,
                   **stream_paths(lgb, counters, tmp)}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    for e in entries:
        e["launches_by_path"] = {p: c[e["name"]] for p, c in by_path.items()}
        e["launches"] = sum(e["launches_by_path"].values())
    print(json.dumps({"kernels": entries}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
