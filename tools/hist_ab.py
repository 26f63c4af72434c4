#!/usr/bin/env python3
"""Before/after measurement of the port's kernels on one NVIDIA GPU,
against the kernels of a parent tree.

    python3 tools/hist_ab.py --quick [--out FILE]
    python3 tools/hist_ab.py --parent DIR [--out FILE]
    python3 tools/hist_ab.py --sweep [--out FILE]

``--quick``: print what ``ptxas -v`` reports for every kernel source of
this tree (registers, shared memory, spills) and what ``cuobjdump -sass``
finds in each library (shared atomics by opcode, float atomics of any
space, fused multiply-adds; the float K1 and K3 and the wide histogram
must hold no float atomic; the split scan must hold no more FFMAs than its
build with
``-fmad=false``: its sums are held bitwise to the reference's rounded
adds and products), then run the kernel phases of
``chip_smoke.py`` (every kernel once at its path's shapes, held bitwise
against its plain version, and timed) and stop.

``--sweep``: time this tree's float K3 at the waves of ``chip_smoke.py``'s
phase 2b with each of several walk budgets
(``FLOAT_LIGHT_ROWS_PER_CHUNK``), which must all give the same bits.

``--parent DIR``: ``DIR`` holds a checkout of the parent tree (only its
``lightgbm_tpu_torch/csrc`` is read).  Its sources are built with
``nvcc`` into a temporary directory and loaded with this tree's C
interface, or, for the float K1 and K3 of a parent without
``hist_float_walk.cuh``, with theirs before it (``WHOLE_CALL_FLOAT``),
and for a wide histogram whose entry point still takes the warps of its
walk, with that one (``WARPS_CALL_WIDE``), launched the way that
parent's wrappers launched them; the parent's
split kernel takes blocks of at most ``PARENT_SPLIT_THREADS`` threads.
At the shapes ``chip_smoke.py`` uses (the float K1 and K3 at every wave
of its phase 2b), each kernel of both trees runs once on the same
inputs (results must be bitwise equal, float ones by bit pattern), then
is timed in turns: parent, change, change, parent (the split scan also
as launches captured in a CUDA graph).  Then the small-data path of
``chip_smoke.py`` (``train.conf`` on 65,536 rows with its valid set and
early stopping), its 20,000,000-row hhilo stream and those rows trained
in memory with the headline's 255 leaves (the float K1 and K3) train
with the parent's kernels and with this tree's, in the same order, and
the four digests of each must be equal.  The wide histogram (the exact-
f32 kernel past the histogram kernels' domain) runs both trees at
``chip_smoke.py``'s phase-25 waves (``max_bin`` 1023 at 128 slots and
2,048 leaves at 1,024, a root and a mid-tree wave each), bitwise equal
and timed in turns, and the ``max_bin``-1023 and 2,048-leaf paths of
that phase train with each tree's kernels (four equal digests each).
K2 and K4 of both trees (a parent without ``lgbm_route_plan`` through
its grid call, ``GRID_CALL_ROUTE``, launched as its wrapper launched
them) run on the same waves, bitwise equal and equal to their plain
versions, timed in turns back to back and in a CUDA graph: the
headline, its categorical data, the small-data path's last pass, the
ranking shape, 2,048-leaf tables at 64 and 1,024 splits, a 131,072-leaf
wave at 65,536 and int32 bins at ``max_bin`` 1023.  It also reports
whether the K1 and float-K1 libraries hold the parent's instructions.
Prints a summary and, with ``--out``, writes the results as one JSON
object; times are means over back-to-back launches (warm), on the card
named in the output.
"""
from __future__ import annotations

import argparse
import contextlib
import ctypes
import functools
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from lightgbm_tpu_torch.ops import cuda_build  # noqa: E402

# the parent's split kernel: blocks of at most this many threads (a warp
# per feature since PR 5; a parent before it took 256)
PARENT_SPLIT_THREADS = 1024
STREAM_G = cs.STREAM_FEATURES
# the float K1 and K3 before hist_float_walk.cuh: K1 the float K5's
# partial and fold kernels over windows of FLOAT_WINDOW rows (its partial
# kernel's plan: ops/histogram.py float_plan), K3 one call of a sort by
# slot and a walk of at most 12 warps a block
_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
WHOLE_CALL_FLOAT = {
    "hist_route_float": {
        "lgbm_hist_route_float": [_P, _LL, _LL, _I, _P, _I, _P, _P, _P, _I,
                                  _P, _I, _P, _P, _I, _I, _I, _I, _I, _P,
                                  _P, _P, _P]},
    "hist_compact_float": {
        "lgbm_hist_compact_float": [_P, _LL, _I, _P, _I, _P, _I, _P, _P, _I,
                                    _I, _I, _I, _I, _P, _P, _P, _P, _P, _P]},
}
WHOLE_CALL_K3_MAX_WARPS = 12
# the wide histogram before its redesign: one call with per-chunk slot
# counts, slot starts, a row order and the warps of its walk
WARPS_CALL_WIDE = {
    "hist_wide": {
        "lgbm_hist_wide": [_P, _I, _LL, _LL, _I, _P, _P, _P, _P, _I, _I, _I,
                           _I, _P, _P, _P, _I, _P, _P]},
}
WARPS_CALL_CHUNK = 4096
WARPS_CALL_SMEM = 96 * 1024
# K2/K4 before their redesign: no launch plan and no scratch, a grid of
# at most four 512-thread blocks an SM, one row a thread at a time
GRID_CALL_ROUTE = {
    "route": {
        "lgbm_route_rows": [_P, _LL, _P, _P, _P, _I, _P, _I, _I, _I, _P],
        "lgbm_route_rows_values": [_P, _LL, _P, _P, _P, _I, _P, _I, _P, _P,
                                   _I, _I, _P],
        "lgbm_route_rows_i32": [_P, _LL, _P, _P, _P, _I, _P, _I, _I, _I, _P],
        "lgbm_route_rows_values_i32": [_P, _LL, _P, _P, _P, _I, _P, _I, _P,
                                       _P, _I, _I, _P]},
}
GRID_CALL_BLOCK = 512
GRID_CALL_BLOCKS_PER_SM = 4


def _sass(so: str) -> str:
    return subprocess.run(
        [os.path.join(os.path.dirname(cuda_build.nvcc_path()), "cuobjdump"),
         "-sass", so], capture_output=True, text=True).stdout


def same_sass(name: str, parent_so: str) -> bool:
    """Whether library ``name`` of this tree and the parent's hold the
    same instructions (addresses, encodings and branch targets aside):
    a kernel whose code did not change keeps its time."""
    def code(so):
        text = re.sub(r"/\*[0-9a-f]{4}\*/|/\* 0x[0-9a-f]+ \*/", "",
                      _sass(so))
        return [ln.strip() for ln in text.splitlines()
                if ln.strip() and not re.search(r"\b(BRA|BSSY|CALL)\b", ln)
                and ln.strip().split()[0] not in ("Fatbin", "code",
                                                  "Function", "arch",
                                                  "host", "compressed")
                and not ln.strip().startswith((".", "="))]
    return code(str(cuda_build._library_path(name))) == code(parent_so)


def ptxas_report() -> tuple:
    """``nvcc -Xptxas -v`` of every kernel source, all at once, and what
    the SASS of each library holds: shared atomics by opcode and fused
    multiply-adds.  The split scan is built a second time with
    ``-fmad=false``: its FFMA count must not change (the IEEE divides
    hold FFMAs of their own; a contracted ``a*b + c`` would add some).
    -> (report, whether the split scan passed)."""
    tmp = tempfile.mkdtemp(prefix="ptxas_")
    jobs = [(name, os.path.join(tmp, f"{name}.so"), ("-Xptxas", "-v"))
            for name in cuda_build.LIBRARIES]
    jobs.append(("split", os.path.join(tmp, "split-nofma.so"),
                 ("-fmad=false",)))
    procs = []
    for name, so, extra in jobs:
        cmd = [cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, *extra, "-I",
               str(cuda_build.CSRC), "-o", so,
               str(cuda_build.CSRC / f"{name}.cu")]
        procs.append((name, so, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    lines = []
    ffma, fatom = {}, {}
    for name, so, p in procs:
        out, _ = p.communicate()
        lines += [f"{name}: {ln}" for ln in out.decode().splitlines()
                  if "ptxas" in ln and ("registers" in ln or "spill" in ln
                                        or "Compiling" in ln)]
        dump = _sass(so)
        ops = {}
        for op in re.findall(r"\b(ATOMS\.[A-Z0-9.]+)", dump):
            ops[op] = ops.get(op, 0) + 1
        base = os.path.basename(so)
        ffma[base] = len(re.findall(r"\bFFMA\b", dump))
        # float atomics of any space: ATOMS/ATOMG/ATOM/RED on F16-F64
        fatom[base] = re.findall(
            r"\b((?:ATOMS|ATOMG|ATOM|RED)\.[A-Z0-9.]*\bB?F(?:16|32|64)\b"
            r"[A-Z0-9.]*)", dump)
        lines.append(f"{base}: shared atomics {ops}, float atomics "
                     f"{len(fatom[base])}, FFMA {ffma[base]}")
    shutil.rmtree(tmp, ignore_errors=True)
    ok = ffma["split.so"] == ffma["split-nofma.so"]
    lines.append(f"split scan: FFMA {ffma['split.so']} with contraction on, "
                 f"{ffma['split-nofma.so']} with -fmad=false: "
                 f"{'nothing contracted' if ok else 'CONTRACTED'}")
    floats = {n: fatom[f"{n}.so"] for n in ("hist_route_float",
                                            "hist_compact_float",
                                            "hist_wide")}
    lines.append(f"float K1/K3 and wide histogram float atomics: {floats}")
    return "\n".join(lines), ok and not any(floats.values())


def takes_walk_warps(csrc: str) -> bool:
    """Whether a tree's wide histogram has the entry point that takes the
    warps of its walk (``WARPS_CALL_WIDE``)."""
    path = os.path.join(csrc, "hist_wide.cu")
    return os.path.exists(path) and re.search(
        r"lgbm_hist_wide\([^)]*\bint warps\b", open(path).read()) is not None


def takes_route_grid(csrc: str) -> bool:
    """Whether a tree's K2/K4 take the grid call (``GRID_CALL_ROUTE``:
    no ``lgbm_route_plan``)."""
    path = os.path.join(csrc, "route.cu")
    return os.path.exists(path) and "lgbm_route_plan" not in open(path).read()


def build_parent(parent: str, out_dir: str) -> tuple:
    """Build the parent's kernel sources: -> (name -> library, whether
    its float K1 and K3 take the whole-call interface, whether its wide
    histogram takes the warps call, whether its K2/K4 take the grid
    call).
    Libraries are loaded with this tree's C interface or those.  A
    library the parent does not have yet is left out (both sides then
    launch this tree's)."""
    csrc = os.path.join(parent, "lightgbm_tpu_torch", "csrc")
    whole = not os.path.exists(os.path.join(csrc, "hist_float_walk.cuh"))
    warps = takes_walk_warps(csrc)
    grid = takes_route_grid(csrc)
    interfaces = dict(cuda_build.LIBRARIES,
                      **(WHOLE_CALL_FLOAT if whole else {}),
                      **(WARPS_CALL_WIDE if warps else {}),
                      **(GRID_CALL_ROUTE if grid else {}))
    procs = []
    for name in cuda_build.LIBRARIES:
        if not os.path.exists(os.path.join(csrc, f"{name}.cu")):
            continue
        path = os.path.join(out_dir, f"lib{name}-parent.so")
        # -fno-gnu-unique: the static locals of the sources' inline host
        # functions (shared-memory opt-ins, a side stream) are otherwise
        # one object across both trees' libraries in this process, so
        # the parent's kernels would skip their own opt-ins
        cmd = [cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS,
               "-Xcompiler", "-fno-gnu-unique", "-I", csrc,
               "-o", path, os.path.join(csrc, f"{name}.cu")]
        procs.append((name, path, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    libs = {}
    for name, path, p in procs:
        out, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"parent {name}.cu: {out.decode()}")
        lib = ctypes.CDLL(path)
        for fn, argtypes in interfaces[name].items():
            f = getattr(lib, fn)
            f.argtypes = argtypes
            f.restype = ctypes.c_int
        libs[name] = lib
    return libs, whole, warps, grid


@contextlib.contextmanager
def kernels_of(libs: dict, split_threads: int, whole_float: bool = False,
               wide_warps: bool = False, route_grid: bool = False):
    """Launch through ``libs`` (name -> library) in place of the loaded
    ones, the split scan with blocks of at most ``split_threads``; with
    ``whole_float`` the float K1 and K3 through the wrappers of the
    whole-call interface, with ``wide_warps`` the wide histogram through
    the warps call (and its scratch counted as its wrapper allocated it
    in the learner's setup check), with ``route_grid`` K2/K4 through the
    grid call."""
    from lightgbm_tpu_torch.learner import serial
    from lightgbm_tpu_torch.ops import compact, histogram, route, split_kernel
    saved = dict(cuda_build._loaded)
    launch = split_kernel.split_scan_launch
    k1, k3 = histogram.hist_route_float_raw, compact.hist_compact_float_raw
    wide, wide_scratch = (histogram.hist_wide_launch,
                          serial.hist_wide_scratch_bytes)
    route_launch = route.route_launch
    cuda_build._loaded.update(libs)
    if route_grid:
        route.route_launch = functools.partial(grid_call_route,
                                               libs["route"])
    split_kernel.split_scan_launch = functools.partial(launch,
                                                       threads=split_threads)
    if whole_float:
        histogram.hist_route_float_raw = functools.partial(whole_k1_raw, k1)
        compact.hist_compact_float_raw = functools.partial(whole_k3_raw, k3)
    if wide_warps:
        histogram.hist_wide_launch = functools.partial(warps_call_wide,
                                                       libs["hist_wide"])
        serial.hist_wide_scratch_bytes = warps_call_scratch
    try:
        yield
    finally:
        cuda_build._loaded.clear()
        cuda_build._loaded.update(saved)
        split_kernel.split_scan_launch = launch
        histogram.hist_route_float_raw = k1
        compact.hist_compact_float_raw = k3
        histogram.hist_wide_launch = wide
        serial.hist_wide_scratch_bytes = wide_scratch
        route.route_launch = route_launch


def grid_call_route(plib, bins_t, leaf2, out, tabs, cat_mask,
                    leaf_values=None, values_out=None, scratch=None,
                    lib=None):
    """K2 (with ``leaf_values``: K4) through the grid call of ``lib``
    (default ``plib``), launched as its wrapper launched it: -> the CUDA
    error code.  ``scratch`` is not taken."""
    import torch
    from lightgbm_tpu_torch.ops.route import route_entry
    dev = bins_t.device
    n_pad, L = bins_t.shape[1], tabs.shape[1]
    values = leaf_values is not None
    grid = max(1, min(-(-n_pad // GRID_CALL_BLOCK), GRID_CALL_BLOCKS_PER_SM
                      * cuda_build.multiprocessor_count(dev)))
    extra = (leaf_values.data_ptr(), values_out.data_ptr()) if values else ()
    return route_entry(lib or plib, bins_t, values)(
        bins_t.data_ptr(), n_pad, leaf2.data_ptr(), out.data_ptr(),
        tabs.data_ptr(), L, cat_mask.data_ptr(), cat_mask.shape[1], *extra,
        grid, GRID_CALL_BLOCK, torch.cuda.current_stream(dev).cuda_stream)


def warps_call_scratch(n: int, G: int, A: int, B: int) -> int:
    """Bytes the warps call's wrapper allocated beside its histogram
    (the slot sort's counts, starts and order)."""
    return 4 * (max(1, -(-n // WARPS_CALL_CHUNK)) * A + A + 1 + max(1, n))


def warps_call_wide(lib, bins_t, grad, hess, hist_leaf, inv, L, B, out):
    """The wide histogram through the warps call, launched as its wrapper
    launched it (slot sort chunks of ``WARPS_CALL_CHUNK`` rows, 1-8 warps
    a block in ``WARPS_CALL_SMEM``): -> the CUDA error code."""
    import torch
    G, n_pad = bins_t.shape
    n, A, dev = grad.shape[0], out.shape[0], bins_t.device
    nchunks = -(-n // WARPS_CALL_CHUNK)
    counts = torch.empty(max(1, nchunks) * A, dtype=torch.int32, device=dev)
    start = torch.empty(A + 1, dtype=torch.int32, device=dev)
    order = torch.empty(max(1, n), dtype=torch.int32, device=dev)
    warps = max(1, min(8, WARPS_CALL_SMEM // ((3 * B + 64) * 4)))
    return lib.lgbm_hist_wide(
        bins_t.data_ptr(), int(bins_t.dtype == torch.int32), n_pad, n, G,
        grad.data_ptr(), hess.data_ptr(), hist_leaf.data_ptr(),
        inv.data_ptr(), L, A, B, WARPS_CALL_CHUNK, counts.data_ptr(),
        start.data_ptr(), order.data_ptr(), warps, out.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)


def whole_k1_windows(lib, bins_t, vals, leaf2, inv, src, L, B, acc,
                     leaf2_out, tabs, cat):
    """The whole-call float K1 over windows of ``FLOAT_WINDOW`` rows: ->
    one callable per window."""
    import torch
    from lightgbm_tpu_torch.ops.histogram import (
        FLOAT_CHUNK, FLOAT_WINDOW, BoundLaunch, float_plan, float_scratch)
    G, n_pad = bins_t.shape
    C, A = vals.shape[0], src.shape[0]
    plan = float_plan(A, B, C)
    part, counts = float_scratch(min(n_pad, FLOAT_WINDOW), A, G, B, C,
                                 bins_t.device)
    stream = torch.cuda.current_stream(bins_t.device).cuda_stream
    tensors = (bins_t, vals, leaf2, inv, src, part, counts, acc, leaf2_out,
               tabs, cat)
    return [BoundLaunch(lib.lgbm_hist_route_float, (
        bins_t.data_ptr() + w0, n_pad, min(FLOAT_WINDOW, n_pad - w0), G,
        vals.data_ptr() + 4 * w0, C, leaf2.data_ptr() + 4 * w0,
        leaf2_out.data_ptr() + 4 * w0, tabs.data_ptr(), L, cat.data_ptr(),
        cat.shape[1], inv.data_ptr(), src.data_ptr(), A, B, FLOAT_CHUNK,
        plan.chp, plan.warps, part.data_ptr(), counts.data_ptr(),
        acc.data_ptr(), stream), tensors)
        for w0 in range(0, n_pad, FLOAT_WINDOW)]


def whole_k3_call(lib, bins_t, vals, hist_leaf, inv, src, L, B, acc):
    """The whole-call float K3 (its sort and walk), bound: -> a
    callable."""
    import torch
    from lightgbm_tpu_torch.ops.histogram import (FLOAT_CHUNK, SMEM_BLOCK_MAX,
                                                  BoundLaunch)
    G, n_pad = bins_t.shape
    C, A = vals.shape[0], src.shape[0]
    dev = bins_t.device
    K = -(-n_pad // FLOAT_CHUNK)
    warps = next(w for w in range(WHOLE_CALL_K3_MAX_WARPS, 0, -1)
                 if ((w + 1) * B * 32 + w) * 4 <= SMEM_BLOCK_MAX)
    counts = torch.empty((A, K), dtype=torch.int32, device=dev)
    offs = torch.empty_like(counts)
    sbins = torch.empty((n_pad, -(-G // 4)), dtype=torch.int32, device=dev)
    svals = torch.empty((C, n_pad), dtype=torch.int16, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    return BoundLaunch(lib.lgbm_hist_compact_float, (
        bins_t.data_ptr(), n_pad, G, vals.data_ptr(), C, hist_leaf.data_ptr(),
        L, inv.data_ptr(), src.data_ptr(), A, B, FLOAT_CHUNK, warps, 0,
        counts.data_ptr(), offs.data_ptr(), sbins.data_ptr(),
        svals.data_ptr(), acc.data_ptr(), stream),
        (bins_t, vals, hist_leaf, inv, src, acc, counts, offs, sbins, svals))


def whole_k1_raw(counter, bins_t, vals, leaf2, active, tabs, cat_mask,
                 num_leaf_slots, max_bins, acc=None):
    """``hist_route_float_raw`` on the whole-call float K1 (CUDA tensors;
    launches counted on ``counter``)."""
    import torch
    from lightgbm_tpu_torch.ops.histogram import bin_stride, slot_tables
    G = bins_t.shape[0]
    C, A, L = vals.shape[0], active.shape[0], num_leaf_slots
    B = bin_stride(max_bins)
    if acc is None:
        acc = torch.zeros((A, G, B, C), device=bins_t.device)
    inv, src = slot_tables(active, L, collect_unbagged=True)
    leaf2_out = torch.empty_like(leaf2)
    for f in whole_k1_windows(cuda_build.library("hist_route_float"),
                              bins_t, vals, leaf2, inv, src, L, B, acc,
                              leaf2_out, tabs, cat_mask):
        cuda_build.check_launch(f(), "hist_route_float (parent)")
        counter.launches += 1
    return acc, leaf2_out


def whole_k3_raw(counter, bins_t, vals, hist_leaf, active, num_leaf_slots,
                 max_bins, acc=None):
    """``hist_compact_float_raw`` on the whole-call float K3."""
    import torch
    from lightgbm_tpu_torch.ops.histogram import bin_stride, slot_tables
    G = bins_t.shape[0]
    C, A, L = vals.shape[0], active.shape[0], num_leaf_slots
    B = bin_stride(max_bins)
    if acc is None:
        acc = torch.zeros((A, G, B, C), device=bins_t.device)
    inv, src = slot_tables(active, L, collect_unbagged=False)
    f = whole_k3_call(cuda_build.library("hist_compact_float"), bins_t, vals,
                      hist_leaf, inv, src, L, B, acc)
    cuda_build.check_launch(f(), "hist_compact_float (parent)")
    counter.launches += 1
    return acc


def turns(parent_fn, change_fn, reps: int, graph: bool = False) -> dict:
    """Parent, change, change, parent: mean ms of each over ``reps``
    back-to-back launches and, with ``graph``, in a CUDA graph."""
    out = {}
    timers = [("", lambda f: cs.time_ms(f, reps))]
    if graph:
        timers.append(("graph_", cs.graph_ms))
    for prefix, timer in timers:
        p1, c1 = timer(parent_fn), timer(change_fn)
        c2, p2 = timer(change_fn), timer(parent_fn)
        out.update({f"{prefix}parent_ms": [p1, p2],
                    f"{prefix}change_ms": [c1, c2],
                    f"{prefix}ratio": (c1 + c2) / (p1 + p2)})
    return out


class Sides:
    """The parent's and this tree's libraries, and the split scan's
    block size in each."""

    def __init__(self, plibs, whole_float: bool = False,
                 wide_warps: bool = False, route_grid: bool = False):
        self.plibs = plibs
        self.whole_float = whole_float
        self.wide_warps = wide_warps
        self.route_grid = route_grid
        self.mine = {n: cuda_build.library(n) for n in cuda_build.LIBRARIES}

    def parent(self):
        return kernels_of(self.plibs, PARENT_SPLIT_THREADS, self.whole_float,
                          self.wide_warps, self.route_grid)

    def change(self):
        from lightgbm_tpu_torch.ops.split_kernel import SPLIT_THREADS
        return kernels_of(self.mine, SPLIT_THREADS)

    def both(self, make):
        """``make()`` under the parent's kernels, then under this
        tree's: -> (parent's result, change's result)."""
        with self.parent():
            p = make()
        with self.change():
            c = make()
        return p, c


def int_case(sides, kind, bins_t, vals, leaf, inv, src, L, B, carry,
             tabs=None, cat=None):
    """One int32 histogram launch of both trees on the same inputs:
    -> (parent, change, equal)."""
    import torch
    from lightgbm_tpu_torch.ops.histogram import (hist_launcher, hist_plan,
                                                  hist_slab)
    G, n_pad = bins_t.shape
    C, A = vals.shape[0], src.shape[0]
    dev = bins_t.device
    route = kind == "hist_route"
    plan = hist_plan(n_pad, G, A, B, C,
                     cuda_build.multiprocessor_count(dev), L, route)

    def make():
        out = carry.clone()
        lo = torch.empty_like(leaf) if route else None
        fn = hist_launcher(kind, bins_t, vals, leaf, inv, src, L, B, plan,
                           hist_slab(plan, A, G, B, C, dev), out, lo, tabs,
                           cat)
        return fn, (out, lo)
    (parent, p_out), (change, c_out) = sides.both(make)

    def equal():
        if parent() or change():
            raise RuntimeError("launch failed")
        torch.cuda.synchronize()
        return all(a is None or torch.equal(a, b)
                   for a, b in zip(p_out, c_out))
    return parent, change, equal


def float_case(sides, bins_t, vals, hl, inv, src, L, B, carry):
    import torch
    from lightgbm_tpu_torch.ops.histogram import (float_plan, float_scratch,
                                                  hist_float_launcher)
    G, n_pad = bins_t.shape
    C, A = vals.shape[0], src.shape[0]

    def make():
        part, counts = float_scratch(n_pad, A, G, B, C, bins_t.device)
        out = carry.clone()
        return hist_float_launcher(bins_t, vals, hl, inv, src, L, B,
                                   float_plan(A, B, C), part, counts,
                                   out), out
    (parent, out_p), (change, out_c) = sides.both(make)

    def equal():
        if change() or parent():
            raise RuntimeError("launch failed")
        torch.cuda.synchronize()
        return torch.equal(out_c.view(torch.int32), out_p.view(torch.int32))
    return parent, change, equal


def float_k1_case(sides, dd, vals, leaf2, inv, src, L, B, tabs, cat):
    """The float K1 of both trees on the same inputs, every window of a
    call: -> (parent, change, equal); equal compares the sums by bit
    pattern and leaf2'."""
    import torch
    from lightgbm_tpu_torch.ops.histogram import (
        FLOAT_WINDOW, float_plan, float_scratch, hist_route_float_launches)
    G, n_pad = dd.bins_t.shape
    C, A = vals.shape[0], src.shape[0]

    def make(whole):
        acc = torch.zeros((A, G, B, C), device=dd.device)
        lo = torch.empty_like(leaf2)
        if whole:
            fns = whole_k1_windows(sides.plibs["hist_route_float"],
                                   dd.bins_t, vals, leaf2, inv, src, L, B,
                                   acc, lo, tabs, cat)
        else:
            part, counts = float_scratch(min(n_pad, FLOAT_WINDOW), A, G, B,
                                         C, dd.device)
            fns = hist_route_float_launches(dd.bins_t, vals, leaf2, inv, src,
                                            L, B, float_plan(A, B, C), part,
                                            counts, acc, lo, tabs, cat)
        return (lambda: max(f() for f in fns)), (acc, lo)
    with sides.parent():
        parent, p_out = make(sides.whole_float)
    with sides.change():
        change, c_out = make(False)

    def equal():
        if parent() or change():
            raise RuntimeError("launch failed")
        torch.cuda.synchronize()
        return (cs.bits_equal(p_out[0], c_out[0])
                and torch.equal(p_out[1], c_out[1]))
    return parent, change, equal


def float_k3_case(sides, dd, vals, hl, inv, src, L, B):
    """The float K3 of both trees on the same inputs: -> (parent, change,
    equal); equal compares the sums by bit pattern."""
    import torch
    from lightgbm_tpu_torch.ops.histogram import (
        FloatWalkScratch, float_walk_launches, float_walk_plan)
    G, n_pad = dd.bins_t.shape
    C, A = vals.shape[0], src.shape[0]
    dev = dd.device

    def make(whole):
        acc = torch.zeros((A, G, B, C), device=dev)
        if whole:
            fns = [whole_k3_call(sides.plibs["hist_compact_float"], dd.bins_t,
                                 vals, hl, inv, src, L, B, acc)]
        else:
            plan = float_walk_plan(n_pad, A, G, B, C, L,
                                   cuda_build.multiprocessor_count(dev))
            fns = float_walk_launches(
                dd.bins_t, vals, hl, inv, src, L, B, plan,
                FloatWalkScratch.empty(plan, A, G, B, C, dev), acc)
        return (lambda: max(f() for f in fns)), acc
    with sides.parent():
        parent, p_out = make(sides.whole_float)
    with sides.change():
        change, c_out = make(False)

    def equal():
        if parent() or change():
            raise RuntimeError("launch failed")
        torch.cuda.synchronize()
        return cs.bits_equal(p_out, c_out)
    return parent, change, equal


def wide_case(sides, bins_t, grad, hess, hl, active, L, B):
    """The wide histogram of both trees on the same inputs, each launch
    under its own tree's kernels: -> (parent, change, equal)."""
    import torch
    from lightgbm_tpu_torch.ops import histogram
    shape = (active.shape[0], bins_t.shape[0], B, 3)
    inv = histogram.slot_tables(active, L, collect_unbagged=False)[0]
    outs = {}

    def side(which):
        out = outs[which] = torch.empty(shape, device=bins_t.device)

        def launch():
            with getattr(sides, which)():
                return histogram.hist_wide_launch(bins_t, grad, hess, hl,
                                                  inv, L, B, out)
        return launch
    parent, change = side("parent"), side("change")

    def equal():
        if parent() or change():
            raise RuntimeError("launch failed")
        torch.cuda.synchronize()
        return torch.equal(outs["parent"].view(torch.int32),
                           outs["change"].view(torch.int32))
    return parent, change, equal


def route_case(sides, bins_t, leaf2, tabs, cat, lv=None):
    """K2 (with ``lv``: K4) of both trees on the same wave, each bound to
    its own library with its buffers and scratch allocated once: ->
    (parent, change, equal); equal also holds both to the plain
    version."""
    import torch
    from lightgbm_tpu_torch.ops import route
    dev = bins_t.device
    n_pad, L = bins_t.shape[1], tabs.shape[1]
    outs = {w: (torch.empty_like(leaf2),
                None if lv is None else torch.empty(n_pad, device=dev))
            for w in ("parent", "change")}
    launch = route.route_launch   # this tree's, whatever a context swaps

    def bind(which, lib, grid_call):
        out, vout = outs[which]
        if grid_call:
            return lambda: grid_call_route(lib, bins_t, leaf2, out, tabs,
                                           cat, lv, vout)
        nscratch = route.route_plan(lib, dev, L, lv is not None,
                                    bins_t.dtype == torch.int32).scratch_bytes
        scratch = (torch.empty(nscratch, dtype=torch.uint8, device=dev)
                   if nscratch else None)
        return lambda: launch(bins_t, leaf2, out, tabs, cat, lv, vout,
                              scratch, lib)
    parent = bind("parent", sides.plibs["route"], sides.route_grid)
    change = bind("change", sides.mine["route"], False)

    def equal():
        if parent() or change():
            raise RuntimeError("launch failed")
        torch.cuda.synchronize()
        if lv is None:
            ref = (route.route_plain(bins_t, leaf2, tabs, cat),)
        else:
            ref = route.route_values_plain(bins_t, leaf2, tabs, cat, lv)
        return all(torch.equal(outs[w][i], r) for w in outs
                   for i, r in enumerate(ref))
    return parent, change, equal


def route_kernel_ab(sides) -> list:
    """K2 and K4 of both trees, bitwise equal (and equal to their plain
    versions), timed in turns back to back and in a CUDA graph, at the
    waves ``chip_smoke.py`` measures: the headline (127 leaves of 255, 64
    split), its categorical data (a third of the splits categorical), the
    small-data path's last pass (63 leaves, 256-bin stride, bagged), the
    ranking shape (2.27M x 136), 2,048-leaf tables with 64 and 1,024
    splits, a 131,072-leaf wave with 65,536 splits, and int32 bins at
    ``max_bin`` 1023."""
    import torch
    import lightgbm_tpu_torch as lgb
    from lightgbm_tpu_torch.io.device import to_device
    rows = []

    def measure(shape, dd, leaf2, tabs, cat, L):
        gen = torch.Generator(device="cuda")
        gen.manual_seed(L)
        lv = torch.randn(L, generator=gen, device="cuda")
        for name, v in (("K2 route", None), ("K4 route_values", lv)):
            parent, change, equal = route_case(sides, dd.bins_t, leaf2, tabs,
                                               cat, v)
            if not equal():
                raise AssertionError(f"{name} {shape}: parent != change or "
                                     f"plain")
            r = dict(kernel=name, shape=shape,
                     **turns(parent, change, 50, graph=True))
            cs.log(f"{name} {shape}: parent {r['parent_ms']} change "
                   f"{r['change_ms']} ms, ratio {r['ratio']:.3f}; in a graph "
                   f"parent {r['graph_parent_ms']} change "
                   f"{r['graph_change_ms']} ms, ratio "
                   f"{r['graph_ratio']:.3f}, bitwise equal")
            rows.append(r)

    gen = torch.Generator(device="cuda")
    gen.manual_seed(15)
    X, y = cs.headline_data()
    ds = lgb.Dataset(X, label=y, params={"max_bin": 63}).construct()
    dd = to_device(ds._constructed, "cuda")
    measure("headline", dd, *cs.wave_inputs(dd, 127, 64, 128, gen)[:3], 255)
    Ld, Lw = cs.WIDE_DEEP_LEAVES, cs.WIDEST_LEAVES
    for nl in (64, Ld // 2):
        measure(f"{Ld} leaves, {nl} splits", dd,
                *cs.wave_inputs(dd, nl, nl, 8, gen, Ld)[:3], Ld)
    measure(f"{Lw} leaves, {Lw // 2} splits", dd,
            *cs.wave_inputs(dd, Lw // 2, Lw // 2, 8, gen, Lw)[:3], Lw)
    del dd, ds
    Xc = cs.categorize(X.copy(), 1)
    dsc = lgb.Dataset(Xc, label=y, params={"max_bin": 63},
                      categorical_feature=cs.CAT_COLUMNS).construct()
    ddc = to_device(dsc._constructed, "cuda")
    measure("headline categorical", ddc, *cs.wave_inputs(
        ddc, 127, 64, 128, gen, cat_share=cs.CAT_SHARE,
        cat_features=cs.CAT_COLUMNS)[:3], 255)
    del ddc, dsc, Xc
    dsw = lgb.Dataset(X, label=y,
                      params={"max_bin": cs.WIDE_MAX_BIN}).construct()
    ddw = to_device(dsw._constructed, "cuda")
    measure("int32 bins (max_bin 1023)", ddw,
            *cs.wave_inputs(ddw, 127, 64, 128, gen)[:3], 255)
    del ddw, dsw, X, y
    Xs, ys, _, _ = cs.small_data()
    dss = lgb.Dataset(Xs, label=ys,
                      params={"max_bin": cs.TRAIN_CONF["max_bin"]}).construct()
    dds = to_device(dss._constructed, "cuda")
    Ls = cs.TRAIN_CONF["num_leaves"]
    measure("small-data last pass", dds, *cs.wave_inputs(
        dds, 32, 31, 32, gen, Ls, cs.TRAIN_CONF["bagging_fraction"])[:3], Ls)
    del dds, dss
    Xr, rel, sizes = cs.rank_data()
    dsr = lgb.Dataset(Xr, label=rel, group=sizes,
                      params={"max_bin": cs.RANK_PARAMS["max_bin"]})
    dsr.construct()
    ddr = to_device(dsr._constructed, "cuda")
    measure("ranking (2.27M x 136)", ddr,
            *cs.wave_inputs(ddr, 127, 64, 128, gen,
                            cs.RANK_PARAMS["num_leaves"])[:3],
            cs.RANK_PARAMS["num_leaves"])
    return rows


def wide_kernel_ab(sides) -> list:
    """The wide histogram of both trees at ``chip_smoke.py``'s phase-25
    waves: ``max_bin`` 1023 (int32 bins) at 128 slots and 2,048 leaves
    (uint8 bins) at 1,024, a root and a mid-tree wave each."""
    import torch
    import lightgbm_tpu_torch as lgb
    from lightgbm_tpu_torch.io.device import to_device
    from lightgbm_tpu_torch.ops.histogram import bin_stride
    X, y = cs.headline_data()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(25)
    rows = []
    for max_bin, L, A in ((cs.WIDE_MAX_BIN, 255, 128),
                          (63, cs.WIDE_DEEP_LEAVES, 1024)):
        ds = lgb.Dataset(X, label=y, params={"max_bin": max_bin}).construct()
        dd = to_device(ds._constructed, "cuda")
        B = bin_stride(dd.group_max_bins)
        for skew in (True, False):
            g, h, hl, active = cs.wide_hist_case(dd, L, A, gen, skew)
            name = (f"{dd.bins_t.dtype} A={A} B={B} "
                    f"{'root' if skew else 'mid-tree'}")
            parent, change, equal = wide_case(sides, dd.bins_t, g, h, hl,
                                              active, L, B)
            if not equal():
                raise AssertionError(f"wide histogram {name}: parent != "
                                     f"change")
            r = dict(kernel="hist_wide", shape=name,
                     **turns(parent, change, 10))
            cs.log(f"hist_wide {name}: parent {r['parent_ms']} change "
                   f"{r['change_ms']} ms, ratio {r['ratio']:.3f}, bitwise "
                   f"equal")
            rows.append(r)
        del dd, ds
    return rows


def wide_path_ab(sides) -> dict:
    """Phase 25's ``max_bin``-1023 and 2,048-leaf paths, each trained with
    the parent's kernels and with this tree's in turns: walls and
    digests (scores included), which must be equal."""
    import torch
    import lightgbm_tpu_torch as lgb
    from lightgbm_tpu_torch.ops.histogram import hist_wide_raw
    X, y = cs.headline_data()
    result = {}
    for name, params in (
            ("wide", dict(cs.HEADLINE_PARAMS, max_bin=cs.WIDE_MAX_BIN)),
            ("deep", dict(cs.HEADLINE_PARAMS,
                          num_leaves=cs.WIDE_DEEP_LEAVES))):
        ds = lgb.Dataset(X, label=y, params={"max_bin": params["max_bin"]})
        ds.construct()
        runs = []
        for which in ("parent", "change", "change", "parent"):
            n0 = hist_wide_raw.launches
            with getattr(sides, which)():
                t0 = time.time()
                bst = lgb.train(dict(params), ds,
                                num_boost_round=cs.WIDE_ITERS, device="cuda")
                torch.cuda.synchronize()
                wall = time.time() - t0
            r = dict(which=which, wall_s=wall, digest=bst.digest(),
                     launches=hist_wide_raw.launches - n0)
            cs.log(f"{name} ab {which}: {r}")
            runs.append(r)
        if any(r["launches"] == 0 for r in runs):
            raise AssertionError(f"{name}: a run did not take the wide "
                                 f"histogram")
        if len({r["digest"] for r in runs}) != 1:
            raise AssertionError(f"{name}: parent and change digests differ")
        result[name] = runs
    return result


def split_case(sides, B: int, gen):
    """K6 of both trees on one ``[64, 28, B, 3]`` wave of the small-data
    path (its constraints, a feature mask, missing values)."""
    import torch
    from lightgbm_tpu_torch.ops.split import SplitParams
    from lightgbm_tpu_torch.ops.split_kernel import (
        PACKED, SPLIT_THREADS, split_hyper, split_scan_launch)
    dev = gen.device
    L2, F = 64, cs.HEADLINE_FEATURES
    inputs = cs.split_wave_inputs(F, B, L2, cs.SMALL_ROWS, gen, dev)
    hyper = split_hyper(SplitParams(
        min_data_in_leaf=cs.TRAIN_CONF["min_data_in_leaf"],
        min_sum_hessian_in_leaf=cs.TRAIN_CONF["min_sum_hessian_in_leaf"]))
    fm8 = (torch.rand(F, generator=gen, device=dev) < 0.8).to(torch.uint8)
    out_p = torch.full((L2, PACKED), float("nan"), device=dev)
    out_c = torch.full((L2, PACKED), float("nan"), device=dev)
    plib, lib = sides.plibs["split"], sides.mine["split"]

    def parent():
        return split_scan_launch(plib, *inputs, fm8, hyper, True, out_p,
                                 threads=PARENT_SPLIT_THREADS)

    def change():
        return split_scan_launch(lib, *inputs, fm8, hyper, True, out_c,
                                 threads=SPLIT_THREADS)

    def equal():
        if parent() or change():
            raise RuntimeError("launch failed")
        torch.cuda.synchronize()
        return torch.equal(out_c.view(torch.int32), out_p.view(torch.int32))
    return parent, change, equal


def kernel_ab(sides) -> list:
    import torch
    import lightgbm_tpu_torch as lgb
    from lightgbm_tpu_torch.io.device import to_device
    from lightgbm_tpu_torch.ops.histogram import (bin_stride, pack_values,
                                                  pack_values_q, slot_tables)
    from lightgbm_tpu_torch.ops.route import route_plain
    rows = []

    def record(name, shape, case, reps, graph=False):
        parent, change, equal = case
        if not equal():
            raise AssertionError(f"{name} {shape}: parent != change")
        r = dict(kernel=name, shape=shape,
                 **turns(parent, change, reps, graph))
        extra = (f"; in a graph parent {r['graph_parent_ms']} change "
                 f"{r['graph_change_ms']} ms, ratio {r['graph_ratio']:.3f}"
                 if graph else "")
        cs.log(f"{name} {shape}: parent {r['parent_ms']} change "
               f"{r['change_ms']} ms, ratio {r['ratio']:.3f}{extra}, "
               f"bitwise equal")
        rows.append(r)

    X, y = cs.headline_data()
    ds = lgb.Dataset(X, label=y, params={"max_bin": 63}).construct()
    dd = to_device(ds._constructed, "cuda")
    dev = dd.device
    g = torch.randn(dd.num_data, device=dev) * 0.5
    h = torch.rand(dd.num_data, device=dev) * 0.25
    vals, _ = pack_values_q(g, h, "int8h", dd.n_pad)
    G = dd.bins_t.shape[0]
    C, L = vals.shape[0], 255
    B = bin_stride(dd.group_max_bins)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    for A in (8, 16, 32):
        leaf2, tabs, cat, active = cs.wave_inputs(dd, A, A // 2, A, gen, L)
        inv, src = slot_tables(active, L, collect_unbagged=True)
        zero = torch.zeros((A, G, B, C), dtype=torch.int32, device=dev)
        record("K1 hist_route", f"headline A={A}",
               int_case(sides, "hist_route", dd.bins_t, vals, leaf2, inv,
                        src, L, B, zero, tabs, cat), 20)
    for A in (64, 128):
        leaf2, tabs, cat, active = cs.wave_inputs(
            dd, 127 if A == 128 else 63, A - 2, A, gen)
        hleaf = route_plain(dd.bins_t, leaf2, tabs, cat)[1].contiguous()
        inv, src = slot_tables(active, L, collect_unbagged=False)
        zero = torch.zeros((A, G, B, C), dtype=torch.int32, device=dev)
        record("K3 hist_compact", f"headline A={A}",
               int_case(sides, "hist_compact", dd.bins_t, vals, hleaf, inv,
                        src, L, B, zero), 20)
    # the float K1 and K3 at chip_smoke.py's phase-2b waves
    for mode, A, bag, skew in (("hhilo", 8, 0.8, False),
                               ("hhilo", 16, 0.8, False),
                               ("hhilo", 32, 0.8, False),
                               ("hilo", 32, 0.8, False),
                               ("hhilo", 32, 1.0, True)):
        vf = cs.float_values(dd, mode, gen)
        leaf2, tabs, cat, active = cs.wave_inputs(dd, max(A, 8), A // 2, A,
                                                  gen, L, bag)
        if skew:
            leaf2, tabs = cs.skew_wave(leaf2, tabs, int(active[0]))
        inv, src = slot_tables(active, L, collect_unbagged=True)
        record("float K1 hist_route_float",
               f"headline {mode} A={A}{' skewed' if skew else ''}",
               float_k1_case(sides, dd, vf, leaf2, inv, src, L, B, tabs, cat),
               10)
    for mode, A, skew in (("hhilo", 64, False), ("hhilo", 128, False),
                          ("hilo", 128, False), ("hhilo", 128, True)):
        vf = cs.float_values(dd, mode, gen)
        leaf2, tabs, cat, active = cs.wave_inputs(
            dd, 127 if A == 128 else 63, A - 2, A, gen, L, 0.8)
        hleaf = route_plain(dd.bins_t, leaf2, tabs, cat)[1].contiguous()
        if skew:
            hleaf = torch.where(hleaf >= 0, active[0], hleaf).contiguous()
        inv, src = slot_tables(active, L, collect_unbagged=False)
        record("float K3 hist_compact_float",
               f"headline {mode} A={A}{' skewed' if skew else ''}",
               float_k3_case(sides, dd, vf, hleaf, inv, src, L, B), 10)
    del dd, ds, X, y

    Xs, ys, _, _ = cs.small_data()
    dss = lgb.Dataset(Xs, label=ys,
                      params={"max_bin": cs.TRAIN_CONF["max_bin"]}).construct()
    dds = to_device(dss._constructed, "cuda")
    gen.manual_seed(1)
    gs = torch.randn(dds.num_data, device=dev) * 0.5
    hs = torch.rand(dds.num_data, device=dev) * 0.25
    vs, _ = pack_values_q(gs, hs, "int8h", dds.n_pad)
    Ls = cs.TRAIN_CONF["num_leaves"]
    Bs = bin_stride(dds.group_max_bins)
    leaf2, tabs, cat, active = cs.wave_inputs(
        dds, 32, 16, 32, gen, Ls, cs.TRAIN_CONF["bagging_fraction"])
    inv, src = slot_tables(active, Ls, collect_unbagged=True)
    zero = torch.zeros((32, dds.bins_t.shape[0], Bs, C), dtype=torch.int32,
                       device=dev)
    record("K1 hist_route", "small-data A=32 B=256",
           int_case(sides, "hist_route", dds.bins_t, vs, leaf2, inv, src, Ls,
                    Bs, zero, tabs, cat), 20)
    for Bk in (256, 64):
        record("K6 split_scan", f"small-data [64, 28, {Bk}, 3]",
               split_case(sides, Bk, gen), 50, graph=True)

    gen.manual_seed(2)
    Lk, A, R = cs.STREAM_PARAMS["num_leaves"], 32, cs.STREAM_BLOCK
    B = bin_stride(63)
    for shape in ("uniform", "skewed"):
        prev = cs.stream_wave(gen, Lk, A)
        bins_t, g, h, hl, active = cs.stream_wave(gen, Lk, A,
                                                  skew=shape == "skewed")
        inv, src = slot_tables(active, Lk, collect_unbagged=True)
        _, sc = pack_values_q(prev[1], prev[2], "int8h", R)
        vq, _ = pack_values_q(g, h, "int8h", R, scales=sc)
        carry = torch.randint(-5000, 5000, (A, STREAM_G, B, vq.shape[0]),
                              generator=gen, device=dev, dtype=torch.int32)
        record("K5 hist_active int8h", f"stream {shape}",
               int_case(sides, "hist_active", bins_t, vq, hl, inv, src, Lk,
                        B, carry), 20)
        vf = pack_values(g, h, "hhilo", R)
        carry = torch.randn((A, STREAM_G, B, vf.shape[0]), generator=gen,
                            device=dev)
        record("K5 hist_float hhilo", f"stream {shape}",
               float_case(sides, bins_t, vf, hl, inv, src, Lk, B, carry), 10)
    L3, A3 = 255, 128
    prev = cs.stream_wave(gen, L3, A3)
    bins_t, g, h, hl, _ = cs.stream_wave(gen, L3, A3)
    active = prev[4]
    _, sc = pack_values_q(prev[1], prev[2], "int8h", R)
    vq, _ = pack_values_q(g, h, "int8h", R, scales=sc)
    inv, src = slot_tables(active, L3, collect_unbagged=False)
    carry = torch.randint(-5000, 5000, (A3, STREAM_G, B, vq.shape[0]),
                          generator=gen, device=dev, dtype=torch.int32)
    record("K3 hist_compact", "stream seeded A=128",
           int_case(sides, "hist_compact", bins_t, vq, hl, inv, src, L3, B,
                    carry), 20)
    return rows


def light_sweep(rpcs=(4, 8, 12, 16, 24, 32)) -> list:
    """This tree's float K3 at chip_smoke.py's phase-2b waves with
    ``FLOAT_LIGHT_ROWS_PER_CHUNK`` set to each of ``rpcs`` in turn: the
    time of a call and its split at each; every setting must give the
    same bits (the split only moves work between the walk and the
    partials)."""
    import torch
    import lightgbm_tpu_torch as lgb
    from lightgbm_tpu_torch.io.device import to_device
    from lightgbm_tpu_torch.ops import histogram
    from lightgbm_tpu_torch.ops.histogram import bin_stride, slot_tables
    from lightgbm_tpu_torch.ops.route import route_plain
    X, y = cs.headline_data()
    ds = lgb.Dataset(X, label=y, params={"max_bin": 63}).construct()
    dd = to_device(ds._constructed, "cuda")
    L, B = 255, bin_stride(dd.group_max_bins)
    G = dd.bins_t.shape[0]
    gen = torch.Generator(device=dd.device)
    gen.manual_seed(5)
    rows = []
    saved = histogram.FLOAT_LIGHT_ROWS_PER_CHUNK
    try:
        for mode, A, skew in (("hhilo", 64, False), ("hhilo", 128, False),
                              ("hilo", 128, False), ("hhilo", 128, True)):
            vf = cs.float_values(dd, mode, gen)
            leaf2, tabs, cat, active = cs.wave_inputs(
                dd, 127 if A == 128 else 63, A - 2, A, gen, L, 0.8)
            hl = route_plain(dd.bins_t, leaf2, tabs, cat)[1].contiguous()
            if skew:
                hl = torch.where(hl >= 0, active[0], hl).contiguous()
            inv, src = slot_tables(active, L, collect_unbagged=False)
            C = vf.shape[0]
            shape = f"{mode} A={A}{' skewed' if skew else ''}"
            res, first = [], None
            for rpc in rpcs:
                histogram.FLOAT_LIGHT_ROWS_PER_CHUNK = rpc
                w = cs.walk_measure(dd, vf, hl, inv, src, L, B, (A, G, B, C))
                acc = torch.zeros((A, G, B, C), device=dd.device)
                plan = histogram.float_walk_plan(
                    dd.n_pad, A, G, B, C, L,
                    cuda_build.multiprocessor_count(dd.device))
                for f in histogram.float_walk_launches(
                        dd.bins_t, vf, hl, inv, src, L, B, plan,
                        histogram.FloatWalkScratch.empty(plan, A, G, B, C,
                                                         dd.device), acc):
                    cuda_build.check_launch(f(), "hist_compact_float")
                torch.cuda.synchronize()
                if first is None:
                    first = acc
                elif not cs.bits_equal(acc, first):
                    raise AssertionError(f"float K3 {shape}: the walk "
                                         f"budget changed the bits")
                res.append(dict(rows_per_chunk=rpc, **{
                    k: w[k] for k in ("ms", "graph_ms", "sort_ms", "walk_ms",
                                      "fold_ms", "heavy_slots",
                                      "light_slots", "heavy_pairs",
                                      "walked_rows_max")}))
            cs.log(f"sweep hist_compact_float {shape}: " + "; ".join(
                f"{r['rows_per_chunk']}: {r['ms']:.4f} ms ({r['heavy_pairs']}"
                f" heavy pairs, walks <= {r['walked_rows_max']} rows)"
                for r in res))
            rows.append(dict(kernel="hist_compact_float", shape=shape,
                             runs=res))
    finally:
        histogram.FLOAT_LIGHT_ROWS_PER_CHUNK = saved
    return rows


def path_ab(sides, tmp: str) -> dict:
    """The small-data path, the 20M-row hhilo stream and those rows in
    memory at 255 leaves (the float K1 and K3), each trained with the
    parent's kernels and with this tree's in turns: walls and digests,
    which must be equal."""
    import torch
    import lightgbm_tpu_torch as lgb
    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.ops.histogram import hist_active_float_raw
    from lightgbm_tpu_torch.ops.split_kernel import find_best_splits_kernel
    Xs, ys, Xv, yv = cs.small_data()

    def small():
        ds = lgb.Dataset(Xs, label=ys,
                         params={"max_bin": cs.TRAIN_CONF["max_bin"]})
        dv = lgb.Dataset(Xv, label=yv, reference=ds)
        ds.construct()
        dv.construct()
        t0 = time.time()
        bst = lgb.train(dict(cs.TRAIN_CONF), ds,
                        num_boost_round=cs.SMALL_ITERS, device="cuda",
                        valid_sets=[dv], valid_names=["valid"],
                        early_stopping_rounds=cs.SMALL_EARLY_STOP,
                        evals_result={}, verbose_eval=False)
        torch.cuda.synchronize()
        return (time.time() - t0, bst.current_iteration(),
                bst.digest(include_scores=False))

    cfg = Config.from_params(cs.STREAM_PARAMS)
    t0 = time.time()
    store = lgb.outofcore.ingest_synthetic(
        os.path.join(tmp, "scale"), cs.STREAM_SCALE_ROWS, cs.STREAM_FEATURES,
        cfg, seed=2,
        shard_rows=max(cs.STREAM_BLOCK, cs.STREAM_SCALE_ROWS // 32))
    cs.log(f"stream ab: ingest {time.time() - t0:.1f} s")

    def stream():
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        bst = lgb.train_streaming(cs.STREAM_PARAMS, store,
                                  num_boost_round=cs.STREAM_ITERS,
                                  block_rows=cs.STREAM_BLOCK, device="cuda")
        torch.cuda.synchronize()
        return (time.time() - t0, torch.cuda.max_memory_allocated() / 2**20,
                bst.digest())

    from lightgbm_tpu_torch.boosting.gbdt import GBDT
    from lightgbm_tpu_torch.ops.compact import hist_compact_float_raw
    t0 = time.time()
    ds20 = store.to_binned_dataset(cfg)
    cs.log(f"in-memory ab: dataset from the store {time.time() - t0:.1f} s")

    def inmem():
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        mem = GBDT(Config.from_params(cs.HEAD20_PARAMS), ds20, "cuda")
        for _ in range(cs.STREAM_ITERS):
            mem.train_one_iter()
        torch.cuda.synchronize()
        return (time.time() - t0, torch.cuda.max_memory_allocated() / 2**20,
                mem.digest())

    result = {}
    for name, run, counter in (("small_data", small, find_best_splits_kernel),
                               ("stream_scale", stream,
                                hist_active_float_raw),
                               ("inmem_20m_255", inmem,
                                hist_compact_float_raw)):
        runs = []
        for which in ("parent", "change", "change", "parent"):
            n0 = counter.launches
            with getattr(sides, which)():
                out = run()
            r = dict(which=which, wall_s=out[0], digest=out[2],
                     launches=counter.launches - n0)
            r["iterations" if name == "small_data" else "peak_mib"] = out[1]
            cs.log(f"{name} ab {which}: {r}")
            runs.append(r)
        if any(r["launches"] == 0 for r in runs):
            raise AssertionError(f"{name}: a run did not take the kernel")
        if len({r["digest"] for r in runs}) != 1:
            raise AssertionError(f"{name}: parent and change digests differ")
        result[name] = runs
    return result


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--sweep", action="store_true",
                    help="time the float K3 at several walk budgets")
    ap.add_argument("--parent")
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("hist_ab: no CUDA device", file=sys.stderr)
        return 2
    card = cs.card_line()
    cs.log(f"torch {torch.__version__} cuda {torch.version.cuda}; {card}")
    result = dict(card=card)
    if args.quick:
        report, no_fma = ptxas_report()
        cs.log(report)
        if not no_fma:
            raise AssertionError("nvcc contracted a multiply-add in the "
                                 "split scan, or a float K1/K3 or wide "
                                 "histogram library holds a float atomic")
        # the kernel phases time K2/K4 beside the launch floor's kernel
        floor_dir = tempfile.mkdtemp(prefix="hist_ab_floor_")
        try:
            floor_build = cs.start_launch_floor_build(floor_dir)
            cs.log(f"build_s {cuda_build.build_all():.2f}")
            cs.load_launch_floor(floor_build)
        finally:
            shutil.rmtree(floor_dir, ignore_errors=True)
        import lightgbm_tpu_torch as lgb
        from lightgbm_tpu_torch.io.device import to_device
        from lightgbm_tpu_torch.ops.histogram import pack_values_q
        int_rate = cs.int32_ops_per_s(cuda_build.multiprocessor_count(
            torch.device("cuda")))
        entries = []
        def headline_phases(dd, vals, entries):
            cs.kernel_phase(dd, vals, entries)
            cs.float_kernel_phase(dd, entries)
        for data, max_bin, phase in (
                (cs.headline_data(), 63, headline_phases),
                (cs.small_data()[:2], cs.TRAIN_CONF["max_bin"],
                 lambda d, v, e: cs.small_kernel_phase(d, v, int_rate, e))):
            ds = lgb.Dataset(*data[:1], label=data[1],
                             params={"max_bin": max_bin}).construct()
            dd = to_device(ds._constructed, "cuda")
            g = torch.randn(dd.num_data, device="cuda") * 0.5
            h = torch.rand(dd.num_data, device="cuda") * 0.25
            vals, _ = pack_values_q(g, h, "int8h", dd.n_pad)
            phase(dd, vals, entries)
        cs.stream_kernel_phase(int_rate, entries)
        torch.cuda.synchronize()
        result["kernels"] = entries
    elif args.sweep:
        cuda_build.build_all()
        result["sweep"] = light_sweep()
    else:
        if not args.parent:
            ap.error("--parent DIR or --quick")
        cuda_build.build_all()
        tmp = tempfile.mkdtemp(prefix="hist_ab_")
        try:
            sides = Sides(*build_parent(args.parent, tmp))
            # K1 and the float K1 share route_row.cuh with K2/K4
            result["same_sass"] = {
                n: same_sass(n, os.path.join(tmp, f"lib{n}-parent.so"))
                for n in ("hist_route", "hist_route_float")}
            cs.log(f"same instructions as the parent: "
                   f"{result['same_sass']}")
            result["kernels"] = (kernel_ab(sides) + route_kernel_ab(sides)
                                 + wide_kernel_ab(sides))
            result["paths"] = dict(path_ab(sides, tmp),
                                   **wide_path_ab(sides))
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
        cs.log(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
