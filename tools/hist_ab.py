#!/usr/bin/env python3
"""Before/after measurement of the histogram kernels (K1, K3, K5 int8h
and the float K5) on one NVIDIA GPU, against the kernels of a parent
tree.

    python3 tools/hist_ab.py --quick [--out FILE]
    python3 tools/hist_ab.py --parent DIR [--out FILE]

``--quick``: print what ``ptxas -v`` reports for every histogram kernel
of this tree (registers, shared memory, spills), then run the kernel
phases of ``chip_smoke.py`` (every kernel once at its path's shapes,
held bitwise against its plain version, and timed) and stop.

``--parent DIR``: ``DIR`` holds a checkout of the parent tree (only its
``lightgbm_tpu_torch/csrc`` is read).  Its histogram sources are built
with ``nvcc`` into a temporary directory and called through their C
interface (that of the tree before the int32 body was given slabs and
the float K5 a sorted chunk walk; its launch plan is restated below).
At the shapes ``chip_smoke.py`` uses, each kernel of both trees runs
once on the same inputs from the same carry (results must be bitwise
equal), then is timed in turns: parent, change, change, parent.  Then
the 20,000,000-row hhilo stream of ``chip_smoke.py`` trains on one
synthetic store with the parent's float K5 and with this tree's, in the
same order, and the four digests must be equal.  Prints a summary and,
with ``--out``, writes the results as one JSON object; times are means
over back-to-back launches (warm), on the card named in the output.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import math
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

KERNEL_SOURCES = ("hist_route", "hist_compact", "hist_active", "hist_float")

# the parent tree's C interface and launch plan
_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
PARENT_SIGS = {
    "hist_route": [_P, _LL, _I, _P, _I, _P, _P, _P, _I, _P, _I, _P, _P, _I,
                   _I, _I, _I, _I, _LL, _I, _P, _P],
    "hist_compact": [_P, _LL, _I, _P, _I, _P, _I, _P, _P, _I, _I, _I, _I, _I,
                     _LL, _I, _P, _P],
    "hist_active": [_P, _LL, _I, _P, _I, _P, _I, _P, _P, _I, _I, _I, _I, _I,
                    _LL, _I, _P, _P],
    "hist_float": [_P, _LL, _I, _P, _I, _P, _I, _P, _P, _I, _I, _I, _I, _P,
                   _P, _P],
}
PARENT_HIST_SMEM = 128 * 1024
PARENT_HIST_BLOCK = 1024
PARENT_FLOAT_SMEM = 200 * 1024


def parent_hist_shape(n_pad, G, A, B, C, sms):
    cells = PARENT_HIST_SMEM // 4 // (B * C)
    if cells >= A:
        As, Ft = A, min(G, cells // A)
    else:
        As, Ft = max(1, cells), 1
    tiles = math.ceil(G / Ft) * math.ceil(A / As)
    gx = max(1, min(math.ceil(n_pad / PARENT_HIST_BLOCK),
                    math.ceil(2 * sms / tiles)))
    return As, Ft, gx, math.ceil(n_pad / gx)


def parent_float_slots(A, B, C):
    per_slot = C * B * 32 * 4
    return max(1, min(A, (PARENT_FLOAT_SMEM - 2 * 2048) // per_slot))


def ptxas_report() -> str:
    """``nvcc -Xptxas -v`` of every histogram source, all at once."""
    from lightgbm_tpu_torch.ops import cuda_build as cb
    tmp = tempfile.mkdtemp(prefix="ptxas_")
    procs = []
    for name in KERNEL_SOURCES:
        cmd = [cb.nvcc_path(), *cb.NVCC_FLAGS, "-Xptxas", "-v", "-I",
               str(cb.CSRC), "-o", os.path.join(tmp, f"{name}.so"),
               str(cb.CSRC / f"{name}.cu")]
        procs.append((name, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT)))
    lines = []
    for name, p in procs:
        out, _ = p.communicate()
        lines += [f"{name}: {ln}" for ln in out.decode().splitlines()
                  if "ptxas" in ln and ("registers" in ln or "spill" in ln
                                        or "Compiling" in ln)]
        # the shared-memory atomics the compiler emitted, by opcode
        dump = subprocess.run(
            [os.path.join(os.path.dirname(cb.nvcc_path()), "cuobjdump"),
             "-sass", os.path.join(tmp, f"{name}.so")],
            capture_output=True, text=True).stdout
        ops = {}
        for op in re.findall(r"\b(ATOMS\.[A-Z0-9.]+)", dump):
            ops[op] = ops.get(op, 0) + 1
        lines.append(f"{name}: shared atomics {ops}")
    shutil.rmtree(tmp, ignore_errors=True)
    return "\n".join(lines)


def build_parent(parent: str, out_dir: str) -> dict:
    from lightgbm_tpu_torch.ops import cuda_build as cb
    csrc = os.path.join(parent, "lightgbm_tpu_torch", "csrc")
    procs = []
    for name in KERNEL_SOURCES:
        path = os.path.join(out_dir, f"lib{name}-parent.so")
        cmd = [cb.nvcc_path(), *cb.NVCC_FLAGS, "-I", csrc, "-o", path,
               os.path.join(csrc, f"{name}.cu")]
        procs.append((name, path, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    libs = {}
    for name, path, p in procs:
        out, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"parent {name}.cu: {out.decode()}")
        lib = ctypes.CDLL(path)
        fn = getattr(lib, f"lgbm_{name}")
        fn.argtypes = PARENT_SIGS[name]
        fn.restype = ctypes.c_int
        libs[name] = fn
    return libs


def turns(parent_fn, change_fn, reps: int) -> dict:
    """Parent, change, change, parent: mean ms of each over ``reps``."""
    p1 = cs.time_ms(parent_fn, reps)
    c1 = cs.time_ms(change_fn, reps)
    c2 = cs.time_ms(change_fn, reps)
    p2 = cs.time_ms(parent_fn, reps)
    return dict(parent_ms=[p1, p2], change_ms=[c1, c2],
                ratio=(c1 + c2) / (p1 + p2))


class IntCase:
    """One int32 histogram launch of both trees on the same inputs."""

    def __init__(self, plibs, kind, bins_t, vals, leaf, inv, src, L, B,
                 carry, tabs=None, cat=None):
        import torch
        from lightgbm_tpu_torch.ops import cuda_build
        from lightgbm_tpu_torch.ops.histogram import (BoundLaunch,
                                                      hist_launcher,
                                                      hist_plan, hist_slab)
        G, n_pad = bins_t.shape
        C = vals.shape[0]
        A = src.shape[0]
        dev = bins_t.device
        sms = cuda_build.multiprocessor_count(dev)
        route = kind == "hist_route"
        self.plan = hist_plan(n_pad, G, A, B, C, sms, L, route)
        slab = hist_slab(self.plan, A, G, B, C, dev)
        self.out_c = carry.clone()
        self.out_p = carry.clone()
        lo_c = torch.empty_like(leaf) if route else None
        self.lo_p = torch.empty_like(leaf) if route else None
        self.change = hist_launcher(kind, bins_t, vals, leaf, inv, src, L, B,
                                    self.plan, slab, self.out_c, lo_c, tabs,
                                    cat)
        As, Ft, gx, rpb = parent_hist_shape(n_pad, G, A, B, C, sms)
        stream = torch.cuda.current_stream(dev).cuda_stream
        head = [bins_t.data_ptr(), n_pad, G, vals.data_ptr(), C,
                leaf.data_ptr()]
        head += ([self.lo_p.data_ptr(), tabs.data_ptr(), L, cat.data_ptr(),
                  cat.shape[1]] if route else [L])
        args = head + [inv.data_ptr(), src.data_ptr(), A, B, Ft, As, gx, rpb,
                       PARENT_HIST_BLOCK, self.out_p.data_ptr(), stream]
        self.parent = BoundLaunch(plibs[kind], args,
                                  (self.out_p, self.lo_p))
        self.lo_c = lo_c

    def equal(self) -> bool:
        import torch
        for f in (self.change, self.parent):
            if f() != 0:
                raise RuntimeError("launch failed")
        torch.cuda.synchronize()
        ok = torch.equal(self.out_c, self.out_p)
        if self.lo_c is not None:
            ok = ok and torch.equal(self.lo_c, self.lo_p)
        return ok


def float_case(plibs, bins_t, vals, hl, inv, src, L, B, carry):
    import torch
    from lightgbm_tpu_torch.ops.histogram import (FLOAT_CHUNK, BoundLaunch,
                                                  float_plan, float_scratch,
                                                  hist_float_launcher)
    G, n_pad = bins_t.shape
    C = vals.shape[0]
    A = src.shape[0]
    dev = bins_t.device
    part, counts = float_scratch(n_pad, A, G, B, C, dev)
    out_c, out_p = carry.clone(), carry.clone()
    change = hist_float_launcher(bins_t, vals, hl, inv, src, L, B,
                                 float_plan(A, B, C), part, counts, out_c)
    K = -(-n_pad // FLOAT_CHUNK)
    ppart = torch.empty((K, A, G, B, C), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    args = [bins_t.data_ptr(), n_pad, G, vals.data_ptr(), C, hl.data_ptr(),
            L, inv.data_ptr(), src.data_ptr(), A, B,
            parent_float_slots(A, B, C), FLOAT_CHUNK, ppart.data_ptr(),
            out_p.data_ptr(), stream]
    parent = BoundLaunch(plibs["hist_float"], args, (ppart, out_p))

    def equal():
        if change() != 0 or parent() != 0:
            raise RuntimeError("launch failed")
        torch.cuda.synchronize()
        return torch.equal(out_c.view(torch.int32), out_p.view(torch.int32))
    return change, parent, equal


def kernel_ab(plibs) -> list:
    import torch
    import lightgbm_tpu_torch as lgb
    from lightgbm_tpu_torch.io.device import to_device
    from lightgbm_tpu_torch.ops.histogram import (bin_stride, pack_values,
                                                  pack_values_q, slot_tables)
    from lightgbm_tpu_torch.ops.route import route_plain
    rows = []

    def record(name, shape, case_equal, change, parent, reps):
        if not case_equal():
            raise AssertionError(f"{name} {shape}: parent != change")
        r = dict(kernel=name, shape=shape, **turns(parent, change, reps))
        cs.log(f"{name} {shape}: parent {r['parent_ms']} change "
               f"{r['change_ms']} ms, ratio {r['ratio']:.3f}, bitwise equal")
        rows.append(r)

    X, y = cs.headline_data()
    ds = lgb.Dataset(X, label=y, params={"max_bin": 63}).construct()
    dd = to_device(ds._constructed, "cuda")
    dev = dd.device
    g = torch.randn(dd.num_data, device=dev) * 0.5
    h = torch.rand(dd.num_data, device=dev) * 0.25
    vals, _ = pack_values_q(g, h, "int8h", dd.n_pad)
    G, n_pad = dd.bins_t.shape
    C, L = vals.shape[0], 255
    B = bin_stride(dd.group_max_bins)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    for A in (8, 16, 32):
        leaf2, tabs, cat, active = cs.wave_inputs(dd, A, A // 2, A, gen, L)
        inv, src = slot_tables(active, L, collect_unbagged=True)
        zero = torch.zeros((A, G, B, C), dtype=torch.int32, device=dev)
        c = IntCase(plibs, "hist_route", dd.bins_t, vals, leaf2, inv, src, L,
                    B, zero, tabs, cat)
        record("K1 hist_route", f"headline A={A}", c.equal, c.change,
               c.parent, 20)
    for A in (64, 128):
        leaf2, tabs, cat, active = cs.wave_inputs(
            dd, 127 if A == 128 else 63, A - 2, A, gen)
        hleaf = route_plain(dd.bins_t, leaf2, tabs, cat)[1].contiguous()
        inv, src = slot_tables(active, L, collect_unbagged=False)
        zero = torch.zeros((A, G, B, C), dtype=torch.int32, device=dev)
        c = IntCase(plibs, "hist_compact", dd.bins_t, vals, hleaf, inv, src,
                    L, B, zero)
        record("K3 hist_compact", f"headline A={A}", c.equal, c.change,
               c.parent, 20)
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
    c = IntCase(plibs, "hist_route", dds.bins_t, vs, leaf2, inv, src, Ls, Bs,
                zero, tabs, cat)
    record("K1 hist_route", "small-data A=32 B=256", c.equal, c.change,
           c.parent, 20)

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
        c = IntCase(plibs, "hist_active", bins_t, vq, hl, inv, src, Lk, B,
                    carry)
        record("K5 hist_active int8h", f"stream {shape}", c.equal, c.change,
               c.parent, 20)
        vf = pack_values(g, h, "hhilo", R)
        carry = torch.randn((A, STREAM_G, B, vf.shape[0]), generator=gen,
                            device=dev)
        change, parent, equal = float_case(plibs, bins_t, vf, hl, inv, src,
                                           Lk, B, carry)
        record("K5 hist_float hhilo", f"stream {shape}", equal, change,
               parent, 10)
    L3, A3 = 255, 128
    prev = cs.stream_wave(gen, L3, A3)
    bins_t, g, h, hl, _ = cs.stream_wave(gen, L3, A3)
    active = prev[4]
    _, sc = pack_values_q(prev[1], prev[2], "int8h", R)
    vq, _ = pack_values_q(g, h, "int8h", R, scales=sc)
    inv, src = slot_tables(active, L3, collect_unbagged=False)
    carry = torch.randint(-5000, 5000, (A3, STREAM_G, B, vq.shape[0]),
                          generator=gen, device=dev, dtype=torch.int32)
    c = IntCase(plibs, "hist_compact", bins_t, vq, hl, inv, src, L3, B,
                carry)
    record("K3 hist_compact", "stream seeded A=128", c.equal, c.change,
           c.parent, 20)
    return rows


STREAM_G = cs.STREAM_FEATURES


def stream_ab(plibs, tmp: str) -> dict:
    """The 20M-row hhilo stream on one store with the parent's float K5
    and with this tree's: walls, peak memory and digests, in turns."""
    import torch
    import lightgbm_tpu_torch as lgb
    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.learner import serial
    from lightgbm_tpu_torch.ops.histogram import (FLOAT_CHUNK, bin_stride,
                                                  hist_active_float_raw,
                                                  slot_tables)
    fn = plibs["hist_float"]
    calls = [0]

    def parent_float(bins_t, vals, hist_leaf, active, L, max_bins, acc):
        B = bin_stride(max_bins)
        G, n_pad = bins_t.shape
        C, A = vals.shape[0], active.shape[0]
        inv, src = slot_tables(active, L, collect_unbagged=True)
        K = -(-n_pad // FLOAT_CHUNK)
        part = torch.empty((K, A, G, B, C), dtype=torch.float32,
                           device=bins_t.device)
        code = fn(bins_t.data_ptr(), n_pad, G, vals.data_ptr(), C,
                  hist_leaf.data_ptr(), L, inv.data_ptr(), src.data_ptr(), A,
                  B, parent_float_slots(A, B, C), FLOAT_CHUNK,
                  part.data_ptr(), acc.data_ptr(),
                  torch.cuda.current_stream(bins_t.device).cuda_stream)
        if code:
            raise RuntimeError(f"parent hist_float failed: {code}")
        calls[0] += 1
        return acc

    cfg = Config.from_params(cs.STREAM_PARAMS)
    t0 = time.time()
    store = lgb.outofcore.ingest_synthetic(
        os.path.join(tmp, "scale"), cs.STREAM_SCALE_ROWS, cs.STREAM_FEATURES,
        cfg, seed=2,
        shard_rows=max(cs.STREAM_BLOCK, cs.STREAM_SCALE_ROWS // 32))
    cs.log(f"stream ab: ingest {time.time() - t0:.1f} s")
    runs = []
    for which in ("parent", "change", "change", "parent"):
        serial.hist_active_float_raw = (parent_float if which == "parent"
                                        else hist_active_float_raw)
        n0 = hist_active_float_raw.launches
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        bst = lgb.train_streaming(cs.STREAM_PARAMS, store,
                                  num_boost_round=cs.STREAM_ITERS,
                                  block_rows=cs.STREAM_BLOCK, device="cuda")
        torch.cuda.synchronize()
        wall = time.time() - t0
        r = dict(which=which, wall_s=wall,
                 rows_iter_per_s=store.n * cs.STREAM_ITERS / wall,
                 peak_mib=torch.cuda.max_memory_allocated() / 2**20,
                 digest=bst.digest(),
                 change_launches=hist_active_float_raw.launches - n0)
        cs.log(f"stream ab {which}: {wall:.3f} s, {r['rows_iter_per_s']:.4g} "
               f"rows x iterations/s, peak {r['peak_mib']:.1f} MiB, digest "
               f"{r['digest']}")
        runs.append(r)
    serial.hist_active_float_raw = hist_active_float_raw
    if calls[0] == 0 or any(r["change_launches"] == 0 for r in runs
                            if r["which"] == "change"):
        raise AssertionError("a stream did not take the kernel it tests")
    if len({r["digest"] for r in runs}) != 1:
        raise AssertionError("parent and change digests differ")
    return dict(runs=runs, parent_float_calls=calls[0])


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--parent")
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("hist_ab: no CUDA device", file=sys.stderr)
        return 2
    from lightgbm_tpu_torch.ops import cuda_build
    card = cs.card_line()
    cs.log(f"torch {torch.__version__} cuda {torch.version.cuda}; {card}")
    result = dict(card=card)
    if args.quick:
        cs.log(ptxas_report())
        cs.log(f"build_s {cuda_build.build_all():.2f}")
        import lightgbm_tpu_torch as lgb
        from lightgbm_tpu_torch.io.device import to_device
        from lightgbm_tpu_torch.ops.histogram import pack_values_q
        X, y = cs.headline_data()
        ds = lgb.Dataset(X, label=y, params={"max_bin": 63}).construct()
        dd = to_device(ds._constructed, "cuda")
        g = torch.randn(dd.num_data, device="cuda") * 0.5
        h = torch.rand(dd.num_data, device="cuda") * 0.25
        vals, _ = pack_values_q(g, h, "int8h", dd.n_pad)
        entries = []
        cs.kernel_phase(dd, vals, entries)
        int_rate = cs.int32_ops_per_s(cuda_build.multiprocessor_count(
            dd.device))
        cs.stream_kernel_phase(int_rate, entries)
        torch.cuda.synchronize()
        result["kernels"] = entries
    else:
        if not args.parent:
            ap.error("--parent DIR or --quick")
        cuda_build.build_all()
        tmp = tempfile.mkdtemp(prefix="hist_ab_")
        try:
            plibs = build_parent(args.parent, tmp)
            result["kernels"] = kernel_ab(plibs)
            result["stream"] = stream_ab(plibs, tmp)
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
