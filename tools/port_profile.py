#!/usr/bin/env python3
"""Where the time goes in lightgbm_tpu_torch's training on a GPU.

    python3 tools/port_profile.py [--path headline|small|stream]
                                  [--scan kernel|torch] [--out F]

``--path headline`` (the default) builds the bench's synthetic binary
set (``chip_smoke.headline_data``: 1M x 28, max_bin 63) and a Booster of
the headline config (255 leaves, lr 0.1, min_data_in_leaf 20).
``--path small`` builds the small-data path of ``chip_smoke.py``: the
upstream binary_classification ``train.conf`` (``chip_smoke.TRAIN_CONF``)
on the generator's 65,536 training rows with its 13,107-row valid set;
each iteration there is ``update()`` plus the training and valid
evaluation ``lgb.train`` makes with ``metric_freq=1``.  ``--path
stream`` writes ``chip_smoke.py``'s stream identity store (the bench's
synthetic 4,194,304 x 28 rows, max_bin 63) into a temporary directory
and streams it in blocks of 1,048,576 rows (63 leaves, lr 0.1); there
an iteration is one streamed tree (gradients, every wave's uploads,
routes and folds, the score update), and the profile also splits the
device time into host-to-device copies, device-to-host copies and
kernels.  ``--scan torch``
makes the learner take the torch split scan where it would take the
split kernel (the scan before the kernel was ported), for comparison.

After a warm-up of 2 iterations (1 on the stream) it times 8
iterations (2 on the stream) on the host clock without a profiler
(steady ms/iter, the Booster's setup excluded), then profiles as many
more with ``torch.profiler`` (CPU + CUDA activities), with
each wave's split scan inside a ``split_scan`` range and each valid-set
tree walk (``predict_built_tree``) inside a ``valid_walk`` range.
Prints one JSON line with both walls (``steady_ms_per_iter``,
``profiled_ms_per_iter``), device-busy ms/iter (sum of kernel
durations), the idle share of the profiled window, the port kernels'
share, the split scan's device time, the valid walk's device time and
launches, and the top device kernels by time; ``--out`` also writes the
full table as JSON.  Needs a CUDA device; fails without one.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPLIT_KERNEL = "split_scan_kernel"
PORT_KERNELS = ("route_kernel", "hist_kernel", "hist_float", SPLIT_KERNEL)
ITERS = {"headline": 8, "small": 8, "stream": 2}
WARMUP = {"headline": 2, "small": 2, "stream": 1}


def _timed_iters(step, torch, iters: int) -> float:
    t0 = time.time()
    for _ in range(iters):
        step()
    torch.cuda.synchronize()
    return time.time() - t0


def _in_range(torch, module, name: str, label: str) -> None:
    """Run ``module.name`` inside a ``label`` profiler range."""
    fn = getattr(module, name)

    def traced(*a, **kw):
        with torch.profiler.record_function(label):
            return fn(*a, **kw)
    setattr(module, name, traced)


def _instrument(torch, use_kernel: bool) -> None:
    """Put the learner's split scan in a ``split_scan`` range and the
    valid-set walk in a ``valid_walk`` range; with ``use_kernel`` False,
    refuse the split kernel so the torch scan runs."""
    from lightgbm_tpu_torch.boosting import gbdt
    from lightgbm_tpu_torch.learner import serial
    _in_range(torch, serial, "scan_grid", "split_scan")
    _in_range(torch, gbdt, "predict_built_tree", "valid_walk")
    if not use_kernel:
        serial.split_kernel_ok = lambda *a, **kw: False


def _range_kernels(prof, label: str):
    """-> (device us, kernel launches, calls) of the torch kernels
    launched inside each host-side ``label`` range.  The range's
    device-side twin spans the idle gaps too, so it is not counted; the
    split kernel, launched through ctypes, is counted from the kernel
    table, never here."""
    from torch.autograd import DeviceType

    def walk(e):
        ks = [k for k in e.kernels if SPLIT_KERNEL not in k.name]
        us, n = sum(k.duration for k in ks), len(ks)
        for c in e.cpu_children:
            cu, cn = walk(c)
            us, n = us + cu, n + cn
        return us, n
    ranges = [e for e in prof.events()
              if e.name == label and e.device_type == DeviceType.CPU]
    stats = [walk(e) for e in ranges]
    return (sum(u for u, _ in stats), sum(k for _, k in stats),
            len(ranges))


def _booster(lgb, path: str, tmp: str):
    """-> (booster, one-iteration step, training rows)."""
    from chip_smoke import (HEADLINE_ROWS, SMALL_ROWS, STREAM_BLOCK,
                            STREAM_FEATURES, STREAM_IDENT_ROWS,
                            STREAM_PARAMS, TRAIN_CONF, headline_data,
                            small_data)
    if path == "stream":
        from lightgbm_tpu_torch.boosting.streaming import StreamTrainer
        from lightgbm_tpu_torch.config import Config
        cfg = Config.from_params(STREAM_PARAMS)
        store = lgb.outofcore.ingest_synthetic(
            tmp, STREAM_IDENT_ROWS, STREAM_FEATURES, cfg, seed=3,
            shard_rows=STREAM_IDENT_ROWS)
        tr = StreamTrainer(cfg, store, block_rows=STREAM_BLOCK,
                           device="cuda")

        def step():
            tr.train(tr.booster.iter + 1)
        return tr.booster, step, STREAM_IDENT_ROWS
    if path == "headline":
        X, y = headline_data()
        params = {"objective": "binary", "num_leaves": 255, "max_bin": 63,
                  "learning_rate": 0.1, "min_data_in_leaf": 20,
                  "verbose": -1}
        bst = lgb.Booster(params, lgb.Dataset(X, label=y,
                                              params={"max_bin": 63}),
                          device="cuda")
        return bst, bst.update, HEADLINE_ROWS
    X, y, Xv, yv = small_data()
    ds = lgb.Dataset(X, label=y, params={"max_bin": TRAIN_CONF["max_bin"]})
    bst = lgb.Booster(dict(TRAIN_CONF), ds, device="cuda")
    bst.add_valid(lgb.Dataset(Xv, label=yv, reference=ds), "valid")

    def step():
        bst.update()
        bst.eval_train()
        bst.eval_valid()
    return bst, step, SMALL_ROWS


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--path", choices=("headline", "small", "stream"),
                    default="headline")
    ap.add_argument("--scan", choices=("kernel", "torch"), default="kernel")
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("port_profile: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, _ROOT)
    import lightgbm_tpu_torch as lgb
    from chip_smoke import card_line
    from lightgbm_tpu_torch.ops import cuda_build
    cuda_build.build_all()
    card = card_line()
    _instrument(torch, args.scan == "kernel")

    it = ITERS[args.path]
    tmp = tempfile.mkdtemp(prefix="lgbm_profile_")
    try:
        bst, step, n_rows = _booster(lgb, args.path, tmp)
        for _ in range(WARMUP[args.path]):
            step()
        torch.cuda.synchronize()
        steady = _timed_iters(step, torch, it)

        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            wall = _timed_iters(step, torch, it)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # the split scan's device time: the torch kernels inside its ranges
    # plus the split kernel, which runs only there (launched through
    # ctypes, it is counted from the kernel table below)
    scan_us, _, scan_calls = _range_kernels(prof, "split_scan")
    walk_us, walk_launches, _ = _range_kernels(prof, "valid_walk")
    rows = []
    for ev in prof.key_averages():
        dev_us = getattr(ev, "device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "cuda_time_total", 0.0)
        self_dev = getattr(ev, "self_device_time_total", None)
        if self_dev is None:
            self_dev = getattr(ev, "self_cuda_time_total", dev_us)
        if self_dev > 0 and ev.key not in ("split_scan", "valid_walk"):
            rows.append({"name": ev.key, "count": int(ev.count),
                         "self_device_us": float(self_dev)})
    rows.sort(key=lambda r: -r["self_device_us"])
    # kernels only: CUDA events that are not the host-side op wrappers
    kernel_rows = [r for r in rows if not r["name"].startswith("aten::")
                   and not r["name"].startswith("cuda")]
    busy_us = sum(r["self_device_us"] for r in kernel_rows)
    scan_us += sum(r["self_device_us"] for r in kernel_rows
                   if SPLIT_KERNEL in r["name"])
    port_us = sum(r["self_device_us"] for r in kernel_rows
                  if any(k in r["name"] for k in PORT_KERNELS))

    def device_us(prefix):
        return sum(r["self_device_us"] for r in kernel_rows
                   if r["name"].startswith(prefix))
    h2d_us, d2h_us = device_us("Memcpy HtoD"), device_us("Memcpy DtoH")
    copy_us = sum(r["self_device_us"] for r in kernel_rows
                  if r["name"].startswith("Mem"))
    summary = {
        "card": card, "path": args.path, "scan": args.scan,
        "rows": n_rows, "iters": it,
        "steady_ms_per_iter": 1e3 * steady / it,
        "profiled_ms_per_iter": 1e3 * wall / it,
        "device_busy_ms_per_iter": busy_us / 1e3 / it,
        "idle_share": 1.0 - (busy_us / 1e6) / wall if wall > 0 else None,
        "port_kernels_ms_per_iter": port_us / 1e3 / it,
        "split_scan_device_ms_per_iter": scan_us / 1e3 / it,
        "split_scans_per_iter": scan_calls / it,
        "valid_walk_device_ms_per_iter": walk_us / 1e3 / it,
        "valid_walk_launches_per_iter": walk_launches / it,
        "device_kernel_launches_per_iter": sum(
            r["count"] for r in kernel_rows) / it,
        # copies run on their own stream on the streamed path and may
        # overlap kernels: busy time is the sum of both, not their union
        "h2d_copy_ms_per_iter": h2d_us / 1e3 / it,
        "d2h_copy_ms_per_iter": d2h_us / 1e3 / it,
        "kernel_ms_per_iter": (busy_us - copy_us) / 1e3 / it,
        "h2d_share_of_wall": (h2d_us / 1e6) / wall if wall > 0 else None,
        "top": kernel_rows[:12],
    }
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w", encoding="utf-8") as f:
            json.dump({**summary, "all": rows}, f, indent=1)
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
