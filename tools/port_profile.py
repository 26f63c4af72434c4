#!/usr/bin/env python3
"""Where the time goes in lightgbm_tpu_torch's headline training on a GPU.

    python3 tools/port_profile.py [--out F]

Builds the bench's synthetic binary set (``chip_smoke.headline_data``:
1M x 28, max_bin 63) and a Booster of the headline config (255 leaves,
lr 0.1, min_data_in_leaf 20).  After a warm-up of 2 iterations it times
8 iterations on the host clock without a profiler (steady ms/iter, the
Booster's setup excluded), then profiles 8 more with ``torch.profiler``
(CPU + CUDA activities).  Prints one JSON line with both walls
(``steady_ms_per_iter``, ``profiled_ms_per_iter``),
device-busy ms/iter (sum of kernel durations), the idle share of the
profiled window, the port kernels' share, and the top device kernels by
time; ``--out`` also writes the full table as JSON.  Needs a CUDA
device; fails without one.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_KERNELS = ("route_kernel", "hist_kernel")
ITERS = 8


def _timed_iters(bst, torch) -> float:
    t0 = time.time()
    for _ in range(ITERS):
        bst.update()
    torch.cuda.synchronize()
    return time.time() - t0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("port_profile: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, _ROOT)
    import lightgbm_tpu_torch as lgb
    from chip_smoke import HEADLINE_ROWS, card_line, headline_data
    from lightgbm_tpu_torch.ops import cuda_build
    cuda_build.build_all()
    card = card_line()

    X, y = headline_data()
    params = {"objective": "binary", "num_leaves": 255, "max_bin": 63,
              "learning_rate": 0.1, "min_data_in_leaf": 20, "verbose": -1}
    bst = lgb.Booster(params, lgb.Dataset(X, label=y,
                                          params={"max_bin": 63}),
                      device="cuda")
    for _ in range(2):
        bst.update()
    torch.cuda.synchronize()
    steady = _timed_iters(bst, torch)

    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall = _timed_iters(bst, torch)

    rows = []
    for ev in prof.key_averages():
        dev_us = getattr(ev, "device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "cuda_time_total", 0.0)
        self_dev = getattr(ev, "self_device_time_total", None)
        if self_dev is None:
            self_dev = getattr(ev, "self_cuda_time_total", dev_us)
        if self_dev > 0:
            rows.append({"name": ev.key, "count": int(ev.count),
                         "self_device_us": float(self_dev)})
    rows.sort(key=lambda r: -r["self_device_us"])
    # kernels only: CUDA events that are not the host-side op wrappers
    kernel_rows = [r for r in rows if not r["name"].startswith("aten::")
                   and not r["name"].startswith("cuda")]
    busy_us = sum(r["self_device_us"] for r in kernel_rows)
    port_us = sum(r["self_device_us"] for r in kernel_rows
                  if any(k in r["name"] for k in PORT_KERNELS))
    it = ITERS
    summary = {
        "card": card, "rows": HEADLINE_ROWS, "iters": it,
        "steady_ms_per_iter": 1e3 * steady / it,
        "profiled_ms_per_iter": 1e3 * wall / it,
        "device_busy_ms_per_iter": busy_us / 1e3 / it,
        "idle_share": 1.0 - (busy_us / 1e6) / wall if wall > 0 else None,
        "port_kernels_ms_per_iter": port_us / 1e3 / it,
        "device_kernel_launches_per_iter": sum(
            r["count"] for r in kernel_rows) / it,
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
