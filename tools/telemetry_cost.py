#!/usr/bin/env python3
"""What lightgbm_tpu_torch's telemetry costs on a GPU's host.

    python3 tools/telemetry_cost.py [--iters 16] [--out FILE]

First the host cost of one call: a traced span written to a file under
``/tmp``, ``/dev/shm`` and the working directory, a bare line-buffered
and a block-buffered write there, a span with telemetry on and no trace,
a span with telemetry off.  Then the headline of ``chip_smoke.py``
(1M x 28, ``max_bin`` 63, 255 leaves) through ``lgb.train`` on the card,
``--iters`` iterations, steady ms/iter (``chip_smoke.IterClock``) in four
modes, in turns, twice each, with the heap grown by 3M small objects (as
late in a long process) and then frozen (``gc.freeze``): telemetry off,
on without a trace (the summary only), tracing with a write per record
(the trace's buffer set to a line, ``TRACE_BUFFER = 1``) and tracing
through the module's block buffer.  Each run prints its Python garbage
collections by generation.  Prints one line per measurement and, with
``--out``, writes them as JSON.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def per_call_us(fn, n: int = 3000) -> float:
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    return (time.perf_counter() - t0) / n * 1e6


def call_costs(obs, tel) -> dict:
    def span():
        with obs.span("tree.hist"):
            pass
    out = {}
    for d in ("/tmp", "/dev/shm", os.getcwd()):
        if not os.path.isdir(d):
            continue
        fd, path = tempfile.mkstemp(dir=d, suffix=".jsonl")
        os.close(fd)
        obs.reset()
        obs.enable(trace_path=path)
        out[f"traced span, {d}"] = per_call_us(span)
        obs.reset()
        for name, buffering in (("line-buffered", 1), ("block-buffered",
                                                       1 << 16)):
            with open(path, "a", buffering=buffering) as f:
                out[f"{name} write, {d}"] = per_call_us(
                    lambda: f.write('{"a": 1}\n'))
        os.remove(path)
    obs.reset()
    obs.enable()
    out["span, telemetry on, no trace"] = per_call_us(span)
    obs.reset()
    out["span, telemetry off"] = per_call_us(span, 30000)
    return out


def headline_runs(lgb, obs, tel, cs, iters: int) -> list:
    import numpy as np
    X, z = cs.headline_latent()
    y = (z > 0).astype(np.float32)
    ds = lgb.Dataset(X, label=y, params={"max_bin": 63}).construct()
    trace = os.path.join(tempfile.mkdtemp(prefix="telemetry_cost_"),
                         "trace.jsonl")
    buffer = tel.TRACE_BUFFER
    heap = [[i, str(i)] for i in range(3_000_000)]

    def run(mode):
        obs.reset()
        tel.TRACE_BUFFER = 1 if mode == "trace, a write a record" else buffer
        p = dict(cs.HEADLINE_PARAMS)
        if mode == "summary":
            obs.enable()
        elif mode.startswith("trace"):
            p["telemetry_output"] = trace
        clock = cs.IterClock()
        gc0 = [s["collections"] for s in gc.get_stats()]
        lgb.train(p, ds, num_boost_round=iters, device="cuda",
                  callbacks=[clock])
        gc1 = [s["collections"] for s in gc.get_stats()]
        obs.reset()
        if os.path.exists(trace):
            os.remove(trace)
        return clock.steady_ms, [b - a for a, b in zip(gc0, gc1)]

    modes = ["off", "summary", "trace, a write a record",
             "trace, buffered"]
    rows = []
    try:
        for frozen in (False, True):
            if frozen:
                gc.freeze()
            for rep in range(2):
                for m in (modes if rep == 0 else modes[::-1]):
                    ms, gcs = run(m)
                    rows.append(dict(frozen=frozen, mode=m, steady_ms=ms,
                                     gc_collections=gcs))
                    print(f"headline, heap frozen {frozen}, {m}: steady "
                          f"{ms:.2f} ms/iter, gc collections {gcs}",
                          flush=True)
    finally:
        tel.TRACE_BUFFER = buffer
        gc.unfreeze()
        del heap
    return rows


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=16)
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import torch
    if not torch.cuda.is_available():
        print("telemetry_cost: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    import lightgbm_tpu_torch as lgb
    from lightgbm_tpu_torch import obs
    from lightgbm_tpu_torch.obs import telemetry as tel
    from lightgbm_tpu_torch.ops import cuda_build
    card = cs.card_line()
    cuda_build.build_all()
    calls = call_costs(obs, tel)
    for k, v in calls.items():
        print(f"{k}: {v:.2f} us [{card}]", flush=True)
    rows = headline_runs(lgb, obs, tel, cs, args.iters)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": card, "per_call_us": calls, "headline": rows},
                      f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
