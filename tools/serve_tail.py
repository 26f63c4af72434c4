"""Where a served request's tail goes, for one or more checkouts of the
port on the same card: the scorer's CUDA graph replay per bucket, the
host round trip of ``CompiledModel.predict_raw`` per batch, the
objective's output conversion per batch, and phase 12's open-loop
sweep at 1k and 5k QPS.

    python3 tools/serve_tail.py [--out DIR] [LABEL=CHECKOUT ...]

Each ``LABEL=CHECKOUT`` (default ``change=.``, the checkout this file is
in) runs in a process of its own that imports ``lightgbm_tpu_torch``,
``chip_smoke`` and ``tools/load_harness.py`` from ``CHECKOUT``, in the
order given (parent, change, change, parent pairs two versions on one
card).  Every process scores the same seeded forest of phase 12's
shape (``chip_smoke.random_forest``: 100 binary trees of up to 63
leaves over 28 features) with a binary objective.  Each prints one JSON
line (also written to ``DIR/<label>.<i>.json``): times in ms as p50 and
p99 over ``REPS`` calls, device times by CUDA events, host times by
``time.perf_counter``, the sweep's rows as ``tools/load_harness.py``
reports them, and the card's name and power limit.  Needs CUDA.
"""
import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUCKETS = (256, 1024, 4096)
BATCHES = (1, 17, 240, 900, 4000)    # request sizes -> buckets 256..4096
CONVERT_ROWS = (1, 17, 256, 4096)
REPS = 300
QPS = (1_000.0, 5_000.0)
QPS_S = 2.0
FEATURES = 28


def _pcts(ms):
    import numpy as np
    a = np.asarray(ms)
    return {"p50": float(np.percentile(a, 50)),
            "p99": float(np.percentile(a, 99))}


def worker(label: str, tree: str) -> dict:
    """One checkout's measurements (run in a process of its own)."""
    sys.path.insert(0, os.path.abspath(tree))
    import gc
    import importlib.util
    import numpy as np
    import torch
    import chip_smoke as cs
    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.objective import objectives
    from lightgbm_tpu_torch.serve import PredictionServer, compile_trees
    spec = importlib.util.spec_from_file_location(
        "load_harness", os.path.join(tree, "tools", "load_harness.py"))
    harness = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(harness)
    trees = cs.random_forest(21, num_class=1, iters=100, num_leaves=63,
                             num_features=FEATURES, cat_features=())
    obj = objectives.create_objective(Config.from_params(
        {"objective": "binary"}))
    cm = compile_trees(trees, num_class=1, objective=obj, device="cuda")
    cm.warm(BUCKETS)
    torch.cuda.synchronize()
    rng = np.random.RandomState(5)
    X = rng.normal(size=(8192, FEATURES)).astype(np.float32)
    out = {"label": label, "tree": tree, "card": cs.card_line(),
           "forest_leaf_sum": float(sum(float(np.sum(t.leaf_value))
                                        for t in trees))}

    replay = {}
    for b in BUCKETS:
        g = cm._graphs[(b, False)]
        g.rows.copy_(torch.from_numpy(X[:b]))
        ms = []
        for i in range(REPS + 20):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            g.graph.replay()
            end.record()
            end.synchronize()
            if i >= 20:
                ms.append(start.elapsed_time(end))
        replay[b] = _pcts(ms)
    out["replay_ms"] = replay

    def host(fn, arg):
        for _ in range(20):
            fn(arg)
        ms = []
        for _ in range(REPS):
            t0 = time.perf_counter()
            fn(arg)
            ms.append(1e3 * (time.perf_counter() - t0))
        return _pcts(ms)

    out["predict_raw_ms"] = {k: host(cm.predict_raw, X[:k])
                             for k in BATCHES}
    convert = getattr(objectives, "convert_rows", None)
    if convert is None:         # a checkout from before the blocked one
        def convert(o, raw):
            return o.convert_output(torch.as_tensor(raw)).numpy()
    raw = cm.predict_raw(X)
    out["convert_ms"] = {k: host(lambda r: convert(obj, r), raw[:k])
                         for k in CONVERT_ROWS}
    out["eager_calls"] = cm.eager_calls

    srv = PredictionServer(cm, max_batch=max(BUCKETS), max_wait_ms=1.0,
                           buckets=BUCKETS, min_bucket=BUCKETS[0],
                           raw_score=True)
    try:
        gc.collect()
        gc.freeze()
        out["sweep"] = harness.sweep(srv, X, QPS, QPS_S,
                                     rows_per_request=1, seed=13)
    finally:
        gc.unfreeze()
        srv.close()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("runs", nargs="*", default=["change=."])
    ap.add_argument("--out", default=os.path.join(HERE, "chiprun_out",
                                                  "serve_tail"))
    ap.add_argument("--worker", nargs=2, metavar=("LABEL", "CHECKOUT"))
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("serve_tail: no CUDA device", file=sys.stderr)
        return 2
    if args.worker:
        print(json.dumps(worker(*args.worker)), flush=True)
        return 0
    os.makedirs(args.out, exist_ok=True)
    rc = 0
    for i, run in enumerate(args.runs):
        label, tree = run.split("=", 1)
        p = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--worker", label, os.path.abspath(tree)],
                           capture_output=True, text=True, timeout=600)
        if p.returncode != 0:
            print(f"serve_tail: {label} failed:\n{p.stderr[-4000:]}",
                  file=sys.stderr)
            rc = 1
            continue
        line = p.stdout.strip().splitlines()[-1]
        with open(os.path.join(args.out, f"{label}.{i}.json"), "w") as f:
            f.write(line + "\n")
        print(line, flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
