#!/usr/bin/env python3
"""Find the first learner step where two runs of a full-size cell part.

A cell of ``tools/torch_fullsize_ref.py`` is trained for a few iterations
through ``lightgbm_tpu_torch`` on each device given, with every learner
step recorded (the gradients, the int8 packing, the root statistics, each
wave's histograms and split scan, the wave update, the finished tree).
The runs are compared step by step and the first tensors that differ are
printed.  ``--out`` writes a sha256 of every step's tensors, and
``--against`` compares this host's runs with such a file from another
host (the card's host against a CPU host, say)::

    python tools/fullsize_stepdiff.py --cell headline_l2 --devices cuda,cpu
    python tools/fullsize_stepdiff.py --cell stream --devices cuda,cpu
    python tools/fullsize_stepdiff.py --devices cpu --out steps.json
    python tools/fullsize_stepdiff.py --devices cpu --against steps.json

It also prints the numpy and torch versions and the cell's label mean as
numpy's ``mean`` and as the port's fixed-order ``host_mean`` give it.
Every cell of the tool but ``dp2_l2`` (a world of ranks) runs here: the
stream through ``train_streaming`` on its store, whose per-block
gradient calls (``get_gradients_k``) are recorded too.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import platform
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the learner steps recorded, in the order the learner calls them
STEPS = ("root_stats", "pack_values_q", "apply_hist_wave", "scan_grid",
         "_apply_wave", "finished_tree")


def flat(x, pre=""):
    """Every tensor inside ``x`` (tuples, named tuples, objects, dicts):
    ``[(path, tensor on the CPU)]``."""
    import torch
    if torch.is_tensor(x):
        return [(pre, x.detach().cpu().clone())]
    out = []
    if isinstance(x, (tuple, list)):
        for i, v in enumerate(x):
            out += flat(v, f"{pre}[{i}]")
    elif hasattr(x, "_fields"):
        for k in x._fields:
            out += flat(getattr(x, k), f"{pre}.{k}")
    elif isinstance(x, dict):
        for k, v in x.items():
            out += flat(v, f"{pre}.{k}")
    elif hasattr(x, "__dict__"):
        for k, v in vars(x).items():
            out += flat(v, f"{pre}.{k}")
    return out


def record_steps(log: list):
    """Wrap the learner's steps and the GBDT's gradients so that each call
    appends ``(step, [(path, tensor)])`` to ``log``."""
    from lightgbm_tpu_torch.boosting.gbdt import GBDT
    from lightgbm_tpu_torch.learner import serial
    from lightgbm_tpu_torch.objective.objectives import ObjectiveFunction

    def wrap(owner, name):
        f = getattr(owner, name)

        def g(*a, **k):
            r = f(*a, **k)
            entries = flat(r)
            if name == "_apply_wave":
                # row L of the best table and the histogram state is the
                # dump of padding slots: garbage no step reads
                entries = [(p, x[:-1] if p.startswith((".best",
                                                       ".hist_state"))
                            else x) for p, x in entries]
            log.append((name, entries))
            return r
        setattr(owner, name, g)

    for name in STEPS:
        wrap(serial, name)
    wrap(GBDT, "gradients")
    wrap(ObjectiveFunction, "get_gradients_k")


def same(a, b) -> bool:
    import torch
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.is_floating_point():
        return bool(((a == b) | (torch.isnan(a) & torch.isnan(b))).all())
    return torch.equal(a, b)


def first_differences(a: list, b: list, limit: int = 12) -> list:
    """The first tensors (at most ``limit``) that differ between two
    step logs."""
    out = []
    for i, ((na, ta), (_, tb)) in enumerate(zip(a, b)):
        for (k, xa), (_, xb) in zip(ta, tb):
            if not same(xa, xb):
                d = (xa != xb) if xa.shape == xb.shape else None
                idx = [] if d is None else d.nonzero()[:3].tolist()
                out.append({"step": i, "name": na + k,
                            "differ": None if d is None else int(d.sum()),
                            "of": xa.numel(), "first": idx,
                            "a": [xa[tuple(j)].item() for j in idx],
                            "b": [xb[tuple(j)].item() for j in idx]})
                if len(out) >= limit:
                    return out
    return out


def canonical_bytes(x) -> bytes:
    """A tensor's bytes with every NaN as one NaN (hosts set the sign and
    payload of 0/0 differently)."""
    import torch
    if x.is_floating_point():
        x = torch.where(torch.isnan(x), torch.full_like(x, float("nan")), x)
    return x.contiguous().numpy().tobytes()


def digests(log: list) -> list:
    return [(n, [(k, hashlib.sha256(canonical_bytes(x)).hexdigest()[:16])
                 for k, x in ts]) for n, ts in log]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cell", default="headline_l2")
    ap.add_argument("--iters", type=int, default=1)
    ap.add_argument("--devices", default="cuda,cpu")
    ap.add_argument("--out", default=None)
    ap.add_argument("--against", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, REPO)
    import torch
    import lightgbm_tpu_torch as lgb
    from lightgbm_tpu_torch.objective.objectives import host_mean
    from tools import torch_fullsize_ref as ref
    import tempfile
    from lightgbm_tpu_torch.config import Config
    if ref.CELLS[args.cell].get("mesh"):
        raise SystemExit(f"{args.cell}: a world of ranks; see chip_smoke.py "
                         f"phase 31")
    stream = ref.CELLS[args.cell].get("stream")
    tmp = tempfile.TemporaryDirectory()
    if stream:
        store = ref.stream_store(lgb.outofcore, Config, tmp.name)
        y = store.labels_array()
    else:
        y = ref.cell_data(args.cell)[1]
    print(json.dumps({"numpy": np.__version__, "torch": torch.__version__,
                      "python": platform.python_version(),
                      "label_mean_numpy": float(y.mean()).hex(),
                      "label_mean_host_sum": float(host_mean(y)).hex()}),
          flush=True)
    log, runs = [], {}
    record_steps(log)
    for dev in args.devices.split(","):
        log.clear()
        t0 = time.time()
        if stream:
            g, _ = ref.train_stream(lgb.train_streaming, store, args.iters,
                                    device=dev)
        else:
            g = ref.train(lgb, args.cell, args.iters, device=dev)[0]._gbdt
        runs[dev] = {"steps": list(log), "init": g.init_score_value,
                     "trees": ref.tree_digests(g.models)}
        rec = ref.load_record(args.cell)["tree_digests"]
        print(json.dumps({"device": dev, "steps": len(log),
                          "seconds": round(time.time() - t0, 1),
                          "init_score": float(runs[dev]["init"]).hex(),
                          "trees_as_record": [a == b for a, b in zip(
                              runs[dev]["trees"], rec)]}), flush=True)
    tmp.cleanup()
    devs = list(runs)
    if len(devs) >= 2:
        print(json.dumps({"first_differences": first_differences(
            runs[devs[0]]["steps"], runs[devs[1]]["steps"])}), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({d: digests(r["steps"]) for d, r in runs.items()}, f)
    if args.against:
        with open(args.against) as f:
            other = json.load(f)
        mine = digests(runs[devs[0]]["steps"])
        theirs = other.get(devs[0]) or next(iter(other.values()))
        for i, ((n, ka), (_, kb)) in enumerate(zip(mine, theirs)):
            diff = [k for (k, ha), (_, hb) in zip(ka, kb) if ha != hb]
            if diff:
                print(json.dumps({"first_step_apart": i, "name": n,
                                  "tensors": diff[:6]}), flush=True)
                break
        else:
            print(json.dumps({"first_step_apart": None}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
