#!/usr/bin/env python3
"""What the live ops plane and the numerics sentinels cost the headline
of ``chip_smoke.py`` on a GPU, and where that cost would come from.

    python3 tools/plane_cost.py [--runs 32] [--piece-runs 3] [--turns 4]
                                [--situ-runs 3] [--out FILE]
    python3 tools/plane_cost.py --summarize FILE ...

Builds the kernels and the headline (1M x 28, ``max_bin`` 63, 255
leaves, 32 iterations), then:

1. times, on the host, one call of each piece of the plane's work an
   iteration does: a telemetry span with telemetry off, on, and on with
   the metrics registry as its sink; the registry's own ``span``; a
   health mark; and the device-side sentinel over the headline's score
   shape (``[1M, 1]`` f32, a sync included);
2. counts the sink calls of one plane-mounted headline run by kind, and
   multiplies them by (1)'s per-call times: the sink's own ms/iter;
3. times the plane's own calls from inside ``--situ-runs`` plane-on
   headline runs (:class:`InSitu`): ms an iteration by call, with the
   caches as training leaves them;
4. runs ``chip_smoke.plane_cost_path`` with ``--runs`` runs: the plane's
   live work toggled by iteration inside each run, the median of the
   pairs' on - off differences (what phase 27 holds), and the garbage
   collector's passes meanwhile;
5. toggles each piece of that work alone (telemetry with its sink, the
   sentinels, the health marks), all of them, and none (the pairs' null
   spread), ``--piece-runs`` runs each in turns, and keeps every
   iteration's milliseconds and flag;
6. runs whole headline runs off and with the plane and sentinels on, in
   ``--turns`` pairs of alternating order (off-on, on-off, ...), and
   reports each pair's on - off steady ms/iter (``IterClock``).
Stages 4-6 are left out when their count is 0.

Prints one JSON object as its last line, and writes the whole result
(every iteration's milliseconds included) to ``--out`` when given.
``--summarize`` reads such files (or a smoke log's phase 27) and prints
the toggled pairs' spread and what it means for the gate at 90 pairs
and at its own count (:func:`spread`).
"""
import argparse
import gc
import json
import math
import os
import statistics
import sys
import time
from collections import Counter

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
import lightgbm_tpu_torch as lgb  # noqa: E402
from lightgbm_tpu_torch import obs  # noqa: E402
from lightgbm_tpu_torch.obs import health, ops_plane, telemetry  # noqa: E402
from lightgbm_tpu_torch.ops import cuda_build  # noqa: E402

CALLS = 100_000
SENTINEL_CALLS = 200


def per_call_us(fn, n: int) -> float:
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    return 1e6 * (time.perf_counter() - t0) / n


def span_once():
    with obs.span("tree.hist"):
        pass


def host_costs() -> dict:
    """(1): microseconds a call."""
    out = {}
    with cs.obs_env():
        out["span_off_us"] = per_call_us(span_once, CALLS)
        obs.enable()
        out["span_on_us"] = per_call_us(span_once, CALLS)
    with cs.obs_env(LGBM_TPU_OPS_PORT="0"):
        reg = ops_plane.mount("cost").registry
        out["span_sink_us"] = per_call_us(span_once, CALLS)
        out["registry_span_us"] = per_call_us(
            lambda: reg.span("tree.hist", 1e-3), CALLS)
        out["mark_ready_us"] = per_call_us(health.mark_ready, CALLS)
        s = torch.zeros((cs.HEADLINE_ROWS, 1), device="cuda")
        torch.cuda.synchronize()
        out["sentinel_us"] = per_call_us(
            lambda: health.check_scores(s, window=0), SENTINEL_CALLS)
    return out


class GcPauses:
    """Counts and times the garbage collector's passes by generation
    while it is entered."""

    def __init__(self):
        self.passes = Counter()
        self.seconds = Counter()
        self._t0 = 0.0

    def _callback(self, phase, info):
        if phase == "start":
            self._t0 = time.perf_counter()
        else:
            gen = info["generation"]
            self.passes[gen] += 1
            self.seconds[gen] += time.perf_counter() - self._t0

    def __enter__(self):
        gc.callbacks.append(self._callback)
        return self

    def __exit__(self, *exc):
        gc.callbacks.remove(self._callback)
        return False

    def report(self) -> dict:
        return {f"gen{g}": {"passes": self.passes[g],
                            "ms": 1e3 * self.seconds[g]}
                for g in sorted(self.passes)}


class InSitu:
    """Times the plane's own calls from inside a plane-on run: every
    span's enter and exit, the counters, the sentinels' checks and
    switch reads, and the health marks (the wrapper's own overhead
    included)."""

    TARGETS = ((telemetry._Span, "__enter__"), (telemetry._Span, "__exit__"),
               (obs, "counter_add"), (health, "check_scores"),
               (health, "sentinels_enabled"), (health, "mark_ready"))

    def __init__(self):
        self.seconds = Counter()
        self.calls = Counter()
        self._saved = []

    def _wrap(self, fn, key):
        seconds, calls, clock = self.seconds, self.calls, time.perf_counter

        def timed(*args, **kw):
            t0 = clock()
            try:
                return fn(*args, **kw)
            finally:
                seconds[key] += clock() - t0
                calls[key] += 1
        return timed

    def __enter__(self):
        for owner, attr in self.TARGETS:
            fn = getattr(owner, attr)
            self._saved.append((owner, attr, fn))
            setattr(owner, attr, self._wrap(fn, attr))
        return self

    def __exit__(self, *exc):
        for owner, attr, fn in reversed(self._saved):
            setattr(owner, attr, fn)
        self._saved = []
        return False


def in_situ(ds, counters, head_ref: dict, runs: int) -> dict:
    """(3a): ms an iteration inside the plane's own calls, by call,
    over ``runs`` whole headline runs with the plane and sentinels on."""
    on_env = {"LGBM_TPU_OPS_PORT": "0", "LGBM_TPU_SENTINELS": "1"}
    timer = InSitu()
    for run in range(runs):
        with cs.obs_env(**on_env), timer:
            bst, _, _ = cs.train_path(
                lgb, f"headline, plane on, timed inside ({run + 1})",
                counters, cs.HEADLINE_PARAMS, ds, cs.HEADLINE_ITERS)
        if bst.digest() != head_ref["digest"]:
            raise AssertionError("plane timed inside: another model")
    iters = runs * cs.HEADLINE_ITERS
    out = {k: {"calls_per_iter": timer.calls[k] / iters,
               "ms_per_iter": 1e3 * timer.seconds[k] / iters}
           for k in timer.calls}
    out["total_ms_per_iter"] = sum(v["ms_per_iter"] for v in out.values())
    return out


class CountingSink:
    """Stands in for the registry and counts its calls by kind."""

    def __init__(self, registry):
        self.registry = registry
        self.calls = Counter()

    def __getattr__(self, kind):
        fn = getattr(self.registry, kind)

        def call(*args, **kw):
            self.calls[kind] += 1
            return fn(*args, **kw)
        return call


class InstallCounter:
    before_iteration = True

    def __init__(self):
        self.sink = None

    def __call__(self, env):
        if self.sink is None:
            self.sink = CountingSink(ops_plane.plane().registry)
            telemetry.set_sink(self.sink)


def sink_calls(ds, counters) -> dict:
    """(2): sink calls an iteration on the headline, by kind."""
    with cs.obs_env(LGBM_TPU_OPS_PORT="0"):
        inst = InstallCounter()
        cs.train_path(lgb, "headline, sink counted", counters,
                      cs.HEADLINE_PARAMS, ds, cs.HEADLINE_ITERS,
                      callbacks=[inst])
        calls = dict(inst.sink.calls)
    return {k: v / cs.HEADLINE_ITERS for k, v in calls.items()}


def pieces(ds, counters, runs: int, head_ref: dict) -> dict:
    """(5): each piece toggled alone, all, none; every iteration kept."""
    sets = {"all": cs.PlaneToggle.PIECES, "none": ()}
    sets.update({p: (p,) for p in cs.PlaneToggle.PIECES})
    out = {k: {"diffs_ms": [], "iter_ms": [], "flags": []} for k in sets}
    for run in range(runs):
        for name, which in sets.items():
            with cs.obs_env(LGBM_TPU_OPS_PORT="0"):
                clock = cs.IterClock()
                toggle = cs.PlaneToggle(cs.HEADLINE_ITERS, seed=100 + run,
                                        pieces=which)
                bst, _, _ = cs.train_path(
                    lgb, f"headline, {name} toggled ({run + 1})", counters,
                    cs.HEADLINE_PARAMS, ds, cs.HEADLINE_ITERS,
                    callbacks=[toggle, clock])
            if bst.digest() != head_ref["digest"]:
                raise AssertionError(f"{name} toggled: another model")
            ms = clock.iter_ms()
            out[name]["diffs_ms"] += toggle.pair_diffs(ms)
            out[name]["iter_ms"].append(ms)
            out[name]["flags"].append(toggle.flags)
    for name, o in out.items():
        o["median_diff_ms"] = statistics.median(o["diffs_ms"])
        print(f"{name}: median on - off {o['median_diff_ms']:.3f} ms/iter "
              f"over {len(o['diffs_ms'])} pairs", flush=True)
    return out


def whole_runs(ds, counters, turns: int, head_ref: dict) -> dict:
    """(6): paired whole runs, order alternating."""
    on_env = {"LGBM_TPU_OPS_PORT": "0", "LGBM_TPU_SENTINELS": "1"}
    pairs = []
    for turn in range(turns):
        order = ("off", "on") if turn % 2 == 0 else ("on", "off")
        ms = {}
        for kind in order:
            with cs.obs_env(**(on_env if kind == "on" else {})):
                clock = cs.IterClock()
                bst, _, _ = cs.train_path(
                    lgb, f"headline, plane {kind} ({turn + 1})", counters,
                    cs.HEADLINE_PARAMS, ds, cs.HEADLINE_ITERS,
                    callbacks=[clock])
            if bst.digest() != head_ref["digest"]:
                raise AssertionError(f"plane {kind}: another model")
            ms[kind] = clock.steady_ms
        pairs.append(ms)
    diffs = [p["on"] - p["off"] for p in pairs]
    return {"pairs": pairs, "diffs_ms": diffs,
            "median_diff_ms": statistics.median(diffs)}


# the pairs phase 27 holds: 15 a 32-iteration run (the first unpaired)
GATE_PAIRS = cs.OBS_COST_RUNS * ((cs.HEADLINE_ITERS - 1) // 2)


def spread(diffs: list, bound: float) -> dict:
    """The pairs' median and interquartile range, the median's standard
    error (1.2533 sigma / sqrt(n), sigma = IQR / 1.349) at the pairs'
    own count, at 90 (the gate to PR 22) and at ``GATE_PAIRS``, and the
    normal chance that a median of so many such pairs lands past
    ``bound``."""
    d = sorted(diffs)
    q1, q3 = (statistics.quantiles(d, n=4) + [0.0])[0:3:2]
    med, sigma = statistics.median(d), (q3 - q1) / 1.349
    out = {"pairs": len(d), "median_ms": med, "iqr_ms": q3 - q1}
    for n in (len(d), 90, GATE_PAIRS):
        se = 1.2533 * sigma / math.sqrt(n)
        out[f"se_{n}_ms"] = se
        out[f"p_past_bound_{n}"] = 0.5 * math.erfc((bound - med)
                                                   / (se * math.sqrt(2)))
    return out


def saved_cost(path: str) -> dict:
    """The toggled stage of a result this tool saved, or of phase 27's
    line in a log of ``chip_smoke.py``."""
    with open(path) as f:
        text = f.read()
    if text.startswith("{"):
        return json.loads(text)["in_run"]
    for line in text.splitlines():
        if line.startswith('{"phase": 27,'):
            return json.loads(line)["cost"]
    raise ValueError(f"{path}: no toggled plane cost")


def summarize(paths: list) -> int:
    """``--summarize FILE ...``: :func:`spread` of each saved result's
    toggled stage (or a smoke log's phase 27), one JSON line a file (no
    card needed)."""
    for path in paths:
        cost = saved_cost(path)
        print(json.dumps({"file": path, **spread(cost["diffs_ms"],
                                                 cost["bound_ms"])}))
    return 0


def main() -> int:
    if sys.argv[1:2] == ["--summarize"]:
        return summarize(sys.argv[2:])
    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", type=int, default=cs.OBS_COST_RUNS)
    ap.add_argument("--piece-runs", type=int, default=3)
    ap.add_argument("--turns", type=int, default=4)
    ap.add_argument("--situ-runs", type=int, default=3)
    ap.add_argument("--out")
    args = ap.parse_args()
    card = cs.card_line()
    print(card, flush=True)
    cuda_build.build_all()
    from lightgbm_tpu_torch.ops.compact import hist_compact_raw
    from lightgbm_tpu_torch.ops.histogram import hist_route_raw
    from lightgbm_tpu_torch.ops.route import (route_rows_raw,
                                              route_rows_values_raw)
    counters = {"route": route_rows_raw,
                "route_values": route_rows_values_raw,
                "hist_route": hist_route_raw,
                "hist_compact": hist_compact_raw}
    X, z = cs.headline_latent()
    y = (z > 0).astype(np.float32)
    ds = lgb.Dataset(X, label=y, params={"max_bin": 63}).construct()
    with cs.obs_env():
        bst, _, _ = cs.train_path(lgb, "headline, reference", counters,
                                  cs.HEADLINE_PARAMS, ds, cs.HEADLINE_ITERS)
    head_ref = {"digest": bst.digest()}
    res = {"card": card, "host_us": host_costs()}
    calls = sink_calls(ds, counters)
    res["sink_calls_per_iter"] = calls
    per = {"span": res["host_us"]["span_sink_us"]
           - res["host_us"]["span_on_us"]}
    res["sink_ms_per_iter"] = 1e-3 * sum(
        n * per.get(k, res["host_us"]["registry_span_us"])
        for k, n in calls.items())
    print(json.dumps(res), flush=True)
    res["in_situ"] = in_situ(ds, counters, head_ref, args.situ_runs)
    print(json.dumps({"in_situ": res["in_situ"]}), flush=True)
    if args.runs:
        pauses = GcPauses()
        with pauses:
            cost = cs.plane_cost_path(lgb, counters, ds, head_ref, {},
                                      runs=args.runs, hold=False)
        cost["gc"] = pauses.report()
        d, n = cost["diffs_ms"], len(cost["diffs_ms"]) // args.runs
        cost["per_run_median_ms"] = [statistics.median(d[i:i + n])
                                     for i in range(0, len(d), n)]
        res["in_run"] = cost
    if args.piece_runs:
        res["pieces"] = pieces(ds, counters, args.piece_runs, head_ref)
    if args.turns:
        res["whole_runs"] = whole_runs(ds, counters, args.turns, head_ref)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f)
    print(json.dumps({k: v for k, v in res.items() if k != "pieces"}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
