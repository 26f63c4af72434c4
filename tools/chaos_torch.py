"""Chaos launcher for lightgbm_tpu_torch's elastic training: SIGKILL a
rank mid-run and demand the same bytes back.

The counterpart of the JAX package's ``tools/chaos.py`` for the port
(it imports the port only).  It:

1. hosts an :class:`~lightgbm_tpu_torch.parallel.elastic.ElasticCoordinator`
   in this process;
2. trains the uninterrupted single-process oracle,
   ``StreamTrainer(num_shards=S)``, on the same device as the workers;
3. spawns N worker processes (``python -m tools.chaos_torch --worker
   SPEC``) that build the same inputs from the spec (a synthetic set from
   its seed, or a shard store the spec names, which they mmap) and train
   them through :func:`~lightgbm_tpu_torch.boosting.streaming.train_elastic`;
4. watches their progress on the coordinator's heartbeats
   (``membership()``) and delivers ``SIGKILL``, not SIGTERM (no atexit,
   no flush), to the victim once it reports the kill iteration;
5. optionally spawns a replacement joiner (the world regrows);
6. fails unless every surviving worker's model sha256 and ``digest()``
   equal the oracle's, and every recovery episode's phases sum to its
   ``mttr_s``.

The model depends on ``(data, config, S)`` only, never on the world size
or the membership history, so the single-process oracle is the oracle of
every run: a clean two-process run, a killed and shrunk one, a killed and
regrown one.

Each worker reports its launches of the kernels (K1-K6 wrappers), the
health states ``/healthz`` walked through (polled every 10 ms), its wall,
its recovery episodes, its ``elastic.*`` and ``stream.*`` counters
(``elastic.bytes_exchanged``: the encoded shard payloads it sent) and
its collective wait accounting.  ``--device cuda`` runs oracle and workers on
card 0 (a worker that finds no card fails); workers reuse the kernels
the oracle built.

Usage::

    python -m tools.chaos_torch --device cpu --workers 2 --kill-iter 3
    python -m tools.chaos_torch --device cpu --workers 2 --kill-iter 3 --respawn
    python -m tools.chaos_torch --device cpu --workers 2 --no-kill
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import signal
import subprocess
import sys
import tempfile
import threading
import time
from typing import Any, Dict, List, Optional

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the launch counters a worker reports: the wrappers of K1-K6
COUNTERS = {
    "hist_route": ("ops.histogram", "hist_route_raw"),          # K1
    "route": ("ops.route", "route_rows_raw"),                   # K2
    "hist_compact": ("ops.compact", "hist_compact_raw"),        # K3
    "route_values": ("ops.route", "route_rows_values_raw"),     # K4
    "hist_active": ("ops.histogram", "hist_active_raw"),        # K5
    "split_scan": ("ops.split_kernel", "find_best_splits_kernel"),  # K6
}


def counters() -> Dict[str, Any]:
    """The K1-K6 wrappers by name; each counts its kernel launches
    (``launches``) and, on the CPU, its plain runs (``plain_calls``)."""
    import importlib
    return {k: getattr(importlib.import_module(
        f"lightgbm_tpu_torch.{mod}"), fn) for k, (mod, fn) in
        COUNTERS.items()}


def default_spec(rundir: str, workers: int = 2, shards: int = 0,
                 iters: int = 8, rows: int = 600, features: int = 8,
                 leaves: int = 7, snapshot_freq: int = 1, seed: int = 7,
                 device: str = "cpu") -> Dict[str, Any]:
    return {
        "rows": int(rows), "features": int(features), "seed": int(seed),
        "shards": int(shards) or int(workers), "device": device,
        "block_rows": None, "store": None,
        "params": {
            "objective": "regression", "num_leaves": int(leaves),
            "num_iterations": int(iters), "learning_rate": 0.2,
            "min_data_in_leaf": 5, "feature_fraction": 0.8, "seed": 3,
            "snapshot_freq": int(snapshot_freq), "snapshot_keep": 2,
            "output_model": os.path.join(rundir, "chaos_model.txt"),
            "verbose": -1,
        },
    }


def build_inputs(spec: Dict[str, Any]):
    """spec -> (params, source): the shard store the spec names, opened
    read-only, or a BinnedDataset of the synthetic rows of its seed.  A
    pure function of the spec."""
    import numpy as np
    params = dict(spec["params"])
    if spec.get("store"):
        from lightgbm_tpu_torch.io.outofcore import MANIFEST, ShardStore
        with open(os.path.join(spec["store"], MANIFEST)) as f:
            return params, ShardStore(spec["store"], json.load(f))
    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.io.dataset import BinnedDataset, Metadata
    rng = np.random.default_rng(spec["seed"])
    n, f = spec["rows"], spec["features"]
    X = rng.normal(size=(n, f))
    y = (X[:, 0] + 0.5 * X[:, 1] ** 2 + np.sin(X[:, 2])
         + rng.normal(scale=0.1, size=n))
    md = Metadata()
    md.set_field("label", y.astype(np.float32))
    return params, BinnedDataset.from_raw(X, Config.from_params(params),
                                          metadata=md)


def model_identity(booster) -> Dict[str, str]:
    text = booster.save_model_to_string(-1)
    return {"model_sha256": hashlib.sha256(text.encode()).hexdigest(),
            "digest": booster.digest()}


def train_oracle(spec: Dict[str, Any]):
    """The uninterrupted single-process run at the spec's shard count:
    -> (booster, seconds)."""
    import torch
    from lightgbm_tpu_torch.boosting.streaming import StreamTrainer
    from lightgbm_tpu_torch.config import Config
    params, src = build_inputs(spec)
    cfg = Config.from_params(dict(params, snapshot_freq=-1))
    t0 = time.perf_counter()
    bst = StreamTrainer(cfg, src, block_rows=spec.get("block_rows"),
                        device=spec["device"],
                        num_shards=spec["shards"]).train()
    if spec["device"] == "cuda":
        torch.cuda.synchronize()
    return bst, time.perf_counter() - t0


# ---------------------------------------------------------------------------
# worker
# ---------------------------------------------------------------------------
class HealthWalk:
    """The ``/healthz`` states a scraper polling every ``period`` seconds
    sees, each change recorded once."""

    def __init__(self, period: float = 0.01):
        from lightgbm_tpu_torch.obs import health
        health._set_active(True)
        self._health = health
        self.walk: List[str] = []
        self._stop = threading.Event()
        self._t = threading.Thread(target=self._run, args=(period,),
                                   daemon=True, name="chaos-health-walk")
        self._t.start()

    def _poll(self) -> None:
        st = self._health.state()["state"]
        if not self.walk or self.walk[-1] != st:
            self.walk.append(st)

    def _run(self, period: float) -> None:
        while True:
            self._poll()
            if self._stop.wait(period):
                return

    def stop(self) -> List[str]:
        """Stop polling; the walk ends with the state at the stop."""
        self._stop.set()
        self._t.join(timeout=2.0)
        self._poll()
        return self.walk


def worker_main(spec_path: str, member: Optional[str] = None) -> int:
    with open(spec_path) as f:
        spec = json.load(f)
    import torch
    if spec["device"] == "cuda":
        if not torch.cuda.is_available():
            print("chaos worker: no CUDA device", file=sys.stderr)
            return 2
    else:
        torch.set_num_threads(1)    # toy tensors: more threads only spin
    from lightgbm_tpu_torch.boosting.streaming import (StreamTrainer,
                                                       train_elastic)
    from lightgbm_tpu_torch.obs import fleet
    # an iteration floor: at a toy shape a worker can run through every
    # iteration between two heartbeats, closing the kill window before
    # the launcher sees the victim's progress; the sleep changes no byte
    slow = float(os.environ.get("LGBM_TPU_CHAOS_ITER_SLEEP_S", "0") or 0)
    if slow > 0:
        orig = StreamTrainer._train_one_iter

        def throttled(self, it):
            time.sleep(slow)
            return orig(self, it)
        StreamTrainer._train_one_iter = throttled

    member = member or os.environ.get("LGBM_TPU_ELASTIC_MEMBER",
                                      f"pid{os.getpid()}")
    from lightgbm_tpu_torch import obs
    obs.enable()        # the run summary only (no trace file)
    params, src = build_inputs(spec)
    wrappers = counters()
    for w in wrappers.values():
        w.launches = 0
        w.plain_calls = 0
    walk = HealthWalk()
    t0 = time.perf_counter()
    try:
        booster = train_elastic(params, src, num_shards=spec["shards"],
                                min_world=int(spec.get("min_world", 1)),
                                block_rows=spec.get("block_rows"),
                                device=spec["device"])
        if spec["device"] == "cuda":
            torch.cuda.synchronize()
    finally:
        states = walk.stop()
    summary = obs.summary()
    result = dict(model_identity(booster), member=member,
                  seconds=time.perf_counter() - t0,
                  episodes=fleet.recovery_episodes(), health_walk=states,
                  counters={k: v for k, v in summary["counters"].items()
                            if k.startswith(("elastic.", "stream.waves",
                                             "stream.trees",
                                             "collective."))},
                  collective_skew=summary.get("collective_skew"),
                  launches={k: int(w.launches) for k, w in wrappers.items()},
                  plain_calls={k: int(w.plain_calls)
                               for k, w in wrappers.items()})
    out = os.path.join(os.path.dirname(spec_path), f"result-{member}.json")
    with open(out + ".tmp", "w") as f:
        json.dump(result, f)
    os.replace(out + ".tmp", out)
    print(f"[chaos-worker {member}] OK {result['model_sha256'][:12]}")
    return 0


# ---------------------------------------------------------------------------
# launcher
# ---------------------------------------------------------------------------
def _spawn(rundir: str, spec_path: str, address: str, member: str,
           worker_cmd: Optional[List[str]]) -> subprocess.Popen:
    env = {k: v for k, v in os.environ.items()
           if k not in ("LGBM_TPU_FAULTS", "LGBM_TPU_TRACE",
                        "LGBM_TPU_OPS_PORT")}
    env.update({
        "LGBM_TPU_ELASTIC": address,
        "LGBM_TPU_ELASTIC_MEMBER": member,
        "LGBM_TPU_HEARTBEAT_S": env.get("LGBM_TPU_HEARTBEAT_S", "0.1"),
        "LGBM_TPU_CHAOS_ITER_SLEEP_S":
            env.get("LGBM_TPU_CHAOS_ITER_SLEEP_S", "0.25"),
        "LGBM_TPU_COLLECTIVE_DEADLINE_S":
            env.get("LGBM_TPU_COLLECTIVE_DEADLINE_S", "60"),
        "PYTHONPATH": _REPO + os.pathsep + env.get("PYTHONPATH", ""),
    })
    cmd = (list(worker_cmd) + [spec_path, member] if worker_cmd else
           [sys.executable, "-m", "tools.chaos_torch", "--worker",
            spec_path, "--member", member])
    log = open(os.path.join(rundir, f"log-{member}.txt"), "w")
    return subprocess.Popen(cmd, cwd=_REPO, env=env, stdout=log,
                            stderr=subprocess.STDOUT)


def run_chaos(workers: int = 2, shards: int = 0, iters: int = 8,
              rows: int = 600, features: int = 8, leaves: int = 7,
              snapshot_freq: int = 1, kill_iter: Optional[int] = 3,
              kill_member: int = 1, respawn: bool = False,
              rundir: Optional[str] = None, timeout_s: float = 420.0,
              device: str = "cpu", spec: Optional[Dict[str, Any]] = None,
              oracle: Optional[Dict[str, str]] = None,
              worker_cmd: Optional[List[str]] = None) -> Dict[str, Any]:
    """One chaos scenario end to end; -> the verdict (key ``ok``).
    ``kill_iter=None`` is the uninterrupted control run.  ``spec`` (with
    its ``rundir``-relative files) replaces the synthetic default,
    ``oracle`` (a :func:`model_identity`) skips training the oracle, and
    ``worker_cmd`` replaces the worker command (the spec path and the
    member id are appended)."""
    from lightgbm_tpu_torch.parallel.elastic import ElasticCoordinator

    rundir = rundir or tempfile.mkdtemp(prefix="lgbm_torch_chaos_")
    os.makedirs(rundir, exist_ok=True)
    spec = dict(spec or default_spec(
        rundir, workers=workers, shards=shards, iters=iters, rows=rows,
        features=features, leaves=leaves, snapshot_freq=snapshot_freq,
        device=device))
    spec["min_world"] = workers
    spec_path = os.path.join(rundir, "spec.json")
    with open(spec_path, "w") as f:
        json.dump(spec, f, indent=1)

    verdict: Dict[str, Any] = {
        "ok": False, "rundir": rundir, "oracle": oracle, "killed": None,
        "respawned": None, "results": [], "errors": [],
    }
    if oracle is None:
        bst, seconds = train_oracle(spec)
        verdict["oracle"] = oracle = model_identity(bst)
        verdict["oracle_seconds"] = seconds
    want = oracle

    coord = ElasticCoordinator(heartbeat_timeout_s=1.0)
    address = coord.start()
    procs: Dict[str, subprocess.Popen] = {}
    t_start = time.perf_counter()
    try:
        for i in range(workers):
            member = f"worker-{i}"
            procs[member] = _spawn(rundir, spec_path, address, member,
                                   worker_cmd)
        victim = f"worker-{kill_member}" if kill_iter is not None else None
        deadline = time.monotonic() + timeout_s
        respawned = 0
        while time.monotonic() < deadline:
            info = coord.membership()
            if victim is not None and victim in procs:
                mem = next((m for m in info["members"]
                            if m["member"] == victim), None)
                if mem is not None and \
                        int(mem["detail"].get("iteration", 0)) >= kill_iter:
                    os.kill(procs[victim].pid, signal.SIGKILL)
                    procs[victim].wait()
                    verdict["killed"] = {
                        "member": victim,
                        "at_iteration": mem["detail"].get("iteration"),
                        "generation": info["generation"],
                        "after_s": time.perf_counter() - t_start}
                    print(f"[chaos] SIGKILL {victim} at iteration "
                          f"{mem['detail'].get('iteration')} "
                          f"(generation {info['generation']})", flush=True)
                    del procs[victim]
                    victim = None
                    if respawn:
                        member = f"joiner-{respawned}"
                        respawned += 1
                        # the joiner merges into the live world: it must
                        # not wait for the original world size
                        jpath = os.path.join(rundir, "spec-joiner.json")
                        with open(jpath, "w") as f:
                            json.dump(dict(spec, min_world=1), f, indent=1)
                        procs[member] = _spawn(rundir, jpath, address,
                                               member, worker_cmd)
                        verdict["respawned"] = member
            if procs and all(p.poll() is not None for p in procs.values()):
                break
            time.sleep(0.05)
        else:
            verdict["errors"].append(f"timeout after {timeout_s}s")
        for member, proc in procs.items():
            rc = proc.poll()
            if rc is None:
                proc.kill()
                proc.wait()
                verdict["errors"].append(f"{member} hung; killed")
            elif rc != 0:
                verdict["errors"].append(f"{member} exited {rc}")
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        coord.stop()
    verdict["seconds"] = time.perf_counter() - t_start

    for name in sorted(os.listdir(rundir)):
        if name.startswith("result-") and name.endswith(".json"):
            with open(os.path.join(rundir, name)) as f:
                verdict["results"].append(json.load(f))
    if not verdict["results"]:
        verdict["errors"].append("no worker produced a result")
    for res in verdict["results"]:
        for key in ("model_sha256", "digest"):
            if res[key] != want[key]:
                verdict["errors"].append(
                    f"{res['member']} {key} mismatch: {res[key][:12]} != "
                    f"oracle {want[key][:12]}")

    # every recovery a survivor lived through, phase by phase; a killed
    # run must leave at least one, and its phases sum to its mttr_s
    episodes = [dict(ep, member=res["member"])
                for res in verdict["results"]
                for ep in res.get("episodes", [])]
    for ep in episodes:
        gap = abs(sum(ep["phases"].values()) - ep["mttr_s"])
        if gap > 1e-9:
            verdict["errors"].append(
                f"{ep['member']} episode phases sum "
                f"{sum(ep['phases'].values()):.6f}s != mttr "
                f"{ep['mttr_s']:.6f}s")
    if verdict["killed"] is not None and verdict["results"] \
            and not episodes:
        verdict["errors"].append(
            "a rank was killed but no survivor recorded a recovery")
    if episodes:
        top = max(episodes, key=lambda ep: ep["mttr_s"])
        verdict["recovery"] = top
        verdict["mttr_s"] = top["mttr_s"]
    verdict["ok"] = not verdict["errors"]
    return verdict


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--worker", metavar="SPEC", help=argparse.SUPPRESS)
    ap.add_argument("--member", help=argparse.SUPPRESS)
    ap.add_argument("--device", choices=("cpu", "cuda"), default="cpu")
    ap.add_argument("--workers", type=int, default=2)
    ap.add_argument("--shards", type=int, default=0,
                    help="protocol shard count (default: --workers)")
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--rows", type=int, default=600)
    ap.add_argument("--features", type=int, default=8)
    ap.add_argument("--leaves", type=int, default=7)
    ap.add_argument("--snapshot-freq", type=int, default=1)
    ap.add_argument("--kill-iter", type=int, default=3,
                    help="SIGKILL the victim when it reports this "
                         "iteration")
    ap.add_argument("--kill-member", type=int, default=1)
    ap.add_argument("--no-kill", action="store_true",
                    help="the uninterrupted control run")
    ap.add_argument("--respawn", action="store_true",
                    help="spawn a replacement joiner after the kill")
    ap.add_argument("--rundir")
    ap.add_argument("--timeout", type=float, default=420.0)
    ap.add_argument("--json", action="store_true", dest="as_json")
    args = ap.parse_args(argv)

    if args.worker:
        return worker_main(args.worker, args.member)

    verdict = run_chaos(
        workers=args.workers, shards=args.shards, iters=args.iters,
        rows=args.rows, features=args.features, leaves=args.leaves,
        snapshot_freq=args.snapshot_freq,
        kill_iter=None if args.no_kill else args.kill_iter,
        kill_member=args.kill_member, respawn=args.respawn,
        rundir=args.rundir, timeout_s=args.timeout, device=args.device)
    if args.as_json:
        print(json.dumps(verdict, indent=1))
    else:
        for err in verdict["errors"]:
            print(f"[chaos] FAIL: {err}")
        mttr = verdict.get("mttr_s")
        mttr_txt = f", mttr={mttr:.3f}s" if mttr is not None else ""
        print(f"[chaos] {'OK' if verdict['ok'] else 'FAILED'}: "
              f"{len(verdict['results'])} result(s), killed="
              f"{verdict['killed']}{mttr_txt}, oracle "
              f"{verdict['oracle']['model_sha256'][:12]}")
    return 0 if verdict["ok"] else 1


if __name__ == "__main__":
    sys.path.insert(0, _REPO)
    sys.exit(main())
