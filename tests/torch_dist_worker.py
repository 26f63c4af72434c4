"""One rank of a lightgbm_tpu_torch process group on the CPU (gloo), for
the multi-process tests (``tests/test_torch_parallel.py``,
``tests/test_torch_multiprocess.py``).  It imports the port only.

    python tests/torch_dist_worker.py JOB.json RANK WORLD PORT

``JOB.json`` holds ``{"out": dir, "cases": [...], "device": "cpu" or
"cuda"}`` (a card a rank, ``cuda:<rank % device_count>``; the ``train``
cases run there); each case writes
``<out>/<name>.rank<r>.npz`` (tensors) and ``.json`` (everything else).
Kinds:

* ``learner`` — one ``build_tree_distributed`` over the bins and
  gradients of ``input`` (an ``.npz``): data/voting ranks take their
  contiguous row block, feature ranks every row (``int8_row_limit``
  stands in for the quantized modes' row bound);
* ``train`` — ``lgb.train`` on ``X``/``y`` of ``input``, each rank its
  contiguous row block of the binned set (every row for feature);
* ``load`` — ``Dataset(path, num_machines=world)``: the mod-rank rows
  with distributed bin finding, then ``lgb.train``;
* ``desync`` — a train, then three host gathers with the
  ``spmd.skip_record`` fault on rank 1 at the middle one, and the merged
  summary;
* ``snapshot`` — a data-parallel ``lgb.train`` with ``snapshot_freq``
  under ``prefix`` (the multi-process commit barrier), a resume from the
  snapshot at ``resume_at`` in the same world, and a run whose rank 1
  reports another digest at the barrier.

A case that raises writes its error instead; the rank goes on with the
next case, and leaves the process group on every exit path.
"""
import json
import os
import sys
import traceback


def _tree_out(bt):
    import numpy as np
    nl = int(bt.num_leaves)
    return {"num_leaves": np.int64(nl),
            **{k: getattr(bt, k).cpu().numpy() for k in (
                "feature", "threshold_bin", "default_left", "left_child",
                "right_child", "gain", "internal_value", "internal_count",
                "leaf_value", "leaf_count", "leaf_depth", "row_leaf",
                "row_value")}}


def _block(n, rank, world):
    per = -(-n // world)
    return min(rank * per, n), min((rank + 1) * per, n)


def run_learner(case, rank, world):
    import numpy as np
    import torch
    from lightgbm_tpu_torch.convert import device_data_from_numpy
    from lightgbm_tpu_torch.learner.serial import GrowthParams
    from lightgbm_tpu_torch.obs import flight_recorder as fr
    from lightgbm_tpu_torch.ops import histogram as t_hist
    from lightgbm_tpu_torch.ops.split import SplitParams
    from lightgbm_tpu_torch.parallel.learners import build_tree_distributed
    from lightgbm_tpu_torch.parallel.mesh import MeshContext
    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.learner import serial
    z = np.load(case["input"], allow_pickle=True)
    meta = z["meta"].item()
    bins, grad, hess = z["bins"], z["grad"], z["hess"]
    bag = z["bag"] if "bag" in z.files else None
    fmask = z["fmask"] if "fmask" in z.files else None
    lt = case["learner"]
    if lt in ("data", "voting"):
        lo, hi = _block(len(bins), rank, world)
        bins, grad, hess = bins[lo:hi], grad[lo:hi], hess[lo:hi]
        bag = bag[lo:hi] if bag is not None else None
    dd = device_data_from_numpy(bins, meta, "cpu")
    ctx = MeshContext(Config.from_params({"tree_learner": lt}), "cpu")
    p = GrowthParams(num_leaves=case["L"],
                     split=SplitParams(**case.get("split", {})))
    fr.reset()
    k5_wrappers = (t_hist.hist_active_raw, t_hist.hist_active_float_raw)
    k5 = sum(f.plain_calls for f in k5_wrappers)
    limit = serial._INT8_ROW_LIMIT
    serial._INT8_ROW_LIMIT = case.get("int8_row_limit", limit)
    try:
        bt = build_tree_distributed(
            ctx, lt, dd, torch.as_tensor(grad), torch.as_tensor(hess), p,
            bag_mask=None if bag is None else torch.as_tensor(bag),
            feature_mask=None if fmask is None else torch.as_tensor(fmask),
            top_k=case.get("top_k", 20), hist_mode=case.get("hist_mode"),
            overlap=case.get("overlap"))
    finally:
        serial._INT8_ROW_LIMIT = limit
    snap = fr.snapshot()
    psums = sum(1 for e in snap["last"]
                if e["site"] == "parallel.learners.hist_psum")
    return _tree_out(bt), {
        "fr_digest": snap["digest"], "fr_count": snap["count"],
        "hist_psum_records": psums,
        "k5_calls": sum(f.plain_calls for f in k5_wrappers) - k5}


def _train_set(case, rank, world):
    import numpy as np
    import lightgbm_tpu_torch as lgb
    z = np.load(case["input"])
    X, y = z["X"], z["y"]
    params = dict(case["params"])
    full = lgb.Dataset(X, label=y, params=params)
    if params.get("tree_learner", "serial") in ("data", "voting"):
        lo, hi = _block(len(X), rank, world)
        return full.subset(np.arange(lo, hi), params=params), params, z
    return full, params, z


def run_train(case, rank, world, device="cpu"):
    import numpy as np
    import lightgbm_tpu_torch as lgb
    from lightgbm_tpu_torch.ops import histogram as t_hist
    ds, params, z = _train_set(case, rank, world)
    k5 = t_hist.hist_active_raw.launches
    valid = []
    if "Xv" in z.files:
        valid = [lgb.Dataset(z["Xv"], label=z["yv"], reference=ds)]
    ev = {}
    bst = lgb.train(dict(params), ds, case.get("rounds", 5),
                    valid_sets=valid, valid_names=["v"][:len(valid)],
                    evals_result=ev, verbose_eval=False,
                    early_stopping_rounds=case.get("early_stopping"),
                    device=device)
    gbdt = bst._gbdt
    return {"scores": gbdt.scores.cpu().numpy()}, {
        "k5_launches": t_hist.hist_active_raw.launches - k5,
        "model": bst.model_to_string(),
        "digest": bst.digest(include_scores=False),
        "best_iteration": int(bst.best_iteration),
        "iterations": int(bst.current_iteration()),
        "evals": ev, "init_score": float(gbdt.init_score_value)}


def run_load(case, rank, world):
    import lightgbm_tpu_torch as lgb
    params = dict(case["params"])
    ds = lgb.Dataset(case["path"], params=params).construct()
    b = ds._constructed
    bst = lgb.train(dict(params), ds, case.get("rounds", 3),
                    verbose_eval=False, device="cpu")
    return {"bins": b.bins}, {
        "mappers": [m.to_dict() for m in b.mappers],
        "num_data": int(b.num_data), "model": bst.model_to_string()}


def run_desync(case, rank, world):
    from lightgbm_tpu_torch import obs
    from lightgbm_tpu_torch.io.distributed import process_allgather
    from lightgbm_tpu_torch.utils import faults
    obs.reset()
    obs.enable()
    arrays, info = run_train(case, rank, world)
    # rank 1 drops the record of the middle one of three host gathers
    for step in range(3):
        if rank == 1 and step == 1:
            faults.inject("spmd.skip_record", times=1)
        try:
            process_allgather({"step": step, "rank": rank})
        finally:
            faults.clear()
    merged = obs.merged_summary()
    info["merged"] = {k: merged.get(k) for k in (
        "process_count", "flight_recorder_check", "collective_skew")}
    info["merged"]["ranks"] = [s.get("rank") for s in merged["ranks"]]
    obs.reset()
    return arrays, info


def run_snapshot(case, rank, world, device="cpu"):
    import lightgbm_tpu_torch as lgb
    from lightgbm_tpu_torch import obs
    from lightgbm_tpu_torch.boosting import snapshot as snap
    from lightgbm_tpu_torch.boosting.gbdt import GBDT
    ds, params, _ = _train_set(case, rank, world)
    params = dict(params, output_model=case["prefix"],
                  snapshot_freq=case["freq"], snapshot_keep=8)
    rounds = case["rounds"]
    full = lgb.train(dict(params), ds, rounds, verbose_eval=False,
                     device=device)
    manifest = snap.snapshot_paths(case["prefix"], case["resume_at"])[2]
    res = lgb.train(dict(params), ds, rounds, verbose_eval=False,
                    device=device, resume_from=manifest)
    info = {"digest": full.digest(include_scores=False),
            "digest_scores": full.digest(),
            "resumed_digest": res.digest(include_scores=False),
            "resumed_digest_scores": res.digest(),
            "model": full.model_to_string(),
            "resumed_model": res.model_to_string()}
    # rank 1 reports another digest at the barrier: both ranks refuse
    obs.reset()
    obs.enable()
    digest = GBDT.digest
    if rank == 1:
        GBDT.digest = lambda self, include_scores=True: "rank1-differs"
    try:
        lgb.train(dict(params, output_model=case["prefix"] + ".bad"), ds,
                  case["freq"], verbose_eval=False, device=device)
        info["mismatch_error"] = None
    except RuntimeError as exc:
        info["mismatch_error"] = str(exc)
    finally:
        GBDT.digest = digest
    info["mismatch_events"] = obs.summary()["events"].get(
        "elastic:barrier_mismatch", 0)
    info["bad_manifests"] = len(snap.list_snapshots(
        case["prefix"] + ".bad"))
    obs.reset()
    return {"scores": res._gbdt.scores.cpu().numpy()}, info


def run_world(cases, world, out_dir, timeout=240.0, device="cpu"):
    """Start ``world`` ranks of this script over ``cases`` (a free port,
    the ``spawn``-clean way: fresh interpreters) and wait for them; ->
    ``{case name: [(arrays, info) of rank 0, ...]}``.  A rank that fails
    or outlives ``timeout`` fails the call, and every rank is killed."""
    import socket
    import subprocess
    import numpy as np
    os.makedirs(out_dir, exist_ok=True)
    job = os.path.join(out_dir, "job.json")
    with open(job, "w") as f:
        json.dump({"out": out_dir, "cases": cases, "device": device}, f)
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    env = dict(os.environ)
    env.pop("LGBM_TPU_FAULTS", None)
    env.pop("LGBM_TPU_TRACE", None)
    import time
    logs = [os.path.join(out_dir, f"rank{r}.log") for r in range(world)]
    procs = []
    for r in range(world):
        with open(logs[r], "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), job, str(r),
                 str(world), str(port)], env=env, stdout=log,
                stderr=subprocess.STDOUT))
    try:
        t_end = time.monotonic() + timeout
        for p in procs:
            p.wait(timeout=max(1.0, t_end - time.monotonic()))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    if bad:
        raise RuntimeError(f"ranks {bad} failed:\n" + "\n".join(
            open(logs[r]).read()[-3000:] for r in bad))
    res = {}
    for case in cases:
        name = case["name"]
        per = []
        for r in range(world):
            base = os.path.join(out_dir, f"{name}.rank{r}")
            with np.load(base + ".npz", allow_pickle=True) as z:
                arrays = {k: z[k] for k in z.files}
            with open(base + ".json") as f:
                per.append((arrays, json.load(f)))
        res[name] = per
    return res


KINDS = {"learner": run_learner, "train": run_train, "load": run_load,
         "desync": run_desync, "snapshot": run_snapshot}


def main():
    job_path, rank, world, port = (sys.argv[1], int(sys.argv[2]),
                                   int(sys.argv[3]), int(sys.argv[4]))
    # the ranks run beside the rest of the suite on few cores: yield to
    # tests that hold wall-clock deadlines (heartbeats, timing budgets)
    os.nice(10)
    import numpy as np
    import torch
    torch.set_num_threads(1)
    from lightgbm_tpu_torch.parallel import mesh
    with open(job_path) as f:
        job = json.load(f)
    out = job["out"]
    try:
        device = job.get("device", "cpu")
        mesh.init_distributed(f"127.0.0.1:{port}", world, rank,
                              device="cpu" if device == "cpu" else None,
                              timeout_s=120.0)
        for case in job["cases"]:
            name = case["name"]
            for k, v in case.get("env", {}).items():
                os.environ[k] = v
            try:
                kw = ({"device": device}
                      if case["kind"] in ("train", "snapshot") else {})
                arrays, info = KINDS[case["kind"]](case, rank, world, **kw)
            except Exception as exc:  # noqa: BLE001 - reported to the test
                arrays, info = {}, {"error": f"{type(exc).__name__}: {exc}",
                                    "traceback": traceback.format_exc()}
            for k in case.get("env", {}):
                os.environ.pop(k, None)
            np.savez(os.path.join(out, f"{name}.rank{rank}.npz"), **arrays)
            with open(os.path.join(out, f"{name}.rank{rank}.json"),
                      "w") as f:
                json.dump(info, f, default=str)
            # every case ends with the ranks in step
            torch.distributed.barrier()
    finally:
        mesh.destroy()


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    main()
