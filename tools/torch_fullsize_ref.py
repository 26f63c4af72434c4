#!/usr/bin/env python3
"""Full-size records of the JAX package's models, and the port held to them.

``chip_smoke.py`` phase 31 holds the models that the port trains on the
card at full size to models of the JAX package (``lightgbm_tpu``).  The
reference cannot run where the card is (the port's programs import no
JAX) and takes minutes an iteration at these sizes in Pallas interpret
mode, so its models are recorded once, here on the CPU, and committed as
``tests/data/torch_fullsize/<cell>.json.gz``.

Record every cell (minutes to tens of minutes each on a CPU host)::

    JAX_PLATFORMS=cpu python tools/torch_fullsize_ref.py [--cells a,b]

Train the port on the CPU on each record's data and parameters and report
"identical" or the first divergence (``--iters`` cuts a prefix)::

    python tools/torch_fullsize_ref.py --check cpu [--cells a,b] [--iters N]

The JAX package is forced onto its kernel path: ``LGBM_TPU_HIST_BACKEND=
compact`` (off the TPU its default backend is the unquantized scatter,
another model) and, for the cells with at most 65,536 rows, also
``LGBM_TPU_SPLIT_INTERPRET=1`` (its fused split kernel, which the port's
split kernel follows).  The generators restate ``chip_smoke.py``'s.

A record holds the cell's parameters, rounds and early stopping; the
generator, its seed and a sha256 of the data's bytes; the JAX and jaxlib
versions and the host's CPU; the model text, its tree digest
(``digest(include_scores=False)``) and one digest per tree; the train
metric (and the best iteration and the valid AUC there); and, for
``SAMPLE_ROWS`` seeded training rows, the host walk's f64 raw score and
the JAX package's ``predict(raw_score=True)``, as f64 hex.
"""
from __future__ import annotations

import argparse
import gzip
import hashlib
import json
import os
import platform
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECORD_DIR = os.path.join(REPO, "tests", "data", "torch_fullsize")

HEADLINE_ROWS = 1_000_000
HEADLINE_FEATURES = 28
SMALL_ROWS = 65_536
SMALL_VALID = SMALL_ROWS // 5
SERVE_TRAIN_ROWS = 200_000
SAMPLE_ROWS = 4_096
SAMPLE_SEED = 31
SPLIT_KERNEL_ROWS = 65_536    # the JAX package's fused split kernel's limit

HEADLINE_PARAMS = {"objective": "binary", "num_leaves": 255, "max_bin": 63,
                   "learning_rate": 0.1, "min_data_in_leaf": 20,
                   "verbose": -1}
L2_PARAMS = dict(HEADLINE_PARAMS, objective="regression")
TRAIN_CONF = {"objective": "binary", "metric": "binary_logloss,auc",
              "metric_freq": 1, "is_training_metric": True,
              "num_leaves": 63, "max_bin": 255, "learning_rate": 0.1,
              "feature_fraction": 0.8, "bagging_freq": 5,
              "bagging_fraction": 0.8, "min_data_in_leaf": 50,
              "min_sum_hessian_in_leaf": 5.0, "verbose": -1}
SERVE_PARAMS = {"objective": "binary", "num_leaves": 63, "max_bin": 63,
                "learning_rate": 0.1, "min_data_in_leaf": 20, "verbose": -1}

# cell -> its data, parameters, rounds and early stopping; each is the
# chip_smoke.py phase it checks (4, 31, 5 and 12)
CELLS = {
    "headline": {"data": "headline_latent", "seed": 0, "label": "binary",
                 "params": HEADLINE_PARAMS, "rounds": 32,
                 "early_stopping_rounds": None},
    "headline_l2": {"data": "headline_latent", "seed": 0, "label": "z",
                    "params": L2_PARAMS, "rounds": 8,
                    "early_stopping_rounds": None},
    "small_data": {"data": "small_latent", "seed": 3, "label": "binary",
                   "params": TRAIN_CONF, "rounds": 100,
                   "early_stopping_rounds": 10},
    "serving": {"data": "serve_rows", "seed": 11, "label": "binary",
                "params": SERVE_PARAMS, "rounds": 100,
                "early_stopping_rounds": None},
}


def headline_latent(seed: int = 0):
    """``chip_smoke.headline_latent``: ``(X, z)``, 1M x 28,
    ``z = 2 X0 + X1 - X2 + noise``."""
    rng = np.random.RandomState(seed)
    X = rng.normal(size=(HEADLINE_ROWS, HEADLINE_FEATURES)).astype(
        np.float32)
    z = (X[:, 0] * 2 + X[:, 1] - X[:, 2]
         + rng.normal(scale=1.0, size=HEADLINE_ROWS))
    return X, z


def small_latent(seed: int = 3):
    """``chip_smoke.small_latent``: the training rows, then the valid
    rows."""
    n = SMALL_ROWS + SMALL_VALID
    rng = np.random.RandomState(seed)
    X = rng.normal(size=(n, HEADLINE_FEATURES)).astype(np.float32)
    z = X[:, 0] * 2 + X[:, 1] - X[:, 2] + rng.normal(scale=1.0, size=n)
    return X, z


def serve_rows(seed: int = 11):
    """``chip_smoke.serve_phase``'s training set: 200,000 x 28 and its
    latent."""
    rng = np.random.RandomState(seed)
    X = rng.normal(size=(SERVE_TRAIN_ROWS, HEADLINE_FEATURES)).astype(
        np.float32)
    z = X[:, 0] * 2 + X[:, 1] - X[:, 2] + rng.normal(scale=1.0,
                                                      size=SERVE_TRAIN_ROWS)
    return X, z


GENERATORS = {"headline_latent": headline_latent,
              "small_latent": small_latent, "serve_rows": serve_rows}


def cell_data(cell: str):
    """``(X, y, X_valid, y_valid)`` of a cell (the valid pair None where
    the cell has no valid set); labels float32."""
    spec = CELLS[cell]
    X, z = GENERATORS[spec["data"]](spec["seed"])
    y = ((z > 0) if spec["label"] == "binary" else z).astype(np.float32)
    if spec["data"] == "small_latent":
        return X[:SMALL_ROWS], y[:SMALL_ROWS], X[SMALL_ROWS:], y[SMALL_ROWS:]
    return X, y, None, None


def data_sha256(X, y, Xv=None, yv=None) -> str:
    """sha256 of the C-order bytes of ``X``, ``y`` and, where present, the
    valid pair."""
    h = hashlib.sha256()
    for a in (X, y, Xv, yv):
        if a is not None:
            h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def sample_rows(n: int) -> np.ndarray:
    """The seeded training rows whose raw scores a record keeps."""
    rng = np.random.RandomState(SAMPLE_SEED)
    return np.sort(rng.choice(n, size=SAMPLE_ROWS, replace=False))


def tree_digests(trees, tree_digest=None) -> list:
    """One sha256 per host tree over ``obs/determinism.tree_digest``'s
    canonical fields (the same fields in both packages; the port's
    function unless another is given)."""
    if tree_digest is None:
        from lightgbm_tpu_torch.obs.determinism import tree_digest
    out = []
    for t in trees:
        h = hashlib.sha256()
        tree_digest(h, t)
        out.append(h.hexdigest())
    return out


def to_hex(values) -> list:
    return [float(v).hex() for v in np.asarray(values, np.float64).ravel()]


def host_raw(trees, X) -> np.ndarray:
    """The host walk's raw score: each tree's f64 leaf value added in tree
    order (the sum that a served score rounds once)."""
    X64 = np.asarray(X, np.float64)
    out = np.zeros(len(X64))
    for t in trees:
        out += t.predict_batch(X64)
    return out


def from_hex(values) -> np.ndarray:
    return np.array([float.fromhex(v) for v in values], np.float64)


def record_path(cell: str, out_dir=None) -> str:
    return os.path.join(out_dir or RECORD_DIR, f"{cell}.json.gz")


def load_record(cell: str) -> dict:
    with gzip.open(record_path(cell), "rt") as f:
        return json.load(f)


def reference_env(cell: str) -> dict:
    """The switches that put the JAX package on its kernel path."""
    env = {"LGBM_TPU_HIST_BACKEND": "compact"}
    if cell_rows(cell) <= SPLIT_KERNEL_ROWS:
        env["LGBM_TPU_SPLIT_INTERPRET"] = "1"
    return env


def cell_rows(cell: str) -> int:
    return {"headline_latent": HEADLINE_ROWS, "small_latent": SMALL_ROWS,
            "serve_rows": SERVE_TRAIN_ROWS}[CELLS[cell]["data"]]


def cpu_model() -> str:
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return platform.processor() or platform.machine()


def train_metrics(cell: str, y, pred) -> dict:
    """The train metric of a cell's predictions: AUC of a binary cell,
    the mean squared error of the L2 cell."""
    from lightgbm_tpu_torch.metric.metrics import binary_auc
    if CELLS[cell]["label"] == "binary":
        return {"train_auc": float(binary_auc(y, pred))}
    d = np.asarray(pred, np.float64) - np.asarray(y, np.float64)
    return {"train_l2": float(np.mean(d * d))}


def valid_metrics(bst, Xv, yv) -> dict:
    """The best iteration and the valid AUC of the predictions it
    truncates to (as ``chip_smoke.py`` phase 5 reads them)."""
    from lightgbm_tpu_torch.metric.metrics import binary_auc
    return {"best_iteration": int(bst.best_iteration),
            "valid_auc": float(binary_auc(yv, bst.predict(Xv)))}


def train(lgb, cell: str, rounds=None, **train_kw):
    """``lgb.train`` of a cell through the package ``lgb`` (either one),
    its valid set and early stopping given and no ``evals_result``: the
    JAX package then takes its fused-window loop, whose score update is
    the fused multiply-add that the port's also makes (with
    ``evals_result`` it takes its callback loop, which rounds the product
    first: ROADMAP C3).  -> ``(booster, seconds)``."""
    spec = CELLS[cell]
    X, y, Xv, yv = cell_data(cell)
    params = dict(spec["params"])
    ds = lgb.Dataset(X, label=y, params={"max_bin": params["max_bin"]})
    kw = dict(train_kw)
    if Xv is not None:
        dv = lgb.Dataset(Xv, label=yv, reference=ds)
        kw.update(valid_sets=[dv], valid_names=["valid"])
        if spec["early_stopping_rounds"]:
            kw["early_stopping_rounds"] = spec["early_stopping_rounds"]
    t0 = time.time()
    bst = lgb.train(params, ds, num_boost_round=rounds or spec["rounds"],
                    verbose_eval=False, **kw)
    return bst, time.time() - t0


def iterations(bst) -> int:
    """The iterations a Booster holds (a method in the port, an attribute
    in the JAX package)."""
    it = bst.current_iteration
    return int(it() if callable(it) else it)


def record(cell: str, out_dir=None) -> dict:
    """Train the JAX package on a cell and write its record into
    ``out_dir``."""
    for k, v in reference_env(cell).items():
        os.environ[k] = v
    import jax
    import jaxlib
    import lightgbm_tpu as jlgb
    from lightgbm_tpu.obs.determinism import tree_digest
    spec = CELLS[cell]
    X, y, Xv, yv = cell_data(cell)
    bst, seconds = train(jlgb, cell)
    trees = bst._gbdt.models
    total = iterations(bst)
    rows = sample_rows(len(X))
    raw = bst.predict(X[rows], num_iteration=total, raw_score=True)
    pred = bst.predict(X, num_iteration=total)
    rec = {
        "cell": cell,
        "params": spec["params"], "rounds": spec["rounds"],
        "early_stopping_rounds": spec["early_stopping_rounds"],
        "data": {"generator": spec["data"], "seed": spec["seed"],
                 "label": spec["label"], "rows": int(len(X)),
                 "valid_rows": 0 if Xv is None else int(len(Xv)),
                 "features": int(X.shape[1]),
                 "sha256": data_sha256(X, y, Xv, yv)},
        "reference": {"package": "lightgbm_tpu", "jax": jax.__version__,
                      "jaxlib": jaxlib.__version__,
                      "python": platform.python_version(),
                      "cpu": cpu_model(), "env": reference_env(cell),
                      "seconds": round(seconds, 1)},
        "iterations": int(total),
        "digest_trees": bst.digest(include_scores=False),
        "tree_digests": tree_digests(trees, tree_digest),
        "model": bst.model_to_string(),
        "metrics": train_metrics(cell, y, pred),
        "sample": {"seed": SAMPLE_SEED, "rows": rows.tolist(),
                   "host_raw": to_hex(host_raw(trees, X[rows])),
                   "raw_score": to_hex(raw)},
    }
    if Xv is not None:
        rec["metrics"].update(valid_metrics(bst, Xv, yv))
    os.makedirs(os.path.dirname(record_path(cell, out_dir)), exist_ok=True)
    with gzip.GzipFile(record_path(cell, out_dir), "wb", mtime=0) as f:
        f.write(json.dumps(rec, sort_keys=True).encode())
    return rec


def compare(rec: dict, text: str, trees) -> dict:
    """A model of the port against a record: identical trees, the first
    divergence (``model_flip_report``), the tree digest."""
    from lightgbm_tpu_torch.parallel.envelope import model_flip_report
    got = tree_digests(trees)
    want = rec["tree_digests"][:len(got)]
    same = 0
    while same < len(want) and got[same] == want[same]:
        same += 1
    rep = model_flip_report(rec["model"], text)
    return {"trees": len(got), "identical_trees": same,
            "identical": same == len(got) == len(rec["tree_digests"]),
            "prefix_identical": same == len(got),
            "flip_tree": rep["flip_tree"], "flip_node": rep["flip_node"],
            "flip_kind": rep["flip_kind"],
            "abs_gain_gap": rep["abs_gain_gap"],
            "rel_gain_gap": rep["rel_gain_gap"],
            "near_tie": rep["near_tie"],
            "max_leaf_value_gap": rep["max_leaf_value_gap"]}


def gradient_moves(cell: str, iters: int) -> dict:
    """Where a binary cell parts from its record on the CPU (ROADMAP C8):
    the port trained ``iters`` iterations (the record's trees, when its
    prefix is identical, so its scores are the JAX package's), then the
    gradients of those scores through each package's objective on the
    CPU (the JAX package's jitted, as its tree build runs it): the rows
    whose gradient or hessian differs, and the rows whose int8h quanta
    (each side quantized by its own package) differ."""
    import types
    import jax
    import jax.numpy as jnp
    import lightgbm_tpu_torch as tlgb
    from lightgbm_tpu.config import Config as JConfig
    from lightgbm_tpu.objective.objectives import create_objective
    from lightgbm_tpu.ops.pallas_histogram import pack_values_q as jpack
    from lightgbm_tpu_torch.ops.histogram import pack_values_q as tpack
    X, y, _, _ = cell_data(cell)
    bst, _ = train(tlgb, cell, iters, device="cpu",
                   keep_training_booster=True)
    score = bst._gbdt.scores[:, 0]
    tg, th = bst._gbdt.objective.get_gradients(score)
    jobj = create_objective(JConfig.from_params(dict(CELLS[cell]["params"])))
    jobj.init(types.SimpleNamespace(label=y, weight=None,
                                    query_boundaries=None), len(y))
    jg, jh = jax.jit(jobj.get_gradients)(jnp.asarray(score.numpy()))
    jg, jh = np.asarray(jg), np.asarray(jh)
    n = len(y)
    tq, _ = tpack(tg, th, "int8h", n)
    jq, _ = jax.jit(lambda a, b: jpack(a, b, "int8h", row_tile=1))(
        jnp.asarray(jg), jnp.asarray(jh))
    return {"iteration": iters,
            "gradient_rows": int(np.sum((tg.numpy() != jg)
                                        | (th.numpy() != jh))),
            "quanta_rows": int(np.sum((tq.numpy() != np.asarray(jq)[:, :n])
                                      .any(0)))}


def check_cpu(cell: str, iters=None) -> dict:
    """Train the port on the CPU on a record's cell (its first ``iters``
    iterations, or the record's own) and compare."""
    import lightgbm_tpu_torch as tlgb
    rec = load_record(cell)
    X, y, Xv, yv = cell_data(cell)
    if data_sha256(X, y, Xv, yv) != rec["data"]["sha256"]:
        raise AssertionError(f"{cell}: the generator's data is not the "
                             f"record's")
    rounds = iters or rec["rounds"]
    bst, seconds = train(tlgb, cell, rounds, device="cpu")
    out = {"cell": cell, "iterations": iterations(bst),
           "seconds": round(seconds, 1),
           **compare(rec, bst.model_to_string(), bst._gbdt.models)}
    if (not out["identical"] and out["identical_trees"] < out["trees"]
            and CELLS[cell]["label"] == "binary"):
        out["c8"] = gradient_moves(cell, out["identical_trees"])
    if out["identical"]:
        total = iterations(bst)
        rows = np.asarray(rec["sample"]["rows"])
        out["host_raw_equal"] = bool(np.array_equal(
            host_raw(bst._gbdt.models, X[rows]),
            from_hex(rec["sample"]["host_raw"])))
        out["metrics"] = train_metrics(cell, y, bst.predict(
            X, num_iteration=total))
        if Xv is not None:
            out["metrics"].update(valid_metrics(bst, Xv, yv))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cells", default=",".join(CELLS))
    ap.add_argument("--check", choices=["cpu"], default=None,
                    help="train the port on the CPU and compare")
    ap.add_argument("--iters", type=int, default=None,
                    help="with --check: train only this prefix")
    ap.add_argument("--out", default=RECORD_DIR,
                    help="where to write the records (a rebuild to compare)")
    args = ap.parse_args(argv)
    sys.path.insert(0, REPO)
    bad = 0
    for cell in args.cells.split(","):
        if args.check:
            out = check_cpu(cell, args.iters)
            bad += not out["prefix_identical"] and not out["near_tie"]
        else:
            rec = record(cell, args.out)
            out = {"cell": cell, "iterations": rec["iterations"],
                   "digest_trees": rec["digest_trees"],
                   "seconds": rec["reference"]["seconds"],
                   "metrics": rec["metrics"],
                   "bytes": os.path.getsize(record_path(cell, args.out))}
        print(json.dumps(out), flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
