#!/usr/bin/env python3
"""Full-size records of the JAX package's models, and the port held to them.

``chip_smoke.py`` phase 31 holds the models that the port trains on the
card at full size to models of the JAX package (``lightgbm_tpu``).  The
reference cannot run where the card is (the port's programs import no
JAX) and takes minutes an iteration at these sizes in Pallas interpret
mode, so its models are recorded once, here on the CPU, and committed as
``tests/data/torch_fullsize/<cell>.json.gz``.

Record every cell (minutes to tens of minutes each on a CPU host; a
cell with ``mesh``, ``dp2_l2``, records in a process of its own, since
the JAX package's CPU devices are set before it is imported)::

    JAX_PLATFORMS=cpu python tools/torch_fullsize_ref.py [--cells a,b]

Train the port on the CPU on each record's data and parameters and report
"identical" or the first divergence, where it parts the gradients and
quanta that the two packages' objectives give on the same scores, and
the metric beside the record's (``--iters`` cuts a prefix; ``dp2_l2``
trains a gloo world of two ranks through ``tests/torch_dist_worker.py``,
the stream its store)::

    python tools/torch_fullsize_ref.py --check cpu [--cells a,b] [--iters N]

The JAX package is forced onto its kernel path: ``LGBM_TPU_HIST_BACKEND=
compact`` (off the TPU its default backend is the unquantized scatter,
another model) and, for the cells with at most 65,536 rows, also
``LGBM_TPU_SPLIT_INTERPRET=1`` (its fused split kernel, which the port's
split kernel follows).  The generators restate ``chip_smoke.py``'s.

A record holds the cell's parameters, rounds and early stopping; the
generator, its seed and a sha256 of the data's bytes (the ranking
cell's query sizes too; the stream's store: its bins, then its labels);
the JAX and jaxlib versions, the host's CPU and the switches (a mesh's
``mesh_shape``); the model text, its tree digest
(``digest(include_scores=False)``) and one digest per tree; the train
metric (AUC, L2, ``multi_logloss`` or NDCG@10; and the best iteration
and the valid AUC there); and, for ``SAMPLE_ROWS`` seeded training rows,
the host walk's f64 raw score (every class, row-major) and the JAX
package's ``predict(raw_score=True)``, as f64 hex.  The stream's store
has no raw values: its record keeps those rows' training scores.
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
FLOAT_PARAMS = dict(HEADLINE_PARAMS, gpu_use_dp=True)
MC_CLASSES = 5
MC_PARAMS = {"objective": "multiclass", "num_class": MC_CLASSES,
             "num_leaves": 255, "max_bin": 63, "learning_rate": 0.1,
             "min_data_in_leaf": 20, "verbose": -1}
RANK_QUERIES = 4_750
RANK_FEATURES = 136
RANK_PARAMS = {"objective": "lambdarank", "num_leaves": 255,
               "learning_rate": 0.1, "min_data_in_leaf": 0,
               "min_sum_hessian_in_leaf": 100, "max_bin": 255,
               "metric": "ndcg", "ndcg_eval_at": [10], "verbose": -1}
DP_PARAMS = dict(L2_PARAMS, tree_learner="data", boost_from_average=False)
DP_WORLD = 2
STREAM_PARAMS = {"objective": "binary", "num_leaves": 63, "max_bin": 63,
                 "learning_rate": 0.1, "verbose": -1}
STREAM_ROWS = 4_194_304
STREAM_FEATURES = 28
STREAM_BLOCK = 1 << 20

# cell -> its data, parameters, rounds and early stopping; each is the
# chip_smoke.py phase it checks (4, 31, 5, 12, 6, 17, 19, 28 and 8).
# ``mesh`` trains the JAX package on a mesh of that many CPU devices (the
# port: as many ranks); ``stream`` through ``train_streaming`` on the
# synthetic store in blocks of ``STREAM_BLOCK`` rows
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
    "headline_float": {"data": "headline_latent", "seed": 0,
                       "label": "binary", "params": FLOAT_PARAMS,
                       "rounds": 8, "early_stopping_rounds": None},
    "multiclass": {"data": "headline_latent", "seed": 0, "label": "class5",
                   "params": MC_PARAMS, "rounds": 8,
                   "early_stopping_rounds": None},
    "rank": {"data": "rank_rows", "seed": 7, "label": "relevance",
             "params": RANK_PARAMS, "rounds": 8,
             "early_stopping_rounds": None},
    "dp2_l2": {"data": "headline_latent", "seed": 0, "label": "z",
               "params": DP_PARAMS, "rounds": 8,
               "early_stopping_rounds": None, "mesh": DP_WORLD},
    "stream": {"data": "synthetic_store", "seed": 3, "label": "store",
               "params": STREAM_PARAMS, "rounds": 2,
               "early_stopping_rounds": None, "stream": True},
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


def rank_rows(seed: int = 7):
    """``chip_smoke.rank_data``: the bench's MS LTR-shaped ranking set,
    ``(X, relevance, query sizes)``."""
    rng = np.random.RandomState(seed)
    sizes = np.clip(np.round(rng.lognormal(mean=4.55, sigma=0.7,
                                           size=RANK_QUERIES)),
                    1, 1251).astype(np.int64)
    n = int(sizes.sum())
    X = rng.normal(size=(n, RANK_FEATURES)).astype(np.float32)
    raw = X[:, 0] + 0.6 * X[:, 1] - 0.4 * X[:, 2] \
        + rng.normal(scale=0.8, size=n)
    rel = np.digitize(raw, np.quantile(raw, [0.55, 0.78, 0.92, 0.98])
                      ).astype(np.float32)
    return X, rel, sizes


def class_labels(z, k: int = MC_CLASSES):
    """``chip_smoke.class_labels``: ``k`` classes from the quantiles of
    the latent."""
    q = np.quantile(z, np.arange(1, k) / k)
    return np.digitize(z, q).astype(np.float32)


GENERATORS = {"headline_latent": headline_latent,
              "small_latent": small_latent, "serve_rows": serve_rows,
              "rank_rows": rank_rows}


def cell_data(cell: str):
    """``(X, y, X_valid, y_valid)`` of a cell (the valid pair None where
    the cell has no valid set; the ranking cell's third item is its
    query sizes); labels float32.  The stream's rows are a store:
    :func:`stream_store`."""
    spec = CELLS[cell]
    if spec.get("stream"):
        raise ValueError(f"{cell}: a stream's rows are its store")
    if spec["label"] == "relevance":
        X, rel, sizes = GENERATORS[spec["data"]](spec["seed"])
        return X, rel, sizes, None
    X, z = GENERATORS[spec["data"]](spec["seed"])
    if spec["label"] == "class5":
        y = class_labels(z)
    else:
        y = ((z > 0) if spec["label"] == "binary" else z).astype(np.float32)
    if spec["data"] == "small_latent":
        return X[:SMALL_ROWS], y[:SMALL_ROWS], X[SMALL_ROWS:], y[SMALL_ROWS:]
    return X, y, None, None


def stream_store(oc, Config, cache_dir: str):
    """The stream cell's store through a package's ``ingest_synthetic``
    (``oc``, its ``io.outofcore``; ``Config``, its config class), as
    ``chip_smoke.py`` phase 8 writes it: one shard."""
    spec = CELLS["stream"]
    return oc.ingest_synthetic(cache_dir, STREAM_ROWS, STREAM_FEATURES,
                               Config.from_params(spec["params"]),
                               seed=spec["seed"], shard_rows=STREAM_ROWS)


def store_sha256(store) -> str:
    """sha256 of a store's bins (C order), then its labels."""
    bins, label, _ = store.read_rows(0, store.n)
    return data_sha256(bins, label)


def data_sha256(X, y, Xv=None, yv=None) -> str:
    """sha256 of the C-order bytes of ``X``, ``y`` and, where present, the
    valid pair (or the ranking cell's query sizes, int64)."""
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


def host_raw(trees, X, K: int = 1) -> np.ndarray:
    """The host walk's raw score: each tree's f64 leaf value added in tree
    order (the sum that a served score rounds once) into its class
    (tree ``i`` is class ``i % K``); ``[n]``, or ``[n * K]`` row-major."""
    X64 = np.asarray(X, np.float64)
    out = np.zeros((len(X64), K))
    for i, t in enumerate(trees):
        out[:, i % K] += t.predict_batch(X64)
    return out.ravel()


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
    if cell == "rank":
        return int(rank_rows(CELLS[cell]["seed"])[2].sum())
    return {"headline_latent": HEADLINE_ROWS, "small_latent": SMALL_ROWS,
            "serve_rows": SERVE_TRAIN_ROWS,
            "synthetic_store": STREAM_ROWS}[CELLS[cell]["data"]]


def num_class(cell: str) -> int:
    return int(CELLS[cell]["params"].get("num_class", 1))


def cpu_model() -> str:
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return platform.processor() or platform.machine()


def multi_logloss(y, prob) -> float:
    """The mean of ``-log(p of the row's class)``, each probability held
    to at least 1e-15 (LightGBM's ``multi_logloss``), in f64."""
    p = np.asarray(prob, np.float64)[np.arange(len(y)),
                                     np.asarray(y, np.int64)]
    return float(-np.mean(np.log(np.maximum(p, 1e-15))))


def ndcg10(rel, sizes, scores) -> float:
    """NDCG@10 of raw scores over the queries of ``sizes`` (the port's
    metric, as ``chip_smoke.py`` phase 19 reads it)."""
    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.metric.metrics import NDCGMetric
    qb = np.concatenate([[0], np.cumsum(sizes)])
    (_, v, _), = NDCGMetric(Config.from_params(RANK_PARAMS)).eval(
        rel, np.asarray(scores, np.float64), None, qb)
    return float(v)


def train_metrics(cell: str, y, pred, sizes=None) -> dict:
    """The train metric of a cell's predictions: AUC of a binary cell or
    of the stream's training scores, the mean squared error of an L2
    cell, ``multi_logloss`` of the class probabilities, NDCG@10 of the
    ranking cell's raw scores."""
    from lightgbm_tpu_torch.metric.metrics import binary_auc
    label = CELLS[cell]["label"]
    if label in ("binary", "store"):
        return {"train_auc": float(binary_auc(y, pred))}
    if label == "class5":
        return {"train_multi_logloss": multi_logloss(y, pred)}
    if label == "relevance":
        return {"train_ndcg10": ndcg10(y, sizes, pred)}
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
    first: ROADMAP C3).  A cell with ``mesh`` trains the JAX package on a
    mesh of that many devices (``mesh_shape``; the port's ranks take
    :func:`dp_world`).  -> ``(booster, seconds)``."""
    spec = CELLS[cell]
    X, y, Xv, yv = cell_data(cell)
    params = dict(spec["params"])
    if spec.get("mesh") and lgb.__name__ == "lightgbm_tpu":
        params["mesh_shape"] = str(spec["mesh"])
    kw = dict(train_kw)
    if spec["label"] == "relevance":
        ds = lgb.Dataset(X, label=y, group=Xv,
                         params={"max_bin": params["max_bin"]})
        Xv = None
    else:
        ds = lgb.Dataset(X, label=y, params={"max_bin": params["max_bin"]})
    if Xv is not None:
        dv = lgb.Dataset(Xv, label=yv, reference=ds)
        kw.update(valid_sets=[dv], valid_names=["valid"])
        if spec["early_stopping_rounds"]:
            kw["early_stopping_rounds"] = spec["early_stopping_rounds"]
    t0 = time.time()
    bst = lgb.train(params, ds, num_boost_round=rounds or spec["rounds"],
                    verbose_eval=False, **kw)
    return bst, time.time() - t0


def train_stream(train_streaming, store, rounds=None, **kw):
    """The stream cell through a package's ``train_streaming`` on its
    store, in blocks of ``STREAM_BLOCK`` rows -> ``(GBDT, seconds)``."""
    spec = CELLS["stream"]
    t0 = time.time()
    g = train_streaming(dict(spec["params"]), store,
                        num_boost_round=rounds or spec["rounds"],
                        block_rows=STREAM_BLOCK, **kw)
    return g, time.time() - t0


def iterations(bst) -> int:
    """The iterations a Booster holds (a method in the port, an attribute
    in the JAX package)."""
    it = bst.current_iteration
    return int(it() if callable(it) else it)


def mesh_flags(devices: int) -> None:
    """Give the JAX package ``devices`` CPU devices (before it is
    imported), as ``tests/conftest.py`` does."""
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + f" --xla_force_host_platform_device_count={devices}"
        ).strip()


def record(cell: str, out_dir=None) -> dict:
    """Train the JAX package on a cell and write its record into
    ``out_dir``."""
    import tempfile
    spec = CELLS[cell]
    for k, v in reference_env(cell).items():
        os.environ[k] = v
    if spec.get("mesh"):
        mesh_flags(spec["mesh"])
    import jax
    import jaxlib
    import lightgbm_tpu as jlgb
    from lightgbm_tpu.obs.determinism import tree_digest
    if spec.get("mesh") and len(jax.devices()) < spec["mesh"]:
        raise RuntimeError(f"{cell}: {len(jax.devices())} JAX devices; "
                           f"record this cell in a process of its own")
    K = num_class(cell)
    data = {"generator": spec["data"], "seed": spec["seed"],
            "label": spec["label"]}
    sample = {"seed": SAMPLE_SEED}
    if spec.get("stream"):
        from lightgbm_tpu.boosting.streaming import train_streaming
        from lightgbm_tpu.config import Config as JConfig
        from lightgbm_tpu.io import outofcore as joc
        with tempfile.TemporaryDirectory() as tmp:
            store = stream_store(joc, JConfig, tmp)
            data.update(rows=int(store.n), features=STREAM_FEATURES,
                        valid_rows=0, shard_rows=STREAM_ROWS,
                        block_rows=STREAM_BLOCK,
                        sha256=store_sha256(store))
            y = store.labels_array()
            g, seconds = train_stream(train_streaming, store)
        trees, total = g.models, int(g.iter)
        digest, text = g.digest(include_scores=False), \
            g.save_model_to_string()
        scores = np.asarray(g.scores, np.float32)[:, 0]
        rows = sample_rows(len(y))
        sample.update(rows=rows.tolist(), scores=to_hex(scores[rows]))
        metrics = train_metrics(cell, y, scores)
    else:
        X, y, Xv, yv = cell_data(cell)
        bst, seconds = train(jlgb, cell)
        trees, total = bst._gbdt.models, iterations(bst)
        digest, text = bst.digest(include_scores=False), \
            bst.model_to_string()
        rows = sample_rows(len(X))
        raw = bst.predict(X[rows], num_iteration=total, raw_score=True)
        sample.update(rows=rows.tolist(),
                      host_raw=to_hex(host_raw(trees, X[rows], K)),
                      raw_score=to_hex(raw))
        if spec["label"] == "relevance":
            data.update(queries=int(len(Xv)))
            metrics = train_metrics(cell, y, bst.predict(
                X, num_iteration=total, raw_score=True), sizes=Xv)
            Xv = None
        else:
            metrics = train_metrics(cell, y, bst.predict(
                X, num_iteration=total))
        data.update(rows=int(len(X)),
                    valid_rows=0 if Xv is None else int(len(Xv)),
                    features=int(X.shape[1]),
                    sha256=data_sha256(*cell_data(cell)))
        if Xv is not None:
            metrics.update(valid_metrics(bst, Xv, yv))
    ref_env = dict(reference_env(cell))
    if spec.get("mesh"):
        ref_env["mesh_shape"] = str(spec["mesh"])
    rec = {
        "cell": cell,
        "params": spec["params"], "rounds": spec["rounds"],
        "early_stopping_rounds": spec["early_stopping_rounds"],
        "data": data,
        "reference": {"package": "lightgbm_tpu", "jax": jax.__version__,
                      "jaxlib": jaxlib.__version__,
                      "python": platform.python_version(),
                      "numpy": np.__version__,
                      "devices": len(jax.devices()),
                      "cpu": cpu_model(), "env": ref_env,
                      "seconds": round(seconds, 1)},
        "iterations": int(total),
        "digest_trees": digest,
        "tree_digests": tree_digests(trees, tree_digest),
        "model": text,
        "metrics": metrics,
        "sample": sample,
    }
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


def port_train(cell: str, rounds=None, **kw):
    """The port on the CPU on a cell (its first ``rounds`` iterations):
    -> ``(model text, trees, scores [n, K] tensor, seconds, extra)``,
    ``extra`` what the cell's metric and checks read (``X``, ``y``, the
    query sizes, the store's labels, a Booster).  ``dp2_l2`` trains a
    gloo world of two ranks (``tests/torch_dist_worker.py``) and returns
    rank 0's model, after checking that both ranks' are equal."""
    import tempfile
    import lightgbm_tpu_torch as tlgb
    spec = CELLS[cell]
    if spec.get("stream"):
        from lightgbm_tpu_torch.config import Config
        with tempfile.TemporaryDirectory() as tmp:
            store = stream_store(tlgb.outofcore, Config, tmp)
            sha = store_sha256(store)
            g, seconds = train_stream(tlgb.train_streaming, store, rounds,
                                      device="cpu", **kw)
            labels = store.labels_array()
        return (g.save_model_to_string(), g.models, g.scores, seconds,
                {"y": labels, "sha256": sha})
    X, y, Xv, yv = cell_data(cell)
    extra = {"X": X, "y": y, "Xv": Xv, "yv": yv,
             "sha256": data_sha256(X, y, Xv, yv)}
    if spec.get("mesh"):
        import torch
        from tests.torch_dist_worker import run_world
        with tempfile.TemporaryDirectory() as tmp:
            data = os.path.join(tmp, "xy.npz")
            np.savez(data, X=X, y=y)
            t0 = time.time()
            res = run_world([{"name": cell, "kind": "train", "input": data,
                              "params": dict(spec["params"]),
                              "rounds": rounds or spec["rounds"]}],
                            spec["mesh"], os.path.join(tmp, "out"),
                            timeout=3600.0)
            seconds = time.time() - t0
        infos = [info for _, info in res[cell]]
        if any("error" in i for i in infos):
            raise RuntimeError(next(i["traceback"] for i in infos
                                    if "error" in i))
        if any(i["model"] != infos[0]["model"] for i in infos):
            raise AssertionError(f"{cell}: the ranks' models differ")
        bst = tlgb.Booster(model_str=infos[0]["model"], device="cpu")
        scores = torch.cat([torch.from_numpy(a["scores"])
                            for a, _ in res[cell]])
        return infos[0]["model"], bst._gbdt.models, scores, seconds, dict(
            extra, booster=bst)
    bst, seconds = train(tlgb, cell, rounds, device="cpu", **kw)
    if spec["label"] == "relevance":
        extra.update(sizes=Xv, Xv=None)
    return (bst.model_to_string(), bst._gbdt.models, bst._gbdt.scores,
            seconds, dict(extra, booster=bst))


def gradient_moves(cell: str, iters: int) -> dict:
    """Where a cell parts from its record on the CPU (ROADMAP C8, C19):
    the port trained ``iters`` iterations (the record's trees, when its
    prefix is identical, so its scores are the JAX package's), then the
    gradients of those scores through each package's objective on the
    CPU (the JAX package's jitted, as its tree build runs it): the rows
    whose gradient or hessian differs in any class and, on an int8h
    cell, the rows whose quanta (each side quantized by its own package,
    per class) differ."""
    import types
    import jax
    import jax.numpy as jnp
    from lightgbm_tpu.config import Config as JConfig
    from lightgbm_tpu.objective.objectives import create_objective
    from lightgbm_tpu.ops.pallas_histogram import pack_values_q as jpack
    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.objective.objectives import (
        create_objective as tcreate)
    from lightgbm_tpu_torch.io.dataset import Metadata
    from lightgbm_tpu_torch.ops.histogram import pack_values_q as tpack
    params = dict(CELLS[cell]["params"])
    _, _, score, _, extra = port_train(cell, iters,
                                       **({} if CELLS[cell].get("stream")
                                          else {"keep_training_booster":
                                                True}))
    y = np.asarray(extra["y"], np.float32)
    sizes = extra.get("sizes")
    qb = None if sizes is None else np.concatenate([[0], np.cumsum(sizes)])
    md = Metadata()
    md.set_field("label", y)
    if sizes is not None:
        md.set_field("group", sizes)
    tobj = tcreate(Config.from_params(params))
    tobj.init(md, len(y), "cpu")
    tg, th = tobj.get_gradients_k(score)
    jobj = create_objective(JConfig.from_params(params))
    jobj.init(types.SimpleNamespace(label=y, weight=None,
                                    query_boundaries=qb), len(y))
    K = score.shape[1]
    js = jnp.asarray(score.numpy() if K > 1 else score.numpy()[:, 0])
    jg, jh = jax.jit(jobj.get_gradients)(js)
    jg = np.asarray(jg).reshape(len(y), K)
    jh = np.asarray(jh).reshape(len(y), K)
    n = len(y)
    out = {"iteration": iters,
           "gradient_rows": int(np.sum(((tg.numpy() != jg)
                                        | (th.numpy() != jh)).any(1)))}
    if not params.get("gpu_use_dp"):
        moved = np.zeros(n, bool)
        for k in range(K):
            tq, _ = tpack(tg[:, k].contiguous(), th[:, k].contiguous(),
                          "int8h", n)
            jq, _ = jax.jit(lambda a, b: jpack(a, b, "int8h", row_tile=1))(
                jnp.asarray(jg[:, k]), jnp.asarray(jh[:, k]))
            moved |= (tq.numpy() != np.asarray(jq)[:, :n]).any(0)
        out["quanta_rows"] = int(moved.sum())
    return out


def check_cpu(cell: str, iters=None) -> dict:
    """Train the port on the CPU on a record's cell (its first ``iters``
    iterations, or the record's own) and compare: identical trees, the
    first divergence, and (the record's own iterations) the metric and
    the sample rows' scores."""
    rec = load_record(cell)
    rounds = iters or rec["rounds"]
    text, trees, scores, seconds, extra = port_train(cell, rounds)
    if extra["sha256"] != rec["data"]["sha256"]:
        raise AssertionError(f"{cell}: the generator's data is not the "
                             f"record's")
    out = {"cell": cell, "iterations": len(trees) // num_class(cell),
           "seconds": round(seconds, 1), **compare(rec, text, trees)}
    if not out["identical"] and out["identical_trees"] < out["trees"]:
        out["c8"] = gradient_moves(cell, out["identical_trees"]
                                   // num_class(cell))
    rows = np.asarray(rec["sample"]["rows"])
    if CELLS[cell].get("stream"):
        if out["identical"]:
            got = np.asarray(scores.numpy()[rows, 0], np.float32)
            out["sample_scores_equal"] = int(np.sum(
                got == from_hex(rec["sample"]["scores"]).astype(
                    np.float32)))
        if rounds == rec["rounds"]:
            out["metrics"] = train_metrics(cell, extra["y"],
                                           scores.numpy()[:, 0])
        return out
    X, y, bst = extra["X"], extra["y"], extra["booster"]
    if out["identical"]:
        out["host_raw_equal"] = bool(np.array_equal(
            host_raw(trees, X[rows], num_class(cell)),
            from_hex(rec["sample"]["host_raw"])))
    if len(trees) == len(rec["tree_digests"]):
        total = iterations(bst)
        if CELLS[cell]["label"] == "relevance":
            out["metrics"] = train_metrics(cell, y, bst.predict(
                X, num_iteration=total, raw_score=True),
                sizes=extra["sizes"])
        else:
            out["metrics"] = train_metrics(cell, y, bst.predict(
                X, num_iteration=total))
        if extra["Xv"] is not None:
            out["metrics"].update(valid_metrics(bst, extra["Xv"],
                                                extra["yv"]))
        out["metric_gaps"] = {k: abs(v - rec["metrics"][k])
                              for k, v in out["metrics"].items()}
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
    cells = args.cells.split(",")
    meshes = [CELLS[c]["mesh"] for c in cells if CELLS[c].get("mesh")]
    if meshes and not args.check:
        if len(meshes) < len(cells):
            # the JAX package's CPU devices are fixed when it is imported:
            # a mesh cell records in a process of its own
            import subprocess
            for c in cells:
                if CELLS[c].get("mesh"):
                    subprocess.run([sys.executable, os.path.abspath(__file__),
                                    "--cells", c, "--out", args.out],
                                   check=True)
            cells = [c for c in cells if not CELLS[c].get("mesh")]
        else:
            mesh_flags(max(meshes))
    bad = 0
    for cell in cells:
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
