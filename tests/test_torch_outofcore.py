"""The shard store of out-of-core training, in both packages.

Both packages read and write the same on-disk store (manifest, per-shard
JSON sidecars, ``.bins``/``.label``/``.weight`` blobs).  The port's
ingest of CSV and libsvm files (libsvm through the native parser) and
its synthetic store are bitwise the JAX package's (mapper digest, shard
sha256s, manifest key, rows; for libsvm every file byte); the port
opens a store the JAX package wrote and streams it to the JAX package's
streamed model; an ingest whose manifest was deleted reuses the
finished shards; ``train_streaming`` over a CSV list trains end to end
on the CPU, and over a libsvm file (its store placed by
``LGBM_TPU_STREAM_CACHE``) to the JAX package's streamed model and the
port's in-memory model of the file; the ingest's spans and counters.  The JAX side streams with its wide kernel fold in
Pallas interpret mode (``LGBM_TPU_HIST_BACKEND=pallas``,
``LGBM_TPU_SPLIT_INTERPRET=1``).
"""
import json
import os

import numpy as np
import pytest
import torch

from tools.numcheck.tolerance_registry import tol

from lightgbm_tpu.boosting.streaming import StreamTrainer as JStream
from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.io import outofcore as j_oc

import lightgbm_tpu_torch as tlgb
from lightgbm_tpu_torch.boosting.streaming import StreamTrainer
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.io import outofcore as t_oc
from lightgbm_tpu_torch.learner.serial import STREAM_CHUNK

torch.set_num_threads(1)   # tiny tensors: more threads only spin

N, F = 12000, 6
PARAMS = {"objective": "binary", "num_leaves": 15, "max_bin": 63,
          "learning_rate": 0.1, "verbose": -1}
ITERS = 3


def _csvs(tmp_path, n=N, cut=5000, seed=7, weights=False):
    """Two CSV files (label first, then optional weight, then features)."""
    rng = np.random.RandomState(seed)
    X = rng.normal(size=(n, F))
    y = (X[:, 0] + 0.5 * X[:, 1] + rng.normal(scale=0.3, size=n) > 0
         ).astype(np.float32)
    cols = [y[:, None]]
    if weights:
        cols.append(rng.uniform(0.5, 2.0, size=(n, 1)))
    rows = np.concatenate(cols + [X], axis=1)
    paths = []
    for i, (a, b) in enumerate([(0, cut), (cut, n)]):
        p = os.path.join(str(tmp_path), f"part{i}.csv")
        np.savetxt(p, rows[a:b], delimiter=",", fmt="%.9g")
        paths.append(p)
    return paths


def _jax_digest(monkeypatch, store, params):
    monkeypatch.setenv("LGBM_TPU_HIST_BACKEND", "pallas")
    monkeypatch.setenv("LGBM_TPU_SPLIT_INTERPRET", "1")
    return JStream(JConfig.from_params(params), store,
                   block_rows=STREAM_CHUNK).train(ITERS).digest()


def _stream_digest(store, params):
    return StreamTrainer(Config.from_params(params), store,
                         block_rows=STREAM_CHUNK,
                         device="cpu").train(ITERS).digest()


def _same_store(a, b):
    for k in ("key", "mapper_digest", "used_features", "feature_names",
              "dtype", "total_rows"):
        assert a.manifest[k] == b.manifest[k], k
    for k in ("sha256", "rows", "has_weight", "name"):
        assert ([s[k] for s in a.manifest["shards"]]
                == [s[k] for s in b.manifest["shards"]]), k


@pytest.mark.parametrize("weights", [False, True], ids=["plain", "weight"])
def test_ingest_matches_reference(tmp_path, weights):
    paths = _csvs(tmp_path, weights=weights)
    params = dict(PARAMS, weight_column="1" if weights else "")
    ref = j_oc.ingest(paths, JConfig.from_params(params),
                      str(tmp_path / "jax"))
    got = t_oc.ingest(paths, Config.from_params(params),
                      str(tmp_path / "port"))
    _same_store(got, ref)
    assert got.manifest["mapper_digest"] == t_oc.mapper_digest(got.mappers)
    for k in range(2):
        for suffix in (".bins", ".label") + ((".weight",) if weights
                                             else ()):
            name = f"shard-{k:04d}{suffix}"
            with open(tmp_path / "jax" / name, "rb") as a, \
                    open(tmp_path / "port" / name, "rb") as b:
                assert a.read() == b.read(), name


def test_port_streams_a_store_the_reference_wrote(tmp_path, monkeypatch):
    """The on-disk hand-over: the JAX package ingests, the port opens
    the store with ``load_store`` and streams it to the JAX package's
    streamed model, and to the model of the same rows held resident."""
    paths = _csvs(tmp_path)
    cdir = str(tmp_path / "store")
    jstore = j_oc.ingest(paths, JConfig.from_params(PARAMS), cdir)
    cfg = Config.from_params(PARAMS)
    store = t_oc.load_store(cdir, paths, cfg)
    assert store is not None and store.n == N
    d = _stream_digest(store, PARAMS)
    assert d == _stream_digest(store.to_binned_dataset(cfg), PARAMS)
    assert d == _jax_digest(monkeypatch, jstore, PARAMS)
    # a changed binning knob makes the store stale: refused, not trained
    assert t_oc.load_store(cdir, paths, Config.from_params(
        dict(PARAMS, max_bin=31))) is None


def test_ingest_synthetic_matches_reference(tmp_path):
    cfg_j, cfg_t = JConfig.from_params(PARAMS), Config.from_params(PARAMS)
    rows, shard = 3 * 4096 + 17, 4096
    ref = j_oc.ingest_synthetic(str(tmp_path / "jax"), rows, F, cfg_j,
                                seed=3, shard_rows=shard)
    got = t_oc.ingest_synthetic(str(tmp_path / "port"), rows, F, cfg_t,
                                seed=3, shard_rows=shard)
    _same_store(got, ref)
    for a, b in zip(got.read_rows(0, rows), ref.read_rows(0, rows)[:2]):
        np.testing.assert_array_equal(a, b)
    assert got.read_rows(0, rows)[2] is None


def test_ingest_resumes_after_manifest_loss(tmp_path):
    """An ingest cut before its manifest was written: the next ingest
    reuses every finished shard (blobs untouched) and writes the same
    manifest."""
    paths = _csvs(tmp_path)
    cfg = Config.from_params(PARAMS)
    cdir = tmp_path / "store"
    first = t_oc.ingest(paths, cfg, str(cdir))
    blobs = sorted(p for p in os.listdir(cdir) if p.endswith(".bins"))
    stamps = {p: os.stat(cdir / p).st_mtime_ns for p in blobs}
    with open(cdir / t_oc.MANIFEST) as f:
        manifest = json.load(f)
    os.remove(cdir / t_oc.MANIFEST)
    assert t_oc.load_store(str(cdir), paths, cfg) is None
    again = t_oc.ingest(paths, cfg, str(cdir))
    assert {p: os.stat(cdir / p).st_mtime_ns for p in blobs} == stamps
    assert again.manifest == manifest == first.manifest


def test_train_streaming_csv_end_to_end(tmp_path):
    paths = _csvs(tmp_path, n=9000, cut=4000, seed=13)
    cdir = str(tmp_path / "cache")
    bst = tlgb.train_streaming(PARAMS, paths, num_boost_round=ITERS,
                               cache_dir=cdir, block_rows=STREAM_CHUNK,
                               device="cpu")
    assert len(bst.models) == ITERS
    assert os.path.exists(os.path.join(cdir, t_oc.MANIFEST))
    store = t_oc.load_store(cdir, paths, Config.from_params(PARAMS))
    assert bst.digest() == _stream_digest(store, PARAMS)
    # the booster predicts through the store's mappers: its raw scores
    # on the training rows are the streamed score state
    X = np.concatenate([np.loadtxt(p, delimiter=",")[:, 1:] for p in paths])
    raw = bst.predict(X, raw_score=True)
    np.testing.assert_allclose(raw, bst.scores.numpy()[:, 0], rtol=0,
                               atol=tol("f32_tight"))


def _libsvm(tmp_path, n=N, cut=5000, seed=7, zero=0.25):
    """Two libsvm files (label, then ``index:value`` pairs) with a
    ``zero`` share of the values zero and left out."""
    rng = np.random.RandomState(seed)
    X = rng.normal(size=(n, F))
    X[rng.uniform(size=X.shape) < zero] = 0.0
    y = (X[:, 0] + 0.5 * X[:, 1] + rng.normal(scale=0.3, size=n) > 0
         ).astype(int)
    paths = []
    for i, (a, b) in enumerate([(0, cut), (cut, n)]):
        p = os.path.join(str(tmp_path), f"part{i}.svm")
        with open(p, "w") as f:
            # a Python float's repr reads back exactly
            for yi, row in zip(y[a:b].tolist(), X[a:b].tolist()):
                f.write(f"{yi} " + " ".join(
                    f"{j}:{v!r}" for j, v in enumerate(row) if v != 0.0)
                    + "\n")
        paths.append(p)
    return paths


def test_libsvm_source_raises(tmp_path):
    """(The name is kept from when a libsvm source raised.)  A libsvm
    file list ingests through the native parser into the JAX package's
    store, bitwise: the manifest, every sidecar and every blob."""
    from lightgbm_tpu_torch import native
    if not native.available():
        pytest.skip("the native parser does not build here")
    paths = _libsvm(tmp_path)
    ref = j_oc.ingest(paths, JConfig.from_params(PARAMS),
                      str(tmp_path / "jax"))
    got = t_oc.ingest(paths, Config.from_params(PARAMS),
                      str(tmp_path / "port"))
    _same_store(got, ref)
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port"))
    assert {"manifest.json", "shard-0001.json", "shard-0001.bins",
            "shard-0001.label"} <= set(names)
    for name in names:
        with open(tmp_path / "jax" / name, "rb") as a, \
                open(tmp_path / "port" / name, "rb") as b:
            assert a.read() == b.read(), name


def test_libsvm_stream_matches_reference(tmp_path, monkeypatch):
    """``train_streaming`` over a libsvm file, its store placed by
    ``LGBM_TPU_STREAM_CACHE``: the JAX package's streamed model of the
    same store and the port's in-memory ``lgb.train(Dataset(path))``."""
    from lightgbm_tpu_torch import native
    if not native.available():
        pytest.skip("the native parser does not build here")
    path = _libsvm(tmp_path, cut=N)[0]
    cdir = str(tmp_path / "cache")
    monkeypatch.setenv("LGBM_TPU_STREAM_CACHE", cdir)
    assert t_oc.default_cache_dir([path]) == cdir
    bst = tlgb.train_streaming(PARAMS, [path], num_boost_round=ITERS,
                               block_rows=STREAM_CHUNK, device="cpu")
    store = t_oc.load_store(cdir, [path], Config.from_params(PARAMS))
    assert store is not None and store.n == N
    jstore = j_oc.load_store(cdir, [path], JConfig.from_params(PARAMS))
    assert bst.digest() == _jax_digest(monkeypatch, jstore, PARAMS)
    mem = tlgb.train(dict(PARAMS), tlgb.Dataset(path),
                     num_boost_round=ITERS, device="cpu")
    assert mem.digest() == bst.digest()
    monkeypatch.delenv("LGBM_TPU_STREAM_CACHE")
    assert t_oc.default_cache_dir([path]) == os.path.join(
        str(tmp_path), ".lgbm_shards")


def test_ingest_telemetry(tmp_path):
    from lightgbm_tpu_torch import obs
    paths = _csvs(tmp_path)
    obs.reset()
    obs.enable()
    try:
        t_oc.ingest(paths, Config.from_params(PARAMS), str(tmp_path / "c"))
        s = obs.summary()
    finally:
        obs.reset()
    assert s["spans"]["ingest.find_bins"]["count"] == 1
    assert s["spans"]["ingest.shard"]["count"] == 2
    assert s["counters"]["ingest.shards"] == 2
    assert s["counters"]["ingest.rows"] == N
