"""Snapshots and exact resume of lightgbm_tpu_torch, at toy size on the
CPU: the JAX package's fault-tolerance scenarios
(``tests/test_fault_tolerance.py``) through the port's ``lgb.train``, and
snapshots that cross between the two packages.

A real failure is driven through the ``snapshot.write`` fault point
(``utils/faults.py``), which tears the model file of a snapshot
mid-write.  Across the packages the model is L2 regression, which the
two build bitwise (scores included) with the JAX package on its kernel
path in interpret mode (``LGBM_TPU_HIST_BACKEND=compact``,
``LGBM_TPU_SPLIT_INTERPRET=1``).
"""
import json
import os

import numpy as np
import pytest
import torch

from tools.numcheck.tolerance_registry import tol

import lightgbm_tpu as jlgb
from lightgbm_tpu.boosting import snapshot as jsnap

import lightgbm_tpu_torch as tlgb
from lightgbm_tpu_torch.boosting import snapshot as snap
from lightgbm_tpu_torch.utils import faults

torch.set_num_threads(1)   # tiny tensors: more threads only spin


@pytest.fixture(autouse=True)
def _clean_faults():
    faults.clear()
    yield
    faults.clear()


def _binary_data(n=600, f=6, seed=11, noise=0.5):
    rng = np.random.RandomState(seed)
    X = rng.normal(size=(n, f)).astype(np.float32)
    y = (X[:, 0] * 2 + X[:, 1] - 0.5 * X[:, 2]
         + rng.normal(scale=noise, size=n) > 0).astype(np.float32)
    return X, y


def _params(prefix, **kw):
    p = {"objective": "binary", "num_leaves": 7, "min_data_in_leaf": 5,
         "learning_rate": 0.1, "verbose": -1, "snapshot_freq": 4,
         "output_model": str(prefix)}
    p.update(kw)
    return p


def _train(X, y, prefix, rounds=12, **kw):
    resume_from = kw.pop("resume_from", None)
    return tlgb.train(_params(prefix, **kw), tlgb.Dataset(X, label=y),
                      num_boost_round=rounds, verbose_eval=False,
                      resume_from=resume_from, device="cpu")


def test_snapshot_bundle_written_and_validates(tmp_path):
    """Each snapshot is model text, an f32 state sidecar and a manifest
    with checksums; no ``.tmp`` residue survives a clean run."""
    X, y = _binary_data()
    prefix = tmp_path / "m.txt"
    _train(X, y, prefix, rounds=8, snapshot_keep=8)
    snaps = snap.list_snapshots(str(prefix))
    assert [it for it, _ in snaps] == [8, 4]
    for it, manifest_path in snaps:
        m = snap.validate_snapshot(manifest_path)
        assert m is not None
        assert m["iteration"] == it
        assert m["num_trees"] == it
        assert m["world_size"] == 1
        st = np.load(m["state_path"])
        assert st["scores"].shape == (len(y), 1)
        assert st["scores"].dtype == np.float32
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp")]


# bagging and feature fraction: the resumed run must rebuild the bagging
# mask of its epoch and key the feature masks on the global tree index
@pytest.mark.parametrize("extra", [
    {}, {"bagging_freq": 3, "bagging_fraction": 0.7,
         "feature_fraction": 0.8}], ids=["plain", "bagged"])
def test_resume_bit_identical_after_kill(tmp_path, extra):
    """A run killed while writing its iteration-8 snapshot resumes from
    the intact iteration-4 one and writes the uninterrupted run's model
    text, scores included in the digest."""
    X, y = _binary_data()
    a = _train(X, y, tmp_path / "A.txt", **extra)

    prefix_b = tmp_path / "B.txt"
    faults.inject("snapshot.write", times=1, skip=1)
    with pytest.raises(faults.FaultInjected):
        _train(X, y, prefix_b, **extra)
    assert faults.fired("snapshot.write") == 1
    faults.clear()
    m = snap.latest_valid_snapshot(str(prefix_b))
    assert m is not None and m["iteration"] == 4

    b = _train(X, y, prefix_b, resume_from=str(prefix_b), **extra)
    assert b.current_iteration() == 12
    assert b.model_to_string() == a.model_to_string()
    assert b.digest() == a.digest()


def test_corrupted_latest_falls_back_to_previous(tmp_path):
    X, y = _binary_data()
    prefix = tmp_path / "m.txt"
    _train(X, y, prefix, rounds=12, snapshot_keep=8)
    snaps = snap.list_snapshots(str(prefix))
    assert [it for it, _ in snaps] == [12, 8, 4]
    newest = snap.validate_snapshot(snaps[0][1])["model_path"]
    with open(newest) as f:
        text = f.read()
    with open(newest, "w") as f:
        f.write(text[:len(text) // 2])
    assert snap.latest_valid_snapshot(str(prefix))["iteration"] == 8
    with open(snaps[1][1], "w") as f:
        f.write("{ torn json")
    assert snap.latest_valid_snapshot(str(prefix))["iteration"] == 4
    bst = _train(X, y, prefix, resume_from=str(prefix))
    assert bst.current_iteration() == 12


def test_retention_prunes_to_snapshot_keep(tmp_path):
    X, y = _binary_data()
    prefix = tmp_path / "m.txt"
    _train(X, y, prefix, rounds=12, snapshot_freq=2, snapshot_keep=2)
    assert [it for it, _ in snap.list_snapshots(str(prefix))] == [12, 10]
    names = os.listdir(tmp_path)
    for it in (2, 4, 6, 8):
        assert not [n for n in names if f"snapshot_iter_{it}." in n], names


def test_early_stopping_state_survives_resume(tmp_path):
    """Killed with early stopping armed: the manifest carries the
    bookkeeping, and the resumed run stops with the uninterrupted run's
    ``best_iteration``, ``best_score`` and model text."""
    X, y = _binary_data(n=500, seed=3, noise=1.0)
    Xv, yv = _binary_data(n=300, seed=4, noise=1.0)

    def run(prefix, resume_from=None):
        params = _params(prefix, metric="auc", snapshot_freq=4)
        train = tlgb.Dataset(X, label=y, params=params)
        valid = train.create_valid(Xv, label=yv)
        return tlgb.train(params, train, num_boost_round=40,
                          valid_sets=[valid], early_stopping_rounds=5,
                          verbose_eval=False, resume_from=resume_from,
                          device="cpu")

    a = run(tmp_path / "A.txt")
    assert 8 < a.current_iteration() < 40     # stopped after the kill

    prefix_b = tmp_path / "B.txt"
    faults.inject("snapshot.write", times=1, skip=1)   # dies at 8
    with pytest.raises(faults.FaultInjected):
        run(prefix_b)
    faults.clear()
    m = snap.latest_valid_snapshot(str(prefix_b))
    assert m["iteration"] == 4
    assert m["key_order"] == ["valid_0:auc"]
    assert 1 <= m["best_iter"]["valid_0:auc"] <= 4

    b = run(prefix_b, resume_from=str(prefix_b))
    assert b.best_iteration == a.best_iteration
    assert b.current_iteration() == a.current_iteration()
    assert b.best_score == a.best_score
    assert b.model_to_string() == a.model_to_string()


def test_resume_auto(tmp_path):
    """``"auto"`` and ``"latest"`` resolve the ``output_model`` prefix;
    the ``resume_from`` parameter works as the argument does."""
    X, y = _binary_data()
    prefix = tmp_path / "m.txt"
    _train(X, y, prefix, rounds=8)
    assert _train(X, y, prefix, resume_from="auto").current_iteration() == 12
    bst = tlgb.train(_params(prefix, resume_from="latest"),
                     tlgb.Dataset(X, label=y), num_boost_round=16,
                     verbose_eval=False, device="cpu")
    assert bst.current_iteration() == 16


def test_resume_without_snapshot_raises(tmp_path):
    X, y = _binary_data()
    with pytest.raises(FileNotFoundError):
        _train(X, y, tmp_path / "none.txt",
               resume_from=str(tmp_path / "none.txt"))


def test_resume_without_state_sidecar_replays_trees(tmp_path):
    """Without the ``.npz`` sidecar the restored trees are replayed into
    the scores on the device; the replay is the scores of the trees
    within a few f32 ulps, and the run trains to the full count."""
    X, y = _binary_data()
    prefix = tmp_path / "m.txt"
    a = _train(X, y, prefix, rounds=8)
    m = snap.latest_valid_snapshot(str(prefix))
    os.unlink(m["state_path"])
    manifest = json.load(open(snap.list_snapshots(str(prefix))[0][1]))
    assert manifest["iteration"] == 8
    g = tlgb.Booster(_params(prefix), tlgb.Dataset(X, label=y),
                     device="cpu")._gbdt
    assert g.resume_from_snapshot(str(prefix)) == 8
    # f32 sums of the same shrunk leaf values, each rounded to f32 once
    # more from the model text's float64
    np.testing.assert_allclose(g.scores.numpy(), a._gbdt.scores.numpy(),
                               rtol=0, atol=tol("f32_tight"))
    bst = _train(X, y, prefix, resume_from=str(prefix))
    assert bst.current_iteration() == 12
    assert bst.num_trees() == 12
    assert np.isfinite(bst.predict(X, raw_score=True)).all()


# -- across the packages ----------------------------------------------------
def _l2_data(n=3000, f=6, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.normal(size=(n, f)).astype(np.float32)
    y = (X[:, 0] * 2 + X[:, 1] - X[:, 2]).astype(np.float32)
    return X, y


def _l2_params(prefix, **kw):
    p = {"objective": "regression", "num_leaves": 15, "max_bin": 63,
         "learning_rate": 0.1, "min_data_in_leaf": 20, "verbose": -1,
         "output_model": str(prefix)}
    p.update(kw)
    return p


@pytest.fixture
def ref_kernels(monkeypatch):
    monkeypatch.setenv("LGBM_TPU_HIST_BACKEND", "compact")
    monkeypatch.setenv("LGBM_TPU_SPLIT_INTERPRET", "1")


def test_jax_snapshot_resumes_in_port(tmp_path, ref_kernels):
    """The JAX package writes a snapshot at iteration 4; the port resumes
    it to 12 and writes the JAX package's uninterrupted model text."""
    X, y = _l2_data()
    full = jlgb.train(_l2_params(tmp_path / "full.txt"),
                      jlgb.Dataset(X, label=y), num_boost_round=12,
                      verbose_eval=False)
    prefix = tmp_path / "jax.txt"
    jlgb.train(_l2_params(prefix, snapshot_freq=4),
               jlgb.Dataset(X, label=y), num_boost_round=4,
               verbose_eval=False)
    assert snap.latest_valid_snapshot(str(prefix))["iteration"] == 4
    bst = tlgb.train(_l2_params(prefix), tlgb.Dataset(X, label=y),
                     num_boost_round=12, verbose_eval=False,
                     resume_from=str(prefix), device="cpu")
    assert bst.current_iteration() == 12
    assert bst.model_to_string() == full.model_to_string()
    assert bst.digest() == full.digest()


def test_port_snapshot_resumes_in_jax(tmp_path, ref_kernels):
    """A port snapshot validates under the JAX package's
    ``validate_snapshot``, and the JAX package resumes it to its own
    uninterrupted model text."""
    X, y = _l2_data()
    full = jlgb.train(_l2_params(tmp_path / "full.txt"),
                      jlgb.Dataset(X, label=y), num_boost_round=12,
                      verbose_eval=False)
    prefix = tmp_path / "port.txt"
    tlgb.train(_l2_params(prefix, snapshot_freq=4), tlgb.Dataset(X, label=y),
               num_boost_round=4, verbose_eval=False, device="cpu")
    (_, manifest_path), = snap.list_snapshots(str(prefix))
    m = jsnap.validate_snapshot(manifest_path)
    assert m is not None and m["iteration"] == 4 and m["state_path"]
    bst = jlgb.train(_l2_params(prefix), jlgb.Dataset(X, label=y),
                     num_boost_round=12, verbose_eval=False,
                     resume_from=str(prefix))
    assert bst.current_iteration == 12
    assert bst.model_to_string() == full.model_to_string()


def test_jax_early_stopping_manifest_restores(tmp_path, ref_kernels):
    """A JAX-written manifest's early-stopping state (keys, 1-based best
    iterations) restores into the port, which then stops with the JAX
    package's uninterrupted ``best_iteration`` and model text."""
    X, y = _l2_data()
    Xv, yv = _l2_data(n=800, seed=1)
    yv = yv + np.random.RandomState(2).normal(size=len(yv)).astype(
        np.float32)

    def datasets(lgb):
        train = lgb.Dataset(X, label=y)
        return train, lgb.Dataset(Xv, label=yv, reference=train)

    kw = dict(num_boost_round=60, valid_names=["valid"],
              early_stopping_rounds=3, verbose_eval=False)
    tr, va = datasets(jlgb)
    full = jlgb.train(_l2_params(tmp_path / "full.txt", learning_rate=0.5),
                      tr, valid_sets=[va], **kw)
    assert 8 < full.current_iteration < 60
    prefix = tmp_path / "jax.txt"
    tr, va = datasets(jlgb)
    jlgb.train(_l2_params(prefix, learning_rate=0.5, snapshot_freq=4,
                          snapshot_keep=1),
               tr, valid_sets=[va], **dict(kw, num_boost_round=4))
    m = snap.latest_valid_snapshot(str(prefix))
    assert m["key_order"] == ["valid:l2"]
    tr, va = datasets(tlgb)
    bst = tlgb.train(_l2_params(prefix, learning_rate=0.5), tr,
                     valid_sets=[va], resume_from=str(prefix),
                     device="cpu", **kw)
    assert bst._gbdt._es_state["key_order"] == ["valid:l2"]
    assert bst.best_iteration == full.best_iteration
    assert bst.current_iteration() == full.current_iteration
    assert bst.model_to_string() == full.model_to_string()


def test_config_snapshot_params():
    """The snapshot knobs and their aliases parse as in the JAX
    package."""
    from lightgbm_tpu_torch.config import Config
    cfg = Config.from_params({"snapshot_keep_cnt": "3", "resume": "x",
                              "snapshot_freq": 5})
    assert cfg.snapshot_keep == 3
    assert cfg.resume_from == "x"
    assert cfg.snapshot_freq == 5
