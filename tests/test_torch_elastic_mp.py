"""The multi-process snapshot barrier of lightgbm_tpu_torch: ``lgb.train``
with ``snapshot_freq`` and ``resume_from`` in a gloo world of two CPU
ranks (``tests/torch_dist_worker.py``, kind ``snapshot``).

* Every rank writes its own rows' scores, the ranks agree on
  ``(iteration, digest)`` and rank 0 commits one manifest of world 2; a
  resume at W = 2 from the middle snapshot ends on the uninterrupted
  model, each rank's scores included (its own state file, bit for bit).
* A resume at another world size refuses: W = 1 from the two-rank
  snapshot (this process), as the JAX package's
  ``test_snapshot_resume_rejects_world_size_mismatch``.
* A rank that reports another digest at the barrier makes every rank
  raise, emits ``elastic:barrier_mismatch`` and commits nothing.
"""
import json

import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as tlgb
from lightgbm_tpu_torch.boosting import snapshot as snap

from tests.torch_dist_worker import run_world

torch.set_num_threads(1)   # tiny tensors: more threads only spin

N = 4000
BASE = {"objective": "binary", "num_leaves": 15, "max_bin": 63,
        "min_data_in_leaf": 20, "learning_rate": 0.1, "verbose": -1,
        "tree_learner": "data"}
FREQ, ROUNDS, RESUME_AT = 2, 6, 4


def _data(n=N, seed=3):
    rng = np.random.RandomState(seed)
    X = rng.normal(size=(n, 6))
    y = ((X[:, 0] + 0.7 * X[:, 1] + 0.5 * rng.normal(size=n)) > 0
         ).astype(np.float32)
    return X, y


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    d = tmp_path_factory.mktemp("elastic_mp")
    X, y = _data()
    np.savez(d / "input.npz", X=X, y=y)
    prefix = str(d / "snap" / "m.txt")
    (d / "snap").mkdir()
    cases = [dict(name="snapshot", kind="snapshot",
                  input=str(d / "input.npz"), params=BASE, prefix=prefix,
                  freq=FREQ, rounds=ROUNDS, resume_at=RESUME_AT)]
    res = run_world(cases, 2, str(d / "out"), timeout=240.0)
    return res["snapshot"], prefix, X, y


def _ok(per_rank):
    for arrays, info in per_rank:
        assert "error" not in info, info.get("traceback")


def test_resume_at_world_two_equals_uninterrupted(world):
    per_rank, prefix, _, _ = world
    _ok(per_rank)
    for _, info in per_rank:
        assert info["resumed_model"] == info["model"]
        assert info["resumed_digest"] == info["digest"]
        # each rank's scores came back from its own state file
        assert info["resumed_digest_scores"] == info["digest_scores"]
    assert per_rank[0][1]["digest"] == per_rank[1][1]["digest"]
    assert per_rank[0][1]["digest_scores"] != per_rank[1][1]["digest_scores"]
    man = snap.resolve_snapshot(snap.snapshot_paths(prefix, RESUME_AT)[2])
    assert man["world_size"] == 2 and man["state_file"] == ""
    assert sorted(man["rank_state_paths"]) == [0, 1]
    with open(snap.snapshot_paths(prefix, ROUNDS)[2]) as f:
        assert json.load(f)["iteration"] == ROUNDS


def test_resume_at_another_world_refuses(world):
    per_rank, prefix, X, y = world
    _ok(per_rank)
    manifest = snap.snapshot_paths(prefix, RESUME_AT)[2]
    params = dict(BASE, tree_learner="serial", output_model=prefix)
    with pytest.raises(ValueError, match="2-process mesh"):
        tlgb.train(params, tlgb.Dataset(X, label=y), num_boost_round=ROUNDS,
                   resume_from=manifest, device="cpu")


def test_barrier_digest_mismatch_raises_on_every_rank(world):
    per_rank, _, _, _ = world
    _ok(per_rank)
    for _, info in per_rank:
        assert "ranks disagree" in (info["mismatch_error"] or "")
        assert info["mismatch_events"] == 1
        assert info["bad_manifests"] == 0


def test_snapshot_resume_rejects_world_size_mismatch(tmp_path):
    """One process: a manifest of another world size refuses (the JAX
    package's ``tests/test_elastic.py`` case, on the port)."""
    X, y = _data(n=800)
    prefix = tmp_path / "w.txt"
    params = dict(BASE, tree_learner="serial", snapshot_freq=2,
                  output_model=str(prefix))
    tlgb.train(params, tlgb.Dataset(X, label=y), num_boost_round=4,
               device="cpu")
    _, manifest_path = snap.list_snapshots(str(prefix))[0]
    with open(manifest_path) as f:
        manifest = json.load(f)
    assert manifest["world_size"] == 1
    manifest["world_size"] = 3
    with open(manifest_path, "w") as f:
        json.dump(manifest, f)
    with pytest.raises(ValueError, match="3-process mesh"):
        tlgb.train(params, tlgb.Dataset(X, label=y), num_boost_round=6,
                   resume_from=manifest_path, device="cpu")
