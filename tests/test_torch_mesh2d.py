"""A 2-D ``mesh_shape`` (data x feature) in lightgbm_tpu_torch: a gloo
world of four CPU ranks (``tests/torch_dist_worker.py``) with
``mesh_shape`` [2, 2] against the JAX package's [2, 2] and [2] meshes.

Rank ``r`` holds data index ``r // 2`` (``parallel/mesh.py:mesh_data_rank``,
the JAX package's row-major device grid); the two ranks of a data index
hold the same rows, and the learner runs over the two ranks of one
feature index (``MeshContext.group``), so each data shard counts once.
The JAX package's learners never read the feature axis: its [2, 2]
model is its [2] model.  For the data-, feature- and voting-parallel
learners, and for a data-parallel L1 run (leaf renewal over the
sub-group), the four ranks' models are byte-identical and their digest
is the JAX package's [2, 2] and [2] digests.  A file loaded with
``num_machines=4`` gives each rank its data index's rows: the two ranks
of a data index hold the JAX package's loader's rows of a 2-rank load.
Ranks of one data index that hold different rows raise before the
first tree.  (A [2, 2] mesh in a world of one rank raises, naming the
four ranks it needs:
``tests/test_torch_distributed_io.py::test_mesh_shape_rules``.)
"""
import json
import threading

import numpy as np
import pytest
import torch

import lightgbm_tpu as jlgb
from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.io import distributed as j_dist
from lightgbm_tpu.io import loader as j_loader

from tests.torch_dist_worker import run_world

torch.set_num_threads(1)   # tiny tensors: more threads only spin

N = 4000
ROUNDS = 5
BASE = {"objective": "binary", "num_leaves": 15, "max_bin": 63,
        "min_data_in_leaf": 20, "learning_rate": 0.1, "verbose": -1,
        "boost_from_average": False}
CASES = {"data": dict(BASE, tree_learner="data"),
         "feature": dict(BASE, tree_learner="feature"),
         "voting": dict(BASE, tree_learner="voting", top_k=3),
         "data_l1": dict(BASE, tree_learner="data",
                         objective="regression_l1")}


def _data(n=N, seed=11):
    rng = np.random.RandomState(seed)
    X = rng.normal(size=(n, 8))
    y = ((X[:, 0] + 0.8 * X[:, 3] - 0.5 * X[:, 5]
          + 0.5 * rng.normal(size=n)) > 0).astype(np.float32)
    return X, y


LOAD_PARAMS = dict(BASE, tree_learner="data", num_machines=4,
                   mesh_shape="2,2", bin_construct_sample_cnt=800)


def _write_csv(path, X, y):
    with open(path, "w") as f:
        for xi, yi in zip(X, y):
            f.write(",".join([repr(float(yi))] + [repr(float(v))
                                                  for v in xi]) + "\n")


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh2d")
    X, y = _data()
    path = str(d / "xy.npz")
    np.savez(path, X=X, y=y)
    csv = str(d / "train.csv")
    _write_csv(csv, *_data(3000, seed=9))
    load = dict(name="load", kind="load", path=csv,
                params=dict(LOAD_PARAMS), rounds=3)
    # every rank its own rows: the two ranks of a data index disagree
    stray = dict(name="stray", kind="train", input=path,
                 params=dict(CASES["data"], mesh_shape="2,2"), rounds=2,
                 rows_by_global_rank=True)
    (d / "snap").mkdir()
    snapshot = dict(name="snapshot", kind="snapshot", input=path,
                    params=dict(CASES["data"], mesh_shape="2,2"),
                    prefix=str(d / "snap" / "m.txt"), freq=2, rounds=4,
                    resume_at=2)
    res = run_world([dict(name=name, kind="train", input=path,
                          params=dict(p, mesh_shape="2,2"), rounds=ROUNDS)
                     for name, p in CASES.items()] + [snapshot, load, stray],
                    4, str(d / "out"))
    return res, snapshot["prefix"], csv


@pytest.mark.parametrize("name", list(CASES))
def test_mesh_2x2_equals_jax_2x2_and_2(four, name, monkeypatch):
    monkeypatch.setenv("LGBM_TPU_HIST_BACKEND", "compact")
    monkeypatch.setenv("LGBM_TPU_SPLIT_INTERPRET", "1")
    per = four[0][name]
    for _, info in per:
        assert "error" not in info, info.get("traceback")
    models = [info["model"] for _, info in per]
    assert all(m == models[0] for m in models)
    assert per[0][1]["iterations"] == ROUNDS
    X, y = _data()
    digests = [jlgb.train(dict(CASES[name], mesh_shape=shape),
                          jlgb.Dataset(X, label=y),
                          ROUNDS).digest(include_scores=False)
               for shape in ("2,2", "2")]
    assert per[0][1]["digest"] == digests[0] == digests[1]


def test_mesh_2x2_snapshot_resumes_at_its_world(four):
    """Snapshots of a [2, 2] run: one writer a data index (feature index
    0), a manifest of a 2-rank world, and every rank resumed from the
    middle snapshot ends on the uninterrupted model, its scores from its
    data index's state file.  The commit barrier compares every rank's
    ack: rank 1, a replica of data index 0, reporting another digest
    is refused on every rank."""
    from lightgbm_tpu_torch.boosting import snapshot as snap
    res, prefix, _ = four
    per = res["snapshot"]
    for _, info in per:
        assert "error" not in info, info.get("traceback")
        assert info["resumed_model"] == info["model"]
        assert info["resumed_digest_scores"] == info["digest_scores"]
        assert "ranks disagree" in (info["mismatch_error"] or "")
        assert info["mismatch_events"] == 1
        assert info["bad_manifests"] == 0
    scores = [info["digest_scores"] for _, info in per]
    assert scores[0] == scores[1] != scores[2] == scores[3]
    man = snap.resolve_snapshot(snap.snapshot_paths(prefix, 2)[2])
    assert man["world_size"] == 2
    assert sorted(man["rank_state_paths"]) == [0, 1]


def test_mesh_2x2_file_load_takes_the_data_index_rows(four):
    """``Dataset(path)`` with ``num_machines=4`` under [2, 2]: ranks 2i
    and 2i + 1 load data index i's mod-2 rows, bitwise the JAX package's
    loader's rank i of a 2-rank load (the same mappers, through one
    gather entry a data index), and the four models are byte-identical."""
    res, _, csv = four
    per = res["load"]
    for _, info in per:
        assert "error" not in info, info.get("traceback")
    assert [info["num_data"] for _, info in per] == [1500] * 4
    assert len({json.dumps(info["mappers"]) for _, info in per}) == 1
    assert len({info["model"] for _, info in per}) == 1
    ag = j_dist.ThreadedAllgather(2)
    out = [None, None]
    jparams = dict(LOAD_PARAMS, num_machines=2)
    jparams.pop("mesh_shape")

    def load(r):
        out[r] = j_loader.load_file(csv, JConfig.from_params(jparams),
                                    rank=r, num_machines=2,
                                    allgather=ag.for_rank(r))

    ts = [threading.Thread(target=load, args=(r,)) for r in range(2)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(120)
    for rank, (arr, info) in enumerate(per):
        jd = out[rank // 2]
        np.testing.assert_array_equal(arr["bins"], jd.bins)
        assert json.dumps(info["mappers"], default=str) == json.dumps(
            [m.to_dict() for m in jd.mappers], default=str)


def test_mesh_2x2_replicas_holding_other_rows_raise(four):
    """Ranks of one data index that hold different rows (each rank its
    own global block) are refused before the first tree, on every rank,
    naming the ranks that disagree."""
    per = four[0]["stray"]
    for rank, (_, info) in enumerate(per):
        assert "disagree with rank" in info.get("error", ""), info
