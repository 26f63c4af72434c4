"""lightgbm_tpu_torch across four CPU ranks, and multi-process loading.

* A gloo world of four ranks (``tests/torch_dist_worker.py``) trains
  data-parallel; at four ranks the order of the histogram sum over the
  ranks is gloo's, not XLA's, so the model is held to the JAX package's
  4-device mesh model within the model-flip envelope
  (``parallel/envelope.py:model_flip_report``), and the four ranks to
  each other bit for bit.
* A world of two ranks loads one CSV with ``num_machines=2``: each rank
  keeps its mod-rank rows, the bin mappers come from the distributed
  bin finding and are identical on both ranks and equal to the JAX
  package's loader's (ranks as threads there); the ranks then train
  data-parallel to one model.
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
from lightgbm_tpu.parallel.envelope import assert_model_flip_envelope

from tests.torch_dist_worker import run_world

torch.set_num_threads(1)   # tiny tensors: more threads only spin

BASE = {"objective": "binary", "num_leaves": 15, "max_bin": 63,
        "min_data_in_leaf": 20, "learning_rate": 0.1, "verbose": -1,
        "boost_from_average": False}
N = 4000


def _data(n=N, seed=7):
    rng = np.random.RandomState(seed)
    X = rng.normal(size=(n, 6))
    y = ((X[:, 0] - 0.6 * X[:, 2] + 0.5 * rng.normal(size=n)) > 0).astype(
        np.float32)
    return X, y


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    d = tmp_path_factory.mktemp("w4")
    X, y = _data()
    path = str(d / "xy.npz")
    np.savez(path, X=X, y=y)
    return run_world([dict(name="data4", kind="train", input=path,
                           params=dict(BASE, tree_learner="data"),
                           rounds=4)], 4, str(d / "out"))


def test_four_ranks_within_envelope_of_jax_mesh(four, monkeypatch):
    monkeypatch.setenv("LGBM_TPU_HIST_BACKEND", "compact")
    monkeypatch.setenv("LGBM_TPU_SPLIT_INTERPRET", "1")
    per = four["data4"]
    for _, info in per:
        assert "error" not in info, info.get("traceback")
    models = [info["model"] for _, info in per]
    assert all(m == models[0] for m in models)
    X, y = _data()
    jb = jlgb.train(dict(BASE, tree_learner="data", mesh_shape="4"),
                    jlgb.Dataset(X, label=y), 4)
    assert_model_flip_envelope(models[0], jb.model_to_string(),
                               label="torch W=4 vs JAX 4-device mesh")


def _write_csv(path, X, y):
    with open(path, "w") as f:
        for xi, yi in zip(X, y):
            f.write(",".join([repr(float(yi))] + [repr(float(v))
                                                  for v in xi]) + "\n")


def test_num_machines_load_and_train(tmp_path):
    X, y = _data(3000, seed=9)
    path = str(tmp_path / "train.csv")
    _write_csv(path, X, y)
    params = dict(BASE, tree_learner="data", num_machines=2,
                  bin_construct_sample_cnt=800)
    res = run_world([dict(name="load", kind="load", path=path,
                          params=params, rounds=3)], 2,
                    str(tmp_path / "out"))
    per = res["load"]
    for _, info in per:
        assert "error" not in info, info.get("traceback")
    (a_arr, a), (b_arr, b) = per
    assert a["num_data"] == b["num_data"] == 1500
    assert json.dumps(a["mappers"]) == json.dumps(b["mappers"])
    assert a["model"] == b["model"]
    # the JAX package's loader over the same file, its ranks as threads
    ag = j_dist.ThreadedAllgather(2)
    out = [None, None]

    def load(r):
        out[r] = j_loader.load_file(path, JConfig.from_params(params),
                                    rank=r, num_machines=2,
                                    allgather=ag.for_rank(r))

    ts = [threading.Thread(target=load, args=(r,)) for r in range(2)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(120)
    for arr, info, jd in ((a_arr, a, out[0]), (b_arr, b, out[1])):
        np.testing.assert_array_equal(arr["bins"], jd.bins)
        assert json.dumps(info["mappers"], default=str) == json.dumps(
            [m.to_dict() for m in jd.mappers], default=str)
