"""``lgb.train`` across processes: lightgbm_tpu_torch's data-parallel
training in a gloo world of two CPU ranks (``tests/torch_dist_worker.py``)
against the JAX package's 2-device mesh run, and the multi-process
contracts around it:

* ``tree_learner="data"`` gives the JAX package's model (digest and
  model text) on both ranks, each rank training on its contiguous half
  of the rows, also when the halves differ by a row (ROADMAP C28); ``feature`` and ``voting`` give rank-identical models, the
  feature-parallel one the serial model's decisions;
* early stopping decides the same iteration on every rank (the JAX
  package's ``tests/test_multihost.py:95``): the ranks adopt rank 0's
  metric values at each window;
* GOSS and random forests train with identical ranks; DART raises the
  JAX package's error;
* with one rank, ``tree_learner="data"`` warns and trains the serial
  model;
* after a data-parallel run, ``spmd.skip_record`` on rank 1 at the
  middle one of three host gathers makes the merged summary's
  ``flight_recorder_check`` name the skipped site and rank 1 (the JAX
  package's ``tests/multihost_spmd_worker.py`` sequence), with both
  ranks and their collective skew in the summary.
"""
import numpy as np
import pytest
import torch

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb

from tests.torch_dist_worker import run_world

torch.set_num_threads(1)   # tiny tensors: more threads only spin

N = 4000
BASE = {"objective": "binary", "num_leaves": 15, "max_bin": 63,
        "min_data_in_leaf": 20, "learning_rate": 0.1, "verbose": -1}


def _data(n=N, seed=3):
    rng = np.random.RandomState(seed)
    X = rng.normal(size=(n, 6))
    X[rng.rand(n) < 0.05, 3] = np.nan
    y = ((X[:, 0] + 0.7 * X[:, 1] - 0.4 * np.nan_to_num(X[:, 3])
          + 0.5 * rng.normal(size=n)) > 0).astype(np.float32)
    return X, y


CASES = [
    dict(name="data", kind="train",
         params=dict(BASE, tree_learner="data", boost_from_average=False),
         rounds=6),
    dict(name="data_bag", kind="train",
         params=dict(BASE, tree_learner="data", bagging_fraction=0.7,
                     bagging_freq=1, feature_fraction=0.8,
                     boost_from_average=False), rounds=4),
    dict(name="data_average", kind="train",
         params=dict(BASE, tree_learner="data"), rounds=2),
    dict(name="feature", kind="train",
         params=dict(BASE, tree_learner="feature"), rounds=4),
    dict(name="voting", kind="train",
         params=dict(BASE, tree_learner="voting", top_k=3), rounds=4),
    dict(name="early_stop", kind="train", valid=True, early_stopping=3,
         params=dict(BASE, tree_learner="data", metric="auc",
                     is_training_metric=True, learning_rate=0.5),
         rounds=40),
    dict(name="goss", kind="train",
         params=dict(BASE, tree_learner="data", boosting="goss"), rounds=4),
    dict(name="rf", kind="train",
         params=dict(BASE, tree_learner="data", boosting="rf",
                     bagging_fraction=0.6, bagging_freq=1), rounds=4),
    dict(name="dart", kind="train",
         params=dict(BASE, tree_learner="data", boosting="dart"), rounds=2),
    dict(name="desync", kind="desync",
         params=dict(BASE, tree_learner="data"), rounds=3),
    # ranks of 2,001 and 2,000 rows (ROADMAP C28)
    dict(name="uneven", kind="train", n=N + 1,
         params=dict(BASE, objective="regression", tree_learner="data",
                     boost_from_average=False, bagging_fraction=0.7,
                     bagging_freq=1), rounds=6),
]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    d = tmp_path_factory.mktemp("multiprocess")
    X, y = _data()
    Xv, yv = _data(1000, seed=4)
    plain = str(d / "xy.npz")
    np.savez(plain, X=X, y=y)
    with_valid = str(d / "xyv.npz")
    np.savez(with_valid, X=X, y=y, Xv=Xv, yv=yv)
    X1, y1 = _data(N + 1)
    uneven = str(d / "xy_uneven.npz")
    np.savez(uneven, X=X1, y=y1)
    cases = [dict({k: v for k, v in c.items() if k not in ("valid", "n")},
                  input=(with_valid if c.get("valid")
                         else uneven if c.get("n") else plain))
             for c in CASES]
    return run_world(cases, 2, str(d / "out"))


def _ok(res, name):
    per = res[name]
    for _, info in per:
        assert "error" not in info, info.get("traceback")
    return per


@pytest.fixture
def compact(monkeypatch):
    """The JAX package on its kernel path on the CPU (interpret mode)."""
    monkeypatch.setenv("LGBM_TPU_HIST_BACKEND", "compact")
    monkeypatch.setenv("LGBM_TPU_SPLIT_INTERPRET", "1")


def _jax_mesh(params, rounds, n_devices=2, n=N):
    X, y = _data(n)
    return jlgb.train(dict(params, mesh_shape=str(n_devices)),
                      jlgb.Dataset(X, label=y), rounds)


@pytest.mark.parametrize("name", ["data", "data_bag"])
def test_data_parallel_train_equals_jax_mesh(world, compact, name):
    """Both ranks' models are the JAX package's 2-device mesh model (from
    a zero init score: see the next test for ``boost_from_average``)."""
    case = next(c for c in CASES if c["name"] == name)
    jb = _jax_mesh(case["params"], case["rounds"])
    (_, a), (_, b) = _ok(world, name)
    assert a["model"] == b["model"]
    assert a["init_score"] == b["init_score"]
    assert a["digest"] == b["digest"] == jb.digest(include_scores=False)
    assert a["model"] == jb.model_to_string()


def test_uneven_ranks_equal_jax_mesh(world, compact):
    """Ranks of 2,001 and 2,000 rows (n = 4,001, int8h, bagging): the
    JAX package's 2-device mesh pads its second device with one
    bagged-out row of zero gradient and hessian, which could have moved
    that device's int8 quantization scales (ROADMAP C28); the port's
    rank holds its 2,000 rows alone.  The models are bitwise equal: the
    padding row moves no scale.  The objective is L2, whose gradients
    are exact: the binary objective's sigmoid on the CPU is not bitwise
    the JAX package's on every row (``tests/test_torch_objectives.py``
    holds it within ``f32_eps_few``), and at these shard lengths its
    last-bit differences reach a root's raw sums (one internal value
    an ulp apart), though not the quantized histograms."""
    case = next(c for c in CASES if c["name"] == "uneven")
    jb = _jax_mesh(case["params"], case["rounds"], n=case["n"])
    (_, a), (_, b) = _ok(world, "uneven")
    assert a["model"] == b["model"] == jb.model_to_string()
    assert a["digest"] == jb.digest(include_scores=False)


def test_data_parallel_init_score_is_jax_multiprocess_one(world):
    """A multi-process run takes its init score from every rank's labels
    through the JAX package's ``boost_from_score_global`` (float64 sums
    of the ranks' label sums); the JAX package's single-process mesh
    averages all rows in float32 instead, which can land an ulp away
    (ROADMAP C27), so this case is held to the multi-process form."""
    from lightgbm_tpu.config import Config as JConfig
    from lightgbm_tpu.io.dataset import Metadata as JMetadata
    from lightgbm_tpu.objective.objectives import create_objective
    X, y = _data()
    halves = [y[:N // 2], y[N // 2:]]
    objs = []
    for part in halves:
        md = JMetadata()
        md.set_field("label", part)
        o = create_objective(JConfig.from_params(dict(BASE)))
        o.init(md, len(part))
        objs.append(o)
    sums = [[float(p.astype(np.float64).sum()), float(len(p))]
            for p in halves]
    want = objs[0].boost_from_score_global(lambda obj: sums)
    (_, a), (_, b) = _ok(world, "data_average")
    assert a["init_score"] == b["init_score"] == want != 0.0
    assert a["model"] == b["model"]


@pytest.mark.parametrize("name", ["feature", "voting"])
def test_feature_and_voting_ranks_identical(world, name, monkeypatch):
    (_, a), (_, b) = _ok(world, name)
    assert a["model"] == b["model"] and a["iterations"] == 4
    assert a["digest"] == b["digest"]
    if name == "feature":
        # rows replicated, the argmax with the serial tie rule: the serial
        # model, scanned as the feature-parallel ranks scan (the serial
        # build takes the fused split kernel at <= 65,536 rows, whose
        # gains round differently; past it, as on the headline, both
        # take the scan of ops/split.py)
        from lightgbm_tpu_torch.ops import split_kernel
        monkeypatch.setattr(split_kernel, "SPLIT_KERNEL_MAX_ROWS", 0)
        X, y = _data()
        serial = tlgb.train(dict(BASE), tlgb.Dataset(X, label=y), 4,
                            device="cpu")
        assert a["digest"] == serial.digest(include_scores=False)


def test_early_stopping_rank_identical(world):
    (_, a), (_, b) = _ok(world, "early_stop")
    assert a["best_iteration"] == b["best_iteration"] > 0
    assert a["iterations"] == b["iterations"] < 40
    assert a["model"] == b["model"]
    # every rank reports rank 0's values, the training metric included
    assert a["evals"] == b["evals"]


@pytest.mark.parametrize("name", ["goss", "rf"])
def test_variants_ranks_identical(world, name):
    (_, a), (_, b) = _ok(world, name)
    assert a["model"] == b["model"] and a["iterations"] > 0
    assert a["digest"] == b["digest"]


def test_dart_multiprocess_raises_jax_error(world):
    for _, info in world["dart"]:
        assert info["error"].startswith("NotImplementedError: boosting=dart "
                                        "is not supported with multi-process "
                                        "training")


def test_single_rank_data_learner_warns_and_trains_serial(caplog):
    X, y = _data(1000)
    serial = tlgb.train(dict(BASE), tlgb.Dataset(X, label=y), 3,
                        device="cpu")
    with caplog.at_level("WARNING", logger="lightgbm_tpu_torch"):
        data = tlgb.train(dict(BASE, tree_learner="data"),
                          tlgb.Dataset(X, label=y), 3, device="cpu")
    assert data.digest() == serial.digest()
    assert ("tree_learner=data requested but only one device is visible; "
            "running serial") in caplog.text


def test_desync_localized_and_merged_summary(world):
    per = _ok(world, "desync")
    for _, info in per:
        m = info["merged"]
        assert m["process_count"] == 2 and m["ranks"] == [0, 1]
        check = m["flight_recorder_check"]
        assert check["ok"] is False
        div = check["first_divergence"]
        assert div["rank"] == 1
        assert div["site"] == "io.distributed.process_allgather"
        skew = m["collective_skew"]
        assert "io.distributed.process_allgather" in skew
        assert len(skew["io.distributed.process_allgather"][
            "per_rank_wait_s"]) == 2
