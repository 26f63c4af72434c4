"""Leaf renewal (L1, quantile, MAPE) under data- and voting-parallel
training: lightgbm_tpu_torch in a gloo world of two CPU ranks
(``tests/torch_dist_worker.py``) against the JAX package's 2-device mesh.

Each rank holds its contiguous block of the rows; every leaf of a
renewed tree takes the objective's percentile over every rank's
residuals, weights and leaf ids, laid rank-major over the global row
axis (``GBDT._renew_leaves``, ``MeshContext.all_gather_rows``; MAPE's
per-row ``label_weight`` realigned by its ``globalize_rows``).  The JAX
package's mesh holds every row, pads the last device's block and cuts
the padding off ``row_leaf`` before it renews, so the pad rows enter
no percentile.  Both ranks' models are the JAX package's model text,
bit for bit, with and without weights, on ranks of 2,000 rows each and
of 2,001 and 2,000; and one voting-parallel L1 run too.
"""
import numpy as np
import pytest
import torch

import lightgbm_tpu as jlgb

from tests.torch_dist_worker import run_world

torch.set_num_threads(1)   # tiny tensors: more threads only spin

N = 4000
ROUNDS = 3
BASE = {"num_leaves": 15, "max_bin": 63, "min_data_in_leaf": 20,
        "learning_rate": 0.1, "verbose": -1, "tree_learner": "data"}
OBJECTIVES = {"l1": {"objective": "regression_l1"},
              "quantile": {"objective": "quantile", "alpha": 0.3},
              "mape": {"objective": "mape"}}


def _data(n, weighted, seed=5):
    rng = np.random.RandomState(seed)
    X = rng.normal(size=(n, 6))
    X[rng.rand(n) < 0.05, 2] = np.nan
    y = (2.0 * X[:, 0] - X[:, 1] + 0.5 * np.nan_to_num(X[:, 2])
         + rng.standard_t(3, size=n) + 3.0).astype(np.float32)
    w = (rng.uniform(0.5, 2.0, size=n).astype(np.float32) if weighted
         else None)
    return X, y, w


def _cases():
    out = []
    for obj, extra in OBJECTIVES.items():
        for weighted in (False, True):
            for uneven in (False, True):
                out.append(dict(name=f"{obj}_{'w' if weighted else 'u'}_"
                                     f"{'odd' if uneven else 'even'}",
                                params=dict(BASE, **extra),
                                n=N + int(uneven), weighted=weighted))
    out.append(dict(name="l1_voting",
                    params=dict(BASE, tree_learner="voting", top_k=3,
                                **OBJECTIVES["l1"]),
                    n=N + 1, weighted=True))
    return out


CASES = _cases()


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    d = tmp_path_factory.mktemp("renewal")
    jobs = []
    for c in CASES:
        X, y, w = _data(c["n"], c["weighted"])
        path = str(d / f"{c['name']}.npz")
        np.savez(path, X=X, y=y, **({} if w is None else {"w": w}))
        jobs.append(dict(name=c["name"], kind="train", input=path,
                         params=c["params"], rounds=ROUNDS))
    return run_world(jobs, 2, str(d / "out"))


@pytest.fixture
def compact(monkeypatch):
    """The JAX package on its kernel path on the CPU (interpret mode)."""
    monkeypatch.setenv("LGBM_TPU_HIST_BACKEND", "compact")
    monkeypatch.setenv("LGBM_TPU_SPLIT_INTERPRET", "1")


@pytest.mark.parametrize("case", CASES, ids=[c["name"] for c in CASES])
def test_renewal_ranks_equal_jax_mesh(world, compact, case):
    (_, a), (_, b) = world[case["name"]]
    for info in (a, b):
        assert "error" not in info, info.get("traceback")
    X, y, w = _data(case["n"], case["weighted"])
    jb = jlgb.train(dict(case["params"], mesh_shape="2"),
                    jlgb.Dataset(X, label=y, weight=w), ROUNDS)
    assert a["model"] == b["model"] == jb.model_to_string()
    assert a["digest"] == b["digest"] == jb.digest(include_scores=False)
    assert a["iterations"] == ROUNDS
