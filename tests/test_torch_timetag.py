"""TIMETAG phase timers of the port (``lightgbm_tpu_torch/utils/timetag.py``)
held to the JAX package's on a toy run of three ``Booster.update`` calls
(the JAX package's per-iteration loop, where its timetags sit).

``LGBM_TPU_TIMETAG=1`` records the boosting phases, each as often as the
JAX package does; ``LGBM_TPU_TIMETAG=phases`` adds the tree learner's
``tree:*`` phases under the JAX package's names (the port routes inside
its fused histogram kernel on narrow waves, so ``tree:route`` is
counted less often).  Off, the port records nothing.
"""
import numpy as np
import pytest
import torch

import lightgbm_tpu as jlgb
from lightgbm_tpu.utils import timetag as jtt

import lightgbm_tpu_torch as tlgb
from lightgbm_tpu_torch.utils import timetag as ttt

torch.set_num_threads(1)   # tiny tensors: more threads only spin

PARAMS = {"objective": "binary", "num_leaves": 7, "verbose": -1}
ITERS = 3


@pytest.fixture(autouse=True)
def _reference_kernels(monkeypatch):
    monkeypatch.setenv("LGBM_TPU_HIST_BACKEND", "compact")
    monkeypatch.setenv("LGBM_TPU_SPLIT_INTERPRET", "1")
    jtt.reset()
    ttt.reset()
    yield
    jtt.reset()
    ttt.reset()


def _data():
    rng = np.random.RandomState(0)
    X = rng.normal(size=(500, 4))
    return X, (X[:, 0] > 0).astype(np.float32)


def _run(lgb, **kw):
    X, y = _data()
    bst = lgb.Booster(params=dict(PARAMS), train_set=lgb.Dataset(X, label=y),
                      **kw)
    for _ in range(ITERS):
        bst.update()
    bst.model_to_string()           # the host trees: to_host_tree


@pytest.mark.parametrize("mode", ["1", "phases"])
def test_phase_names_match_reference(mode, monkeypatch):
    monkeypatch.setenv("LGBM_TPU_TIMETAG", mode)
    _run(jlgb)
    _run(tlgb, device="cpu")
    assert sorted(ttt._acc) == sorted(jtt._acc)
    boosting = {"boosting(grad)", "tree", "score", "stump_check",
                "to_host_tree"}
    assert boosting <= set(ttt._acc)
    assert {k: ttt._cnt[k] for k in boosting} == \
        {k: jtt._cnt[k] for k in boosting}
    assert ttt._cnt["tree"] == ITERS
    if mode == "phases":
        assert {"tree:init", "tree:route", "tree:hist", "tree:scan",
                "tree:update"} <= set(ttt._acc)
    assert "[TIMETAG]" in ttt.report()


def test_off_records_nothing(monkeypatch):
    monkeypatch.delenv("LGBM_TPU_TIMETAG", raising=False)
    _run(tlgb, device="cpu")
    assert not ttt._acc and not ttt._cnt
