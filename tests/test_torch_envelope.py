"""The port's divergence envelope (``lightgbm_tpu_torch/parallel/envelope.py``)
against the JAX package's ``parallel/envelope.py``: the same reports on
the same inputs.

``model_flip_report`` on model strings of the port (identical, a
near-tie flip, a real divergence) and ``near_tie_report`` on two
hand-made trees over one bin matrix (numpy arrays for both packages;
the port's also takes torch tensors).
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from lightgbm_tpu.parallel import envelope as jenv

import lightgbm_tpu_torch as tlgb
from lightgbm_tpu_torch.parallel import envelope as tenv

torch.set_num_threads(1)   # tiny tensors: more threads only spin


def _models():
    rng = np.random.RandomState(0)
    X = rng.normal(size=(600, 5))
    y = (X[:, 0] + 0.5 * X[:, 1] + rng.normal(size=600) > 0).astype(
        np.float32)
    params = {"objective": "binary", "num_leaves": 7, "verbose": -1,
              "feature_fraction": 0.6}

    def train(**kw):
        return tlgb.train(dict(params, **kw), tlgb.Dataset(X, label=y), 4,
                          device="cpu").model_to_string()
    return train(), train(feature_fraction_seed=7)


def _flip(text: str) -> str:
    """The first tree's second split gain raised by one ulp-sized step:
    the winner of a near tie, everything else equal."""
    lines = text.splitlines()
    i = next(k for k, ln in enumerate(lines) if ln.startswith("split_gain="))
    gains = lines[i].split("=", 1)[1].split()
    gains[1] = repr(float(gains[1]) * (1 + 1e-7))
    lines[i] = "split_gain=" + " ".join(gains)
    j = next(k for k, ln in enumerate(lines) if ln.startswith("threshold="))
    thr = lines[j].split("=", 1)[1].split()
    thr[1] = repr(float(thr[1]) + 1e-3)
    lines[j] = "threshold=" + " ".join(thr)
    return "\n".join(lines) + "\n"


@pytest.mark.parametrize("case", ["same", "near_tie", "diverged"])
def test_model_flip_report_matches_reference(case):
    a, b = _models()
    other = {"same": a, "near_tie": _flip(a), "diverged": b}[case]
    got = tenv.model_flip_report(a, other)
    assert got == jenv.model_flip_report(a, other)
    if case == "same":
        assert got["flip_tree"] is None
    if case == "near_tie":
        assert got["near_tie"]
        tenv.assert_model_flip_envelope(a, other)


def _tree(feature, threshold, left, right, gain, leaf_value, row_leaf):
    return SimpleNamespace(
        feature=np.asarray(feature, np.int32),
        threshold_bin=np.asarray(threshold, np.int32),
        left_child=np.asarray(left, np.int32),
        right_child=np.asarray(right, np.int32),
        gain=np.asarray(gain, np.float32),
        leaf_value=np.asarray(leaf_value, np.float32),
        row_leaf=np.asarray(row_leaf, np.int32),
        num_leaves=len(leaf_value))


def _walk(t, bins):
    out = []
    for row in bins:
        node = 0
        while True:
            f, thr = t["feature"][node], t["threshold"][node]
            child = t["left"][node] if row[f] <= thr else t["right"][node]
            if child < 0:
                out.append(~child)
                break
            node = child
    return out


def test_near_tie_report_matches_reference():
    rng = np.random.RandomState(3)
    bins = rng.randint(0, 16, size=(400, 3)).astype(np.uint8)
    # two 3-leaf trees: the same root, a near-tied second split on
    # another feature
    shape = dict(feature=[0, 1], threshold=[7, 4], left=[1, -2],
                 right=[-1, -3])
    a = dict(shape, gain=[10.0, 2.0000], leaf_value=[0.1, -0.2, 0.3])
    b = dict(shape, feature=[0, 2], threshold=[7, 9],
             gain=[10.0, 2.0001], leaf_value=[0.1, -0.2, 0.3])
    trees = []
    for d in (a, b):
        arr = {"feature": d["feature"], "threshold": d["threshold"],
               "left": d["left"], "right": d["right"]}
        trees.append(_tree(d["feature"], d["threshold"], d["left"],
                           d["right"], d["gain"], d["leaf_value"],
                           _walk(arr, bins)))
    want = jenv.near_tie_report(trees[0], trees[1], bins)
    assert want["mismatched_rows"] > 0 and want["divergence_points"] == 1
    assert tenv.near_tie_report(trees[0], trees[1], bins) == want
    as_tensors = [SimpleNamespace(**{k: torch.as_tensor(v)
                                     if isinstance(v, np.ndarray) else v
                                     for k, v in vars(t).items()})
                  for t in trees]
    assert tenv.near_tie_report(*as_tensors, bins) == want
    assert tenv.assert_envelope(trees[0], trees[1], bins,
                                mismatch_ceiling=1.0) == want
