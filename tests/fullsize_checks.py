"""Checks shared by the full-size record tests (``tests/test_torch_
fullsize*.py``): a record's parameters against ``chip_smoke.py``'s, its
model text against its digests, and the port's prefix against it."""
import hashlib

import numpy as np

from tools import torch_fullsize_ref as ref
from tools.numcheck.tolerance_registry import tol

import lightgbm_tpu_torch as tlgb
from lightgbm_tpu_torch.obs.determinism import tree_digest
from lightgbm_tpu_torch.parallel.envelope import model_flip_report


def check_smoke_constants(cell, rec, params, rounds, stop) -> None:
    """The record was made at ``chip_smoke.py``'s parameters, rounds and
    early stopping, on the JAX package's kernel path."""
    assert rec["params"] == params
    assert rec["rounds"] == rounds
    assert rec["early_stopping_rounds"] == stop
    env = dict(rec["reference"]["env"])
    mesh = env.pop("mesh_shape", None)
    assert env == ref.reference_env(cell)
    assert env["LGBM_TPU_HIST_BACKEND"] == "compact"
    assert mesh == (str(ref.CELLS[cell]["mesh"])
                    if ref.CELLS[cell].get("mesh") else None)
    assert len(rec["tree_digests"]) == (rec["iterations"]
                                        * ref.num_class(cell))
    if stop is None:
        assert rec["iterations"] == rounds


def check_round_trip(cell, rec, X=None) -> None:
    """The model text parses to the record's per-tree and tree digests,
    ``model_flip_report`` of the record against itself is identical,
    and (where the cell has raw rows ``X``) the sample rows' host-walk
    scores are the parsed trees' and the JAX package's own predictor
    (an f32 sum on its device) lands within ``f32_accum_5x`` of them."""
    bst = tlgb.Booster(model_str=rec["model"], device="cpu")
    trees = bst._gbdt.models
    assert ref.tree_digests(trees) == rec["tree_digests"]
    h = hashlib.sha256()
    for t in trees:
        tree_digest(h, t)
    assert h.hexdigest() == rec["digest_trees"]
    rep = model_flip_report(rec["model"], rec["model"])
    assert rep["flip_tree"] is None and rep["prefix_trees"] == len(trees)
    assert not rep["max_leaf_value_gap"]
    rows = np.asarray(rec["sample"]["rows"])
    assert len(rows) == ref.SAMPLE_ROWS
    if X is None:
        return
    host = ref.host_raw(trees, X[rows], ref.num_class(cell))
    np.testing.assert_array_equal(host,
                                  ref.from_hex(rec["sample"]["host_raw"]))
    np.testing.assert_allclose(ref.from_hex(rec["sample"]["raw_score"]),
                               host, rtol=tol("f32_accum_5x"),
                               atol=tol("f32_accum_5x"))


def check_prefix(cell, rec, trees, text, bitwise: bool) -> dict:
    """The port's first trees against the record's: equal, or (where
    ``bitwise`` is False) parted at a near-tie only, the leaf values of
    the structurally equal trees within ``envelope_value_noise``.  ->
    ``model_flip_report``'s report."""
    got = ref.tree_digests(trees)
    assert 0 < len(got) <= len(rec["tree_digests"])
    rep = model_flip_report(rec["model"], text)
    if got == rec["tree_digests"][:len(got)]:
        return rep
    assert not bitwise, f"{cell}: the port's trees are not the JAX package's"
    assert rep["near_tie"], (f"{cell}: the port parts from the record "
                             f"other than at a near-tie: {rep}")
    assert rep["max_leaf_value_gap"] <= tol("envelope_value_noise"), rep
    return rep
