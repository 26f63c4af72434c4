"""The compiled predictor's score order and the serve pack's partition
rules (``lightgbm_tpu_torch/serve/compiler.py``).

* Each class's f64 leaf values are added tree by tree, in tree order,
  from zero (:func:`_sum_block`): on seeded forests of 120 trees (one
  class, and three) the f64 sums equal the host walk's
  (``Tree.predict_batch`` added in tree order, as ``GBDT.predict_raw``)
  bit for bit, and the f32 scores equal that sum rounded once, whatever
  the batch: alone, padded to a bucket or not, in row chunks of 64 or
  1,000.  A reduction over the tree axis, as the predictor had before,
  sums in an order that follows the row count (on the card a row's
  score moved with its batch; on these forests 879 and 980 of the
  1,000 rows' f64 sums differ from the tree-order sum, though not yet
  in f32 on the CPU).
* Prediction early stopping continues each row's sum from its
  accumulator: with a margin no row reaches, its scores are
  ``predict_raw``'s bit for bit.
* The objective's output conversion (``objectives.convert_rows``) runs
  in blocks of rows padded to one size, so a row's probability does not
  depend on its batch either: torch's CPU sigmoid takes a scalar path at
  a chunk's tail, an ulp from the vector one (on the card, 3 of 100,000
  rows of the C API's prediction differed from the same rows inside a
  1,000,000-row batch).
* ``build_pack`` passes every tensor of the pack through the serve
  rules (``parallel/partition.py``): a field no rule names raises
  ``PartitionRuleError``; the port's ``persistent_names(2)`` are the JAX
  package's outside the serve pack, whose names are the port's own
  ``ServePack`` fields, and both rule tables cover them exactly once.
"""
import dataclasses

import numpy as np
import pytest
import torch

from lightgbm_tpu.parallel import partition as j_part

from lightgbm_tpu_torch.parallel import partition as t_part
from lightgbm_tpu_torch.serve import compile_trees
from lightgbm_tpu_torch.serve.compiler import ServePack, _sum_block, build_pack

from chip_smoke import forest_rows, random_forest

torch.set_num_threads(1)   # tiny tensors: more threads only spin

ROWS = 1000


def _host_sum(trees, X, K):
    """The host walk's f64 sum: from zero, tree ``i`` into class
    ``i % K``."""
    out = np.zeros((X.shape[0], K))
    for i, t in enumerate(trees):
        out[:, i % K] += t.predict_batch(np.asarray(X, np.float64))
    return out


@pytest.fixture(scope="module", params=[1, 3], ids=["binary", "3class"])
def forest(request):
    K = request.param
    trees = random_forest(7, num_class=K, iters=120 // K, num_leaves=15)
    X = forest_rows(trees, ROWS, seed=8)
    return trees, X, K


def test_sum_block_is_tree_order_f64(forest):
    trees, X, K = forest
    cm = compile_trees(trees, num_class=K, device="cpu")
    got = _sum_block(cm.pack, torch.from_numpy(X), False).numpy()
    np.testing.assert_array_equal(got.T, _host_sum(trees, X, K))


@pytest.mark.parametrize("rchunk", [64, 1000])
def test_scores_do_not_depend_on_the_batch(forest, rchunk):
    trees, X, K = forest
    want = _host_sum(trees, X, K).astype(np.float32)
    want = want if K > 1 else want[:, 0]
    cm = compile_trees(trees, num_class=K, device="cpu", rchunk=rchunk)
    np.testing.assert_array_equal(cm.predict_raw(X), want)
    np.testing.assert_array_equal(cm.predict_raw(X, pad=False), want)
    for lo, hi in ((0, 1), (3, 20), (100, 357), (ROWS - 256, ROWS)):
        np.testing.assert_array_equal(cm.predict_raw(X[lo:hi]), want[lo:hi])


def test_early_stop_without_stops_is_predict_raw(forest):
    trees, X, K = forest
    cm = compile_trees(trees, num_class=K, device="cpu", rchunk=256)
    raw, taken = cm.predict_raw_early_stop(X, 7, 1e30)
    np.testing.assert_array_equal(raw, cm.predict_raw(X))
    assert (taken == -(-len(trees) // (7 * K))).all()


@pytest.mark.parametrize("objective,K", [("binary", 1), ("multiclass", 3)])
def test_conversion_does_not_depend_on_the_batch(objective, K):
    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.objective.objectives import (convert_rows,
                                                         create_objective)
    o = create_objective(Config.from_params(
        {"objective": objective, "num_class": K}))
    raw = (np.random.RandomState(9).normal(size=(100_000, K)) * 4).astype(
        np.float32)
    raw = raw if K > 1 else raw[:, 0]
    full = convert_rows(o, raw)
    np.testing.assert_array_equal(
        full, o.convert_output(torch.from_numpy(raw)).numpy())
    for off, n in ((0, 99_999), (5, 1000), (123, 37), (7, 31), (64, 4097)):
        np.testing.assert_array_equal(convert_rows(o, raw[off:off + n]),
                                      full[off:off + n])


def test_pack_field_without_rule_raises(monkeypatch):
    trees = random_forest(1, num_class=1, iters=3)
    pack = build_pack(trees, device="cpu")
    specs = t_part.match_partition_rules(t_part.serve_rules(),
                                         t_part.serve_pack_names(pack))
    assert specs and all(s == () for s in specs.values())
    monkeypatch.setattr(t_part, "serve_rules", lambda: (
        ("serve_pack", r"^serve/pack/(?!leaf_value$)", ()),))
    with pytest.raises(t_part.PartitionRuleError,
                       match="serve/pack/leaf_value"):
        build_pack(trees, device="cpu")


def test_persistent_names_match_jax():
    names = t_part.persistent_names(2)
    jnames = j_part.persistent_names(2)
    outside = [n for n in names if not n.startswith("serve/")]
    assert outside == [n for n in jnames if not n.startswith("serve/")]
    tensors = [f.name for f in dataclasses.fields(ServePack)
               if f.type not in ("int", int)]
    assert [n for n in names if n.startswith("serve/")] == [
        f"serve/pack/{f}" for f in tensors]
    for row_sharded in (True, False):
        assert t_part.audit_rules(t_part.train_rules("data", row_sharded),
                                  names) == []
        assert j_part.audit_rules(j_part.train_rules("data", row_sharded),
                                  jnames) == []
