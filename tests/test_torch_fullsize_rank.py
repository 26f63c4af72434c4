"""The JAX package's full-size ranking model, recorded, and the port held
to it.

``tests/data/torch_fullsize/rank.json.gz`` (``tools/torch_fullsize_
ref.py``) is ``chip_smoke.py`` phase 19's lambdarank at the bench's MS
LTR shape: 4,750 queries (seed 7, about 120 documents each), 136
features at ``max_bin`` 255, 255 leaves, 8 iterations.  The record is
checked whole (its data and parameters are the script's, its model text
parses back to its digests and its sample rows' host-walk scores), and
the port on the CPU at full size trains its first tree, bitwise the
record's: at iteration 0 every score ties, so every pair sigmoid is
exactly 1/2, and the pair grids fold in the JAX package's order
(ROADMAP C40, held on every bucket width by the last test here).
"""
import numpy as np
import pytest
import torch

from tests.fullsize_checks import (check_prefix, check_round_trip,
                                   check_smoke_constants)
from tools import torch_fullsize_ref as ref

import chip_smoke as cs
import lightgbm_tpu_torch as tlgb

torch.set_num_threads(1)   # one worker, one thread: the file's budget

PREFIX = 1


def test_record_data_and_parameters_are_the_smokes():
    rec = ref.load_record("rank")
    X, rel, sizes = cs.rank_data()
    assert ref.data_sha256(X, rel, sizes) == rec["data"]["sha256"]
    assert ref.data_sha256(*ref.cell_data("rank")[:3]) \
        == rec["data"]["sha256"]
    check_smoke_constants("rank", rec, cs.RANK_PARAMS, cs.RANK_ITERS, None)
    assert rec["data"]["queries"] == cs.RANK_QUERIES == len(sizes)
    assert rec["data"]["rows"] == len(X)
    assert rec["data"]["features"] == cs.RANK_FEATURES


def test_record_model_round_trips():
    rec = ref.load_record("rank")
    check_round_trip("rank", rec, ref.cell_data("rank")[0])
    # the record's metric is the port's NDCG@10 of the JAX package's raw
    # scores; phase 19's gate holds it
    assert rec["metrics"]["train_ndcg10"] >= cs.RANK_NDCG_GATE


def test_port_prefix_equals_record():
    rec = ref.load_record("rank")
    bst, _ = ref.train(tlgb, "rank", PREFIX, device="cpu")
    assert len(bst._gbdt.models) == PREFIX
    check_prefix("rank", rec, bst._gbdt.models, bst.model_to_string(),
                 bitwise=True)
    assert np.isfinite(bst._gbdt.scores.numpy()).all()


@pytest.mark.parametrize("M", [16, 32, 64, 128, 256, 512, 1024, 2048])
def test_lambdarank_fold_is_the_references(M):
    """ROADMAP C40: the pair grids of every bucket width of the ranking
    cell (``T`` = ``max_position`` 20, or ``M`` below it) fold to the
    JAX package's gradients bitwise.  The scores tie, so every sigmoid
    is exactly 1/2, as at the cell's iteration 0, where ``torch.sum``'s
    fold moved 205,424 of the 561,830 rows' gradients from the JAX
    package's (the first, row 0 of query 0, 309 documents in the
    512-wide bucket: 0x1.8ebfa8p-6 against 0x1.8ebff8p-6), and the
    port's tree 0 parted from the record in leaf values on the CPU and
    on the card."""
    import jax.numpy as jnp
    import lightgbm_tpu.objective.objectives as jobj
    from lightgbm_tpu_torch.objective.objectives import (
        lambdarank_bucket_grads)
    rng = np.random.RandomState(M)
    C, T = 6, min(20, M)
    valid = np.arange(M)[None, :] < rng.randint(M // 2 + 1, M + 1,
                                                size=C)[:, None]
    label = np.where(valid, rng.randint(0, 5, size=(C, M)), -1).astype(
        np.float32)
    gain = np.where(valid, 2.0 ** np.maximum(label, 0) - 1, 0).astype(
        np.float32)
    imd = rng.uniform(0.01, 0.2, size=C).astype(np.float32)
    disc = (1.0 / np.log2(np.arange(M) + 2.0)).astype(np.float32)
    s = np.zeros((C, M), np.float32)
    want = jobj._lambdarank_bucket_grads(
        jnp.asarray(s), jnp.asarray(valid), jnp.asarray(label),
        jnp.asarray(gain), jnp.asarray(imd), jnp.asarray(disc),
        np.float32(1.0), T=T, C=C)
    got = lambdarank_bucket_grads(*(torch.from_numpy(a) for a in (
        s, valid, label, gain, imd, disc)), 1.0, T)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(
            g.numpy()[valid].view(np.int32),
            np.asarray(w)[valid].view(np.int32))
