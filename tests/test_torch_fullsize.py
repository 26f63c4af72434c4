"""The JAX package's full-size models, recorded, and the port held to them.

``tests/data/torch_fullsize/<cell>.json.gz`` holds a model of the JAX
package at the full size of a ``chip_smoke.py`` path, trained once on a
CPU on its kernel path by ``tools/torch_fullsize_ref.py``:

* ``headline``: phase 4 (1M x 28, 255 leaves, ``max_bin`` 63, binary, 32
  iterations);
* ``headline_l2``: the same rows and parameters with objective
  ``regression`` on the latent, 8 iterations (phase 31);
* ``small_data``: phase 5 (upstream ``train.conf``, 65,536 + 13,107
  rows, early stopping after 10);
* ``serving``: phase 12's model (200,000 x 28, 63 leaves, 100
  iterations).

``chip_smoke.py`` phase 31 holds the card's models to these records.
Here each record is checked whole (its data is ``chip_smoke.py``'s, its
parameters are the script's, its model text parses back to its per-tree
digests and its sample rows' host-walk scores), and the port on the CPU,
at the records' full size, trains the first trees of each cell: they
must be the record's trees.  Where a binary cell parts from its record
on the CPU, the cause is the host (ROADMAP C8: torch's and XLA's CPU
sigmoids differ by an ulp on some rows, which can move a row's int8h
quantum), and the test accepts only a divergence that
``parallel/envelope.py:model_flip_report`` classifies as a near-tie, with
the leaf values of the structurally equal trees inside the measured
envelope.
"""
import hashlib

import numpy as np
import pytest
import torch

from tools import torch_fullsize_ref as ref
from tools.numcheck.tolerance_registry import tol

import chip_smoke as cs
import lightgbm_tpu_torch as tlgb
from lightgbm_tpu_torch.obs.determinism import tree_digest
from lightgbm_tpu_torch.parallel.envelope import model_flip_report

# this file's cells (the others have files of their own:
# test_torch_fullsize_float.py, _mc.py, _rank.py and _dp_stream.py)
CELLS = ("headline", "headline_l2", "small_data", "serving")

# chip_smoke.py's constants for each cell: (params, rounds, early stop)
SMOKE = {
    "headline": (cs.HEADLINE_PARAMS, cs.HEADLINE_ITERS, None),
    "headline_l2": (cs.FULLSIZE_L2_PARAMS, cs.FULLSIZE_L2_ITERS, None),
    "small_data": (cs.TRAIN_CONF, cs.SMALL_ITERS, cs.SMALL_EARLY_STOP),
    "serving": (cs.SERVE_PARAMS, cs.SERVE_ITERS, None),
}

# the iterations of each cell the port trains here on the CPU, at full
# size (each within the file's budget on one worker)
PREFIX = {"headline": 2, "headline_l2": 2, "small_data": 5, "serving": 3}
PREFIX_THREADS = 1


def smoke_data(cell):
    """The cell's data as ``chip_smoke.py`` phase 31 makes it."""
    if cell in ("headline", "headline_l2"):
        X, z = cs.headline_latent()
        label = (z > 0) if cell == "headline" else z
        return X, label.astype(np.float32)
    if cell == "small_data":
        return cs.small_data()
    return cs.serve_train_data(np.random.RandomState(11))


@pytest.fixture(scope="module")
def records():
    return {c: ref.load_record(c) for c in CELLS}


@pytest.mark.parametrize("cell", CELLS)
def test_record_data_and_parameters_are_the_smokes(cell, records):
    rec = records[cell]
    data = smoke_data(cell)
    assert ref.data_sha256(*data) == rec["data"]["sha256"]
    assert ref.data_sha256(*ref.cell_data(cell)) == rec["data"]["sha256"]
    params, rounds, stop = SMOKE[cell]
    assert rec["params"] == params
    assert rec["rounds"] == rounds
    assert rec["early_stopping_rounds"] == stop
    assert rec["reference"]["env"] == ref.reference_env(cell)
    assert rec["reference"]["env"]["LGBM_TPU_HIST_BACKEND"] == "compact"
    assert len(rec["tree_digests"]) == rec["iterations"]
    if stop is None:
        assert rec["iterations"] == rounds


@pytest.mark.parametrize("cell", CELLS)
def test_record_model_round_trips(cell, records):
    """The model text parses to the record's per-tree and tree digests,
    ``model_flip_report`` of the record against itself is identical, and
    the sample rows' host-walk scores are the parsed trees'."""
    rec = records[cell]
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
    X = ref.cell_data(cell)[0]
    rows = np.asarray(rec["sample"]["rows"])
    assert len(rows) == ref.SAMPLE_ROWS
    np.testing.assert_array_equal(ref.host_raw(trees, X[rows]),
                                  ref.from_hex(rec["sample"]["host_raw"]))
    # the JAX package's own predictor sums in f32 on its device
    np.testing.assert_allclose(ref.from_hex(rec["sample"]["raw_score"]),
                               ref.from_hex(rec["sample"]["host_raw"]),
                               rtol=tol("f32_accum_5x"),
                               atol=tol("f32_accum_5x"))


@pytest.mark.parametrize("cell", CELLS)
def test_port_prefix_equals_record(cell, records):
    """The port on the CPU at the record's full size: its first trees are
    the record's, or (a binary cell, ROADMAP C8) part from them at a
    near-tie only."""
    rec = records[cell]
    threads = torch.get_num_threads()
    torch.set_num_threads(PREFIX_THREADS)
    try:
        bst, _ = ref.train(tlgb, cell, PREFIX[cell], device="cpu")
    finally:
        torch.set_num_threads(threads)
    got = ref.tree_digests(bst._gbdt.models)
    assert len(got) == PREFIX[cell]
    if got == rec["tree_digests"][:len(got)]:
        return
    assert ref.CELLS[cell]["label"] == "binary", (
        f"{cell}: the port's L2 trees are not the JAX package's")
    rep = model_flip_report(rec["model"], bst.model_to_string())
    assert rep["near_tie"], (f"{cell}: the port parts from the record "
                             f"other than at a near-tie: {rep}")
    assert rep["max_leaf_value_gap"] <= tol("envelope_value_noise"), rep


def _pairwise_one_by_one(a, lo, n):
    """numpy 2.0's ``pairwise_sum``, one f32 add at a time."""
    if n < 8:
        acc = np.float32(0)
        for i in range(n):
            acc = np.float32(acc + a[lo + i])
        return acc
    if n <= 128:
        r = [a[lo + j] for j in range(8)]
        i = 8
        while i < n - n % 8:
            for j in range(8):
                r[j] = np.float32(r[j] + a[lo + i + j])
            i += 8
        acc = np.float32(np.float32(np.float32(r[0] + r[1])
                                    + np.float32(r[2] + r[3]))
                         + np.float32(np.float32(r[4] + r[5])
                                      + np.float32(r[6] + r[7])))
        for k in range(i, n):
            acc = np.float32(acc + a[lo + k])
        return acc
    half = n // 2
    half -= half % 8
    return np.float32(_pairwise_one_by_one(a, lo, half)
                      + _pairwise_one_by_one(a, lo + half, n - half))


@pytest.mark.parametrize("n", [1, 7, 129, 1000, 8192, 20011])
def test_host_sum_is_one_fixed_order(n):
    """The port's host label sums (init scores) add in numpy 2.0's order
    (8,192-value buffers, each a pairwise sum, added in order), written
    out here one add at a time, whatever numpy the host has."""
    from lightgbm_tpu_torch.objective.objectives import host_sum
    a = (np.random.RandomState(n).normal(size=n) * 3 + 0.5).astype(
        np.float32)
    want = np.float32(0)
    for lo in range(0, n, 8192):
        want = np.float32(want + _pairwise_one_by_one(a, lo,
                                                      min(8192, n - lo)))
    assert np.float32(host_sum(a)).tobytes() == want.tobytes()


def test_l2_init_score_is_the_references():
    """The headline latent's L2 init score: the JAX package's label mean
    (numpy 2.0's order), bitwise.  Summed in another order it is not: a
    newer numpy on an AVX-512 host rounded it to the f64 mean's nearest
    f32 (0x1.521fdep-8 against 0x1.521fd4p-8), and the card's model
    parted from the record at tree 0."""
    import lightgbm_tpu.objective.objectives as jobj
    from lightgbm_tpu_torch.objective.objectives import host_mean
    X, z = cs.headline_latent()
    z32 = z.astype(np.float32)
    stand_in = type("Labels", (), {"_label_np": z32, "_weight_np": None})
    ref_mean = jobj.ObjectiveFunction._host_label_mean(stand_in)
    assert float(host_mean(z32)).hex() == float(ref_mean).hex()
    assert float(np.float32(z.astype(np.float32).astype(np.float64).mean())
                 ).hex() != float(host_mean(z32)).hex()
    bst = tlgb.train(dict(cs.FULLSIZE_L2_PARAMS, num_leaves=2),
                     tlgb.Dataset(X[:, :1], label=z32), 1, device="cpu")
    assert float(bst._gbdt.init_score_value).hex() == float(ref_mean).hex()


@pytest.mark.parametrize("mode", ["int8", "int8h", "int8hh"])
def test_quantizer_divides_as_the_reference(mode):
    """A row within an ulp of a half quantizes as the JAX package's does:
    ``x * (127 / scale)`` with the quotient rounded once.  torch's ``127.0
    / tensor`` multiplies by the reciprocal instead (0x1.a5f9aep+3 against
    0x1.a5f9acp+3 here), which put this row at 15.5 and rounded it to 16:
    one row of the 1M-row L2 headline's tree 6, whose leaf values then
    parted from the record on the CPU and on the card alike."""
    import jax
    import jax.numpy as jnp
    from lightgbm_tpu.ops.pallas_histogram import pack_values_q as jpack
    from lightgbm_tpu_torch.ops.histogram import pack_values_q as tpack
    g = np.array([float.fromhex("0x1.34304cp+3"),
                  float.fromhex("0x1.2ce89ap+0")], np.float32)
    h = np.ones(2, np.float32)
    tv, ts_ = tpack(torch.from_numpy(g), torch.from_numpy(h), mode, 2)
    # jitted, as the JAX package's tree build runs it (its residual is a
    # fused multiply-add only when compiled)
    jv, js_ = jax.jit(lambda a, b: jpack(a, b, mode, row_tile=1))(
        jnp.asarray(g), jnp.asarray(h))
    assert tv[0].tolist() == [127, 15]
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv)[:, :2])
    np.testing.assert_array_equal(ts_.numpy(), np.asarray(js_))
