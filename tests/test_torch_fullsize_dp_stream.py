"""The JAX package's full-size two-rank and streamed models, recorded,
and the port held to them.

``tests/data/torch_fullsize/<cell>.json.gz`` (``tools/torch_fullsize_
ref.py``):

* ``dp2_l2``: the headline's 1M x 28 rows, objective ``regression`` on
  the latent, ``tree_learner`` ``data`` from a zero init score, 8
  iterations, trained by the JAX package on a mesh of 2 CPU devices
  (``chip_smoke.py`` phase 31 holds two ranks of the card to it);
* ``stream``: phase 8's identity stream, ``ingest_synthetic(seed=3)``'s
  4,194,304 x 28 pre-binned rows, 63 leaves, 1,048,576-row blocks, 2
  iterations through ``train_streaming``.  The store holds no raw
  values, so the record keeps the sample rows' training scores.

Each record is checked whole; the port's ``ingest_synthetic`` writes the
store whose bytes the record hashed; and the port on the CPU at full
size trains the first tree of each, bitwise the record's: ``dp2_l2`` as
a gloo world of two ranks (``tests/torch_dist_worker.py``; L2 has no
transcendental), and the stream's (at iteration 0 every row has the one
init score, so torch's and XLA's sigmoids give the same gradients; from
iteration 1 they can part on some rows, ROADMAP C8, though on this
store both of the record's trees are the port's on the CPU).
"""
import numpy as np
import pytest
import torch

from tests.fullsize_checks import (check_prefix, check_round_trip,
                                   check_smoke_constants)
from tests.torch_dist_worker import run_world
from tools import torch_fullsize_ref as ref

import chip_smoke as cs
import lightgbm_tpu_torch as tlgb
from lightgbm_tpu_torch.config import Config

torch.set_num_threads(1)   # one worker, one thread: the file's budget

PREFIX = 1


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    """The port's store of the stream cell, as phase 8 writes it."""
    return ref.stream_store(tlgb.outofcore, Config,
                            str(tmp_path_factory.mktemp("stream")))


def test_dp2_record_data_and_parameters_are_the_smokes():
    rec = ref.load_record("dp2_l2")
    X, z = cs.headline_latent()
    assert ref.data_sha256(X, z.astype(np.float32)) == rec["data"]["sha256"]
    check_smoke_constants("dp2_l2", rec, cs.FULLSIZE_DP_PARAMS,
                          cs.FULLSIZE_DP_ITERS, None)
    assert cs.FULLSIZE_DP_WORLD == ref.DP_WORLD == rec["reference"]["devices"]
    assert rec["reference"]["env"]["mesh_shape"] == str(cs.FULLSIZE_DP_WORLD)


def test_dp2_record_model_round_trips():
    check_round_trip("dp2_l2", ref.load_record("dp2_l2"),
                     cs.headline_latent()[0])


def test_dp2_two_ranks_equal_record(tmp_path):
    """A gloo world of two ranks on the CPU, each its contiguous half of
    the rows: both ranks' first tree is the record's, bitwise."""
    rec = ref.load_record("dp2_l2")
    X, y, _, _ = ref.cell_data("dp2_l2")
    data = str(tmp_path / "xy.npz")
    np.savez(data, X=X, y=y)
    res = run_world([{"name": "dp2", "kind": "train", "input": data,
                      "params": dict(cs.FULLSIZE_DP_PARAMS),
                      "rounds": PREFIX}], cs.FULLSIZE_DP_WORLD,
                    str(tmp_path / "out"))
    (_, a), (_, b) = res["dp2"]
    assert "error" not in a and "error" not in b, a.get("traceback")
    assert a["model"] == b["model"]
    assert a["init_score"] == 0.0
    trees = tlgb.Booster(model_str=a["model"], device="cpu")._gbdt.models
    assert len(trees) == PREFIX
    check_prefix("dp2_l2", rec, trees, a["model"], bitwise=True)


def test_stream_store_is_the_records(store):
    """The port's ``ingest_synthetic`` writes the JAX package's bytes: the
    bins and labels the record hashed."""
    rec = ref.load_record("stream")
    assert ref.store_sha256(store) == rec["data"]["sha256"]
    assert store.n == rec["data"]["rows"] == cs.STREAM_IDENT_ROWS
    assert rec["data"]["block_rows"] == cs.STREAM_BLOCK
    assert rec["data"]["features"] == cs.STREAM_FEATURES
    check_smoke_constants("stream", rec, cs.STREAM_PARAMS, cs.STREAM_ITERS,
                          None)


def test_stream_record_model_round_trips():
    rec = ref.load_record("stream")
    check_round_trip("stream", rec)
    scores = ref.from_hex(rec["sample"]["scores"])
    assert len(scores) == ref.SAMPLE_ROWS and np.isfinite(scores).all()
    assert rec["metrics"]["train_auc"] >= cs.AUC_GATE


def test_stream_prefix_equals_record(store):
    rec = ref.load_record("stream")
    g, _ = ref.train_stream(tlgb.train_streaming, store, PREFIX,
                            device="cpu")
    assert len(g.models) == PREFIX
    check_prefix("stream", rec, g.models, g.save_model_to_string(),
                 bitwise=True)
