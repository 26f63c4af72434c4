"""The JAX package's full-size multiclass model, recorded, and the port
held to it.

``tests/data/torch_fullsize/multiclass.json.gz``
(``tools/torch_fullsize_ref.py``) is ``chip_smoke.py`` phase 17's first
model: the headline's 1M x 28 rows, 5 classes from the latent's
quantiles, 255 leaves, ``max_bin`` 63, 8 iterations (40 trees).  The
record is checked whole (its data and parameters are the script's, its
model text parses back to its digests and its sample rows' host-walk
scores of every class), and the port on the CPU at full size trains its
first iteration (5 trees), bitwise the record's: every row starts from
the same scores, so the softmax gives the same probabilities in both
packages.  From iteration 1 torch's and XLA's CPU softmax differ by an
ulp on some rows (ROADMAP C8: 327,092 rows' gradients and 1,761 rows'
int8h quanta at iteration 1), and the port on the CPU parts from the
record at a near-tie (tools/torch_fullsize_ref.py --check cpu).
"""
import numpy as np
import torch

from tests.fullsize_checks import (check_prefix, check_round_trip,
                                   check_smoke_constants)
from tools import torch_fullsize_ref as ref

import chip_smoke as cs
import lightgbm_tpu_torch as tlgb

torch.set_num_threads(1)   # one worker, one thread: the file's budget

PREFIX = 1


def test_record_data_and_parameters_are_the_smokes():
    rec = ref.load_record("multiclass")
    X, z = cs.headline_latent()
    y = cs.class_labels(z, cs.MC_CLASSES)
    assert ref.data_sha256(X, y) == rec["data"]["sha256"]
    assert ref.data_sha256(*ref.cell_data("multiclass")[:2]) \
        == rec["data"]["sha256"]
    check_smoke_constants("multiclass", rec, cs.MC_PARAMS, cs.MC_ITERS,
                          None)
    assert rec["data"]["rows"] == cs.HEADLINE_ROWS
    assert len(rec["tree_digests"]) == cs.MC_CLASSES * cs.MC_ITERS
    # phase 17's gate: the loss ends at most this share of ln K
    assert rec["metrics"]["train_multi_logloss"] <= (
        cs.MC_LOSS_SHARE * np.log(cs.MC_CLASSES))


def test_record_model_round_trips():
    check_round_trip("multiclass", ref.load_record("multiclass"),
                     cs.headline_latent()[0])


def test_port_prefix_equals_record():
    rec = ref.load_record("multiclass")
    bst, _ = ref.train(tlgb, "multiclass", PREFIX, device="cpu")
    assert len(bst._gbdt.models) == PREFIX * cs.MC_CLASSES
    check_prefix("multiclass", rec, bst._gbdt.models,
                 bst.model_to_string(), bitwise=True)
