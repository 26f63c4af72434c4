"""The JAX package's full-size float headline model, recorded, and the
port held to it.

``tests/data/torch_fullsize/headline_float.json.gz``
(``tools/torch_fullsize_ref.py``) is ``chip_smoke.py`` phase 6: the
headline's 1M x 28 rows and parameters with ``gpu_use_dp``, so the hilo
float histograms through the float K1 and K3, 8 iterations.  The record
is checked whole (its data and parameters are the script's, its model
text parses back to its digests and its sample rows' host-walk scores),
and the port on the CPU at full size trains its first two trees: the
record's, or a first divergence at a near-tie (ROADMAP C8: from
iteration 1 torch's and XLA's CPU sigmoids part on some rows; the float
histograms add in one order, C10) with the leaf values before it inside
the measured envelope.

Phases 17 and 19 train with ``evals_result`` or ``callbacks``, their
records without; phase 31 reuses their models because the port's model
does not depend on them, as the last test here shows.
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

PREFIX = 2


def test_record_data_and_parameters_are_the_smokes():
    rec = ref.load_record("headline_float")
    X, z = cs.headline_latent()
    assert ref.data_sha256(X, (z > 0).astype(np.float32)) \
        == rec["data"]["sha256"]
    assert ref.data_sha256(*ref.cell_data("headline_float")[:2]) \
        == rec["data"]["sha256"]
    check_smoke_constants("headline_float", rec,
                          dict(cs.HEADLINE_PARAMS, gpu_use_dp=True),
                          cs.FLOAT_ITERS, None)
    assert rec["data"]["rows"] == cs.HEADLINE_ROWS


def test_record_model_round_trips():
    check_round_trip("headline_float", ref.load_record("headline_float"),
                     cs.headline_latent()[0])


def test_port_prefix_equals_record():
    rec = ref.load_record("headline_float")
    bst, _ = ref.train(tlgb, "headline_float", PREFIX, device="cpu")
    assert bst._gbdt.hist_mode == "hilo"
    assert len(bst._gbdt.models) == PREFIX
    check_prefix("headline_float", rec, bst._gbdt.models,
                 bst.model_to_string(), bitwise=False)


@pytest.mark.parametrize("objective", ["multiclass", "lambdarank"])
def test_model_does_not_depend_on_evals_result_or_callbacks(objective):
    """Phases 17 and 19 train with ``evals_result`` or ``callbacks``, the
    records without (the JAX package then takes its fused-window loop,
    ROADMAP C3): the port's model, scores included, is the same either
    way, so phase 31 holds phase 17's and 19's models to the records."""
    rng = np.random.RandomState(0)
    X = rng.normal(size=(3000, 6)).astype(np.float32)
    z = X[:, 0] * 2 + X[:, 1] + rng.normal(size=3000)
    if objective == "multiclass":
        params = dict(cs.MC_PARAMS, num_leaves=15)
        ds = tlgb.Dataset(X, label=cs.class_labels(z, cs.MC_CLASSES),
                          params={"max_bin": 63})
    else:
        params = dict(cs.RANK_PARAMS, num_leaves=15,
                      min_sum_hessian_in_leaf=1, max_bin=63)
        rel = np.digitize(z, np.quantile(z, [0.55, 0.78, 0.92, 0.98]))
        ds = tlgb.Dataset(X, label=rel.astype(np.float32),
                          group=np.full(100, 30), params={"max_bin": 63})
    plain = tlgb.train(dict(params), ds, 4, device="cpu")
    ev, ends = {}, []
    watched = tlgb.train(dict(params), ds, 4, device="cpu",
                         valid_sets=[ds], valid_names=["training"],
                         evals_result=ev, callbacks=[ends.append],
                         verbose_eval=False)
    assert len(ends) == 4 and len(next(iter(ev["training"].values()))) == 4
    assert watched.digest() == plain.digest()
