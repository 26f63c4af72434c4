"""Options the JAX package acts on and lightgbm_tpu_torch does not read
yet raise, in memory (``lgb.train``) and streamed (``StreamTrainer``),
instead of training or predicting something else: ``snapshot_freq``
(the reference writes snapshots), ``pred_early_stop`` (the reference
predicts with early stopping) and a non-empty ``mesh_shape`` (the
reference's mesh path)."""
import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as tlgb
from lightgbm_tpu_torch.boosting.streaming import StreamTrainer
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.io.dataset import BinnedDataset, Metadata

torch.set_num_threads(1)   # tiny tensors: more threads only spin

BASE = {"objective": "binary", "num_leaves": 7, "verbose": -1}


@pytest.mark.parametrize("option,match", [
    ({"snapshot_freq": 2}, "A6"),
    ({"pred_early_stop": True}, "A6"),
    ({"mesh_shape": "2"}, "A11"),
], ids=["snapshot_freq", "pred_early_stop", "mesh_shape"])
def test_unported_option_raises(option, match):
    rng = np.random.RandomState(0)
    X = rng.normal(size=(500, 4))
    y = (X[:, 0] > 0).astype(np.float32)
    params = dict(BASE, **option)
    with pytest.raises(NotImplementedError, match=match):
        tlgb.train(dict(params), tlgb.Dataset(X, label=y),
                   num_boost_round=1, device="cpu")
    cfg = Config.from_params(params)
    md = Metadata()
    md.set_field("label", y)
    with pytest.raises(NotImplementedError, match=match):
        StreamTrainer(cfg, BinnedDataset.from_raw(X, cfg, metadata=md),
                      device="cpu")
    # the defaults stay accepted
    tlgb.train(dict(BASE), tlgb.Dataset(X, label=y), num_boost_round=1,
               device="cpu")
