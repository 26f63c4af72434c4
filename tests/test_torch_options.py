"""Options the JAX package acts on and lightgbm_tpu_torch does not read
yet raise, instead of training something else, each naming its ROADMAP
item: ``input_model`` (read by the command-line application, A14's
second half; ``train`` takes ``init_model``) and a 2-D ``mesh_shape``
(the data x feature mesh, A11's remainder; a 1-D one trains,
``tests/test_torch_multiprocess.py``) in memory (``lgb.train``) and
streamed (``StreamTrainer``).  ``snapshot_freq`` and ``resume_from``
work in memory (``tests/test_torch_snapshot.py``, and across processes
``tests/test_torch_elastic_mp.py``) and streamed (barrier snapshots,
``tests/test_torch_elastic_train.py``), and so does
``pred_early_stop`` (``tests/test_torch_model_surface.py``);
``telemetry_output`` writes the trace in memory and streamed
(``tests/test_torch_telemetry.py``).
``valid_data`` files, which only the command-line application reads,
raise in ``lgb.train`` (A14's second half)."""
import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as tlgb
from lightgbm_tpu_torch.boosting.streaming import StreamTrainer
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.io.dataset import BinnedDataset, Metadata

torch.set_num_threads(1)   # tiny tensors: more threads only spin

BASE = {"objective": "binary", "num_leaves": 7, "verbose": -1}


def _data():
    rng = np.random.RandomState(0)
    X = rng.normal(size=(500, 4))
    y = (X[:, 0] > 0).astype(np.float32)
    return X, y


def _stream(params, X, y):
    cfg = Config.from_params(params)
    md = Metadata()
    md.set_field("label", y)
    return StreamTrainer(cfg, BinnedDataset.from_raw(X, cfg, metadata=md),
                         device="cpu")


@pytest.mark.parametrize("option,match", [
    ({"input_model": "model.txt"}, "A14"),
    ({"mesh_shape": "2,2"}, "A11"),
], ids=["input_model", "mesh_shape"])
def test_unported_option_raises(option, match):
    X, y = _data()
    params = dict(BASE, **option)
    with pytest.raises(NotImplementedError, match=match):
        tlgb.train(dict(params), tlgb.Dataset(X, label=y),
                   num_boost_round=1, device="cpu")
    with pytest.raises(NotImplementedError, match=match):
        _stream(params, X, y)
    # the defaults stay accepted
    tlgb.train(dict(BASE), tlgb.Dataset(X, label=y), num_boost_round=1,
               device="cpu")


@pytest.mark.parametrize("option", [
    {"snapshot_freq": 2}, {"resume_from": "auto"},
], ids=["snapshot_freq", "resume_from"])
def test_stream_snapshot_option_raises(option, tmp_path):
    """The stream takes both since elastic training: ``snapshot_freq``
    commits barrier snapshots under ``output_model`` and ``resume_from``
    continues from the newest one, ending on the uninterrupted model."""
    from lightgbm_tpu_torch.boosting import snapshot as snap
    X, y = _data()
    prefix = str(tmp_path / "m.txt")
    params = dict(BASE, output_model=prefix)
    ds = _stream(params, X, y).src._ds
    full = tlgb.train_streaming(params, ds, num_boost_round=4, device="cpu")
    if "snapshot_freq" in option:
        bst = tlgb.train_streaming(dict(params, **option), ds,
                                   num_boost_round=4, device="cpu")
        assert [it for it, _ in snap.list_barriers(prefix)] == [4, 2]
    else:
        tlgb.train_streaming(dict(params, snapshot_freq=2), ds,
                             num_boost_round=2, device="cpu")
        bst = tlgb.train_streaming(dict(params, **option), ds,
                                   num_boost_round=4, device="cpu")
    assert bst.iter == 4
    assert bst.digest() == full.digest()


@pytest.mark.parametrize("option", [
    {"snapshot_freq": 2}, {"pred_early_stop": True},
    {"telemetry_output": "trace.jsonl"},
], ids=["snapshot_freq", "pred_early_stop", "telemetry_output"])
def test_lifted_option_trains_in_memory(option, tmp_path):
    """The options this package reads since the model surface: training
    takes them in memory (snapshots under ``output_model``; prediction
    early stopping at predict time); ``telemetry_output`` (since the
    telemetry port) in memory, writing its trace, and in a stream."""
    from lightgbm_tpu_torch import obs
    X, y = _data()
    option = {k: str(tmp_path / v) if k == "telemetry_output" else v
              for k, v in option.items()}
    params = dict(BASE, output_model=str(tmp_path / "m.txt"), **option)
    try:
        bst = tlgb.train(params, tlgb.Dataset(X, label=y),
                         num_boost_round=2, device="cpu")
        if "telemetry_output" in option:
            obs.reset()
            assert (tmp_path / "trace.jsonl").stat().st_size > 0
            _stream(dict(BASE, **option), X, y).train(1)
    finally:
        obs.reset()
    assert bst.current_iteration() == 2
    assert np.isfinite(bst.predict(X)).all()


def test_valid_data_files_raise():
    X, y = _data()
    with pytest.raises(NotImplementedError, match="A14"):
        tlgb.train(dict(BASE, valid_data="valid.csv"),
                   tlgb.Dataset(X, label=y), num_boost_round=1,
                   device="cpu")
