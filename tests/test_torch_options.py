"""Options of the JAX package in lightgbm_tpu_torch.

A 2-D ``mesh_shape`` [d, f] (the data x feature mesh) trains across
d * f ranks (``tests/test_torch_mesh2d.py``); in a process of its own
a data-parallel ``lgb.train`` raises, naming the ranks it needs,
instead of training something else, and a stream takes ``d`` protocol
shards, the model of ``mesh_shape`` [d].  ``input_model`` in ``lgb.train``'s parameters
loads that model into the booster, as the JAX package's
``create_boosting`` does (its trees first, the training scores without
them, ROADMAP C33), and ``valid_data`` files, which only the
command-line application reads, are ignored by ``lgb.train`` as by the
JAX package's: both held to the JAX package here (its kernels in Pallas
interpret mode).  ``snapshot_freq`` and ``resume_from`` work in memory
(``tests/test_torch_snapshot.py``, and across processes
``tests/test_torch_elastic_mp.py``) and streamed (barrier snapshots,
``tests/test_torch_elastic_train.py``), and so does ``pred_early_stop``
(``tests/test_torch_model_surface.py``); ``telemetry_output`` writes the
trace in memory and streamed (``tests/test_torch_telemetry.py``)."""
import numpy as np
import pytest
import torch

import lightgbm_tpu as jlgb

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
    ({"mesh_shape": "2,2", "tree_learner": "data"}, "needs 4 ranks"),
], ids=["mesh_shape"])
def test_unported_option_raises(option, match):
    X, y = _data()
    params = dict(BASE, **option)
    with pytest.raises(ValueError, match=match):
        tlgb.train(dict(params), tlgb.Dataset(X, label=y),
                   num_boost_round=1, device="cpu")
    # a stream takes the data axis as its protocol shards
    st = _stream(params, X, y)
    assert st.S == 2
    one_d = _stream(dict(params, mesh_shape="2"), X, y)
    assert st.train(3).digest() == one_d.train(3).digest()
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


# the JAX package's kernels and the port's agree bitwise on these
# (tests/test_torch_engine.py's configuration)
PARITY = {"num_leaves": 15, "max_bin": 63, "learning_rate": 0.1,
          "min_data_in_leaf": 20, "verbose": -1}


def _parity_data():
    rng = np.random.RandomState(0)
    X = rng.normal(size=(2000, 6)).astype(np.float32)
    z = X[:, 0] * 2 + X[:, 1] - X[:, 2] + rng.normal(size=2000)
    return X, z.astype(np.float32)


@pytest.fixture
def reference_kernels(monkeypatch):
    monkeypatch.setenv("LGBM_TPU_HIST_BACKEND", "compact")
    monkeypatch.setenv("LGBM_TPU_SPLIT_INTERPRET", "1")


@pytest.mark.parametrize("objective", ["binary", "regression"])
def test_input_model_in_params_matches_reference(objective, tmp_path,
                                                 reference_kernels):
    """``input_model`` in the parameters: the booster starts from the
    file's trees (iterations counted on from them) and grows the new
    ones on training scores that hold the init score only, as the JAX
    package's (ROADMAP C33): the model text, digest and training scores
    bitwise the JAX package's."""
    X, z = _parity_data()
    y = (z > 0).astype(np.float32) if objective == "binary" else z
    params = dict(PARITY, objective=objective)
    path = str(tmp_path / "first.txt")
    tlgb.train(dict(params), tlgb.Dataset(X, label=y), num_boost_round=2,
               device="cpu").save_model(path)
    p = dict(params, input_model=path)
    jb = jlgb.train(dict(p), jlgb.Dataset(X, label=y), num_boost_round=3)
    tb = tlgb.train(dict(p), tlgb.Dataset(X, label=y), num_boost_round=3,
                    device="cpu")
    assert tb.current_iteration() == jb.current_iteration == 5
    assert tb.model_to_string() == jb.model_to_string()
    assert tb.digest() == jb.digest()
    np.testing.assert_array_equal(tb._gbdt.scores.numpy(),
                                  np.asarray(jb._gbdt.scores))
    # the loaded trees come first, unchanged
    first = tlgb.Booster(model_file=path, device="cpu").model_to_string()
    assert _trees(tb.model_to_string())[:2] == _trees(first)


def _trees(text):
    return [t.strip() for t in
            text.split("feature importances:")[0].split("Tree=")[1:]]


def test_valid_data_ignored_by_train(tmp_path, reference_kernels):
    """``valid_data`` in ``lgb.train``'s parameters changes nothing (a
    path that does not exist is not read), as in the JAX package: both
    give the model trained without it."""
    X, z = _parity_data()
    y = (z > 0).astype(np.float32)
    params = dict(PARITY, objective="binary")
    p = dict(params, valid_data=str(tmp_path / "absent.csv"))
    jb = jlgb.train(dict(p), jlgb.Dataset(X, label=y), num_boost_round=3)
    tb = tlgb.train(dict(p), tlgb.Dataset(X, label=y), num_boost_round=3,
                    device="cpu")
    plain = tlgb.train(dict(params), tlgb.Dataset(X, label=y),
                       num_boost_round=3, device="cpu")
    assert tb.digest() == plain.digest()
    assert tb.model_to_string() == jb.model_to_string()
    assert tb.digest() == jb.digest()
