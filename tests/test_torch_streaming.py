"""Streamed out-of-core training in both packages at toy size on the CPU.

The JAX side streams with its seeded kernel folds in Pallas interpret
mode (``LGBM_TPU_HIST_BACKEND=pallas`` for the wide kernel K5,
``compact`` for the leaf-compacted K3, and ``LGBM_TPU_SPLIT_INTERPRET=1``
for its split kernel; its CPU default, the scatter fold, sums unquantized
values and builds another model).  The port runs its kernels' plain
versions.  12,000 rows stream in blocks of 8,192 (two blocks, the second
padded).

On the quantized modes the port's streamed model (digest with scores)
equals its in-memory model and the JAX package's streamed model.  One
exception is explained, not hidden: from the second iteration the
binary gradients differ by an ulp between ``torch.sigmoid`` and XLA's
logistic on about 10% of the rows, which can move an int8 code and so a
leaf value by a few ulps; there the JAX comparison accepts the same
trees with leaf values within ``tol("f32_eps_few")``, or a first
divergence ``model_flip_report`` classifies as a near-tie.  The L2
objective has no such step and is held bitwise on both kernels.
"""
import numpy as np
import pytest
import torch

from tools.numcheck.tolerance_registry import tol

from lightgbm_tpu.boosting.streaming import StreamTrainer as JStream
from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.io.dataset import BinnedDataset as JDataset
from lightgbm_tpu.io.dataset import Metadata as JMetadata
from lightgbm_tpu.parallel.envelope import model_flip_report

import lightgbm_tpu_torch as tlgb
from lightgbm_tpu_torch.boosting.streaming import StreamTrainer
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.io.dataset import BinnedDataset, Metadata
from lightgbm_tpu_torch.learner.serial import STREAM_CHUNK
from lightgbm_tpu_torch.ops import compact as t_compact
from lightgbm_tpu_torch.ops import histogram as t_hist
from lightgbm_tpu_torch.ops import route as t_route

torch.set_num_threads(1)   # tiny tensors: more threads only spin

N, F = 12000, 6
ITERS = 3
BASE = {"objective": "binary", "num_leaves": 15, "max_bin": 63,
        "learning_rate": 0.1, "verbose": -1}


def _data(seed=7, n=N, weights=False):
    rng = np.random.RandomState(seed)
    X = rng.normal(size=(n, F))
    y = (X[:, 0] + 0.5 * X[:, 1] + rng.normal(scale=0.3, size=n) > 0
         ).astype(np.float32)
    w = rng.uniform(0.5, 2.0, size=n).astype(np.float32) if weights else None
    return X, y, w


def _resident(X, y, w, params):
    cfg = Config.from_params(params)
    md = Metadata()
    md.set_field("label", y)
    if w is not None:
        md.set_field("weight", w)
    return cfg, BinnedDataset.from_raw(X, cfg, metadata=md)


def _stream(params, X, y, w=None, block_rows=STREAM_CHUNK, **kw):
    cfg, res = _resident(X, y, w, params)
    tr = StreamTrainer(cfg, res, block_rows=block_rows, device="cpu", **kw)
    assert len(tr.blocks) > 1, "parity must exercise several blocks"
    return tr, tr.train(ITERS)


def _jax_stream(monkeypatch, backend, params, X, y, w=None):
    monkeypatch.setenv("LGBM_TPU_HIST_BACKEND", backend)
    monkeypatch.setenv("LGBM_TPU_SPLIT_INTERPRET", "1")
    cfg = JConfig.from_params(params)
    md = JMetadata()
    md.set_field("label", y)
    if w is not None:
        md.set_field("weight", w)
    tr = JStream(cfg, JDataset.from_raw(X, cfg, metadata=md),
                 block_rows=STREAM_CHUNK)
    assert tr.backend == backend
    return tr.train(ITERS)


def _in_memory(params, X, y, w=None):
    return tlgb.train(dict(params), tlgb.Dataset(X, label=y, weight=w),
                      num_boost_round=ITERS, device="cpu")._gbdt


CASES = {
    # K5 on every wave (15 leaves: 8-slot tail)
    "wide_binary": (dict(BASE), False, "pallas", "wide", True),
    # 127 leaves: the 64-slot tail takes the seeded K3
    "compact_binary": (dict(BASE, num_leaves=127), False, "compact",
                       "compact", False),
    "wide_l2_weights": (dict(BASE, objective="regression"), True, "pallas",
                        "wide", True),
    "compact_l2_weights": (dict(BASE, objective="regression",
                                num_leaves=127), True, "compact",
                           "compact", True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_streamed_matches_in_memory_and_reference(monkeypatch, case):
    params, weighted, jax_backend, backend, jax_bitwise = CASES[case]
    X, y, w = _data(weights=weighted)
    if params["objective"] == "regression":
        y = (X[:, 0] + 0.5 * X[:, 1]).astype(np.float32)
    wrappers = (t_hist.hist_active_raw, t_compact.hist_compact_raw,
                t_route.route_rows_raw, t_route.route_rows_values_raw)
    before = [f.plain_calls for f in wrappers]
    tr, st = _stream(params, X, y, w)
    moved = [f.plain_calls > b for f, b in zip(wrappers, before)]
    assert moved == [backend == "wide", backend == "compact", True, True]
    assert tr.fold.backend == backend and tr.fold.hist_mode == "int8h"
    assert st.iter == ITERS
    mem = _in_memory(params, X, y, w)
    assert st.digest() == mem.digest()
    assert st.save_model_to_string() == mem.save_model_to_string()
    ref = _jax_stream(monkeypatch, jax_backend, params, X, y, w)
    if jax_bitwise:
        assert st.digest() == ref.digest()
    else:
        rep = model_flip_report(ref.save_model_to_string(),
                                st.save_model_to_string())
        assert rep["near_tie"], rep
        if rep["flip_tree"] is None:
            assert rep["max_leaf_value_gap"] <= tol("f32_eps_few"), rep


@pytest.mark.parametrize("mode", ["int8h", "hhilo"])
def test_block_size_invariance(mode):
    X, y, _ = _data(seed=11, n=3 * STREAM_CHUNK + 123)
    params = dict(BASE, hist_mode=mode)
    d1 = _stream(params, X, y)[1].digest()
    tr, st = _stream(params, X, y, block_rows=2 * STREAM_CHUNK)
    assert tr.fold.hist_mode == mode
    assert st.digest() == d1


def test_hhilo_matches_reference(monkeypatch):
    """The float fold (K5 on bf16-rounded values, fixed order) against
    the reference's streamed float fold: the same trees, leaf values
    within ``tol("f32_eps_few")``, or a first divergence that is a
    near-tie."""
    X, y, _ = _data()
    params = dict(BASE, hist_mode="hhilo")
    before = t_hist.hist_active_float_raw.plain_calls
    tr, st = _stream(params, X, y)
    assert t_hist.hist_active_float_raw.plain_calls > before
    assert tr.fold.hist_mode == "hhilo" and not tr.fold.quantized
    ref = _jax_stream(monkeypatch, "pallas", params, X, y)
    rep = model_flip_report(ref.save_model_to_string(),
                            st.save_model_to_string())
    assert rep["near_tie"], rep
    if rep["flip_tree"] is None:
        assert rep["max_leaf_value_gap"] <= tol("f32_eps_few"), rep


def test_pipeline_off_same_model():
    X, y, _ = _data(seed=3)
    on = _stream(BASE, X, y)[1].digest()
    off = _stream(BASE, X, y, pipeline=False)[1].digest()
    assert on == off


@pytest.mark.parametrize("rows,blocks", [(None, 1), ("5000", 2),
                                         ("8192", 2), ("8193", 1)],
                         ids=["unset", "5000", "8192", "8193"])
def test_stream_rows_env_sets_the_block_size(monkeypatch, rows, blocks):
    """``LGBM_TPU_STREAM_ROWS`` is the block size when the caller passes
    none, rounded up to whole ``STREAM_CHUNK`` chunks (1,048,576 rows when
    unset); it changes the block count and not the model."""
    X, y, _ = _data(seed=3)
    if rows is None:
        monkeypatch.delenv("LGBM_TPU_STREAM_ROWS", raising=False)
    else:
        monkeypatch.setenv("LGBM_TPU_STREAM_ROWS", rows)
    cfg, res = _resident(X, y, None, BASE)
    tr = StreamTrainer(cfg, res, device="cpu")
    assert len(tr.blocks) == blocks
    assert tr.R % STREAM_CHUNK == 0
    # an explicit block size wins over the variable
    assert len(StreamTrainer(cfg, res, block_rows=STREAM_CHUNK,
                             device="cpu").blocks) == 2
    assert tr.train(ITERS).digest() == _stream(BASE, X, y)[1].digest()


@pytest.mark.parametrize("value,on", [("0", False), ("off", False),
                                      ("FALSE", False), ("1", True)])
def test_stream_pipeline_env(monkeypatch, value, on):
    """``LGBM_TPU_STREAM_PIPELINE=0`` (``off``, ``false``) is
    ``pipeline=False``, the serial escape; the model is the same."""
    X, y, _ = _data(seed=3)
    monkeypatch.setenv("LGBM_TPU_STREAM_PIPELINE", value)
    tr, st = _stream(BASE, X, y)
    assert tr.pipeline is on
    monkeypatch.delenv("LGBM_TPU_STREAM_PIPELINE")
    assert st.digest() == _stream(BASE, X, y, pipeline=not on)[1].digest()


# leaves per float mode: 15 runs every wave through the float K1 (the
# 8-slot tail), 127 through the float K3 (at <= 65,536 rows every wave
# has the 64-slot tail width)
FLOAT_LEAVES = {"bf16": 15, "hilo": 127, "hhilo": 127, "ghilo": 15}


@pytest.mark.parametrize("mode", t_hist.FLOAT_MODES)
def test_float_mode_in_memory_matches_stream(mode):
    """In memory the float modes take the float K1 (waves of <= 32
    slots) or the float K3 (wider waves), both in the float K5's fixed
    order; the streamed fold takes the float K5 on every wave.  The two
    models are bitwise equal, scores included."""
    X, y, _ = _data()
    params = dict(BASE, hist_mode=mode, num_leaves=FLOAT_LEAVES[mode])
    kernel = (t_hist.hist_route_float_raw if FLOAT_LEAVES[mode] <= 31
              else t_compact.hist_compact_float_raw)
    before = kernel.plain_calls
    mem = _in_memory(params, X, y)
    assert kernel.plain_calls > before
    tr, st = _stream(params, X, y)
    assert tr.fold.hist_mode == mode and not tr.fold.quantized
    assert st.digest() == mem.digest()
    assert st.save_model_to_string() == mem.save_model_to_string()


@pytest.mark.parametrize("extra,match", [
    ({"bagging_fraction": 0.5, "bagging_freq": 1}, "bagging"),
    ({"boosting": "dart"}, "boosting"),
    ({"boosting": "goss"}, "boosting"),
    ({"objective": "lambdarank"}, "rank"),
    ({"tree_learner": "data", "num_machines": 2}, "num_machines"),
    ({"tree_learner": "feature"}, "tree_learner"),
], ids=["bagging", "dart", "goss", "ranking", "data_parallel",
        "feature_parallel"])
def test_descoped_configs_raise(extra, match):
    X, y, _ = _data(n=STREAM_CHUNK)
    cfg, res = _resident(X, y, None, dict(BASE, **extra))
    with pytest.raises(ValueError, match=match):
        StreamTrainer(cfg, res, device="cpu")
