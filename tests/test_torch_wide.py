"""Wide bins and deep trees in lightgbm_tpu_torch, past the histogram
kernels' domain (groups of more than 256 bins, more than 1,024 leaves),
held against the JAX package's scatter backend at toy size on the CPU.

The JAX side runs with ``LGBM_TPU_HIST_BACKEND=compact`` and
``LGBM_TPU_SPLIT_INTERPRET=1``, which such a configuration leaves for
its XLA scatter (exact f32, rows in order), XLA routing and, under
65,536 rows, its split kernel.  The port's wide histogram sums each cell
in the same row order, so the L2 models and their scores are bitwise;
binary models (the sigmoid, ``tol("f32_eps_few")``) are equal or a near
tie by ``model_flip_report``.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import lightgbm_tpu as jlgb
from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.io.dataset import BinnedDataset as JDataset
from lightgbm_tpu.ops.pallas_histogram import hist_active_scatter
from lightgbm_tpu.ops.pallas_route import (route_rows_xla,
                                           route_rows_values_pallas)
from lightgbm_tpu.parallel.envelope import model_flip_report

import lightgbm_tpu_torch as tlgb
from lightgbm_tpu_torch.io.device import device_data_from_arrays, to_device
from lightgbm_tpu_torch.io.device import feature_meta_np
from lightgbm_tpu_torch.learner import serial as tserial
from lightgbm_tpu_torch.ops import histogram as t_hist
from lightgbm_tpu_torch.ops import route as t_route
from lightgbm_tpu_torch.serve import compile_model

torch.set_num_threads(1)   # tiny tensors: more threads only spin

WIDE = {"max_bin": 511, "num_leaves": 31, "min_data_in_leaf": 5}
DEEP = {"max_bin": 63, "num_leaves": 1100, "min_data_in_leaf": 1,
        "min_sum_hessian_in_leaf": 0.0}
# more than 1,024 slots a wave (the JAX package's round8(L / 2))
DEEPER = dict(DEEP, num_leaves=2100)


@pytest.fixture(autouse=True)
def _reference_kernels(monkeypatch):
    monkeypatch.setenv("LGBM_TPU_HIST_BACKEND", "compact")
    monkeypatch.setenv("LGBM_TPU_SPLIT_INTERPRET", "1")


def _data(objective, n=3000, f=6, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.normal(size=(n, f)).astype(np.float32)
    z = X[:, 0] * 2 + X[:, 1] - X[:, 2] + rng.normal(size=n)
    y = (z > 0) if objective == "binary" else z
    return X, y.astype(np.float32)


def _both(objective, config, rounds=4, valid=False, **kw):
    X, y = _data(objective)
    params = {"objective": objective, "learning_rate": 0.1, "verbose": -1,
              **config}
    out = []
    for lib, extra in ((jlgb, {}), (tlgb, {"device": "cpu"})):
        ds = lib.Dataset(X[:2400], label=y[:2400])
        vs = ([lib.Dataset(X[2400:], label=y[2400:], reference=ds)]
              if valid else None)
        out.append(lib.train(dict(params), ds, num_boost_round=rounds,
                             valid_sets=vs,
                             valid_names=["v"] if valid else None,
                             verbose_eval=False, **kw, **extra))
    return X, out


@pytest.mark.parametrize("config,rounds", [(WIDE, 4), (DEEP, 4),
                                           (DEEPER, 2)],
                         ids=["max_bin511", "leaves1100", "leaves2100"])
def test_l2_bitwise(config, rounds):
    _, (jb, tb) = _both("regression", config, rounds=rounds)
    assert tb.model_to_string() == jb.model_to_string()
    assert tb.digest() == jb.digest()
    nl = [t.num_leaves for t in tb._gbdt.models]
    assert max(nl) == config["num_leaves"]


@pytest.mark.parametrize("config", [WIDE, DEEP], ids=["max_bin511",
                                                     "leaves1100"])
def test_binary_matches_reference(config):
    _, (jb, tb) = _both("binary", config)
    if tb.digest(include_scores=False) != jb.digest(include_scores=False):
        rep = model_flip_report(jb.model_to_string(), tb.model_to_string())
        assert rep["near_tie"], rep


def test_backend_choice():
    X, y = _data("regression")
    ds = tlgb.Dataset(X, label=y, params={"max_bin": 511}).construct()
    dd = to_device(ds._constructed, "cpu")
    assert dd.bins_t.dtype == torch.int32 and dd.group_max_bins > 256
    assert tserial.resolve_backend(dd, 31) == "scatter"
    ds = tlgb.Dataset(X, label=y, params={"max_bin": 63}).construct()
    dd = to_device(ds._constructed, "cpu")
    assert dd.bins_t.dtype == torch.uint8
    assert tserial.resolve_backend(dd, 1100) == "scatter"
    assert tserial.resolve_backend(dd, 1024) == "compact"
    assert tserial.resolve_backend(dd, 31) == "fused"
    # a stream past the kernels' domain folds through the seeded wide
    # histogram: exact f32 whatever the hist mode, the carry unpacked as is
    A = tserial.wide_wave_slots(1100)
    fold = tserial.make_hist_fold_fn(dd, 1100, A, hist_mode="int8h")
    assert (fold.backend, fold.quantized) == ("scatter", False)
    acc = fold.init_acc()
    assert acc.shape == (A, dd.num_groups, 64, 3)
    assert acc.dtype == torch.float32 and not bool(acc.any())
    assert fold.unpack(acc) is acc


def test_leaves_131072_match_reference():
    """LightGBM's largest ``num_leaves``, 131,072 (65,536 slots a wave),
    takes the scatter backend with no slot cap and trains one iteration
    as the JAX package does.  With 3 columns at a 16-bin stride the grid
    is lane-unaligned: the JAX package keeps its XLA split scan and the
    port takes K6 (C4), so the models are equal or a near tie."""
    X, y = _data("regression", n=300, f=3)
    params = {"objective": "regression", "num_leaves": 131072,
              "max_bin": 15, "min_data_in_leaf": 1,
              "min_sum_hessian_in_leaf": 0.0, "learning_rate": 0.1,
              "verbose": -1}
    ds = tlgb.Dataset(X, label=y, params={"max_bin": 15}).construct()
    dd = to_device(ds._constructed, "cpu")
    assert tserial.wide_wave_slots(131072) == 65536
    assert tserial.resolve_backend(dd, 131072) == "scatter"
    jb = jlgb.train(dict(params), jlgb.Dataset(X, label=y),
                    num_boost_round=1, verbose_eval=False)
    tb = tlgb.train(dict(params), tlgb.Dataset(X, label=y),
                    num_boost_round=1, verbose_eval=False, device="cpu")
    assert tb._gbdt.models[0].num_leaves > 256
    if tb.digest(include_scores=False) != jb.digest(include_scores=False):
        rep = model_flip_report(jb.model_to_string(), tb.model_to_string())
        assert rep["near_tie"], rep


@pytest.mark.parametrize("shape", [(3000, 5, 511, 31, 16),
                                   (20000, 3, 1023, 255, 128),
                                   (5000, 4, 63, 2048, 1024)],
                         ids=["wide", "wider", "deep"])
def test_wide_hist_plain_is_reference_scatter(shape):
    """The wide histogram's plain version equals the reference's
    ``hist_active_scatter`` bitwise (both add in row order; values over
    eight decades, where another order shows), inactive slots zero."""
    n, G, mb, L, A = shape
    rs = np.random.RandomState(n)
    bins = rs.randint(0, mb, (n, G)).astype(np.int32)
    g = (rs.randn(n) * 10.0 ** rs.uniform(-5, 3, n)).astype(np.float32)
    h = (rs.rand(n) * 10.0 ** rs.uniform(-5, 3, n)).astype(np.float32)
    leaf = rs.randint(-1, L, n).astype(np.int32)
    act = rs.permutation(L)[:A].astype(np.int32)
    act[-2:] = -1
    ref = np.asarray(hist_active_scatter(
        jnp.asarray(bins), jnp.asarray(g), jnp.asarray(h),
        jnp.asarray(leaf), jnp.asarray(act), max_bins=mb,
        num_leaf_slots=L))
    n_pad = -(-n // 2048) * 2048
    bt = torch.zeros((G, n_pad), dtype=torch.int32)
    bt[:, :n] = torch.tensor(bins.T)
    hl = torch.full((n_pad,), -1, dtype=torch.int32)
    hl[:n] = torch.tensor(leaf)
    before = t_hist.hist_wide_raw.plain_calls
    got = t_hist.hist_wide_raw(bt, torch.tensor(g), torch.tensor(h), hl,
                               torch.tensor(act), L, mb).numpy()
    assert t_hist.hist_wide_raw.plain_calls == before + 1
    assert np.array_equal(got, ref)
    assert not got[-2:].any() and got[:, :, :, 2].sum() > 0


def _wide_wave(seed=3, n=4000, L=40):
    rng = np.random.RandomState(seed)
    X = rng.normal(size=(n, 5))
    X[rng.rand(n) < 0.15, 1] = np.nan
    X[rng.rand(n) < 0.3, 2] = 0.0
    ds = JDataset.from_raw(X, JConfig.from_params(
        {"max_bin": 511, "zero_as_missing": False}))
    assert ds.bins.dtype == np.int32
    meta = feature_meta_np(ds)
    dd = device_data_from_arrays(ds.bins, meta, "cpu")
    n_pad = dd.n_pad
    F = len(meta["num_bins"])
    row_leaf = rng.randint(0, 20, size=n).astype(np.int32)
    leaf2 = np.full((2, n_pad), -1, np.int32)
    leaf2[0, :n] = row_leaf
    leaf2[1, :n] = np.where(rng.rand(n) < 0.8, row_leaf, -1)
    feature = rng.randint(0, F, size=L).astype(np.int32)
    nb = meta["num_bins"][feature]
    B = t_hist.bin_stride(meta["max_bins"])
    tables = [feature, (rng.rand(L) * (nb - 1)).astype(np.int32),
              rng.rand(L) < 0.5, np.zeros(L, bool), np.zeros((L, B), bool),
              rng.rand(L) < 0.6, ((20 + np.arange(L)) % L).astype(np.int32)]
    tables += [meta[k] for k in ("missing_types", "nan_bins",
                                 "default_bins", "feat_group",
                                 "feat_offset", "num_bins")]
    return ds, dd, leaf2, tables


def test_route_int32_is_route_rows_xla():
    """K2 and K4 on int32 bins: bitwise the reference's XLA routing, and
    counted as the int32 instantiations."""
    ds, dd, leaf2, tables = _wide_wave()
    n = dd.num_data
    ref = np.asarray(route_rows_xla(jnp.asarray(ds.bins), jnp.asarray(leaf2),
                                    *[jnp.asarray(t) for t in tables]))
    before = t_route.ROUTE_I32.plain_calls
    got = t_route.route_rows(dd.bins_t, torch.as_tensor(leaf2),
                             *[torch.as_tensor(t) for t in tables]).numpy()
    assert t_route.ROUTE_I32.plain_calls == before + 1
    assert np.array_equal(got[:, :n], ref[:, :n])
    assert (got[0, :n] != leaf2[0, :n]).any()
    lv = np.random.RandomState(5).normal(size=len(tables[0])).astype(
        np.float32)
    ref_l2, ref_v = route_rows_values_pallas(
        jnp.asarray(dd.bins_t.numpy()), jnp.asarray(leaf2),
        *[jnp.asarray(t) for t in tables], jnp.asarray(lv), interpret=True)
    before = t_route.ROUTE_VALUES_I32.plain_calls
    got_l2, got_v = t_route.route_rows_values(
        dd.bins_t, torch.as_tensor(leaf2),
        *[torch.as_tensor(t) for t in tables], torch.as_tensor(lv))
    assert t_route.ROUTE_VALUES_I32.plain_calls == before + 1
    assert np.array_equal(got_l2.numpy(), np.asarray(ref_l2))
    assert np.array_equal(got_v.numpy(), np.asarray(ref_v))


def test_valid_set_and_binned_serving():
    """A valid set on wide bins scores as the JAX package's does; the
    compiled model serves int32-binned rows as it serves raw ones."""
    X, (jb, tb) = _both("regression", WIDE, rounds=5, valid=True)
    assert tb.model_to_string() == jb.model_to_string()
    assert tb.eval_valid() == jb.eval_valid()
    cm = compile_model(tb)
    bins = cm.bin_rows(X)
    assert bins.dtype == np.int32 and bins.max() > 255
    np.testing.assert_array_equal(cm.leaf_indices(bins, binned=True),
                                  cm.leaf_indices(X))
    np.testing.assert_array_equal(cm.leaf_indices(X), tb.predict(
        X, pred_leaf=True, device=False))
    np.testing.assert_array_equal(cm.predict_raw(bins, binned=True),
                                  cm.predict_raw(X))
