"""lightgbm_tpu_torch learner pieces against the JAX package on the CPU.

* ``pack_values_q`` and ``dequant_hist`` are bitwise the reference's as
  its tree build compiles them (jitted), over many scales;
* ``root_stats`` (chunked pairwise reduction) is bitwise;
* ``find_best_splits`` agrees on the same histogram grid: equal decisions
  and leaf sums within a named tolerance (the port's fixed prefix-sum
  order is the reference's compiled CPU order, so they are expected to be
  bitwise as well);
* one ``build_tree`` agrees node for node with the reference's
  ``build_tree`` under ``hist_backend="compact"`` (Pallas kernels in
  interpret mode, the split kernel included through
  ``LGBM_TPU_SPLIT_INTERPRET=1``), on the same bins handed over by
  ``convert``; at <= 65,536 rows both take the fused split kernel, above
  it both take the scan of ``ops/split.py``.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tools.numcheck.tolerance_registry import tol

from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.io.dataset import BinnedDataset as JDataset
from lightgbm_tpu.io.device import feature_meta_np, to_device as j_to_device
from lightgbm_tpu.learner import serial as jserial
from lightgbm_tpu.ops import split as jsplit
from lightgbm_tpu.ops.pallas_histogram import pack_values_q as j_pack

from lightgbm_tpu_torch.convert import device_data_from_numpy
from lightgbm_tpu_torch.learner import serial as tserial
from lightgbm_tpu_torch.ops import compact as t_compact
from lightgbm_tpu_torch.ops import histogram as t_hist
from lightgbm_tpu_torch.ops import route as t_route
from lightgbm_tpu_torch.ops import split as tsplit
from lightgbm_tpu_torch.ops import split_kernel as t_split

torch.set_num_threads(1)   # tiny tensors: more threads only spin


def _grad_hess(n, seed=0):
    rng = np.random.RandomState(seed)
    score = rng.normal(scale=0.5, size=n).astype(np.float32)
    y = (rng.rand(n) < 0.5).astype(np.float32)
    p = 1.0 / (1.0 + np.exp(-score))
    g = (p - y).astype(np.float32)
    h = (p * (1.0 - p)).astype(np.float32)
    return g, h


@pytest.mark.parametrize("mode", ["int8h", "int8hh", "int8"])
def test_pack_values_q_bitwise(mode):
    pack = jax.jit(functools.partial(j_pack, mode=mode))
    rng = np.random.RandomState(1)
    for _ in range(10):          # several scales (see the dequant test)
        g, h = _grad_hess(3000, seed=int(rng.randint(1 << 30)))
        g *= rng.uniform(0.1, 4.0)
        h *= rng.uniform(0.5, 4.0)
        jv, js = pack(jnp.asarray(g), jnp.asarray(h))
        tv, ts = t_hist.pack_values_q(torch.as_tensor(g),
                                      torch.as_tensor(h), mode,
                                      np.asarray(jv).shape[1])
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("mode", ["int8h", "int8hh", "int8"])
def test_dequant_hist_bitwise_over_scales(mode):
    """The reference's compiled dequant (reciprocal steps, fused hi+lo
    sums) for many scales: one scale decides the rounding of a whole
    grid, so a single pair of scales can hide a wrong form."""
    from lightgbm_tpu.ops.pallas_histogram import dequant_hist as j_deq
    rng = np.random.RandomState(8)
    raw = rng.randint(-200000, 200000, size=(64, 5)).astype(np.int32)
    C = {"int8": 3, "int8h": 4, "int8hh": 5}[mode]
    f = jax.jit(functools.partial(j_deq, mode=mode))
    for _ in range(100):
        sc = rng.uniform(0.01, 10, size=2).astype(np.float32)
        ref = np.asarray(f(jnp.asarray(raw[:, :C]), jnp.asarray(sc)))
        got = t_hist.dequant_hist(torch.as_tensor(raw[:, :C]),
                                  torch.as_tensor(sc), mode).numpy()
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("n", [1000, 20000])
def test_root_stats_bitwise(n):
    g, h = _grad_hess(n, seed=2)
    bag = np.random.RandomState(3).rand(n) < 0.9
    jr = jserial.root_stats(jnp.asarray(g), jnp.asarray(h), jnp.asarray(bag))
    tr = tserial.root_stats(torch.as_tensor(g), torch.as_tensor(h),
                            torch.as_tensor(bag))
    for a, b in zip(jr, tr):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("L", [2, 15, 127, 255, 1000])
def test_stage_plan_matches(L):
    assert tserial.stage_plan(L) == jserial.stage_plan(L)
    assert tserial.stage_plan(L, 1) == jserial.stage_plan(L, 1)


def _split_grid(any_missing, seed=4, L=12, F=7, B=64):
    """A dequantized histogram grid with consistent leaf totals."""
    rng = np.random.RandomState(seed)
    num_bins = rng.randint(20, B, size=F).astype(np.int32)
    cnt = rng.randint(0, 40, size=(L, F, B)).astype(np.float32)
    valid = np.arange(B)[None, None, :] < num_bins[None, :, None]
    cnt = np.where(valid, cnt, 0.0).astype(np.float32)
    g = np.where(valid, rng.normal(size=(L, F, B)) * cnt * 0.1,
                 0.0).astype(np.float32)
    h = (cnt * 0.2).astype(np.float32)
    grid = np.stack([g, h, cnt], -1).astype(np.float32)
    # leaf totals: feature 0's sums (every feature sees every row)
    for f in range(1, F):
        grid[:, f] = grid[:, 0]
        grid[:, f, num_bins[f]:] = 0.0
    tot = grid[:, 0].sum(axis=1)
    mt = (rng.randint(0, 3, size=F) if any_missing
          else np.zeros(F)).astype(np.int32)
    db = rng.randint(0, 5, size=F).astype(np.int32)
    return grid, tot, num_bins, mt, db


@pytest.mark.parametrize("any_missing", [False, True],
                         ids=["no_missing", "missing"])
def test_find_best_splits_agrees(any_missing):
    grid, tot, nb, mt, db = _split_grid(any_missing)
    params = dict(lambda_l1=0.0, lambda_l2=0.1, min_data_in_leaf=5)
    jr = jsplit.find_best_splits(
        jnp.asarray(grid), jnp.asarray(tot[:, 0]), jnp.asarray(tot[:, 1]),
        jnp.asarray(tot[:, 2]), jnp.asarray(nb), jnp.asarray(mt),
        jnp.asarray(db), jnp.zeros(len(nb), bool),
        jsplit.SplitParams(**params), any_categorical=False,
        any_missing=any_missing)
    tr = tsplit.find_best_splits(
        torch.as_tensor(grid), torch.as_tensor(tot[:, 0]),
        torch.as_tensor(tot[:, 1]), torch.as_tensor(tot[:, 2]),
        torch.as_tensor(nb), torch.as_tensor(mt), torch.as_tensor(db),
        tsplit.SplitParams(**params), any_missing=any_missing)
    assert (np.asarray(jr.gain) > 0).any()
    for name in ("feature", "threshold", "default_left"):
        np.testing.assert_array_equal(getattr(tr, name).numpy(),
                                      np.asarray(getattr(jr, name)))
    for name in ("gain", "left_sum_grad", "left_sum_hess", "left_count",
                 "right_sum_grad", "right_sum_hess", "right_count",
                 "left_output", "right_output"):
        np.testing.assert_allclose(getattr(tr, name).numpy(),
                                   np.asarray(getattr(jr, name)),
                                   rtol=tol("f32_accum"),
                                   atol=tol("f32_accum"))


def test_prefix_sum_fixed_order_matches_compiled_cumsum():
    rng = np.random.RandomState(5)
    for B in (8, 16, 64, 256):
        x = (rng.normal(size=(40, B)) * 50).astype(np.float32)
        ref = np.asarray(jax.jit(lambda a: jnp.cumsum(a, axis=-1))(
            jnp.asarray(x)))
        np.testing.assert_array_equal(
            tsplit.prefix_sum(torch.as_tensor(x)).numpy(), ref)


def test_fixed_sum_matches_compiled_sum():
    """The sum that rebuilds an EFB-bundled feature's default cell: the
    reference's compiled ``jnp.sum`` over the bin axis, bitwise, at every
    bin stride (``torch.sum`` adds in another order)."""
    rng = np.random.RandomState(6)
    for B in (8, 16, 32, 64, 128, 256):
        x = (rng.normal(size=(12, 5, B, 3))
             * 10.0 ** rng.uniform(-3, 3, size=(12, 5, B, 3))
             ).astype(np.float32)
        ref = np.asarray(jax.jit(lambda a: jnp.sum(a, axis=2))(
            jnp.asarray(x)))
        np.testing.assert_array_equal(
            t_hist.fixed_sum(torch.as_tensor(x), 2).numpy(), ref)


# (rows, leaves, backend): at <= 65,536 rows every wave runs at the tail
# width; 70,000 rows take the staged plan 8, 8, 8, 8, 16, 32 (fused) then
# 64, 128 and the 128-slot tail (route + compact), as the headline does
BUILD_CASES = [(3000, 15, "fused"), (3000, 127, "compact"),
               (70000, 255, "staged")]


@pytest.mark.parametrize("n,L,backend", BUILD_CASES,
                         ids=[b for _, _, b in BUILD_CASES])
def test_build_tree_node_for_node(monkeypatch, n, L, backend):
    monkeypatch.setenv("LGBM_TPU_SPLIT_INTERPRET", "1")
    rng = np.random.RandomState(6)
    X = rng.normal(size=(n, 6))
    X[rng.rand(n) < 0.1, 1] = np.nan
    ds = JDataset.from_raw(X, JConfig.from_params({"max_bin": 63}))
    g, h = _grad_hess(n, seed=7)
    growth_kw = dict(num_leaves=L, max_depth=-1, wave_size=0)
    split = dict(min_data_in_leaf=20)
    jd = j_to_device(ds)
    jt = jax.jit(functools.partial(
        jserial.build_tree, hist_backend="compact", hist_mode="int8h"),
        static_argnums=(3,))(
            jd, jnp.asarray(g), jnp.asarray(h),
            jserial.GrowthParams(split=jsplit.SplitParams(**split),
                                 **growth_kw))
    td = device_data_from_numpy(ds.bins, feature_meta_np(ds), "cpu")
    assert tserial.resolve_backend(td, L) == (
        "fused" if backend == "fused" else "compact")
    calls = {f: f.plain_calls for f in (
        t_hist.hist_route_raw, t_compact.hist_compact_raw,
        t_route.route_rows_raw, t_route.route_rows_values_raw,
        t_split.find_best_splits_kernel)}
    tt = tserial.build_tree(td, torch.as_tensor(g), torch.as_tensor(h),
                            tserial.GrowthParams(
                                split=tsplit.SplitParams(**split),
                                **growth_kw))
    moved = {f: f.plain_calls > c for f, c in calls.items()}
    assert moved[t_route.route_rows_values_raw]
    assert moved[t_hist.hist_route_raw] == (backend != "compact")
    assert moved[t_compact.hist_compact_raw] == (backend != "fused")
    assert moved[t_route.route_rows_raw] == (backend != "fused")
    assert moved[t_split.find_best_splits_kernel] == (
        n <= t_split.SPLIT_KERNEL_MAX_ROWS)
    nl = int(jt.num_leaves)
    assert int(tt.num_leaves) == nl and nl > L // 2
    m = nl - 1
    for name in ("feature", "threshold_bin", "default_left", "left_child",
                 "right_child", "internal_count"):
        np.testing.assert_array_equal(getattr(tt, name).numpy()[:m],
                                      np.asarray(getattr(jt, name))[:m])
    for name in ("leaf_count", "leaf_depth"):
        np.testing.assert_array_equal(getattr(tt, name).numpy()[:nl],
                                      np.asarray(getattr(jt, name))[:nl])
    for name in ("gain", "internal_value"):
        np.testing.assert_array_equal(getattr(tt, name).numpy()[:m],
                                      np.asarray(getattr(jt, name))[:m])
    np.testing.assert_array_equal(tt.leaf_value.numpy()[:nl],
                                  np.asarray(jt.leaf_value)[:nl])
    np.testing.assert_array_equal(tt.row_leaf.numpy(),
                                  np.asarray(jt.row_leaf))
    np.testing.assert_array_equal(tt.row_value.numpy(),
                                  np.asarray(jt.row_value))
    # the device walk of the built tree lands every row where routing did,
    # in as many passes as the tree is deep (more passes change nothing)
    depth = int(tt.leaf_depth.max())
    want = tt.leaf_value.numpy()[tt.row_leaf.numpy()]
    for passes in (depth, L - 1):
        pred = tserial.predict_built_tree(tt, td, passes)
        np.testing.assert_array_equal(pred.numpy(), want)
