"""lightgbm_tpu_torch kernels (plain versions on the CPU) against the JAX
package's Pallas kernels in interpret mode, on identical inputs.

K1 fused route+histogram (``hist_route_pallas``), K2 route
(``route_rows_pallas``), K3 leaf-compacted histogram
(``hist_active_compact``) and K4 route-values
(``route_rows_values_pallas``) are fed the same transposed bins,
quantized values, leaf vectors, active sets and split tables.  Routing,
route values and the int8 histograms (after ``dequant_hist`` on both
sides) must be bitwise equal.  The inputs cover -1 active slots,
out-of-bag rows, padding rows, NaN and zero missing types, and an
EFB-bundled dataset for routing.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tools.numcheck.tolerance_registry import tol

from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.io.dataset import BinnedDataset as JDataset
from lightgbm_tpu.io.device import feature_meta_np
from lightgbm_tpu.ops.compact import hist_active_compact as j_compact
from lightgbm_tpu.ops.pallas_histogram import (hist_active_scatter,
                                               hist_route_pallas)
from lightgbm_tpu.ops.pallas_route import (route_rows_pallas,
                                           route_rows_values_pallas)

from lightgbm_tpu_torch.convert import device_data_from_numpy
from lightgbm_tpu_torch.ops import compact as t_compact
from lightgbm_tpu_torch.ops import histogram as t_hist
from lightgbm_tpu_torch.ops import route as t_route

L = 31


def _dataset(bundled: bool, seed=3, n=3000):
    """A JAX-package BinnedDataset with NaN / zero-missing columns; the
    bundled variant adds mutually exclusive sparse columns EFB packs into
    one group."""
    rng = np.random.RandomState(seed)
    X = rng.normal(size=(n, 6))
    X[rng.rand(n) < 0.15, 1] = np.nan
    X[rng.rand(n) < 0.3, 2] = 0.0
    params = {"max_bin": 63, "zero_as_missing": False}
    if bundled:
        rows = np.arange(n)
        extra = rng.normal(size=(n, 3))
        for i in range(3):
            extra[(rows % 3 != i) | (rng.rand(n) < 0.5), i] = 0.0
        X = np.concatenate([X, extra], axis=1)
    ds = JDataset.from_raw(X, JConfig.from_params(params))
    assert (ds.bundle is not None) == bundled
    return ds


def _wave(ds, seed, hist_frac=0.8):
    """Same-seed wave inputs: leaf vectors with bagged-out and padding
    rows, per-leaf split tables over the dataset's logical features."""
    rng = np.random.RandomState(seed)
    meta = feature_meta_np(ds)
    dd = device_data_from_numpy(ds.bins, meta, "cpu")
    n, n_pad = dd.num_data, dd.n_pad
    F = len(meta["num_bins"])
    row_leaf = rng.randint(0, 20, size=n).astype(np.int32)
    hist_leaf = np.where(rng.rand(n) < hist_frac, row_leaf, -1)
    leaf2 = np.full((2, n_pad), -1, np.int32)
    leaf2[0, :n] = row_leaf
    leaf2[1, :n] = hist_leaf
    feature = rng.randint(0, F, size=L).astype(np.int32)
    nb = meta["num_bins"][feature]
    tables = dict(
        feature=feature,
        threshold=(rng.rand(L) * (nb - 1)).astype(np.int32),
        default_left=rng.rand(L) < 0.5,
        is_categorical=np.zeros(L, bool),
        cat_mask=np.zeros((L, t_hist.bin_stride(meta["max_bins"])), bool),
        sel=rng.rand(L) < 0.6,
        new_id=(20 + np.arange(L)) % L)
    tables["new_id"] = tables["new_id"].astype(np.int32)
    metas = [meta[k] for k in ("missing_types", "nan_bins", "default_bins",
                               "feat_group", "feat_offset", "num_bins")]
    return dd, meta, leaf2, tables, metas


def _args(tables, metas, lib):
    order = ("feature", "threshold", "default_left", "is_categorical",
             "cat_mask", "sel", "new_id")
    if lib == "jax":
        return [jnp.asarray(tables[k]) for k in order] + [
            jnp.asarray(m) for m in metas]
    return [torch.as_tensor(tables[k]) for k in order] + [
        torch.as_tensor(m) for m in metas]


def _vals(dd, seed, mode="int8h"):
    rng = np.random.RandomState(seed)
    g = rng.normal(size=dd.num_data).astype(np.float32)
    h = rng.uniform(0.01, 0.25, size=dd.num_data).astype(np.float32)
    vals, scales = t_hist.pack_values_q(torch.as_tensor(g),
                                        torch.as_tensor(h), mode, dd.n_pad)
    return vals, scales


def _active(seed, A, n_neg):
    rng = np.random.RandomState(seed)
    active = np.full(A, -1, np.int32)
    active[:A - n_neg] = rng.choice(L, A - n_neg, replace=False)
    rng.shuffle(active)
    return active


@pytest.mark.parametrize("bundled", [False, True], ids=["plain", "efb"])
def test_route_bitwise(bundled):
    ds = _dataset(bundled)
    dd, meta, leaf2, tables, metas = _wave(ds, seed=11)
    bt_j = jnp.asarray(dd.bins_t.numpy())
    ref = np.asarray(route_rows_pallas(bt_j, jnp.asarray(leaf2),
                                       *_args(tables, metas, "jax"),
                                       any_cat=False, interpret=True))
    before = t_route.route_rows_raw.plain_calls
    got = t_route.route_rows(dd.bins_t, torch.as_tensor(leaf2),
                             *_args(tables, metas, "torch"))
    assert t_route.route_rows_raw.plain_calls == before + 1
    np.testing.assert_array_equal(got.numpy(), ref)
    moved = (ref[0] != leaf2[0]).sum()
    assert moved > 0 and (ref[:, dd.num_data:] == -1).all()


def test_route_values_bitwise():
    ds = _dataset(True)
    dd, meta, leaf2, tables, metas = _wave(ds, seed=12)
    lv = np.random.RandomState(5).normal(scale=0.3, size=L).astype(
        np.float32)
    ref_l2, ref_v = route_rows_values_pallas(
        jnp.asarray(dd.bins_t.numpy()), jnp.asarray(leaf2),
        *_args(tables, metas, "jax"), jnp.asarray(lv), any_cat=False,
        interpret=True)
    got_l2, got_v = t_route.route_rows_values(
        dd.bins_t, torch.as_tensor(leaf2), *_args(tables, metas, "torch"),
        torch.as_tensor(lv))
    np.testing.assert_array_equal(got_l2.numpy(), np.asarray(ref_l2))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(ref_v))
    assert (got_v.numpy()[dd.num_data:] == 0.0).all()


@pytest.mark.parametrize("A,n_neg,mode", [(8, 2, "int8h"), (16, 3, "int8h"),
                                          (8, 1, "int8hh")])
def test_hist_route_bitwise(A, n_neg, mode):
    ds = _dataset(False)
    dd, meta, leaf2, tables, metas = _wave(ds, seed=13 + A)
    vals, scales = _vals(dd, seed=A, mode=mode)
    active = _active(A, A, n_neg)
    G = dd.num_groups
    ref_h, ref_l2 = hist_route_pallas(
        jnp.asarray(dd.bins_t.numpy()), jnp.asarray(vals.numpy()),
        jnp.asarray(leaf2), jnp.asarray(active),
        *_args(tables, metas, "jax"), jnp.asarray(scales.numpy()),
        num_features=G, max_bins=dd.group_max_bins, mode=mode,
        any_cat=False, interpret=True)
    before = t_hist.hist_route_raw.plain_calls
    got_h, got_l2 = t_hist.hist_route(
        dd.bins_t, vals, torch.as_tensor(leaf2), torch.as_tensor(active),
        *_args(tables, metas, "torch"), scales,
        max_bins=dd.group_max_bins, mode=mode)
    assert t_hist.hist_route_raw.plain_calls == before + 1
    np.testing.assert_array_equal(got_l2.numpy(), np.asarray(ref_l2))
    ref_h = np.asarray(ref_h)
    assert got_h.shape == ref_h.shape
    np.testing.assert_array_equal(got_h.numpy(), ref_h)
    # -1 slots collect the out-of-bag rows, as the TPU kernel's do
    neg = np.nonzero(active < 0)[0]
    assert ref_h[neg][..., 2].sum() > 0


@pytest.mark.parametrize("A,n_neg", [(64, 5)])
def test_hist_compact_bitwise(A, n_neg):
    ds = _dataset(False)
    dd, meta, leaf2, tables, metas = _wave(ds, seed=29)
    # the compact kernel reads the ROUTED hist leaves (route first)
    hleaf = t_route.route_rows(dd.bins_t, torch.as_tensor(leaf2),
                               *_args(tables, metas, "torch"))[1]
    hleaf = hleaf.contiguous()
    vals, scales = _vals(dd, seed=A)
    rng = np.random.RandomState(A)
    active = np.full(A, -1, np.int32)          # -1 slots + inactive leaves
    active[:L - n_neg] = rng.choice(L, L - n_neg, replace=False)
    rng.shuffle(active)
    G = dd.num_groups
    ref = np.asarray(j_compact(
        jnp.asarray(dd.bins_t.numpy()), jnp.asarray(vals.numpy()),
        jnp.asarray(hleaf.numpy()), jnp.asarray(active),
        jnp.asarray(scales.numpy()), num_features=G,
        max_bins=dd.group_max_bins, num_leaf_slots=L, mode="int8h",
        interpret=True))
    before = t_compact.hist_compact_raw.plain_calls
    got = t_compact.hist_active_compact(
        dd.bins_t, vals, hleaf, torch.as_tensor(active), scales,
        num_leaf_slots=L, max_bins=dd.group_max_bins, mode="int8h")
    assert t_compact.hist_compact_raw.plain_calls == before + 1
    np.testing.assert_array_equal(got.numpy(), ref)
    # -1 slots are exact zeros
    assert (got.numpy()[active < 0] == 0.0).all()


def test_hist_active_scatter_matches():
    """The float32 scatter oracle: same cells, sums to f32 accumulation
    order, counts exact."""
    ds = _dataset(False)
    rng = np.random.RandomState(31)
    n = ds.bins.shape[0]
    g = rng.normal(size=n).astype(np.float32)
    h = rng.uniform(0.1, 1.0, size=n).astype(np.float32)
    row_leaf = rng.randint(-1, L, size=n).astype(np.int32)
    active = _active(7, 12, 3)
    mb = int(ds.bins.max()) + 1
    ref = np.asarray(hist_active_scatter(
        jnp.asarray(ds.bins), jnp.asarray(g), jnp.asarray(h),
        jnp.asarray(row_leaf), jnp.asarray(active), max_bins=mb,
        num_leaf_slots=L))
    got = t_hist.hist_active_scatter(
        torch.as_tensor(ds.bins), torch.as_tensor(g), torch.as_tensor(h),
        torch.as_tensor(row_leaf), torch.as_tensor(active), max_bins=mb,
        num_leaf_slots=L).numpy()
    np.testing.assert_array_equal(got[..., 2], ref[..., 2])
    np.testing.assert_allclose(got, ref, rtol=tol("f32_accum"),
                               atol=tol("f32_accum"))
