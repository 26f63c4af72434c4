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
EFB-bundled dataset for routing, and tables in which about a third of
the leaves split categorically (the reference kernels with
``any_cat=True``).

The wide active-leaf histogram K5 (``hist_active_pallas``) and K3 are
held in their seeded form: two row blocks folded through one carry
(the reference's ``acc=``/``raw=True``), then unpacked.  Quantized, the
port's plain version is bitwise the reference's kernel.  On the float
modes both are held to a float64 sum of the bf16-rounded values within
``tol("f32_accum")``; the port's plain version sums in its documented
order (checked against a row loop), so a chain of blocks is bitwise one
call over all rows.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tools.numcheck.tolerance_registry import tol

from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.io.dataset import BinnedDataset as JDataset
from lightgbm_tpu.io.device import feature_meta_np
from lightgbm_tpu.ops.compact import hist_active_compact as j_compact
from lightgbm_tpu.ops.compact import unpack_hist_compact_raw
from lightgbm_tpu.ops.pallas_histogram import (hist_active_pallas,
                                               hist_active_scatter,
                                               hist_route_pallas,
                                               pack_values as j_pack_values,
                                               unpack_hist_raw)
from lightgbm_tpu.ops.pallas_route import (route_rows_pallas,
                                           route_rows_values_pallas)

from lightgbm_tpu_torch.convert import device_data_from_numpy
from lightgbm_tpu_torch.ops import compact as t_compact
from lightgbm_tpu_torch.ops import histogram as t_hist
from lightgbm_tpu_torch.ops import route as t_route

torch.set_num_threads(1)   # tiny tensors: more threads only spin

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


def _wave(ds, seed, hist_frac=0.8, cat=False):
    """Same-seed wave inputs: leaf vectors with bagged-out and padding
    rows, per-leaf split tables over the dataset's logical features.
    With ``cat`` about a third of the leaves split categorically, each
    with a random mask of left bins."""
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
    B = t_hist.bin_stride(meta["max_bins"])
    tables = dict(
        feature=feature,
        threshold=(rng.rand(L) * (nb - 1)).astype(np.int32),
        default_left=rng.rand(L) < 0.5,
        is_categorical=np.zeros(L, bool),
        cat_mask=np.zeros((L, B), bool),
        sel=rng.rand(L) < 0.6,
        new_id=(20 + np.arange(L)) % L)
    if cat:
        tables["is_categorical"] = rng.rand(L) < 1 / 3
        tables["cat_mask"] = ((rng.rand(L, B) < 0.5)
                              & tables["is_categorical"][:, None])
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


@pytest.mark.parametrize("bundled,cat", [
    pytest.param(False, False, id="plain"), pytest.param(True, False, id="efb"),
    pytest.param(False, True, id="plain-cat"),
    pytest.param(True, True, id="efb-cat")])
def test_route_bitwise(bundled, cat):
    ds = _dataset(bundled)
    dd, meta, leaf2, tables, metas = _wave(ds, seed=11, cat=cat)
    bt_j = jnp.asarray(dd.bins_t.numpy())
    ref = np.asarray(route_rows_pallas(bt_j, jnp.asarray(leaf2),
                                       *_args(tables, metas, "jax"),
                                       any_cat=cat, interpret=True))
    before = t_route.route_rows_raw.plain_calls
    got = t_route.route_rows(dd.bins_t, torch.as_tensor(leaf2),
                             *_args(tables, metas, "torch"))
    assert t_route.route_rows_raw.plain_calls == before + 1
    np.testing.assert_array_equal(got.numpy(), ref)
    moved = (ref[0] != leaf2[0]).sum()
    assert moved > 0 and (ref[:, dd.num_data:] == -1).all()
    if cat:
        # rows of categorical leaves moved both ways
        rl = np.maximum(leaf2[0, :dd.num_data], 0)
        on_cat = tables["is_categorical"][rl] & tables["sel"][rl] & (
            leaf2[0, :dd.num_data] >= 0)
        went = ref[0, :dd.num_data][on_cat] != leaf2[0, :dd.num_data][on_cat]
        assert 0 < went.sum() < on_cat.sum()


def test_route_values_bitwise(cat=False):
    ds = _dataset(True)
    dd, meta, leaf2, tables, metas = _wave(ds, seed=12, cat=cat)
    lv = np.random.RandomState(5).normal(scale=0.3, size=L).astype(
        np.float32)
    ref_l2, ref_v = route_rows_values_pallas(
        jnp.asarray(dd.bins_t.numpy()), jnp.asarray(leaf2),
        *_args(tables, metas, "jax"), jnp.asarray(lv), any_cat=cat,
        interpret=True)
    got_l2, got_v = t_route.route_rows_values(
        dd.bins_t, torch.as_tensor(leaf2), *_args(tables, metas, "torch"),
        torch.as_tensor(lv))
    np.testing.assert_array_equal(got_l2.numpy(), np.asarray(ref_l2))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(ref_v))
    assert (got_v.numpy()[dd.num_data:] == 0.0).all()


def test_route_values_categorical_bitwise():
    test_route_values_bitwise(cat=True)


@pytest.mark.parametrize("A,n_neg,mode,cat", [
    pytest.param(8, 2, "int8h", False, id="8-2-int8h"),
    pytest.param(16, 3, "int8h", False, id="16-3-int8h"),
    pytest.param(8, 1, "int8hh", False, id="8-1-int8hh"),
    pytest.param(16, 3, "int8h", True, id="16-3-int8h-cat")])
def test_hist_route_bitwise(A, n_neg, mode, cat):
    ds = _dataset(cat)
    dd, meta, leaf2, tables, metas = _wave(ds, seed=13 + A, cat=cat)
    vals, scales = _vals(dd, seed=A, mode=mode)
    active = _active(A, A, n_neg)
    G = dd.num_groups
    ref_h, ref_l2 = hist_route_pallas(
        jnp.asarray(dd.bins_t.numpy()), jnp.asarray(vals.numpy()),
        jnp.asarray(leaf2), jnp.asarray(active),
        *_args(tables, metas, "jax"), jnp.asarray(scales.numpy()),
        num_features=G, max_bins=dd.group_max_bins, mode=mode,
        any_cat=cat, interpret=True)
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


@pytest.mark.parametrize("A,n_neg,cat", [
    pytest.param(64, 5, False, id="64-5"),
    pytest.param(64, 5, True, id="64-5-cat")])
def test_hist_compact_bitwise(A, n_neg, cat):
    ds = _dataset(False)
    dd, meta, leaf2, tables, metas = _wave(ds, seed=29, cat=cat)
    # the compact kernel reads the ROUTED hist leaves (route first)
    hleaf = t_route.route_rows(dd.bins_t, torch.as_tensor(leaf2),
                               *_args(tables, metas, "torch"))[1]
    hleaf = hleaf.contiguous()
    if cat:
        # the leaves that the reference's route wrote, categorical
        # splits included
        ref_l2 = route_rows_pallas(
            jnp.asarray(dd.bins_t.numpy()), jnp.asarray(leaf2),
            *_args(tables, metas, "jax"), any_cat=True, interpret=True)
        np.testing.assert_array_equal(hleaf.numpy(), np.asarray(ref_l2)[1])
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
    """The float32 scatter oracle, now the wide histogram's plain version
    on the transposed bins (``hist_wide_raw`` on CPU tensors): same
    cells, counts exact, and the sums bitwise (both add in row order)."""
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
    n_pad = -(-n // 2048) * 2048
    bins_t = torch.zeros((ds.bins.shape[1], n_pad), dtype=torch.uint8)
    bins_t[:, :n] = torch.as_tensor(ds.bins.T)
    hist_leaf = torch.full((n_pad,), -1, dtype=torch.int32)
    hist_leaf[:n] = torch.as_tensor(row_leaf)
    got = t_hist.hist_wide_raw(
        bins_t, torch.as_tensor(g), torch.as_tensor(h), hist_leaf,
        torch.as_tensor(active), L, mb).numpy()
    np.testing.assert_array_equal(got[..., 2], ref[..., 2])
    np.testing.assert_allclose(got, ref, rtol=tol("f32_accum"),
                               atol=tol("f32_accum"))
    np.testing.assert_array_equal(got, ref)


# -- K5 and seeded K3: two blocks of a stream through one carry ----------
CUT = 8192          # the block boundary (a multiple of the stream chunk)


def _stream_wave(seed, A, n_neg, n=12000):
    """A 12,000-row dataset (two blocks: 8,192 rows, then 4,096 with the
    padding), gradients, hist leaves with -1 rows, an active set."""
    ds = _dataset(False, seed=seed, n=n)
    dd = device_data_from_numpy(ds.bins, feature_meta_np(ds), "cpu")
    rng = np.random.RandomState(seed)
    g = torch.as_tensor(rng.normal(size=n).astype(np.float32))
    h = torch.as_tensor(rng.uniform(0.01, 0.25, size=n).astype(np.float32))
    hleaf = np.full(dd.n_pad, -1, np.int32)
    hleaf[:n] = np.where(rng.rand(n) < 0.9, rng.randint(0, 20, size=n), -1)
    return dd, g, h, hleaf, _active(seed, A, n_neg)


def _blocks(n_pad):
    return ((0, CUT), (CUT, n_pad))


def _ref_fold(fn, dd, vals, hleaf, active, scales, mode, **kw):
    """The reference kernel over the two blocks, seeded with its raw
    carry."""
    bt, v = dd.bins_t.numpy(), vals.numpy()
    raw = None
    for lo, hi in _blocks(dd.n_pad):
        raw = fn(jnp.asarray(bt[:, lo:hi]), jnp.asarray(v[:, lo:hi]),
                 jnp.asarray(hleaf[lo:hi]), jnp.asarray(active),
                 None if scales is None else jnp.asarray(scales.numpy()),
                 raw, num_features=dd.num_groups,
                 max_bins=dd.group_max_bins, mode=mode, interpret=True,
                 raw=True, **kw)
    return raw


def _jit_unpack(fn):
    """The reference's unpack as its fold compiles it (jitted: the
    hi+lo dequantization is a fused multiply-add there)."""
    return jax.jit(fn, static_argnums=(1, 2, 3, 4))


def _port_fold(fn, dd, vals, hleaf, active, acc=None):
    for lo, hi in _blocks(dd.n_pad):
        acc = fn(dd.bins_t[:, lo:hi].contiguous(),
                 vals[:, lo:hi].contiguous(), torch.as_tensor(hleaf[lo:hi]),
                 torch.as_tensor(active), L, dd.group_max_bins, acc)
    return acc


@pytest.mark.parametrize("mode,A,n_neg", [("int8", 8, 2), ("int8h", 32, 3),
                                          ("int8hh", 8, 1)])
def test_hist_active_seeded_bitwise(mode, A, n_neg):
    dd, g, h, hleaf, active = _stream_wave(40 + A, A, n_neg)
    vals, scales = t_hist.pack_values_q(g, h, mode, dd.n_pad)
    raw = _ref_fold(hist_active_pallas, dd, vals, hleaf, active, scales,
                    mode)
    ref = np.asarray(_jit_unpack(unpack_hist_raw)(
        raw, A, dd.num_groups, dd.group_max_bins, mode,
        jnp.asarray(scales.numpy())))
    before = t_hist.hist_active_raw.plain_calls
    acc = _port_fold(t_hist.hist_active_raw, dd, vals, hleaf, active)
    assert t_hist.hist_active_raw.plain_calls == before + 2
    got = t_hist.combine_hist_cols(acc, mode, scales).numpy()
    np.testing.assert_array_equal(got, ref)
    # every -1 slot holds each row whose hist leaf is -1, once per column
    n_neg_rows = int((hleaf[:dd.num_data] < 0).sum())
    counts = acc[torch.as_tensor(active < 0)][..., -1].sum(dim=2)
    assert (counts == n_neg_rows).all()


def test_hist_compact_seeded_bitwise():
    A, n_neg = 64, 5
    dd, g, h, hleaf, _ = _stream_wave(29, 8, 1)
    rng = np.random.RandomState(A)
    active = np.full(A, -1, np.int32)
    active[:L - n_neg] = rng.choice(L, L - n_neg, replace=False)
    vals, scales = t_hist.pack_values_q(g, h, "int8h", dd.n_pad)
    raw = _ref_fold(j_compact, dd, vals, hleaf, active, scales, "int8h",
                    num_leaf_slots=L)
    ref = np.asarray(_jit_unpack(unpack_hist_compact_raw)(
        raw, A, dd.num_groups, dd.group_max_bins, "int8h",
        jnp.asarray(scales.numpy())))
    acc = _port_fold(t_compact.hist_compact_raw, dd, vals, hleaf, active)
    got = t_hist.combine_hist_cols(acc, "int8h", scales).numpy()
    np.testing.assert_array_equal(got, ref)
    assert (got[active < 0] == 0.0).all()


@pytest.mark.parametrize("mode", t_hist.FLOAT_MODES)
def test_pack_values_bitwise(mode):
    rng = np.random.RandomState(len(mode))
    n = 3001
    g = rng.normal(size=n).astype(np.float32)
    h = rng.uniform(0.001, 0.3, size=n).astype(np.float32)
    ref = np.asarray(j_pack_values(jnp.asarray(g), jnp.asarray(h), mode))
    got = t_hist.pack_values(torch.as_tensor(g), torch.as_tensor(h), mode,
                             ref.shape[1])
    np.testing.assert_array_equal(got.numpy(), ref)


def _f64_oracle(dd, vals, hleaf, active, mode):
    """float64 sums of the bf16-rounded values, combined to ``[A, G, B,
    3]`` as the kernels combine their columns."""
    A, G = len(active), dd.num_groups
    B = t_hist.bin_stride(dd.group_max_bins)
    v = vals.to(torch.bfloat16).double().numpy()
    bins = dd.bins_t.numpy().astype(np.int64)
    out = np.zeros((A, G, B, v.shape[0]))
    for s, a in enumerate(active):
        rows = np.nonzero(hleaf == a)[0]
        for f in range(G):
            for c in range(v.shape[0]):
                np.add.at(out[s, f, :, c], bins[f, rows], v[c, rows])
    return t_hist.combine_hist_cols(torch.as_tensor(out), mode).numpy()


@pytest.mark.parametrize("mode,A", [("hhilo", 32), ("hilo", 8),
                                    ("bf16", 8), ("ghilo", 8)])
def test_hist_active_float_within_f64(mode, A):
    dd, g, h, hleaf, active = _stream_wave(50 + A, A, 2)
    vals = t_hist.pack_values(g, h, mode, dd.n_pad)
    oracle = _f64_oracle(dd, vals, hleaf, active, mode)
    raw = _ref_fold(hist_active_pallas, dd, vals, hleaf, active, None, mode)
    ref = np.asarray(_jit_unpack(unpack_hist_raw)(
        raw, A, dd.num_groups, dd.group_max_bins, mode))
    acc = _port_fold(t_hist.hist_active_float_raw, dd, vals, hleaf, active)
    got = t_hist.combine_hist_cols(acc, mode).numpy()
    for name, arr in (("reference", ref), ("port", got)):
        np.testing.assert_allclose(arr, oracle, rtol=tol("f32_accum"),
                                   atol=tol("f32_accum"), err_msg=name)
    np.testing.assert_array_equal(got[..., 2], oracle[..., 2])


def test_hist_active_float_block_invariant():
    """One call over all rows is bitwise two chained calls."""
    dd, g, h, hleaf, active = _stream_wave(61, 16, 2, n=20000)
    vals = t_hist.pack_values(g, h, "hhilo", dd.n_pad)
    one = t_hist.hist_active_float_raw(dd.bins_t, vals,
                                       torch.as_tensor(hleaf),
                                       torch.as_tensor(active), L,
                                       dd.group_max_bins)
    two = None
    for lo, hi in ((0, 2 * CUT), (2 * CUT, dd.n_pad)):
        two = t_hist.hist_active_float_raw(
            dd.bins_t[:, lo:hi].contiguous(), vals[:, lo:hi].contiguous(),
            torch.as_tensor(hleaf[lo:hi]), torch.as_tensor(active), L,
            dd.group_max_bins, two)
    assert torch.equal(one, two)


def test_float_plain_sums_in_row_order():
    """The float plain version's order: a 1-D float32 ``index_add_`` on
    the CPU adds in index order (held to a sequential loop on values
    whose sum depends on the order), and the whole K5 plain version
    equals a row loop of its contract (per chunk of ``FLOAT_CHUNK``
    rows, each cell from +0.0 in row order; partials into the carry in
    chunk order)."""
    rng = np.random.RandomState(5)
    idx = rng.randint(0, 7, size=20000)
    val = (rng.normal(size=20000)
           * 10.0 ** rng.randint(-4, 8, size=20000)).astype(np.float32)
    seq = np.zeros(7, np.float32)
    for i, x in zip(idx, val):
        seq[i] = np.float32(seq[i] + x)
    rev = np.zeros(7, np.float32)
    for i, x in zip(idx[::-1], val[::-1]):
        rev[i] = np.float32(rev[i] + x)
    assert not np.array_equal(seq, rev)        # the order matters here
    got = torch.zeros(7).index_add_(0, torch.as_tensor(idx),
                                    torch.as_tensor(val))
    np.testing.assert_array_equal(got.numpy(), seq)

    dd, g, h, hleaf, active = _stream_wave(71, 8, 2, n=3000)
    vals = t_hist.pack_values(g, h, "hilo", dd.n_pad)
    carry = torch.as_tensor(rng.normal(size=(8, dd.num_groups, 64, 5))
                            .astype(np.float32))
    got = t_hist.hist_active_float_raw(
        dd.bins_t, vals, torch.as_tensor(hleaf), torch.as_tensor(active), L,
        dd.group_max_bins, carry.clone()).numpy()
    v = vals.to(torch.bfloat16).float().numpy()
    bins = dd.bins_t.numpy()
    want = carry.numpy().copy()
    slot_of = {}
    for s, a in enumerate(active):
        slot_of.setdefault(int(a), s)
    for k0 in range(0, dd.n_pad, t_hist.FLOAT_CHUNK):
        part = np.zeros_like(want)
        for r in range(k0, min(k0 + t_hist.FLOAT_CHUNK, dd.n_pad)):
            s = slot_of.get(int(hleaf[r]))
            if s is None:
                continue
            for f in range(dd.num_groups):
                for c in range(v.shape[0]):
                    b = bins[f, r]
                    part[s, f, b, c] = np.float32(part[s, f, b, c]
                                                  + v[c, r])
        for s, a in enumerate(active):
            want[s] = want[s] + part[slot_of[int(a)]]
    np.testing.assert_array_equal(got, want)


# -- launch plans and scratch of the CUDA histogram kernels (host logic) --
# (n_pad, G, A, B, C, L, route): the paths' shapes (headline K1 at 8-32
# slots and K3 at 64-128, small-data K1 at 256 bins, the stream block's
# K5 and seeded K3) and edge shapes (odd value-row counts, wide groups,
# many slots, fewer rows than a partition)
PLAN_SHAPES = [
    (1001472, 28, 8, 64, 4, 255, True), (1001472, 28, 16, 64, 4, 255, True),
    (1001472, 28, 32, 64, 4, 255, True), (1001472, 28, 64, 64, 4, 255, False),
    (1001472, 28, 128, 64, 4, 255, False), (65536, 28, 32, 256, 4, 63, True),
    (1 << 20, 28, 32, 64, 4, 63, False), (1 << 20, 28, 128, 64, 4, 255, False),
    (1 << 20, 28, 32, 64, 3, 63, False), (1 << 20, 28, 32, 256, 5, 63, False),
    (8192, 200, 512, 256, 5, 1023, False), (2048, 3, 2, 8, 1, 7, True)]


@pytest.mark.parametrize("shape", PLAN_SHAPES,
                         ids=[f"n{s[0]}-G{s[1]}-A{s[2]}-B{s[3]}-C{s[4]}"
                              for s in PLAN_SHAPES])
def test_hist_plan_tiles_fit_and_cover_once(shape):
    """Every block's tile fits the 227 KB a block may hold, and the grid
    covers every (row, column, slot) exactly once: row partitions of a
    multiple of 4 rows, balanced column tiles and slot groups, one slab
    per row partition."""
    n_pad, G, A, B, C, L, route = shape
    sms = 132
    plan = t_hist.hist_plan(n_pad, G, A, B, C, sms, L, route)
    assert plan.smem == t_hist.hist_smem_bytes(L, route, plan.As, plan.Ft, B,
                                               C)
    assert plan.smem <= t_hist.SMEM_BLOCK_MAX
    assert plan.rows_per_block % 4 == 0
    rows = np.zeros(n_pad, np.int64)
    for x in range(plan.grid_x):
        rows[x * plan.rows_per_block:(x + 1) * plan.rows_per_block] += 1
    assert (rows == 1).all()
    cols = np.zeros(G, np.int64)
    for y in range(plan.col_tiles):
        cols[y * plan.Ft:(y + 1) * plan.Ft] += 1
    assert (cols == 1).all() and (plan.col_tiles - 1) * plan.Ft < G
    slots = np.zeros(A, np.int64)
    for z in range(plan.slot_groups):
        slots[z * plan.As:(z + 1) * plan.As] += 1
    assert (slots == 1).all() and (plan.slot_groups - 1) * plan.As < A
    # as many blocks as fill the multiprocessors once, at most
    resident = min(2, t_hist.SMEM_SM // (plan.smem + 1024))
    assert plan.blocks <= max(sms * resident,
                              plan.col_tiles * plan.slot_groups)
    slab = t_hist.hist_slab(plan, A, G, B, C, "cpu")
    assert slab.shape == (plan.grid_x, A, G, B, C)
    assert slab.dtype == torch.int32


@pytest.mark.parametrize("A,B,C", [(1, 64, 4), (32, 64, 4), (128, 64, 4),
                                   (32, 256, 4), (8, 256, 5), (1024, 64, 3),
                                   (4, 8, 3)])
def test_float_plan_fits_and_sorts(A, B, C):
    """The float K5's partial block fits a block's shared memory with at
    least one warp; its staged rows hold the chunk sorted by slot with
    every slot's run starting at a multiple of 4, on 32 different banks
    (``chp % 8 == 4``); the scratch holds a partial per (chunk, slot)
    and the rows of each."""
    plan = t_hist.float_plan(A, B, C)
    assert 1 <= plan.warps <= t_hist.FLOAT_MAX_WARPS
    assert plan.smem == t_hist.float_smem_bytes(plan.warps, A, B, C,
                                                plan.chp)
    assert plan.smem <= t_hist.SMEM_BLOCK_MAX
    if plan.warps < t_hist.FLOAT_MAX_WARPS:
        assert t_hist.float_smem_bytes(plan.warps + 1, A, B, C,
                                       plan.chp) > t_hist.SMEM_BLOCK_MAX
    chunk = t_hist.FLOAT_CHUNK
    assert plan.chp % 8 == 4
    # the worst case: every slot with rows, each run padded by 3
    assert plan.chp >= chunk + 3 * min(A, chunk)
    G, n_pad = 28, 5 * chunk + 100
    part, counts = t_hist.float_scratch(n_pad, A, G, B, C, "cpu")
    K = -(-n_pad // chunk)
    assert part.shape == (K, A, C, B, G) and part.dtype == torch.float32
    assert counts.shape == (K, A) and counts.dtype == torch.int32


def test_hist_kernels_take_aligned_rows():
    """The CUDA histogram kernels read 4 rows at a time: the wrappers
    refuse a row count that is not a multiple of 4 and a tensor that is
    not 16-byte aligned (a view into another tensor's storage)."""
    ok = torch.zeros(64, dtype=torch.int32)
    t_hist._check_vector_rows(64, ok)
    with pytest.raises(ValueError, match="multiple of 4"):
        t_hist._check_vector_rows(66, ok)
    with pytest.raises(ValueError, match="aligned"):
        t_hist._check_vector_rows(60, ok[1:61])


@pytest.mark.parametrize("wave", ["skewed", "sparse"])
@pytest.mark.parametrize("mode", ["int8h", "hhilo"])
def test_hist_active_plain_waves(mode, wave):
    """K5's plain versions on the two waves the CUDA tests add beside the
    uniform one: a skewed wave (every row in one slot, as every tree's
    first wave) and a sparse one (each 2,048-row chunk in 2 of the
    slots): every row lands in its slot once and the float version keeps
    its block invariance."""
    dd, g, h, hleaf, active = _stream_wave(83, 16, 2, n=12000)
    rng = np.random.RandomState(7)
    live = active[active >= 0]
    if wave == "skewed":
        hleaf = np.where(hleaf >= 0, live[0], hleaf).astype(np.int32)
    else:
        for k0 in range(0, dd.n_pad, t_hist.FLOAT_CHUNK):
            pick = rng.choice(live, 2, replace=False)
            seg = hleaf[k0:k0 + t_hist.FLOAT_CHUNK]
            hleaf[k0:k0 + t_hist.FLOAT_CHUNK] = np.where(
                seg >= 0, pick[rng.randint(0, 2, size=seg.size)], seg)
    n_live = int((hleaf[:dd.num_data] >= 0).sum())
    if mode == "int8h":
        vals, _ = t_hist.pack_values_q(g, h, mode, dd.n_pad)
        fn = t_hist.hist_active_raw
    else:
        vals = t_hist.pack_values(g, h, mode, dd.n_pad)
        fn = t_hist.hist_active_float_raw
    acc = _port_fold(fn, dd, vals, hleaf, active)
    one = fn(dd.bins_t, vals, torch.as_tensor(hleaf),
             torch.as_tensor(active), L, dd.group_max_bins)
    assert torch.equal(acc.view(torch.int32), one.view(torch.int32))
    first = {}
    for s, a in enumerate(active):
        first.setdefault(int(a), s)
    held = sum(int(acc[first[int(a)], 0, :, -1].sum())
               for a in np.unique(live))
    assert held == n_live


# -- float K1 and float K3 (the in-memory float modes) -----------------
def _float_vals(dd, seed, mode):
    rng = np.random.RandomState(seed)
    g = rng.normal(size=dd.num_data).astype(np.float32)
    h = rng.uniform(0.01, 0.25, size=dd.num_data).astype(np.float32)
    return t_hist.pack_values(torch.as_tensor(g), torch.as_tensor(h), mode,
                              dd.n_pad)


@pytest.mark.parametrize("A,n_neg,mode,cat", [
    pytest.param(8, 2, "bf16", False, id="8-2-bf16"),
    pytest.param(16, 3, "hhilo", False, id="16-3-hhilo"),
    pytest.param(32, 2, "hilo", False, id="32-2-hilo"),
    pytest.param(16, 3, "hhilo", True, id="16-3-hhilo-cat")])
def test_hist_route_float_matches_reference(A, n_neg, mode, cat):
    """Float K1's plain version against the reference's fused kernel in
    interpret mode on the same float value rows: the routed leaf vectors
    bitwise, the histograms within ``tol("f32_accum")`` (the sums are
    the same, only their order differs: the port's is the float K5's),
    the counts exact."""
    ds = _dataset(cat)
    dd, meta, leaf2, tables, metas = _wave(ds, seed=17 + A, cat=cat)
    vals = _float_vals(dd, A, mode)
    active = _active(A + 1, A, n_neg)
    ref_h, ref_l2 = hist_route_pallas(
        jnp.asarray(dd.bins_t.numpy()), jnp.asarray(vals.numpy()),
        jnp.asarray(leaf2), jnp.asarray(active),
        *_args(tables, metas, "jax"), None, num_features=dd.num_groups,
        max_bins=dd.group_max_bins, mode=mode, any_cat=cat,
        interpret=True)
    before = t_hist.hist_route_float_raw.plain_calls
    got_h, got_l2 = t_hist.hist_route(
        dd.bins_t, vals, torch.as_tensor(leaf2), torch.as_tensor(active),
        *_args(tables, metas, "torch"), None, max_bins=dd.group_max_bins,
        mode=mode)
    assert t_hist.hist_route_float_raw.plain_calls == before + 1
    np.testing.assert_array_equal(got_l2.numpy(), np.asarray(ref_l2))
    ref_h = np.asarray(ref_h)
    assert got_h.shape == ref_h.shape
    np.testing.assert_allclose(got_h.numpy(), ref_h, rtol=tol("f32_accum"),
                               atol=tol("f32_accum"))
    np.testing.assert_array_equal(got_h.numpy()[..., 2], ref_h[..., 2])
    # -1 slots collect the out-of-bag rows, as the TPU kernel's do
    assert ref_h[np.nonzero(active < 0)[0]][..., 2].sum() > 0


@pytest.mark.parametrize("A,mode", [(64, "hhilo"), (128, "hilo"),
                                    (64, "bf16")])
def test_hist_compact_float_matches_reference(A, mode):
    """Float K3's plain version against the reference's leaf-compacted
    kernel in interpret mode on float values: within
    ``tol("f32_accum")``, counts exact, -1 slots exact zeros."""
    ds = _dataset(False)
    dd, meta, leaf2, tables, metas = _wave(ds, seed=31 + A)
    hleaf = t_route.route_rows(dd.bins_t, torch.as_tensor(leaf2),
                               *_args(tables, metas, "torch"))[1]
    hleaf = hleaf.contiguous()
    vals = _float_vals(dd, A, mode)
    rng = np.random.RandomState(A)
    active = np.full(A, -1, np.int32)          # -1 slots + inactive leaves
    active[:L - 5] = rng.choice(L, L - 5, replace=False)
    rng.shuffle(active)
    ref = np.asarray(j_compact(
        jnp.asarray(dd.bins_t.numpy()), jnp.asarray(vals.numpy()),
        jnp.asarray(hleaf.numpy()), jnp.asarray(active), None,
        num_features=dd.num_groups, max_bins=dd.group_max_bins,
        num_leaf_slots=L, mode=mode, interpret=True))
    before = t_compact.hist_compact_float_raw.plain_calls
    got = t_compact.hist_active_compact(
        dd.bins_t, vals, hleaf, torch.as_tensor(active), None,
        num_leaf_slots=L, max_bins=dd.group_max_bins, mode=mode).numpy()
    assert t_compact.hist_compact_float_raw.plain_calls == before + 1
    np.testing.assert_allclose(got, ref, rtol=tol("f32_accum"),
                               atol=tol("f32_accum"))
    np.testing.assert_array_equal(got[..., 2], ref[..., 2])
    assert (got[active < 0] == 0.0).all()


@pytest.mark.parametrize("mode", ["hhilo", "hilo"])
def test_float_k1_k3_plain_are_route_and_k5(mode):
    """Within the port, on a 20,000-row wave (ten chunks) into a carry
    with -0.0 cells: the float K1 plain version is bitwise the plain
    route followed by the float K5's plain version, and the float K3
    plain version is bitwise the float K5's on every non-negative slot
    (its -1 slots keep the carry: they get nothing)."""
    dd, g, h, _, _ = _stream_wave(91, 8, 1, n=20000)
    rng = np.random.RandomState(9)
    vals = t_hist.pack_values(g, h, mode, dd.n_pad)
    n, n_pad = dd.num_data, dd.n_pad
    leaf2 = np.full((2, n_pad), -1, np.int32)
    leaf2[0, :n] = rng.randint(0, 20, size=n)
    leaf2[1, :n] = np.where(rng.rand(n) < 0.85, leaf2[0, :n], -1)
    F = dd.num_features
    sel = torch.as_tensor(rng.rand(L) < 0.5) & (torch.arange(L) < 20)
    tabs, cat = t_route.leaf_tables(
        torch.as_tensor(rng.randint(0, F, size=L)).int(),
        torch.as_tensor(rng.randint(0, 40, size=L)).int(),
        torch.as_tensor(rng.rand(L) < 0.5), torch.zeros(L, dtype=torch.bool),
        torch.zeros((L, 64), dtype=torch.bool), sel,
        torch.where(sel, 20 + torch.cumsum(sel.int(), 0) - 1, 0).int(),
        dd.missing_types, dd.nan_bins, dd.default_bins, dd.feat_group,
        dd.feat_offset, dd.num_bins)
    leaf2 = torch.as_tensor(leaf2)
    B = t_hist.bin_stride(dd.group_max_bins)

    def carry(A):
        c = torch.as_tensor(rng.normal(size=(A, dd.num_groups, B,
                                             vals.shape[0]))
                            .astype(np.float32))
        c[torch.as_tensor(rng.rand(*c.shape) < 0.05)] = -0.0
        return c

    def bits(t):
        return t.view(torch.int32)

    active = torch.as_tensor(_active(5, 16, 3))
    acc = carry(16)
    k1, l2 = t_hist.hist_route_float_raw(dd.bins_t, vals, leaf2, active,
                                         tabs, cat, L, dd.group_max_bins,
                                         acc.clone())
    routed = t_route.route_rows_raw(dd.bins_t, leaf2, tabs, cat)
    k5 = t_hist.hist_active_float_raw(dd.bins_t, vals,
                                      routed[1].contiguous(), active, L,
                                      dd.group_max_bins, acc.clone())
    assert torch.equal(l2, routed)
    assert torch.equal(bits(k1), bits(k5))

    hleaf = routed[1].contiguous()
    active = torch.full((64,), -1, dtype=torch.int32)
    active[:L - 4] = torch.as_tensor(rng.choice(L, L - 4, replace=False))
    active = active[torch.as_tensor(rng.permutation(64))].contiguous()
    acc = carry(64)
    k3 = t_compact.hist_compact_float_raw(dd.bins_t, vals, hleaf, active, L,
                                          dd.group_max_bins, acc.clone())
    k5 = t_hist.hist_active_float_raw(dd.bins_t, vals, hleaf, active, L,
                                      dd.group_max_bins, acc.clone())
    live = active >= 0
    assert torch.equal(bits(k3[live]), bits(k5[live]))
    assert torch.equal(bits(k3[~live]), bits(acc[~live]))


@pytest.mark.parametrize("B", [8, 64, 128, 256])
def test_compact_float_walk_block_fits(B):
    """The float K3's blocks fit a block's shared memory: a light walk's
    warp holds an int4 (total, partial, chunk) per cell of its [B][32]
    lanes, a heavy-partial block a [B][32] float tile per warp; the fill
    block per-warp slot counts, a chunk's rows and 32 staged columns.  The window's scratch holds the
    sort's counts, positions and ranks per (slot, chunk), the per-slot
    table, the heavy pairs, each active row's bins (4 a word) and packed
    values, and ``pcap`` chunk partials."""
    n_pad, A, G, C, L = 5 * t_hist.FLOAT_CHUNK + 100, 128, 28, 5, 255
    plan = t_hist.float_walk_plan(n_pad, A, G, B, C, L, 132)
    assert plan.light_smem == B * 32 * 16 <= t_hist.SMEM_BLOCK_MAX
    assert (plan.heavy_smem == t_hist.FLOAT_HEAVY_WARPS * B * 32 * 4
            <= t_hist.SMEM_BLOCK_MAX)
    assert plan.fill_smem <= t_hist.SMEM_BLOCK_MAX
    assert plan.count_smem == A * 4
    assert plan.window == n_pad and plan.chunks == 6
    assert plan.pcap == t_hist.FLOAT_HEAVY_SLOTS * 6
    sc = t_hist.FloatWalkScratch.empty(plan, A, G, B, C, "cpu")
    assert sc.ints.shape == (3 * A * 6 + 6 * A + 2 + plan.pcap,)
    # every slot's run padded to 16 positions, 16-byte aligned columns,
    # and a batch of slack past the last run
    R = t_hist.float_walk_rows(n_pad, A)
    assert R % 16 == 0 and R >= n_pad + 15 * A + t_hist.FLOAT_WALK_BATCH
    assert sc.sbins.shape == (G, R) and sc.sbins.dtype == torch.uint8
    assert sc.svals.shape == (C, R) and sc.svals.dtype == torch.int32
    assert sc.partial.shape == (plan.pcap, C, B, G)
    assert sc.meta(A, n_pad).shape == (6, A)


@pytest.mark.parametrize("mode", ["hhilo", "hilo"])
def test_float_walk_scratch_bounded(mode):
    """At 20M rows and 128 slots (the in-memory 255-leaf waves) the float
    K3's scratch is one window's, the same as at one window of rows:
    it does not grow with rows x slots, and stays a small part of the
    4 GiB the 20M in-memory runs may peak at."""
    C = t_hist.value_cols(mode)
    G, B, L = 28, 64, 255
    sizes = {}
    for n_pad in (t_hist.FLOAT_WINDOW, 20_000_000, 40_000_000):
        plan = t_hist.float_walk_plan(n_pad, 128, G, B, C, L, 132)
        assert plan.window == t_hist.FLOAT_WINDOW
        sc = t_hist.FloatWalkScratch.empty(plan, 128, G, B, C, "meta")
        sizes[n_pad] = sc.nbytes
    assert len(set(sizes.values())) == 1
    assert sizes[20_000_000] < 400 << 20
    # the heavy pairs' partials are at most FLOAT_HEAVY_SLOTS slots' worth
    plan = t_hist.float_walk_plan(20_000_000, 128, G, B, C, L, 132)
    assert plan.pcap == t_hist.FLOAT_HEAVY_SLOTS * plan.chunks
    assert plan.chunks == t_hist.FLOAT_WINDOW // t_hist.FLOAT_CHUNK


def test_float_walk_windows_and_threshold():
    """The float K3's windows of ``FLOAT_WINDOW`` rows (the last one
    shorter) and each window's walk budget,
    ``FLOAT_LIGHT_ROWS_PER_CHUNK`` rows per chunk of that window; the plan refuses waves it cannot hold."""
    W, ch = t_hist.FLOAT_WINDOW, t_hist.FLOAT_CHUNK
    plan = t_hist.float_walk_plan(2 * W + 8, 64, 28, 64, 4, 255, 132)
    assert plan.window == W and plan.chunks == W // ch
    assert plan.heavy_blocks == 132 * t_hist.FLOAT_HEAVY_BLOCKS_PER_SM
    rpc = t_hist.FLOAT_LIGHT_ROWS_PER_CHUNK
    assert t_hist.float_light_rows(W) == rpc * (W // ch)
    assert t_hist.float_light_rows(8) == rpc
    assert t_hist.float_light_rows(ch + 4) == 2 * rpc
    small = t_hist.float_walk_plan(4096, 8, 3, 8, 3, 7, 132)
    assert small.window == 4096 and small.chunks == 2
    assert small.heavy_blocks == -(-small.pcap * 3 // 4)
    with pytest.raises(ValueError, match="slots"):
        t_hist.float_walk_plan(4096, t_hist.FLOAT_WALK_MAX_SLOTS + 1, 3, 8,
                               3, 7, 132)
    with pytest.raises(ValueError, match="shared memory"):
        t_hist.float_walk_plan(4096, 8, 3, 512, 3, 7, 132)


@pytest.mark.parametrize("case", ["budget", "dense", "cap", "ties", "empty"])
def test_float_walk_split_rule(case):
    """The float K3 plan kernel's split (its host twin): a slot with more
    than ``light_rows`` rows keeps its first chunks up to that many rows
    for the walk (none from ``dense_rows`` rows on) and gives its later
    chunks with rows to partials, whose
    pairs are numbered on from the previous slot's, largest slots first
    and ties by slot, while they fit ``pcap``; the rest are walked
    whole.  -> ``(hbase, lrows, hcount)``."""
    f = t_hist.float_walk_split
    if case == "budget":
        # slot 1 (9 rows, first): 2 + 3 rows fit 5, chunk 3 goes heavy;
        # slot 2: its first chunk alone exceeds 5, so its 3 chunks with
        # rows go heavy, numbered after slot 1's; slot 0 fits
        assert f([[1, 1, 1, 0], [2, 3, 0, 4], [6, 0, 1, 1]], 5, 99, 10) == \
            ([-1, 0, 1], [3, 5, 0], [0, 1, 3])
    elif case == "dense":
        # slot 1 reaches the dense rows: all its chunks with rows go heavy
        assert f([[1, 1, 1, 0], [2, 3, 0, 4], [6, 0, 1, 1]], 5, 9, 10) == \
            ([-1, 0, 3], [3, 0, 0], [0, 3, 3])
    elif case == "cap":
        # the largest slot's 4 pairs fit, the next one's 3 would not: it
        # and every smaller slot are walked whole
        assert f([[9, 9, 9, 9], [9, 9, 9, 0], [6, 6, 0, 0]], 8, 99, 4) == \
            ([0, -1, -1], [0, 27, 12], [4, 0, 0])
    elif case == "ties":
        assert f([[4, 4], [4, 4]], 4, 99, 10) == ([0, 1], [4, 4], [1, 1])
    else:
        assert f([[0, 0], [0, 0]], 0, 0, 10) == ([-1, -1], [0, 0], [0, 0])
        assert f([], 4, 8, 10) == ([], [], [])
