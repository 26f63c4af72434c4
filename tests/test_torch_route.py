"""The per-leaf record layout of the route kernels K2/K4 in its plain form
(``ops/route.py`` ``route_records`` and ``route_by_records``, the layout
of ``csrc/route_row.cuh`` ``RecordLeaf``), on the CPU.

At deep-tree tables (2,048 and 131,072 leaves), with EFB-bundled and
categorical leaves, bagged-out and padding rows, and fields past 16 bits
(thresholds and bins past 70,000 on int32 bins, right-child ids past
65,535, group ids past 255, EFB offsets and NaN bins past 65,535), the
route by records must equal the port's ``route_plain`` and the JAX
package's ``route_rows_xla`` bit for bit, and at 2,048 leaves also its
Pallas kernels in interpret mode (K2 and K4).  Integer work: exact.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from lightgbm_tpu.ops.pallas_route import (route_rows_pallas,
                                           route_rows_values_pallas,
                                           route_rows_xla)

from lightgbm_tpu_torch.io.binning import MISSING_NAN, MISSING_ZERO
from lightgbm_tpu_torch.ops import route as t_route

from tests.route_waves import CASES, deep_wave

torch.set_num_threads(1)   # tiny tensors: more threads only spin


ORDER = ("feature", "threshold", "default_left", "is_categorical",
         "cat_mask", "sel", "new_id")
META = ("missing_types", "nan_bins", "default_bins", "feat_group",
        "feat_offset", "num_bins")


def _tabs(tables, metas):
    args = [torch.as_tensor(tables[k]) for k in ORDER] + [
        torch.as_tensor(metas[k]) for k in META]
    return t_route.leaf_tables(*args)


def _jax_args(tables, metas):
    return [jnp.asarray(tables[k]) for k in ORDER] + [
        jnp.asarray(metas[k]) for k in META]


@pytest.mark.parametrize("case", list(CASES), ids=list(CASES))
def test_records_route_as_reference(case):
    """route_by_records(route_records(tabs)) == route_plain == the JAX
    package's route_rows_xla, bitwise; the wrapper takes the plain
    version on the CPU (int32 bins count into ``ROUTE_I32``)."""
    kw = CASES[case]
    bins_t, leaf2, tables, metas = deep_wave(**kw)
    tabs, cat = _tabs(tables, metas)
    bt, l2 = torch.as_tensor(bins_t), torch.as_tensor(leaf2)
    rec, bits = t_route.route_records(tabs)
    got = t_route.route_by_records(bt, l2, rec, bits, cat)
    n = kw["n"]
    ref = np.asarray(route_rows_xla(
        jnp.asarray(bins_t[:, :n].T), jnp.asarray(leaf2),
        *_jax_args(tables, metas)))
    np.testing.assert_array_equal(got.numpy(), ref)
    count = t_route.ROUTE_I32 if kw.get("int32") else t_route.route_rows_raw
    before = count.plain_calls
    assert torch.equal(t_route.route_rows_raw(bt, l2, tabs, cat), got)
    assert count.plain_calls == before + 1
    moved = got[0, :n] != l2[0, :n]
    assert moved.any() and (got[:, n:] == -1).all()
    assert (got[1, :n][l2[1, :n] < 0] == -1).all()
    # the fields the case is about reach past their narrow widths
    sel = tabs[t_route.T_SEL] != 0
    if kw["L"] > 65536:
        assert int(got[0].max()) > 65535
    if kw["max_bin"] > 70000:
        wide = tabs[:, sel]
        for row in (t_route.T_THR, t_route.T_OFF, t_route.T_NB,
                    t_route.T_NANB):
            assert int(wide[row].max()) > 70000, row
        assert int(wide[t_route.T_GROUP].max()) > 255
        assert int(bt.max()) > 70000
    if kw.get("cat_share"):
        on_cat = (tabs[t_route.T_ISCAT] != 0)[l2[0, :n].clamp(min=0)] & \
            sel[l2[0, :n].clamp(min=0)] & (l2[0, :n] >= 0)
        assert 0 < int((moved & on_cat).sum()) < int(on_cat.sum())


@pytest.mark.parametrize("case", ["2048-64", "2048-1024-efb-cat"])
def test_records_route_as_pallas_kernels(case):
    """At 2,048 leaves the route by records and the route values on it
    equal the JAX package's Pallas K2 and K4 in interpret mode."""
    kw = CASES[case]
    bins_t, leaf2, tables, metas = deep_wave(**kw)
    tabs, cat = _tabs(tables, metas)
    bt, l2 = torch.as_tensor(bins_t), torch.as_tensor(leaf2)
    got = t_route.route_by_records(bt, l2, *t_route.route_records(tabs),
                                   cat)
    args = _jax_args(tables, metas)
    any_cat = bool(kw.get("cat_share"))
    ref = np.asarray(route_rows_pallas(jnp.asarray(bins_t),
                                       jnp.asarray(leaf2), *args,
                                       any_cat=any_cat, interpret=True))
    np.testing.assert_array_equal(got.numpy(), ref)
    lv = np.random.RandomState(5).normal(scale=0.3, size=kw["L"]).astype(
        np.float32)
    ref_l2, ref_v = route_rows_values_pallas(
        jnp.asarray(bins_t), jnp.asarray(leaf2), *args, jnp.asarray(lv),
        any_cat=any_cat, interpret=True)
    got_l2, got_v = t_route.route_values_plain(bt, l2, tabs, cat,
                                               torch.as_tensor(lv))
    np.testing.assert_array_equal(got_l2.numpy(), np.asarray(ref_l2))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(ref_v))
    assert torch.equal(got_l2, got)


def test_route_records_layout():
    """Each split leaf's record holds its table fields at full width in
    the kernels' order, flags as csrc/route_row.cuh defines them (the
    missing type NaN or zero, any other value as 0); the selection map
    holds bit ``i % 32`` of word ``i // 32`` for leaf ``i``, unselected
    leaves' records are zero."""
    bins_t, leaf2, tables, metas = deep_wave(**CASES["131072-wide-fields"])
    tabs, _ = _tabs(tables, metas)
    tabs[t_route.T_MT, ::7] = 5          # no missing type the route knows
    rec, bits = t_route.route_records(tabs)
    L = tabs.shape[1]
    assert rec.shape == (L, 8) and rec.dtype == torch.int32
    assert bits.shape == (L // 32,) and bits.dtype == torch.int32
    sel = tabs[t_route.T_SEL] != 0
    word = bits.long()[torch.arange(L) // 32]
    assert torch.equal((word >> (torch.arange(L) % 32)) & 1, sel.long())
    assert (rec[~sel] == 0).all()
    t = tabs[:, sel]
    r = rec[sel]
    for col, row in ((0, t_route.T_GROUP), (1, t_route.T_THR),
                     (2, t_route.T_NEWID), (4, t_route.T_OFF),
                     (5, t_route.T_NB), (6, t_route.T_DB),
                     (7, t_route.T_NANB)):
        assert torch.equal(r[:, col], t[row]), col
    flags = r[:, 3]
    mt = t[t_route.T_MT]
    assert torch.equal((flags & t_route.REC_CAT) != 0,
                       t[t_route.T_ISCAT] != 0)
    assert torch.equal((flags & t_route.REC_DEFAULT_LEFT) != 0,
                       t[t_route.T_DL] != 0)
    known = (mt == MISSING_NAN) | (mt == MISSING_ZERO)
    assert torch.equal(flags >> t_route.REC_MT_SHIFT,
                       torch.where(known, mt, 0))
    assert (~known).any() and (mt == MISSING_NAN).any()
    bt, l2 = torch.as_tensor(bins_t), torch.as_tensor(leaf2)
    cat = torch.zeros((L, 64), dtype=torch.uint8)
    assert torch.equal(t_route.route_by_records(bt, l2, rec, bits, cat),
                       t_route.route_plain(bt, l2, tabs, cat))
