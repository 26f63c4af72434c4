"""lightgbm_tpu_torch's distributed learners against the JAX package's.

A gloo world of two CPU ranks (``tests/torch_dist_worker.py``, started
once for the module) builds data-, feature- and voting-parallel trees
with ``parallel/learners.py:build_tree_distributed``; this process runs
the JAX package's ``build_tree_distributed`` on a 2-device mesh of its
virtual CPU devices, over the same bins and gradients (rows split
contiguously, as the mesh splits them), with the Pallas kernels in
interpret mode (``hist_backend="compact"``, ``LGBM_TPU_SPLIT_INTERPRET=1``):

* data-parallel trees equal the JAX package's bitwise in int8h (the K5
  and the K3 waves) and in a float mode, node for node, ``row_leaf`` and
  the leaf values included, on both ranks;
* feature-parallel equals the JAX package's serial ``build_tree`` (rows
  replicated, the argmax with the serial tie rule), and voting equals
  the JAX package's voting;
* the overlapped wave reduction equals the plain one bitwise with
  bagging and a feature mask, with one logical ``hist_psum`` record a
  wave and the same flight-recorder digest;
* ``_chunk_bounds`` is the JAX package's;
* a rank holds the quantized modes' row bound against its own rows, as
  the JAX package's shard does.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.io.dataset import BinnedDataset as JDataset
from lightgbm_tpu.io.device import feature_meta_np, to_device as j_to_device
from lightgbm_tpu.learner import serial as jserial
from lightgbm_tpu.ops import overlap as j_overlap
from lightgbm_tpu.ops import split as jsplit
from lightgbm_tpu.parallel import learners as jlearners
from lightgbm_tpu.parallel.mesh import make_mesh

from lightgbm_tpu_torch.ops import overlap as t_overlap

from tests.torch_dist_worker import run_world

torch.set_num_threads(1)   # tiny tensors: more threads only spin

N, F = 4096, 6
SPLIT = dict(min_data_in_leaf=10, min_sum_hessian_in_leaf=1e-3)
TREE_FIELDS = ("feature", "threshold_bin", "default_left", "left_child",
               "right_child", "internal_count", "gain", "internal_value")

# (name, learner, leaves, hist mode, extra): L=15 waves take K5, L=127
# the compact K3 (every wave at the 64-slot tail at <= 65,536 rows)
CASES = [
    ("data_int8h_k5", "data", 15, "int8h", {}),
    ("data_int8h_k3", "data", 127, "int8h", {}),
    ("data_hilo_k5", "data", 15, "hilo", {}),
    ("feature_int8h", "feature", 31, "int8h", {}),
    ("voting_int8h", "voting", 15, "int8h", {"top_k": 2}),
    ("data_bag_overlap", "data", 15, "int8h", {"bag": True, "overlap": True}),
    ("data_bag_plain", "data", 15, "int8h", {"bag": True, "overlap": False}),
    # the quantized modes' row bound between a rank's rows and the total
    ("data_int8h_rank_bound", "data", 15, "int8h", {"limit": 3000}),
]


def _inputs():
    rng = np.random.RandomState(11)
    X = rng.normal(size=(N, F))
    X[rng.rand(N) < 0.1, 2] = np.nan
    ds = JDataset.from_raw(X, JConfig.from_params({"max_bin": 63}))
    score = rng.normal(scale=0.5, size=N).astype(np.float32)
    y = ((X[:, 0] + 0.5 * np.nan_to_num(X[:, 2])
          + 0.3 * rng.normal(size=N)) > 0).astype(np.float32)
    p = 1.0 / (1.0 + np.exp(-score))
    g = (p - y).astype(np.float32)
    h = (p * (1.0 - p)).astype(np.float32)
    bag = rng.rand(N) < 0.7
    fmask = np.array([True, True, False, True, True, True])
    return ds, g, h, bag, fmask


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    if len(jax.devices()) < 2:
        pytest.skip("needs 2 virtual devices")
    ds, g, h, bag, fmask = _inputs()
    d = tmp_path_factory.mktemp("parallel")
    plain = str(d / "in.npz")
    np.savez(plain, bins=ds.bins, meta=np.array(feature_meta_np(ds)),
             grad=g, hess=h)
    masked = str(d / "in_bag.npz")
    np.savez(masked, bins=ds.bins, meta=np.array(feature_meta_np(ds)),
             grad=g, hess=h, bag=bag, fmask=fmask)
    cases = [dict(name=name, kind="learner", learner=lt, L=L, hist_mode=mode,
                  split=SPLIT, input=masked if ex.get("bag") else plain,
                  top_k=ex.get("top_k", 20), overlap=ex.get("overlap"),
                  env={"LGBM_TPU_OVERLAP_CHUNKS": "3"},
                  **({"int8_row_limit": ex["limit"]} if "limit" in ex
                     else {}))
             for name, lt, L, mode, ex in CASES]
    res = run_world(cases, 2, str(d / "out"))
    return ds, g, h, bag, fmask, res


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setenv("LGBM_TPU_SPLIT_INTERPRET", "1")


def _jax_dist(ds, g, h, lt, L, mode, bag=None, fmask=None, top_k=20,
              overlap=None):
    jd = j_to_device(ds)
    p = jserial.GrowthParams(num_leaves=L,
                             split=jsplit.SplitParams(**SPLIT))
    fn = jax.jit(functools.partial(
        jlearners.build_tree_distributed, make_mesh(2), "data", lt,
        top_k=top_k, hist_backend="compact", hist_mode=mode,
        overlap=overlap), static_argnums=(3,))
    return fn(jd, jnp.asarray(g), jnp.asarray(h), p,
              None if bag is None else jnp.asarray(bag),
              None if fmask is None else jnp.asarray(fmask))


def _ranks(res, name):
    per = res[name]
    for _, info in per:
        assert "error" not in info, info.get("traceback")
    return per


def _assert_tree_equal(t, jt):
    nl = int(jt.num_leaves)
    assert int(t["num_leaves"]) == nl and nl > 2
    m = nl - 1
    for name in TREE_FIELDS:
        np.testing.assert_array_equal(t[name][:m],
                                      np.asarray(getattr(jt, name))[:m],
                                      err_msg=name)
    for name in ("leaf_value", "leaf_count", "leaf_depth"):
        np.testing.assert_array_equal(t[name][:nl],
                                      np.asarray(getattr(jt, name))[:nl],
                                      err_msg=name)


def _rank_rows(r, n=N, world=2):
    per = -(-n // world)
    return slice(r * per, (r + 1) * per)


@pytest.mark.parametrize("name", ["data_int8h_k5", "data_int8h_k3",
                                  "data_hilo_k5"])
def test_data_parallel_equals_jax_mesh(world, name):
    ds, g, h, _, _, res = world
    _, lt, L, mode, _ = next(c for c in CASES if c[0] == name)
    jt = _jax_dist(ds, g, h, lt, L, mode)
    jrow = np.asarray(jt.row_leaf)
    for r, (t, info) in enumerate(_ranks(res, name)):
        _assert_tree_equal(t, jt)
        np.testing.assert_array_equal(t["row_leaf"], jrow[_rank_rows(r)])
        lv = np.asarray(jt.leaf_value)
        np.testing.assert_array_equal(t["row_value"],
                                      lv[jrow[_rank_rows(r)]])
        # K5 histograms the waves up to the compaction threshold
        assert (info["k5_calls"] > 0) == (L == 15)


def test_hist_mode_follows_the_ranks_rows(world, monkeypatch):
    """The quantized modes fall back to a float mode past a row bound
    (``effective_hist_mode``); a data-parallel rank, like the JAX
    package's shard, holds the bound against its own rows, whose int32
    histogram it accumulates.  With the bound between a rank's 2,048
    rows and the 4,096 of both, the tree is the JAX package's mesh tree
    under the same bound, and that is the int8h tree."""
    ds, g, h, _, _, res = world
    monkeypatch.setattr(jserial, "_INT8_ROW_LIMIT", 3000)
    jt = _jax_dist(ds, g, h, "data", 15, "int8h")
    jrow = np.asarray(jt.row_leaf)
    for r, (t, _) in enumerate(_ranks(res, "data_int8h_rank_bound")):
        _assert_tree_equal(t, jt)
        np.testing.assert_array_equal(t["row_leaf"], jrow[_rank_rows(r)])
    for (t, _), (t8, _) in zip(_ranks(res, "data_int8h_rank_bound"),
                               _ranks(res, "data_int8h_k5")):
        for k in t:
            np.testing.assert_array_equal(t[k], t8[k], err_msg=k)


def test_feature_parallel_equals_jax_serial(world):
    """The serial tree's decisions and rows (JAX ``tests/test_parallel.py:
    66-76`` compares the decisions): at <= 65,536 rows the serial build
    scans with the fused split kernel and the feature-parallel one with
    the scan of ``ops/split.py``, whose gains round differently (the JAX
    package's own pair differs the same way); the JAX package's
    feature-parallel tree is matched bit for bit."""
    ds, g, h, _, _, res = world
    jd = j_to_device(ds)
    p = jserial.GrowthParams(num_leaves=31,
                             split=jsplit.SplitParams(**SPLIT))
    jt = jax.jit(functools.partial(jserial.build_tree, hist_backend="compact",
                                   hist_mode="int8h"),
                 static_argnums=(3,))(jd, jnp.asarray(g), jnp.asarray(h), p)
    jf = _jax_dist(ds, g, h, "feature", 31, "int8h")
    nl = int(jt.num_leaves)
    for t, _ in _ranks(res, "feature_int8h"):
        assert int(t["num_leaves"]) == nl
        for name in ("feature", "threshold_bin", "default_left",
                     "left_child", "right_child", "internal_count"):
            np.testing.assert_array_equal(t[name][:nl - 1],
                                          np.asarray(getattr(jt, name))[
                                              :nl - 1], err_msg=name)
        np.testing.assert_array_equal(t["row_leaf"], np.asarray(jt.row_leaf))
        _assert_tree_equal(t, jf)
        np.testing.assert_array_equal(t["row_leaf"], np.asarray(jf.row_leaf))


def test_voting_parallel_equals_jax_voting(world):
    ds, g, h, _, _, res = world
    jt = _jax_dist(ds, g, h, "voting", 15, "int8h", top_k=2)
    jrow = np.asarray(jt.row_leaf)
    for r, (t, _) in enumerate(_ranks(res, "voting_int8h")):
        _assert_tree_equal(t, jt)
        np.testing.assert_array_equal(t["row_leaf"], jrow[_rank_rows(r)])


def test_overlap_bitwise_with_bagging_and_feature_mask(world):
    ds, g, h, bag, fmask, res = world
    over = _ranks(res, "data_bag_overlap")
    plain = _ranks(res, "data_bag_plain")
    jt = _jax_dist(ds, g, h, "data", 15, "int8h", bag=bag, fmask=fmask,
                   overlap=True)
    for r in range(2):
        t_o, i_o = over[r]
        t_p, i_p = plain[r]
        for k in t_o:
            np.testing.assert_array_equal(t_o[k], t_p[k], err_msg=k)
        _assert_tree_equal(t_o, jt)
        # one logical hist_psum record a wave (+ the root statistics),
        # the same schedule digest either way
        assert i_o["hist_psum_records"] == i_p["hist_psum_records"] > 2
        assert i_o["fr_digest"] == i_p["fr_digest"]
        assert i_o["fr_count"] == i_p["fr_count"]
    # the masked-out feature never splits
    assert 2 not in t_o["feature"][:int(t_o["num_leaves"]) - 1]


@pytest.mark.parametrize("G,chunks", [(1, 2), (6, 2), (6, 3), (7, 3),
                                      (28, 2), (28, 5), (4, 8)])
def test_chunk_bounds_match(G, chunks):
    assert t_overlap._chunk_bounds(G, chunks) == j_overlap._chunk_bounds(
        G, chunks)


def test_ranks_identical_everywhere(world):
    """Every field of every case is the same on both ranks but the
    row-indexed ones of the row-splitting learners."""
    res = world[-1]
    for name, lt, *_ in CASES:
        (a, _), (b, _) = _ranks(res, name)
        for k in a:
            if k in ("row_leaf", "row_value") and lt != "feature":
                continue
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"{name}/{k}")
