"""Categorical features end to end, in both packages at toy size on the CPU.

* The split scan: the port's ``find_best_splits`` with
  ``any_categorical=True`` against the JAX package's (jitted, as its
  learner runs it) on seeded grids with one-hot and many-vs-many
  features, unoccupied bins, ties in the sort key, the
  ``max_cat_threshold`` cap and a chunked feature axis: every field of
  the winner bitwise (gains, sums and outputs included).
* Whole models through ``lgb.train``.  The JAX side runs its
  histogram and route kernels in Pallas interpret mode
  (``LGBM_TPU_HIST_BACKEND=compact``; its split kernel is gated off
  categorical data in both packages, so both run their vectorized
  scan); the port runs its kernels' plain versions.  One-hot,
  many-vs-many, the 127-leaf route + leaf-compacted path and an
  EFB-bundled categorical column give the JAX package's ``digest()``
  (scores included); a float mode holds the ladder of
  ``test_float_train_matches_reference``; a valid set with unseen
  categories and early stopping gives the same ``best_iteration`` with
  metrics within ``tol("metric_coarse")``; a pandas DataFrame with
  ``category`` columns gives the JAX model's digest.  The digest, not
  the model text, is compared: the text also carries each node's
  ``internal_value``, and the JAX package's root value differs between
  its own compiled paths (its per-iteration loop and its fused window)
  by hundreds of ulps where the port's root sum lies closer to the exact
  one.
* Model text and serving: a port model round-trips
  ``save_model_to_string``; a JAX-saved categorical model loaded through
  ``convert`` predicts what the JAX booster predicts; the compiled
  predictor's binned categorical path (unseen, negative and NaN
  categories) routes as its raw path, the host walk and the JAX
  package's compiled predictor do, trained or loaded and bin-aligned.
* Streaming: a ``categorical_column`` CSV store streamed gives the
  digest of in-memory training on the same store, and the JAX package's
  streamed digest or, past the sigmoid's ulp (see
  ``tests/test_torch_streaming.py``), its trees with leaf values within
  ``tol("f32_eps_few")``.
"""
import os

import numpy as np
import pandas as pd
import pytest
import torch

from tools.numcheck.tolerance_registry import tol

import jax
import jax.numpy as jnp

import lightgbm_tpu as jlgb
from lightgbm_tpu.basic import Booster as JBooster
from lightgbm_tpu.boosting.streaming import StreamTrainer as JStream
from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.io import outofcore as j_oc
from lightgbm_tpu.metric.metrics import binary_auc
from lightgbm_tpu.ops import split as jsplit
from lightgbm_tpu.parallel.envelope import model_flip_report
from lightgbm_tpu.serve import compile_model as jcompile_model

import lightgbm_tpu_torch as tlgb
from lightgbm_tpu_torch.boosting.gbdt import GBDT
from lightgbm_tpu_torch.boosting.streaming import StreamTrainer
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.convert import booster_from_model_string
from lightgbm_tpu_torch.io import outofcore as t_oc
from lightgbm_tpu_torch.learner.serial import STREAM_CHUNK
from lightgbm_tpu_torch.models.tree import Tree, predict_leaf
from lightgbm_tpu_torch.ops import compact as t_compact
from lightgbm_tpu_torch.ops import histogram as t_hist
from lightgbm_tpu_torch.ops import route as t_route
from lightgbm_tpu_torch.ops import split as tsplit
from lightgbm_tpu_torch.ops import split_kernel as t_split
from lightgbm_tpu_torch.serve import compile_model, compile_trees

from chip_smoke import CAT_COLUMNS, cat_nodes, categorize

torch.set_num_threads(1)   # tiny tensors: more threads only spin

ITERS = 4
PARAMS = {"objective": "binary", "num_leaves": 15, "max_bin": 63,
          "learning_rate": 0.1, "min_data_in_leaf": 20, "verbose": -1}


# ---------------------------------------------------------------------------
# the split scan
# ---------------------------------------------------------------------------
def _cat_grid(seed, L=10, F=7, B=64, ties=False):
    """A histogram grid with consistent leaf totals: features 0-1 one-hot
    sized (3 and 4 bins), 2-5 many-vs-many with unoccupied bins, 6
    numerical.  ``ties`` quantizes the gradients and hessians so that
    many bins share their sort key."""
    rng = np.random.RandomState(seed)
    num_bins = rng.randint(5, B, size=F).astype(np.int32)
    num_bins[:2] = (3, 4)
    cnt = rng.randint(0, 30, size=(L, F, B)).astype(np.float32)
    cnt[rng.rand(L, F, B) < 0.3] = 0.0
    valid = np.arange(B)[None, None, :] < num_bins[None, :, None]
    cnt = np.where(valid, cnt, 0.0).astype(np.float32)
    g = rng.normal(size=(L, F, B)) * cnt * 0.1
    h = cnt * 0.25
    if ties:
        g = np.round(g)
        h = np.where(cnt > 0, 2.0, 0.0)
    grid = np.stack([np.where(valid, g, 0.0), h, cnt], -1).astype(np.float32)
    tot = grid.sum(axis=2).max(axis=1)               # [L, 3]
    mt = rng.randint(0, 3, size=F).astype(np.int32)
    db = rng.randint(0, 3, size=F).astype(np.int32)
    is_cat = np.ones(F, bool)
    is_cat[6] = False
    return grid, tot, num_bins, mt, db, is_cat


SCAN_CASES = {
    "onehot_and_many": (dict(seed=0), dict(lambda_l2=0.1), None),
    "ties": (dict(seed=1, ties=True), dict(min_data_in_leaf=3), None),
    "cat_threshold_cap": (dict(seed=2), dict(max_cat_threshold=2,
                                             cat_smooth=1.0), None),
    "l1_chunked": (dict(seed=3), dict(lambda_l1=0.5, cat_l2=1.0), 2),
}


@pytest.mark.parametrize("case", list(SCAN_CASES))
def test_categorical_scan_matches_reference(case):
    grid_kw, params, chunk = SCAN_CASES[case]
    grid, tot, nb, mt, db, ic = _cat_grid(**grid_kw)
    jp = jsplit.SplitParams(**params)

    def jscan(*a):
        return jsplit.find_best_splits(*a, params=jp, any_categorical=True,
                                       any_missing=True, feature_chunk=chunk)
    jr = jax.jit(jscan)(jnp.asarray(grid), jnp.asarray(tot[:, 0]),
                        jnp.asarray(tot[:, 1]), jnp.asarray(tot[:, 2]),
                        jnp.asarray(nb), jnp.asarray(mt), jnp.asarray(db),
                        jnp.asarray(ic))
    tr = tsplit.find_best_splits(
        torch.as_tensor(grid), torch.as_tensor(tot[:, 0]),
        torch.as_tensor(tot[:, 1]), torch.as_tensor(tot[:, 2]),
        torch.as_tensor(nb), torch.as_tensor(mt), torch.as_tensor(db),
        tsplit.SplitParams(**params), any_missing=True, feature_chunk=chunk,
        is_categorical=torch.as_tensor(ic), any_categorical=True)
    cat = np.asarray(jr.is_categorical)
    mask = np.asarray(jr.cat_mask)
    assert cat.any()
    if case == "cat_threshold_cap":
        many = cat & (nb[np.asarray(jr.feature)] > 4)
        assert many.any() and (mask[many].sum(1) <= 2).all()
    for name in ("gain", "feature", "threshold", "default_left",
                 "is_categorical", "cat_mask", "left_sum_grad",
                 "left_sum_hess", "left_count", "right_sum_grad",
                 "right_sum_hess", "right_count", "left_output",
                 "right_output"):
        np.testing.assert_array_equal(getattr(tr, name).numpy(),
                                      np.asarray(getattr(jr, name)), name)
    if chunk is not None:
        whole = tsplit.find_best_splits(
            torch.as_tensor(grid), torch.as_tensor(tot[:, 0]),
            torch.as_tensor(tot[:, 1]), torch.as_tensor(tot[:, 2]),
            torch.as_tensor(nb), torch.as_tensor(mt), torch.as_tensor(db),
            tsplit.SplitParams(**params), is_categorical=torch.as_tensor(ic),
            any_categorical=True)
        for name in ("gain", "feature", "cat_mask", "left_output"):
            assert torch.equal(getattr(whole, name), getattr(tr, name))


# ---------------------------------------------------------------------------
# whole models
# ---------------------------------------------------------------------------
def _cat_data(seed=0, n=3000, f=6, many=12, few=4, noise=80, efb=False):
    """Labels from the continuous columns, then columns 1-3 made
    categorical (:func:`chip_smoke.categorize`: 12 permuted buckets, 4
    permuted buckets, 80 noise categories past ``max_bin``).  ``efb``
    adds three sparse mutually exclusive columns, the middle one
    categorical, which EFB bundles."""
    rng = np.random.RandomState(seed)
    X = rng.normal(size=(n, f)).astype(np.float32)
    y = (X[:, 0] * 2 + X[:, 1] - X[:, 2] + rng.normal(size=n)
         > 0).astype(np.float32)
    categorize(X, seed + 1, many=many, few=few, noise=noise)
    cats = list(CAT_COLUMNS)
    if efb:
        rows = np.arange(n)
        on = rng.rand(n) < 0.3
        extra = np.zeros((n, 3), np.float32)
        extra[:, 0] = np.where((rows % 3 == 0) & on, rng.normal(size=n), 0)
        extra[:, 1] = np.where((rows % 3 == 1) & on,
                               rng.randint(1, 7, size=n), 0)
        extra[:, 2] = np.where((rows % 3 == 2) & on, rng.normal(size=n), 0)
        y = (y + (extra[:, 1] % 2 == 1) > 0.5).astype(np.float32)
        X = np.concatenate([X, extra], axis=1)
        cats.append(f + 1)
    return X, y, cats


WRAPPERS = (t_hist.hist_route_raw, t_compact.hist_compact_raw,
            t_route.route_rows_raw, t_route.route_rows_values_raw,
            t_split.find_best_splits_kernel)
FUSED = {t_hist.hist_route_raw, t_route.route_rows_values_raw}
COMPACT = {t_compact.hist_compact_raw, t_route.route_rows_raw,
           t_route.route_rows_values_raw}

MODEL_CASES = {
    # one categorical column of 4 categories: one-vs-rest only
    "onehot": (dict(), dict(), [2], FUSED),
    "many_vs_many": (dict(), dict(), None, FUSED),
    "compact": (dict(seed=1), dict(num_leaves=127), None, COMPACT),
    "efb_bundled": (dict(seed=2, efb=True), dict(), None, FUSED),
}


@pytest.mark.parametrize("case", list(MODEL_CASES))
def test_categorical_model_matches_reference(monkeypatch, case):
    monkeypatch.setenv("LGBM_TPU_HIST_BACKEND", "compact")
    data_kw, extra, cats, expect = MODEL_CASES[case]
    X, y, all_cats = _cat_data(**data_kw)
    cats = cats or all_cats
    params = dict(PARAMS, **extra)
    jb = jlgb.train(dict(params), jlgb.Dataset(X, label=y,
                                               categorical_feature=cats),
                    num_boost_round=ITERS)
    before = {w: w.plain_calls for w in WRAPPERS}
    tb = tlgb.train(dict(params), tlgb.Dataset(X, label=y,
                                               categorical_feature=cats),
                    num_boost_round=ITERS, device="cpu")
    assert {w for w in WRAPPERS if w.plain_calls > before[w]} == expect
    if case == "efb_bundled":
        ds = tb._gbdt.train_set
        assert ds.bundle.is_bundled and any(
            len(grp) > 1 and 7 in grp for grp in ds.bundle.groups)
    assert tb.digest() == jb.digest()
    nodes = cat_nodes(tb._gbdt.models)
    assert set(nodes.get(2, [1])) == {1}        # 4 bins: one-vs-rest
    if case == "onehot":
        assert nodes[2]
    elif case == "efb_bundled":
        assert nodes.get(7)
    else:
        assert max(nodes[1]) > 1
    # same trees: the two predictors differ only in float32 summation
    np.testing.assert_allclose(tb.predict(X, raw_score=True),
                               jb.predict(X, raw_score=True), rtol=0,
                               atol=tol("f32_accum"))


def test_categorical_float_mode_ladder(monkeypatch):
    """hhilo through the float K1: the ladder of
    ``test_float_train_matches_reference`` (the same trees with leaf
    values within ``tol("f32_eps_few")``, or a first divergence at a
    near-tie; train AUC within ``tol("metric_coarse")``)."""
    monkeypatch.setenv("LGBM_TPU_HIST_BACKEND", "compact")
    X, y, cats = _cat_data(seed=4)
    params = dict(PARAMS, hist_mode="hhilo")
    jb = jlgb.train(dict(params), jlgb.Dataset(X, label=y,
                                               categorical_feature=cats),
                    num_boost_round=ITERS)
    before = t_hist.hist_route_float_raw.plain_calls
    tb = tlgb.train(dict(params), tlgb.Dataset(X, label=y,
                                               categorical_feature=cats),
                    num_boost_round=ITERS, device="cpu")
    assert t_hist.hist_route_float_raw.plain_calls > before
    assert any(t.num_cat for t in tb._gbdt.models)
    rep = model_flip_report(jb.model_to_string(), tb.model_to_string())
    assert rep["near_tie"], rep
    if rep["flip_tree"] is None:
        assert rep["max_leaf_value_gap"] <= tol("f32_eps_few"), rep
    assert abs(binary_auc(y, jb.predict(X)) - binary_auc(y, tb.predict(X))
               ) <= tol("metric_coarse")


def _valid_run(lgb, X, y, Xv, yv, cats, params, evals, **kw):
    ds = lgb.Dataset(X, label=y, categorical_feature=cats)
    vs = lgb.Dataset(Xv, label=yv, reference=ds, categorical_feature=cats)
    return lgb.train(dict(params), ds, num_boost_round=12,
                     valid_sets=[vs], valid_names=["valid"],
                     early_stopping_rounds=2, evals_result=evals,
                     verbose_eval=False, **kw)


def test_categorical_valid_set_early_stopping(monkeypatch):
    """A valid set with categories the training set never saw (binned to
    the last bin, as the reference bins them) and early stopping on
    noisy labels at a high learning rate: ``best_iteration`` equal to
    both JAX runs (its callback loop and its fused window, as
    ``tests/test_torch_valid.py`` explains), every metric within
    ``tol("metric_coarse")`` of the callback loop's, the digest the
    fused window's."""
    monkeypatch.setenv("LGBM_TPU_HIST_BACKEND", "compact")
    rng = np.random.RandomState(9)
    n, nv = 2000, 500
    X = rng.normal(size=(n + nv, 6)).astype(np.float32)
    y = (X[:, 0] + X[:, 1] - X[:, 2] + rng.normal(scale=3.0, size=n + nv)
         > 0).astype(np.float32)
    categorize(X, 10, many=12, noise=40, valid_from=n)
    Xv, yv = X[n:], y[n:]
    X, y = X[:n], y[:n]
    assert X[:, 1].max() < 12 <= Xv[:, 1].max()
    params = dict(PARAMS, metric="auc,binary_logloss", learning_rate=1.0,
                  num_leaves=31, min_data_in_leaf=5)
    ref_evals, evals = {}, {}
    jcb = _valid_run(jlgb, X, y, Xv, yv, CAT_COLUMNS, params, ref_evals)
    jfast = _valid_run(jlgb, X, y, Xv, yv, CAT_COLUMNS, params, None)
    tb = _valid_run(tlgb, X, y, Xv, yv, CAT_COLUMNS, params, evals,
                    device="cpu")
    assert tb.best_iteration == jcb.best_iteration == jfast.best_iteration
    assert tb.best_iteration < tb.current_iteration() < 12
    assert any(t.num_cat for t in tb._gbdt.models)
    for metric, ref in ref_evals["valid"].items():
        np.testing.assert_allclose(evals["valid"][metric], ref,
                                   rtol=tol("metric_coarse"),
                                   atol=tol("metric_coarse"))
    assert tb.digest(include_scores=False) == jfast.digest(
        include_scores=False)


def test_pandas_category_columns(monkeypatch):
    """A DataFrame whose categorical columns have the ``category`` dtype
    (string categories): ``categorical_feature="auto"`` takes them, as
    does a list of column names; both give the JAX model's digest."""
    monkeypatch.setenv("LGBM_TPU_HIST_BACKEND", "compact")
    X, y, cats = _cat_data(seed=5)
    names = [f"f{i}" for i in range(X.shape[1])]
    df = pd.DataFrame(X, columns=names)
    for c in cats:
        df[names[c]] = pd.Categorical(
            [f"c{int(v)}" for v in X[:, c]])
    df.loc[df.index[::97], names[1]] = np.nan
    jb = jlgb.train(dict(PARAMS), jlgb.Dataset(df, label=y),
                    num_boost_round=ITERS)
    tb = tlgb.train(dict(PARAMS), tlgb.Dataset(df, label=y),
                    num_boost_round=ITERS, device="cpu")
    assert tb._gbdt.train_set.feature_names == names
    assert list(np.nonzero(
        tb._gbdt.train_set.feature_info.is_categorical)[0]) == cats
    assert tb.digest() == jb.digest()
    by_name = tlgb.train(dict(PARAMS), tlgb.Dataset(df, label=y),
                         num_boost_round=ITERS, device="cpu",
                         categorical_feature=[names[c] for c in cats])
    assert by_name.digest() == jb.digest()
    np.testing.assert_allclose(tb.predict(df, raw_score=True),
                               jb.predict(df, raw_score=True), rtol=0,
                               atol=tol("f32_accum"))


# ---------------------------------------------------------------------------
# model text and serving
# ---------------------------------------------------------------------------
def _query(X, seed, n=1500):
    """Rows like ``X`` whose categorical columns hold seen, unseen,
    negative and NaN categories."""
    rng = np.random.RandomState(seed)
    Q = X[rng.randint(0, len(X), size=n)].copy()
    for c in CAT_COLUMNS:
        odd = rng.rand(n)
        Q[odd < 0.05, c] = 500 + rng.randint(0, 9, size=int((odd < 0.05)
                                                           .sum()))
        Q[(odd >= 0.05) & (odd < 0.08), c] = -1 - rng.randint(0, 3)
        Q[(odd >= 0.08) & (odd < 0.1), c] = np.nan
    return Q


def test_categorical_model_text_round_trip(monkeypatch):
    monkeypatch.setenv("LGBM_TPU_HIST_BACKEND", "compact")
    X, y, cats = _cat_data(seed=6)
    tb = tlgb.train(dict(PARAMS), tlgb.Dataset(X, label=y,
                                               categorical_feature=cats),
                    num_boost_round=ITERS, device="cpu")
    text = tb.model_to_string()
    assert "cat_boundaries=" in text and "cat_threshold=" in text
    Q = _query(X, 1)
    back = booster_from_model_string(text, device="cpu")
    assert back.model_to_string().split("feature_infos=")[1].split(
        "\n", 1)[1] == text.split("feature_infos=")[1].split("\n", 1)[1]
    np.testing.assert_array_equal(back.predict(Q, raw_score=True),
                                  tb.predict(Q, raw_score=True))
    # a JAX-saved categorical model predicts in the port what the JAX
    # booster predicts (the same host walk in float64: bitwise)
    jb = jlgb.train(dict(PARAMS), jlgb.Dataset(X, label=y,
                                               categorical_feature=cats),
                    num_boost_round=ITERS)
    jtext = jb.model_to_string()
    loaded = booster_from_model_string(jtext, device="cpu")
    np.testing.assert_array_equal(loaded.predict(Q, raw_score=True),
                                  JBooster(model_str=jtext).predict(
                                      Q, raw_score=True))
    np.testing.assert_array_equal(loaded.predict(Q, pred_leaf=True),
                                  jb.predict(Q, pred_leaf=True))


def test_binned_categorical_serving(monkeypatch):
    """The compiled predictor on a categorical model: leaf routing binned
    == raw == the host walk on rows with unseen, negative and NaN
    categories (an unseen category bins to the sentinel and goes right),
    == the JAX package's compiled predictor; a loaded model made
    bin-aligned with ``Tree.align_with_mappers`` serves binned rows the
    same way."""
    monkeypatch.setenv("LGBM_TPU_HIST_BACKEND", "compact")
    X, y, cats = _cat_data(seed=7)
    tb = tlgb.train(dict(PARAMS), tlgb.Dataset(X, label=y,
                                               categorical_feature=cats),
                    num_boost_round=ITERS, device="cpu")
    g = tb._gbdt
    assert any(t.num_cat for t in g.models)
    cm = compile_model(tb)
    assert cm.has_binned and cm.pack.catbin_words is not None
    Q = _query(X, 2)
    bins = cm.bin_rows(Q)
    host = predict_leaf(g.models, Q)
    raw = cm.leaf_indices(Q)
    np.testing.assert_array_equal(raw, host)
    np.testing.assert_array_equal(cm.leaf_indices(bins, binned=True), host)
    np.testing.assert_array_equal(cm.predict_raw(bins, binned=True),
                                  cm.predict_raw(Q))
    jb = jlgb.train(dict(PARAMS), jlgb.Dataset(X, label=y,
                                               categorical_feature=cats),
                    num_boost_round=ITERS)
    assert jb.digest() == tb.digest()
    np.testing.assert_array_equal(jcompile_model(jb).leaf_indices(Q), raw)
    # loaded: value bitsets only, until aligned with the mappers
    trees = [Tree.from_string(t.to_string()) for t in g.models]
    ds = g.train_set
    fmap = {f: i for i, f in enumerate(ds.used_features)}
    for t in trees:
        t.align_with_mappers(ds.mappers, fmap)
    for t, ref in zip(trees, g.models):
        assert len(t.cat_left_bins) == len(ref.cat_left_bins) == t.num_cat
        for a, b in zip(t.cat_left_bins, ref.cat_left_bins):
            np.testing.assert_array_equal(a, b)
    lm = compile_trees(trees, mappers=ds.mappers,
                       used_features=ds.used_features,
                       num_features=X.shape[1], device="cpu")
    np.testing.assert_array_equal(lm.leaf_indices(bins, binned=True), host)


# ---------------------------------------------------------------------------
# streaming
# ---------------------------------------------------------------------------
def test_categorical_stream_matches_in_memory_and_reference(tmp_path,
                                                            monkeypatch):
    """A CSV store ingested with ``categorical_column`` (the label first,
    so features 1-3 are file columns 2-4), streamed in two blocks: the
    digest of in-memory training on ``store.to_binned_dataset``, and the
    JAX package's streamed digest on its own ingest of the same files
    (its wide kernel fold in interpret mode)."""
    X, y, _ = _cat_data(seed=8, n=12000)
    rows = np.concatenate([y[:, None], X], axis=1)
    paths = []
    for i, (a, b) in enumerate([(0, 5000), (5000, len(rows))]):
        p = os.path.join(str(tmp_path), f"part{i}.csv")
        np.savetxt(p, rows[a:b], delimiter=",", fmt="%.9g")
        paths.append(p)
    params = dict(PARAMS, categorical_column="2,3,4")
    cfg = Config.from_params(params)
    store = t_oc.ingest(paths, cfg, str(tmp_path / "port"))
    assert [store.mappers[c].bin_type for c in CAT_COLUMNS] == [1, 1, 1]
    tr = StreamTrainer(cfg, store, block_rows=STREAM_CHUNK, device="cpu")
    assert len(tr.blocks) > 1
    st = tr.train(ITERS)
    assert any(t.num_cat for t in st.models)
    mem = GBDT(cfg, store.to_binned_dataset(cfg), "cpu")
    for _ in range(ITERS):
        mem.train_one_iter()
    assert st.digest() == mem.digest()
    monkeypatch.setenv("LGBM_TPU_HIST_BACKEND", "pallas")
    jcfg = JConfig.from_params(params)
    jstore = j_oc.ingest(paths, jcfg, str(tmp_path / "jax"))
    assert jstore.manifest["mapper_digest"] == store.manifest["mapper_digest"]
    ref = JStream(jcfg, jstore, block_rows=STREAM_CHUNK).train(ITERS)
    if ref.digest() != st.digest():
        # tests/test_torch_streaming.py's exception: from the second
        # iteration the binary gradients differ by an ulp between
        # torch.sigmoid and XLA's logistic, which can move an int8 code
        rep = model_flip_report(ref.save_model_to_string(),
                                st.save_model_to_string())
        assert rep["near_tie"], rep
        if rep["flip_tree"] is None:
            assert rep["max_leaf_value_gap"] <= tol("f32_eps_few"), rep
