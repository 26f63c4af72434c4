"""The model surface of lightgbm_tpu_torch, held against the JAX package
at toy size on the CPU: the JSON dump, feature importance, rollback,
``add_valid`` after training started, refit, SHAP contributions,
prediction early stopping, model files, the ``Dataset`` accessors and
binary files, copies and pickles.

Where both packages train, the model is L2 regression, which they build
bitwise (scores included; the JAX package on its kernel path in
interpret mode, ``LGBM_TPU_HIST_BACKEND=compact``,
``LGBM_TPU_SPLIT_INTERPRET=1``), so what both compute from the same
trees must agree bitwise or within the named tolerance given.
"""
import copy
import pickle

import numpy as np
import pytest
import torch

from tools.numcheck.tolerance_registry import tol

import lightgbm_tpu as jlgb
from lightgbm_tpu.basic import Booster as JBooster
from lightgbm_tpu.io.dataset import BinnedDataset as JBinnedDataset

import lightgbm_tpu_torch as tlgb
from lightgbm_tpu_torch.io.dataset import BinnedDataset
from lightgbm_tpu_torch.models.tree import predict_leaf

torch.set_num_threads(1)   # tiny tensors: more threads only spin

ITERS = 6


def _data(n=3000, f=6, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.normal(size=(n, f)).astype(np.float32)
    y = (X[:, 0] * 2 + X[:, 1] - X[:, 2]
         + 0.3 * rng.normal(size=n)).astype(np.float32)
    return X, y


def _params(**kw):
    p = {"objective": "regression", "num_leaves": 15, "max_bin": 63,
         "learning_rate": 0.1, "min_data_in_leaf": 20, "verbose": -1}
    p.update(kw)
    return p


@pytest.fixture
def pair(monkeypatch):
    """The same L2 model trained in both packages: ``(jax, port, X, y)``,
    each Booster with its training ``Dataset`` as ``train_ds``; equal
    digests (scores included) are the premise of every comparison."""
    monkeypatch.setenv("LGBM_TPU_HIST_BACKEND", "compact")
    monkeypatch.setenv("LGBM_TPU_SPLIT_INTERPRET", "1")
    X, y = _data()
    jds, tds = jlgb.Dataset(X, label=y), tlgb.Dataset(X, label=y)
    jb = jlgb.train(_params(), jds, num_boost_round=ITERS,
                    verbose_eval=False)
    tb = tlgb.train(_params(), tds, num_boost_round=ITERS,
                    verbose_eval=False, device="cpu")
    jb.train_ds, tb.train_ds = jds, tds
    assert tb.digest() == jb.digest()
    return jb, tb, X, y


def test_dump_model_and_importance_match_reference(pair):
    jb, tb, _, _ = pair
    assert tb.dump_model() == jb.dump_model()
    assert tb.dump_model(num_iteration=2) == jb.dump_model(num_iteration=2)
    for kind in ("split", "gain"):
        np.testing.assert_array_equal(tb.feature_importance(kind),
                                      jb.feature_importance(kind))
    assert tb.feature_name() == jb.feature_name()
    assert tb.num_feature() == jb.num_feature() == 6
    assert tb.num_trees() == jb.num_trees() == ITERS


def test_rollback_matches_reference(pair):
    """Rollback subtracts the replayed f32 outputs of the last trees:
    the scores equal the JAX package's bitwise, twice over."""
    jb, tb, X, _ = pair
    for _ in range(2):
        jb.rollback_one_iter()
        tb.rollback_one_iter()
        np.testing.assert_array_equal(tb._gbdt.scores.numpy(),
                                      np.asarray(jb._gbdt.scores))
    assert tb.current_iteration() == jb.current_iteration == ITERS - 2
    assert tb.model_to_string() == jb.model_to_string()


def test_add_valid_mid_run_matches_reference(pair):
    """A valid set added after training started gets the existing trees
    replayed into its scores: bitwise the JAX package's; one more
    iteration then scores it as a set attached from the start."""
    jb, tb, _, _ = pair
    Xv, yv = _data(n=700, seed=5)
    jb.add_valid(jb.train_ds.create_valid(Xv, label=yv), "v")
    tb.add_valid(tb.train_ds.create_valid(Xv, label=yv), "v")
    np.testing.assert_array_equal(tb._gbdt._valid_scores[0].numpy(),
                                  np.asarray(jb._gbdt._valid_scores[0]))
    assert tb.eval_valid() == [(n, m, pytest.approx(v), h)
                               for n, m, v, h in jb.eval_valid()]
    tb.update()
    raw = tb.predict(Xv, raw_score=True, device=False,
                     num_iteration=ITERS + 1)
    np.testing.assert_allclose(tb._gbdt._valid_scores[0].numpy()[:, 0],
                               raw, rtol=0, atol=tol("f32_tight"))


def test_refit_matches_reference(pair):
    """Refit on the training rows: the leaf values equal the JAX
    package's bitwise.  (The JAX package bins the refit rows with fresh
    mappers and aligns the trees to them, which routes some rows of new
    data otherwise than the trees' own thresholds do; on the training
    rows the fresh mappers are the training mappers, and both packages
    route as the host walk.  The port always routes as the host walk:
    ``test_refit_leaves_follow_host_walk``.)"""
    jb, tb, X, y = pair
    jr = jb.refit(X, y, decay_rate=0.7)
    tr = tb.refit(X, y, decay_rate=0.7)
    assert tr.num_trees() == jr.num_trees() == ITERS
    for t_tree, j_tree in zip(tr._gbdt.models, jr._gbdt.models):
        np.testing.assert_array_equal(t_tree.leaf_value, j_tree.leaf_value)
    np.testing.assert_array_equal(tr._gbdt.scores.numpy(),
                                  np.asarray(jr._gbdt.scores))
    # the refitted model differs from the source and leaves it alone
    assert tr.model_to_string() != tb.model_to_string()
    assert tb.digest() == jb.digest()


def test_refit_leaves_follow_host_walk():
    """On new rows each row's leaf is the host walk's (the compiled
    predictor's walk on the Booster's device), the refit is computed
    from those leaves in float64 as a numpy refit, and ``kwargs`` reach
    the new Booster's parameters."""
    X, y = _data()
    tb = tlgb.train(_params(), tlgb.Dataset(X, label=y), num_boost_round=3,
                    verbose_eval=False, device="cpu")
    X2, y2 = _data(n=1500, seed=9)
    new = tlgb.Booster(params=_params(), model_str=tb.model_to_string(),
                       device="cpu")
    from lightgbm_tpu_torch.io.dataset import Metadata
    md = Metadata()
    md.set_field("label", y2)
    leaves = new._gbdt.refit_rows(X2, md, decay_rate=0.5)
    np.testing.assert_array_equal(leaves, predict_leaf(tb._gbdt.models, X2))
    # the numpy refit of the same leaves (L2: grad = score - label)
    score = np.zeros(len(y2), np.float32)
    for i, t in enumerate(tb._gbdt.models):
        g = (score - y2).astype(np.float32)
        nl = t.num_leaves
        sg = np.zeros(nl)
        cnt = np.zeros(nl)
        np.add.at(sg, leaves[:, i], g)
        np.add.at(cnt, leaves[:, i], 1.0)
        with np.errstate(divide="ignore", invalid="ignore"):
            out = -sg / cnt
        want = np.where(cnt > 0, 0.5 * t.leaf_value[:nl]
                        + 0.5 * out * 0.1, t.leaf_value[:nl])
        np.testing.assert_array_equal(new._gbdt.models[i].leaf_value[:nl],
                                      want)
        score = score + want.astype(np.float32)[leaves[:, i]]
    r = tb.refit(X2, y2, lambda_l2=5.0)
    assert r._gbdt.config.lambda_l2 == 5.0
    assert r.num_trees() == 3


def test_pred_contrib_matches_reference(pair):
    """TreeSHAP on the host: the JAX package's values (both packages
    run the same compiled recursion, ``ltpu_treeshap``; the models are
    each package's own training), summing to the raw prediction."""
    jb, tb, X, _ = pair
    tc = tb.predict(X[:300], pred_contrib=True)
    jc = jb.predict(X[:300], pred_contrib=True)
    assert tc.shape == (300, 7)
    np.testing.assert_allclose(tc, jc, rtol=0, atol=tol("f64_chain"))
    np.testing.assert_allclose(tc.sum(axis=1),
                               tb.predict(X[:300], raw_score=True),
                               rtol=0, atol=tol("f64_chain"))


def _ulps(got32, want64):
    """|f32 - f64| in f32 ulps of the f64 value."""
    want32 = np.float32(want64)
    return np.abs(got32.astype(np.float64) - want64) / np.spacing(
        np.abs(want32)).astype(np.float64)


def test_pred_early_stop_matches_reference(monkeypatch):
    """``pred_early_stop`` rounds: the port's host walk (float64 sums in
    tree order) against the JAX package (each round's float32 sum added
    in float64) within ``f32_accum``, the same rows stopping; the
    compiled predictor's rounds (``device=True``) route as the host
    rounds and score within 1 f32 ulp of their float64 sums."""
    monkeypatch.setenv("LGBM_TPU_HIST_BACKEND", "compact")
    monkeypatch.setenv("LGBM_TPU_SPLIT_INTERPRET", "1")
    X, y = _data()
    es = {"pred_early_stop": True, "pred_early_stop_freq": 2,
          "pred_early_stop_margin": 0.5}
    jb = jlgb.train(_params(**es), jlgb.Dataset(X, label=y),
                    num_boost_round=ITERS, verbose_eval=False)
    tb = tlgb.train(_params(**es), tlgb.Dataset(X, label=y),
                    num_boost_round=ITERS, verbose_eval=False, device="cpu")
    assert tb.digest() == jb.digest()
    raw, taken = tb._gbdt.predict_raw_early_stop(X, ITERS)
    assert 0 < (taken < 3).sum() < len(X)      # some rows stop early
    np.testing.assert_array_equal(tb.predict(X, raw_score=True), raw[:, 0])
    np.testing.assert_allclose(raw[:, 0], jb.predict(X, raw_score=True),
                               rtol=tol("f32_accum"), atol=tol("f32_accum"))
    cm = tb._device_predictor()
    draw, dtaken = cm.predict_raw_early_stop(X, 2, 0.5)
    np.testing.assert_array_equal(dtaken, taken)
    assert _ulps(draw, raw[:, 0]).max() <= tol("serve_ulp")
    np.testing.assert_array_equal(
        tb.predict(X, raw_score=True, device=True), draw)


def test_pred_early_stop_multiclass_rounds():
    """With K trees an iteration the margin is top1 - top2: the compiled
    rounds route as the host rounds, within 1 ulp."""
    rng = np.random.RandomState(4)
    X = rng.normal(size=(2000, 5)).astype(np.float32)
    y = np.digitize(X[:, 0] + 0.5 * X[:, 1], [-0.5, 0.5]).astype(np.float32)
    p = {"objective": "multiclass", "num_class": 3, "num_leaves": 7,
         "verbose": -1, "pred_early_stop": True, "pred_early_stop_freq": 3,
         "pred_early_stop_margin": 0.4}
    tb = tlgb.train(p, tlgb.Dataset(X, label=y), num_boost_round=9,
                    verbose_eval=False, device="cpu")
    raw, taken = tb._gbdt.predict_raw_early_stop(X, tb.num_trees())
    assert 0 < (taken < 3).sum() < len(X)
    draw, dtaken = tb._device_predictor().predict_raw_early_stop(X, 3, 0.4)
    np.testing.assert_array_equal(dtaken, taken)
    assert _ulps(draw, raw).max() <= tol("serve_ulp")
    prob = tb.predict(X, device=False)
    np.testing.assert_allclose(prob.sum(axis=1), 1.0, rtol=0,
                               atol=tol("f32_tight"))


def test_model_files_cross_packages(pair, tmp_path):
    """A model file either package saves loads in the other: the same
    host raw scores, and the same text written back."""
    jb, tb, X, _ = pair
    tpath, jpath = str(tmp_path / "port.txt"), str(tmp_path / "jax.txt")
    tb.save_model(tpath)
    jb.save_model(jpath)
    with open(tpath) as f, open(jpath) as g:
        assert f.read() == g.read()
    jl = JBooster(model_file=tpath)
    tl = tlgb.Booster(model_file=jpath, device="cpu")
    np.testing.assert_array_equal(tl.predict(X, raw_score=True),
                                  jl.predict(X, raw_score=True))
    assert tl.model_to_string() == jl.model_to_string()
    # the module-level entry point loads a file or a string
    np.testing.assert_array_equal(
        tlgb.predict(tpath, X, raw_score=True, device=False),
        tl.predict(X, raw_score=True))
    np.testing.assert_array_equal(
        tlgb.predict(tb.model_to_string(num_iteration=2), X, device=False),
        tb.predict(X, num_iteration=2))
    other = tlgb.Booster(model_str=tl.model_to_string(num_iteration=1),
                         device="cpu")
    assert other.model_from_string(tb.model_to_string()) is other
    assert other.num_trees() == ITERS


def test_dataset_fields_and_subset(tmp_path):
    X, y = _data(n=400)
    ds = tlgb.Dataset(X, label=y, params={"max_bin": 63})
    assert ds.num_data() == 400 and ds.num_feature() == 6
    assert ds.feature_names == [f"Column_{i}" for i in range(6)]
    np.testing.assert_array_equal(ds.get_label(), y)
    w = np.linspace(0.5, 1.5, 400).astype(np.float32)
    ds.set_weight(w)
    ds.set_init_score(np.full(400, 0.25))
    ds.set_label(y * 2)
    np.testing.assert_array_equal(ds.get_weight(), w)
    np.testing.assert_array_equal(ds.get_init_score(), np.full(400, 0.25))
    np.testing.assert_array_equal(ds.get_label(), y * 2)
    ds.set_group([100, 300])
    np.testing.assert_array_equal(ds.get_group(), [100, 300])
    ds.set_field("group", None)
    assert ds.get_field("group") is None
    idx = np.arange(0, 400, 3)
    sub = ds.subset(idx)
    assert sub.num_data() == len(idx)
    np.testing.assert_array_equal(sub._constructed.bins,
                                  ds._constructed.bins[idx])
    np.testing.assert_array_equal(sub.get_label(), (y * 2)[idx])
    # binary files cross both ways
    tpath, jpath = str(tmp_path / "port.bin"), str(tmp_path / "jax.bin")
    ds.save_binary(tpath)
    jds = jlgb.Dataset(X, label=y, params={"max_bin": 63}).construct()
    jds.save_binary(jpath)
    jl = JBinnedDataset.load_binary(tpath)
    tl = BinnedDataset.load_binary(jpath)
    np.testing.assert_array_equal(jl.bins, ds._constructed.bins)
    np.testing.assert_array_equal(tl.bins, jds._constructed.bins)
    np.testing.assert_array_equal(jl.metadata.weight, w)
    np.testing.assert_array_equal(tl.metadata.label, y)


def test_pickle_and_copy_keep_model_text(tmp_path):
    X, y = _data(n=800)
    tb = tlgb.train(_params(), tlgb.Dataset(X, label=y), num_boost_round=3,
                    verbose_eval=False, device="cpu")
    tb.best_iteration = 2
    text = tb.model_to_string()
    for other in (pickle.loads(pickle.dumps(tb)), copy.copy(tb),
                  copy.deepcopy(tb)):
        assert other.model_to_string() == text
        assert other.best_iteration == 2
        assert other.device == "cpu"
        np.testing.assert_array_equal(other.predict(X), tb.predict(X))
    state = tb.__getstate__()
    assert not any(isinstance(v, torch.Tensor) for v in state.values())


def test_rollback_then_update_serves_new_trees():
    """The compiled predictor is cached per model length: rollback and a
    new ``update`` keep the length, so rollback must drop the cache, or
    the old tree would be served."""
    X, y = _data(n=1500)
    bst = tlgb.train(_params(), tlgb.Dataset(X, label=y), num_boost_round=4,
                     verbose_eval=False, device="cpu")
    before = bst.predict(X, raw_score=True, device=True)
    bst.rollback_one_iter()
    assert bst.num_trees() == 3
    bst._gbdt.reset_config({"learning_rate": 0.3})
    bst.update()                    # another fourth tree
    after = bst.predict(X, raw_score=True, device=True)
    host = bst.predict(X, raw_score=True, device=False)
    assert not np.array_equal(after, before)
    assert _ulps(after, host).max() <= tol("serve_ulp")
