"""lightgbm_tpu_torch's serving path (``lightgbm_tpu_torch/serve/``) and
loaded-model prediction, against the JAX package on the CPU.

* The compiled predictor routes every row to the same leaf (bitwise) as
  the JAX package's ``compile_model(...).leaf_indices`` and the port's
  host oracle (``models/tree.py:predict_leaf``), on models the JAX
  package trained and carried across as model text (NaN-missing,
  zero-as-missing, categorical with unseen categories, 3 classes) and on
  a seeded forest of the port's own trees (stumps, every missing type,
  categorical nodes; ``chip_smoke.random_forest``); its scores are
  within ``tol("serve_ulp")`` f32 ulp of the f64 sequential host sum,
  per class.
* The binned path of a port-trained model routes and scores as its raw
  path, and ``bin_rows`` equals the JAX package's.
* ``Booster.predict``: ``device=True`` / ``pred_leaf`` / truncation
  against the host path; ``pred_contrib`` raises.
* The micro-batching ``PredictionServer``: mixed sizes with latency
  stats, a transient fault retried with no request dropped or resolved
  twice, a non-transient fault failing fast, exhausted retries
  delivering the exception, drain on close (as ``tests/test_serve.py``
  holds the JAX package's).
* Loaded models: 3-class models predict ``[n, 3]`` and every objective
  the JAX package names converts its output as the JAX package's
  loaded Booster does; an objective the port cannot name raises; a
  trained Poisson model converts its output as the JAX package's.
"""
import numpy as np
import pytest
import torch

from tools.numcheck.tolerance_registry import tol

import lightgbm_tpu as jlgb
from lightgbm_tpu.models.tree import Tree as JTree
from lightgbm_tpu.objective.objectives import RegressionL2 as JRegressionL2
from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.serve import compile_model as jcompile_model
from lightgbm_tpu.serve import compile_trees as jcompile_trees

import lightgbm_tpu_torch as tlgb
from lightgbm_tpu_torch.models.tree import Tree, predict_leaf
from lightgbm_tpu_torch.serve import (PredictionServer, compile_model,
                                      compile_trees, next_bucket)
from lightgbm_tpu_torch.serve.server import _default_buckets
from lightgbm_tpu_torch.utils import faults
from lightgbm_tpu_torch.utils.retry import RetryPolicy

from chip_smoke import forest_rows, random_forest

torch.set_num_threads(1)   # tiny tensors: more threads only spin

FAST_RETRY = RetryPolicy(attempts=3, base_s=0.0, max_s=0.0, jitter=0.0)
F32_TINY = np.finfo(np.float32).tiny


@pytest.fixture(autouse=True)
def _clean_faults():
    faults.clear()
    yield
    faults.clear()


def _jax_train(n=2500, f=6, nan_frac=0.0, seed=0, cat_cols=(), **params):
    """A model trained by the JAX package (as ``tests/test_serve.py``
    trains its own): ``(jax booster, port booster loaded from its model
    text on the CPU)``."""
    rng = np.random.RandomState(seed)
    cols = [rng.normal(size=(n, f)).astype(np.float32)]
    for _ in cat_cols:
        cols.append(rng.randint(0, 25, size=(n, 1)).astype(np.float32))
    X = np.concatenate(cols, axis=1)
    if nan_frac:
        X[rng.rand(*X.shape) < nan_frac] = np.nan
    y = (np.nan_to_num(X[:, 0]) + np.nan_to_num(X[:, 1])
         + (X[:, f] % 3 == 1 if cat_cols else 0) > 0).astype(np.float32)
    p = {"objective": "binary", "num_leaves": 15, "num_iterations": 8,
         "max_bin": 63, "verbose": -1, "min_data_in_leaf": 5}
    p.update(params)
    if p["objective"] == "multiclass":
        y = rng.randint(0, p["num_class"], size=n).astype(np.float32)
    cat = [f + i for i in range(len(cat_cols))] or "auto"
    bst = jlgb.train(p, jlgb.Dataset(X, label=y, params=p,
                                     categorical_feature=cat))
    return bst, tlgb.Booster(model_str=bst.model_to_string(), device="cpu")


def _query(tbst, n=800, nan_frac=0.0, seed=1, cat_hi=30, zero_frac=0.0):
    """Query rows; categorical columns get integers with UNSEEN and
    negative values."""
    f = tbst._gbdt.max_feature_idx + 1
    rng = np.random.RandomState(seed)
    X = rng.normal(size=(n, f)).astype(np.float32)
    for t in tbst._gbdt.models:
        for node in range(t.num_leaves - 1):
            if t.decision_type[node] & 1:
                X[:, t.split_feature[node]] = rng.randint(
                    -2, cat_hi, size=n).astype(np.float32)
    if zero_frac:
        X[rng.rand(n, f) < zero_frac] = 0.0
    if nan_frac:
        X[rng.rand(n, f) < nan_frac] = np.nan
    return X


def _oracle(models, X, K=1):
    """Sequential f64 sum over trees, tree t into class t % K."""
    X64 = np.asarray(X, np.float64)
    out = np.zeros((X.shape[0], K))
    for i, t in enumerate(models):
        out[:, i % K] += t.predict_batch(X64)
    return out if K > 1 else out[:, 0]


def _assert_ulp(dev, oracle):
    """Per element within ``tol("serve_ulp")`` f32 ulp of the oracle."""
    assert dev.dtype == np.float32
    diff = np.abs(np.asarray(dev, np.float64) - oracle)
    ulp = np.spacing(np.abs(oracle).astype(np.float32)).astype(np.float64)
    assert np.all(diff <= tol("serve_ulp") * ulp), \
        f"max {np.max(diff / ulp):.2f} ulp"


# ---------------------------------------------------------------------------
# routing and scores against the JAX package and the host oracle
# ---------------------------------------------------------------------------
JAX_MODELS = {
    "nan_missing": (dict(nan_frac=0.15), dict(nan_frac=0.15)),
    "zero_as_missing": (dict(seed=3, zero_as_missing=True),
                        dict(seed=4, zero_frac=0.2)),
    "categorical_unseen": (dict(seed=7, cat_cols=(0, 1), num_iterations=10),
                           dict(seed=8, nan_frac=0.05, cat_hi=40)),
    "multiclass3": (dict(seed=5, objective="multiclass", num_class=3,
                         num_leaves=7, num_iterations=5, nan_frac=0.1),
                    dict(seed=6, nan_frac=0.1)),
}


@pytest.mark.parametrize("case", list(JAX_MODELS))
def test_routing_and_scores_match_jax(case):
    train_kw, query_kw = JAX_MODELS[case]
    jbst, tbst = _jax_train(**train_kw)
    models = tbst._gbdt.models
    K = tbst._gbdt.num_tree_per_iteration
    if case == "categorical_unseen":
        assert any(t.num_cat > 0 for t in models)
    cm = compile_model(tbst)
    assert not cm.has_binned and cm.device.type == "cpu"
    Xq = _query(tbst, **query_kw)
    got = cm.leaf_indices(Xq)
    assert got.dtype == np.int32 and got.shape == (len(Xq), len(models))
    assert np.array_equal(got, predict_leaf(models, Xq))
    assert np.array_equal(got, jcompile_model(jbst).leaf_indices(Xq))
    raw = cm.predict_raw(Xq)
    assert raw.shape == ((len(Xq), K) if K > 1 else (len(Xq),))
    _assert_ulp(raw, _oracle(models, Xq, K))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_seeded_forest_routing(seed):
    """Stumps, every missing type, categorical nodes, thresholds at the
    zero threshold's edges and inputs one f32 step either side of each
    threshold: bitwise the host oracle (denormal inputs included) and,
    on normal inputs, the JAX package's compiled predictor (XLA on the
    CPU flushes denormal inputs to zero)."""
    trees = random_forest(seed)
    assert any(t.num_leaves == 1 for t in trees)
    assert any(t.num_cat for t in trees)
    X = forest_rows(trees, 2000, seed + 100)
    cm = compile_trees(trees, num_class=3, device="cpu")
    got = cm.leaf_indices(X)
    assert np.array_equal(got, predict_leaf(trees, X))
    _assert_ulp(cm.predict_raw(X), _oracle(trees, X, 3))
    Xn = X.copy()
    Xn[(Xn != 0) & (np.abs(Xn) < F32_TINY)] = 0.0
    jtrees = [JTree.from_string(t.to_string()) for t in trees]
    assert np.array_equal(cm.leaf_indices(Xn), jcompile_trees(
        jtrees, num_class=3).leaf_indices(Xn))


def test_stump_forest_and_class_padding():
    """``num_leaves == 1`` stumps route every row to leaf 0; a tree count
    that is not a multiple of the classes is padded with zero stumps."""
    t1 = Tree(2)
    t1.leaf_value[0] = 0.625
    t2 = Tree(2)
    t2.leaf_value[0] = -1.0 / 3.0
    X = np.random.RandomState(0).normal(size=(64, 3)).astype(np.float32)
    cm = compile_trees([t1, t2], device="cpu")
    assert np.array_equal(cm.leaf_indices(X), np.zeros((64, 2), np.int32))
    _assert_ulp(cm.predict_raw(X), _oracle([t1, t2], X))
    trees = random_forest(4, num_class=2, iters=3)[:5]
    X = forest_rows(trees, 300, 9)
    cm = compile_trees(trees, num_class=2, device="cpu")
    assert cm.leaf_indices(X).shape == (300, 5)
    _assert_ulp(cm.predict_raw(X), _oracle(trees, X, 2))


def test_serve_entry_points_default_to_the_card():
    """``build_pack`` and ``compile_trees`` pack onto the card unless
    asked for the CPU (here there is no card: the default raises)."""
    import inspect
    from lightgbm_tpu_torch.serve import build_pack
    for fn in (build_pack, compile_trees):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    trees = random_forest(2, num_class=1, iters=2)
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            compile_trees(trees)
    assert build_pack(trees, device="cpu").leaf_value.device.type == "cpu"
    assert compile_trees(trees, device="cpu").device.type == "cpu"


def test_empty_forest_predicts_base_score():
    cm = compile_trees([], base_score=0.25, device="cpu")
    out = cm.predict_raw(np.zeros((3, 2), np.float32))
    assert np.array_equal(out, np.full(3, 0.25, np.float32))
    assert cm.leaf_indices(np.zeros((3, 2), np.float32)).shape == (3, 0)


# ---------------------------------------------------------------------------
# the binned path of a port-trained model
# ---------------------------------------------------------------------------
def _train_both(nan_frac, zero_as_missing, seed=0, n=2000, f=5):
    rng = np.random.RandomState(seed)
    X = rng.normal(size=(n, f)).astype(np.float32)
    X[rng.rand(n, f) < 0.1] = 0.0
    if nan_frac:
        X[rng.rand(n, f) < nan_frac] = np.nan
    y = (np.nan_to_num(X[:, 0]) - np.nan_to_num(X[:, 2]) > 0).astype(
        np.float32)
    p = {"objective": "binary", "num_leaves": 15, "max_bin": 63,
         "min_data_in_leaf": 5, "verbose": -1,
         "zero_as_missing": zero_as_missing}
    tbst = tlgb.train(dict(p), tlgb.Dataset(X, label=y), num_boost_round=6,
                      device="cpu")
    jbst = jlgb.train(dict(p, num_iterations=6),
                      jlgb.Dataset(X, label=y, params=p))
    return tbst, jbst


@pytest.mark.parametrize("nan_frac,zero_as_missing",
                         [(0.1, False), (0.0, True)],
                         ids=["nan_missing", "zero_as_missing"])
def test_binned_path_matches_raw_path(nan_frac, zero_as_missing):
    tbst, jbst = _train_both(nan_frac, zero_as_missing)
    cm = compile_model(tbst)
    assert cm.has_binned
    Xq = _query(tbst, n=700, nan_frac=nan_frac, zero_frac=0.15, seed=2)
    bins = cm.bin_rows(Xq)
    assert bins.dtype == np.uint8
    assert np.array_equal(bins, jcompile_model(jbst).bin_rows(Xq))
    assert np.array_equal(cm.leaf_indices(bins, binned=True),
                          cm.leaf_indices(Xq))
    assert np.array_equal(cm.leaf_indices(Xq),
                          predict_leaf(tbst._gbdt.models, Xq))
    assert np.array_equal(cm.predict_raw(bins, binned=True),
                          cm.predict_raw(Xq))
    _assert_ulp(cm.predict_raw(Xq), _oracle(tbst._gbdt.models, Xq))


def test_binned_path_needs_mappers():
    _, tbst = _jax_train(n=600, num_iterations=2)
    cm = compile_model(tbst)
    with pytest.raises(ValueError, match="without bin mappers"):
        cm.bin_rows(np.zeros((2, 6), np.float32))
    with pytest.raises(ValueError, match="feature columns"):
        cm.predict_raw(np.zeros((2, 3), np.float32))


# ---------------------------------------------------------------------------
# Booster.predict surfaces and truncation
# ---------------------------------------------------------------------------
def test_truncation_multiclass():
    jbst, tbst = _jax_train(seed=5, objective="multiclass", num_class=3,
                            num_leaves=7, num_iterations=6, n=900)
    g = tbst._gbdt
    assert g.num_tree_per_iteration == 3 and len(g.models) == 18
    Xq = _query(tbst, n=200, seed=3)
    full = tbst.predict(Xq, pred_leaf=True)
    cut = tbst.predict(Xq, num_iteration=2, pred_leaf=True)
    assert cut.shape == (200, 6) and np.array_equal(cut, full[:, :6])
    assert np.array_equal(
        tbst.predict(Xq, num_iteration=2, pred_leaf=True, device=True), cut)
    raw2 = tbst.predict(Xq, num_iteration=2, raw_score=True)
    assert raw2.shape == (200, 3)
    np.testing.assert_allclose(
        raw2, jbst.predict(Xq, num_iteration=2, raw_score=True),
        rtol=tol("f32_tight"), atol=tol("f32_tight"))
    _assert_ulp(tbst.predict(Xq, num_iteration=2, raw_score=True,
                             device=True), _oracle(g.models[:6], Xq, 3))
    tbst.best_iteration = 2
    assert np.array_equal(tbst.predict(Xq, raw_score=True), raw2)
    assert np.array_equal(tbst.predict(Xq, pred_leaf=True), cut)


@pytest.mark.parametrize("source", ["port_trained", "jax_loaded"])
def test_booster_device_matches_host(source):
    if source == "port_trained":
        tbst, _ = _train_both(0.1, False)
    else:
        _, tbst = _jax_train(nan_frac=0.1)
    Xq = _query(tbst, nan_frac=0.1)
    for raw in (True, False):
        np.testing.assert_allclose(
            tbst.predict(Xq, raw_score=raw, device=True),
            tbst.predict(Xq, raw_score=raw),
            rtol=tol("f32_accum"), atol=tol("f32_accum_2x"))
    assert np.array_equal(tbst.predict(Xq, pred_leaf=True, device=True),
                          tbst.predict(Xq, pred_leaf=True))
    cm = tbst._device_predictor(-1)
    assert tbst._device_predictor(-1) is cm      # cached per truncation


def test_booster_device_default(monkeypatch):
    """``device=None`` follows the Booster's device: the host walk on the
    CPU, the compiled predictor on ``cuda`` (here a CPU-compiled stand-in
    behind ``_device_predictor``, so the choice is checked without a
    card)."""
    _, tbst = _jax_train(n=600, num_iterations=3)
    Xq = _query(tbst, n=100)
    host = tbst.predict(Xq, raw_score=True)
    assert host.dtype == np.float64              # the f64 host walk
    assert not tbst._serve_cache
    cm = compile_model(tbst)
    asked = []
    monkeypatch.setattr(tbst, "_device_predictor",
                        lambda n=-1: asked.append(n) or cm)
    tbst.device = "cuda"
    got = tbst.predict(Xq, raw_score=True)
    leaves = tbst.predict(Xq, pred_leaf=True)
    assert asked == [-1, -1]                     # took the serving path
    _assert_ulp(got, host)
    assert np.array_equal(leaves, predict_leaf(tbst._gbdt.models, Xq))
    # device=False reaches the host walk on a cuda Booster
    assert np.array_equal(tbst.predict(Xq, raw_score=True, device=False),
                          host)
    assert asked == [-1, -1]


def test_pred_contrib_raises():
    """``pred_contrib`` on a loaded model no longer raises: it takes the
    host path, as the JAX package's does, and gives its SHAP values."""
    jbst, tbst = _jax_train(n=600, num_iterations=2)
    X = np.random.RandomState(1).normal(size=(50, 6)).astype(np.float32)
    np.testing.assert_allclose(tbst.predict(X, pred_contrib=True),
                               jbst.predict(X, pred_contrib=True),
                               rtol=0, atol=tol("f64_chain"))


# ---------------------------------------------------------------------------
# the micro-batching server (as tests/test_serve.py:324-462)
# ---------------------------------------------------------------------------
def _server_model():
    _, tbst = _jax_train(n=800, f=4, num_iterations=4, num_leaves=7)
    return compile_model(tbst)


def test_server_mixed_sizes_and_latency():
    cm = _server_model()
    rng = np.random.RandomState(3)
    with PredictionServer(cm, max_batch=256, max_wait_ms=1.0,
                          buckets=(64, 256), min_bucket=64,
                          raw_score=True) as srv:
        reqs = [rng.normal(size=(k, 4)).astype(np.float32)
                for k in (1, 5, 40, 1, 120, 7, 256, 200)]
        futs = [srv.submit(r) for r in reqs]
        for r, fu in zip(reqs, futs):
            np.testing.assert_array_equal(np.atleast_1d(fu.result(60)),
                                          np.atleast_1d(cm.predict_raw(r)))
        st = srv.stats()
    assert st["resolved"] == len(reqs) and st["failed"] == 0
    assert st["pending"] == 0 and st["rows"] == sum(len(r) for r in reqs)
    assert st["steady_captures"] == 0 and st["steady_eager"] == 0
    assert st["latency_ms"] and set(st["latency_ms"]) <= {64, 256}
    for rec in st["latency_ms"].values():
        assert rec["p99"] >= rec["p50"] >= 0.0


def test_server_converted_and_binned():
    tbst, _ = _train_both(0.0, False, n=800)
    cm = compile_model(tbst)
    rng = np.random.RandomState(4)
    reqs = [rng.normal(size=(k, 5)).astype(np.float32) for k in (3, 1, 30)]
    with PredictionServer(cm, max_batch=64, buckets=(64,)) as srv:
        got = [srv.predict(r) for r in reqs]
    for r, g in zip(reqs, got):
        np.testing.assert_array_equal(np.atleast_1d(g), cm.predict(r))
    with PredictionServer(cm, max_batch=64, buckets=(64,), binned=True,
                          raw_score=True) as srv:
        got = [srv.predict(cm.bin_rows(r)) for r in reqs]
    for r, g in zip(reqs, got):
        np.testing.assert_array_equal(np.atleast_1d(g), cm.predict_raw(r))


def test_server_fault_retries_no_drop_no_double():
    """A mid-batch transient fault retries through ``utils/retry`` and
    every request still resolves exactly once with correct scores."""
    cm = _server_model()
    rng = np.random.RandomState(4)
    reqs = [rng.normal(size=(k, 4)).astype(np.float32)
            for k in (3, 9, 2, 50, 1)]
    faults.inject("serve.score", times=1)        # transient (UNAVAILABLE)
    with PredictionServer(cm, max_batch=128, max_wait_ms=1.0,
                          buckets=(128,), min_bucket=128, raw_score=True,
                          retry_policy=FAST_RETRY) as srv:
        futs = [srv.submit(r) for r in reqs]
        results = [fu.result(60) for fu in futs]
        st = srv.stats()
    assert faults.fired("serve.score") == 1
    assert faults.calls("serve.score") >= 2      # the batch was re-scored
    for r, got in zip(reqs, results):
        np.testing.assert_array_equal(np.atleast_1d(got),
                                      np.atleast_1d(cm.predict_raw(r)))
    assert st["resolved"] == len(reqs)
    assert st["failed"] == 0 and st["pending"] == 0


def test_server_nontransient_fails_fast_and_delivers_errors():
    cm = _server_model()
    faults.inject("serve.score", times=1, transient=False)
    with PredictionServer(cm, max_batch=64, max_wait_ms=0.5,
                          buckets=(64,), min_bucket=64, raw_score=True,
                          retry_policy=FAST_RETRY) as srv:
        fu = srv.submit(np.zeros((2, 4), np.float32))
        with pytest.raises(faults.FaultInjected):
            fu.result(60)
        ok = srv.predict(np.zeros((1, 4), np.float32))  # still serving
        st = srv.stats()
    assert faults.fired("serve.score") == 1      # no retry on PERMANENT
    assert np.isfinite(ok)
    assert st["failed"] == 1 and st["resolved"] == 1 and st["pending"] == 0


def test_server_exhausted_retries_deliver_exception():
    cm = _server_model()
    faults.inject("serve.score", times=10)       # outlives the budget
    with PredictionServer(cm, max_batch=64, max_wait_ms=0.5,
                          buckets=(64,), min_bucket=64, raw_score=True,
                          retry_policy=FAST_RETRY) as srv:
        fu = srv.submit(np.zeros((2, 4), np.float32))
        with pytest.raises(faults.FaultInjected):
            fu.result(60)
        st = srv.stats()
    assert st["failed"] == 1 and st["pending"] == 0
    assert faults.fired("serve.score") == FAST_RETRY.attempts


def test_server_drain_on_shutdown():
    cm = _server_model()
    rng = np.random.RandomState(5)
    srv = PredictionServer(cm, max_batch=64, max_wait_ms=50.0,
                           buckets=(64,), min_bucket=64, raw_score=True)
    futs = [srv.submit(rng.normal(size=(2, 4)).astype(np.float32))
            for _ in range(30)]
    srv.close()                       # immediate close must drain, not drop
    for fu in futs:
        assert fu.result(60).shape == (2,)
    st = srv.stats()
    assert st["resolved"] == 30 and st["pending"] == 0
    assert not srv._thread.is_alive()
    with pytest.raises(RuntimeError):
        srv.submit(np.zeros((1, 4), np.float32))


def test_retry_env_seam(monkeypatch):
    """A server given no policy retries as ``LGBM_TPU_RETRY_*`` says:
    two attempts survive one transient fault and are spent by two."""
    from lightgbm_tpu_torch.utils import retry
    for k, v in (("ATTEMPTS", "2"), ("BASE_S", "0"), ("MAX_S", "0"),
                 ("DEADLINE_S", "0"), ("JITTER", "0")):
        monkeypatch.setenv(f"LGBM_TPU_RETRY_{k}", v)
    assert retry.RetryPolicy.from_env() == retry.RetryPolicy(
        attempts=2, base_s=0.0, max_s=0.0, deadline_s=0.0, jitter=0.0)
    cm = _server_model()
    x = np.zeros((2, 4), np.float32)
    for times, ok in ((1, True), (2, False)):
        faults.inject("serve.score", times=times)
        with PredictionServer(cm, max_batch=64, max_wait_ms=0.5,
                              buckets=(64,), min_bucket=64,
                              raw_score=True) as srv:
            fu = srv.submit(x)
            if ok:
                np.testing.assert_array_equal(fu.result(60),
                                              cm.predict_raw(x))
            else:
                with pytest.raises(faults.FaultInjected):
                    fu.result(60)
            st = srv.stats()
        assert faults.fired("serve.score") == times
        assert st["failed"] == (0 if ok else 1) and st["pending"] == 0


def test_latency_ring_is_bounded():
    """The per-bucket latency sketch keeps the last ``cap`` samples (4,096
    by default) and counts every one."""
    from lightgbm_tpu_torch.obs.ops_plane import RollingQuantiles
    assert RollingQuantiles()._cap == 4096
    rq = RollingQuantiles(cap=4)
    for v in (9.0, 9.0, 9.0, 9.0, 1.0, 1.0, 1.0, 1.0, 2.0):
        rq.observe(v)
    assert rq.count == 9 and len(rq._buf) == 4
    assert rq.quantiles((50.0,)) == {50.0: 1.0}
    assert rq.stats_ms()["count"] == 9


def test_bucket_helpers():
    assert next_bucket(1, 64) == 64
    assert next_bucket(64, 64) == 64
    assert next_bucket(65, 64) == 128
    assert next_bucket(1_000_000, 256) == 1 << 20
    assert _default_buckets(4096, 64) == [64, 256, 1024, 4096]
    assert _default_buckets(100, 64) == [64, 128]


def test_fault_env_seam(monkeypatch):
    """``LGBM_TPU_FAULTS`` arms points: ``name:times@skip`` and ``!``."""
    monkeypatch.setenv("LGBM_TPU_FAULTS", "serve.score:1@1!")
    faults._env_loaded = False
    faults.fault_point("serve.score")             # skipped
    with pytest.raises(faults.FaultInjected, match="PERMANENT"):
        faults.fault_point("serve.score")
    faults.fault_point("serve.score")             # spent
    assert faults.fired("serve.score") == 1 and faults.calls("serve.score") == 3


# ---------------------------------------------------------------------------
# loaded models: classes and objectives (the two repaired faults)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("objective", ["multiclass", "multiclassova"])
def test_loaded_multiclass_predicts_n_by_k(objective):
    rng = np.random.RandomState(0)
    X = rng.normal(size=(600, 5)).astype(np.float32)
    y = rng.randint(0, 3, size=600).astype(np.float32)
    p = {"objective": objective, "num_class": 3, "num_leaves": 7,
         "num_iterations": 3, "verbose": -1, "min_data_in_leaf": 5}
    jbst = jlgb.train(p, jlgb.Dataset(X, label=y, params=p))
    text = jbst.model_to_string()
    jl = jlgb.Booster(model_str=text)
    tl = tlgb.Booster(model_str=text, device="cpu")
    Xq = rng.normal(size=(40, 5)).astype(np.float32)
    for raw in (True, False):
        want = jl.predict(Xq, raw_score=raw)
        assert want.shape == (40, 3)
        for device in (False, True):
            got = tl.predict(Xq, raw_score=raw, device=device)
            assert got.shape == (40, 3)
            np.testing.assert_allclose(got, want, rtol=tol("f32_tight"),
                                       atol=tol("f32_tight"))


def test_loaded_poisson_predicts_converted():
    rng = np.random.RandomState(1)
    X = rng.normal(size=(800, 4)).astype(np.float32)
    y = rng.poisson(np.exp(0.5 * X[:, 0])).astype(np.float32)
    p = {"objective": "poisson", "num_leaves": 7, "num_iterations": 4,
         "verbose": -1, "min_data_in_leaf": 5}
    jbst = jlgb.train(p, jlgb.Dataset(X, label=y, params=p))
    text = jbst.model_to_string()
    tl = tlgb.Booster(model_str=text, device="cpu")
    want = jlgb.Booster(model_str=text).predict(X[:50])
    assert np.all(want > 0)
    for device in (False, True):
        np.testing.assert_allclose(tl.predict(X[:50], device=device), want,
                                   rtol=tol("f32_tight"),
                                   atol=tol("f32_tight"))


# every objective string the JAX package writes, on one trained forest
LOADED_OBJECTIVES = ["regression", "regression_l1", "huber", "fair",
                     "quantile", "mape", "lambdarank", "poisson", "gamma",
                     "tweedie", "binary sigmoid:1.0", "binary sigmoid:0.7",
                     "xentropy", "xentlambda", "cross_entropy"]


@pytest.fixture(scope="module")
def regression_text():
    rng = np.random.RandomState(2)
    X = rng.normal(size=(800, 4)).astype(np.float32)
    y = (X[:, 0] + 0.1 * rng.normal(size=800)).astype(np.float32)
    p = {"objective": "regression", "num_leaves": 7, "num_iterations": 4,
         "verbose": -1, "min_data_in_leaf": 5}
    jbst = jlgb.train(p, jlgb.Dataset(X, label=y, params=p))
    return jbst.model_to_string(), X[:60]


@pytest.mark.parametrize("objective", LOADED_OBJECTIVES)
def test_loaded_objective_output_matches_jax(regression_text, objective):
    text, X = regression_text
    line = [ln for ln in text.splitlines() if ln.startswith("objective=")]
    text = text.replace(line[0], f"objective={objective}")
    want = jlgb.Booster(model_str=text).predict(X)
    tl = tlgb.Booster(model_str=text, device="cpu")
    for device in (False, True):
        np.testing.assert_allclose(tl.predict(X, device=device), want,
                                   rtol=tol("f32_tight"),
                                   atol=tol("f32_tight"))
    # the objective line survives a save
    assert f"objective={objective}" in tl.model_to_string()


def test_loaded_regression_sqrt(regression_text):
    """The reference writes ``regression sqrt`` for ``reg_sqrt``; the
    port converts with ``sign(s) * s * s`` as the JAX package's
    ``RegressionL2(reg_sqrt=True).convert_output`` does."""
    text, X = regression_text
    line = [ln for ln in text.splitlines() if ln.startswith("objective=")]
    tl = tlgb.Booster(model_str=text.replace(line[0],
                                             "objective=regression sqrt"),
                      device="cpu")
    raw = tl.predict(X, raw_score=True)
    want = np.asarray(JRegressionL2(JConfig.from_params(
        {"objective": "regression", "reg_sqrt": True})).convert_output(
            raw.astype(np.float32)))
    np.testing.assert_allclose(tl.predict(X), want, rtol=tol("f32_tight"),
                               atol=tol("f32_tight"))
    assert np.any(raw < 0) and np.all(np.sign(tl.predict(X)) == np.sign(raw))


def test_loaded_unknown_objective_raises(regression_text):
    text, X = regression_text
    line = [ln for ln in text.splitlines() if ln.startswith("objective=")]
    with pytest.raises(NotImplementedError, match="rank_xendcg"):
        tlgb.Booster(model_str=text.replace(line[0],
                                            "objective=rank_xendcg"),
                     device="cpu")


def test_output_only_objective_does_not_train():
    """Poisson, once an output-only objective of loaded models, trains:
    its model converts its output (``exp``) as the JAX package's
    Poisson model does, and saves an objective line that loads back to
    the same predictions."""
    rng = np.random.RandomState(0)
    X = rng.normal(size=(300, 3))
    y = np.abs(X[:, 0])
    p = {"objective": "poisson", "num_leaves": 7, "min_data_in_leaf": 5,
         "verbose": -1}
    bst = tlgb.train(dict(p), tlgb.Dataset(X, label=y), num_boost_round=3,
                     device="cpu")
    raw = bst.predict(X, raw_score=True)
    want = np.asarray(jlgb.Booster(model_str=bst.model_to_string()).predict(X))
    np.testing.assert_allclose(bst.predict(X), want, rtol=tol("f32_tight"),
                               atol=tol("f32_tight"))
    np.testing.assert_allclose(bst.predict(X), np.exp(raw),
                               rtol=tol("f32_tight"), atol=tol("f32_tight"))
    text = bst.model_to_string()
    assert "objective=poisson" in text
    np.testing.assert_array_equal(
        tlgb.Booster(model_str=text, device="cpu").predict(X),
        bst.predict(X))
