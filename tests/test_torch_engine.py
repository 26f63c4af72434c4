"""The port's training entry surface, held against the JAX package at toy
size on the CPU: custom objectives (``fobj``) and evaluation functions
(``feval``), continued training from ``init_model``, ``learning_rates``,
``keep_training_booster``, and ``cv`` with its folds and early stopping.

The JAX side runs its kernels in Pallas interpret mode
(``LGBM_TPU_HIST_BACKEND=compact``, ``LGBM_TPU_SPLIT_INTERPRET=1``).

With ``fobj``, ``feval`` or ``learning_rates`` the JAX package trains on
its per-iteration loop, whose score update rounds ``lr * value`` before
the add; the port's one loop makes the fused multiply-add of the JAX
package's fused window (ROADMAP C3).  So those models are compared as
``tests/test_torch_valid.py`` compares the callback loop's: equal
digests, or a first divergence that ``model_flip_report`` classifies as
a near tie; metrics within ``tol("metric_coarse")``.  Where the JAX
package also makes the FMA (``init_model`` without callbacks) the model
text and the training scores must be bitwise equal.
"""
import numpy as np
import pytest
import torch

from tools.numcheck.tolerance_registry import tol

import lightgbm_tpu as jlgb
from lightgbm_tpu.parallel.envelope import model_flip_report

import lightgbm_tpu_torch as tlgb
from lightgbm_tpu_torch import engine as t_engine

torch.set_num_threads(1)   # tiny tensors: more threads only spin

PARAMS = {"num_leaves": 15, "max_bin": 63, "learning_rate": 0.1,
          "min_data_in_leaf": 20, "verbose": -1}


@pytest.fixture(autouse=True)
def _reference_kernels(monkeypatch):
    monkeypatch.setenv("LGBM_TPU_HIST_BACKEND", "compact")
    monkeypatch.setenv("LGBM_TPU_SPLIT_INTERPRET", "1")


def _binary(n=2000, f=6, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.normal(size=(n, f)).astype(np.float32)
    y = (X[:, 0] * 2 + X[:, 1] - X[:, 2]
         + rng.normal(size=n) > 0).astype(np.float32)
    return X, y


def _multiclass(n=1500, f=5, seed=1):
    rng = np.random.RandomState(seed)
    X = rng.normal(size=(n, f)).astype(np.float32)
    y = np.argmax(X[:, :3] + 0.5 * rng.normal(size=(n, 3)),
                  axis=1).astype(np.float32)
    return X, y


def _same_model(jb, tb):
    """Equal digests, or the first divergence a near tie."""
    if tb.digest(include_scores=False) != jb.digest(include_scores=False):
        rep = model_flip_report(jb.model_to_string(), tb.model_to_string())
        assert rep["near_tie"], rep


def logloss_fobj(score, dataset):
    p = 1.0 / (1.0 + np.exp(-score))
    label = dataset.get_label()
    return p - label, p * (1.0 - p)


def softmax_fobj(score, dataset):
    """Multiclass softmax gradients from class-major ``[n * 3]`` scores,
    returned class-major."""
    label = dataset.get_label().astype(int)
    s = score.reshape(3, -1).T                       # [n, 3]
    e = np.exp(s - s.max(axis=1, keepdims=True))
    p = e / e.sum(axis=1, keepdims=True)
    onehot = np.eye(3)[label]
    return ((p - onehot).T.reshape(-1),
            (2.0 * p * (1.0 - p)).T.reshape(-1))


def test_fobj_binary_matches_reference():
    X, y = _binary()
    models = []
    for lgb, kw in ((jlgb, {}), (tlgb, {"device": "cpu"})):
        models.append(lgb.train(dict(PARAMS), lgb.Dataset(X, label=y), 8,
                                fobj=logloss_fobj, verbose_eval=False, **kw))
    jb, tb = models
    _same_model(jb, tb)
    assert tb._gbdt.objective is None and tb._gbdt.init_score_value == 0.0
    np.testing.assert_allclose(tb.predict(X), jb.predict(X), rtol=0,
                               atol=tol("prob_coarse"))


def test_fobj_multiclass_class_major_matches_reference():
    """K = 3 through ``Booster.update(fobj=)``: the scores reach ``fobj``
    class-major and a 1-D gradient is read back class-major."""
    X, y = _multiclass()
    params = dict(PARAMS, objective="multiclass", num_class=3)
    seen = []

    def fobj(score, dataset):
        seen.append(score.copy())
        return softmax_fobj(score, dataset)

    jb = jlgb.Booster(dict(params), jlgb.Dataset(X, label=y))
    tb = tlgb.Booster(dict(params), tlgb.Dataset(X, label=y), device="cpu")
    for _ in range(4):
        jb.update(fobj=softmax_fobj)
        scores = tb._gbdt.scores.numpy().copy()
        tb.update(fobj=fobj)
        np.testing.assert_array_equal(seen[-1], scores.T.reshape(-1))
    _same_model(jb, tb)


def test_fobj_multiclass_builtin_gradient_is_builtin_model():
    """A 1-D class-major ``fobj`` that returns the built-in softmax
    gradient trains the built-in multiclass model bitwise, scores
    included (a row-major read would train the wrong classes)."""
    X, y = _multiclass()
    params = dict(PARAMS, objective="multiclass", num_class=3)
    ref = tlgb.Booster(dict(params), tlgb.Dataset(X, label=y), device="cpu")
    tb = tlgb.Booster(dict(params), tlgb.Dataset(X, label=y), device="cpu")
    obj = tb._gbdt.objective

    def fobj(score, dataset):
        s = torch.as_tensor(score.reshape(3, -1).T.copy())
        g, h = obj.get_gradients_k(s)
        return g.numpy().T.reshape(-1), h.numpy().T.reshape(-1)

    for _ in range(4):
        ref.update()
        tb.update(fobj=fobj)
    assert tb.digest() == ref.digest()


def test_fobj_l2_is_builtin_regression():
    """An L2 ``fobj`` (``score - label``, ones, in f32 from the Dataset's
    own label) against the built-in ``regression``, both without
    ``boost_from_average``: the same model bitwise, scores included
    (the card's phase 23 holds the same at full width)."""
    X, y = _binary()
    z = (X[:, 0] * 2 + X[:, 1]).astype(np.float32)

    def l2(score, dataset):
        label = dataset.get_label()
        return score - label, np.ones_like(score)

    params = dict(PARAMS, boost_from_average=False)
    a = tlgb.train(dict(params, objective="regression"),
                   tlgb.Dataset(X, label=z), 6, verbose_eval=False,
                   device="cpu")
    b = tlgb.train(dict(params), tlgb.Dataset(X, label=z), 6, fobj=l2,
                   verbose_eval=False, device="cpu")
    assert b.digest() == a.digest()
    # the same objective given as the ``objective`` parameter
    c = tlgb.train(dict(params, objective=l2), tlgb.Dataset(X, label=z), 6,
                   verbose_eval=False, device="cpu")
    assert c.digest() == a.digest()


def test_fobj_multiclass_train_raises_as_reference():
    """``train(fobj=)`` sets the objective to ``none``, whose
    ``num_class`` must be 1, in both packages."""
    X, y = _multiclass()
    for lgb, kw in ((jlgb, {}), (tlgb, {"device": "cpu"})):
        with pytest.raises(ValueError, match="num_class"):
            lgb.train(dict(PARAMS, num_class=3), lgb.Dataset(X, label=y), 2,
                      fobj=softmax_fobj, verbose_eval=False, **kw)


def error_rate(score, dataset):
    return ("error_rate", float(np.mean((score > 0) != dataset.get_label())),
            False)


def test_feval_records_match_reference():
    X, y = _binary()
    Xv, yv = _binary(n=500, seed=3)
    params = dict(PARAMS, objective="binary", metric="auc",
                  is_training_metric=True)
    records = []
    for lgb, kw in ((jlgb, {}), (tlgb, {"device": "cpu"})):
        ds = lgb.Dataset(X, label=y)
        vs = lgb.Dataset(Xv, label=yv, reference=ds)
        ev = {}
        b = lgb.train(dict(params), ds, 6, valid_sets=[vs],
                      valid_names=["valid"], feval=error_rate,
                      evals_result=ev, verbose_eval=False, **kw)
        records.append((b, ev))
    (jb, jev), (tb, tev) = records
    assert set(tev) == set(jev) == {"training", "valid"}
    for name in jev:
        assert list(tev[name]) == list(jev[name]) == ["auc", "error_rate"]
        for metric, ref in jev[name].items():
            np.testing.assert_allclose(tev[name][metric], ref,
                                       rtol=tol("metric_coarse"),
                                       atol=tol("metric_coarse"))
    _same_model(jb, tb)


def test_feval_list_and_multiclass_scores():
    """``feval`` may return a list; with K > 1 it sees ``[n, K]``."""
    X, y = _multiclass()
    params = dict(PARAMS, objective="multiclass", num_class=3)
    shapes = []

    def feval(score, dataset):
        shapes.append(score.shape)
        return [("a", 1.0, True), ("b", 2.0, False)]

    ds = tlgb.Dataset(X, label=y)
    ev = {}
    tlgb.train(dict(params), ds, 2, valid_sets=[ds.create_valid(X, label=y)],
               valid_names=["v"], feval=feval, evals_result=ev,
               verbose_eval=False, device="cpu")
    assert shapes == [(len(X), 3)] * 2
    assert list(ev["v"]) == ["multi_logloss", "a", "b"]
    assert ev["v"]["b"] == [2.0, 2.0]


def _init_model(kind, booster, tmp_path):
    if kind == "string":
        return booster.model_to_string()
    if kind == "file":
        path = str(tmp_path / f"{type(booster).__module__}.txt")
        booster.save_model(path)
        return path
    return booster


@pytest.mark.parametrize("kind", ["string", "file", "booster"])
def test_init_model_matches_reference(kind, tmp_path):
    """4 + 4 iterations: the model text and the training scores equal the
    JAX package's bitwise, its double ``boost_from_average`` included."""
    X, y = _binary()
    params = dict(PARAMS, objective="binary")
    out = []
    for lgb, kw in ((jlgb, {}), (tlgb, {"device": "cpu"})):
        first = lgb.train(dict(params), lgb.Dataset(X, label=y), 4,
                          verbose_eval=False, **kw)
        init = _init_model(kind, first, tmp_path)
        b = lgb.train(dict(params), lgb.Dataset(X, label=y), 4,
                      init_model=init, verbose_eval=False, **kw)
        out.append(b)
    jb, tb = out
    assert tb.current_iteration() == 8 and tb.num_trees() == 8
    assert tb.model_to_string() == jb.model_to_string()
    np.testing.assert_array_equal(tb._gbdt.scores.numpy(),
                                  np.asarray(jb._gbdt.scores))


def test_init_model_double_bias_is_pinned():
    """The JAX package's continued training counts ``boost_from_average``
    twice (ROADMAP C23): the new Booster's scores start at the average
    ``v``, and the replay of the loaded model adds its first tree's bias
    ``v`` again.  So the training scores sit ``v`` above the model's own
    raw prediction, and the new trees carry no bias in the model text.
    A later fix changes this test on purpose."""
    X, y = _binary()
    params = dict(PARAMS, objective="binary")
    first = tlgb.train(dict(params), tlgb.Dataset(X, label=y), 2,
                       verbose_eval=False, device="cpu")
    b = tlgb.train(dict(params), tlgb.Dataset(X, label=y), 2,
                   init_model=first, verbose_eval=False, device="cpu")
    g = b._gbdt
    v = g.init_score_value
    assert v < -0.05
    raw = b.predict(X, raw_score=True)
    np.testing.assert_allclose(g.scores.numpy()[:, 0] - raw, v, rtol=0,
                               atol=tol("f32_accum"))
    # the loaded trees come first, unchanged
    assert _trees(b.model_to_string())[:2] == _trees(first.model_to_string())


def _trees(text):
    return [t.strip() for t in
            text.split("feature importances:")[0].split("Tree=")[1:]]


def test_learning_rates_constant_is_fixed_lr():
    X, y = _binary()
    params = dict(PARAMS, objective="binary")
    a = tlgb.train(dict(params), tlgb.Dataset(X, label=y), 6,
                   verbose_eval=False, device="cpu")
    b = tlgb.train(dict(params), tlgb.Dataset(X, label=y), 6,
                   learning_rates=[0.1] * 6, verbose_eval=False,
                   device="cpu")
    assert b.digest() == a.digest()
    assert b.model_to_string() == a.model_to_string()


@pytest.mark.parametrize("schedule", ["list", "function"])
def test_learning_rates_decaying_matches_reference(schedule):
    X, y = _binary()
    params = dict(PARAMS, objective="binary")
    rates = [0.2 * 0.8 ** i for i in range(6)]
    lr = rates if schedule == "list" else (lambda i: 0.2 * 0.8 ** i)
    out = []
    for lgb, kw in ((jlgb, {}), (tlgb, {"device": "cpu"})):
        out.append(lgb.train(dict(params), lgb.Dataset(X, label=y), 6,
                             learning_rates=lr, verbose_eval=False, **kw))
    jb, tb = out
    _same_model(jb, tb)
    assert [t.shrinkage_rate for t in tb._gbdt.models] == rates


def test_keep_training_booster():
    X, y = _binary()
    ds = tlgb.Dataset(X, label=y)
    b = tlgb.train(dict(PARAMS, objective="binary"), ds, 2,
                   verbose_eval=False, device="cpu")
    assert b._train_dataset is None
    b = tlgb.train(dict(PARAMS, objective="binary"), ds, 2,
                   keep_training_booster=True, verbose_eval=False,
                   device="cpu")
    assert b._train_dataset is ds
    b.update()
    assert b.current_iteration() == 3


def test_resume_from_with_init_model_raises(tmp_path):
    X, y = _binary()
    first = tlgb.train(dict(PARAMS, objective="binary"),
                       tlgb.Dataset(X, label=y), 2, verbose_eval=False,
                       device="cpu")
    with pytest.raises(ValueError, match="mutually exclusive"):
        tlgb.train(dict(PARAMS, objective="binary"),
                   tlgb.Dataset(X, label=y), 2, init_model=first,
                   resume_from=str(tmp_path / "m"), verbose_eval=False,
                   device="cpu")


def test_feature_name_argument():
    X, y = _binary()
    names = [f"f{i}" for i in range(X.shape[1])]
    b = tlgb.train(dict(PARAMS, objective="binary"),
                   tlgb.Dataset(X, label=y), 2, feature_name=names,
                   verbose_eval=False, device="cpu")
    assert b.feature_name() == names


def _rank_data(nq=30, per=20, seed=5):
    rng = np.random.RandomState(seed)
    X = rng.normal(size=(nq * per, 4)).astype(np.float32)
    y = np.clip((X[:, 0] * 2 + rng.normal(size=nq * per)).round(), 0,
                3).astype(np.float32)
    return X, y, np.full(nq, per)


class _Splitter:
    """A scikit-learn style splitter: every third row is a test row of
    fold ``r % 3``."""

    def split(self, X, y):
        rows = np.arange(len(X))
        for f in range(3):
            yield rows[rows % 3 != f], rows[rows % 3 == f]


@pytest.mark.parametrize("case", ["stratified", "plain", "group",
                                  "splitter", "list"])
def test_cv_folds_match_reference(case):
    """The rows of every fold (what ``fpreproc`` sees as
    ``used_indices``) equal the JAX package's."""
    X, y = _binary(n=600)
    kw = {"nfold": 4, "seed": 7}
    params = dict(PARAMS, objective="binary")
    if case == "plain":
        params["objective"] = "regression"
    if case == "group":
        X, y, group = _rank_data()
        params["objective"] = "lambdarank"
    if case == "splitter":
        kw = {"folds": _Splitter()}
    if case == "list":
        kw = {"folds": list(_Splitter().split(X, y))}
    seen = []
    for lgb, extra in ((jlgb, {}), (tlgb, {"device": "cpu"})):
        ds = lgb.Dataset(X, label=y, group=group if case == "group" else None)
        rows = []

        def fpreproc(tr, va, p):
            rows.append((tr.used_indices.tolist(), va.used_indices.tolist()))
            return tr, va, p
        lgb.cv(dict(params), ds, num_boost_round=1, fpreproc=fpreproc,
               **kw, **extra)
        seen.append(rows)
    assert seen[0] == seen[1]
    assert len(seen[1]) == (3 if case in ("splitter", "list") else 4)


def test_cv_results_and_early_stopping_match_reference():
    """Means and standard deviations per iteration within
    ``tol("metric_coarse")``; early stopping on the first metric's mean
    cuts both at the same iteration."""
    X, y = _binary(n=1200, seed=2)
    params = dict(PARAMS, objective="binary", metric="binary_logloss,auc",
                  learning_rate=0.5, num_leaves=31, min_data_in_leaf=5)
    out = []
    for lgb, kw in ((jlgb, {}), (tlgb, {"device": "cpu"})):
        out.append(lgb.cv(dict(params), lgb.Dataset(X, label=y),
                          num_boost_round=30, nfold=3, seed=0,
                          early_stopping_rounds=3, **kw))
    jr, tr = out
    assert set(tr) == set(jr) == {"binary_logloss-mean", "binary_logloss-stdv",
                                  "auc-mean", "auc-stdv"}
    assert len(tr["auc-mean"]) == len(jr["auc-mean"]) < 30
    for key in jr:
        np.testing.assert_allclose(tr[key], jr[key],
                                   rtol=tol("metric_coarse"),
                                   atol=tol("metric_coarse"))


def test_cv_mean_is_mean_of_fold_trains():
    """Each iteration's mean is the mean of one ``lgb.train`` per fold on
    the same rows, bitwise (what the card's phase 23 holds at the
    small-data shape)."""
    X, y = _binary(n=900, seed=4)
    params = dict(PARAMS, objective="binary", metric="auc")
    ds = tlgb.Dataset(X, label=y)
    res = tlgb.cv(dict(params), ds, num_boost_round=4, nfold=3, seed=1,
                  device="cpu")
    per_fold = []
    for tr_idx, va_idx in t_engine.cv_folds(ds, params, nfold=3, seed=1):
        ev = {}
        tlgb.train(dict(params), ds.subset(np.sort(tr_idx)), 4,
                   valid_sets=[ds.subset(np.sort(va_idx))],
                   valid_names=["valid"], evals_result=ev,
                   verbose_eval=False, device="cpu")
        per_fold.append(ev["valid"]["auc"])
    want = [float(np.mean(v)) for v in zip(*per_fold)]
    assert res["auc-mean"] == want


def test_cv_fobj_and_feval():
    """``fobj`` gives each fold's gradients; ``feval`` joins the means."""
    X, y = _binary(n=600)
    params = dict(PARAMS, objective="binary", metric="auc")
    res = tlgb.cv(dict(params), tlgb.Dataset(X, label=y), num_boost_round=3,
                  nfold=3, fobj=logloss_fobj, feval=error_rate,
                  device="cpu")
    assert set(res) == {"auc-mean", "auc-stdv", "error_rate-mean",
                        "error_rate-stdv"}
    assert len(res["error_rate-mean"]) == 3


@pytest.mark.parametrize("name", ["init_model", "callbacks"])
def test_cv_refuses_dropped_arguments(name):
    """The JAX package's ``cv`` ignores these (ROADMAP C24); the port
    refuses them rather than run other folds than were asked for."""
    X, y = _binary(n=300)
    value = {"init_model": "tree\n",
             "callbacks": [tlgb.early_stopping(2)]}[name]
    with pytest.raises(NotImplementedError, match=name):
        tlgb.cv(dict(PARAMS, objective="binary"), tlgb.Dataset(X, label=y),
                num_boost_round=2, nfold=3, device="cpu", **{name: value})


def test_cv_feature_name_applies():
    """``feature_name`` names the folds' features, as in ``train``."""
    X, y = _binary(n=300)
    names = [f"f{j}" for j in range(X.shape[1])]
    seen = []

    def fpreproc(tr, va, p):
        seen.append(tr.construct()._constructed.feature_names)
        return tr, va, p
    tlgb.cv(dict(PARAMS, objective="binary"), tlgb.Dataset(X, label=y),
            num_boost_round=1, nfold=3, feature_name=names,
            fpreproc=fpreproc, device="cpu")
    assert seen == [names] * 3


def test_package_exports():
    for name in ("cv", "reset_parameter", "early_stopping",
                 "print_evaluation", "record_evaluation",
                 "EarlyStopException", "LGBMModel", "LGBMRegressor",
                 "LGBMClassifier", "LGBMRanker", "plot_importance",
                 "plot_metric", "plot_tree", "create_tree_digraph"):
        assert getattr(tlgb, name) is not None, name
    with pytest.raises(AttributeError):
        tlgb.not_a_name


def test_silent_and_verbose_keywords_match_reference():
    """ROADMAP C25: ``Dataset(silent=)``, ``Booster(silent=)`` and
    ``Booster.model_from_string(model_str, verbose=)`` are accepted and
    ignored, as in the JAX package (and LightGBM 2.1): the same calls
    build the JAX package's model (``Booster.update`` is its per-iteration
    loop, C3: equal digests or a near tie), and ``model_from_string``
    with ``verbose`` reads back what ``Booster(model_str=)`` reads."""
    X, y = _binary()
    out = {}
    for name, lib, extra in (("jax", jlgb, {}),
                             ("port", tlgb, {"device": "cpu"})):
        ds = lib.Dataset(X, label=y, silent=False)
        bst = lib.Booster(params=dict(PARAMS, objective="binary"),
                          train_set=ds, silent=False, **extra)
        for _ in range(4):
            bst.update()
        text = bst.model_to_string()
        loaded = lib.Booster(model_str=text, **extra).model_from_string(
            text, verbose=True)
        assert loaded.model_to_string() == lib.Booster(
            model_str=text, **extra).model_to_string()
        out[name] = bst
    _same_model(out["jax"], out["port"])
