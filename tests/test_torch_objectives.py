"""Objectives of lightgbm_tpu_torch against the JAX package's, on the CPU.

The same seeded numpy labels, weights and scores go through each
objective of both packages (the JAX one eagerly, op by op, as its
per-iteration loop runs it): gradients and hessians, with and without
weights, ``boost_from_score`` and ``convert_output``.  Objectives whose
arithmetic is adds, multiplies, divides, signs and clips are bitwise;
those through ``exp`` or the sigmoid are held within ``f32_eps_few``
(torch's and XLA's transcendentals round differently by an ulp, which
``1 - y * exp(-s)`` and its kin magnify).  ``leaf_percentile`` (the leaf renewal of L1, quantile and MAPE)
is bitwise the JAX package's ``_leaf_percentile``, weighted and not,
with empty leaves and tied values of both zero signs.
"""
import numpy as np
import pytest
import torch

from tools.numcheck.tolerance_registry import tol

from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.io.dataset import Metadata as JMetadata
from lightgbm_tpu.objective import objectives as jobj

from lightgbm_tpu_torch.config import Config as TConfig
from lightgbm_tpu_torch.io.dataset import Metadata as TMetadata
from lightgbm_tpu_torch.objective import objectives as tobj

torch.set_num_threads(1)   # tiny tensors: more threads only spin

N = 1500
K = 4

# objective -> (params, label kind, bitwise)
CASES = {
    "regression": ({}, "real", True),
    "regression_sqrt": ({"objective": "regression", "reg_sqrt": True},
                        "real", True),
    "regression_l1": ({}, "real", True),
    "huber": ({"alpha": 0.7}, "real", True),
    "fair": ({"fair_c": 0.8}, "real", True),
    "poisson": ({}, "count", False),
    "quantile": ({"alpha": 0.3}, "real", True),
    "mape": ({}, "positive", True),
    "gamma": ({}, "positive", False),
    "tweedie": ({"tweedie_variance_power": 1.3}, "positive", False),
    "binary": ({"sigmoid": 0.8}, "binary", False),
    "multiclass": ({"num_class": K}, "class", False),
    "multiclassova": ({"num_class": K, "sigmoid": 1.2}, "class", False),
    "xentropy": ({}, "prob", False),
    "xentlambda": ({}, "prob", False),
}


def _labels(kind, rng):
    z = rng.normal(size=N)
    return {
        "real": z,
        "count": rng.poisson(np.exp(0.5 * z)),
        "positive": np.exp(0.5 * z) + 0.05 * rng.rand(N),
        "binary": (z > 0.3),
        "class": rng.randint(0, K, size=N),
        "prob": 1.0 / (1.0 + np.exp(-z)),
    }[kind].astype(np.float32)


def _pair(name, weighted, seed=0):
    """The objective of both packages, initialised on the same rows, and
    a score array."""
    params, kind, bitwise = CASES[name]
    params = {"objective": name, **params}
    rng = np.random.RandomState(seed)
    label = _labels(kind, rng)
    weight = (rng.uniform(0.2, 2.0, size=N).astype(np.float32)
              if weighted else None)
    objs = []
    for Cfg, Md, mod, kw in ((JConfig, JMetadata, jobj, {}),
                             (TConfig, TMetadata, tobj,
                              {"device": "cpu"})):
        md = Md()
        md.set_field("label", label)
        if weighted:
            md.set_field("weight", weight)
        o = mod.create_objective(Cfg.from_params(params))
        o.init(md, N, **kw)
        objs.append(o)
    shape = (N, K) if kind == "class" else (N,)
    score = rng.normal(scale=1.5, size=shape).astype(np.float32)
    score[:7] = 0.0             # ties and exact zeros of the residual
    return objs[0], objs[1], score, bitwise


def _close(got, want, bitwise):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    if bitwise:
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    else:
        np.testing.assert_allclose(got, want, rtol=tol("f32_eps_few"),
                                   atol=tol("f32_eps_few"))


@pytest.mark.parametrize("weighted", [False, True], ids=["plain", "weighted"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_gradients_match_reference(name, weighted):
    jo, to, score, bitwise = _pair(name, weighted)
    gj, hj = jo.get_gradients(score)
    gt, ht = to.get_gradients(torch.from_numpy(score))
    _close(gt, gj, bitwise)
    _close(ht, hj, bitwise)
    assert to.num_model_per_iteration == jo.num_model_per_iteration
    assert to.need_renew_tree_output == jo.need_renew_tree_output
    bj, bt = jo.boost_from_score(), to.boost_from_score()
    assert abs(float(bj) - bt) <= tol("f64_solver") * max(1.0, abs(bt))
    _close(to.convert_output(torch.from_numpy(score)),
           jo.convert_output(score), bitwise)


def _percentile_inputs(seed, n=900, L=12):
    rng = np.random.RandomState(seed)
    values = rng.normal(size=n).astype(np.float32)
    values[rng.rand(n) < 0.1] = 0.0
    values[rng.rand(n) < 0.05] = -0.0
    values[:40] = np.round(values[:40])       # more ties
    # leaves 3 and 7 stay empty
    row_leaf = rng.choice([i for i in range(L) if i not in (3, 7)],
                          size=n).astype(np.int32)
    weight = rng.uniform(0.1, 3.0, size=n).astype(np.float32)
    return values, row_leaf, weight, L


@pytest.mark.parametrize("alpha", [0.5, 0.1, 0.9])
@pytest.mark.parametrize("weighted", [False, True], ids=["plain", "weighted"])
def test_leaf_percentile_matches_reference(alpha, weighted):
    values, row_leaf, weight, L = _percentile_inputs(int(alpha * 10))
    want = np.asarray(jobj._leaf_percentile(
        values, row_leaf, L, alpha, weight if weighted else None))
    got = tobj.leaf_percentile(
        torch.from_numpy(values), torch.from_numpy(row_leaf), L, alpha,
        torch.from_numpy(weight) if weighted else None).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    assert got[3] == 0.0 and got[7] == 0.0


@pytest.mark.parametrize("name", ["regression_l1", "quantile", "mape"])
def test_renew_tree_output_matches_reference(name):
    jo, to, score, _ = _pair(name, weighted=True, seed=4)
    row_leaf = np.random.RandomState(5).randint(0, 9, size=N).astype(np.int32)
    want = np.asarray(jo.renew_tree_output(score, row_leaf, 10))
    got = to.renew_tree_output(torch.from_numpy(score),
                               torch.from_numpy(row_leaf), 10).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("weighted", [False, True], ids=["plain", "weighted"])
@pytest.mark.parametrize("n", [900, 70_000])
def test_host_percentile_is_leaf_percentile(n, weighted):
    """``chip_smoke.host_percentile``, the card's oracle of the renewed
    leaves, is bitwise the port's ``leaf_percentile`` (70,000 rows: a
    weighted prefix sum of five block levels)."""
    from chip_smoke import host_percentile
    values, row_leaf, weight, L = _percentile_inputs(11, n=n)
    w = weight if weighted else None
    want = host_percentile(values, row_leaf, L, 0.3, w)
    got = tobj.leaf_percentile(
        torch.from_numpy(values), torch.from_numpy(row_leaf), L, 0.3,
        None if w is None else torch.from_numpy(w)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("weighted", [False, True], ids=["plain", "weighted"])
def test_mape_renewal_is_host_percentile(weighted):
    """MAPE's renewal is the host percentile at 0.5 weighted by
    ``chip_smoke.mape_weight`` of the labels (and row weights)."""
    from chip_smoke import host_percentile, mape_weight
    _, to, score, _ = _pair("mape", weighted=weighted, seed=6)
    row_leaf = np.random.RandomState(7).randint(0, 9, size=N).astype(np.int32)
    label = to.label.numpy()
    w = to.weight.numpy() if weighted else None
    want = host_percentile(label - score, row_leaf, 10, 0.5,
                           mape_weight(label, w))
    got = to.renew_tree_output(torch.from_numpy(score),
                               torch.from_numpy(row_leaf), 10).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("line", [
    "regression_l1", "huber", "quantile", "lambdarank",
    "multiclass num_class:3", "multiclassova num_class:3 sigmoid:1.5",
    "binary sigmoid:0.7", "regression sqrt", "xentlambda"])
def test_loaded_objective_is_trainable_and_keeps_its_line(line):
    obj = tobj.load_objective(line)
    assert type(obj) is tobj.OBJECTIVES[obj.name]
    assert obj.to_string() == line
    if obj.name.startswith("multiclass"):
        assert obj.num_model_per_iteration == 3


# whole toy models: objective -> (label of the latent z, extra params)
MODELS = {
    "regression_l1": (lambda z: z, {}),
    "regression_l1_weighted_bagged": (
        lambda z: z, {"objective": "regression_l1", "bagging_freq": 1,
                      "bagging_fraction": 0.7}),
    "quantile": (lambda z: z, {"alpha": 0.8}),
    "mape": (lambda z: np.exp(z / 2), {}),
    "huber": (lambda z: z, {}),
    "poisson": (lambda z: np.exp(z / 2), {}),
    "xentropy": (lambda z: 1.0 / (1.0 + np.exp(-z)), {}),
}


@pytest.mark.parametrize("case", sorted(MODELS))
def test_model_matches_reference(monkeypatch, case):
    """``lgb.train`` in both packages (the JAX one on its kernels in
    interpret mode): the renewal objectives (L1, quantile, MAPE; the
    score update rounds ``lr * value`` before the add, as the JAX
    package's per-iteration loop, the only one renewal takes) have the
    JAX package's digest; the others too, or a near-tie first flip."""
    import lightgbm_tpu as jlgb
    from lightgbm_tpu.parallel.envelope import model_flip_report

    import lightgbm_tpu_torch as tlgb
    monkeypatch.setenv("LGBM_TPU_HIST_BACKEND", "compact")
    monkeypatch.setenv("LGBM_TPU_SPLIT_INTERPRET", "1")
    link, extra = MODELS[case]
    rng = np.random.RandomState(0)
    X = rng.normal(size=(3000, 6)).astype(np.float32)
    z = X[:, 0] * 2 + X[:, 1] - X[:, 2] + rng.normal(size=3000)
    y = link(z).astype(np.float32)
    w = (rng.uniform(0.5, 2.0, size=3000).astype(np.float32)
         if "weighted" in case else None)
    params = {"objective": case, "num_leaves": 15, "max_bin": 63,
              "learning_rate": 0.1, "min_data_in_leaf": 20, "verbose": -1,
              **extra}
    jb = jlgb.train(dict(params), jlgb.Dataset(X, label=y, weight=w),
                    num_boost_round=4)
    tb = tlgb.train(dict(params), tlgb.Dataset(X, label=y, weight=w),
                    num_boost_round=4, device="cpu")
    assert tb.current_iteration() == jb.current_iteration == 4
    dj, dt = jb.digest(include_scores=False), tb.digest(include_scores=False)
    if tb._gbdt.objective.need_renew_tree_output:
        assert dt == dj
        assert tb.digest() == jb.digest()       # the scores too
    elif dt != dj:
        rep = model_flip_report(jb.model_to_string(), tb.model_to_string())
        assert rep["near_tie"], rep
    np.testing.assert_allclose(tb.predict(X[:200]), jb.predict(X[:200]),
                               rtol=tol("f32_accum"), atol=tol("f32_accum"))


def test_sort_key_orders_as_reference_argsort():
    """The port's float sort key (the lambdarank and percentile sorts,
    the categorical scan) reproduces the reference's stable argsort:
    both zeros and the denormals tie, NaNs of either sign last,
    infinities in place."""
    import jax.numpy as jnp

    from lightgbm_tpu_torch.ops.split import sort_key
    rng = np.random.RandomState(6)
    x = rng.choice(np.array([0.0, -0.0, 1.5, -1.5, np.inf, -np.inf, np.nan,
                             -np.nan, 2.0, 1e-40, -3e-39], np.float32),
                   size=(7, 300)).astype(np.float32)
    x[3] = rng.normal(size=300)
    want = np.asarray(jnp.argsort(x, axis=-1, stable=True))
    got = torch.argsort(sort_key(torch.from_numpy(x)), dim=-1,
                        stable=True).numpy()
    np.testing.assert_array_equal(got, want)


def test_int8h_heavy_tailed_gradients_match_reference(monkeypatch):
    """A reference caveat both packages share: ``int8h`` rounds each
    gradient to one int8 on the absmax scale, so with a few labels far in
    the tail (Tweedie gradients to about -1,000, the rest near 1.5, which
    round to 0) a leaf's quantized sums disagree with the float root
    totals and its value explodes.  The port reproduces the JAX
    package's leaf, and ``int8hh`` (a second gradient byte) stays
    sane."""
    import lightgbm_tpu as jlgb

    import lightgbm_tpu_torch as tlgb
    monkeypatch.setenv("LGBM_TPU_HIST_BACKEND", "compact")
    monkeypatch.setenv("LGBM_TPU_SPLIT_INTERPRET", "1")
    rng = np.random.RandomState(0)
    X = rng.normal(size=(20000, 6)).astype(np.float32)
    z = X[:, 0] * 2 + X[:, 1] - X[:, 2] + rng.normal(size=20000)
    y = np.exp(z / 2).astype(np.float32)
    y[:5] = 3000.0
    params = {"objective": "tweedie", "num_leaves": 63, "max_bin": 63,
              "min_data_in_leaf": 20, "verbose": -1}
    low = []
    for lgb, kw in ((jlgb, {}), (tlgb, {"device": "cpu"})):
        bst = lgb.train(dict(params), lgb.Dataset(X, label=y),
                        num_boost_round=1, **kw)
        t = bst._gbdt.models[0]
        low.append(float(np.min(t.leaf_value[:t.num_leaves])))
    assert low[1] < -10.0
    assert abs(low[1] - low[0]) <= tol("f32_accum") * abs(low[0])
    bst = tlgb.train(dict(params, hist_mode="int8hh"),
                     tlgb.Dataset(X, label=y), num_boost_round=1,
                     device="cpu")
    t = bst._gbdt.models[0]
    assert np.min(t.leaf_value[:t.num_leaves]) > -10.0


def test_gamma_first_tree_diverges_as_in_reference(monkeypatch):
    """A reference caveat both packages share: on labels over five
    decades (``exp(z / 2)``) Gamma's first Newton step from the log mean,
    about mean / y, is huge for the leaves of the smallest labels.  The
    port grows the JAX package's first tree and its most negative leaf
    under ``int8h``; the float histograms (``hilo``) keep a large
    negative leaf too, so the step is the objective's, not the
    quantization's.  On ``exp(z / 8)`` the leaves stay small."""
    import lightgbm_tpu as jlgb

    import lightgbm_tpu_torch as tlgb
    monkeypatch.setenv("LGBM_TPU_HIST_BACKEND", "compact")
    monkeypatch.setenv("LGBM_TPU_SPLIT_INTERPRET", "1")
    rng = np.random.RandomState(0)
    X = rng.normal(size=(20000, 6)).astype(np.float32)
    z = X[:, 0] * 2 + X[:, 1] - X[:, 2] + rng.normal(size=20000)
    params = {"objective": "gamma", "num_leaves": 63, "max_bin": 63,
              "min_data_in_leaf": 20, "verbose": -1}

    def lowest(lgb, y, **kw):
        bst = lgb.train(dict(params, **kw.pop("extra", {})),
                        lgb.Dataset(X, label=y), num_boost_round=1, **kw)
        t = bst._gbdt.models[0]
        return float(np.min(t.leaf_value[:t.num_leaves]))
    wide = np.exp(z / 2).astype(np.float32)
    ref = lowest(jlgb, wide)
    got = lowest(tlgb, wide, device="cpu")
    assert got < -10.0
    assert abs(got - ref) <= tol("f32_accum") * abs(ref)
    assert lowest(tlgb, wide, device="cpu", extra={"hist_mode": "hilo"}) < -5.0
    narrow = np.exp(z / 8).astype(np.float32)
    assert lowest(tlgb, narrow, device="cpu") > -1.0
