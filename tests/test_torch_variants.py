"""The boosting variants of lightgbm_tpu_torch (GOSS, DART, random
forests), held against the JAX package at toy size on the CPU.

The JAX side runs its kernels in Pallas interpret mode
(``LGBM_TPU_HIST_BACKEND=compact``, ``LGBM_TPU_SPLIT_INTERPRET=1``).
With L2 regression both packages build every variant bitwise, scores
included.  Binary and multiclass gradients go through ``exp``, which the
port does not round as XLA does (``tol("f32_eps_few")``), so those
models are held as equal digests or a first divergence that
``model_flip_report`` classifies as a near tie.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tools.numcheck.tolerance_registry import tol

import lightgbm_tpu as jlgb
from lightgbm_tpu.boosting import variants as jvariants
from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.parallel.envelope import model_flip_report

import lightgbm_tpu_torch as tlgb
from lightgbm_tpu_torch.boosting import snapshot as snap
from lightgbm_tpu_torch.boosting import variants
from lightgbm_tpu_torch.boosting.gbdt import ordered_tree_sum
from lightgbm_tpu_torch.utils import faults

torch.set_num_threads(1)   # tiny tensors: more threads only spin

BASE = {"num_leaves": 7, "max_bin": 63, "learning_rate": 0.1,
        "min_data_in_leaf": 20, "verbose": -1}
DART = {"boosting": "dart", "drop_rate": 0.3, "skip_drop": 0.2}
VARIANTS = {
    "goss": {"boosting": "goss"},
    "dart": DART,
    "dart_uniform": dict(DART, uniform_drop=True),
    "dart_xgboost": dict(DART, xgboost_dart_mode=True),
    "dart_xgboost_uniform": dict(DART, xgboost_dart_mode=True,
                                 uniform_drop=True),
    "rf": {"boosting": "rf", "bagging_freq": 1, "bagging_fraction": 0.7},
}


@pytest.fixture(autouse=True)
def _reference_kernels(monkeypatch):
    monkeypatch.setenv("LGBM_TPU_HIST_BACKEND", "compact")
    monkeypatch.setenv("LGBM_TPU_SPLIT_INTERPRET", "1")
    monkeypatch.delenv("LGBM_TPU_DART_HOST_RNG", raising=False)
    faults.clear()
    yield
    faults.clear()


def _data(objective, n=1000, f=6, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.normal(size=(n, f)).astype(np.float32)
    z = X[:, 0] * 2 + X[:, 1] - X[:, 2] + rng.normal(size=n)
    if objective == "binary":
        return X, (z > 0).astype(np.float32), {"objective": "binary"}
    if objective == "multiclass":
        y = np.argmax(X[:, :3] + 0.5 * rng.normal(size=(n, 3)), axis=1)
        return X, y.astype(np.float32), {"objective": "multiclass",
                                         "num_class": 3}
    return X, z.astype(np.float32), {"objective": "regression"}


def _both(objective, variant, rounds=8, **extra):
    X, y, p = _data(objective)
    params = {**BASE, **p, **VARIANTS[variant], **extra}
    jb = jlgb.train(dict(params), jlgb.Dataset(X, label=y),
                    num_boost_round=rounds, verbose_eval=False)
    tb = tlgb.train(dict(params), tlgb.Dataset(X, label=y),
                    num_boost_round=rounds, verbose_eval=False, device="cpu")
    return X, jb, tb


def _same_model(jb, tb):
    """Equal digests, or the first divergence a near tie."""
    if tb.digest(include_scores=False) != jb.digest(include_scores=False):
        rep = model_flip_report(jb.model_to_string(), tb.model_to_string())
        assert rep["near_tie"], rep


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_variant_l2_bitwise(variant):
    """L2 regression: the model text and the training scores equal the
    JAX package's bitwise."""
    _, jb, tb = _both("regression", variant)
    assert tb.model_to_string() == jb.model_to_string()
    assert tb.digest() == jb.digest()


@pytest.mark.parametrize("objective", ["binary", "multiclass"])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_variant_matches_reference(variant, objective):
    X, jb, tb = _both(objective, variant)
    assert tb.current_iteration() == jb.current_iteration
    _same_model(jb, tb)
    head = tb.model_to_string().split("\n")[0]
    assert head == VARIANTS[variant]["boosting"]
    assert head == jb.model_to_string().split("\n")[0]


@pytest.mark.parametrize("K", [1, 3])
def test_goss_sample_bitwise(K):
    """Mask and scaled gradients equal the JAX package's ``_block_sample``
    on the same gradients, ties at the threshold included."""
    rng = np.random.RandomState(K)
    n = 5000
    g = rng.normal(size=(n, K)).astype(np.float32)
    h = rng.uniform(0.1, 1.0, size=(n, K)).astype(np.float32)
    g[:200] = g[200]                                   # a block of ties
    h[:200] = h[200]
    ref = jvariants.GOSS.__new__(jvariants.GOSS)
    ref.config = JConfig.from_params({"boosting": "goss", "top_rate": 0.2,
                                      "other_rate": 0.1, "bagging_seed": 7})
    ref.num_data, ref._pr = n, None
    for it in (0, 1, 17):
        G, H, bag = ref._block_sample(jnp.asarray(g), jnp.asarray(h), it)
        tg, th, tbag = variants.goss_sample(torch.tensor(g), torch.tensor(h),
                                            it, 0.2, 0.1, 7)
        assert np.array_equal(np.asarray(G), tg.numpy())
        assert np.array_equal(np.asarray(H), th.numpy())
        assert np.array_equal(np.asarray(bag), tbag.numpy())


def test_dart_uniforms_bitwise():
    for it in (1, 2, 3, 7, 8, 9, 33):
        ju, jv = jvariants._drop_uniforms(4, it)
        tu, tv = variants._drop_uniforms(4, it)
        assert ju == tu
        assert np.array_equal(np.asarray(jv), tv)


@pytest.mark.parametrize("variant", ["dart", "dart_uniform",
                                     "dart_xgboost"])
def test_dart_drop_sets_bitwise(variant, monkeypatch):
    """20 iterations of drop sets equal the JAX package's
    ``_select_drop`` (on the bitwise-equal L2 models, so the weights
    that scale the rates agree too)."""
    seen = {"jax": [], "port": []}

    def spy(cls, key):
        orig = cls._select_drop

        def select(self):
            out = orig(self)
            seen[key].append([int(i) for i in out])
            return out
        monkeypatch.setattr(cls, "_select_drop", select)
    spy(jvariants.DART, "jax")
    spy(variants.DART, "port")
    _both("regression", variant, rounds=20, drop_rate=0.5, skip_drop=0.1,
          max_drop=3)
    assert len(seen["port"]) == 20
    assert seen["port"] == seen["jax"]
    assert sum(map(len, seen["port"])) > 10
    assert max(map(len, seen["port"])) == 3                # max_drop caps


@pytest.mark.parametrize("trees", [1, 5, 32, 33, 70])
def test_replay_sum_order_is_xla_order(trees):
    """The dropped set's sum: ``jnp.sum`` over the tree axis padded with
    zeros to a power of two, bitwise (values over many magnitudes, where
    another order shows)."""
    rng = np.random.RandomState(trees)
    v = (rng.normal(size=(trees, 3000))
         * 10.0 ** rng.uniform(-5, 2, size=(trees, 3000))).astype(np.float32)
    pad = 1 << max(0, (trees - 1).bit_length())
    ref = np.asarray(jnp.sum(jnp.asarray(np.concatenate(
        [v, np.zeros((pad - trees, 3000), np.float32)])), axis=0))
    got = ordered_tree_sum([torch.tensor(r) for r in v]).numpy()
    assert np.array_equal(got, ref)


def test_model_text_and_average_output():
    """The first line names the variant; a random forest writes
    ``average_output`` and a loaded one predicts the trees' average."""
    X, jb, tb = _both("binary", "rf")
    text = tb.model_to_string()
    assert "average_output" in text.split("Tree=")[0].split("\n")
    assert text.split("Tree=")[0] == jb.model_to_string().split("Tree=")[0]
    loaded = tlgb.Booster(model_str=text, device="cpu")
    raw = loaded.predict(X, raw_score=True)
    T = loaded.num_trees()
    want = 1.0 / (1.0 + np.exp(-(raw / T)))
    np.testing.assert_allclose(loaded.predict(X), want, rtol=0,
                               atol=tol("f32_tight"))
    np.testing.assert_array_equal(loaded.predict(X), tb.predict(X))
    _, _, gb = _both("binary", "goss", rounds=2)
    assert gb.model_to_string().split("\n")[0] == "goss"
    assert "average_output" not in gb.model_to_string()


def _dart_params(prefix, **kw):
    return {**BASE, "objective": "regression", **DART, "drop_rate": 0.5,
            "output_model": str(prefix), **kw}


def test_port_dart_resume_byte_identical(tmp_path):
    """A DART run killed while writing its iteration-8 snapshot resumes
    from iteration 4 and writes the uninterrupted run's model text, byte
    for byte (each tree's exact shrinkage rides the snapshot, C9)."""
    X, y, _ = _data("regression")
    a = tlgb.train(_dart_params(tmp_path / "A.txt"), tlgb.Dataset(X, label=y),
                   num_boost_round=12, verbose_eval=False, device="cpu")
    prefix = tmp_path / "B.txt"
    faults.inject("snapshot.write", times=1, skip=1)
    with pytest.raises(faults.FaultInjected):
        tlgb.train(_dart_params(prefix, snapshot_freq=4),
                   tlgb.Dataset(X, label=y), num_boost_round=12,
                   verbose_eval=False, device="cpu")
    faults.clear()
    assert snap.latest_valid_snapshot(str(prefix))["iteration"] == 4
    b = tlgb.train(_dart_params(prefix, snapshot_freq=4),
                   tlgb.Dataset(X, label=y), num_boost_round=12,
                   verbose_eval=False, resume_from=str(prefix), device="cpu")
    assert b.current_iteration() == 12
    assert b.model_to_string() == a.model_to_string()
    assert b.digest() == a.digest()


def _shrinkage_free(text):
    return [line for line in text.split("\n")
            if not line.startswith("shrinkage=")]


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_dart_snapshot_crosses_packages(tmp_path, writer):
    """Either package resumes the other's DART snapshot (weights in the
    JAX package's keys) to the uninterrupted model: equal trees and
    leaves; only ``shrinkage=`` may differ in its 8th digit where the
    JAX package's side reads it from the text (ROADMAP C9)."""
    X, y, _ = _data("regression")
    full = jlgb.train(_dart_params(tmp_path / "full.txt"),
                      jlgb.Dataset(X, label=y), num_boost_round=12,
                      verbose_eval=False)
    prefix = tmp_path / "snap.txt"
    first, second = ((jlgb, tlgb) if writer == "jax" else (tlgb, jlgb))
    kw = {"device": "cpu"} if first is tlgb else {}
    first.train(_dart_params(prefix, snapshot_freq=4),
                first.Dataset(X, label=y), num_boost_round=4,
                verbose_eval=False, **kw)
    m = snap.latest_valid_snapshot(str(prefix))
    assert m["iteration"] == 4 and "dart_tree_weights" in m["extra_state"]
    kw = {"device": "cpu"} if second is tlgb else {}
    bst = second.train(_dart_params(prefix), second.Dataset(X, label=y),
                       num_boost_round=12, verbose_eval=False,
                       resume_from=str(prefix), **kw)
    assert bst.digest(include_scores=False) == \
        full.digest(include_scores=False)
    assert _shrinkage_free(bst.model_to_string()) == \
        _shrinkage_free(full.model_to_string())


@pytest.mark.parametrize("boosting_type", ["goss", "dart", "rf"])
def test_sklearn_boosting_type(boosting_type):
    X, y, _ = _data("binary")
    kw = dict(boosting_type=boosting_type, n_estimators=6, num_leaves=7,
              max_bin=63)
    if boosting_type == "rf":
        kw.update(subsample=0.7, subsample_freq=1)
    jm = jlgb.LGBMClassifier(**kw).fit(X, y)
    tm = tlgb.LGBMClassifier(device="cpu", **kw).fit(X, y)
    _same_model(jm.booster_, tm.booster_)
    assert tm.booster_.model_to_string().split("\n")[0] == boosting_type
    assert np.mean(tm.predict(X) == jm.predict(X)) > 0.99


def test_unported_options_raise(monkeypatch):
    X, y, p = _data("binary", n=200)
    # the legacy stateful DART stream trains now (its parity with the JAX
    # package: tests/test_torch_determinism.py)
    monkeypatch.setenv("LGBM_TPU_DART_HOST_RNG", "1")
    bst = tlgb.train({**p, "boosting": "dart"}, tlgb.Dataset(X, label=y), 2,
                     device="cpu")
    assert bst.current_iteration() == 2
    monkeypatch.delenv("LGBM_TPU_DART_HOST_RNG")
    with pytest.raises(ValueError, match="bagging"):
        tlgb.train({**p, "boosting": "rf"}, tlgb.Dataset(X, label=y), 2,
                   device="cpu")
    # num_machines > 1 trains now: outside a process group it is the
    # serial model (multi-process GOSS: tests/test_torch_multiprocess.py)
    goss = tlgb.train({**p, "boosting": "goss"}, tlgb.Dataset(X, label=y),
                      2, device="cpu")
    goss2 = tlgb.train({**p, "boosting": "goss", "num_machines": 2},
                       tlgb.Dataset(X, label=y), 2, device="cpu")
    assert goss2.digest() == goss.digest()


def test_dart_learning_rates_bitwise():
    """``learning_rates`` reach DART's shrinkage: the L2 model equals the
    JAX package's (both round the product before the add)."""
    lrs = [0.1] * 4 + [0.05] * 4
    _, jb, tb = _both("regression", "dart", learning_rates=lrs)
    assert tb.model_to_string() == jb.model_to_string()


def test_rf_continues_from_init_model():
    """A random forest continued from a GBDT model: the loaded trees go
    in front, replayed into the scores, as in the JAX package."""
    X, y, p = _data("regression")
    base = jlgb.train({**BASE, **p}, jlgb.Dataset(X, label=y), 3,
                      verbose_eval=False).model_to_string()
    params = {**BASE, **p, **VARIANTS["rf"]}
    jb = jlgb.train(dict(params), jlgb.Dataset(X, label=y), 4,
                    init_model=base, verbose_eval=False)
    tb = tlgb.train(dict(params), tlgb.Dataset(X, label=y), 4,
                    init_model=base, verbose_eval=False, device="cpu")
    assert tb.num_trees() == 7
    assert tb.model_to_string() == jb.model_to_string()


def test_cv_reaches_variants():
    """``cv`` folds train GOSS: each iteration's mean l2 within
    ``metric_coarse`` of the JAX package's (its per-iteration loop rounds
    the score update, the port fuses it, C3)."""
    X, y, p = _data("regression")
    params = {**BASE, **p, **VARIANTS["goss"]}
    j = jlgb.cv(dict(params), jlgb.Dataset(X, label=y), 5, nfold=3)
    t = tlgb.cv(dict(params), tlgb.Dataset(X, label=y), 5, nfold=3,
                device="cpu")
    np.testing.assert_allclose(t["l2-mean"], j["l2-mean"], rtol=0,
                               atol=tol("metric_coarse"))
