"""LambdaRank in lightgbm_tpu_torch against the JAX package, on the CPU.

Gradients: the same seeded labels, queries and scores through both
packages' ``LambdarankNDCG`` -- query sizes 1 and 2, sizes in the
16-doc bucket and one past it, a 90-doc query, all scores tied (the
first iteration, decided by the stable sort alone) and random ones.
The pair grids fold to per-doc sums in torch's order, not XLA's, so the
gradients are held within ``f32_accum``; the same chunked (``C <
nq``) and unchunked are bitwise equal in the port.  A whole toy model
with ``group=``, a valid set from ``create_valid(..., group=)`` and an
NDCG early stop has the JAX package's digest, or its first divergence
is a near-tie flip (``model_flip_report``), with the same stop and best
iteration and NDCG within ``metric_coarse``.
"""
import numpy as np
import pytest
import torch

from tools.numcheck.tolerance_registry import tol

import lightgbm_tpu as jlgb
from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.io.dataset import Metadata as JMetadata
from lightgbm_tpu.objective import objectives as jobj
from lightgbm_tpu.parallel.envelope import model_flip_report

import lightgbm_tpu_torch as tlgb
from lightgbm_tpu_torch.config import Config as TConfig
from lightgbm_tpu_torch.io.dataset import Metadata as TMetadata
from lightgbm_tpu_torch.metric.metrics import NDCGMetric
from lightgbm_tpu_torch.objective import objectives as tobj

torch.set_num_threads(1)   # tiny tensors: more threads only spin

SIZES = np.array([1, 2, 16, 17, 40, 5, 3, 90, 1, 12, 33, 16, 2, 8, 20])


def _objectives(params=None, seed=0):
    rng = np.random.RandomState(seed)
    n = int(SIZES.sum())
    label = rng.randint(0, 5, size=n).astype(np.float32)
    label[1:3] = 2.0             # the 2-doc query: equal labels, no pair
    out = []
    for Cfg, Md, mod, kw in ((JConfig, JMetadata, jobj, {}),
                             (TConfig, TMetadata, tobj,
                              {"device": "cpu"})):
        md = Md()
        md.set_field("label", label)
        md.set_field("group", SIZES)
        o = mod.create_objective(Cfg.from_params(
            {"objective": "lambdarank", **(params or {})}))
        o.init(md, n, **kw)
        out.append(o)
    return out, n, rng


@pytest.mark.parametrize("params", [{}, {"max_position": 5, "sigmoid": 1.7},
                                    {"label_gain": "0,1,3,7,15"}],
                         ids=["default", "truncated", "label_gain"])
@pytest.mark.parametrize("scores", ["tied", "random"])
def test_lambdarank_gradients_match_reference(params, scores):
    (jo, to), n, rng = _objectives(params)
    s = (np.zeros(n, np.float32) if scores == "tied"
         else rng.normal(size=n).astype(np.float32))
    gj, hj = (np.asarray(a) for a in jo.get_gradients(s))
    gt, ht = (a.numpy() for a in to.get_gradients(torch.from_numpy(s)))
    np.testing.assert_allclose(gt, gj, rtol=tol("f32_accum"),
                               atol=tol("f32_accum"))
    np.testing.assert_allclose(ht, hj, rtol=tol("f32_accum"),
                               atol=tol("f32_accum"))
    assert np.abs(gt).max() > 0.1
    # a single-doc query and a query of equal labels have no pairs
    assert gt[0] == 0.0 and ht[0] == 0.0
    np.testing.assert_array_equal(gt[1:3], 0.0)
    assert [b["M"] for b in to.buckets] == [16, 32, 64, 128]


def test_lambdarank_chunked_equals_whole(monkeypatch):
    """Chunks of 2 queries (``C < nq`` in every bucket) give the
    unchunked gradients bitwise, and the JAX package's chunked dispatch
    (its ``lax.map`` over padded chunks) within ``f32_accum``."""
    (jo, to), n, rng = _objectives(seed=3)
    s = rng.normal(size=n).astype(np.float32)
    g0, h0 = to.get_gradients(torch.from_numpy(s))
    monkeypatch.setenv("LGBM_TPU_RANK_CHUNK_PAIRS", str(2 * 20 * 32))
    g1, h1 = to.get_gradients(torch.from_numpy(s))
    assert torch.equal(g0, g1) and torch.equal(h0, h1)
    gj, hj = jo.get_gradients(s)
    np.testing.assert_allclose(g1.numpy(), np.asarray(gj),
                               rtol=tol("f32_accum"), atol=tol("f32_accum"))
    np.testing.assert_allclose(h1.numpy(), np.asarray(hj),
                               rtol=tol("f32_accum"), atol=tol("f32_accum"))


def _rank_data(nq, seed):
    rng = np.random.RandomState(seed)
    sizes = np.clip(np.round(rng.lognormal(2.5, 0.7, size=nq)), 1,
                    200).astype(int)
    n = int(sizes.sum())
    X = rng.normal(size=(n, 8)).astype(np.float32)
    s = X[:, 0] * 1.5 + X[:, 1] - 0.5 * X[:, 2] + rng.normal(size=n)
    y = np.digitize(s, np.quantile(s, [0.5, 0.75, 0.9, 0.97]))
    return X, y.astype(np.float32), sizes


def test_lambdarank_model_matches_reference(monkeypatch):
    monkeypatch.setenv("LGBM_TPU_HIST_BACKEND", "compact")
    monkeypatch.setenv("LGBM_TPU_SPLIT_INTERPRET", "1")
    X, y, g = _rank_data(150, 7)
    Xv, yv, gv = _rank_data(40, 8)
    params = {"objective": "lambdarank", "num_leaves": 15, "max_bin": 63,
              "learning_rate": 0.1, "min_data_in_leaf": 0,
              "min_sum_hessian_in_leaf": 1.0, "ndcg_eval_at": [3, 10],
              "verbose": -1}
    out = []
    for lgb, kw in ((jlgb, {}), (tlgb, {"device": "cpu"})):
        ds = lgb.Dataset(X, label=y, group=g)
        vs = ds.create_valid(Xv, label=yv, group=gv)
        out.append(lgb.train(dict(params), ds, num_boost_round=15,
                             valid_sets=[vs], early_stopping_rounds=3,
                             verbose_eval=False, **kw))
    jb, tb = out
    assert tb.current_iteration() == jb.current_iteration
    assert tb.best_iteration == jb.best_iteration
    if tb.digest(include_scores=False) != jb.digest(include_scores=False):
        rep = model_flip_report(jb.model_to_string(), tb.model_to_string())
        assert rep["near_tie"], rep
    qb = np.concatenate([[0], np.cumsum(gv)])
    m = NDCGMetric(TConfig.from_params({"ndcg_eval_at": [10]}))
    nj = m.eval(yv, jb.predict(Xv, raw_score=True), None, qb)[0][1]
    nt = m.eval(yv, tb.predict(Xv, raw_score=True), None, qb)[0][1]
    assert abs(nj - nt) <= tol("metric_coarse")
    assert nt > 0.6


def test_ndcg_early_stopping_records_names():
    """``ndcg@k`` is higher-is-better: the stop keeps the best
    iteration, and ``evals_result`` names each cut."""
    X, y, g = _rank_data(60, 1)
    ds = tlgb.Dataset(X, label=y, group=g)
    evals = {}
    bst = tlgb.train({"objective": "lambdarank", "num_leaves": 7,
                      "learning_rate": 0.5, "min_data_in_leaf": 5,
                      "ndcg_eval_at": [1, 5], "verbose": -1}, ds,
                     num_boost_round=30,
                     valid_sets=[ds.create_valid(X, label=y, group=g)],
                     valid_names=["v"], early_stopping_rounds=2,
                     evals_result=evals, verbose_eval=False, device="cpu")
    assert list(evals["v"]) == ["ndcg@1", "ndcg@5"]
    first = evals["v"]["ndcg@1"]
    assert bst.best_iteration == int(np.argmax(first)) + 1
    assert bst.current_iteration() < 30


def test_group_surface():
    X, y, g = _rank_data(20, 2)
    ds = tlgb.Dataset(X, label=y)
    ds.set_group(g)
    np.testing.assert_array_equal(ds.get_group(), g)
    vs = ds.create_valid(X[:int(g[:5].sum())], label=y[:int(g[:5].sum())],
                         group=g[:5])
    np.testing.assert_array_equal(vs.get_group(), g[:5])
    assert vs.reference is ds
    qb = ds._constructed.metadata.query_boundaries
    sub = ds._constructed.subset(np.arange(qb[2], qb[6]))
    np.testing.assert_array_equal(np.diff(sub.metadata.query_boundaries),
                                  g[2:6])
    with pytest.raises(ValueError, match="splits ranking queries"):
        ds._constructed.subset(np.arange(qb[2] + 1, qb[6]))
    with pytest.raises(ValueError, match="query"):
        tlgb.train({"objective": "lambdarank", "verbose": -1},
                   tlgb.Dataset(X, label=y), num_boost_round=1,
                   device="cpu")


def _xla_order_fold(signed, hh, T, M):
    """The JAX package's compiled fold at M >= 64: row sums in
    sequential blocks of 32 (``fixed_sum``), column sums sequential."""
    from lightgbm_tpu_torch.ops.histogram import fixed_sum
    pad = (0, M - T)
    cs, ch = torch.zeros_like(signed[:, 0]), torch.zeros_like(hh[:, 0])
    for t in range(T):
        cs, ch = cs + signed[:, t], ch + hh[:, t]
    return (torch.nn.functional.pad(fixed_sum(signed, 2), pad) - cs,
            torch.nn.functional.pad(fixed_sum(hh, 2), pad) + ch)


@pytest.mark.parametrize("M", [64, 256, 2048])
def test_reference_fold_order_is_known(monkeypatch, M):
    """Where the port's ``torch.sum`` fold differs from the JAX package,
    the difference is the summation order alone: with the reference's
    compiled order (blocks of 32 over M, sequential over T) the port's
    bucket gradients are bitwise the JAX package's.  The scores tie, so
    every sigmoid is exactly 0.5 (torch's and XLA's sigmoids differ by
    an ulp elsewhere)."""
    rng = np.random.RandomState(M)
    C, T = 5, 20
    valid = np.arange(M)[None, :] < rng.randint(M // 2 + 1, M + 1,
                                                size=C)[:, None]
    label = np.where(valid, rng.randint(0, 5, size=(C, M)), -1).astype(
        np.float32)
    gain = np.where(valid, 2.0 ** np.maximum(label, 0) - 1, 0).astype(
        np.float32)
    imd = rng.uniform(0.01, 0.2, size=C).astype(np.float32)
    disc = (1.0 / np.log2(np.arange(M) + 2.0)).astype(np.float32)
    s = np.zeros((C, M), np.float32)
    want = jobj._lambdarank_bucket_grads(s, valid, label, gain, imd, disc,
                                         np.float32(1.3), T=T, C=C)
    monkeypatch.setattr(tobj, "fold_pair_grid", _xla_order_fold)
    got = tobj.lambdarank_bucket_grads(*(torch.from_numpy(a) for a in (
        s, valid, label, gain, imd, disc)), 1.3, T)
    for g, w in zip(got, want):
        w = np.asarray(w)[valid]
        np.testing.assert_array_equal(g.numpy()[valid].view(np.int32),
                                      w.view(np.int32))
