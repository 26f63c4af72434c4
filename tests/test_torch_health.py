"""The live health plane of lightgbm_tpu_torch against the JAX package's,
on the CPU: the health state machine, the stall watchdog and the
numerics sentinels (``obs/health.py``) and the ops plane's ``/metrics``,
``/healthz`` and ``/drain`` (``obs/ops_plane.py``), mounted by a toy
``lgb.train`` and a toy ``PredictionServer``.

State sequences and the Prometheus text are held to the JAX package's
modules on the same calls and feeds; ``health.nan_grad`` degrades the
same iteration of an L2 toy run in both packages (the JAX package on its
per-iteration path with a valid set evaluated every iteration, so its
windows are single iterations).
"""
import json
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import lightgbm_tpu as jlgb
from lightgbm_tpu import obs as jobs
from lightgbm_tpu.obs import health as jhealth
from lightgbm_tpu.obs import ops_plane as jops
from lightgbm_tpu.utils import faults as jfaults

import lightgbm_tpu_torch as tlgb
from lightgbm_tpu_torch import obs as tobs
from lightgbm_tpu_torch.obs import health as thealth
from lightgbm_tpu_torch.obs import ops_plane as tops
from lightgbm_tpu_torch.serve import PredictionServer, compile_model
from lightgbm_tpu_torch.utils import faults as tfaults

torch.set_num_threads(1)   # tiny tensors: more threads only spin

BASE = {"num_leaves": 7, "max_bin": 63, "min_data_in_leaf": 20,
        "verbose": -1}


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for var in ("LGBM_TPU_OPS_PORT", "LGBM_TPU_WATCHDOG_S",
                "LGBM_TPU_SENTINELS", "LGBM_TPU_FORENSIC"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("LGBM_TPU_HIST_BACKEND", "compact")
    monkeypatch.setenv("LGBM_TPU_SPLIT_INTERPRET", "1")
    for o in (tobs, jobs):
        o.reset()
    tfaults.clear()
    jfaults.clear()
    yield
    tfaults.clear()
    jfaults.clear()
    for ops, h, o in ((tops, thealth, tobs), (jops, jhealth, jobs)):
        ops.shutdown()
        h._set_active(False)
        o.reset()


def _data(objective="regression", n=600, f=6, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.normal(size=(n, f)).astype(np.float32)
    z = X[:, 0] * 2 + X[:, 1] - X[:, 2] + rng.normal(size=n)
    if objective == "binary":
        return X, (z > 0).astype(np.float32), {"objective": "binary"}
    return X, z.astype(np.float32), {"objective": "regression"}


def _scrape(port, path="/metrics"):
    """-> (status, body); error bodies are read, not raised."""
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=10) as resp:
            return resp.status, resp.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def _counter(body, name):
    for ln in body.splitlines():
        if ln.startswith(name + " "):
            return float(ln.split()[-1])
    return None


# ---------------------------------------------------------------------------
# state machine
# ---------------------------------------------------------------------------
CALLS = [("mark_warming", ("train",), {}), ("mark_ready", (), {}),
         ("mark_recovering", (), {"reason": "x"}), ("mark_ready", (), {}),
         ("mark_draining", (), {"plane": "serve"}), ("mark_ready", (), {}),
         ("mark_degraded", ("nonfinite",), {"window": 3}),
         ("mark_ready", (), {}), ("mark_stalled", ("gbdt.iteration",), {}),
         ("mark_degraded", ("loss_spike",), {"window": 5}),
         ("mark_warming", (), {})]


@pytest.mark.parametrize("active", [True, False])
def test_state_sequence_is_reference(active):
    seqs = []
    for h in (jhealth, thealth):
        h._set_active(active)
        h.reset()
        seq = [h.state()["state"]]
        for fn, args, kw in CALLS:
            getattr(h, fn)(*args, **kw)
            st = h.state()
            seq.append((st["state"], sorted(st["detail"].items())))
        seqs.append(seq)
    assert seqs[1] == seqs[0]


def test_sentinel_units_are_reference():
    for h in (jhealth, thealth):
        h._set_active(True)
        h.reset()
    ok = np.ones(10, np.float32)
    bad = ok.copy()
    bad[3] = np.nan
    for h in (jhealth, thealth):
        assert h.check_scores(ok, window=1)
        assert not h.check_scores(bad, window=2)
        assert not h.check_leaf_values([np.array([np.inf])], window=2)
        assert h.check_metrics([("valid", "l2", 1.0, False)], window=3)
        assert not h.check_metrics([("valid", "l2", 9.0, False)], window=4)
    assert thealth.state()["state"] == jhealth.state()["state"] == \
        "degraded"
    assert thealth.state()["detail"] == jhealth.state()["detail"]


@pytest.mark.parametrize("as_tensor", [False, True])
def test_check_scores_on_a_tensor_is_the_array_check(as_tensor):
    """``check_scores`` on a score tensor (the sentinel alone checks on
    the scores' device) gives the array check's result and detail."""
    bad = np.ones((50, 2), np.float32)
    bad[[3, 7], 1] = [np.nan, np.inf]
    for h in (jhealth, thealth):
        h._set_active(True)
        h.reset()
    assert thealth.check_scores(torch.ones(50, 2) if as_tensor
                                else np.ones((50, 2), np.float32), 1)
    assert not thealth.check_scores(torch.from_numpy(bad) if as_tensor
                                    else bad, window=2)
    assert not jhealth.check_scores(bad, window=2)
    assert thealth.state()["detail"] == jhealth.state()["detail"]
    assert thealth.state()["detail"]["bad_elements"] == 2


@pytest.mark.parametrize("values,clean", [
    ([3e38, 3e38, -1.0], True),         # finite, but the f32 sum overflows
    ([np.inf, -np.inf, 1.0], False),    # the sum is NaN
    ([1.0, -np.inf, 2.0], False),
])
def test_check_scores_on_a_tensor_by_its_sum(values, clean):
    """The tensor check is one sum on the scores' device: a non-finite
    element makes the sum non-finite, and a finite sum that overflows
    goes to the exact check, so the result is the array check's."""
    scores = np.array(values, np.float32).reshape(-1, 1)
    for h in (jhealth, thealth):
        h._set_active(True)
        h.reset()
    assert thealth.check_scores(torch.from_numpy(scores), window=1) is clean
    assert jhealth.check_scores(scores, window=1) is clean
    assert thealth.state()["detail"] == jhealth.state()["detail"]


# ---------------------------------------------------------------------------
# numerics sentinels in training
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("skip", [0, 2])
def test_nan_grad_degrades_the_reference_iteration(monkeypatch, skip):
    monkeypatch.setenv("LGBM_TPU_SENTINELS", "1")
    monkeypatch.setenv("LGBM_TPU_NO_BLOCK", "1")
    X, y, p = _data()
    params = {**BASE, **p, "metric": "l2"}
    jobs.enable()
    tobs.enable()
    jfaults.inject("health.nan_grad", times=1, skip=skip)
    jlgb.train(dict(params), jlgb.Dataset(X, label=y), 6,
               valid_sets=[jlgb.Dataset(X[:200], label=y[:200])],
               verbose_eval=False)
    tfaults.inject("health.nan_grad", times=1, skip=skip)
    bst = tlgb.train(dict(params), tlgb.Dataset(X, label=y), 6,
                     valid_sets=[tlgb.Dataset(X[:200], label=y[:200])],
                     verbose_eval=False, device="cpu")
    js, ts = jhealth.state(), thealth.state()
    assert ts["state"] == js["state"] == "degraded"
    assert ts["detail"]["reason"] == js["detail"]["reason"] == "nonfinite"
    assert ts["detail"]["window"] == js["detail"]["window"] == skip
    assert tobs.summary()["events"]["health:nonfinite"] == 1
    assert tobs.summary()["health"]["state"] == "degraded"
    assert bst.current_iteration() == skip


def test_clean_train_stays_ready_under_sentinels(monkeypatch):
    monkeypatch.setenv("LGBM_TPU_SENTINELS", "1")
    tobs.enable()
    X, y, p = _data("binary")
    tlgb.train({**BASE, **p}, tlgb.Dataset(X, label=y), 5, device="cpu",
               verbose_eval=False)
    s = tobs.summary()
    assert "health:nonfinite" not in s["events"]
    assert thealth.state()["state"] == "ready"
    assert s["counters"]["health.sentinel_checks"] == 5


# ---------------------------------------------------------------------------
# stall watchdog
# ---------------------------------------------------------------------------
def test_watchdog_stall_writes_forensics_and_503(monkeypatch, tmp_path):
    trace = str(tmp_path / "t.jsonl")
    monkeypatch.setenv("LGBM_TPU_WATCHDOG_S", "0.25")
    monkeypatch.setenv("LGBM_TPU_OPS_PORT", "0")
    plane = tops.mount("test")
    X, y, p = _data("binary")
    tfaults.inject("watchdog.stall", times=1, skip=1)
    bst = tlgb.train({**BASE, **p, "telemetry_output": trace},
                     tlgb.Dataset(X, label=y), 4, device="cpu",
                     verbose_eval=False)
    assert bst.current_iteration() == 4      # the run survived the stall
    s = tobs.summary()
    assert s["events"]["health:stall"] == 1
    assert s["counters"]["watchdog.fires"] == 1
    assert s["counters"]["watchdog.arms"] == 4
    st = thealth.state()
    assert st["state"] == "stalled"
    assert st["detail"]["stalled_span"] == "gbdt.iteration"
    dump = json.load(open(trace + ".forensic.json"))
    assert dump["span"] == "gbdt.iteration" and dump["plane"] == "train"
    assert dump["attrs"]["it"] == 1 and dump["deadline_s"] == 0.25
    assert "Thread" in dump["stacks"] and "counters" in dump
    code, body = _scrape(plane.port, "/healthz")
    assert code == 503 and json.loads(body)["state"] == "stalled"


def test_watchdog_stall_on_a_serve_batch(monkeypatch, tmp_path):
    monkeypatch.setenv("LGBM_TPU_FORENSIC", str(tmp_path / "s.json"))
    X, y, p = _data("binary")
    bst = tlgb.train({**BASE, **p}, tlgb.Dataset(X, label=y), 3,
                     device="cpu", verbose_eval=False)
    monkeypatch.setenv("LGBM_TPU_WATCHDOG_S", "0.15")
    tobs.enable()
    srv = PredictionServer(compile_model(bst), max_batch=256,
                           max_wait_ms=1.0, buckets=(64, 256),
                           raw_score=True)
    tfaults.inject("watchdog.stall", times=1)
    out = srv.submit(X[:3]).result(60)
    assert np.asarray(out).shape == (3,)
    srv.close()
    assert tobs.summary()["events"]["health:stall"] == 1
    dump = json.load(open(tmp_path / "s.json"))
    assert dump["span"] == "serve.batch" and dump["plane"] == "serve"


# ---------------------------------------------------------------------------
# ops plane
# ---------------------------------------------------------------------------
def _feed(tel, sink):
    tel.set_sink(sink)
    tel.counter_add("gbdt.dispatch_gaps", 3)
    tel.counter_add("retry.serve.score.backoff_s", 0.25)
    tel.gauge_set("gbdt.num_trees", 12)
    tel.gauge_set("gbdt.dispatch_gap_mean_s", 0.0125)
    tel.gauge_set("note", "not numeric")
    tel.event("health", "stall", span="x")
    tel.event("fault", "serve.score")
    tel.event("fault", "serve.score")
    for i, d in enumerate((0.5, 0.25, 0.125, 1.0, 2.0)):
        sink.span("gbdt.iteration", d)
        sink.span("tree.hist", d / 8)
        sink.lock_wait("telemetry", d / 100, contended=bool(i % 2))
        sink.lock_wait("serve", d / 1000)


def test_render_prometheus_is_reference():
    from lightgbm_tpu.obs import telemetry as jtel
    from lightgbm_tpu_torch.obs import telemetry as ttel
    texts = []
    for tel, ops in ((jtel, jops), (ttel, tops)):
        tel.enable()
        reg = ops.MetricsRegistry()
        _feed(tel, reg)
        tel.set_sink(None)
        texts.append(reg.render_prometheus())
    assert texts[1] == texts[0]
    assert 'lgbm_tpu_lock_wait_seconds{lock="telemetry",quantile="0.5"}' \
        in texts[1]
    assert 'lgbm_tpu_lock_contended_total{lock="telemetry"} 2' in texts[1]


def test_plane_serves_during_a_toy_train(monkeypatch):
    monkeypatch.setenv("LGBM_TPU_OPS_PORT", "0")
    plane = tops.mount("test")
    seen = []

    def scrape(env):
        code, body = _scrape(plane.port)
        hcode, hbody = _scrape(plane.port, "/healthz")
        seen.append((code, body, hcode, json.loads(hbody)))
    X, y, p = _data("binary")
    tlgb.train({**BASE, **p}, tlgb.Dataset(X, label=y), 5, device="cpu",
               verbose_eval=False, callbacks=[scrape])
    assert len(seen) == 5
    assert all(c == 200 and hc == 200 for c, _, hc, _ in seen)
    assert [h["state"] for *_, h in seen] == ["ready"] * 5
    assert "train" in seen[-1][3]["owners"]
    gaps = [_counter(b, "lgbm_tpu_gbdt_dispatch_gaps_total")
            for _, b, _, _ in seen[1:]]
    assert gaps == sorted(gaps) and len(set(gaps)) == 4
    _, body = _scrape(plane.port)
    assert 'lgbm_tpu_span_seconds_count{span="gbdt_iteration"} 5' in body
    assert 'lgbm_tpu_health_state{state="ready"} 1' in body
    assert tobs.summary()["gauges"]["gbdt.dispatch_gap_mean_s"] > 0
    code, body = _scrape(plane.port, "/nope")
    assert code == 404 and "/drain" in json.loads(body)["paths"]


def test_plane_serves_a_toy_server_and_drains(monkeypatch):
    X, y, p = _data("binary", n=1000)
    bst = tlgb.train({**BASE, **p}, tlgb.Dataset(X, label=y), 3,
                     device="cpu", verbose_eval=False)
    monkeypatch.setenv("LGBM_TPU_OPS_PORT", "0")
    srv = PredictionServer(compile_model(bst), max_batch=256,
                           max_wait_ms=1.0, buckets=(64, 256),
                           raw_score=True)
    plane = tops.plane()
    assert plane is not None and "serve" in plane.owners
    futs = [srv.submit(X[i:i + 3]) for i in range(40)]
    for fu in futs:
        fu.result(60)
    _, body1 = _scrape(plane.port)
    assert _counter(body1, "lgbm_tpu_serve_requests_total") == 40
    assert _counter(body1, "lgbm_tpu_serve_batches_total") >= 1
    code, hbody = _scrape(plane.port, "/healthz")
    assert code == 200 and json.loads(hbody)["state"] == "ready"
    futs += [srv.submit(X[i:i + 2]) for i in range(25)]
    code, dbody = _scrape(plane.port, "/drain")
    assert code == 200
    drain = json.loads(dbody)
    rep = drain["reports"][0]
    assert drain["drained"] and rep["drained"]
    assert rep["resolved"] == 65 and rep["failed"] == 0
    assert rep["pending"] == 0
    assert drain["health"]["state"] == "draining"
    for fu in futs:
        assert fu.done() and fu.exception() is None
    with pytest.raises(RuntimeError):
        srv.submit(X[:1])
    s = tobs.summary()
    assert s["counters"]["serve.rows_batched"] == 40 * 3 + 25 * 2
    assert s["spans"]["serve.batch"]["count"] == rep["batches"]


def test_plane_off_mounts_nothing():
    assert tops.mount("train") is None and tops.plane() is None
    assert tobs.get_sink() is None


def test_merged_summary_lifts_health():
    tobs.enable()
    ranks = [{"health": {"state": "ready"}}, {"health": {"state": "stalled"}},
             {}]
    merged = tobs.merged_summary(lambda s: [dict(s, **r) for r in ranks])
    jmerged = jobs.merged_summary(lambda s: [dict(s, **r) for r in ranks])
    assert merged["health"] == jmerged["health"] == {
        "ranks": ["ready", "stalled", None], "worst": "stalled"}
