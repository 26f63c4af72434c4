"""Telemetry of lightgbm_tpu_torch (``obs/telemetry.py``) against the JAX
package's, on the CPU.

The module-level tests run on both modules, ``lightgbm_tpu.obs.telemetry``
and ``lightgbm_tpu_torch.obs.telemetry``, mirroring ``tests/test_obs.py``:
the trace schema, span nesting, the disabled no-op, the summary and its
merge over an allgather.  Training-level tests run the same toy run in
both packages, in memory and streamed, with ``telemetry_output``: every
span, counter and gauge name on the stated lists appears in both traces
(the JAX package emits its per-phase ``tree.*`` spans on its unfused
per-phase path, ``LGBM_TPU_TIMETAG=phases``), the port's traced model equals its
untraced one, and an injected ``loader.read`` fault is retried with the
same counters and event in both.  ``LGBM_TPU_TRACE``, the ``telemetry``
callback, the retry counters and the snapshot spans are held on the
port alone.
"""
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from lightgbm_tpu import obs as jobs
from lightgbm_tpu.obs import telemetry as jtel
import lightgbm_tpu as jlgb
from lightgbm_tpu.boosting.streaming import StreamTrainer as JStream
from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.io.dataset import BinnedDataset as JDataset
from lightgbm_tpu.io.dataset import Metadata as JMetadata
from lightgbm_tpu.utils import faults as jfaults
from lightgbm_tpu.utils import retry as jretry

import lightgbm_tpu_torch as tlgb
from lightgbm_tpu_torch import obs as tobs
from lightgbm_tpu_torch.boosting.streaming import StreamTrainer
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.io.dataset import BinnedDataset, Metadata
from lightgbm_tpu_torch.learner.serial import STREAM_CHUNK
from lightgbm_tpu_torch.obs import telemetry as ttel
from lightgbm_tpu_torch.utils import faults as tfaults
from lightgbm_tpu_torch.utils import retry as tretry

torch.set_num_threads(1)   # tiny tensors: more threads only spin

MODULES = {"jax": jtel, "port": ttel}
PARAMS = {"objective": "binary", "num_leaves": 7, "verbose": -1}
ROUNDS = 5
# names of a traced in-memory run (with a valid set) in both packages
TRAIN_SPANS = ("engine.train", "gbdt.train", "gbdt.iteration", "gbdt.eval",
               "gbdt.to_host_trees", "io.find_bin", "tree.init",
               "tree.route", "tree.hist", "tree.split_find", "tree.update")
TRAIN_GAUGES = ("gbdt.iterations", "gbdt.num_trees")
# names of a traced stream of several blocks in both packages
STREAM_SPANS = ("stream.train", "stream.gradients", "stream.prefetch",
                "stream.upload", "stream.fold")
STREAM_COUNTERS = ("stream.waves", "stream.trees",
                   "stream.pipeline.overlap_s")


@pytest.fixture(autouse=True)
def _clean():
    for m in (jobs, tobs):
        m.reset()
    jfaults.clear()
    tfaults.clear()
    yield
    for m in (jobs, tobs):
        m.reset()
    jfaults.clear()
    tfaults.clear()


def _data(n=400, f=5, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.normal(size=(n, f)).astype(np.float32)
    y = (X[:, 0] + X[:, 1] > 0).astype(np.float32)
    return X, y


def _read(path):
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def _traced_train(lib, path, valid=False, **kw):
    """A toy ``lib.train`` with ``telemetry_output``: -> (booster,
    records, wall seconds)."""
    X, y = _data()
    ds = lib.Dataset(X, label=y)
    extra = {}
    if valid:
        extra = dict(valid_sets=[lib.Dataset(X[:200], label=y[:200],
                                             reference=ds)],
                     valid_names=["v"], verbose_eval=False)
    t0 = time.perf_counter()
    bst = lib.train(dict(PARAMS, telemetry_output=path), ds,
                    num_boost_round=ROUNDS, **extra, **kw)
    wall = time.perf_counter() - t0
    bst.model_to_string()          # the host trees, under the trace
    lib.obs.disable()              # flush and close the trace
    return bst, _read(path), wall


# ---------------------------------------------------------------------------
# the module, in both packages
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("which", list(MODULES))
def test_trace_schema_and_nesting(tmp_path, which):
    tel = MODULES[which]
    path = str(tmp_path / "t.jsonl")
    tel.enable(trace_path=path)
    with tel.span("outer", a=1) as attrs:
        attrs["b"] = 2
        with tel.span("inner"):
            time.sleep(0.002)
        tel.counter_add("c", 2)
        tel.gauge_set("g", 7)
        tel.event("fault", "f", transient=True)
    tel.disable()
    recs = _read(path)
    assert [r["kind"] for r in recs] == ["span", "counter", "gauge", "event",
                                         "span"]
    for r in recs:
        for key in ("ts", "kind", "name", "rank"):
            assert key in r, (key, r)
        assert isinstance(r["ts"], float) and r["ts"] > 0 and r["rank"] == 0
    inner, outer = recs[0], recs[-1]
    assert (inner["name"], inner["depth"], inner["parent"]) == ("inner", 1,
                                                                "outer")
    assert (outer["name"], outer["depth"], outer["parent"]) == ("outer", 0,
                                                                "")
    assert outer["a"] == 1 and outer["b"] == 2
    assert outer["ts"] <= inner["ts"]
    assert outer["ts"] + outer["dur_s"] >= inner["ts"] + inner["dur_s"]
    assert recs[1]["add"] == 2 and recs[1]["value"] == 2
    assert recs[3]["family"] == "fault" and recs[3]["transient"] is True
    s = tel.summary()
    assert s["spans"]["inner"]["count"] == 1
    assert s["counters"] == {"c": 2} and s["gauges"] == {"g": 7}
    assert s["events"] == {"fault:f": 1}


@pytest.mark.parametrize("which", list(MODULES))
def test_disabled_is_noop(tmp_path, which, monkeypatch):
    tel = MODULES[which]
    monkeypatch.delenv("LGBM_TPU_TRACE", raising=False)
    assert not tel.enabled()
    s1, s2 = tel.span("x"), tel.span("y", attr=1)
    assert s1 is s2 is tel._NOOP_SPAN
    with tel.span("x") as attrs:
        attrs["ignored"] = 1
        attrs.update(also=2)
    tel.counter_add("c")
    tel.gauge_set("g", 3)
    tel.event("e", "f")
    s = tel.summary()
    assert s["spans"] == {} and s["counters"] == {}
    assert s["gauges"] == {} and s["events"] == {}
    assert tel.trace_path() is None


@pytest.mark.parametrize("which", list(MODULES))
def test_merged_summary_over_allgather(which):
    tel = MODULES[which]
    tel.enable()
    with tel.span("collective.allgather"):
        pass
    tel.counter_add("retry.collective.allgather.attempts", 2)
    tel.event("fault", "x")

    def allgather(obj):               # two ranks that report alike
        return [obj, json.loads(json.dumps(obj))]
    merged = tel.merged_summary(allgather)
    assert merged["process_count"] == 2 and len(merged["ranks"]) == 2
    assert merged["spans"]["collective.allgather"]["count"] == 2
    assert merged["counters"]["retry.collective.allgather.attempts"] == 4
    assert merged["events"]["fault:x"] == 2
    assert json.loads(json.dumps(merged)) == merged


@pytest.mark.parametrize("which", list(MODULES))
def test_hold_and_release_restamp_ranks(tmp_path, which):
    tel = MODULES[which]
    path = str(tmp_path / "h.jsonl")
    tel.enable(trace_path=path)
    tel.hold_trace()
    tel.counter_add("held")
    assert not os.path.exists(path)
    tel.set_rank(0, 1)
    tel.release_trace()
    tel.disable()
    assert [r["name"] for r in _read(path)] == ["held"]


# ---------------------------------------------------------------------------
# training in both packages
# ---------------------------------------------------------------------------
def test_train_trace_names_cover_the_reference(tmp_path, monkeypatch):
    """The same traced toy run with a valid set in both packages: each
    stated span and gauge name is in both traces (the JAX package's
    unfused per-phase path emits ``tree.*``), the port's spans nest and
    account for the train call's wall clock, and its traced model is its
    untraced model."""
    monkeypatch.setenv("LGBM_TPU_HIST_BACKEND", "compact")
    monkeypatch.setenv("LGBM_TPU_SPLIT_INTERPRET", "1")
    monkeypatch.setenv("LGBM_TPU_TIMETAG", "phases")
    _, jrecs, _ = _traced_train(jlgb, str(tmp_path / "j.jsonl"), valid=True)
    jobs.reset()
    tb, trecs, wall = _traced_train(tlgb, str(tmp_path / "t.jsonl"),
                                    valid=True, device="cpu")
    for recs in (jrecs, trecs):
        spans = {r["name"] for r in recs if r["kind"] == "span"}
        gauges = {r["name"] for r in recs if r["kind"] == "gauge"}
        assert set(TRAIN_SPANS) <= spans, set(TRAIN_SPANS) - spans
        assert set(TRAIN_GAUGES) <= gauges
    spans = [r for r in trecs if r["kind"] == "span"]
    eps = 5e-3
    for i, child in enumerate(spans):
        if child["depth"] == 0:
            continue
        enclosing = [p for p in spans[i + 1:]
                     if p["depth"] == child["depth"] - 1
                     and p["ts"] <= child["ts"] + eps
                     and p["ts"] + p["dur_s"] + eps
                     >= child["ts"] + child["dur_s"]]
        assert enclosing and child["parent"] == enclosing[0]["name"], child
    top = sum(r["dur_s"] for r in spans if r["depth"] == 0)
    assert top >= 0.90 * wall, (top, wall)
    tobs.reset()
    X, y = _data()
    ds = tlgb.Dataset(X, label=y)
    plain = tlgb.train(dict(PARAMS), ds, num_boost_round=ROUNDS,
                       valid_sets=[tlgb.Dataset(X[:200], label=y[:200],
                                                reference=ds)],
                       valid_names=["v"], verbose_eval=False, device="cpu")
    assert plain.digest() == tb.digest()


def _resident(cfg_cls, ds_cls, md_cls, X, y, params):
    cfg = cfg_cls.from_params(params)
    md = md_cls()
    md.set_field("label", y)
    return cfg, ds_cls.from_raw(X, cfg, metadata=md)


def test_stream_trace_names_cover_the_reference(tmp_path, monkeypatch):
    """A traced stream of two blocks in both packages: the stream's spans
    and counters are in both traces, with the same block and wave counts,
    and the port's traced model is its untraced one."""
    monkeypatch.setenv("LGBM_TPU_HIST_BACKEND", "pallas")
    monkeypatch.setenv("LGBM_TPU_SPLIT_INTERPRET", "1")
    X, y = _data(n=12000, f=6, seed=7)
    params = dict(PARAMS, num_leaves=15, max_bin=63)
    jcfg, jds = _resident(JConfig, JDataset, JMetadata, X, y, params)
    jpath = str(tmp_path / "js.jsonl")
    jobs.enable(trace_path=jpath)
    JStream(jcfg, jds, block_rows=STREAM_CHUNK).train(2)
    jobs.disable()
    jsum = jobs.summary()["counters"]
    cfg, ds = _resident(Config, BinnedDataset, Metadata, X, y, params)
    tpath = str(tmp_path / "ts.jsonl")
    tobs.enable(trace_path=tpath)
    traced = StreamTrainer(cfg, ds, block_rows=STREAM_CHUNK,
                           device="cpu").train(2)
    tobs.disable()
    tsum = tobs.summary()["counters"]
    for recs in (_read(jpath), _read(tpath)):
        names = {r["name"] for r in recs}
        assert set(STREAM_SPANS + STREAM_COUNTERS) <= names, (
            set(STREAM_SPANS + STREAM_COUNTERS) - names)
    assert tsum["stream.trees"] == jsum["stream.trees"] == 2
    assert tsum["stream.waves"] == jsum["stream.waves"]
    tobs.reset()
    plain = StreamTrainer(cfg, ds, block_rows=STREAM_CHUNK,
                          device="cpu").train(2)
    assert plain.digest() == traced.digest()


def test_train_streaming_telemetry_output(tmp_path):
    """``telemetry_output`` enables the trace of a streamed run."""
    X, y = _data(n=12000, f=6, seed=7)
    path = str(tmp_path / "s.jsonl")
    cfg, ds = _resident(Config, BinnedDataset, Metadata, X, y,
                        dict(PARAMS, max_bin=63))
    tlgb.train_streaming(dict(PARAMS, max_bin=63, telemetry_output=path),
                         ds, num_boost_round=2, block_rows=STREAM_CHUNK,
                         device="cpu")
    tobs.disable()
    names = {r["name"] for r in _read(path)}
    assert set(STREAM_SPANS) <= names


def test_loader_read_fault_retried_alike(tmp_path, monkeypatch):
    """One injected ``loader.read`` fault, retried: both packages load the
    file and count the same ``retry.loader.read.*`` and
    ``faults.loader.read.fired`` counters and one ``fault:loader.read``
    event (the backoff seconds are jittered, so only their key is
    compared)."""
    X, y = _data()
    path = str(tmp_path / "train.csv")
    np.savetxt(path, np.column_stack([y, X]), delimiter=",", fmt="%.9g")
    monkeypatch.setattr(jretry, "_sleep", lambda s: None)
    monkeypatch.setattr(tretry, "_sleep", lambda s: None)
    out = {}
    for name, lib, obs, faults in (("jax", jlgb, jobs, jfaults),
                                   ("port", tlgb, tobs, tfaults)):
        obs.enable()
        faults.inject("loader.read", times=1)
        ds = lib.Dataset(path)
        ds.construct()
        assert faults.fired("loader.read") == 1
        out[name] = obs.summary()
        obs.reset()
    for s in out.values():
        assert s["events"].get("fault:loader.read") == 1
    keys = {k for k in out["jax"]["counters"] if "loader.read" in k}
    assert keys == {k for k in out["port"]["counters"]
                    if "loader.read" in k}
    for k in keys - {"retry.loader.read.backoff_s"}:
        assert out["jax"]["counters"][k] == out["port"]["counters"][k], k
    assert out["port"]["counters"]["retry.loader.read.recovered"] == 1


# ---------------------------------------------------------------------------
# the port's surfaces
# ---------------------------------------------------------------------------
def test_env_var_enables_trace(tmp_path):
    trace = str(tmp_path / "env.jsonl")
    code = (
        "import numpy as np, torch, lightgbm_tpu_torch as lgb\n"
        "torch.set_num_threads(1)\n"
        "rng = np.random.RandomState(0)\n"
        "X = rng.normal(size=(300, 4)).astype(np.float32)\n"
        "y = (X[:, 0] > 0).astype(np.float32)\n"
        "lgb.train({'objective': 'binary', 'num_leaves': 7, 'verbose': -1},\n"
        "          lgb.Dataset(X, label=y), num_boost_round=2,\n"
        "          device='cpu')\n")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {**os.environ, "LGBM_TPU_TRACE": trace,
           "PYTHONPATH": repo + os.pathsep + os.environ.get("PYTHONPATH", "")}
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   timeout=300)
    names = {r["name"] for r in _read(trace)}
    assert {"engine.train", "gbdt.train", "tree.hist"} <= names


def test_telemetry_callback(tmp_path):
    X, y = _data()
    ds = tlgb.Dataset(X, label=y)
    rec = {}
    trace = str(tmp_path / "cb.jsonl")
    tlgb.train(dict(PARAMS), ds, num_boost_round=3, valid_sets=[ds],
               valid_names=["training"], verbose_eval=False,
               callbacks=[tlgb.telemetry(rec, trace_path=trace)],
               device="cpu")
    tobs.disable()
    assert rec["summary"]["events"]["train:iteration"] == 3
    iters = [r for r in _read(trace)
             if r["kind"] == "event" and r["name"] == "iteration"]
    assert [r["it"] for r in iters] == [0, 1, 2]
    assert all("training:binary_logloss" in r for r in iters)
    assert tlgb.obs is tobs


def test_retry_counters(monkeypatch):
    monkeypatch.setattr(tretry, "_sleep", lambda s: None)
    tobs.enable()
    calls = [0]

    def flaky():
        calls[0] += 1
        if calls[0] < 3:
            raise RuntimeError("UNAVAILABLE: injected")
        return "ok"

    assert tretry.retry_call(flaky, what="test.site") == "ok"
    c = tobs.summary()["counters"]
    assert c["retry.test.site.attempts"] == 3
    assert c["retry.test.site.retries"] == 2
    assert c["retry.test.site.recovered"] == 1
    assert c["retry.test.site.backoff_s"] > 0
    assert "retry.test.site.exhausted" not in c
    with pytest.raises(RuntimeError):
        tretry.retry_call(lambda: (_ for _ in ()).throw(
            RuntimeError("UNAVAILABLE")), what="dead",
            policy=tretry.RetryPolicy(attempts=2, base_s=0.0))
    assert tobs.summary()["counters"]["retry.dead.exhausted"] == 1


def test_stream_upload_fault_retried(monkeypatch):
    """An injected ``stream.upload`` fault is retried before the copy and
    the model is the unfaulted one."""
    monkeypatch.setattr(tretry, "_sleep", lambda s: None)
    X, y = _data(n=12000, f=6, seed=7)
    cfg, ds = _resident(Config, BinnedDataset, Metadata, X, y,
                        dict(PARAMS, max_bin=63))
    plain = StreamTrainer(cfg, ds, block_rows=STREAM_CHUNK,
                          device="cpu").train(2)
    tobs.enable()
    tfaults.inject("stream.upload", times=1, skip=3)
    faulted = StreamTrainer(cfg, ds, block_rows=STREAM_CHUNK,
                            device="cpu").train(2)
    assert tfaults.fired("stream.upload") == 1
    assert faulted.digest() == plain.digest()
    c = tobs.summary()["counters"]
    assert c["retry.stream.upload.recovered"] == 1
    assert tobs.summary()["events"]["fault:stream.upload"] == 1


def test_snapshot_spans_and_counters(tmp_path):
    X, y = _data()
    tobs.enable()
    tlgb.train(dict(PARAMS, output_model=str(tmp_path / "m.txt"),
                    snapshot_freq=2), tlgb.Dataset(X, label=y),
               num_boost_round=4, device="cpu")
    s = tobs.summary()
    assert s["spans"]["snapshot.write"]["count"] == 2
    assert s["spans"]["snapshot.prune"]["count"] == 2
    assert s["counters"]["snapshot.writes"] == 2
    assert s["counters"]["snapshot.bytes_written"] > 0
    tlgb.train(dict(PARAMS, output_model=str(tmp_path / "m.txt")),
               tlgb.Dataset(X, label=y), num_boost_round=4,
               resume_from="auto", device="cpu")
    s = tobs.summary()
    assert s["spans"]["snapshot.resume"]["count"] == 1
    assert s["spans"]["snapshot.validate"]["count"] >= 1


def test_early_stop_event():
    X, y = _data(n=600)
    tobs.enable()
    ds = tlgb.Dataset(X[:400], label=y[:400])
    noise = np.random.RandomState(5).permutation(y[400:])
    bst = tlgb.train(dict(PARAMS, metric="binary_logloss"), ds,
                     num_boost_round=60,
                     valid_sets=[tlgb.Dataset(X[400:], label=noise,
                                              reference=ds)],
                     valid_names=["v"], early_stopping_rounds=2,
                     verbose_eval=False, device="cpu")
    assert bst.current_iteration() < 60
    assert tobs.summary()["events"] == {"early_stop:v:binary_logloss": 1}
    assert tobs.summary()["gauges"]["gbdt.iterations"] == \
        bst.current_iteration()



def test_trace_flushed_when_train_returns(tmp_path):
    """The port buffers its trace and writes it out when a top-level span
    closes: a run's records are on disk when ``train`` returns, telemetry
    still on."""
    X, y = _data()
    path = str(tmp_path / "f.jsonl")
    tlgb.train(dict(PARAMS, telemetry_output=path), tlgb.Dataset(X, label=y),
               num_boost_round=2, device="cpu")
    assert tobs.enabled()
    names = [r["name"] for r in _read(path)]
    assert names[-1] == "engine.train" and "gbdt.train" in names
