"""Streams over several protocol shards and elastic training of
lightgbm_tpu_torch against the JAX package, at toy size on the CPU.

* **The S-shard stream.**  ``train_streaming`` with
  ``tree_learner="data"`` and ``mesh_shape=[2]`` (and S = 3 through
  ``num_shards``) gives the JAX package's ``StreamTrainer(num_shards=S)``
  model text and ``digest()``: on int8h bit for bit (each shard's int32
  carry, its own scales, the shards' unpacked partials and root
  statistics added in shard order), and on the hhilo float mode bit for
  bit too (the JAX package's own stream and in-memory runs agree there).
  The JAX side streams on its seeded kernel folds in Pallas interpret
  mode, as ``tests/test_torch_streaming.py`` does.
* **World 1 against the oracle.**  A one-member ``train_elastic`` at
  S = 2 equals the port's ``StreamTrainer(num_shards=2)`` and the JAX
  package's ``train_elastic`` (model text and digest); a torn newest
  barrier restores the previous one and reproduces the bytes; S = 3
  adopts no S = 2 barrier; a changed config refuses (the JAX package's
  ``tests/test_elastic.py:485-521``).
* **Churn in threads.**  A joiner and a leaver arrive mid-train, the
  trainer recovers from the last barrier and ends on the oracle's bytes,
  with ``elastic.recoveries`` counted and ``/healthz`` back at ready.
* **Chaos.**  ``tools/chaos_torch.py --device cpu --workers 2
  --kill-iter 3``, with and without ``--respawn``, each in a subprocess
  with a deadline of its own: every survivor's model sha256 and digest
  equal the oracle's, and the recovery's phases sum to its ``mttr_s``.
* **Streamed snapshots.**  A plain stream with ``snapshot_freq`` writes
  the same barriers; ``train_streaming(resume_from=)`` continues from the
  newest one bit for bit.
"""
import contextlib
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from lightgbm_tpu.boosting.streaming import StreamTrainer as JStream
from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.io.dataset import BinnedDataset as JDataset
from lightgbm_tpu.io.dataset import Metadata as JMetadata

import lightgbm_tpu_torch as tlgb
from lightgbm_tpu_torch import obs
from lightgbm_tpu_torch.boosting import snapshot as snap
from lightgbm_tpu_torch.boosting.streaming import (StreamTrainer,
                                                   elastic_shards,
                                                   train_elastic)
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.io.dataset import BinnedDataset, Metadata
from lightgbm_tpu_torch.learner.serial import STREAM_CHUNK
from lightgbm_tpu_torch.obs import health
from lightgbm_tpu_torch.parallel.elastic import (ElasticClient,
                                                 ElasticCoordinator)
from lightgbm_tpu_torch.utils import faults

torch.set_num_threads(1)   # tiny tensors: more threads only spin

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHAOS_TIMEOUT_S = 240      # a chaos scenario's own deadline
THREAD_TIMEOUT_S = 120     # a training thread's

N, F = 30000, 6
ITERS = 3
BASE = {"objective": "binary", "num_leaves": 15, "max_bin": 63,
        "learning_rate": 0.1, "verbose": -1, "tree_learner": "data"}


@pytest.fixture(autouse=True)
def _clean():
    obs.reset()
    obs.enable()
    faults.clear()
    yield
    faults.clear()
    health._set_active(False)
    health.reset()
    obs.disable()
    obs.reset()


def _data(seed=7, n=N):
    rng = np.random.RandomState(seed)
    X = rng.normal(size=(n, F))
    y = (X[:, 0] + 0.5 * X[:, 1] + rng.normal(scale=0.3, size=n) > 0
         ).astype(np.float32)
    return X, y


def _resident(X, y, params):
    cfg = Config.from_params(params)
    md = Metadata()
    md.set_field("label", y)
    return BinnedDataset.from_raw(X, cfg, metadata=md)


def _jax_stream(monkeypatch, params, X, y, S, iters=ITERS):
    monkeypatch.setenv("LGBM_TPU_HIST_BACKEND", "pallas")
    monkeypatch.setenv("LGBM_TPU_SPLIT_INTERPRET", "1")
    cfg = JConfig.from_params(params)
    md = JMetadata()
    md.set_field("label", y)
    tr = JStream(cfg, JDataset.from_raw(X, cfg, metadata=md),
                 block_rows=STREAM_CHUNK, num_shards=S)
    return tr.train(iters)


SHARD_CASES = {
    # mesh_shape=[2] names S (the port's default shard count)
    "s2_binary_int8h": (dict(BASE, mesh_shape="2"), 0, "int8h"),
    "s3_l2_int8h": (dict(BASE, objective="regression"), 3, "int8h"),
    "s2_binary_hhilo": (dict(BASE, mesh_shape="2", hist_mode="hhilo"), 0,
                        "hhilo"),
}


@pytest.mark.parametrize("case", list(SHARD_CASES))
def test_sharded_stream_matches_reference(monkeypatch, case):
    params, num_shards, mode = SHARD_CASES[case]
    X, y = _data()
    if params["objective"] == "regression":
        y = (X[:, 0] + 0.5 * X[:, 1]).astype(np.float32)
    S = num_shards or 2
    ds = _resident(X, y, params)
    tr = StreamTrainer(Config.from_params(params), ds,
                       block_rows=STREAM_CHUNK, device="cpu",
                       num_shards=num_shards)
    assert tr.S == S and tr.fold.hist_mode == mode
    # blocks never straddle a shard, and each shard has several
    for (start, stop, _), sh in zip(tr.blocks, tr.block_shard):
        lo, hi = tr.ranges[sh]
        assert lo <= start < stop <= hi
    assert len(tr.blocks) > S
    st = tlgb.train_streaming(params, ds, num_boost_round=ITERS,
                              block_rows=STREAM_CHUNK, device="cpu",
                              num_shards=num_shards)
    ref = _jax_stream(monkeypatch, params, X, y, S)
    assert st.save_model_to_string() == ref.save_model_to_string()
    assert st.digest() == ref.digest()
    # another shard count is another model
    one = tlgb.train_streaming(dict(params, tree_learner="serial"), ds,
                               num_boost_round=ITERS,
                               block_rows=STREAM_CHUNK, device="cpu")
    assert one.digest() != st.digest()


def test_stream_shard_count_resolution():
    X, y = _data(n=STREAM_CHUNK)
    ds = _resident(X, y, BASE)

    def shards(**kw):
        params = dict(BASE, **kw.pop("params", {}))
        return StreamTrainer(Config.from_params(params), ds, device="cpu",
                             **kw).S
    assert shards() == 1                       # data, no mesh_shape
    assert shards(params={"mesh_shape": "4"}) == 4
    assert shards(params={"mesh_shape": "4"}, num_shards=3) == 3
    assert shards(params={"tree_learner": "serial", "mesh_shape": "4"}) == 1


def test_elastic_shards_resolution(monkeypatch):
    assert elastic_shards(4) == 4
    assert elastic_shards(4, explicit=6) == 6
    monkeypatch.setenv("LGBM_TPU_ELASTIC_SHARDS", "3")
    assert elastic_shards(4) == 3
    assert elastic_shards(0) == 3
    monkeypatch.delenv("LGBM_TPU_ELASTIC_SHARDS")
    assert elastic_shards(0) == 1


# ---------------------------------------------------------------------------
# elastic training in one process
# ---------------------------------------------------------------------------
def _toy_data(n=240, f=5, seed=9):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, f))
    y = (X[:, 0] + 0.5 * X[:, 1] ** 2 + np.sin(X[:, 2])
         + rng.normal(scale=0.1, size=n)).astype(np.float32)
    return X, y


def _toy_params(prefix, iters=4, **kw):
    p = {"objective": "regression", "num_leaves": 7, "min_data_in_leaf": 5,
         "learning_rate": 0.2, "num_iterations": iters, "seed": 3,
         "snapshot_freq": 1, "snapshot_keep": 8, "verbose": -1,
         "output_model": str(prefix)}
    p.update(kw)
    return p


@contextlib.contextmanager
def _coord(cls=ElasticCoordinator):
    coord = cls(heartbeat_timeout_s=5.0)
    coord.start()
    try:
        yield coord
    finally:
        coord.stop()


def _client(coord, member, deadline_s=10.0, cls=ElasticClient):
    return cls(coord.address, member=member, deadline_s=deadline_s,
               heartbeat_interval_s=0.05)


def _jax_elastic(monkeypatch, params, X, y, S):
    from lightgbm_tpu.boosting.streaming import train_elastic as jtrain
    from lightgbm_tpu.parallel.elastic import (ElasticClient as JClient,
                                               ElasticCoordinator as JCoord)
    monkeypatch.setenv("LGBM_TPU_HIST_BACKEND", "pallas")
    monkeypatch.setenv("LGBM_TPU_SPLIT_INTERPRET", "1")
    md = JMetadata()
    md.set_field("label", y)
    ds = JDataset.from_raw(X, JConfig.from_params(dict(params)), metadata=md)
    with _coord(JCoord) as coord:
        c = _client(coord, "solo", cls=JClient)
        try:
            return jtrain(params, ds, num_shards=S, client=c)
        finally:
            c.leave()
            c.close()


def test_elastic_world1_matches_oracles_and_restores(monkeypatch, tmp_path):
    """A one-member run at S = 2 lands on the port's single-process
    trainer's bytes and on the JAX package's ``train_elastic``; a torn
    newest barrier falls back to the previous one and the continued run
    reproduces the bytes; another shard count or another config never
    adopts these barriers."""
    prefix = tmp_path / "m.txt"
    params = _toy_params(prefix, iters=4, snapshot_freq=2)
    X, y = _toy_data()
    ds = _resident(X, y, params)
    with _coord() as coord:
        c = _client(coord, "solo")
        try:
            booster = train_elastic(params, ds, num_shards=2, client=c,
                                    device="cpu")
        finally:
            c.leave()
            c.close()
    oracle_cfg = Config.from_params(dict(params, snapshot_freq=-1))
    oracle = StreamTrainer(oracle_cfg, ds, num_shards=2,
                           device="cpu").train()
    text = oracle.save_model_to_string(-1)
    assert booster.save_model_to_string(-1) == text
    assert booster.digest() == oracle.digest()
    ref = _jax_elastic(monkeypatch, dict(params, output_model=str(
        tmp_path / "jax.txt")), X, y, 2)
    assert ref.save_model_to_string(-1) == text
    assert ref.digest() == oracle.digest()
    assert [it for it, _ in snap.list_barriers(str(prefix))] == [4, 2]
    # the mid-commit SIGKILL shape: no manifest at 4
    os.unlink(snap.barrier_paths(str(prefix), 4)[1])
    resumed = StreamTrainer(oracle_cfg, ds, num_shards=2, device="cpu")
    assert resumed.restore_barrier(str(prefix)) == 2
    final = resumed.train()
    assert final.save_model_to_string(-1) == text
    assert final.digest() == oracle.digest()
    other = StreamTrainer(oracle_cfg, ds, num_shards=3, device="cpu")
    assert other.restore_barrier(str(prefix)) == 0
    changed = Config.from_params(dict(params, learning_rate=0.05))
    with pytest.raises(ValueError, match="config changed"):
        StreamTrainer(changed, ds, num_shards=2,
                      device="cpu").restore_barrier(str(prefix))


def test_membership_churn_recovery_byte_identical(tmp_path):
    """A member joining and leaving mid-train bumps the generation: the
    trainer's collectives fail, it re-rendezvous, restores the last
    barrier and still ends on the oracle's bytes, with ``/healthz`` back
    at ready and ``elastic:recover`` on the record."""
    prefix = tmp_path / "m.txt"
    params = _toy_params(prefix, iters=8, snapshot_freq=1)
    X, y = _toy_data(n=300)
    ds = _resident(X, y, params)
    health._set_active(True)
    box = {}
    with _coord() as coord:
        trainer = _client(coord, "trainer", deadline_s=1.5)

        def run():
            try:
                box["value"] = train_elastic(params, ds, num_shards=2,
                                             client=trainer, device="cpu")
            except BaseException as exc:  # noqa: BLE001 - asserted below
                box["error"] = exc
        t = threading.Thread(target=run, daemon=True)
        t.start()
        try:
            deadline = time.monotonic() + 60.0
            while time.monotonic() < deadline:
                members = coord.membership()["members"]
                if any(m["detail"].get("iteration", 0) >= 1
                       for m in members):
                    break
                time.sleep(0.02)
            intruder = _client(coord, "intruder")
            intruder.join_world()
            intruder.leave()
            intruder.close()
            t.join(THREAD_TIMEOUT_S)
            assert not t.is_alive(), "the elastic run did not finish"
        finally:
            trainer.leave()
            trainer.close()
    assert "error" not in box, box.get("error")
    oracle = StreamTrainer(Config.from_params(dict(params, snapshot_freq=-1)),
                           ds, num_shards=2, device="cpu").train()
    assert box["value"].save_model_to_string(-1) == \
        oracle.save_model_to_string(-1)
    assert box["value"].digest() == oracle.digest()
    s = obs.summary()
    assert s["events"].get("elastic:recover", 0) >= 1
    assert s["counters"].get("elastic.recoveries", 0) >= 1
    assert s["spans"].get("elastic.recover", {}).get("count", 0) >= 1
    assert health.state()["state"] == "ready"


def test_two_members_in_threads_exchange_and_match(tmp_path):
    """Two members of one world (threads) fold one shard each, exchange
    the root statistics and each wave's histograms, and both end on the
    single-process oracle's bytes."""
    prefix = tmp_path / "m.txt"
    params = _toy_params(prefix, iters=4, snapshot_freq=2)
    X, y = _toy_data(n=400)
    ds = _resident(X, y, params)
    boxes = [{}, {}]
    with _coord() as coord:
        clients = [_client(coord, f"m{i}") for i in range(2)]

        def run(i):
            try:
                boxes[i]["value"] = train_elastic(
                    params, ds, num_shards=2, client=clients[i],
                    min_world=2, device="cpu")
            except BaseException as exc:  # noqa: BLE001 - asserted below
                boxes[i]["error"] = exc
        threads = [threading.Thread(target=run, args=(i,), daemon=True)
                   for i in range(2)]
        for t in threads:
            t.start()
        try:
            for t in threads:
                t.join(THREAD_TIMEOUT_S)
                assert not t.is_alive(), "an elastic member did not finish"
        finally:
            for c in clients:
                c.leave()
                c.close()
    oracle = StreamTrainer(Config.from_params(dict(params, snapshot_freq=-1)),
                           ds, num_shards=2, device="cpu").train()
    for box in boxes:
        assert "error" not in box, box.get("error")
        assert box["value"].save_model_to_string(-1) == \
            oracle.save_model_to_string(-1)
        assert box["value"].digest() == oracle.digest()
    c = obs.summary()["counters"]
    assert c.get("elastic.bytes_exchanged", 0) > 0
    man = snap.latest_valid_barrier(str(prefix), num_shards=2)
    assert man["world_size"] == 2 and man["iteration"] == 4


# ---------------------------------------------------------------------------
# streamed snapshots without a coordinator
# ---------------------------------------------------------------------------
def test_stream_snapshots_and_resume_from(tmp_path):
    """``snapshot_freq`` in a plain stream commits barriers (a world of
    one); ``resume_from`` restores the newest and ends on the
    uninterrupted bytes."""
    prefix = str(tmp_path / "s.txt")
    X, y = _data(n=3 * STREAM_CHUNK)
    params = dict(BASE, mesh_shape="2", output_model=prefix,
                  snapshot_freq=2, snapshot_keep=3)
    ds = _resident(X, y, params)
    full = tlgb.train_streaming(params, ds, num_boost_round=6,
                                block_rows=STREAM_CHUNK, device="cpu")
    assert [it for it, _ in snap.list_barriers(prefix)] == [6, 4, 2]
    man = snap.latest_valid_barrier(prefix)
    assert man["world_size"] == 1 and man["num_shards"] == 2
    os.unlink(snap.barrier_paths(prefix, 6)[1])
    res = tlgb.train_streaming(dict(params, resume_from="auto"), ds,
                               num_boost_round=6, block_rows=STREAM_CHUNK,
                               device="cpu")
    assert res.save_model_to_string() == full.save_model_to_string()
    assert res.digest() == full.digest()
    assert obs.summary()["counters"].get("snapshot.barrier_resumes") == 1


# ---------------------------------------------------------------------------
# the chaos gate: real SIGKILLs, real processes
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("respawn", [False, True], ids=["shrink", "regrow"])
def test_chaos_sigkill_byte_identical(tmp_path, respawn):
    """``tools/chaos_torch.py``: SIGKILL worker-1 when it reports
    iteration 3; the survivor shrinks to world 1 (and, with
    ``--respawn``, regrows with a joiner); every survivor's model sha256
    and digest equal the oracle's, and its recovery's phases sum to its
    ``mttr_s``."""
    rundir = str(tmp_path / "chaos")
    cmd = [sys.executable, "-m", "tools.chaos_torch", "--device", "cpu",
           "--workers", "2", "--kill-iter", "3", "--iters", "8",
           "--rows", "400", "--rundir", rundir, "--json",
           "--timeout", str(CHAOS_TIMEOUT_S - 30)]
    if respawn:
        cmd.append("--respawn")
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("LGBM_TPU_")}
    proc = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=CHAOS_TIMEOUT_S)
    out = proc.stdout[proc.stdout.index("{"):]
    verdict = json.loads(out)
    assert proc.returncode == 0 and verdict["ok"], \
        (verdict["errors"], proc.stderr[-2000:])
    assert verdict["killed"]["member"] == "worker-1"
    members = {r["member"] for r in verdict["results"]}
    assert members == ({"worker-0", "joiner-0"} if respawn
                       else {"worker-0"}), verdict
    for key in ("model_sha256", "digest"):
        assert {r[key] for r in verdict["results"]} == \
            {verdict["oracle"][key]}
    rec = verdict["recovery"]
    assert set(rec["phases"]) == {"detect", "resync", "reshard",
                                  "restore", "retrain"}
    assert abs(sum(rec["phases"].values()) - rec["mttr_s"]) < 1e-9
    assert rec["error"] in ("GenerationChanged", "RankLostError")
    assert rec["phases"]["detect"] > 0
    # the survivor trained through the stream's kernels' plain versions
    # (a joiner may arrive after the last iteration and only restore)
    calls = next(r for r in verdict["results"]
                 if r["member"] == "worker-0")["plain_calls"]
    assert calls["hist_active"] > 0 and calls["route"] > 0 \
        and calls["route_values"] > 0
    assert calls["hist_route"] == 0
    for r in verdict["results"]:
        assert r["health_walk"][-1] == "ready", verdict
