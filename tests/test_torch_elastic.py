"""The elastic protocol of lightgbm_tpu_torch (``parallel/elastic.py``),
its fleet accounting (``obs/fleet.py``) and its barrier snapshots
(``boosting/snapshot.py``), held to the JAX package's own cases
(``tests/test_elastic.py``) on the port's modules:

* round trips of the array encoding; rendezvous generations and the
  rank order (sorted member ids); rank-ordered allgathers and barriers;
  a generation change failing an in-flight collective; the resync after
  churn a heartbeat saw first; transport failures raising
  ``RankLostError``; abandoned rounds aging out; the hung-collective
  deadline; wedged against dead; the ``rendezvous.drop_rank`` fault; the
  torn-barrier fallback;
* the wire: a JAX client and a port client join one port coordinator and
  gather each other's arrays bit for bit, and a port client works
  against a JAX coordinator;
* the fleet: a recovery episode's phases sum to its ``mttr_s``, and the
  JAX package's ``read_ledger`` reads a port ``FleetLedger`` file to the
  same records.

Every wait has a bound: thread joins and polling loops time out, so a
hung protocol fails its test instead of the run.
"""
import contextlib
import os
import threading
import time

import numpy as np
import pytest
import torch

from lightgbm_tpu_torch import obs
from lightgbm_tpu_torch.boosting import snapshot as snap
from lightgbm_tpu_torch.io.distributed import RankLostError, deadline_call
from lightgbm_tpu_torch.obs import fleet, health
from lightgbm_tpu_torch.parallel.elastic import (ElasticClient,
                                                 ElasticCoordinator,
                                                 EvictedError,
                                                 GenerationChanged,
                                                 decode_array, encode_array)
from lightgbm_tpu_torch.utils import faults

torch.set_num_threads(1)   # tiny tensors: more threads only spin

JOIN_S = 10.0              # the longest a thread of a test may take


@pytest.fixture(autouse=True)
def _clean():
    obs.reset()
    obs.enable()        # the cases read elastic:* events and counters
    faults.clear()
    yield
    faults.clear()
    health._set_active(False)
    health.reset()
    obs.disable()
    obs.reset()


@contextlib.contextmanager
def _coord(heartbeat_timeout_s=5.0):
    coord = ElasticCoordinator(heartbeat_timeout_s=heartbeat_timeout_s)
    coord.start()
    try:
        yield coord
    finally:
        coord.stop()


def _client(coord, member, deadline_s=5.0, hb=0.05, cls=ElasticClient):
    return cls(coord.address, member=member, deadline_s=deadline_s,
               heartbeat_interval_s=hb)


def _in_thread(fn, *args):
    box = {}

    def run():
        try:
            box["value"] = fn(*args)
        except BaseException as exc:  # noqa: BLE001 - re-raised by caller
            box["error"] = exc

    t = threading.Thread(target=run, daemon=True)
    t.start()
    return t, box


def _joined(*threads):
    for t in threads:
        t.join(JOIN_S)
        assert not t.is_alive(), "a protocol call outlived its bound"


def _pair(coord, **kw):
    a = _client(coord, "a", **kw)
    b = _client(coord, "b", **kw)
    ta, _ = _in_thread(a.join_world, 2)
    tb, _ = _in_thread(b.join_world, 2)
    _joined(ta, tb)
    return a, b


def test_encode_decode_array_bitwise_roundtrip():
    for arr in (np.arange(12, dtype=np.float32).reshape(3, 4) / 7,
                np.array([np.nan, -0.0, np.inf], np.float64),
                np.arange(5, dtype=np.int64)):
        back = decode_array(encode_array(arr))
        assert back.dtype == arr.dtype and back.shape == arr.shape
        assert np.array_equal(arr.view(np.uint8), back.view(np.uint8))


def test_rendezvous_generations_and_rank_order():
    """Every (re)join returns (world, rank, generation); joins bump the
    generation; ranks are 0..W-1 in sorted member-id order."""
    with _coord() as coord:
        a = _client(coord, "a")
        b = _client(coord, "b")
        try:
            w, r, g = a.join_world()
            assert (w, r) == (1, 0) and g >= 1
            w2, r2, g2 = b.join_world()
            assert (w2, r2) == (2, 1) and g2 == g + 1
            assert a.resync() == (2, 0, g2)
            info = coord.membership()
            assert info["world"] == 2 and info["generation"] == g2
            assert [m["member"] for m in info["members"]] == ["a", "b"]
            assert [m["rank"] for m in info["members"]] == [0, 1]
        finally:
            a.close()
            b.close()
    assert obs.summary()["events"].get("elastic:joined", 0) >= 2


def test_allgather_rank_ordered_and_barrier():
    with _coord() as coord:
        a, b = _pair(coord)
        try:
            ta, boxa = _in_thread(a.allgather, {"from": "a"})
            tb, boxb = _in_thread(b.allgather, {"from": "b"})
            _joined(ta, tb)
            want = [{"from": "a"}, {"from": "b"}]
            assert boxa["value"] == want and boxb["value"] == want
            ta, _ = _in_thread(a.barrier, "sync-point")
            tb, boxb = _in_thread(b.barrier, "sync-point")
            _joined(ta, tb)
            assert "error" not in boxb
        finally:
            a.close()
            b.close()


def test_generation_change_fails_inflight_collective():
    """A membership change fails an in-flight collective of the old
    generation; the survivor re-rendezvous alone."""
    with _coord() as coord:
        a, b = _pair(coord)
        try:
            gen2 = a.generation
            t, box = _in_thread(a.allgather, "x")   # waits for b
            time.sleep(0.2)
            b.leave()
            _joined(t)
            assert isinstance(box.get("error"), GenerationChanged)
            assert box["error"].generation > gen2
            w, r, g = a.resync()
            assert (w, r) == (1, 0) and g > gen2
        finally:
            a.close()
            b.close()


def test_resync_realigns_seq_after_heartbeat_observed_churn():
    """A survivor whose heartbeat saw the new generation first still
    resets its collective sequence on resync, so the ranks' ``(generation,
    seq)`` keys agree after the recovery."""
    with _coord() as coord:
        a, b = _pair(coord)
        try:
            gen = a.generation
            b.pause_heartbeats(True)
            ta, _ = _in_thread(a.allgather, 1)
            tb, _ = _in_thread(b.allgather, 2)
            _joined(ta, tb)
            assert a.seq == b.seq == 1
            intruder = _client(coord, "intruder")
            intruder.join_world()
            intruder.leave()
            intruder.close()
            deadline = time.monotonic() + 5.0
            while a.observed_generation <= gen \
                    and time.monotonic() < deadline:
                time.sleep(0.02)
            assert a.observed_generation > gen
            assert a.generation == gen
            a.resync()
            b.resync()
            b.pause_heartbeats(False)
            assert a.generation == b.generation > gen
            assert a.seq == 0 and b.seq == 0
            ta, boxa = _in_thread(a.allgather, "a")
            tb, boxb = _in_thread(b.allgather, "b")
            _joined(ta, tb)
            assert boxa["value"] == boxb["value"] == ["a", "b"]
        finally:
            a.close()
            b.close()


def test_transport_failures_raise_ranklost():
    """A coordinator that went away surfaces as the typed RankLostError
    the recovery loop catches, never as a raw OSError."""
    coord = ElasticCoordinator()
    coord.start()
    c = ElasticClient(coord.address, member="m", deadline_s=2.0)
    c.join_world()
    coord.stop()
    try:
        with pytest.raises(RankLostError):
            c.allgather("x")
    finally:
        c.close()
    s = obs.summary()
    assert s["counters"].get("elastic.transport_errors", 0) \
        + s["counters"].get("collective.deadline_exceeded", 0) >= 1


def test_coordinator_ages_out_abandoned_rounds():
    """A round a member abandoned at its deadline does not stay in the
    coordinator's memory."""
    with _coord(heartbeat_timeout_s=0.4) as coord:
        a, b = _pair(coord, deadline_s=0.3)
        try:
            with pytest.raises(RankLostError):
                a.allgather("only-me")
            with coord._cv:
                assert len(coord._rounds) == 1
            deadline = time.monotonic() + 10.0
            while time.monotonic() < deadline:
                with coord._cv:
                    if not coord._rounds and not coord._touch:
                        break
                time.sleep(0.05)
            with coord._cv:
                assert not coord._rounds and not coord._reads \
                    and not coord._touch
        finally:
            a.close()
            b.close()
    assert obs.summary()["counters"].get("elastic.rounds_aged_out", 0) >= 1


def test_hung_collective_raises_ranklost_within_deadline():
    """With one rank's collective hung (``collective.hang``), the healthy
    peer's allgather raises RankLostError within its deadline."""
    deadline = 0.6
    with _coord() as coord:
        a, b = _pair(coord, deadline_s=deadline)
        try:
            faults.inject("collective.hang", times=1)
            th, _ = _in_thread(a.allgather, "hung")  # takes the fault
            time.sleep(0.05)
            assert faults.fired("collective.hang") == 1
            t0 = time.monotonic()
            with pytest.raises(RankLostError) as err:
                b.allgather("healthy")
            elapsed = time.monotonic() - t0
            assert elapsed < deadline + 1.0, \
                f"detection took {elapsed:.2f}s for a {deadline}s deadline"
            assert err.value.deadline_s == deadline
            th.join(5)
        finally:
            a.close()
            b.close()
    s = obs.summary()
    assert s["events"].get("elastic:rank_lost", 0) >= 1
    assert s["counters"].get("collective.deadline_exceeded", 0) >= 1


def test_deadline_call_detects_hang():
    """``io/distributed.deadline_call``: values and errors pass through,
    and the injected hang raises within the deadline."""
    assert deadline_call(lambda: 41 + 1, "t", deadline=0.5) == 42
    assert deadline_call(lambda: "inline", "t", deadline=None) == "inline"
    with pytest.raises(ZeroDivisionError):
        deadline_call(lambda: 1 // 0, "t", deadline=0.5)
    faults.inject("collective.hang", times=1)
    t0 = time.monotonic()
    with pytest.raises(RankLostError):
        deadline_call(lambda: "late", "t", deadline=0.2)
    assert time.monotonic() - t0 < 1.0
    assert faults.fired("collective.hang") == 1


def test_heartbeat_wedged_vs_dead():
    """Wedged but alive (``stalled``, still beating) is not evicted;
    dead (``heartbeat.miss``: the beats stop) is, and the evictee's next
    collective says so."""
    with _coord(heartbeat_timeout_s=0.4) as coord:
        a = _client(coord, "wedged", hb=0.05)
        try:
            _, _, gen = a.join_world()
            health._set_active(True)
            health.mark_stalled("train_window")
            time.sleep(1.0)   # 2.5x the eviction timeout, still beating
            info = coord.membership()
            assert info["world"] == 1 and info["generation"] == gen
            assert info["members"][0]["state"] == "stalled"
            faults.inject("heartbeat.miss", times=1000)
            deadline = time.monotonic() + 5.0
            while coord.membership()["world"] \
                    and time.monotonic() < deadline:
                time.sleep(0.05)
            info = coord.membership()
            assert info["world"] == 0 and info["generation"] > gen
            assert faults.fired("heartbeat.miss") >= 1
            with pytest.raises(EvictedError):
                a.allgather("x")
        finally:
            a.close()
    s = obs.summary()
    assert s["events"].get("elastic:rank_lost", 0) >= 1
    assert s["counters"].get("elastic.evictions", 0) >= 1


def test_drop_rank_fault_evicts_newest_member():
    """``rendezvous.drop_rank``: the monitor evicts the newest member and
    the survivor re-ranks in a new generation."""
    with _coord(heartbeat_timeout_s=0.8) as coord:
        a = _client(coord, "old")
        b = _client(coord, "new")
        try:
            a.join_world()
            _, _, gen = b.join_world()
            faults.inject("rendezvous.drop_rank", times=1)
            deadline = time.monotonic() + 5.0
            while coord.membership()["world"] != 1 \
                    and time.monotonic() < deadline:
                time.sleep(0.05)
            info = coord.membership()
            assert [m["member"] for m in info["members"]] == ["old"]
            assert faults.fired("rendezvous.drop_rank") == 1
            assert a.resync() == (1, 0, info["generation"])
            assert info["generation"] > gen
            with pytest.raises(EvictedError):
                b.allgather("x")
        finally:
            a.close()
            b.close()


def test_collective_slow_fault_names_the_straggler():
    """``collective.slow`` delays one rank below the deadline; the
    fleet's wait accounting names it as the straggler of that site."""
    with _coord() as coord:
        a, b = _pair(coord)
        try:
            faults.inject("collective.slow", times=1)
            ta, _ = _in_thread(a.allgather, 1, "site.x")   # slowed
            time.sleep(0.05)
            tb, _ = _in_thread(b.allgather, 2, "site.x")
            _joined(ta, tb)
            assert faults.fired("collective.slow") == 1
        finally:
            a.close()
            b.close()
    sk = fleet.skew_snapshot()["site.x"]
    assert sk["waves"] == 2 and sk["straggler_waves"] == 1
    assert sk["wait_max_s"] > 0.1


# ---------------------------------------------------------------------------
# barrier snapshots: the commit marker and the torn-barrier fallback
# ---------------------------------------------------------------------------
def test_barrier_commit_marker_and_torn_fallback(tmp_path):
    """Shards without a manifest and torn model text are skipped; the
    restore lands on the previous committed barrier, and a barrier of
    another shard count is never adopted."""
    prefix = str(tmp_path / "m.txt")
    meta = {"num_shards": 2, "world_size": 2, "generation": 1}
    for it in (2, 4):
        shas = {s: snap.write_barrier_shard(
            prefix, it, s, np.full((3, 1), it + s, np.float32))
            for s in range(2)}
        snap.commit_barrier(prefix, it, f"model-at-{it}\n", shas, meta,
                            keep=8)
    assert [it for it, _ in snap.list_barriers(prefix)] == [4, 2]
    snap.write_barrier_shard(prefix, 6, 0, np.zeros((3, 1), np.float32))
    snap.write_barrier_shard(prefix, 6, 1, np.zeros((3, 1), np.float32))
    man = snap.latest_valid_barrier(prefix)
    assert man is not None and man["iteration"] == 4
    assert sorted(man["shard_paths"]) == [0, 1]
    assert snap.latest_valid_barrier(prefix, num_shards=3) is None
    assert snap.barrier_candidates(prefix, num_shards=2) == {
        4: man["model_sha256"],
        2: snap.validate_barrier(snap.barrier_paths(prefix, 2)[1])[
            "model_sha256"]}
    with open(snap.barrier_paths(prefix, 4)[0], "a") as f:
        f.write("x")
    man = snap.latest_valid_barrier(prefix, num_shards=2)
    assert man is not None and man["iteration"] == 2
    with open(snap.barrier_shard_path(prefix, 2, 1), "ab") as f:
        f.write(b"x")
    assert snap.latest_valid_barrier(prefix) is None


def test_prune_barriers_keeps_the_newest(tmp_path):
    """``snapshot_keep`` committed barriers survive a commit, with their
    shard files; the dropped ones leave nothing behind."""
    prefix = str(tmp_path / "m.txt")
    for it in (1, 2, 3):
        shas = {0: snap.write_barrier_shard(prefix, it, 0,
                                            np.zeros((2, 1), np.float32))}
        snap.commit_barrier(prefix, it, f"m{it}\n", shas,
                            {"num_shards": 1}, keep=2)
    assert [it for it, _ in snap.list_barriers(prefix)] == [3, 2]
    assert sorted(os.listdir(tmp_path)) == sorted(
        f"m.txt.barrier_iter_{it}{suffix}" for it in (2, 3)
        for suffix in ("", ".manifest.json", ".shard0.npz"))


# ---------------------------------------------------------------------------
# the wire: the JAX package's client and the port's share a coordinator
# ---------------------------------------------------------------------------
def _mixed_gather(coord_cls, jclient_cls):
    """A JAX client and a port client on one coordinator: -> (the JAX
    client's gather, the port client's) of each other's arrays."""
    from lightgbm_tpu.parallel.elastic import decode_array as jdecode
    from lightgbm_tpu.parallel.elastic import encode_array as jencode
    rng = np.random.RandomState(5)
    ja = rng.normal(size=(4, 3, 2)).astype(np.float32)
    pa = np.arange(7, dtype=np.int32) - 3
    coord = coord_cls(heartbeat_timeout_s=5.0)
    coord.start()
    try:
        jc = _client(coord, "a-jax", cls=jclient_cls)
        pc = _client(coord, "b-port")
        try:
            tj, _ = _in_thread(jc.join_world, 2)
            tp, _ = _in_thread(pc.join_world, 2)
            _joined(tj, tp)
            assert (jc.rank, pc.rank) == (0, 1)
            tj, bj = _in_thread(jc.allgather, {"x": jencode(ja)})
            tp, bp = _in_thread(pc.allgather, {"x": encode_array(pa)})
            _joined(tj, tp)
            got_j = [jdecode(p["x"]) for p in bj["value"]]
            got_p = [decode_array(p["x"]) for p in bp["value"]]
        finally:
            jc.close()
            pc.close()
    finally:
        coord.stop()
    for got in (got_j, got_p):
        assert got[0].dtype == ja.dtype and got[1].dtype == pa.dtype
        assert got[0].tobytes() == ja.tobytes()
        assert got[1].tobytes() == pa.tobytes()


def test_jax_and_port_clients_share_a_port_coordinator():
    from lightgbm_tpu.parallel.elastic import ElasticClient as JClient
    _mixed_gather(ElasticCoordinator, JClient)


def test_port_client_joins_a_jax_coordinator():
    from lightgbm_tpu.parallel.elastic import ElasticClient as JClient
    from lightgbm_tpu.parallel.elastic import \
        ElasticCoordinator as JCoordinator
    _mixed_gather(JCoordinator, JClient)


def test_encoding_is_the_jax_packages():
    from lightgbm_tpu.parallel.elastic import encode_array as jencode
    for arr in (np.linspace(-1, 1, 10, dtype=np.float32),
                np.arange(6, dtype=np.int64).reshape(2, 3)):
        assert encode_array(arr) == jencode(arr)


# ---------------------------------------------------------------------------
# the fleet: recovery accounting, the clock, the ledger
# ---------------------------------------------------------------------------
def test_recovery_episode_phases_sum_to_mttr():
    ep = fleet.RecoveryEpisode(error="RankLostError", generation=3,
                               target_iter=5,
                               stall_started=time.monotonic() - 0.05)
    for phase in ("detect", "resync", "reshard", "restore"):
        time.sleep(0.002)
        ep.mark(phase)
    rec = ep.finish(iteration=5)
    assert set(rec["phases"]) == set(fleet.RECOVERY_PHASES)
    assert rec["mttr_s"] == sum(rec["phases"].values())
    assert rec["phases"]["detect"] >= 0.05
    assert fleet.recovery_episodes() == [rec]
    assert ep.finish() is None          # closed once
    gone = fleet.RecoveryEpisode()
    gone.abandon()
    assert gone.finish() is None and len(fleet.recovery_episodes()) == 1
    s = obs.summary()
    assert s["events"].get("elastic:recovery") == 1
    assert s["counters"].get("elastic.recovery_episodes") == 1
    obs.reset()
    assert fleet.recovery_episodes() == []


def test_clock_offset_estimate_and_summary():
    """Midpoint of the round trip, the minimum-RTT sample, its error
    ``rtt / 2``; installed, it rides the summary and the trace."""
    calls = []

    def fetch():
        calls.append(1)
        return time.time() + 10.0
    off, err = fleet.estimate_clock_offset(fetch, samples=3)
    assert len(calls) == 3
    assert abs(off - 10.0) < 0.05 and 0.0 <= err < 0.05
    fleet.set_clock(off, err)
    assert fleet.clock() == {"offset_s": off, "err_s": err}
    assert obs.summary()["clock"]["offset_s"] == off


def test_jax_read_ledger_reads_a_port_ledger(tmp_path):
    from lightgbm_tpu.obs import fleet as jfleet
    path = str(tmp_path / "fleet.jsonl")
    with _coord_ledger(path) as coord:
        a = _client(coord, "a")
        try:
            a.join_world()
            a.allgather("x", site="site.y")
        finally:
            a.leave()
            a.close()
    ours, theirs = fleet.read_ledger(path), jfleet.read_ledger(path)
    assert ours == theirs
    kinds = [r["kind"] for r in ours]
    assert kinds[0] == "coordinator_start" and kinds[-1] == "coordinator_stop"
    assert {"join", "round", "member_left"} <= set(kinds)
    rnd = next(r for r in ours if r["kind"] == "round")
    assert rnd["site"] == "site.y" and rnd["world"] == 1
    with open(path, "a") as f:
        f.write('{"torn": ')
    with pytest.raises(ValueError, match="unparseable"):
        fleet.read_ledger(path)


@contextlib.contextmanager
def _coord_ledger(path):
    coord = ElasticCoordinator(heartbeat_timeout_s=5.0, ledger_path=path)
    coord.start()
    try:
        yield coord
    finally:
        coord.stop()


def test_health_walks_ready_recovering_ready():
    """``recovering`` is not sticky: a finished recovery returns
    ``/healthz`` to ready."""
    health._set_active(True)
    health.reset()
    health.mark_ready()
    assert health.state()["state"] == "ready"
    health.mark_recovering(reason="RankLostError")
    st = health.state()
    assert st["state"] == "recovering"
    assert st["detail"]["reason"] == "RankLostError"
    health.mark_ready()
    assert health.state()["state"] == "ready"
