"""lightgbm_tpu_torch's collective flight recorder, fleet accounting and
partition rules against the JAX package's, in one process.

* the cases of the JAX package's ``tests/test_flight_recorder.py``: the
  same records give the same snapshot and digest in both packages (a
  torch operand's dtype is written as the JAX package writes it), and
  ``cross_check_summaries`` / ``window_check`` name the same site and
  rank; the ``spmd.skip_record`` fault, the summary section, the retry
  layer's dump on exhaustion and ``LGBM_TPU_FLIGHT_RECORDER=0``;
* ``obs/fleet.py``'s wait accounting and merge equal the JAX package's;
* the determinism contract's cross-rank ``window_check``;
* the partition rule tables equal the JAX package's, name by name and
  axis by axis; an unmatched name raises.
"""
import numpy as np
import pytest
import torch

from lightgbm_tpu import obs as j_obs
from lightgbm_tpu.obs import fleet as j_fleet
from lightgbm_tpu.obs import flight_recorder as j_fr
from lightgbm_tpu.parallel import partition as j_part
from lightgbm_tpu.utils import faults as j_faults

from lightgbm_tpu_torch import obs as t_obs
from lightgbm_tpu_torch.obs import determinism as t_det
from lightgbm_tpu_torch.obs import fleet as t_fleet
from lightgbm_tpu_torch.obs import flight_recorder as t_fr
from lightgbm_tpu_torch.parallel import partition as t_part
from lightgbm_tpu_torch.utils import faults as t_faults

torch.set_num_threads(1)   # tiny tensors: more threads only spin

PKGS = {"jax": (j_obs, j_fr, j_faults), "torch": (t_obs, t_fr, t_faults)}


@pytest.fixture(autouse=True)
def _clean():
    for obs, _, faults in PKGS.values():
        obs.reset()
        faults.clear()
    yield
    for obs, _, faults in PKGS.values():
        obs.reset()
        faults.clear()


def _records(fr, operand):
    fr.record("parallel.learners.hist_psum", "psum", "data", operand)
    fr.record("io.distributed.process_allgather", "process_allgather")
    fr.record("parallel.learners.sync_global_best", "all_gather", "data",
              operand[0])
    return fr.snapshot()


def test_same_records_same_snapshot_and_digest():
    a = np.zeros((4, 6, 64, 3), np.float32)
    j = _records(j_fr, a)
    t = _records(t_fr, torch.zeros((4, 6, 64, 3), dtype=torch.float32))
    assert t == j
    assert t["last"][0]["dtype"] == "float32"
    assert t["last"][1]["shape"] is None
    assert t_fr.fingerprint() == j_fr.fingerprint()


def test_digest_covers_full_history_beyond_ring():
    for fr in (j_fr, t_fr):
        for _ in range(fr._CAP + 10):
            fr.record("site", "psum", "data")
    j, t = j_fr.snapshot(), t_fr.snapshot()
    assert t == j and len(t["last"]) == t_fr._CAP


def _run(fr, sites):
    fr.reset()
    for s in sites:
        fr.record(s, "allgather")
    return fr.snapshot()


CROSS = {
    "identical": [["s1", "s2", "s3"], ["s1", "s2", "s3"]],
    "skipped": [["s1", "s2", "s3"], ["s1", "s3"]],
    "trailing": [["s1", "s2", "s3"], ["s1", "s2"]],
    "majority": [["s1", "s2"], ["s1", "s2"], ["s1", "sX"]],
    "nothing": [[], []],
}


@pytest.mark.parametrize("case", sorted(CROSS))
def test_cross_check_summaries_same_verdict(case):
    out = {}
    for name, (_, fr, _) in PKGS.items():
        snaps = [_run(fr, sites) for sites in CROSS[case]]
        summaries = [{"rank": r, "flight_recorder": s if s["count"] else None}
                     for r, s in enumerate(snaps)]
        out[name] = fr.cross_check_summaries(summaries)
    assert out["torch"] == out["jax"]
    if case in ("skipped", "trailing", "majority"):
        assert out["torch"]["first_divergence"]["rank"] == (
            2 if case == "majority" else 1)


def test_window_check_mismatch_and_match():
    for obs, fr, _ in PKGS.values():
        obs.enable()
        a = _run(fr, ["s1", "s2", "s3"])
        b = _run(fr, ["s1", "s3"])
        fps = [[a["count"], a["digest"]], [b["count"], b["digest"]]]
        assert not fr.window_check(fps, allgather=lambda snap: [a, b])
        s = obs.summary()
        div = s["flight_recorder_check"]["first_divergence"]
        assert (div["site"], div["rank"]) == ("s2", 1)
        assert s["events"].get("spmd:desync") == 1
        obs.reset()
        obs.enable()
        a = _run(fr, ["s1", "s2"])
        assert fr.window_check([[a["count"], a["digest"]]] * 2)
        assert "flight_recorder_check" not in obs.summary()


def test_skip_fault_point_drops_recording():
    t_faults.inject("spmd.skip_record", times=1)
    t_fr.record("s1", "psum", "data")
    t_fr.record("s2", "psum", "data")
    snap = t_fr.snapshot()
    assert snap["count"] == 1 and snap["last"][0]["site"] == "s2"
    assert t_faults.fired("spmd.skip_record") == 1


def test_summary_carries_recorder_section():
    t_obs.enable()
    assert "flight_recorder" not in t_obs.summary()
    t_fr.record("s1", "psum", "data")
    sec = t_obs.summary()["flight_recorder"]
    assert sec["count"] == 1 and sec["last"][0]["site"] == "s1"
    t_obs.reset()
    assert t_fr.snapshot()["count"] == 0


def test_retry_exhaustion_dumps_schedule():
    from lightgbm_tpu_torch.utils.retry import RetryPolicy, retry_call
    t_fr.record("collective.x", "allgather")

    def boom():
        raise RuntimeError("UNAVAILABLE: injected")

    with pytest.raises(RuntimeError):
        retry_call(boom, policy=RetryPolicy(attempts=2, base_s=0.0,
                                            jitter=0.0),
                   what="collective.x")
    dump = t_obs.summary()["flight_recorder_dump"]
    assert dump["reason"] == "retry.collective.x.exhausted"
    assert dump["last"][0]["site"] == "collective.x"


def test_disabled_via_env(monkeypatch):
    monkeypatch.setenv("LGBM_TPU_FLIGHT_RECORDER", "0")
    t_fr.record("s1", "psum", "data")
    assert t_fr.snapshot()["count"] == 0


def test_forensic_dump_carries_the_ring():
    from lightgbm_tpu_torch.obs import health
    t_fr.record("s1", "psum", "data")
    rec = health.build_forensic("gbdt.iteration", "train", 1.0)
    assert rec["flight_recorder"]["last"][0]["site"] == "s1"


# ---------------------------------------------------------------------------
# fleet
# ---------------------------------------------------------------------------
NOTES = [("site.a", 0.10, 0.02, 100, False), ("site.a", 0.0, 0.03, 100, True),
         ("site.b", 0.25, 0.01, -1, False)]


def test_fleet_accounting_matches_jax():
    snaps = {}
    for name, fleet in (("jax", j_fleet), ("torch", t_fleet)):
        fleet.reset()
        for site, wait, xfer, nbytes, strag in NOTES:
            fleet.note_collective(site, -1, fleet.next_seq(site), wait, xfer,
                                  nbytes, strag)
        snaps[name] = fleet.skew_snapshot()
        assert fleet.next_seq("site.a") == 3
        fleet.reset()
    assert snaps["torch"] == snaps["jax"]
    ranks = [{"collective_skew": snaps["torch"]}, {"collective_skew": {
        "site.a": dict(snaps["torch"]["site.a"], straggler_waves=2)}}]
    assert t_fleet.merge_skew(ranks) == j_fleet.merge_skew(ranks)
    assert t_fleet.collective_slow_s(0.2) == j_fleet.collective_slow_s(0.2)


def test_merged_summary_lifts_check_and_skew():
    t_obs.enable()
    t_fr.record("s1", "psum", "data")
    t_fleet.note_collective("site.a", -1, 1, 0.1, 0.01, 10, False)
    mine = t_obs.summary()
    other = dict(mine, rank=1, flight_recorder=None)
    merged = t_obs.merged_summary(lambda s: [mine, other])
    assert merged["process_count"] == 2
    assert merged["flight_recorder_check"]["ok"] is False
    assert merged["collective_skew"]["site.a"]["per_rank_wait_s"] == [0.1,
                                                                      0.1]


def test_determinism_window_check():
    t_obs.enable()
    assert t_det.window_check(["abc", "abc"], it=3)
    assert not t_det.window_check(["abc", "abc", "abd"], it=4)
    assert t_obs.summary()["events"].get("det:digest_mismatch") == 1


# ---------------------------------------------------------------------------
# partition rules
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("row_sharded", [True, False],
                         ids=["data_voting", "feature"])
def test_rule_tables_match_jax(row_sharded):
    jr = j_part.train_rules("data", row_sharded)
    tr = t_part.train_rules("data", row_sharded)
    assert [(n, rx, tuple(spec)) for n, rx, spec in jr] == list(tr)
    assert list(j_part.serve_rules()[0][:2]) == list(t_part.serve_rules()[0][
        :2])
    # every JAX persistent name but the serve pack's resolves the same
    for name in j_part.persistent_names(2):
        if name.startswith("serve/"):
            continue
        assert t_part.match_name(tr, name) == tuple(
            j_part.match_name(jr, name))
        assert t_part.matching_rules(tr, name) == j_part.matching_rules(
            jr, name)


def test_audit_and_unmatched_name():
    rules = t_part.train_rules("data", True)
    names = [n for n in j_part.persistent_names(2)
             if not n.startswith("serve/")]
    names += [f"data/{n}" for n in t_part.DEVICE_DATA_NAMES]
    assert t_part.audit_rules(rules, names) == []
    findings = t_part.audit_rules(rules, ["model/unknown", "data/bins"])
    assert findings == ["model/unknown: matches NO partition rule"]
    with pytest.raises(t_part.PartitionRuleError, match="model/unknown"):
        t_part.match_name(rules, "model/unknown")
    twice = rules + (("bins_again", r"^data/bins$", ()),)
    assert t_part.audit_rules(twice, ["data/bins"]) == [
        "data/bins: matches 2 rules ['bins', 'bins_again'] (must be 1)"]
