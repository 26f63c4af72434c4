"""The runtime contracts of lightgbm_tpu_torch against the JAX package's,
on the CPU: the lock-order contract (``obs/lock_contract.py``), the ulp
contract (``obs/num_contract.py``), the memory watermark contract
(``obs/mem_contract.py``), the trace contract
(``obs/trace_contract.py``) and the peak tables (``obs/chip_specs.py``).

Module-level behaviour is held to the JAX package's modules on the same
inputs; the training-level contracts run a toy ``lgb.train`` on the CPU
(the memory contract samples the live CPU tensors there).
"""
import os
import re
import threading

import numpy as np
import pytest
import torch

from tools.concheck.lock_registry import LOCKS
from tools.numcheck.tolerance_registry import tol

import lightgbm_tpu as jlgb
from lightgbm_tpu.obs import chip_specs as jspecs
from lightgbm_tpu.obs import num_contract as jnum
from lightgbm_tpu.utils import faults as jfaults

import lightgbm_tpu_torch as tlgb
from lightgbm_tpu_torch import obs as tobs
from lightgbm_tpu_torch.boosting import gbdt as tgbdt
from lightgbm_tpu_torch.learner.serial import (STREAM_CHUNK,
                                               reduce_chunk_sums,
                                               root_chunk_sums)
from lightgbm_tpu_torch.obs import chip_specs as tspecs
from lightgbm_tpu_torch.obs import lock_contract as lc
from lightgbm_tpu_torch.obs import mem_contract as tmem
from lightgbm_tpu_torch.obs import num_contract as tnum
from lightgbm_tpu_torch.obs import trace_contract as ttc
from lightgbm_tpu_torch.ops import cuda_build
from lightgbm_tpu_torch.utils import faults as tfaults

torch.set_num_threads(1)   # tiny tensors: more threads only spin

PORT = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "lightgbm_tpu_torch")
BASE = {"num_leaves": 7, "max_bin": 63, "min_data_in_leaf": 20,
        "verbose": -1}


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for var in ("LGBM_TPU_LOCK_CONTRACT", "LGBM_TPU_LOCK_HOLD_S",
                "LGBM_TPU_NUM_CONTRACT", "LGBM_TPU_MEM_CONTRACT",
                "LGBM_TPU_TRACE_CONTRACT"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("LGBM_TPU_HIST_BACKEND", "compact")
    monkeypatch.setenv("LGBM_TPU_SPLIT_INTERPRET", "1")
    lc.reset()
    tobs.reset()
    tnum.reset()
    jnum.reset()
    tfaults.clear()
    jfaults.clear()
    yield
    tfaults.clear()
    jfaults.clear()
    lc.reset()
    tobs.reset()
    tgbdt._MEM_LEAK_SINK.clear()


def _data(objective="regression", n=600, f=6, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.normal(size=(n, f)).astype(np.float32)
    z = X[:, 0] * 2 + X[:, 1] - X[:, 2] + rng.normal(size=n)
    if objective == "binary":
        return X, (z > 0).astype(np.float32), {"objective": "binary"}
    return X, z.astype(np.float32), {"objective": "regression"}


def _train(params, X, y, rounds=6, **kw):
    return tlgb.train(dict(params), tlgb.Dataset(X, label=y), rounds,
                      verbose_eval=False, device="cpu", **kw)


# ---------------------------------------------------------------------------
# lock contract
# ---------------------------------------------------------------------------
def test_lock_contract_off_returns_plain_primitives():
    plain = (type(threading.Lock()), type(threading.RLock()),
             threading.Condition)
    made = (lc.named_lock("x"), lc.named_rlock("x"),
            lc.named_condition("x"))
    for m, t in zip(made, plain):
        assert isinstance(m, t) and not isinstance(m, lc._ContractBase)


def test_lock_cycle_reported_with_both_sites(monkeypatch):
    monkeypatch.setenv("LGBM_TPU_LOCK_CONTRACT", "1")
    a = lc.named_lock("probe_a")
    b = lc.named_lock("probe_b")

    def order_ab():
        with a:
            with b:
                pass
    t = threading.Thread(target=order_ab)
    t.start()
    t.join(timeout=10.0)
    assert not lc.violations()
    with b:
        with a:                     # closes the cycle
            pass
    cycles = [v for v in lc.violations() if v["kind"] == "lock-order-cycle"]
    assert len(cycles) == 1, lc.violations()
    sites = re.findall(r"probe_[ab]@(test_torch_contracts\.py:\d+)",
                       cycles[0]["detail"])
    assert len(set(sites)) == 4, cycles[0]["detail"]


def test_slow_hold_fault_gives_held_past_deadline(monkeypatch):
    monkeypatch.setenv("LGBM_TPU_LOCK_CONTRACT", "1")
    monkeypatch.setenv("LGBM_TPU_LOCK_HOLD_S", "0.01")
    lk = lc.named_lock("probe_hold")
    tfaults.inject("lock.slow_hold", times=1)
    with lk:
        pass
    held = [v for v in lc.violations() if v["kind"] == "held-past-deadline"]
    assert len(held) == 1, lc.violations()
    assert held[0]["lock"] == "probe_hold"
    assert held[0]["hold_s"] > held[0]["deadline_s"]
    assert "test_torch_contracts.py:" in held[0]["site"]
    assert held[0]["stack"]


def test_port_lock_ids_are_registry_names():
    """Every lock the port names is one of the JAX package's registry ids
    (``tools/concheck/lock_registry.py``)."""
    names = set()
    pat = re.compile(r"named_(?:lock|rlock|condition)\(\s*\"([^\"]+)\"")
    for root, _, files in os.walk(PORT):
        for f in files:
            if f.endswith(".py"):
                names |= set(pat.findall(open(os.path.join(root, f)).read()))
    registry = {d["name"] for d in LOCKS}
    assert {"telemetry", "faults", "log_once", "serve", "health",
            "watchdog", "ops_plane", "ops_drain", "metrics_registry",
            "trace_contract"} <= names
    assert names <= registry, names - registry


def test_contract_locks_train_clean(monkeypatch):
    """Under the contract, a training run in a fresh process takes the
    port's named locks with no cycle."""
    import subprocess
    import sys
    code = ("import numpy as np, lightgbm_tpu_torch as lgb\n"
            "from lightgbm_tpu_torch.obs import lock_contract as lc\n"
            "X = np.random.RandomState(0).normal(size=(300, 4))\n"
            "lgb.train({'objective': 'regression', 'num_leaves': 5,\n"
            "           'verbose': -1}, lgb.Dataset(X, label=X[:, 0]), 3,\n"
            "          device='cpu')\n"
            "s = lc.snapshot()\n"
            "assert 'telemetry' in s['stats'] or 'faults' in s['stats'], s\n"
            "assert not lc.violations(), lc.violations()\n"
            "print('ok')\n")
    env = dict(os.environ, LGBM_TPU_LOCK_CONTRACT="1")
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         cwd=os.path.dirname(PORT), capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0 and "ok" in out.stdout, out.stderr[-2000:]


# ---------------------------------------------------------------------------
# num contract
# ---------------------------------------------------------------------------
def test_num_contract_constants():
    assert tnum.STREAM_CHUNK == STREAM_CHUNK == jnum.STREAM_CHUNK
    assert tnum.ULP_BUDGET == tol("score_root_ulp") == jnum.ULP_BUDGET
    assert tnum.BUDGET_NAME == "score_root_ulp"


@pytest.mark.parametrize("n", [1, 8191, 8192, 8193, 3 * 8192 + 5, 70001])
def test_canonical_root_sum_is_reference(n):
    rng = np.random.RandomState(n)
    x = (rng.normal(size=n) * 10.0 ** rng.uniform(-4, 3, size=n)).astype(
        np.float32)
    got = tnum.canonical_root_sum(x)
    assert np.float32(got).view(np.uint32) == \
        np.float32(jnum.canonical_root_sum(x)).view(np.uint32)
    # and the port's own torch reduction of the same rows
    t = torch.from_numpy(x)
    sg = reduce_chunk_sums(root_chunk_sums(t, t, torch.ones(n, dtype=bool)))
    assert np.float32(sg[0].item()).view(np.uint32) == \
        np.float32(got).view(np.uint32)


def _num_ledger(mod_lgb, num, X, y, device=None, **extra):
    params = {**BASE, "objective": "regression", "metric": "l2", **extra}
    num.reset()
    kw = {"device": device} if device else {}
    mod_lgb.train(dict(params), mod_lgb.Dataset(X, label=y), 6,
                  valid_sets=[mod_lgb.Dataset(X[:200], label=y[:200])],
                  verbose_eval=False, **kw)
    return num.ledger()


def test_l2_ulp_ledger_equals_reference(monkeypatch):
    monkeypatch.setenv("LGBM_TPU_NUM_CONTRACT", "1")
    X, y, _ = _data()
    jl = _num_ledger(jlgb, jnum, X, y)
    tl = _num_ledger(tlgb, tnum, X, y, "cpu")
    assert len(tl) == 6 and tl == jl
    sec = tobs.summary()["numerics"]
    assert sec["budget_name"] == "score_root_ulp" and not sec["trips"]


def test_num_reassoc_moves_the_ledger(monkeypatch):
    """A plain ``torch.sum`` root reduction moves the trained scores: the
    right child's sums are the root's minus the left's, so the root sums
    must be large (shifted labels, no ``boost_from_average``) for their
    last bits to reach a leaf."""
    monkeypatch.setenv("LGBM_TPU_NUM_CONTRACT", "1")
    X, y, _ = _data(n=30000, seed=3)
    y = y + 10.0
    clean = _num_ledger(tlgb, tnum, X, y, "cpu", boost_from_average=False)
    tfaults.inject("num.reassoc", times=1000)
    moved = _num_ledger(tlgb, tnum, X, y, "cpu", boost_from_average=False)
    assert tfaults.fired("num.reassoc") >= 6
    assert [h for _, _, h in moved] != [h for _, _, h in clean]


def test_ulp_budget_trip_degrades(monkeypatch):
    from lightgbm_tpu_torch.obs import health
    monkeypatch.setenv("LGBM_TPU_NUM_CONTRACT", "1")
    monkeypatch.setenv("LGBM_TPU_NUM_CONTRACT", "1")
    # one 2^24 at the front of a chunk and a 0.99 at each pairwise
    # partner of it: every halving level rounds one 0.99 away
    s = np.zeros(8192, np.float32)
    s[0] = 2.0 ** 24
    s[[8192 >> k for k in range(1, 14)]] = 0.99
    monkeypatch.setattr(tnum, "ULP_BUDGET", 4)
    monkeypatch.setattr(jnum, "ULP_BUDGET", 4)
    tobs.enable()
    health._set_active(True)
    try:
        drift = tnum.window_check(s, it=3)
        assert drift == jnum.window_check(s, it=3) == 6
        assert health.state()["state"] == "degraded"
        assert tobs.summary()["events"]["num:ulp_budget"] == 1
    finally:
        health._set_active(False)
        health.reset()


# ---------------------------------------------------------------------------
# memory contract
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n,rounds", [(600, 6), (20000, 12)])
def test_mem_contract_clean_run(monkeypatch, n, rounds):
    """No violation on a clean run; at 20,000 rows a pending tree that
    kept its ``[n]`` per-row storage alive would cross the 1 MiB
    tolerance within the run."""
    monkeypatch.setenv("LGBM_TPU_MEM_CONTRACT", "1")
    X, y, p = _data(n=n)
    _train({**BASE, **p}, X, y, rounds)
    rep = tobs.summary()["mem_contract"]
    assert rep["source"] == "live_tensors"
    assert rep["windows_sampled"] == rounds
    assert rep["violation_count"] == 0 and rep["steady_ok"]
    assert rep["inplace_checked"] and rep["inplace_ok"]


@pytest.mark.parametrize("variant", [{}, {"boosting": "rf",
                                          "bagging_freq": 1,
                                          "bagging_fraction": 0.7}])
def test_mem_leak_fault_is_caught_and_named(monkeypatch, variant):
    monkeypatch.setenv("LGBM_TPU_MEM_CONTRACT", "1")
    X, y, p = _data()
    tobs.enable()
    tfaults.inject("mem.leak", times=100)
    _train({**BASE, **p, **variant}, X, y, 6)
    rep = tobs.summary()["mem_contract"]
    assert rep["violation_count"] >= 1
    assert rep["violations"][0]["span"] == "gbdt.iteration"
    assert rep["violations"][0]["grew_bytes"] >= tgbdt._MEM_LEAK_ELEMS * 4
    assert rep["inplace_ok"]
    assert tobs.summary()["events"]["mem:watermark_violation"] >= 1


def test_inplace_probe_counts_score_tensors():
    wm = tmem.Watermark("probe", sampler=lambda: (0, None, "live_tensors"))
    a = torch.zeros((1234, 3))
    wm.check_inplace(a.shape, a.dtype, "cpu", expected=1)
    assert wm.inplace_ok
    b = torch.ones((1234, 3))
    wm.check_inplace(a.shape, a.dtype, "cpu", expected=1)
    assert not wm.inplace_ok and wm.violations[0]["live_score_tensors"] == 2
    del b


def test_watermark_gate_against_baseline():
    seq = iter([10, 50, 60, 50 + (1 << 20) + 100])
    wm = tmem.Watermark("probe", warmup=1,
                        sampler=lambda: (next(seq), None, "probe"))
    for _ in range(4):
        wm.sample("probe.span")
    rep = wm.report()
    assert rep["baseline_bytes"] == 50 and rep["violation_count"] == 1
    assert rep["violations"][0]["span"] == "probe.span"


# ---------------------------------------------------------------------------
# trace contract
# ---------------------------------------------------------------------------
def test_trace_contract_toy_train_has_no_steady_events(monkeypatch):
    monkeypatch.setenv("LGBM_TPU_TRACE_CONTRACT", "1")
    X, y, p = _data()
    _train({**BASE, **p}, X, y, 4)
    rep = tobs.summary()["trace_contract"]
    assert rep["compiles_steady"] == 0 and rep["steady_ok"]
    assert "contract:recompile_after_warmup" not in tobs.summary()["events"]


def test_build_event_after_steady_is_a_violation(monkeypatch):
    monkeypatch.setenv("LGBM_TPU_TRACE_CONTRACT", "1")
    tobs.enable()
    with ttc.maybe_track() as t:
        cuda_build.compile_event("nvcc", "hist_route")
        t.mark_steady()
        cuda_build.compile_event("load", "route")
    rep = tobs.summary()["trace_contract"]
    assert rep["compiles_warmup"] == 1 and rep["compiles_steady"] == 1
    assert rep["steady_names"] == ["load:route"] and not rep["steady_ok"]
    assert tobs.summary()["events"]["contract:recompile_after_warmup"] == 1
    # no tracker: the seam is a no-op
    ttc.compile_event("nvcc", "x")
    assert not ttc._trackers


def test_trace_contract_off_is_a_no_op():
    with ttc.maybe_track() as t:
        t.mark_steady()
    assert "trace_contract" not in tobs.summary()


# ---------------------------------------------------------------------------
# chip specs
# ---------------------------------------------------------------------------
def test_h100_row():
    p = tspecs.peaks_for("NVIDIA H100 80GB HBM3")
    assert p["key"] == "h100"
    assert p["hbm_bytes_per_s"] == 3.35e12 and p["flops_per_s"] == 67e12
    assert p["bf16_flops_per_s"] == 989e12
    assert "3.35 TB/s" in p["source"]
    assert tspecs.peaks_for("cpu")["sentinel"] is True
    assert tspecs.peaks_for("TPU v5 lite")["flops_per_s"] is None
    assert tspecs.device_kind("cpu") == "cpu"


@pytest.mark.parametrize("flops,nbytes,secs", [
    (1e9, 4e9, 1e-3), (5e12, 1e9, 0.5), (0.0, 1e6, 1e-6),
    (1e6, None, 2e-3), (3e9, 2e9, None), (1e3, 1e3, 10.0)])
def test_roofline_is_reference_arithmetic(flops, nbytes, secs):
    for peaks in (tspecs.peaks_for("NVIDIA H100 80GB HBM3"),
                  tspecs.peaks_for("cpu")):
        assert tspecs.roofline(flops, nbytes, secs, peaks) == \
            jspecs.roofline(flops, nbytes, secs, peaks)
