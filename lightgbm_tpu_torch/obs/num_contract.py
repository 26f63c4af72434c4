"""Runtime ulp contract (``LGBM_TPU_NUM_CONTRACT=1``).

A copy of the JAX package's ``obs/num_contract.py``: the canonical
chunk-and-pairwise reduction of ``learner/serial.py`` (``root_stats``:
zero-padded ``STREAM_CHUNK`` chunks, each halved pairwise, then the chunk
axis padded to a power of two and halved again) keeps float32
accumulation error bounded and the same however the rows are split.

At every iteration boundary the training loop takes one host copy of
the float32 score state, shared with the health sentinels; under this
contract :func:`window_check` computes over it

* the **canonical f32 root sum** — a NumPy mirror of that reduction
  tree, add for add (:func:`canonical_root_sum`) — and the **f64
  oracle** (``np.sum(..., dtype=float64)``) over the same bytes;
* their difference in **ulps at the accumulation scale** (the float32
  spacing at ``sum |scores|``);
* an ``(iteration, drift_ulps, oracle_hex)`` ledger entry.  The oracle
  is kept as ``float.hex()``, so two runs compare exactly: a
  reassociated reducer (the ``num.reassoc`` fault) moves the trained
  scores in their last ulps, and the ledger's oracle entries part where
  the digests do.

The budget is shared by name with the JAX package's tolerance registry:
``ULP_BUDGET`` equals ``tol("score_root_ulp")``.  A trip emits a
``num:ulp_budget`` event and degrades ``/healthz`` (sticky, as the
non-finite sentinel).  Everything lands in the ``numerics`` summary
section.
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from .telemetry import event as obs_event
from .telemetry import set_section

__all__ = ["enabled", "reset", "canonical_root_sum", "ulp_diff",
           "window_check", "ledger", "trips", "section", "ULP_BUDGET",
           "BUDGET_NAME"]

# shared by name with the JAX package's tolerance registry
# ("score_root_ulp")
BUDGET_NAME = "score_root_ulp"
ULP_BUDGET = 8

# the canonical reduction grid (learner/serial.py STREAM_CHUNK), mirrored
# so the host replay reproduces the exact tree; tests pin the two equal
STREAM_CHUNK = 8192


def enabled() -> bool:
    return os.environ.get("LGBM_TPU_NUM_CONTRACT", "0") == "1"


# ledger state (process-wide, reset per run by GBDT.train / tests)
_LEDGER: List[Tuple[int, int, str]] = []   # (window_it, drift_ulps, hex)
_TRIPS: List[Dict] = []


def reset() -> None:
    _LEDGER.clear()
    _TRIPS.clear()


def canonical_root_sum(x) -> np.float32:
    """NumPy mirror of the canonical device reduction: zero-pad the
    flattened f32 array to the STREAM_CHUNK grid, pairwise-halve within
    chunks, pad the chunk axis to a power of two, pairwise-halve again.
    Bit for bit the adds, in the same order, of
    ``learner/serial.py``'s ``reduce_chunk_sums(root_chunk_sums(...))``."""
    v = np.ascontiguousarray(np.asarray(x, np.float32).reshape(-1))
    m = max(1, -(-v.size // STREAM_CHUNK))
    pad = m * STREAM_CHUNK - v.size
    if pad:
        v = np.concatenate([v, np.zeros(pad, np.float32)])
    v = v.reshape(m, STREAM_CHUNK)
    while v.shape[1] > 1:
        half = v.shape[1] // 2
        v = v[:, :half] + v[:, half:]
    v = v[:, 0]
    p = 1 << max(0, (m - 1).bit_length())
    if p > m:
        v = np.concatenate([v, np.zeros(p - m, np.float32)])
    while v.size > 1:
        half = v.size // 2
        v = v[:half] + v[half:]
    return np.float32(v[0])


def _ordered(x: np.float32) -> int:
    """Map f32 bits to integers monotonic in the float order (the
    standard lexicographic trick; ±0 map to the same key)."""
    u = int(np.float32(x).view(np.uint32))
    return (0x100000000 - u) if u & 0x80000000 else (u + 0x80000000)


def ulp_diff(a, b) -> int:
    """Distance between two f32 values in units in the last place
    (number of representable f32 values between them)."""
    return abs(_ordered(np.float32(a)) - _ordered(np.float32(b)))


def window_check(s_np: np.ndarray, it: int) -> Optional[int]:
    """Measure this iteration's accumulation drift over the host copy of
    the score state; returns the drift in ulps (None when skipped:
    contract off or non-finite scores, which the sentinel owns).

    Drift = |canonical f32 root-sum − f64 oracle| in units of the f32
    spacing at ``sum |scores|`` scale.  A budget trip is sticky
    degradation, not an exception: numerics drift is an observability
    fact the run should surface, not a crash."""
    if not enabled():
        return None
    s64 = np.asarray(s_np, np.float64)
    if not np.isfinite(s64).all():
        return None
    oracle = float(s64.sum())
    abssum = float(np.abs(s64).sum())
    canon = canonical_root_sum(s_np)
    if abssum == 0.0:
        drift = 0
    else:
        scale = float(np.spacing(np.float32(abssum)))
        drift = int(round(abs(float(canon) - oracle) / scale))
    _LEDGER.append((int(it), drift, float(oracle).hex()))
    if drift > ULP_BUDGET:
        info = {"window_it": int(it), "drift_ulps": drift,
                "budget": ULP_BUDGET, "budget_name": BUDGET_NAME,
                "canonical": float(canon), "oracle": oracle}
        _TRIPS.append(info)
        obs_event("num", "ulp_budget", **info)
        from . import health as _health
        _health.mark_degraded("ulp_budget", **info)
        from ..utils.log import log_warning
        log_warning(f"numerics contract violation at window it={it}: "
                    f"canonical f32 root-sum drifted {drift} ulps from "
                    f"the f64 oracle (budget {BUDGET_NAME}="
                    f"{ULP_BUDGET})")
    set_section("numerics", section())
    return drift


def ledger() -> List[Tuple[int, int, str]]:
    """The run's ``(window_it, drift_ulps, oracle_hex)`` entries."""
    return list(_LEDGER)


def trips() -> List[Dict]:
    return [dict(t) for t in _TRIPS]


def section() -> Dict:
    """The ``numerics`` summary section: budget, ledger, trips."""
    return {"budget_name": BUDGET_NAME, "budget_ulps": ULP_BUDGET,
            "windows": [[it, d, hx] for it, d, hx in _LEDGER],
            "trips": [dict(t) for t in _TRIPS]}
