"""Collective wait accounting: the cross-rank half of telemetry.

The collective part of the JAX package's ``obs/fleet.py``.  Every host
collective of the port (``io/distributed.py:process_allgather`` and the
bin-finding allgather) reports how its wall time split into ``wait_s``
(blocked on slower peers: arrival skew) and ``xfer_s`` (the transport),
keyed ``(site, seq)`` so that the ranks' records of one collective join.
:func:`note_collective` aggregates the per-site totals this rank saw
(waves, wait and transfer totals, how often this rank arrived last);
:func:`skew_snapshot` rides the run summary as ``collective_skew`` and
:func:`merge_skew` lifts the ranks' sections into the fleet table of
``obs.merged_summary``.

Clock alignment, recovery episodes and the fleet ledger belong to the
elastic protocol and wait for it (ROADMAP A12).

Knob: ``LGBM_TPU_COLLECTIVE_SLOW`` (the ``collective.slow`` delay in
seconds, default 0.25).  Host-side only.
"""
from __future__ import annotations

import os
from typing import Any, Dict, List, Optional

__all__ = ["collective_slow_s", "next_seq", "note_collective",
           "skew_snapshot", "merge_skew", "reset"]

from .lock_contract import named_lock

_lock = named_lock("fleet")


def collective_slow_s(deadline_s: Optional[float] = None) -> float:
    """The ``collective.slow`` fault's delay (``LGBM_TPU_COLLECTIVE_SLOW``
    seconds, default 0.25) — deliberately SUB-deadline: a straggler,
    not a lost rank.  Clamped to half the deadline so arming it can
    never turn skew injection into a spurious ``RankLostError``."""
    try:
        s = float(os.environ.get("LGBM_TPU_COLLECTIVE_SLOW", "0.25"))
    except ValueError:
        s = 0.25
    if s <= 0:
        s = 0.25
    if deadline_s and deadline_s > 0:
        s = min(s, max(deadline_s * 0.5, 0.01))
    return s


_seqs: Dict[str, int] = {}
_skew: Dict[str, Dict[str, Any]] = {}


def next_seq(site: str) -> int:
    """Per-site monotonic sequence for collectives that have no
    protocol-level round key (the process and bin-finding allgathers).  Every
    rank runs the same collective schedule (the flight recorder
    gate), so equal sites count in lockstep and ``(site, seq)`` joins
    per-rank records of the same collective."""
    with _lock:
        _seqs[site] = _seqs.get(site, 0) + 1
        return _seqs[site]


def note_collective(site: str, generation: int, seq: int, wait_s: float,
                    xfer_s: float, nbytes: int = -1,
                    straggler: bool = False) -> None:
    """Accumulate this rank's wait/xfer split for one collective wave.
    ``straggler`` marks waves where THIS rank arrived last (it waited
    ~0s while every peer waited on it)."""
    del generation, seq                 # aggregated per site; the full
    #                                     join key lives on the record
    with _lock:
        st = _skew.get(site)
        if st is None:
            st = _skew[site] = {
                "waves": 0, "wait_total_s": 0.0, "wait_max_s": 0.0,
                "xfer_total_s": 0.0, "bytes_total": 0,
                "straggler_waves": 0,
            }
        st["waves"] += 1
        st["wait_total_s"] += wait_s if wait_s > 0.0 else 0.0
        if wait_s > st["wait_max_s"]:
            st["wait_max_s"] = wait_s
        st["xfer_total_s"] += xfer_s if xfer_s > 0.0 else 0.0
        if nbytes and nbytes > 0:
            st["bytes_total"] += nbytes
        if straggler:
            st["straggler_waves"] += 1


def skew_snapshot() -> Optional[Dict[str, Dict[str, Any]]]:
    """This rank's per-site wait accounting (rides the run summary as
    ``collective_skew``), or None when no collective reported."""
    with _lock:
        if not _skew:
            return None
        return {site: dict(st) for site, st in _skew.items()}


def merge_skew(rank_summaries: List[Dict[str, Any]]
               ) -> Optional[Dict[str, Any]]:
    """Lift the per-rank ``collective_skew`` sections into one fleet
    table: per site, each rank's total wait and straggler-wave count,
    plus the dominant straggler ("rank 2 last into ``hist_psum`` 87%
    of waves")."""
    sites: Dict[str, Dict[str, Any]] = {}
    nranks = len(rank_summaries)
    for r, s in enumerate(rank_summaries):
        for site, st in (s.get("collective_skew") or {}).items():
            agg = sites.setdefault(site, {
                "waves": 0,
                "per_rank_wait_s": [0.0] * nranks,
                "per_rank_straggler_waves": [0] * nranks,
                "wait_max_s": 0.0,
            })
            agg["waves"] = max(agg["waves"], int(st.get("waves", 0)))
            agg["per_rank_wait_s"][r] = round(
                float(st.get("wait_total_s", 0.0)), 6)
            agg["per_rank_straggler_waves"][r] = int(
                st.get("straggler_waves", 0))
            agg["wait_max_s"] = max(agg["wait_max_s"],
                                    float(st.get("wait_max_s", 0.0)))
    if not sites:
        return None
    for agg in sites.values():
        sw = agg["per_rank_straggler_waves"]
        total = sum(sw)
        if total:
            top = max(range(len(sw)), key=lambda r: sw[r])
            agg["straggler_rank"] = top
            agg["straggler_pct"] = round(100.0 * sw[top] / total, 1)
    return sites


def reset() -> None:
    """Forget per-run fleet state (rides ``telemetry.reset``)."""
    with _lock:
        _seqs.clear()
        _skew.clear()
