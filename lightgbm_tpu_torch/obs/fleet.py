"""Fleet observability: the cross-rank half of telemetry.

A copy of the JAX package's ``obs/fleet.py``.  Four host-only pieces
that ``parallel/elastic.py``, ``io/distributed.py`` and
``boosting/streaming.py`` plug into:

* **Clock alignment**: :func:`estimate_clock_offset` turns any "fetch
  the coordinator's wall clock" call into a midpoint-of-RTT offset,
  ``offset = server_ts - (t_send + t_recv) / 2``, with the error bound
  ``rtt / 2`` (Cristian's bound).  The elastic client refreshes it each
  generation and installs it with :func:`set_clock`; telemetry then
  stamps ``clk_off_s`` on every trace record, so ``tools/fleet_report.py``
  maps every rank onto the coordinator's clock
  (``corrected_ts = ts + clk_off_s``).
* **Collective wait accounting**: every host collective (the process
  and bin-finding allgathers, the elastic allgathers) reports how its
  wall time split into ``wait_s`` (blocked on slower peers: arrival
  skew) and ``xfer_s`` (the transport), keyed ``(site, generation,
  seq)`` so that the ranks' records of one collective join.
  :func:`note_collective` aggregates the per-site totals this rank saw;
  :func:`skew_snapshot` rides the run summary as ``collective_skew`` and
  :func:`merge_skew` lifts the ranks' sections into the fleet table of
  ``obs.merged_summary``.
* **Recovery MTTR accounting**: :class:`RecoveryEpisode` carves one
  elastic recovery into the contiguous phases ``detect -> resync ->
  reshard -> restore -> retrain``; consecutive ``mark()`` boundaries
  partition the interval, so the phase durations sum to ``mttr_s`` by
  construction.  Episodes are kept module-side (:func:`recovery_episodes`)
  whether telemetry is on or not (the chaos launcher reads them from
  workers that never trace) and emitted as ``elastic:recovery`` events.
* **The fleet ledger**: :class:`FleetLedger`, the coordinator's JSONL
  history that survives a SIGKILL: one ``os.write`` of a whole line on an
  ``O_APPEND`` descriptor, fsync'd line by line, so a killed coordinator
  leaves only complete lines.  Its records carry the JAX package's field
  names, so either package's :func:`read_ledger` (and
  ``tools/fleet_report.py``) reads the other's ledger.

Knobs: ``LGBM_TPU_CLOCK_SYNC`` (on by default; ``0`` skips the offset
estimation), ``LGBM_TPU_FLEET_LEDGER`` (the ledger path; unset, no
ledger), ``LGBM_TPU_COLLECTIVE_SLOW`` (the ``collective.slow`` fault's
delay in seconds, default 0.25).  Host-side only.
"""
from __future__ import annotations

import json
import os
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

__all__ = [
    "clock_sync_enabled", "collective_slow_s", "ledger_path_env",
    "estimate_clock_offset", "set_clock", "clock", "next_seq",
    "note_collective", "skew_snapshot", "merge_skew",
    "RecoveryEpisode", "recovery_episodes", "FleetLedger",
    "read_ledger", "reset",
]

from .lock_contract import named_lock

_lock = named_lock("fleet")


# ---------------------------------------------------------------------------
# knobs
# ---------------------------------------------------------------------------
def clock_sync_enabled() -> bool:
    """``LGBM_TPU_CLOCK_SYNC`` — on by default; ``0`` disables the
    per-generation offset estimation (records then carry no
    ``clk_off_s`` and the fleet report treats every rank as already on
    the coordinator clock)."""
    return os.environ.get("LGBM_TPU_CLOCK_SYNC", "1") != "0"


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


def ledger_path_env() -> Optional[str]:
    """``LGBM_TPU_FLEET_LEDGER`` — the coordinator ledger path."""
    return os.environ.get("LGBM_TPU_FLEET_LEDGER") or None


# ---------------------------------------------------------------------------
# clock alignment
# ---------------------------------------------------------------------------
_clock: Dict[str, Optional[float]] = {"offset_s": None, "err_s": None}


def estimate_clock_offset(fetch_server_ts: Callable[[], float],
                          samples: int = 4) -> Tuple[float, float]:
    """Midpoint-of-RTT offset of the server clock relative to this
    process: ``offset = server_ts - (t0 + t1) / 2`` from the
    minimum-RTT sample (the least-delayed exchange carries the
    tightest bound).  Returns ``(offset_s, err_s)`` with
    ``err_s = rtt_min / 2``; ``local_ts + offset_s`` lands on the
    server clock within ``+-err_s``."""
    best: Optional[Tuple[float, float]] = None
    for _ in range(max(int(samples), 1)):
        t0 = time.time()
        server_ts = float(fetch_server_ts())
        t1 = time.time()
        rtt = max(t1 - t0, 0.0)
        off = server_ts - (t0 + t1) / 2.0
        if best is None or rtt < best[0]:
            best = (rtt, off)
    assert best is not None
    return best[1], best[0] / 2.0


def set_clock(offset_s: float, err_s: Optional[float] = None) -> None:
    """Install this rank's coordinator-clock offset: telemetry stamps
    it into every subsequent trace record as ``clk_off_s``."""
    from . import telemetry
    with _lock:
        _clock["offset_s"] = float(offset_s)
        _clock["err_s"] = None if err_s is None else float(err_s)
    telemetry.set_clock_offset(float(offset_s))


def clock() -> Dict[str, Optional[float]]:
    with _lock:
        return dict(_clock)


# ---------------------------------------------------------------------------
# collective join keys + wait accounting
# ---------------------------------------------------------------------------
_seqs: Dict[str, int] = {}
_skew: Dict[str, Dict[str, Any]] = {}


def next_seq(site: str) -> int:
    """Per-site monotonic sequence for collectives that have no
    protocol-level round key (the process and bin-finding
    allgathers).  Every
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


# ---------------------------------------------------------------------------
# recovery MTTR accounting
# ---------------------------------------------------------------------------
RECOVERY_PHASES = ("detect", "resync", "reshard", "restore", "retrain")

_episodes: List[Dict[str, Any]] = []


class RecoveryEpisode:
    """One elastic recovery, carved into contiguous phases.

    The interval starts when the failed collective STARTED stalling
    (``stall_started``, monotonic — the deadline wait is the detect
    cost) and ends when training re-reaches the iteration it was at
    when the failure hit (``target_iter``).  ``mark(phase)`` closes
    the current phase at *now*; consecutive boundaries partition the
    interval, so ``mttr_s`` is DEFINED as the sum of the phase
    durations — the breakdown always sums to it exactly."""

    def __init__(self, error: str = "", generation: int = -1,
                 target_iter: int = 0,
                 stall_started: Optional[float] = None):
        now = time.monotonic()
        t0 = now if stall_started is None else float(stall_started)
        self._last = min(t0, now)
        self.error = str(error)
        self.generation = int(generation)
        self.target_iter = max(int(target_iter), 0)
        self.phases: Dict[str, float] = {}
        self.closed = False

    def mark(self, phase: str) -> None:
        """Close the running phase at now (repeat marks accumulate)."""
        if self.closed:
            return
        now = time.monotonic()
        self.phases[phase] = (self.phases.get(phase, 0.0)
                              + max(now - self._last, 0.0))
        self._last = now

    def finish(self, **extra: Any) -> Optional[Dict[str, Any]]:
        """Close the episode (the open tail is the ``retrain`` phase),
        record it module-side and emit the ``elastic:recovery`` event
        carrying the phase breakdown.  Returns the episode record."""
        if self.closed:
            return None
        self.mark("retrain")
        self.closed = True
        phases = {p: round(self.phases.get(p, 0.0), 6)
                  for p in RECOVERY_PHASES}
        rec: Dict[str, Any] = {
            "error": self.error, "generation": self.generation,
            "target_iter": self.target_iter,
            "phases": phases,
            "mttr_s": sum(phases.values()),
        }
        rec.update(extra)
        with _lock:
            _episodes.append(rec)
        from .telemetry import counter_add, event
        counter_add("elastic.recovery_episodes")
        event("elastic", "recovery", mttr_s=rec["mttr_s"],
              error=self.error, generation=self.generation,
              target_iter=self.target_iter,
              **{f"{p}_s": phases[p] for p in RECOVERY_PHASES})
        return rec

    def abandon(self) -> None:
        """A second interrupt landed before this episode closed: the
        new episode subsumes the interval; drop this one."""
        self.closed = True


def recovery_episodes() -> List[Dict[str, Any]]:
    """Every finished episode this process recorded (chaos workers
    ship this list in their result JSON; works with telemetry off)."""
    with _lock:
        return [dict(e) for e in _episodes]


# ---------------------------------------------------------------------------
# the coordinator's SIGKILL-survivable ledger
# ---------------------------------------------------------------------------
class FleetLedger:
    """Append-only JSONL event ledger: one ``os.write`` of a complete
    line on an ``O_APPEND`` fd, fsync'd per line — no tmp file, no
    rename, so a SIGKILL leaves only whole lines (every prior line is
    already durable and parseable)."""

    def __init__(self, path: str):
        self.path = path
        d = os.path.dirname(os.path.abspath(path))
        if d:
            os.makedirs(d, exist_ok=True)
        self._fd: Optional[int] = os.open(
            path, os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644)
        self._wlock = named_lock("fleet_ledger")

    def put_line(self, kind: str, **fields: Any) -> None:
        # ledger lines carry operator-facing wall-clock timestamps
        rec: Dict[str, Any] = {"ts": round(time.time(), 6), "kind": kind}
        rec.update(fields)
        line = (json.dumps(rec) + "\n").encode()
        with self._wlock:
            if self._fd is None:
                return
            try:
                os.write(self._fd, line)
                os.fsync(self._fd)
            except OSError:
                pass                # a full disk must not kill the fleet

    def close(self) -> None:
        with self._wlock:
            if self._fd is not None:
                try:
                    os.close(self._fd)
                except OSError:
                    pass
                self._fd = None


def read_ledger(path: str) -> List[Dict[str, Any]]:
    """Parse a ledger strictly: every non-empty line must be valid
    JSON (the SIGKILL-survivability contract) — a torn line raises
    ``ValueError`` naming its line number."""
    out: List[Dict[str, Any]] = []
    with open(path) as f:
        for i, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                out.append(json.loads(line))
            except ValueError:
                raise ValueError(
                    f"{path}:{i}: unparseable ledger line "
                    f"({line[:60]!r})") from None
    return out


def reset() -> None:
    """Forget per-run fleet state (tests; rides ``telemetry.reset``)."""
    with _lock:
        _seqs.clear()
        _skew.clear()
        _episodes.clear()
        _clock["offset_s"] = None
        _clock["err_s"] = None
