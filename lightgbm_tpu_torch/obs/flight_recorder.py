"""Collective flight recorder: every rank's collective schedule.

A copy of the JAX package's ``obs/flight_recorder.py``.  Each collective
site of the port appends a ``(site, op, axis, shape, dtype)`` fingerprint
to a bounded per-rank ring (``LGBM_TPU_FR_CAP``, default 128 entries) and
folds it into a rolling sha1 digest over the whole history:

* the wave collectives of ``parallel/learners.py`` and ``ops/overlap.py``
  (``parallel.learners.hist_psum``, ``.sync_global_best``,
  ``.voting.vote_gather``, ``.voting.sel_psum``), recorded once per call
  on the host before the collective is issued;
* the host collectives of ``io/distributed.py`` and
  ``parallel/mesh.py`` (``parallel.mesh.rendezvous``, the allgather
  sites), recorded per logical call.

Digests are cross-checked across ranks where the training loop already
gathers: the eval-window metric sync (``engine.py``) and
``obs.merged_summary`` (every rank's summary carries its
``flight_recorder`` section).  A mismatch emits a ``spmd:desync`` event
naming the first diverging site and rank, logs a WARNING and lands in the
summary under ``flight_recorder_check``.  When the retry layer gives up
(``utils/retry.py``), the last K entries go into the summary as
``flight_recorder_dump``.

The ``spmd.skip_record`` fault point drops one record, as a
rank-conditional branch around a collective would.  Always on; disable
with ``LGBM_TPU_FLIGHT_RECORDER=0``.  Operand dtypes are written as the
JAX package writes them (``float32``, not ``torch.float32``), so the
same schedule gives the same digest in both packages.
"""
from __future__ import annotations

import hashlib
import os
from collections import deque
from typing import Any, Dict, List, Optional, Sequence

__all__ = [
    "record", "snapshot", "fingerprint", "reset", "enabled",
    "cross_check_summaries", "window_check", "dump_to_summary",
]

from .lock_contract import named_lock

_lock = named_lock("flight_recorder")
_CAP = max(8, int(os.environ.get("LGBM_TPU_FR_CAP", "128") or 128))
_ring: "deque[Dict[str, Any]]" = deque(maxlen=_CAP)
_count = 0                      # entries ever recorded (ring may be smaller)
_digest = ""                    # rolling sha1 over the full history


def enabled() -> bool:
    return os.environ.get("LGBM_TPU_FLIGHT_RECORDER", "1") != "0"


def reset() -> None:
    global _count, _digest
    with _lock:
        _ring.clear()
        _count = 0
        _digest = ""


def _dtype_name(dtype) -> str:
    """``float32`` for ``torch.float32`` and numpy's ``float32`` alike."""
    s = str(dtype)
    return s[len("torch."):] if s.startswith("torch.") else s


def _fp_str(entry: Dict[str, Any]) -> str:
    return (f"{entry['site']}|{entry['op']}|{entry['axis']}|"
            f"{entry['shape']}|{entry['dtype']}")


def record(site: str, op: str, axis: Optional[str] = None,
           operand: Any = None) -> None:
    """Append one collective fingerprint.  ``operand`` is a tensor or
    array (its shape and dtype are read, no device sync), a tuple of
    them or None (no shape: host object collectives, whose payload sizes
    legitimately differ per rank — only rank-invariant fields may enter
    the fingerprint)."""
    if not enabled():
        return
    from ..utils.faults import FaultInjected, fault_point
    try:
        # an armed skip makes this rank's schedule miss the site, as
        # rank-conditional control flow would
        fault_point("spmd.skip_record")
    except FaultInjected:
        return
    shape = getattr(operand, "shape", None)
    dtype = getattr(operand, "dtype", None)
    entry = {
        "site": site, "op": op,
        "axis": None if axis is None else str(axis),
        "shape": None if shape is None else tuple(int(d) for d in shape),
        "dtype": None if dtype is None else _dtype_name(dtype),
    }
    global _count, _digest
    with _lock:
        entry["seq"] = _count
        _ring.append(entry)
        _count += 1
        _digest = hashlib.sha1(
            (_digest + _fp_str(entry)).encode()).hexdigest()[:16]


def snapshot() -> Dict[str, Any]:
    """This rank's recorder state: total count, rolling digest, last-K
    entries (JSON-serializable — rides the telemetry summary)."""
    with _lock:
        return {"count": _count, "digest": _digest, "cap": _CAP,
                "last": [dict(e) for e in _ring]}


def fingerprint() -> List[Any]:
    """Compact ``[count, digest]`` for cheap per-window cross-checks."""
    with _lock:
        return [_count, _digest]


# ---------------------------------------------------------------------------
# cross-rank checking
# ---------------------------------------------------------------------------
def _first_divergence(snaps: Sequence[Optional[Dict[str, Any]]]
                      ) -> Optional[Dict[str, Any]]:
    """Locate the first schedule divergence across per-rank snapshots.
    Ranks are compared entry-by-entry on the fingerprint string; the
    diverging rank is the one whose stream differs from the majority
    (ties blame the shorter stream: a skipped collective shows up as a
    missing entry).  Returns None when the divergence predates every
    ring window (the digests still prove it happened)."""
    per_rank: List[Dict[int, Dict[str, Any]]] = []
    for s in snaps:
        entries = (s or {}).get("last", [])
        per_rank.append({int(e["seq"]): e for e in entries})
    counts = [(s or {}).get("count", 0) for s in snaps]
    all_seqs = sorted({q for m in per_rank for q in m})
    unknown = ("<evicted>", "<not-yet>")
    for seq in all_seqs:
        # a seq a rank counted but whose ring entry was evicted is
        # UNKNOWN, not divergent (only the window is bounded, not the
        # digest); a seq past a rank's count is handled after the loop
        fps = [(_fp_str(m[seq]) if seq in m
                else ("<evicted>" if seq < counts[r] else "<not-yet>"))
               for r, m in enumerate(per_rank)]
        vals = {fp for fp in fps if fp not in unknown}
        if len(vals) <= 1:
            continue
        # majority fingerprint; deviants are the diverging ranks
        tally: Dict[str, int] = {}
        for fp in fps:
            if fp not in unknown:
                tally[fp] = tally.get(fp, 0) + 1
        majority = max(sorted(tally), key=lambda k: tally[k])
        deviants = [r for r, fp in enumerate(fps)
                    if fp not in unknown and fp != majority]
        if not deviants:
            continue
        # shorter stream first: a skipped collective truncates it
        deviants.sort(key=lambda r: (counts[r], -r))
        site_entry = next((m[seq] for m in per_rank if seq in m), None)
        return {
            "seq": seq,
            "site": site_entry["site"] if site_entry else None,
            "op": site_entry["op"] if site_entry else None,
            "rank": deviants[0],
            "ranks": deviants,
            "entries": {r: (per_rank[r].get(seq) or fps[r])
                        for r in range(len(per_rank))},
        }
    # streams agree entry-for-entry but some rank stopped short: checks
    # run at synchronization barriers, so "not yet there" IS "skipped" —
    # the divergence sits at the shortest stream's end, and the site is
    # whatever the longer ranks issued there
    if len(set(counts)) > 1:
        seq = min(counts)
        site_entry = next((m[seq] for m in per_rank if seq in m), None)
        deviants = sorted([r for r, c in enumerate(counts) if c == seq],
                          key=lambda r: -r)
        return {
            "seq": seq,
            "site": site_entry["site"] if site_entry else None,
            "op": site_entry["op"] if site_entry else None,
            "rank": deviants[0],
            "ranks": deviants,
            "entries": {r: per_rank[r].get(seq) or "<missing>"
                        for r in range(len(per_rank))},
        }
    return None


def _report_desync(div: Optional[Dict[str, Any]],
                   counts: Sequence[int],
                   digests: Sequence[str]) -> Dict[str, Any]:
    from ..utils.log import log_warning
    from .telemetry import event
    out: Dict[str, Any] = {"ok": False, "counts": list(counts),
                           "digests": list(digests)}
    if div is not None:
        out["first_divergence"] = div
        log_warning(
            f"spmd desync: collective schedule diverged at seq "
            f"{div['seq']} site {div['site']!r} — rank {div['rank']} "
            f"disagrees (per-rank counts {list(counts)})")
        event("spmd", "desync", site=div["site"], rank=div["rank"],
              seq=div["seq"])
    else:
        out["first_divergence"] = None
        log_warning(
            f"spmd desync: schedule digests differ but the divergence "
            f"predates the ring window (counts {list(counts)}); raise "
            f"LGBM_TPU_FR_CAP to localize")
        event("spmd", "desync", site=None, rank=None, seq=None)
    return out


def cross_check_summaries(rank_summaries: Sequence[Dict[str, Any]]
                          ) -> Optional[Dict[str, Any]]:
    """Cross-rank schedule check over merged telemetry summaries (each
    carrying its rank's ``flight_recorder`` section).  Returns None
    when no rank recorded anything; otherwise a check report —
    ``{"ok": True, ...}`` or the desync evidence."""
    snaps = [s.get("flight_recorder") for s in rank_summaries]
    if not any(snaps):
        return None
    counts = [(s or {}).get("count", 0) for s in snaps]
    digests = [(s or {}).get("digest", "") for s in snaps]
    if len(set(counts)) == 1 and len(set(digests)) == 1:
        return {"ok": True, "count": counts[0], "digest": digests[0]}
    return _report_desync(_first_divergence(snaps), counts, digests)


def window_check(fingerprints: Sequence[Sequence[Any]],
                 allgather=None) -> bool:
    """Cheap per-window check over ``[count, digest]`` pairs gathered
    from every rank (piggybacked on an existing host collective, e.g.
    the eval-window metric sync).  On mismatch, a SECOND allgather (the
    rare path) exchanges the last-K rings to localize the first
    diverging site+rank.  Returns True when schedules agree."""
    from .telemetry import counter_add, set_section
    counter_add("spmd.window_checks")
    counts = [int(fp[0]) for fp in fingerprints]
    digests = [str(fp[1]) for fp in fingerprints]
    if len(set(counts)) == 1 and len(set(digests)) == 1:
        return True
    div = None
    if allgather is not None:
        snaps = allgather(snapshot())
        div = _first_divergence(snaps)
    report = _report_desync(div, counts, digests)
    set_section("flight_recorder_check", report)
    return False


def dump_to_summary(reason: str) -> None:
    """Drop the last-K schedule into the telemetry summary (called on
    retry exhaustion / gate failures): the post-mortem for a hung or
    failed collective is what this rank had issued up to that point."""
    from .telemetry import set_section
    dump = snapshot()
    dump["reason"] = reason
    set_section("flight_recorder_dump", dump)
