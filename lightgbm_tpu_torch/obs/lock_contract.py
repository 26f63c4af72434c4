"""Runtime lock-order contract (``LGBM_TPU_LOCK_CONTRACT=1``).

A copy of the JAX package's ``obs/lock_contract.py``.  Under the contract
the port's locks are built through :func:`named_lock` /
:func:`named_rlock` / :func:`named_condition`, which return wrapped
primitives that record, per process:

* the **acquisition-order graph**: an edge ``A -> B`` every time a
  thread acquires ``B`` while holding ``A``, with the ``file:line`` of
  both acquisition sites.  Each new edge runs an **online cycle
  check**: a deadlock-in-waiting is reported the first time its closing
  edge appears, naming every edge on the cycle with both sites;
* per-lock **wait/hold timing**: every acquire measures its wait (with
  a contended flag from a non-blocking first attempt) and every release
  its hold.  Waits flow through the telemetry sink
  (``MetricsRegistry.lock_wait``) to ``/metrics`` as
  ``lgbm_tpu_lock_wait_seconds{lock,quantile}``;
* **held-past-deadline** records: with ``LGBM_TPU_LOCK_HOLD_S=<sec>``, a
  release after holding longer than the deadline records a violation
  carrying the owner's acquisition stack.

Lock names are the ids of the JAX package's declarative registry
(``tools/concheck/lock_registry.py``), so both packages name the same
edge.  Off (the default), the factories return plain ``threading``
primitives.

Only the stdlib is imported at module level (telemetry and faults are
imported inside the reporting helpers), so every module, ``utils.log``
and ``utils.faults`` at the bottom of the import graph included, can
take a named lock without an import cycle.
"""
from __future__ import annotations

import os
import sys
import threading
import time
import traceback
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

__all__ = [
    "enabled", "named_lock", "named_rlock", "named_condition",
    "violations", "reset", "snapshot",
    "ContractLock", "ContractRLock", "ContractCondition",
]

_WAIT_SAMPLES = 256          # bounded per-lock sample ring


def enabled() -> bool:
    """True when the contract is armed (read at lock creation)."""
    return os.environ.get("LGBM_TPU_LOCK_CONTRACT", "") == "1"


def _hold_deadline_s() -> float:
    raw = os.environ.get("LGBM_TPU_LOCK_HOLD_S", "")
    try:
        return float(raw) if raw else 0.0
    except ValueError:
        return 0.0


# ---------------------------------------------------------------------------
# process-wide state
# ---------------------------------------------------------------------------
_tls = threading.local()

# the graph lock is a RAW primitive (a wrapped one would report into
# itself); it is also declared in the registry as a leaf under every
# other lock so static analysis sees the same shape
_graph_lock = threading.Lock()
# edge -> (outer site, inner site) of the first observation
_edges: Dict[str, Dict[str, Tuple[str, str]]] = {}
_violations: List[Dict[str, Any]] = []
_stats: Dict[str, Dict[str, Any]] = {}


def _held_stack() -> List[Dict[str, Any]]:
    stack = getattr(_tls, "held", None)
    if stack is None:
        stack = _tls.held = []
    return stack


def _caller_site() -> str:
    """``file:line`` of the nearest frame outside this module."""
    f = sys._getframe(1)
    here = __file__
    while f is not None and f.f_code.co_filename == here:
        f = f.f_back
    if f is None:                                 # pragma: no cover
        return "<unknown>:0"
    return f"{os.path.basename(f.f_code.co_filename)}:{f.f_lineno}"


def _cycle_path(start: str, goal: str) -> Optional[List[str]]:
    """DFS path start -> ... -> goal in the edge graph (caller holds
    _graph_lock)."""
    stack = [(start, [start])]
    seen = {start}
    while stack:
        node, path = stack.pop()
        for nxt in _edges.get(node, ()):
            if nxt == goal:
                return path + [nxt]
            if nxt not in seen:
                seen.add(nxt)
                stack.append((nxt, path + [nxt]))
    return None


def _record_violation(v: Dict[str, Any]) -> None:
    with _graph_lock:
        _violations.append(v)
    _emit_event("lock_contract.violation", kind=v.get("kind", "?"),
                detail=v.get("detail", ""))


def _emit_event(name: str, **attrs: Any) -> None:
    """Telemetry export with a re-entrancy guard: the telemetry module's
    own lock is a wrapped lock, so reporting from inside a wrapper must
    never re-enter the wrappers."""
    if getattr(_tls, "in_report", False):
        return
    _tls.in_report = True
    try:
        from . import telemetry
        telemetry.counter_add("lock_contract.violations", 1)
        telemetry.event(name, **attrs)
    except Exception:               # a broken sink must never raise
        # out of a lock acquire/release
        pass
    finally:
        _tls.in_report = False


def _report_wait(name: str, wait_s: float, contended: bool) -> None:
    with _graph_lock:
        st = _stats.setdefault(name, {
            "acquires": 0, "contended": 0, "wait_max_s": 0.0,
            "hold_max_s": 0.0,
            "waits": deque(maxlen=_WAIT_SAMPLES)})
        st["acquires"] += 1
        st["contended"] += 1 if contended else 0
        st["wait_max_s"] = max(st["wait_max_s"], wait_s)
        st["waits"].append(wait_s)
    if getattr(_tls, "in_report", False):
        return
    # the sink records samples under ITS registry lock: exporting a
    # wait for that same lock (or while this thread already holds it)
    # would re-acquire a non-reentrant lock the thread owns and
    # self-deadlock — keep those samples in _stats/snapshot() only
    if name == "metrics_registry" or any(
            rec["name"] == "metrics_registry"
            for rec in getattr(_tls, "held", None) or ()):
        return
    _tls.in_report = True
    try:
        from . import telemetry
        _lw = getattr(telemetry.get_sink(), "lock_wait", None)
        if _lw is not None:
            _lw(name, wait_s, contended)
    except Exception:               # a broken sink must never raise
        # out of a lock acquire
        pass
    finally:
        _tls.in_report = False


def _report_hold(name: str, hold_s: float) -> None:
    with _graph_lock:
        st = _stats.get(name)
        if st is not None:
            st["hold_max_s"] = max(st["hold_max_s"], hold_s)


def _note_acquired(name: str, site: str) -> Dict[str, Any]:
    """Record edges + push the held record; returns the record."""
    stack = _held_stack()
    reentrant = any(rec["name"] == name for rec in stack)
    if stack and not reentrant:
        outer = stack[-1]
        a, b = outer["name"], name
        with _graph_lock:
            known = _edges.get(a, {})
            new_edge = b not in known
            if new_edge:
                cyc = _cycle_path(b, a)
                _edges.setdefault(a, {})[b] = (outer["site"], site)
            else:
                cyc = None
        if new_edge and cyc is not None:
            with _graph_lock:
                hops = []
                full = [a] + cyc           # a -> b -> ... -> a
                for i in range(len(full) - 1):
                    sa, sb = _edges.get(full[i], {}).get(
                        full[i + 1], ("?", "?"))
                    hops.append(f"{full[i]}@{sa} -> {full[i + 1]}@{sb}")
            detail = "; ".join(hops)
            _record_violation({
                "kind": "lock-order-cycle",
                "edge": (a, b),
                "sites": (outer["site"], site),
                "cycle": full,
                "detail": f"acquisition-order cycle closed by "
                          f"{a}@{outer['site']} -> {b}@{site}: {detail}",
            })
    deadline = _hold_deadline_s()
    rec = {
        "name": name, "site": site,
        "t": time.monotonic(),
        "stack": (traceback.format_stack()[:-2] if deadline > 0
                  else None),
        "deadline": deadline,
    }
    stack.append(rec)
    return rec


def _note_released(name: str) -> None:
    stack = _held_stack()
    for i in range(len(stack) - 1, -1, -1):
        if stack[i]["name"] == name:
            rec = stack.pop(i)
            hold = time.monotonic() - rec["t"]
            _report_hold(name, hold)
            if rec["deadline"] > 0 and hold > rec["deadline"]:
                owner = "".join(rec["stack"] or ())
                _record_violation({
                    "kind": "held-past-deadline",
                    "lock": name, "site": rec["site"],
                    "hold_s": round(hold, 6),
                    "deadline_s": rec["deadline"],
                    "thread": threading.current_thread().name,
                    "stack": owner,
                    "detail": f"lock '{name}' held {hold:.3f}s "
                              f"(deadline {rec['deadline']}s) by "
                              f"{threading.current_thread().name}, "
                              f"acquired at {rec['site']}",
                })
            return


def _maybe_slow_hold(name: str) -> None:
    """The ``lock.slow_hold`` fault point: sleep while holding a named
    lock so the contention/hold-deadline paths are testable."""
    if name == "faults":
        # the probe runs THROUGH the fault harness: probing the
        # harness's own lock would re-enter fault_point and self-
        # deadlock on the non-reentrant lock just acquired
        return
    if getattr(_tls, "in_report", False):
        return
    _tls.in_report = True
    try:
        from ..utils import faults
        if faults.fault_flag("lock.slow_hold"):
            time.sleep(0.05)
    except Exception:
        pass
    finally:
        _tls.in_report = False


# ---------------------------------------------------------------------------
# wrapped primitives
# ---------------------------------------------------------------------------
class _ContractBase:
    """Shared acquire/release bookkeeping for Lock and RLock."""

    def __init__(self, name: str, raw: Any) -> None:
        self.name = name
        self._raw = raw

    def acquire(self, blocking: bool = True,
                timeout: float = -1) -> bool:
        site = _caller_site()
        contended = False
        t0 = time.monotonic()
        got = self._raw.acquire(False)
        if not got:
            contended = True
            if not blocking:
                _report_wait(self.name, time.monotonic() - t0, True)
                return False
            got = (self._raw.acquire(True, timeout) if timeout >= 0
                   else self._raw.acquire(True))
        wait = time.monotonic() - t0
        _report_wait(self.name, wait, contended)
        if not got:
            return False
        _note_acquired(self.name, site)
        _maybe_slow_hold(self.name)
        return True

    def release(self) -> None:
        _note_released(self.name)
        self._raw.release()

    def locked(self) -> bool:
        raw_locked = getattr(self._raw, "locked", None)
        if raw_locked is not None:
            return bool(raw_locked())
        return any(rec["name"] == self.name            # rlock fallback
                   for rec in _held_stack())

    def __enter__(self) -> "_ContractBase":
        self.acquire()
        return self

    def __exit__(self, *exc: Any) -> None:
        self.release()

    def __repr__(self) -> str:                    # pragma: no cover
        return f"<{type(self).__name__} {self.name!r}>"


class ContractLock(_ContractBase):
    def __init__(self, name: str) -> None:
        super().__init__(name, threading.Lock())


class ContractRLock(_ContractBase):
    def __init__(self, name: str) -> None:
        super().__init__(name, threading.RLock())


class ContractCondition(_ContractBase):
    """Condition wrapper: ``wait`` surrenders the held record for its
    duration (the underlying lock really is released)."""

    def __init__(self, name: str) -> None:
        super().__init__(name, threading.Condition())

    def wait(self, timeout: Optional[float] = None) -> bool:
        _note_released(self.name)
        try:
            return self._raw.wait(timeout)
        finally:
            _note_acquired(self.name, _caller_site())

    def wait_for(self, predicate: Any,
                 timeout: Optional[float] = None) -> Any:
        _note_released(self.name)
        try:
            return self._raw.wait_for(predicate, timeout)
        finally:
            _note_acquired(self.name, _caller_site())

    def notify(self, n: int = 1) -> None:
        self._raw.notify(n)

    def notify_all(self) -> None:
        self._raw.notify_all()


# ---------------------------------------------------------------------------
# factories + inspection
# ---------------------------------------------------------------------------
def named_lock(name: str) -> Any:
    return ContractLock(name) if enabled() else threading.Lock()


def named_rlock(name: str) -> Any:
    return ContractRLock(name) if enabled() else threading.RLock()


def named_condition(name: str) -> Any:
    return (ContractCondition(name) if enabled()
            else threading.Condition())


def violations() -> List[Dict[str, Any]]:
    with _graph_lock:
        return list(_violations)


def snapshot() -> Dict[str, Any]:
    """Edges + per-lock stats (quantiles over the bounded sample ring),
    for tests and the watchdog forensic dump."""
    with _graph_lock:
        edges = {a: {b: sites for b, sites in inner.items()}
                 for a, inner in _edges.items()}
        stats: Dict[str, Any] = {}
        for name, st in _stats.items():
            waits = sorted(st["waits"])
            qs = {}
            for q in (50.0, 99.0):
                if waits:
                    idx = min(len(waits) - 1,
                              int(round((q / 100.0) * (len(waits) - 1))))
                    qs[q] = waits[idx]
            stats[name] = {
                "acquires": st["acquires"],
                "contended": st["contended"],
                "wait_max_s": st["wait_max_s"],
                "hold_max_s": st["hold_max_s"],
                "wait_quantiles_s": qs,
            }
        return {"edges": edges, "stats": stats,
                "violations": len(_violations)}


def reset() -> None:
    """Test isolation: drop the graph, stats, and violation log."""
    with _graph_lock:
        _edges.clear()
        _violations.clear()
        _stats.clear()
