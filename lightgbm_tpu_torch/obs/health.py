"""Live health plane: state machine, stall watchdog, numerics sentinels.

A copy of the JAX package's ``obs/health.py``: the state a scraper can
read while the process runs, and a watchdog that names a stalled launch
before a supervisor's kill erases the evidence.

* **Health state machine** — ``warming -> ready -> draining`` with two
  sticky failure states, ``stalled`` (the watchdog fired) and
  ``degraded`` (a numerics sentinel or the ulp budget tripped), and the
  non-sticky ``recovering``.  ``/healthz`` on the ops plane
  (``obs/ops_plane.py``) serves :func:`state`; every transition also
  lands as the ``health`` summary section.
* **Stall watchdog** — a monitor thread armed around each training
  iteration (``engine.py``, ``gbdt.iteration``), streamed tree
  (``boosting/streaming.py``) and serve batch (``serve/server.py``) by
  ``LGBM_TPU_WATCHDOG_S`` (seconds; off by default).  On expiry it emits
  a ``health:stall`` event naming the active span, dumps every thread's
  stack with :mod:`faulthandler`, and writes ``<trace>.forensic.json`` through ``utils/file_io.atomic_write``
  (temporary file and rename: a kill mid-dump never publishes a torn
  file).  It only observes: the stalled launch is left to finish.
* **Numerics sentinels** — over the host copy of the scores taken at
  each iteration boundary: non-finite scores, leaf values or metrics
  raise ``health:nonfinite`` and a lower-is-better metric jumping past
  ``LGBM_TPU_SPIKE_FACTOR`` times its best raises ``health:loss_spike``;
  both turn ``/healthz`` to ``degraded``.  On whenever the ops plane is
  mounted; forced with ``LGBM_TPU_SENTINELS=1``, off with ``=0``.

Fault points (``utils/faults.py``): ``watchdog.stall`` makes the armed
iteration sleep past the deadline (:func:`stall_fault`),
``health.nan_grad`` poisons one gradient element (``GBDT.gradients``).
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np

__all__ = [
    "state", "tracking", "mark_warming", "mark_ready", "mark_recovering",
    "mark_draining", "mark_degraded", "mark_stalled", "reset", "Watchdog",
    "watchdog_seconds", "stall_fault", "sentinels_enabled",
    "check_scores", "check_metrics", "forensic_path", "write_forensic",
]

from .lock_contract import named_condition, named_rlock

_lock = named_rlock("health")
_active = False                 # flipped by the ops plane / watchdog /
#                                  sentinels: mark_* are no-ops otherwise
# ordered by severity: a transition may only move DOWN this list via
# explicit reset (stalled/degraded are sticky — a scraper that polls
# after the incident must still see it).  `recovering` (elastic
# re-rendezvous in progress, parallel/elastic.py) is NOT sticky: a
# successful recovery walks ready -> recovering -> ready.
_SEVERITY = ("ready", "warming", "recovering", "draining", "degraded",
             "stalled")
_state: Dict[str, Any] = {"state": "disabled", "since": None, "detail": {}}
# sentinel memory: per-metric best (rolling reference for the spike
# check) and the one-shot flags so a poisoned run reports the FIRST
# offending window, not one event per boundary after it
_loss_best: Dict[str, float] = {}
_reported: Dict[str, bool] = {}


def _set_active(on: bool) -> None:
    global _active
    with _lock:
        _active = bool(on)
        if on and _state["state"] == "disabled":
            _transition("warming")


def tracking() -> bool:
    """Whether any live-health consumer (ops plane, watchdog,
    sentinels) is armed; ``mark_*`` are one-attr-read no-ops
    otherwise."""
    return _active


def state() -> Dict[str, Any]:
    """The current health state (what ``/healthz`` serves)."""
    with _lock:
        return {"state": _state["state"], "since": _state["since"],
                "detail": dict(_state["detail"])}


def _transition(new: str, **detail) -> None:
    """Move the state machine; sticky states only escalate.  Caller
    may hold ``_lock``.  Every transition refreshes the ``health``
    summary section so multi-rank merged summaries carry it."""
    with _lock:
        cur = _state["state"]
        if cur in _SEVERITY and new in _SEVERITY \
                and _SEVERITY.index(new) < _SEVERITY.index(cur) \
                and cur in ("stalled", "degraded", "draining"):
            # sticky: ready/warming never papers over an incident (or
            # an in-progress drain)
            _state["detail"].update(detail)
            return
        _state["state"] = new
        _state["since"] = time.time()
        _state["detail"].update(detail)
    from .telemetry import set_section
    set_section("health", state())


def mark_warming(plane: str = "") -> None:
    if not _active:
        return
    _transition("warming", **({"plane": plane} if plane else {}))


def mark_ready() -> None:
    if not _active:
        return
    _transition("ready")


def mark_recovering(**detail) -> None:
    """Elastic recovery in flight (rank lost / membership changed —
    ``parallel/elastic.py``): survivors are re-rendezvousing and
    resuming from the last committed barrier snapshot.  Non-sticky —
    a completed recovery returns ``/healthz`` to ``ready``."""
    if not _active:
        return
    _transition("recovering", **detail)


def mark_draining(**detail) -> None:
    if not _active:
        return
    _transition("draining", **detail)


def mark_degraded(reason: str, **detail) -> None:
    if not _active:
        return
    _transition("degraded", reason=reason, **detail)


def mark_stalled(span: str, **detail) -> None:
    if not _active:
        return
    _transition("stalled", stalled_span=span, **detail)


def reset() -> None:
    """Back to a clean slate (tests; a fresh run).  The active flag is
    kept — the ops plane stays mounted across runs in one process."""
    with _lock:
        _state["state"] = "warming" if _active else "disabled"
        _state["since"] = time.time() if _active else None
        _state["detail"] = {}
        _loss_best.clear()
        _reported.clear()


# ---------------------------------------------------------------------------
# stall watchdog
# ---------------------------------------------------------------------------
def watchdog_seconds() -> Optional[float]:
    """The armed deadline from ``LGBM_TPU_WATCHDOG_S`` (default off)."""
    raw = os.environ.get("LGBM_TPU_WATCHDOG_S", "")
    if not raw:
        return None
    try:
        s = float(raw)
    except ValueError:
        return None
    return s if s > 0 else None


def forensic_path() -> Optional[str]:
    """Where the stall forensics land: ``LGBM_TPU_FORENSIC`` wins,
    else ``<trace>.forensic.json`` next to the JSONL trace, else None
    (the dump still reaches the ``forensic`` summary section)."""
    p = os.environ.get("LGBM_TPU_FORENSIC", "")
    if p:
        return p
    from .telemetry import trace_path
    tp = trace_path()
    return f"{tp}.forensic.json" if tp else None


def _thread_stacks() -> str:
    """All-thread stacks via :mod:`faulthandler` (the same dump a
    fatal signal would produce — C-level frames included on py>=3.12,
    and immune to an interpreter wedged in a lock)."""
    import faulthandler
    import tempfile
    with tempfile.TemporaryFile(mode="w+") as f:
        faulthandler.dump_traceback(file=f, all_threads=True)
        f.seek(0)
        return f.read()


def build_forensic(span: str, plane: str, deadline_s: float,
                   attrs: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """The forensic record: who stalled, every thread's stack, the run
    counters/events so far, and the collective flight recorder's last-K
    ring (a stall in a collective names the site this rank was in)."""
    from . import flight_recorder
    from .telemetry import _rank_world, summary
    rank, world = _rank_world()
    s = summary()
    return {
        "ts": time.time(),
        "kind": "stall_forensic",
        "plane": plane,
        "span": span,
        "attrs": dict(attrs or {}),
        "deadline_s": deadline_s,
        "rank": rank,
        "process_count": world,
        "health": state(),
        "stacks": _thread_stacks(),
        "counters": s.get("counters", {}),
        "events": s.get("events", {}),
        "flight_recorder": flight_recorder.snapshot(),
    }


def write_forensic(dump: Dict[str, Any],
                   path: Optional[str] = None) -> Optional[str]:
    """Publish the forensic dump tmp+rename (the snapshot discipline:
    ``chunks=2`` routes the write through the ``snapshot.write`` fault
    point mid-payload, so tests prove a death mid-dump leaves the
    previous published file intact and the torn bytes in ``.tmp``).
    Also lands as the ``forensic`` summary section either way."""
    from .telemetry import set_section
    set_section("forensic", dump)
    path = path or forensic_path()
    if path is None:
        return None
    from ..utils.file_io import atomic_write
    atomic_write(path, json.dumps(dump, indent=1), chunks=2)
    return path


class Watchdog:
    """One monitor thread; :meth:`arm` around each training iteration /
    serve batch, :meth:`disarm` when the launch returns.  On expiry
    the active span is named in a ``health:stall`` event, ``/healthz``
    flips to ``stalled``, and the forensic dump is written — while the
    stalled dispatch is still in flight."""

    def __init__(self, plane: str, deadline_s: float):
        self.plane = plane
        self.deadline_s = float(deadline_s)
        self.fired = threading.Event()      # latest arm's expiry flag
        self._cv = named_condition("watchdog")
        self._armed: Optional[tuple] = None  # (seq, span, attrs, deadline)
        self._seq = 0
        self._stop = False
        _set_active(True)
        self._thread = threading.Thread(
            target=self._run, name=f"lgbm-torch-watchdog-{plane}",
            daemon=True)
        self._thread.start()

    @classmethod
    def maybe(cls, plane: str) -> Optional["Watchdog"]:
        s = watchdog_seconds()
        return cls(plane, s) if s else None

    def arm(self, span: str, **attrs) -> None:
        from .telemetry import counter_add
        counter_add("watchdog.arms")
        with self._cv:
            self._seq += 1
            self.fired.clear()
            self._armed = (self._seq, span, attrs,
                           time.monotonic() + self.deadline_s)
            self._cv.notify()

    def disarm(self) -> None:
        with self._cv:
            self._armed = None
            self._cv.notify()

    def stop(self) -> None:
        with self._cv:
            self._stop = True
            self._cv.notify()
        self._thread.join(timeout=5.0)

    def _run(self) -> None:
        while True:
            with self._cv:
                while not self._stop and self._armed is None:
                    self._cv.wait()
                if self._stop:
                    return
                _seq, span, attrs, deadline = self._armed
                wait = deadline - time.monotonic()
                if wait > 0:
                    # wait out (a slice of) the deadline, then
                    # re-evaluate: a disarm or re-arm in the meantime
                    # resets the loop
                    self._cv.wait(wait)
                    continue
                # past the deadline and still armed: fire once,
                # outside the lock (the dump takes real time and arm/
                # disarm from the worker thread must never block on it)
                self._armed = None
            try:
                self._fire(span, attrs)
            finally:
                self.fired.set()

    def _fire(self, span: str, attrs: Dict[str, Any]) -> None:
        from ..utils.log import log_warning
        from .telemetry import counter_add, event
        counter_add("watchdog.fires")
        event("health", "stall", span=span, plane=self.plane,
              deadline_s=self.deadline_s, **attrs)
        mark_stalled(span, plane=self.plane)
        log_warning(
            f"watchdog: span {span!r} ({self.plane}) exceeded "
            f"{self.deadline_s:g}s — dumping stacks")
        try:
            path = write_forensic(
                build_forensic(span, self.plane, self.deadline_s, attrs))
            if path:
                log_warning(f"watchdog: forensics written to {path}")
        # the dump is best-effort evidence: a failed write must not take
        # the monitor thread down
        except Exception as exc:        # noqa: BLE001
            log_warning(f"watchdog: forensic dump failed: {exc}")


def stall_fault(wd: Optional[Watchdog]) -> None:
    """The ``watchdog.stall`` injection seam: when armed, the calling
    (training or serving) thread sleeps inside the armed span until the
    watchdog names it.  No-op unless the fault is armed."""
    if wd is None:
        return
    from ..utils import faults
    if faults.armed() and faults.fault_flag("watchdog.stall"):
        wd.fired.wait(wd.deadline_s * 10 + 10)


# ---------------------------------------------------------------------------
# numerics sentinels
# ---------------------------------------------------------------------------
def _spike_factor() -> float:
    return float(os.environ.get("LGBM_TPU_SPIKE_FACTOR", "3.0"))


def sentinels_enabled() -> bool:
    """Sentinels run at the iteration boundaries when the ops plane is
    mounted (or forced with ``LGBM_TPU_SENTINELS=1``)."""
    raw = os.environ.get("LGBM_TPU_SENTINELS", "")
    if raw == "0":
        return False
    if raw == "1":
        _set_active(True)
        return True
    from . import ops_plane
    return ops_plane.plane() is not None


def check_scores(scores, window: int) -> bool:
    """Non-finite detection over the score state at an iteration boundary
    (a NaN/inf gradient or hessian poisons the scores it folds into
    within one iteration): a host array, or a tensor checked on its own
    device and copied to the host only when a value is not finite.
    Returns True when clean."""
    from .telemetry import counter_add
    counter_add("health.sentinel_checks")
    if not isinstance(scores, np.ndarray):
        import torch
        if bool(torch.isfinite(scores).all()):
            return True
        scores = scores.cpu().numpy()
    finite = bool(np.isfinite(scores).all())
    if finite:
        return True
    if not _reported.get("nonfinite"):
        _reported["nonfinite"] = True
        bad = int(np.size(scores) - np.count_nonzero(np.isfinite(scores)))
        from ..utils.log import log_warning
        from .telemetry import event
        counter_add("health.nonfinite")
        event("health", "nonfinite", what="scores", window=int(window),
              bad_elements=bad)
        mark_degraded("nonfinite", window=int(window), what="scores",
                      bad_elements=bad)
        log_warning(
            f"health sentinel: {bad} non-finite score element(s) at "
            f"window {int(window)} — a NaN/inf gradient, hessian, or "
            f"leaf value entered the score state")
    return False


def check_leaf_values(leaf_values, window: int) -> bool:
    """Non-finite detection over an iteration's leaf values before the
    stumps are zeroed (``GBDT.train_one_iter`` hands them over on the
    all-stump stop: a non-finite gradient or hessian makes every split
    gain NaN, so the tree is a stump whose root value is non-finite, and
    the zeroing would erase the evidence).  Returns True when clean."""
    bad = sum(int(np.size(lv) - np.count_nonzero(np.isfinite(lv)))
              for lv in leaf_values)
    if not bad:
        return True
    if not _reported.get("nonfinite"):
        _reported["nonfinite"] = True
        from ..utils.log import log_warning
        from .telemetry import counter_add, event
        counter_add("health.nonfinite")
        event("health", "nonfinite", what="leaf_value",
              window=int(window), bad_elements=bad)
        mark_degraded("nonfinite", window=int(window), what="leaf_value",
                      bad_elements=bad)
        log_warning(
            f"health sentinel: non-finite leaf value(s) at window "
            f"{int(window)} — a NaN/inf gradient or hessian poisoned "
            f"the tree build (the all-stump stop was numerics, not "
            f"convergence)")
    return False


def check_metrics(results: List[tuple], window: int) -> bool:
    """Sentinels over the window's eval results (``(set, metric, value,
    higher_is_better)`` tuples, already host-side): non-finite metric
    values raise ``health:nonfinite``; a lower-is-better (loss-like)
    metric jumping past ``LGBM_TPU_SPIKE_FACTOR`` x its best-so-far
    raises ``health:loss_spike``.  Returns True when clean."""
    from ..utils.log import log_warning
    from .telemetry import counter_add, event
    ok = True
    for name, mname, val, hib in results:
        key = f"{name}:{mname}"
        if not np.isfinite(val):
            ok = False
            if not _reported.get(f"nonfinite:{key}"):
                _reported[f"nonfinite:{key}"] = True
                counter_add("health.nonfinite")
                event("health", "nonfinite", what=key, window=int(window))
                mark_degraded("nonfinite", window=int(window), what=key)
                log_warning(f"health sentinel: metric {key} is "
                            f"non-finite at window {int(window)}")
            continue
        if hib:
            continue
        best = _loss_best.get(key)
        if best is None or val < best:
            _loss_best[key] = float(val)
        elif best > 0 and val > best * _spike_factor():
            ok = False
            if not _reported.get(f"spike:{key}"):
                _reported[f"spike:{key}"] = True
                counter_add("health.loss_spikes")
                event("health", "loss_spike", what=key,
                      window=int(window), value=float(val),
                      best=float(best))
                mark_degraded("loss_spike", window=int(window), what=key,
                              value=float(val), best=float(best))
                log_warning(
                    f"health sentinel: {key} spiked to {val:.6g} "
                    f"(best {best:.6g}, factor {_spike_factor():g}) at "
                    f"window {int(window)} — training is diverging")
    return ok
