"""Runtime trace contract: no compile events after warmup.

The JAX package's ``obs/trace_contract.py`` counts XLA trace-cache misses
and holds the steady state of a run to zero of them.  The port never
re-enters XLA; its counterparts of a recompile are

* an ``nvcc`` build or a ``ctypes`` load of a kernel library
  (``ops/cuda_build.py``: ``build_all``, ``library``);
* a build of the native parser (``native/__init__.py``);
* a CUDA-graph capture of a serving bucket (``serve/compiler.py``,
  ``CompiledModel.warm``).

Each calls :func:`compile_event`, one module-level seam: with no live
tracker it costs one attribute read.  A :class:`CompileTracker` counts
the events on either side of :meth:`CompileTracker.mark_steady` (the
training loop calls it after the first iteration, the serving harness
after ``warm()``), keeps the thread of each event, and reports warmup
and steady counts in the ``trace_contract`` / ``serve_trace_contract``
summary sections.  A steady event emits a
``contract:recompile_after_warmup`` event and a WARNING.

``LGBM_TPU_TRACE_CONTRACT=1`` turns it on.
"""
from __future__ import annotations

import os
import threading
from typing import Any, Dict, List, Optional

from ..utils.log import log_warning
from . import telemetry

ENV_FLAG = "LGBM_TPU_TRACE_CONTRACT"

# the live trackers (a training run's and a server's may overlap)
_trackers: List["CompileTracker"] = []


def contract_enabled() -> bool:
    return bool(os.environ.get(ENV_FLAG, ""))


def compile_event(kind: str, name: str) -> None:
    """One compile event (``kind``: ``nvcc``, ``load``, ``native``,
    ``graph_capture``) into every live tracker."""
    if not _trackers:
        return
    tid = threading.get_ident()
    for t in list(_trackers):
        t._record(kind, name, tid)


class CompileTracker:
    """Counts compile events, split into warmup and steady at
    :meth:`mark_steady`.  Context manager, one per run."""

    def __init__(self, track_threads: bool = True):
        self._events: List[Dict[str, Any]] = []
        self._steady_idx: Optional[int] = None
        from .lock_contract import named_lock
        self._lock = named_lock("trace_contract")
        self._track_threads = track_threads
        self._main_thread: Optional[int] = None

    # -- lifecycle ------------------------------------------------------
    def __enter__(self) -> "CompileTracker":
        self._main_thread = threading.get_ident()
        _trackers.append(self)
        return self

    def __exit__(self, *exc) -> bool:
        if self in _trackers:
            _trackers.remove(self)
        return False

    # -- recording ------------------------------------------------------
    def _record(self, kind: str, name: str, thread: Optional[int]) -> None:
        with self._lock:
            self._events.append({"kind": kind, "name": name,
                                 "thread": thread})

    def mark_steady(self) -> None:
        """Flag the end of warmup; idempotent (the first call wins)."""
        with self._lock:
            if self._steady_idx is None:
                self._steady_idx = len(self._events)

    # -- reporting ------------------------------------------------------
    def _split(self):
        with self._lock:
            cut = (self._steady_idx if self._steady_idx is not None
                   else len(self._events))
            warm, steady = self._events[:cut], self._events[cut:]
        if self._track_threads:
            background = [e for e in steady
                          if e["thread"] != self._main_thread]
            steady = [e for e in steady
                      if e["thread"] == self._main_thread]
        else:
            background = []
        return warm, steady, background

    def report(self) -> Dict[str, Any]:
        warm, steady, background = self._split()
        return {
            "compiles_warmup": len(warm),
            "compiles_steady": len(steady),
            "compiles_background": len(background),
            "steady_ok": not steady,
            "steady_names": sorted({f"{e['kind']}:{e['name']}"
                                    for e in steady}),
            "warmup_kinds": sorted({e["kind"] for e in warm}),
        }


class _NoTracker:
    """Shared no-op so call sites stay unconditional."""

    def mark_steady(self) -> None:
        pass


_NO_TRACKER = _NoTracker()


class maybe_track:
    """``with maybe_track() as t:`` — a live :class:`CompileTracker` when
    ``LGBM_TPU_TRACE_CONTRACT`` is set, else a no-op.  On exit the report
    lands in the ``trace_contract`` summary section; a violation logs and
    emits an event."""

    def __init__(self) -> None:
        self._tracker: Optional[CompileTracker] = None

    def __enter__(self):
        if not contract_enabled():
            return _NO_TRACKER
        self._tracker = CompileTracker().__enter__()
        return self._tracker

    def __exit__(self, *exc) -> bool:
        if self._tracker is None:
            return False
        self._tracker.__exit__(*exc)
        rep = self._tracker.report()
        telemetry.set_section("trace_contract", rep)
        if not rep["steady_ok"]:
            telemetry.event("contract", "recompile_after_warmup",
                            count=rep["compiles_steady"],
                            names=rep["steady_names"])
            log_warning(
                f"trace contract violated: {rep['compiles_steady']} "
                f"compile event(s) after warmup "
                f"({', '.join(rep['steady_names'][:5])}) — a kernel build, "
                f"library load or graph capture in the steady state")
        return False
