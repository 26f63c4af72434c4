"""Fault injection: named failure points for robustness tests.

A copy of the JAX package's ``utils/faults.py`` for the port's seams:

* ``snapshot.write`` — mid-file during a snapshot's model write
  (``utils/file_io.atomic_write`` with ``chunks=2``,
  ``boosting/snapshot.py``): a preemption while serializing;
* ``serve.score`` — the serving harness's batched device scoring
  (``serve/server.py``); retried by the shared policy
  (``utils/retry.py``), and the delivery contract (exactly once per
  request) must hold across the retry.

Each point is a single ``fault_point(name)`` call that is a no-op unless
armed.  Tests arm points programmatically (:func:`inject`, :func:`clear`);
operators can arm them from the environment for chaos runs::

    LGBM_TPU_FAULTS="serve.score:2"

fires the first 2 calls.  ``name:times`` or ``name:times@skip`` (skip the
first ``skip`` calls).  Injected failures raise :class:`FaultInjected`,
whose message carries the ``UNAVAILABLE`` transient marker so the retry
layer classifies it like a real RPC fault; arm with ``!`` after the
count (``name:1!``) for a NON-transient fault that must pass straight
through the retry layer.  The JAX package's fault telemetry (counters
and events) waits for ROADMAP A13.
"""
from __future__ import annotations

import os
import threading
from typing import Dict, Optional


class FaultInjected(RuntimeError):
    """An injected fault.  ``transient`` controls whether the message
    carries the retry layer's transient marker."""

    def __init__(self, point: str, transient: bool = True):
        self.point = point
        self.transient = transient
        marker = "UNAVAILABLE" if transient else "PERMANENT"
        super().__init__(
            f"injected fault at {point!r} ({marker}: fault harness)")


class _Arm:
    __slots__ = ("times", "skip", "transient")

    def __init__(self, times: int, skip: int, transient: bool):
        self.times = times
        self.skip = skip
        self.transient = transient


_lock = threading.Lock()
_arms: Dict[str, _Arm] = {}
_fired: Dict[str, int] = {}
_calls: Dict[str, int] = {}
_env_loaded = False


def _load_env() -> None:
    global _env_loaded
    _env_loaded = True
    spec = os.environ.get("LGBM_TPU_FAULTS", "")
    for part in spec.split(","):
        part = part.strip()
        if not part or ":" not in part:
            continue
        name, rest = part.split(":", 1)
        transient = not rest.endswith("!")
        rest = rest.rstrip("!")
        skip = 0
        if "@" in rest:
            rest, skip_s = rest.split("@", 1)
            skip = int(skip_s)
        _arms[name.strip()] = _Arm(int(rest), skip, transient)


def inject(name: str, times: int = 1, skip: int = 0,
           transient: bool = True) -> None:
    """Arm ``name`` to fail its next ``times`` calls (after skipping the
    first ``skip``)."""
    with _lock:
        if not _env_loaded:
            _load_env()
        _arms[name] = _Arm(times, skip, transient)
        _fired.pop(name, None)
        _calls.pop(name, None)


def clear(name: Optional[str] = None) -> None:
    """Disarm one point, or everything (also resets counters)."""
    global _env_loaded
    with _lock:
        if name is None:
            _arms.clear()
            _fired.clear()
            _calls.clear()
            _env_loaded = True          # a full clear overrides the env
        else:
            _arms.pop(name, None)
            _fired.pop(name, None)
            _calls.pop(name, None)


def fired(name: str) -> int:
    """How many times ``name`` actually raised (for test assertions)."""
    with _lock:
        return _fired.get(name, 0)


def calls(name: str) -> int:
    """How many times ``name`` was reached, armed or not."""
    with _lock:
        return _calls.get(name, 0)


def fault_point(name: str) -> None:
    """The injection seam.  No-op unless ``name`` is armed; armed, it
    raises :class:`FaultInjected` for the configured number of calls."""
    with _lock:
        if not _env_loaded:
            _load_env()
        _calls[name] = _calls.get(name, 0) + 1
        arm = _arms.get(name)
        if arm is None:
            return
        if arm.skip > 0:
            arm.skip -= 1
            return
        if arm.times <= 0:
            return
        arm.times -= 1
        _fired[name] = _fired.get(name, 0) + 1
        transient = arm.transient
    raise FaultInjected(name, transient=transient)

