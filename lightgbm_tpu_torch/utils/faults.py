"""Fault injection: named failure points for robustness tests.

A copy of the JAX package's ``utils/faults.py`` for the port's seams:

* ``snapshot.write`` — mid-file during a snapshot's model write
  (``utils/file_io.atomic_write`` with ``chunks=2``,
  ``boosting/snapshot.py``): a preemption while serializing;
* ``serve.score`` — the serving harness's batched device scoring
  (``serve/server.py``); retried by the shared policy
  (``utils/retry.py``), and the delivery contract (exactly once per
  request) must hold across the retry;
* ``loader.read`` — opening a data file (``io/loader.py``: a flaky
  remote filesystem); retried by the shared policy;
* ``stream.upload`` — a streamed block's host -> device copy
  (``boosting/streaming.py``), before the copy is issued; retried by
  the shared policy, so a retried upload never tears a fold;
* ``rendezvous.connect`` — the process-group handshake
  (``parallel/mesh.py:init_distributed``): a coordinator that is not up
  yet; retried by the shared policy;
* ``collective.allgather`` — a host allgather
  (``io/distributed.py``), before it touches any rank-synchronization
  state; retried by the shared policy;
* ``spmd.skip_record`` — drops one collective flight-recorder record
  (``obs/flight_recorder.py``): the rank-divergent schedule the
  cross-rank check must localize.

Silent faults are read through :func:`fault_flag`, which never raises:

* ``det.rng_drift`` — DART's keyed drop derivation consumes the next
  iteration's draws (``boosting/variants.py``): the RNG drift the
  determinism contract (``obs/determinism.py``) must localize;
* ``watchdog.stall`` — the iteration or serve batch armed on the stall
  watchdog sleeps past its deadline (``obs/health.stall_fault``);
* ``health.nan_grad`` — one gradient element becomes NaN
  (``GBDT.gradients``), for the numerics sentinels (``obs/health.py``);
* ``mem.leak`` — the training loop keeps one fresh device tensor an
  iteration in a module-level sink (``boosting/gbdt.py``), for the
  memory contract (``obs/mem_contract.py``);
* ``lock.slow_hold`` — a contract-named lock is held 50 ms longer
  (``obs/lock_contract.py``);
* ``num.reassoc`` — the canonical chunked root reduction of
  ``learner/serial.py:root_stats`` becomes a plain ``torch.sum``, for
  the ulp contract (``obs/num_contract.py``).
* ``collective.hang`` — a host collective under a deadline sleeps past
  it (``io/distributed.py:deadline_call``, the elastic client's
  allgathers), so the deadline raises ``RankLostError``;
* ``rendezvous.drop_rank`` — the elastic coordinator's monitor
  (``parallel/elastic.py``) evicts its newest member as if its
  heartbeats had stopped: a lost rank without killing a process, so
  in-process tests drive generation bumps and recovery;
* ``heartbeat.miss`` — the elastic client's heartbeat thread skips a
  beat while armed; enough armed shots and the coordinator evicts the
  member (the dead-rank signal), a few and it survives;
* ``collective.slow`` — the elastic client sleeps
  ``LGBM_TPU_COLLECTIVE_SLOW`` seconds (default 0.25, clamped below the
  collective deadline) before it enters an allgather: a straggler
  without a failure, which the fleet's wait accounting must name.

Each point is a single ``fault_point(name)`` call that is a no-op unless
armed.  Tests arm points programmatically (:func:`inject`, :func:`clear`);
operators can arm them from the environment for chaos runs::

    LGBM_TPU_FAULTS="serve.score:2"

fires the first 2 calls.  ``name:times`` or ``name:times@skip`` (skip the
first ``skip`` calls).  Injected failures raise :class:`FaultInjected`,
whose message carries the ``UNAVAILABLE`` transient marker so the retry
layer classifies it like a real RPC fault; arm with ``!`` after the
count (``name:1!``) for a NON-transient fault that must pass straight
through the retry layer.  A fired point counts into
``faults.<name>.fired`` and emits a ``fault:<name>`` event
(``obs/telemetry.py``).
"""
from __future__ import annotations

import os
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


def _named_lock(name: str):
    # lazy: lock_contract imports only the stdlib, so this module at the
    # bottom of the import graph can take a contract-named lock
    from ..obs.lock_contract import named_lock
    return named_lock(name)


_lock = _named_lock("faults")
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
    from ..obs import counter_add, event
    counter_add(f"faults.{name}.fired")
    event("fault", name, transient=transient)
    raise FaultInjected(name, transient=transient)



def fault_flag(name: str) -> bool:
    """Non-raising form of :func:`fault_point` for silent faults: True
    when the armed point fires (consuming one shot, with the same
    counters and event), False otherwise."""
    try:
        fault_point(name)
    except FaultInjected:
        return True
    return False


def armed() -> bool:
    """Whether any point is armed (one dict read: the hot-path guard of
    points that are otherwise never reached)."""
    if not _env_loaded:
        with _lock:
            if not _env_loaded:
                _load_env()
    return bool(_arms)

