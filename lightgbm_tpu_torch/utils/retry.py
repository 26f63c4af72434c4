"""Shared retry policy: exponential backoff and a deadline.

A copy of the JAX package's ``utils/retry.py`` for the port's seams:
serving (``serve/server.py`` scores each coalesced batch through
:func:`retry_call`), file loading (``loader.read``) and the streamed
block upload (``stream.upload``).  Faults are classified by marker:
RPC-flavoured messages (and the fault harness's ``UNAVAILABLE``) are
transient, and ``RESOURCE_EXHAUSTED`` is deliberately absent, so a
deterministic out-of-memory fails fast.

Every attempt counts into the per-site telemetry counters
(``retry.<site>.attempts`` / ``.retries`` / ``.backoff_s`` and a final
``.recovered`` or ``.exhausted``, ``obs/telemetry.py``), and every retry
is logged at WARNING.  On exhaustion the collective flight recorder's
last-K schedule lands in the summary as ``flight_recorder_dump``
(``obs/flight_recorder.py``): a collective that never recovers usually
has a desynced peer, and the dump names what this rank had issued.
The rendezvous (``rendezvous.connect``) and the host allgathers
(``collective.allgather``) retry through this layer.

Environment knobs (all optional)::

    LGBM_TPU_RETRY_ATTEMPTS=3     total attempts (first try included)
    LGBM_TPU_RETRY_BASE_S=1.0     first backoff sleep, seconds
    LGBM_TPU_RETRY_MAX_S=30.0     per-sleep cap
    LGBM_TPU_RETRY_DEADLINE_S=0   overall budget; 0 = no deadline
    LGBM_TPU_RETRY_JITTER=0.1     uniform jitter fraction on each sleep
"""
from __future__ import annotations

import os
import random
import time
from dataclasses import dataclass
from typing import Callable, Optional, Tuple

from ..obs import counter_add
from .log import log_warning

# NOTE: no RESOURCE_EXHAUSTED — see module docstring
TRANSIENT_MARKERS: Tuple[str, ...] = (
    "UNAVAILABLE", "DEADLINE_EXCEEDED", "Connection reset", "Broken pipe",
    "Socket closed", "Connection refused", "Connection timed out",
    "failed to connect", "Unable to connect")


def is_transient(exc: BaseException) -> bool:
    """Whether ``exc`` looks like a fault worth retrying."""
    msg = str(exc)
    return any(m in msg for m in TRANSIENT_MARKERS)


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, default))
    except ValueError:
        return default


@dataclass
class RetryPolicy:
    """Backoff shape: ``attempts`` total tries, sleeps of
    ``base_s * 2**k`` (capped at ``max_s``, jittered) between them, all
    inside an optional ``deadline_s`` wall-clock budget."""
    attempts: int = 3
    base_s: float = 1.0
    max_s: float = 30.0
    deadline_s: float = 0.0          # 0 = unbounded
    jitter: float = 0.1

    @classmethod
    def from_env(cls, **overrides) -> "RetryPolicy":
        p = cls(
            attempts=int(_env_float("LGBM_TPU_RETRY_ATTEMPTS", 3)),
            base_s=_env_float("LGBM_TPU_RETRY_BASE_S", 1.0),
            max_s=_env_float("LGBM_TPU_RETRY_MAX_S", 30.0),
            deadline_s=_env_float("LGBM_TPU_RETRY_DEADLINE_S", 0.0),
            jitter=_env_float("LGBM_TPU_RETRY_JITTER", 0.1))
        for k, v in overrides.items():
            setattr(p, k, v)
        return p

    def sleep_s(self, attempt: int) -> float:
        """Backoff before retry number ``attempt`` (0-based failure
        index), jittered."""
        s = min(self.base_s * (2.0 ** attempt), self.max_s)
        if self.jitter > 0:
            # the draw shapes only sleep durations, never model state
            s *= 1.0 + self.jitter * random.random()
        return s


# seam for tests (monkeypatch to skip real sleeping)
_sleep = time.sleep


def retry_call(fn: Callable, *args,
               policy: Optional[RetryPolicy] = None,
               retryable: Callable[[BaseException], bool] = is_transient,
               what: str = "operation",
               **kwargs):
    """Call ``fn(*args, **kwargs)``, retrying retryable failures with
    exponential backoff until the attempt count or deadline runs out.
    Non-retryable exceptions propagate immediately; on exhaustion the
    LAST retryable exception is re-raised (the caller sees the real
    fault, not a wrapper)."""
    p = policy or RetryPolicy.from_env()
    t0 = time.monotonic()
    last: Optional[BaseException] = None
    for attempt in range(max(1, p.attempts)):
        counter_add(f"retry.{what}.attempts")
        try:
            out = fn(*args, **kwargs)
            if attempt > 0:
                counter_add(f"retry.{what}.recovered")
            return out
        except Exception as exc:        # noqa: BLE001 - filtered below
            if not retryable(exc):
                raise
            last = exc
            final = attempt >= p.attempts - 1
            if not final and p.deadline_s > 0 and (
                    time.monotonic() - t0 >= p.deadline_s):
                log_warning(f"{what}: retry deadline "
                            f"({p.deadline_s:.1f}s) exceeded")
                break
            if not final:               # no false "retrying" + sleep on
                s = p.sleep_s(attempt)  # the final failure
                if p.deadline_s > 0:
                    s = min(s, max(0.0, p.deadline_s
                                   - (time.monotonic() - t0)))
                log_warning(
                    f"transient failure in {what} (attempt "
                    f"{attempt + 1}/{p.attempts}), retrying in "
                    f"{s:.1f}s: {str(exc)[:200]}")
                counter_add(f"retry.{what}.retries")
                counter_add(f"retry.{what}.backoff_s", s)
                _sleep(s)
    counter_add(f"retry.{what}.exhausted")
    from ..obs.flight_recorder import dump_to_summary
    dump_to_summary(f"retry.{what}.exhausted")
    raise last


def retrying(fn: Callable, policy: Optional[RetryPolicy] = None,
             retryable: Callable[[BaseException], bool] = is_transient,
             what: Optional[str] = None) -> Callable:
    """Wrap ``fn`` so every call goes through :func:`retry_call`."""
    label = what or getattr(fn, "__name__", "operation")

    def wrapped(*args, **kwargs):
        return retry_call(fn, *args, policy=policy, retryable=retryable,
                          what=label, **kwargs)
    wrapped.__name__ = getattr(fn, "__name__", "wrapped")
    return wrapped
