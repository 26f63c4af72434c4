"""TIMETAG-style phase timers.

The reference accumulates per-phase wall time behind a compile-time
``TIMETAG`` flag and prints totals at shutdown: tree-learner phases in
``src/treelearner/serial_tree_learner.cpp:12-39`` and boosting phases in
``src/boosting/gbdt.cpp:22-63``.  As in the JAX package
(``utils/timetag.py``) the switch is the environment:
``LGBM_TPU_TIMETAG=1`` times the boosting phases (``boosting(grad)``,
``tree``, ``score``, ``stump_check``, ``to_host_tree``), and
``LGBM_TPU_TIMETAG=phases`` the tree learner's phases as well
(``tree:init``, ``tree:route``, ``tree:hist``, ``tree:scan``,
``tree:update``); the totals are logged at interpreter exit.

CUDA launches return before the card has run them, so a phase that
launches device work names its device: the tag synchronizes it before
the clock starts (the previous phase's work is not billed to this one)
and before it stops.  Off, a tag does nothing: no synchronization and no
host read.
"""
from __future__ import annotations

import atexit
import collections
import os
import time
from contextlib import contextmanager, nullcontext

_acc = collections.defaultdict(float)
_cnt = collections.defaultdict(int)
_registered = False


def enabled() -> bool:
    return os.environ.get("LGBM_TPU_TIMETAG", "0") not in ("", "0", "false")


def phases_enabled() -> bool:
    """``LGBM_TPU_TIMETAG=phases``: the tree learner's phases are timed
    too (the JAX package runs its waves as separate dispatches then; the
    port's learner launches them one by one anyway)."""
    return os.environ.get("LGBM_TPU_TIMETAG", "") == "phases"


def _sync(device) -> None:
    if device is not None and str(device).startswith("cuda"):
        import torch
        torch.cuda.synchronize(device)


def tag(name: str, device=None):
    """Accumulate the wall time of the enclosed block under ``name``;
    ``device``: the device whose queued work the block waits for on
    both sides (a CUDA device is synchronized, others need nothing).
    Off, a null context."""
    return timed(name, device) if enabled() else nullcontext()


@contextmanager
def timed(name: str, device=None):
    """Accumulate the enclosed block's wall time under ``name``, whatever
    the switch (the caller has checked it)."""
    _ensure_report()
    _sync(device)
    t0 = time.perf_counter()
    try:
        yield
    finally:
        _sync(device)
        _acc[name] += time.perf_counter() - t0
        _cnt[name] += 1


def report() -> str:
    total = sum(_acc.values())
    lines = ["[LightGBM-TPU] [TIMETAG] phase timings:"]
    for name, sec in sorted(_acc.items(), key=lambda kv: -kv[1]):
        pct = 100.0 * sec / total if total else 0.0
        lines.append(f"  {name:<24s} {sec:10.3f}s  {pct:5.1f}%  "
                     f"(n={_cnt[name]})")
    return "\n".join(lines)


def reset() -> None:
    _acc.clear()
    _cnt.clear()


def _ensure_report() -> None:
    global _registered
    if not _registered:
        _registered = True
        from .log import log_info
        atexit.register(lambda: log_info(report()))
