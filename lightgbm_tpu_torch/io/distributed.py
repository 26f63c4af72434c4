"""Distributed ingest and host collectives.

Port of the JAX package's ``io/distributed.py`` (reference distributed
loading, ``dataset_loader.cpp:744-993``).  With rows sharded across
ranks no rank sees the whole value distribution, so

1. the usable feature count is synced to the minimum across ranks
   (``GlobalSyncUpByMin``, ``dataset_loader.cpp:821``),
2. each rank finds the bin mappers of ITS feature slice from its local
   rows (``:816-858``),
3. the serialized mappers are allgathered, so every rank holds the same
   full mapper list (``:860-880``).

The collective is injectable: :class:`ThreadedAllgather` (a world of
threads, for tests) or :func:`process_allgather` (the process group of
``parallel/mesh.py``, the counterpart of the JAX package's
``jax_process_allgather``).  Host collectives run under a deadline
(``LGBM_TPU_COLLECTIVE_DEADLINE_S``, :func:`deadline_call`): a rank that
stops participating raises :class:`RankLostError` instead of hanging the
job.  The ``ExternalCollectives`` C-function backend of the JAX package
has one caller, the C API, and comes with it (ROADMAP A14).
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import Callable, List, Optional, Sequence

import numpy as np

from ..config import Config
from .binning import BIN_CATEGORICAL, BIN_NUMERICAL, BinMapper

# allgather: (obj) -> list of every rank's obj, rank-ordered
AllgatherFn = Callable[[object], List[object]]


class RankLostError(RuntimeError):
    """A host collective blew its deadline: some rank stopped
    participating (dead, or wedged past ``LGBM_TPU_COLLECTIVE_DEADLINE_S``).
    Typed so that the elastic recovery loop
    (``boosting/streaming.py:train_elastic``) can re-rendezvous instead
    of the whole job blocking forever.  Not
    transient for the retry layer: retrying into the same dead world
    just burns another deadline."""

    def __init__(self, site: str, deadline_s: float, detail: str = ""):
        self.site = site
        self.deadline_s = float(deadline_s)
        msg = (f"collective {site!r} exceeded its {deadline_s:g}s "
               f"deadline; a rank is lost or wedged")
        if detail:
            msg += f" ({detail})"
        super().__init__(msg)


def collective_deadline_s() -> Optional[float]:
    """The host-collective deadline from ``LGBM_TPU_COLLECTIVE_DEADLINE_S``
    (seconds; unset/non-positive = block forever, the pre-elastic
    behavior)."""
    raw = os.environ.get("LGBM_TPU_COLLECTIVE_DEADLINE_S", "")
    if not raw:
        return None
    try:
        s = float(raw)
    except ValueError:
        return None
    return s if s > 0 else None


def deadline_call(fn: Callable, site: str,
                  deadline: Optional[float] = None):
    """Run ``fn()`` under the collective deadline: the call executes in
    a worker thread and a result must land within ``deadline`` seconds
    or a typed :class:`RankLostError` is raised (the blocked thread is
    daemonic and abandoned — a wedged collective cannot be cancelled from
    Python, but the caller gets control back).

    The ``collective.hang`` fault point fires here as a *silent* sleep
    past the deadline (``utils/faults.fault_flag``) — it exercises
    detection (the deadline path), unlike ``collective.allgather`` which
    raises and exercises retry.  With no deadline configured the call
    runs inline, zero overhead."""
    from ..utils.faults import fault_flag
    if deadline is None:
        deadline = collective_deadline_s()
    hang = fault_flag("collective.hang")
    if deadline is None:
        if hang:
            time.sleep(0.05)        # armed but undeadlined: token stall
        return fn()
    done = threading.Event()
    box: dict = {}

    def run():
        if hang:
            # sleep PAST the deadline, then still complete: the caller
            # must already have raised — detection, not data loss
            time.sleep(deadline * 1.5 + 0.05)
        try:
            box["value"] = fn()
        # not swallowed: the caller re-raises box["error"] after
        # done.wait() (unless the deadline already fired, in which case
        # RankLostError preempted this result)
        except BaseException as exc:    # noqa: BLE001
            box["error"] = exc
        finally:
            done.set()

    t = threading.Thread(target=run, name=f"lgbm-tpu-collective-{site}",
                         daemon=True)
    t.start()
    if not done.wait(deadline):
        from ..obs import counter_add, event
        counter_add("collective.deadline_exceeded")
        event("elastic", "rank_lost", site=site, deadline_s=deadline)
        raise RankLostError(site, deadline)
    # success path: `done` is set so the worker is past its useful
    # life — reap it (only the deadline path above abandons the
    # daemonized thread, by design)
    t.join(timeout=1.0)
    if "error" in box:
        raise box["error"]
    return box["value"]


class ThreadedAllgather:
    """Barrier-synchronized in-process allgather for a thread-per-rank
    world (the tests' stand-in for a process group)."""

    def __init__(self, world: int):
        self.world = world
        self._barrier = threading.Barrier(world)
        self._buf: List[object] = [None] * world

    def for_rank(self, rank: int) -> AllgatherFn:
        def allgather(obj):
            self._buf[rank] = obj
            self._barrier.wait()
            out = list(self._buf)
            self._barrier.wait()
            return out
        return allgather


def process_allgather(obj) -> List[object]:
    """Allgather of a picklable object over the process group (one entry
    per rank, in rank order; ``[obj]`` without a group), retried on
    transient failures with the ``collective.allgather`` fault point in
    front, under the collective deadline.

    Each rank's entry wall-clock rides the payload, so every rank learns
    the arrival spread from the gather itself: the span carries
    ``wait_s`` (blocked on the last arrival) and ``xfer_s``, and the
    fleet accounting (``obs/fleet.py``) counts the site's waves and
    stragglers.  One flight-recorder record per logical call (a retried
    rank joins the same collective late; it does not issue a new one);
    payload sizes differ per rank, so only the site and op enter the
    fingerprint."""
    from ..obs import enabled as obs_enabled
    from ..obs import fleet, span
    from ..obs.flight_recorder import record as fr_record
    from ..parallel.mesh import is_initialized, rank_world
    from ..utils.faults import fault_point
    from ..utils.retry import retry_call
    if not is_initialized():
        return [obj]
    import torch.distributed as dist
    rank, world = rank_world()
    site = "io.distributed.process_allgather"

    def _gather():
        fault_point("collective.allgather")
        out: List = [None] * world
        dist.all_gather_object(out, {"_fleet_us": entry_us, "o": obj})
        return out

    fr_record(site, "process_allgather")
    seq = fleet.next_seq(site)
    with span("collective.allgather", site=site, seq=seq) as sp:
        entry_us = int(time.time() * 1e6)
        t0 = time.perf_counter()
        parts = deadline_call(
            lambda: retry_call(_gather, what="collective.allgather"), site)
        dur = time.perf_counter() - t0
        ents = [int(p["_fleet_us"]) for p in parts]
        last = max(ents)
        wait = max((last - entry_us) / 1e6, 0.0)
        straggler = ents.index(last)
        sp["wait_s"] = round(wait, 6)
        sp["xfer_s"] = round(max(dur - wait, 0.0), 6)
        sp["arrive_ts"] = entry_us / 1e6
        sp["straggler_rank"] = straggler
        if obs_enabled():
            fleet.note_collective(site, -1, seq, wait,
                                  max(dur - wait, 0.0), -1,
                                  straggler == rank)
    return [p["o"] for p in parts]


def find_bins_distributed(X_local: np.ndarray,
                          config: Config,
                          rank: int,
                          num_machines: int,
                          allgather: AllgatherFn,
                          categorical_features: Sequence[int] = ()
                          ) -> List[BinMapper]:
    """Feature-sharded distributed bin finding -> full mapper list,
    identical on every rank (`dataset_loader.cpp:816-880`).

    Whatever collective backend the caller injects is wrapped in the
    shared retry policy, with the ``collective.allgather`` fault point
    in front — the seam the fault-injection tests drive.  The fault
    fires BEFORE the backend touches any rank-synchronization state, so
    a retried rank simply joins the collective late (the
    ThreadedAllgather barrier and the reference's blocking sockets both
    tolerate that)."""
    from ..obs import enabled as obs_enabled
    from ..obs import fleet, span
    from ..obs.flight_recorder import record as fr_record
    from ..utils.faults import fault_point
    from ..utils.retry import retrying
    inner = allgather
    site = "io.distributed.binfind_allgather"

    def _ag(obj):
        fault_point("collective.allgather")
        return inner(obj)

    _retry_ag = retrying(_ag, what="collective.allgather")

    # distinct span name: with process_allgather injected the transport
    # times itself under "collective.allgather"; this one must not
    # double-count into the same bucket.  The payload rides wrapped as
    # {"_fleet_us": <entry wall-clock>, "o": obj} — every backend passes
    # dicts through unchanged, so each rank learns the full arrival
    # spread from the gather itself
    def allgather(obj):
        fr_record(site, "allgather")
        seq = fleet.next_seq(site)
        entry_us = int(time.time() * 1e6)
        with span("collective.binfind", site=site, seq=seq) as sp:
            t0 = time.perf_counter()
            parts = deadline_call(
                lambda: _retry_ag({"_fleet_us": entry_us, "o": obj}),
                site)
            dur = time.perf_counter() - t0
            try:
                ents = [int(p["_fleet_us"]) for p in parts]
                objs = [p["o"] for p in parts]
            except (TypeError, KeyError, ValueError):
                return parts    # a backend that rewrites payloads
            last = max(ents)
            wait = max((last - entry_us) / 1e6, 0.0)
            straggler = ents.index(last)
            sp["wait_s"] = round(wait, 6)
            sp["xfer_s"] = round(max(dur - wait, 0.0), 6)
            sp["arrive_ts"] = entry_us / 1e6
            sp["straggler_rank"] = straggler
            if obs_enabled():
                try:
                    nbytes = len(json.dumps(obj).encode())
                except (TypeError, ValueError):
                    nbytes = -1
                sp["bytes"] = nbytes
                fleet.note_collective(site, -1, seq, wait,
                                      max(dur - wait, 0.0), nbytes,
                                      straggler == rank)
        return objs
    cat_set = set(int(c) for c in categorical_features)
    # 1. sync feature count to the min across ranks (:821)
    counts = allgather(int(X_local.shape[1]))
    F = min(int(c) for c in counts)

    # 2. local bin finding for this rank's feature slice (:816-858)
    f_per = -(-F // num_machines)
    start = min(rank * f_per, F)
    end = min(start + f_per, F)
    sample_cnt = min(len(X_local), config.bin_construct_sample_cnt)
    rng = np.random.RandomState(config.data_random_seed + rank)
    idx = (np.arange(len(X_local)) if sample_cnt >= len(X_local)
           else np.sort(rng.choice(len(X_local), sample_cnt, replace=False)))
    local = []
    for f in range(start, end):
        m = BinMapper()
        col = X_local[idx, f].astype(np.float64)
        if f in cat_set:
            m.find_bin(col[~np.isnan(col)], len(col), config.max_bin,
                       config.min_data_in_bin, bin_type=BIN_CATEGORICAL,
                       use_missing=config.use_missing,
                       zero_as_missing=config.zero_as_missing)
        else:
            nz = col[(col != 0.0) | np.isnan(col)]
            m.find_bin(nz, len(col), config.max_bin, config.min_data_in_bin,
                       bin_type=BIN_NUMERICAL, use_missing=config.use_missing,
                       zero_as_missing=config.zero_as_missing)
        local.append((f, m.to_dict()))

    # 3. allgather serialized mappers; every rank rebuilds the full list
    #    (:860-880 — the reference ships fixed-size byte blocks; here
    #    (feature, dict) pairs go through the injected collective)
    parts = allgather(local)
    full: List[Optional[BinMapper]] = [None] * F
    for part in parts:
        for f, d in part:
            full[int(f)] = BinMapper.from_dict(d)
    missing = [f for f, m in enumerate(full) if m is None]
    if missing:
        raise RuntimeError(f"distributed bin finding left features "
                           f"{missing} unmapped")
    return full
