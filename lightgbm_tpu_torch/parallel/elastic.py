"""Elastic rendezvous: generation-numbered membership and host collectives.

A copy of the JAX package's ``parallel/elastic.py``, whose wire format it
keeps byte for byte: a JAX client and a port client can share one
coordinator.  The reference's YARN application master hands every
worker the machine list once (``linkers_socket.cpp:27-68``) and never
updates it, so a dead rank hangs the first collective and the job dies
with its snapshots unused.  This module makes that machine list a
restartable protocol:

* **Generations**: the coordinator numbers every membership view.  Each
  (re)join returns ``(world_size, rank, generation)``; any membership
  change (a join, a clean leave, a heartbeat eviction) bumps the
  generation and fails every in-flight and later collective of the old
  one with :class:`GenerationChanged`, so survivors unwind to the
  recovery loop (``boosting/streaming.py:train_elastic``) instead of
  waiting on a member that is gone.
* **Rank-failure detection**, two signals.  Heartbeats (every
  ``LGBM_TPU_HEARTBEAT_S``) carry the rank's live health state
  (``obs/health.py``); the coordinator evicts a member only when its
  heartbeats stop.  A rank whose watchdog reports ``stalled`` but whose
  heartbeat thread lives is wedged but alive and is not evicted (killing
  it is the operator's call).  And every client collective is bounded by
  ``LGBM_TPU_COLLECTIVE_DEADLINE_S`` and raises the typed
  :class:`~lightgbm_tpu_torch.io.distributed.RankLostError` instead of
  blocking: the backstop for a dead coordinator or an eviction slower
  than the deadline.
* **Rank-ordered collectives**: ``allgather`` is the only primitive
  (a barrier is an allgather of a tag).  Contributions are keyed
  ``(generation, seq)`` and come back in rank order; ranks are the
  members sorted by member id, so the streamed trainer can combine
  per-shard partials in shard order whichever rank computed them.

Transport: one JSON line per request over TCP; numpy payloads travel as
base64 ``.npy`` bytes (:func:`encode_array`).  The module needs neither
torch nor a device, so the protocol tests run anywhere.

Fault points (``utils/faults.py``): ``rendezvous.drop_rank`` makes the
coordinator's monitor evict its newest member (a lost rank without a
killed process), ``heartbeat.miss`` makes a client skip beats,
``collective.hang`` (here and in ``io/distributed.py:deadline_call``)
stalls a collective past the deadline, ``collective.slow`` delays one
rank's contribution below the deadline (``LGBM_TPU_COLLECTIVE_SLOW``
seconds): the straggler the fleet's wait accounting must name.
"""
from __future__ import annotations

import base64
import io
import json
import os
import socket
import socketserver
import threading
import time
import uuid
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..io.distributed import RankLostError, collective_deadline_s
from ..obs import counter_add, event, gauge_set, span
from ..obs import fleet as obs_fleet
from ..utils.log import log_info, log_warning

__all__ = [
    "ElasticCoordinator", "ElasticClient", "ElasticRun",
    "GenerationChanged", "RankLostError", "ELASTIC_INTERRUPTS",
    "heartbeat_s", "elastic_address", "encode_array", "decode_array",
]


class GenerationChanged(RuntimeError):
    """The membership changed under an in-flight collective: the old
    generation's world no longer exists.  Survivors re-rendezvous and
    resume from the last committed barrier snapshot."""

    def __init__(self, generation: int, detail: str = ""):
        self.generation = int(generation)
        msg = (f"elastic membership changed (now generation "
               f"{generation}); in-flight collectives are invalid")
        if detail:
            msg += f": {detail}"
        super().__init__(msg)


class EvictedError(RuntimeError):
    """This member was evicted (missed heartbeats); it must re-join as
    a fresh member to participate again."""


# what the recovery loop catches: lost peers, lost epochs.  (Evicted
# members also recover — by re-joining as a new member.)
ELASTIC_INTERRUPTS = (RankLostError, GenerationChanged, EvictedError)


def heartbeat_s() -> float:
    """Heartbeat interval from ``LGBM_TPU_HEARTBEAT_S`` (default 0.5 s;
    eviction timeout defaults to 5 intervals, coordinator-side)."""
    try:
        s = float(os.environ.get("LGBM_TPU_HEARTBEAT_S", "0.5"))
    except ValueError:
        return 0.5
    return s if s > 0 else 0.5


def elastic_address() -> Optional[str]:
    """``LGBM_TPU_ELASTIC`` — the coordinator's ``host:port``.  Doubles
    as the elastic on/off switch: unset means classic fixed-world
    training."""
    return os.environ.get("LGBM_TPU_ELASTIC") or None


def encode_array(arr: np.ndarray) -> str:
    """numpy array -> base64 ``.npy`` bytes (dtype+shape travel with
    the payload; bitwise round-trip)."""
    buf = io.BytesIO()
    np.save(buf, np.ascontiguousarray(arr), allow_pickle=False)
    return base64.b64encode(buf.getvalue()).decode("ascii")


def decode_array(text: str) -> np.ndarray:
    return np.load(io.BytesIO(base64.b64decode(text.encode("ascii"))),
                   allow_pickle=False)


# ---------------------------------------------------------------------------
# coordinator
# ---------------------------------------------------------------------------
class _Member:
    __slots__ = ("member", "joined_seq", "last", "state", "detail")

    def __init__(self, member: str, joined_seq: int):
        self.member = member
        self.joined_seq = joined_seq
        self.last = time.monotonic()
        self.state = ""
        self.detail: Dict[str, Any] = {}


class ElasticCoordinator:
    """The rendezvous + collective server (the YARN-AM analog, run
    in-process by the launcher — ``tools/chaos_torch.py`` — or
    standalone).

    One instance serves one training job.  Thread-per-connection; all
    state under one condition variable.  ``start()`` returns the bound
    ``host:port`` for ``LGBM_TPU_ELASTIC``."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 heartbeat_timeout_s: Optional[float] = None,
                 ledger_path: Optional[str] = None):
        self.heartbeat_timeout_s = (heartbeat_timeout_s
                                    if heartbeat_timeout_s is not None
                                    else heartbeat_s() * 5)
        # the SIGKILL-survivable fleet history (obs/fleet.FleetLedger):
        # every membership change and completed collective round,
        # fsync'd line-at-a-time.  Off unless a path is given
        # (LGBM_TPU_FLEET_LEDGER or the constructor)
        path = ledger_path or obs_fleet.ledger_path_env()
        self._ledger = obs_fleet.FleetLedger(path) if path else None
        from ..obs.lock_contract import named_condition
        self._cv = named_condition("elastic_coord")
        self._members: Dict[str, _Member] = {}   # member id -> _Member
        self._generation = 0
        self._join_seq = 0
        # (generation, seq) -> {rank: payload}; results cached until the
        # last member of the round has read them.  _touch records each
        # round's last contribution: a legitimate round completes and
        # drains within one client deadline of it, so a round idle for
        # several deadlines was abandoned (its members timed out
        # client-side and retry under fresh keys after resync) and the
        # monitor ages it out to keep coordinator memory bounded.
        self._rounds: Dict[Tuple[int, int], Dict[int, Any]] = {}
        self._reads: Dict[Tuple[int, int], int] = {}
        self._touch: Dict[Tuple[int, int], float] = {}
        # per-round arrival wall-clocks {key: {rank: ts}} — ONE clock
        # (the coordinator's), so the returned per-rank arrival list is
        # directly comparable and each client derives its wait_s from
        # it without any cross-rank clock agreement
        self._arrivals: Dict[Tuple[int, int], Dict[int, float]] = {}
        self._round_sites: Dict[Tuple[int, int], str] = {}
        self._gauge_ranks = 0        # high-water of per-rank age gauges
        self._deadline_hint = 0.0    # max client deadline seen on the wire
        self._stop = False
        coord = self

        class Handler(socketserver.StreamRequestHandler):
            def handle(self):
                try:
                    line = self.rfile.readline()
                    if not line:
                        return
                    req = json.loads(line.decode())
                    resp = coord._dispatch(req)
                # not swallowed: the error goes onto the wire and
                # ElasticClient._check raises it on the client
                except Exception as exc:    # noqa: BLE001
                    resp = {"ok": False, "error": f"{type(exc).__name__}: "
                                                  f"{exc}"}
                try:
                    self.wfile.write(json.dumps(resp).encode() + b"\n")
                except OSError:
                    pass                    # client gave up (deadline)

        class Server(socketserver.ThreadingTCPServer):
            daemon_threads = True
            allow_reuse_address = True

        self._server = Server((host, port), Handler)
        self.host, self.port = self._server.server_address[:2]
        self._threads: List[threading.Thread] = []

    @property
    def address(self) -> str:
        return f"{self.host}:{self.port}"

    def start(self) -> str:
        # the coordinator is the fleet's authoritative observer: give
        # it its own scrapeable /metrics (gated on LGBM_TPU_OPS_PORT,
        # same as every other owner; idempotent if the launcher
        # already mounted one)
        from ..obs import ops_plane
        ops_plane.mount("elastic-coordinator")
        t = threading.Thread(target=self._server.serve_forever,
                             name="lgbm-tpu-elastic-coord", daemon=True)
        t.start()
        m = threading.Thread(target=self._monitor,
                             name="lgbm-tpu-elastic-monitor", daemon=True)
        m.start()
        self._threads = [t, m]
        self._ledger_put("coordinator_start", address=self.address,
                         heartbeat_timeout_s=self.heartbeat_timeout_s)
        log_info(f"elastic coordinator listening on {self.address}")
        return self.address

    def stop(self) -> None:
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        self._server.shutdown()
        self._server.server_close()
        # bounded-shutdown contract: every spawned thread gets a
        # join(timeout) — the server thread exits with shutdown(), the
        # monitor wakes on the notify above and sees _stop
        for t in self._threads:
            t.join(timeout=5.0)
        self._threads = []
        self._ledger_put("coordinator_stop")
        if self._ledger is not None:
            self._ledger.close()

    def _ledger_put(self, kind: str, **fields: Any) -> None:
        if self._ledger is not None:
            self._ledger.put_line(kind, **fields)

    # -- introspection (tests, the chaos launcher's kill scheduler) ----
    def membership(self) -> Dict[str, Any]:
        with self._cv:
            ranks = self._ranks()
            return {
                "generation": self._generation,
                "world": len(ranks),
                "members": [
                    {"member": m.member, "rank": ranks[m.member],
                     "state": m.state, "detail": dict(m.detail),
                     "age_s": time.monotonic() - m.last}
                    for m in sorted(self._members.values(),
                                    key=lambda x: x.joined_seq)],
            }

    # -- internals -----------------------------------------------------
    def _ranks(self) -> Dict[str, int]:
        """member id -> rank: contiguous 0..W-1 in sorted member-id
        order — a pure function of the membership SET, so concurrent
        joiners racing into the same generation get the same rank map
        no matter which socket thread lands first (the join-order
        scheme this replaces handed out ranks by arrival, which two
        deflaked tests had to poll around).  A shrink re-ranks
        survivors — every rank map is per-generation and clients
        re-learn theirs on resync.  Caller holds ``_cv``."""
        return {m: r for r, m in enumerate(sorted(self._members))}

    def _bump(self, why: str, **attrs) -> None:
        """Membership changed: new generation, fail the old one's
        rounds.  Caller holds ``_cv``."""
        self._generation += 1
        self._rounds = {k: v for k, v in self._rounds.items()
                        if k[0] >= self._generation}
        self._reads = {k: v for k, v in self._reads.items()
                       if k[0] >= self._generation}
        self._touch = {k: v for k, v in self._touch.items()
                       if k[0] >= self._generation}
        self._arrivals = {k: v for k, v in self._arrivals.items()
                          if k[0] >= self._generation}
        self._round_sites = {k: v for k, v in self._round_sites.items()
                             if k[0] >= self._generation}
        counter_add("elastic.generation_bumps")
        event("elastic", why, generation=self._generation,
              world=len(self._members), **attrs)
        self._ledger_put(why, generation=self._generation,
                         world=len(self._members), **attrs)
        self._cv.notify_all()

    def _monitor(self) -> None:
        from ..utils.faults import fault_flag
        tick = max(self.heartbeat_timeout_s / 4.0, 0.02)
        while True:
            with self._cv:
                if self._stop:
                    return
                now = time.monotonic()
                dead = [m for m in self._members.values()
                        if now - m.last > self.heartbeat_timeout_s]
                if not dead and fault_flag("rendezvous.drop_rank"):
                    # the injected lost-rank: drop the newest member
                    live = sorted(self._members.values(),
                                  key=lambda m: m.joined_seq)
                    if live:
                        dead = [live[-1]]
                # age out abandoned rounds: every contributor gives up
                # at most one client deadline after its contribution,
                # so a round idle for several deadlines has no live
                # client left (survivors retry under fresh keys)
                stale_after = max(self._deadline_hint * 3,
                                  self.heartbeat_timeout_s * 4, 2.0)
                for key in [k for k, ts in self._touch.items()
                            if now - ts > stale_after]:
                    self._rounds.pop(key, None)
                    self._reads.pop(key, None)
                    self._touch.pop(key, None)
                    self._arrivals.pop(key, None)
                    self._round_sites.pop(key, None)
                    counter_add("elastic.rounds_aged_out")
                # ops-plane gauges: the coordinator's own state, every
                # tick (world size, generation, open rounds, per-rank
                # heartbeat age; ranks beyond the current world read -1
                # so a shrink is visible, not a stale flatline)
                ranks = self._ranks()
                gauge_set("elastic.world_size", len(ranks))
                gauge_set("elastic.generation", self._generation)
                gauge_set("elastic.open_rounds", len(self._rounds))
                for m in self._members.values():
                    gauge_set(f"elastic.heartbeat_age_s.rank{ranks[m.member]}",
                              round(now - m.last, 3))
                for r in range(len(ranks), self._gauge_ranks):
                    gauge_set(f"elastic.heartbeat_age_s.rank{r}", -1)
                self._gauge_ranks = max(self._gauge_ranks, len(ranks))
                for m in dead:
                    ranks = self._ranks()
                    lost_rank = ranks.get(m.member, -1)
                    del self._members[m.member]
                    counter_add("elastic.evictions")
                    log_warning(
                        f"elastic: rank {lost_rank} ({m.member}) lost "
                        f"(no heartbeat for {now - m.last:.2f}s); "
                        f"world {len(self._members) + 1} -> "
                        f"{len(self._members)}")
                    self._bump("rank_lost", rank=lost_rank,
                               member=m.member,
                               last_state=m.state or "unknown",
                               age_s=round(now - m.last, 3))
                self._cv.wait(tick)

    def _dispatch(self, req: Dict[str, Any]) -> Dict[str, Any]:
        op = req.get("op")
        if op == "join":
            return self._op_join(req)
        if op == "sync":
            return self._op_sync(req)
        if op == "allgather":
            return self._op_allgather(req)
        if op == "heartbeat":
            return self._op_heartbeat(req)
        if op == "leave":
            return self._op_leave(req)
        if op == "info":
            return {"ok": True, **self.membership()}
        if op == "clock":
            # the clock-alignment probe: no membership check (a joiner
            # syncs before it has a rank), no state touched — just the
            # coordinator's wall clock for midpoint-of-RTT estimation
            return {"ok": True, "server_ts": time.time()}
        return {"ok": False, "error": f"unknown op {op!r}"}

    def _view(self, member: str) -> Dict[str, Any]:
        ranks = self._ranks()
        return {"ok": True, "world": len(ranks),
                "rank": ranks.get(member, -1),
                "generation": self._generation}

    def _op_join(self, req) -> Dict[str, Any]:
        member = req["member"]
        min_world = int(req.get("min_world", 1))
        with self._cv:
            if member not in self._members:
                self._join_seq += 1
                self._members[member] = _Member(member, self._join_seq)
                counter_add("elastic.joins")
                self._bump("join", member=member)
                rank = self._ranks()[member]
                log_info(f"elastic: member {member} joined as rank "
                         f"{rank} (world {len(self._members)}, "
                         f"generation {self._generation})")
            # hold until the world is big enough (initial formation); a
            # member waiting here is alive, and its heartbeat starts only
            # when the join returns, so the wait keeps it fresh (else a
            # peer that starts a heartbeat timeout later evicts it;
            # ROADMAP C36)
            while len(self._members) < min_world \
                    and member in self._members and not self._stop:
                self._members[member].last = time.monotonic()
                self._cv.wait(0.2)
            if member not in self._members:
                return {"ok": False, "error": "evicted"}
            return self._view(member)

    def _op_sync(self, req) -> Dict[str, Any]:
        with self._cv:
            if req["member"] not in self._members:
                return {"ok": False, "error": "evicted"}
            return self._view(req["member"])

    def _op_heartbeat(self, req) -> Dict[str, Any]:
        with self._cv:
            m = self._members.get(req["member"])
            if m is None:
                return {"ok": False, "error": "evicted"}
            m.last = time.monotonic()
            m.state = str(req.get("state", ""))
            m.detail = dict(req.get("detail") or {})
            return self._view(req["member"])

    def _op_leave(self, req) -> Dict[str, Any]:
        with self._cv:
            m = self._members.pop(req["member"], None)
            if m is not None:
                counter_add("elastic.leaves")
                self._bump("member_left", member=req["member"])
                log_info(f"elastic: member {req['member']} left "
                         f"(world {len(self._members)}, generation "
                         f"{self._generation})")
            return {"ok": True, "generation": self._generation}

    def _op_allgather(self, req) -> Dict[str, Any]:
        member = req["member"]
        gen = int(req["generation"])
        seq = int(req["seq"])
        key = (gen, seq)
        with self._cv:
            if member not in self._members:
                return {"ok": False, "error": "evicted"}
            if gen != self._generation:
                return {"ok": False, "error": "generation_changed",
                        "generation": self._generation}
            ranks = self._ranks()
            world = len(ranks)
            try:
                self._deadline_hint = max(self._deadline_hint,
                                          float(req.get("deadline_s") or 0))
            except (TypeError, ValueError):
                pass
            rank = ranks[member]
            parts = self._rounds.setdefault(key, {})
            arr = self._arrivals.setdefault(key, {})
            if rank not in parts:
                # coordinator-clock arrival stamp: one clock for every
                # rank, so the returned list is directly comparable
                arr[rank] = time.time()
            parts[rank] = req.get("payload")
            if req.get("site"):
                self._round_sites[key] = str(req["site"])
            self._touch[key] = time.monotonic()
            if len(parts) >= world:
                # this contribution completed the round: one ledger
                # line with the arrival spread (emitted once — by the
                # last arriver, i.e. the straggler itself)
                vals = sorted(arr.values())
                self._ledger_put(
                    "round", site=self._round_sites.get(key, ""),
                    generation=gen, seq=seq, world=world,
                    skew_s=round(vals[-1] - vals[0], 6) if vals else 0.0,
                    straggler_rank=(max(arr, key=arr.get)
                                    if arr else -1))
                counter_add("elastic.rounds")
            self._cv.notify_all()
            while True:
                if self._stop:
                    return {"ok": False, "error": "coordinator stopped"}
                if gen != self._generation:
                    return {"ok": False, "error": "generation_changed",
                            "generation": self._generation}
                if len(self._rounds.get(key, ())) >= world:
                    break
                self._cv.wait(0.5)
            payloads = [self._rounds[key][r] for r in range(world)]
            arrivals = [self._arrivals.get(key, {}).get(r)
                        for r in range(world)]
            # drop the round once every member has read it
            self._reads[key] = self._reads.get(key, 0) + 1
            if self._reads[key] >= world:
                self._rounds.pop(key, None)
                self._reads.pop(key, None)
                self._touch.pop(key, None)
                self._arrivals.pop(key, None)
                self._round_sites.pop(key, None)
            return {"ok": True, "payloads": payloads,
                    "arrivals": arrivals}


# ---------------------------------------------------------------------------
# client
# ---------------------------------------------------------------------------
class ElasticClient:
    """One training process's handle on the elastic world.

    ``join`` -> ``(world, rank, generation)``; ``allgather``/``barrier``
    are the generation-scoped collectives; a daemon heartbeat thread
    keeps membership alive and carries the live health state (the
    wedged-vs-dead signal).  All blocking calls are bounded by
    ``deadline_s`` and raise :class:`RankLostError` on expiry."""

    def __init__(self, address: Optional[str] = None,
                 member: Optional[str] = None,
                 deadline_s: Optional[float] = None,
                 heartbeat_interval_s: Optional[float] = None):
        addr = address or elastic_address()
        if not addr:
            raise ValueError("no elastic coordinator address (pass one "
                             "or set LGBM_TPU_ELASTIC=host:port)")
        host, _, port = addr.rpartition(":")
        self.host, self.port = host or "127.0.0.1", int(port)
        self.member = member or (os.environ.get("LGBM_TPU_ELASTIC_MEMBER")
                                 or f"m-{uuid.uuid4().hex[:12]}")
        self.deadline_s = (deadline_s if deadline_s is not None
                           else (collective_deadline_s() or 300.0))
        self.heartbeat_interval_s = (heartbeat_interval_s
                                     if heartbeat_interval_s is not None
                                     else heartbeat_s())
        self.world = 0
        self.rank = -1
        self.generation = -1
        # churn the heartbeat thread has SEEN but this client has not
        # yet adopted; only _adopt mutates (generation, seq) — the pair
        # keys collective rounds and must move together on every member.
        # _seen_generation is written by BOTH the heartbeat thread and
        # the main thread, so it gets its own leaf lock
        from ..obs.lock_contract import named_lock
        self._state_lock = named_lock("elastic_client")
        self._seen_generation = -1
        self.seq = 0
        self._status: Dict[str, Any] = {}
        self._hb_thread: Optional[threading.Thread] = None
        self._hb_stop = threading.Event()
        self._hb_pause = threading.Event()
        # coordinator-clock alignment (refreshed per generation): the
        # offset every trace record is stamped with (clk_off_s) and its
        # rtt/2 error bound
        self.clock_offset_s: Optional[float] = None
        self.clock_err_s: Optional[float] = None
        self._clock_synced_gen = -2
        # monotonic start of the in-flight collective, if any: when a
        # deadline fires, the recovery loop reads this to charge the
        # whole stall to the `detect` phase of the MTTR breakdown
        self.op_started: Optional[float] = None

    # -- transport -----------------------------------------------------
    def _rpc(self, msg: Dict[str, Any],
             timeout: Optional[float] = None) -> Dict[str, Any]:
        timeout = self.deadline_s if timeout is None else timeout
        site = f"elastic.{msg.get('op')}"
        try:
            with socket.create_connection((self.host, self.port),
                                          timeout=timeout) as sock:
                sock.settimeout(timeout)
                f = sock.makefile("rwb")
                f.write(json.dumps(msg).encode() + b"\n")
                f.flush()
                line = f.readline()
            if not line:
                raise RankLostError(site, timeout,
                                    "coordinator closed the connection")
            return json.loads(line.decode())
        except socket.timeout:
            counter_add("collective.deadline_exceeded")
            event("elastic", "rank_lost", site=site, deadline_s=timeout)
            raise RankLostError(site, timeout) from None
        except (OSError, ValueError) as exc:
            # reset/refused/broken-pipe from a coordinator hiccup, or a
            # truncated JSON line: every transport failure funnels into
            # the typed recovery path (train_elastic catches
            # ELASTIC_INTERRUPTS, not raw socket errors)
            counter_add("elastic.transport_errors")
            event("elastic", "rank_lost", site=site, deadline_s=timeout,
                  error=type(exc).__name__)
            raise RankLostError(
                site, timeout,
                f"transport failure {type(exc).__name__}: {exc}") from None

    def _check(self, resp: Dict[str, Any]) -> Dict[str, Any]:
        if resp.get("ok"):
            return resp
        err = resp.get("error", "")
        if err == "generation_changed":
            counter_add("elastic.generation_changed")
            raise GenerationChanged(resp.get("generation", -1))
        if err == "evicted":
            raise EvictedError(f"member {self.member} was evicted "
                               "(missed heartbeats); re-join required")
        raise RuntimeError(f"elastic coordinator error: {err}")

    # -- membership ----------------------------------------------------
    def join_world(self, min_world: int = 1) -> Tuple[int, int, int]:
        """(Re)join the world; blocks until ``min_world`` members are
        present.  Returns ``(world, rank, generation)`` and starts the
        heartbeat.  Retried through the shared policy with the
        ``rendezvous.connect`` fault point in front (the same seam
        ``mesh.init_distributed`` exposes)."""
        from ..utils.faults import fault_point
        from ..utils.retry import retry_call

        def _join():
            fault_point("rendezvous.connect")
            return self._check(self._rpc(
                {"op": "join", "member": self.member,
                 "min_world": int(min_world)}))

        with span("elastic.rendezvous", member=self.member,
                  min_world=int(min_world)):
            resp = retry_call(_join, what="elastic.join")
        self._adopt(resp)
        self._maybe_sync_clock()
        event("elastic", "joined", rank=self.rank, world=self.world,
              generation=self.generation)
        self._start_heartbeat()
        return self.world, self.rank, self.generation

    def resync(self) -> Tuple[int, int, int]:
        """Adopt the current membership view (after a
        :class:`GenerationChanged`); in-flight sequence numbers reset —
        collectives are scoped per generation."""
        with span("elastic.rendezvous", member=self.member, resync=1):
            resp = self._check(self._rpc({"op": "sync",
                                          "member": self.member}))
        self._adopt(resp)
        self._maybe_sync_clock()
        return self.world, self.rank, self.generation

    def _adopt(self, resp: Dict[str, Any]) -> None:
        self.world = int(resp["world"])
        self.rank = int(resp["rank"])
        self.generation = int(resp["generation"])
        with self._state_lock:
            self._seen_generation = self.generation
        # unconditional: every member re-adopts after an interrupt, so
        # resetting only on a generation change would leave a member
        # whose view was already current (e.g. the heartbeat saw the
        # bump first) keyed off its peers' (generation, seq) forever
        self.seq = 0

    def _maybe_sync_clock(self) -> None:
        """Refresh the coordinator-clock offset once per adopted
        generation (``LGBM_TPU_CLOCK_SYNC=0`` disables): midpoint-of-RTT
        against the ``clock`` op, minimum-RTT sample, error bound
        ``rtt/2``.  Best-effort — a sync failure leaves the previous
        offset in place rather than interrupting training."""
        if not obs_fleet.clock_sync_enabled():
            return
        if self._clock_synced_gen == self.generation:
            return

        def _fetch() -> float:
            resp = self._rpc({"op": "clock", "member": self.member},
                             timeout=max(self.heartbeat_interval_s * 4,
                                         2.0))
            if not resp.get("ok"):
                raise RankLostError("elastic.clock", 0.0,
                                    "clock probe refused")
            return float(resp["server_ts"])

        try:
            off, err = obs_fleet.estimate_clock_offset(_fetch)
        except (RankLostError, OSError, ValueError):
            return
        self.clock_offset_s, self.clock_err_s = off, err
        self._clock_synced_gen = self.generation
        obs_fleet.set_clock(off, err)
        event("fleet", "clock_sync", offset_s=round(off, 6),
              err_s=round(err, 6), generation=self.generation)

    @property
    def observed_generation(self) -> int:
        """The newest generation this process has any evidence of —
        adopted (collectives run under it) or merely seen by the
        heartbeat thread (collectives of the adopted generation are
        doomed; :class:`ElasticRun` fails them eagerly)."""
        with self._state_lock:
            return max(self.generation, self._seen_generation)

    def leave(self) -> None:
        self._hb_stop.set()
        try:
            self._rpc({"op": "leave", "member": self.member}, timeout=5.0)
        except (RankLostError, OSError):
            pass

    def close(self) -> None:
        self._hb_stop.set()
        if self._hb_thread is not None:
            self._hb_thread.join(timeout=2.0)

    # -- collectives ---------------------------------------------------
    def allgather(self, obj: Any,
                  site: str = "elastic.allgather") -> List[Any]:
        """Rank-ordered allgather of a JSON-serializable object within
        the current generation.  Raises :class:`GenerationChanged` when
        the membership moved, :class:`RankLostError` past the deadline
        (the ``collective.hang`` fault stalls this call to prove the
        deadline detects it; ``collective.slow`` delays it
        SUB-deadline — the injected straggler for skew attribution).

        ``site`` names the call point; together with
        ``(generation, seq)`` it joins per-rank trace records of the
        same collective.  The span splits wall time into ``wait_s``
        (blocked on later-arriving peers, from the coordinator's
        single-clock arrival stamps) vs ``xfer_s`` (everything else:
        transport + coordinator turnaround)."""
        from ..obs import enabled as obs_enabled
        from ..utils.faults import fault_flag
        if fault_flag("collective.slow"):
            time.sleep(obs_fleet.collective_slow_s(self.deadline_s))
        self.seq += 1
        if fault_flag("collective.hang"):
            time.sleep(self.deadline_s * 1.5 + 0.05)
        nbytes = -1
        if obs_enabled():
            try:
                nbytes = len(json.dumps(obj).encode())
            except (TypeError, ValueError):
                nbytes = -1
        # cleared on SUCCESS only: after a failure the recovery loop
        # reads (and consumes) it as the stall start of the `detect`
        # phase — the deadline wait is part of the MTTR, not overhead
        # that vanishes with the exception
        self.op_started = time.monotonic()
        with span("collective.elastic", site=site,
                  generation=self.generation, seq=self.seq) as sp:
            t0 = time.perf_counter()
            resp = self._check(self._rpc(
                {"op": "allgather", "member": self.member,
                 "generation": self.generation, "seq": self.seq,
                 "deadline_s": self.deadline_s, "site": site,
                 "payload": obj}))
            dur = time.perf_counter() - t0
            arrivals = resp.get("arrivals")
            if arrivals and 0 <= self.rank < len(arrivals) \
                    and all(a is not None for a in arrivals):
                last = max(arrivals)
                wait = max(last - arrivals[self.rank], 0.0)
                straggler = arrivals.index(last)
                sp["wait_s"] = round(wait, 6)
                sp["xfer_s"] = round(max(dur - wait, 0.0), 6)
                sp["arrive_ts"] = arrivals[self.rank]
                sp["straggler_rank"] = straggler
                if nbytes >= 0:
                    sp["bytes"] = nbytes
                if obs_enabled():
                    obs_fleet.note_collective(
                        site, self.generation, self.seq, wait,
                        max(dur - wait, 0.0), nbytes,
                        straggler == self.rank)
        self.op_started = None
        return resp["payloads"]

    def barrier(self, tag: str, site: str = "elastic.barrier") -> None:
        """All current members reach ``tag`` (an allgather of the tag;
        mismatched tags are a protocol desync and raise loudly)."""
        tags = self.allgather({"barrier": tag}, site=site)
        if any(t != {"barrier": tag} for t in tags):
            raise RuntimeError(f"elastic barrier desync at {tag!r}: "
                               f"{tags}")

    # -- heartbeats ----------------------------------------------------
    def set_status(self, **detail: Any) -> None:
        """Attach status to this member's heartbeats (the chaos
        launcher schedules kills off it; operators see it in
        ``info()``)."""
        self._status.update(detail)

    def pause_heartbeats(self, pause: bool = True) -> None:
        """Test hook: a paused heartbeat thread is a dead rank as far
        as the coordinator can tell."""
        if pause:
            self._hb_pause.set()
        else:
            self._hb_pause.clear()

    def _start_heartbeat(self) -> None:
        if self._hb_thread is not None and self._hb_thread.is_alive():
            return
        self._hb_stop.clear()
        self._hb_thread = threading.Thread(
            target=self._hb_run, name=f"lgbm-tpu-heartbeat-{self.member}",
            daemon=True)
        self._hb_thread.start()

    def _hb_run(self) -> None:
        from ..obs import health
        from ..utils.faults import fault_flag
        while not self._hb_stop.wait(self.heartbeat_interval_s):
            if self._hb_pause.is_set():
                continue
            if fault_flag("heartbeat.miss"):
                continue            # the injected dropped beat
            try:
                resp = self._rpc(
                    {"op": "heartbeat", "member": self.member,
                     "state": health.state()["state"],
                     "detail": dict(self._status)},
                    timeout=max(self.heartbeat_interval_s * 2, 1.0))
            except (RankLostError, OSError, ValueError):
                continue            # next beat retries; eviction is the
                #                     coordinator's judgement, not ours
            if resp.get("ok"):
                # observe membership churn between collectives; the
                # client ADOPTS it only via resync/_adopt (which also
                # resets seq — the two must never move separately)
                with self._state_lock:
                    self._seen_generation = max(
                        self._seen_generation,
                        int(resp.get("generation", -1)))


class ElasticRun:
    """One generation's frozen view, handed to the streamed trainer:
    the client plus the (world, rank, generation) it will train under
    and the run-lifetime protocol shard count ``num_shards`` — FIXED
    across membership changes, so per-shard partials combine in shard
    order and any world size reproduces the same bytes."""

    def __init__(self, client: ElasticClient, num_shards: int):
        self.client = client
        self.world = client.world
        self.rank = client.rank
        self.generation = client.generation
        self.num_shards = int(num_shards)
        if self.num_shards < 1:
            raise ValueError("num_shards must be >= 1")

    def owned_shards(self) -> Tuple[int, ...]:
        """The mod-world shard slice (the out-of-core store's
        ``sources[r::S]`` rule, applied to protocol shards)."""
        return tuple(s for s in range(self.num_shards)
                     if s % self.world == self.rank)

    def allgather(self, obj: Any,
                  site: str = "elastic.allgather") -> List[Any]:
        g = self.client.observed_generation
        if g != self.generation:
            raise GenerationChanged(g, "membership moved under this run")
        return self.client.allgather(obj, site=site)

    def barrier(self, tag: str, site: str = "elastic.barrier") -> None:
        g = self.client.observed_generation
        if g != self.generation:
            raise GenerationChanged(g, "membership moved under this run")
        self.client.barrier(tag, site=site)
