"""Structured training telemetry: spans, counters, gauges, JSONL traces.

A copy of the JAX package's ``obs/telemetry.py`` for the port, with the
same API and the same trace schema, so that one reader handles traces of
either package:

* **Spans** — ``with span("tree.hist") as s: ...; s["rows"] = n``.
  Host wall-clock only, nestable (a thread-local stack), and no implicit
  device synchronization: a span around an asynchronous CUDA launch
  times the host cost of that launch.
* **Counters / gauges** — ``counter_add("retry.loader.read.retries")``,
  ``gauge_set("gbdt.num_trees", n)``.  Counters accumulate (floats
  allowed: backoff seconds ride the same channel), gauges overwrite.
* **Events** — one-shot occurrences (``event("fault", name)``: an
  injection fired; early stopping triggered).

Sinks:

* an in-memory **run summary** as a plain dict (:func:`summary`):
  per-span count/total/max seconds, counters, gauges, event counts;
* a **JSONL event trace**, enabled by ``LGBM_TPU_TRACE=<path>`` or the
  ``telemetry_output`` parameter.  Every record carries ``ts`` (wall
  clock at start, epoch seconds), ``kind`` (``span`` | ``counter`` |
  ``gauge`` | ``event``), ``name`` and ``rank``; span records add
  ``dur_s`` (>= 0), ``depth`` and ``parent``, and are written on CLOSE,
  so a parent's record follows its children's;
* **per-rank files** in multi-process runs (the trace path gains a
  ``.rank<k>`` suffix, decided at the first write) and a **merged
  summary** over an allgather the caller supplies
  (:func:`merged_summary`).

Disabled telemetry is a guard-checked no-op — one module-attribute read
per call site — so the instrumentation stays in every path, the
per-wave learner loop included.

Unlike the JAX module's line-buffered trace, records go through a
64 KB buffer, flushed when a top-level span closes (the end of a
``train`` call), at least every ``TRACE_FLUSH_S`` seconds, on
:func:`disable` and at exit: on an NVIDIA H100 machine's host a write
per record cost the traced headline about 20 ms an iteration, a
buffered one nothing measurable (PERF.md; ``tools/telemetry_cost.py``).

While a device-time capture is live (``obs/profiler.py``) every span
also enters the installed annotator (:func:`set_annotator`:
``torch.profiler.record_function``), so the capture attributes device
time to the span tree.  :func:`merged_summary` lifts each rank's health
state (``obs/health.py``), cross-checks the ranks' collective flight
recorders (``obs/flight_recorder.py``) and merges their collective wait
accounting (``obs/fleet.py``).  The rank comes from
``torch.distributed`` when a process group is initialized, or from
:func:`set_rank`; ``parallel/mesh.py:init_distributed`` holds the trace
(:func:`hold_trace`) until the rendezvous has told the process its
rank.
"""
from __future__ import annotations

import atexit
import json
import os
import sys
import threading
import time
from typing import Any, Dict, IO, Optional

__all__ = [
    "enabled", "enable", "disable", "reset", "span", "counter_add",
    "gauge_set", "event", "summary", "merged_summary", "write_summary",
    "trace_path", "set_section", "set_annotator", "set_sink",
    "get_sink", "set_clock_offset", "set_rank", "hold_trace",
    "release_trace",
]


def _named_rlock(name: str):
    # lazy: lock_contract imports only the stdlib, so this is cycle-free
    from . import lock_contract
    return lock_contract.named_rlock(name)


_lock = _named_rlock("telemetry")
_tls = threading.local()            # per-thread span stack
_clock, _wall = time.perf_counter, time.time

# -- state (module-level flags keep the disabled path one attribute read)
_enabled = False
_trace_requested: Optional[str] = None   # path asked for; opens lazily
_trace_file: Optional[IO[str]] = None
_trace_open_path: Optional[str] = None
_last_flush = 0.0
# the longest a written record waits in the buffer while records flow
TRACE_FLUSH_S = 1.0
TRACE_BUFFER = 1 << 16

_spans: Dict[str, list] = {}        # name -> [count, total_s, max_s]
_counters: Dict[str, float] = {}
_gauges: Dict[str, Any] = {}
_events: Dict[str, int] = {}
# named summary sections: one structured result per run, stored even
# while telemetry is off (their producers gate themselves)
_sections: Dict[str, Any] = {}
# span annotator (obs/profiler.py): while a device-time capture is live,
# every span also enters ``fn(name)``; None costs one attribute read
_annotator = None
# live-metrics sink (counter/gauge/event/span callbacks); None costs one
# attribute read on the enabled path
_sink = None
# this rank's clock offset against a coordinator: stamped on every
# trace record as ``clk_off_s`` when set
_clk_off: Optional[float] = None
# (rank, world) override for fleets that are not a torch.distributed
# process group
_rank_override = None


def set_clock_offset(offset_s: Optional[float]) -> None:
    """Install this rank's clock offset (``None`` removes the stamp)."""
    global _clk_off
    _clk_off = None if offset_s is None else float(offset_s)


def set_rank(rank: int, world: int) -> None:
    """Override the (rank, world) identity used for trace-record rank
    stamps, per-rank trace-file suffixes and summaries."""
    global _rank_override
    _rank_override = (int(rank), max(int(world), 1))


def set_annotator(fn) -> None:
    """Install or remove the per-span annotation factory (``fn(name)`` ->
    context manager).  Owned by ``obs/profiler.py``."""
    global _annotator
    _annotator = fn


def get_sink():
    """The installed sink or None: a lock-free attribute read
    (``obs/lock_contract.py`` calls it from inside lock wrappers)."""
    return _sink


def set_sink(sink) -> None:
    """Install or remove the live-metrics sink (an object with
    ``counter``, ``gauge``, ``event`` and ``span`` methods).  Survives
    :func:`reset`: its lifecycle is the process, not one run."""
    global _sink
    _sink = sink


def _rank_world():
    """(rank, world): the :func:`set_rank` override, else the
    ``torch.distributed`` process group when one is initialized (read
    only if ``torch.distributed`` is already imported), else (0, 1)."""
    if _rank_override is not None:
        return _rank_override
    dist = sys.modules.get("torch.distributed")
    if dist is None:
        return 0, 1
    try:
        if dist.is_available() and dist.is_initialized():
            return int(dist.get_rank()), int(dist.get_world_size())
    except (RuntimeError, ValueError):
        pass
    return 0, 1


# ---------------------------------------------------------------------------
# lifecycle
# ---------------------------------------------------------------------------
def enabled() -> bool:
    return _enabled


def enable(trace_path: Optional[str] = None) -> None:
    """Turn telemetry on.  ``trace_path`` also streams every record as
    one JSON line (appended; per-rank suffix in multi-process runs).
    Idempotent; a second call can add a trace to an enabled run."""
    global _enabled, _trace_requested
    with _lock:
        _enabled = True
        if trace_path:
            _trace_requested = trace_path


def disable() -> None:
    """Turn telemetry off and close the trace (the summary is kept)."""
    global _enabled, _trace_file, _trace_open_path
    with _lock:
        _enabled = False
        if _trace_file is not None:
            try:
                _trace_file.close()
            except OSError:
                pass
        _trace_file = None
        _trace_open_path = None


def reset() -> None:
    """Clear the run summary and forget any requested trace; also
    rewinds the profiler's state, the health state machine, the
    collective flight recorder and the collective wait accounting (a
    fresh run inherits none of the previous one's)."""
    global _trace_requested, _held, _annotator, _clk_off, _rank_override
    with _lock:
        disable()
        _trace_requested = None
        _held = None
        _annotator = None
        _clk_off = None
        _rank_override = None
        _spans.clear()
        _counters.clear()
        _gauges.clear()
        _events.clear()
        _sections.clear()
        if getattr(_tls, "stack", None):
            _tls.stack = []
    from . import fleet, flight_recorder, health, profiler
    profiler.reset()
    health.reset()
    flight_recorder.reset()
    fleet.reset()


def trace_path() -> Optional[str]:
    """The trace file actually written (with any rank suffix), or the
    requested path when nothing has been written yet."""
    return _trace_open_path or _trace_requested


def _init_from_env() -> None:
    path = os.environ.get("LGBM_TPU_TRACE", "")
    if path:
        enable(trace_path=path)


# ---------------------------------------------------------------------------
# trace writing
# ---------------------------------------------------------------------------
_held = None                  # not None => buffer records instead


def hold_trace() -> None:
    """Buffer trace records in memory instead of opening the trace file
    (around a rendezvous: a process that does not know its rank yet must
    not open the unsuffixed path).  No-op when already holding."""
    global _held
    with _lock:
        if _held is None:
            _held = []


def release_trace() -> None:
    """Write the records buffered by :func:`hold_trace` (their ``rank``
    re-stamped) and resume direct writes."""
    global _held
    with _lock:
        pending, _held = _held, None
        if pending:
            rank, _ = _rank_world()
            for rec in pending:
                rec["rank"] = rank
                _trace_write(rec)


def _trace_write(record: Dict[str, Any], flush: bool = False) -> None:
    """Append one JSONL record (``flush``: write the buffer out now).
    The caller holds ``_lock``; the file opens at the first write."""
    global _trace_file, _trace_open_path, _last_flush
    if _clk_off is not None and "clk_off_s" not in record:
        record["clk_off_s"] = _clk_off
    if _held is not None:
        _held.append(record)
        return
    if _trace_file is None:
        if not _trace_requested:
            return
        rank, world = _rank_world()
        path = _trace_requested
        if world > 1:
            path = f"{path}.rank{rank}"
        try:
            _trace_file = open(path, "a", buffering=TRACE_BUFFER)
            _trace_open_path = path
        except OSError:
            return
    try:
        _trace_file.write(json.dumps(record) + "\n")
        now = time.monotonic()
        if flush or now - _last_flush >= TRACE_FLUSH_S:
            _trace_file.flush()
            _last_flush = now
    except (OSError, ValueError):
        pass


# ---------------------------------------------------------------------------
# spans
# ---------------------------------------------------------------------------
class _Discard:
    """Attribute sink of the disabled path: swallows writes."""
    __slots__ = ()

    def __setitem__(self, key, value):
        pass

    def update(self, *args, **kwargs):
        pass


_DISCARD = _Discard()


class _NoopSpan:
    __slots__ = ()

    def __enter__(self):
        return _DISCARD

    def __exit__(self, *exc):
        return False


_NOOP_SPAN = _NoopSpan()


class _Span:
    __slots__ = ("name", "attrs", "t0", "ts", "depth", "ann", "stack")

    def __init__(self, name: str, attrs: Dict[str, Any]):
        self.name = name
        self.attrs = attrs

    def __enter__(self):
        try:
            stack = _tls.stack
        except AttributeError:
            stack = _tls.stack = []
        self.stack = stack
        self.depth = len(stack)
        stack.append(self.name)
        ann = _annotator
        if ann is not None:
            try:
                self.ann = ann(self.name)
                self.ann.__enter__()
            except Exception:           # noqa: BLE001 - a profiler
                self.ann = None         # hiccup must not stop the span
        else:
            self.ann = None
        self.ts = _wall()
        self.t0 = _clock()
        return self.attrs

    def __exit__(self, exc_type, exc, tb):
        dur = _clock() - self.t0
        if self.ann is not None:
            try:
                self.ann.__exit__(exc_type, exc, tb)
            except Exception:           # noqa: BLE001 - best effort
                pass
            self.ann = None
        name, stack = self.name, self.stack
        parent = ""
        if stack and stack[-1] is name:
            stack.pop()
            if stack:
                parent = stack[-1]
        with _lock:
            agg = _spans.get(name)
            if agg is None:
                agg = _spans[name] = [0, 0.0, 0.0]
            agg[0] += 1
            agg[1] += dur
            if dur > agg[2]:
                agg[2] = dur
            sink = _sink
            if sink is not None:
                sink.span(name, dur)
            if _trace_requested:
                rec = {"ts": self.ts, "kind": "span", "name": name,
                       "rank": _rank_world()[0], "dur_s": dur,
                       "depth": self.depth, "parent": parent}
                if self.attrs:
                    rec.update(self.attrs)
                _trace_write(rec, flush=self.depth == 0)
        return False


def span(name: str, **attrs):
    """Context manager timing the enclosed block under ``name``; yields
    a dict the block may add fields to (they land on the trace record).
    A shared no-op when telemetry is disabled."""
    if not _enabled:
        return _NOOP_SPAN
    return _Span(name, attrs)


# ---------------------------------------------------------------------------
# counters / gauges / events
# ---------------------------------------------------------------------------
def counter_add(name: str, n: float = 1) -> None:
    if not _enabled:
        return
    with _lock:
        _counters[name] = _counters.get(name, 0) + n
        sink = _sink
        if sink is not None:
            sink.counter(name, n, _counters[name])
        if _trace_requested:
            _trace_write({"ts": time.time(), "kind": "counter",
                          "name": name, "rank": _rank_world()[0], "add": n,
                          "value": _counters[name]})


def gauge_set(name: str, value: Any) -> None:
    if not _enabled:
        return
    with _lock:
        _gauges[name] = value
        sink = _sink
        if sink is not None:
            sink.gauge(name, value)
        if _trace_requested:
            _trace_write({"ts": time.time(), "kind": "gauge",
                          "name": name, "rank": _rank_world()[0],
                          "value": value})


def event(kind: str, name: str, **fields) -> None:
    """Record a one-shot occurrence.  ``kind`` is a coarse family
    (``"fault"``, ``"early_stop"``, ...); the trace record's ``kind`` is
    ``"event"`` with the family under ``"family"``."""
    if not _enabled:
        return
    with _lock:
        key = f"{kind}:{name}"
        _events[key] = _events.get(key, 0) + 1
        sink = _sink
        if sink is not None:
            sink.event(key, _events[key])
        if _trace_requested:
            rec = {"ts": time.time(), "kind": "event", "name": name,
                   "rank": _rank_world()[0], "family": kind}
            if fields:
                rec.update(fields)
            _trace_write(rec)


# ---------------------------------------------------------------------------
# summaries
# ---------------------------------------------------------------------------
def set_section(name: str, data: Any) -> None:
    """Attach a named section to the run summary (overwrites); not gated
    on :func:`enabled`."""
    with _lock:
        _sections[name] = data


def summary() -> Dict[str, Any]:
    """The in-memory run summary as a plain (JSON-serializable) dict,
    with this rank's collective flight-recorder state (``flight_recorder``:
    ring and rolling digest), its collective wait accounting
    (``collective_skew``) once a collective has run, and its
    coordinator-clock offset (``clock``) once the elastic client set
    one."""
    rank, world = _rank_world()
    from . import fleet, flight_recorder
    fr = flight_recorder.snapshot()
    sk = fleet.skew_snapshot()
    ck = fleet.clock()
    with _lock:
        out = {
            "rank": rank,
            "process_count": world,
            "spans": {k: {"count": v[0], "total_s": v[1], "max_s": v[2]}
                      for k, v in _spans.items()},
            "counters": dict(_counters),
            "gauges": dict(_gauges),
            "events": dict(_events),
        }
        if fr["count"]:
            out["flight_recorder"] = fr
        if sk is not None:
            out["collective_skew"] = sk
        if ck.get("offset_s") is not None:
            out["clock"] = ck
        out.update(_sections)
        return out


def merged_summary(allgather=None) -> Dict[str, Any]:
    """Every rank's summary merged into one dict (identical on all ranks).
    ``allgather(obj) -> [obj of rank 0, ...]`` is the host collective
    (default: the process group's, ``io/distributed.py:process_allgather``);
    ``ranks`` keeps each rank's full summary, ``counters`` and ``events``
    sum and ``spans`` combine across ranks.  The ranks'
    ``flight_recorder`` sections are cross-checked into
    ``flight_recorder_check`` (a desync names the first diverging site
    and rank), their ``collective_skew`` sections become the fleet table
    of the same name, and each rank's health state is lifted into
    ``health``."""
    if allgather is None:
        from ..io.distributed import process_allgather as allgather
    locals_ = allgather(summary())
    merged: Dict[str, Any] = {
        "process_count": len(locals_),
        "ranks": locals_,
        "spans": {},
        "counters": {},
        "events": {},
    }
    for s in locals_:
        for k, v in s.get("counters", {}).items():
            merged["counters"][k] = merged["counters"].get(k, 0) + v
        for k, v in s.get("events", {}).items():
            merged["events"][k] = merged["events"].get(k, 0) + v
        for k, v in s.get("spans", {}).items():
            agg = merged["spans"].setdefault(
                k, {"count": 0, "total_s": 0.0, "max_s": 0.0})
            agg["count"] += v["count"]
            agg["total_s"] += v["total_s"]
            agg["max_s"] = max(agg["max_s"], v["max_s"])
    from . import fleet, flight_recorder
    check = flight_recorder.cross_check_summaries(locals_)
    if check is not None:
        merged["flight_recorder_check"] = check
    skew = fleet.merge_skew(locals_)
    if skew is not None:
        merged["collective_skew"] = skew
    hs = [(s.get("health") or {}).get("state") for s in locals_]
    if any(hs):
        order = ("ready", "warming", "draining", "degraded", "stalled")
        known = [h for h in hs if h in order]
        merged["health"] = {
            "ranks": hs,
            "worst": (max(known, key=order.index) if known else None),
        }
    return merged


def write_summary(path: str, merged: Optional[Dict[str, Any]] = None) -> None:
    """Atomically write a summary (merged or this rank's) as JSON."""
    from ..utils.file_io import atomic_write
    atomic_write(path, json.dumps(merged if merged is not None
                                  else summary(), indent=1))


_init_from_env()
atexit.register(disable)
