"""Device-time attribution: profiler-backed span accounting.

The JAX package's ``obs/profiler.py`` on ``torch.profiler``.  Telemetry
spans (``obs/telemetry.py``) time the host: a span around an
asynchronous launch closes when the host returns, while the card is
still running.  This module attributes the device's time to the spans.

* **Capture** — under ``LGBM_TPU_PROFILE=<dir>`` a training run profiles
  itself: at the first iteration boundary after warmup (the first
  iteration) it starts ``torch.profiler.profile`` (CPU activity, and CUDA
  activity on the card), and after ``LGBM_TPU_PROFILE_WINDOWS`` windows
  of ``LGBM_TPU_PROFILE_ITERS`` iterations it stops, writes the chrome
  trace into ``<dir>``, parses it and puts the result into the run
  summary as the ``device_attribution`` section.  While the capture is
  live, every telemetry span also enters
  ``torch.profiler.record_function(name)`` (installed with
  :func:`telemetry.set_annotator`), and each kernel wrapper of K1-K4 and
  the wide histogram enters ``record_function("kernel.<name>")`` around
  its launch and records the launch's bytes and operations
  (:func:`launch`, :func:`record_kernel_cost`).  The serving
  harness marks each batch (:func:`step`).

* **Parse** — :func:`parse_capture` reads the chrome trace.  The ops are
  the card's events of category ``kernel``, ``gpu_memcpy`` and
  ``gpu_memset``; each gets its launch's host time as its join key
  (``launch_ts``): the ``cuda_runtime`` / ``cuda_driver`` event with the
  same ``correlation`` id (``cudaLaunchKernel`` from torch or from the
  port's ``ctypes`` libraries, ``cudaGraphLaunch``, a copy).  A port
  kernel runs after its span closed, so the launch decides the span.
  An op's program is the port's kernel name when its launch lies in a
  ``kernel.<name>`` annotation, else the CUDA function's name.  On the
  CPU there are no device events: the ops are the outermost ``cpu_op``
  events (the plain versions' torch calls; a kernel annotation names
  their program the same way), and the report carries the ``cpu``
  sentinel.  The annotations are the ``user_annotation`` events
  whose names have the span prefixes.

* **Attribute** — :func:`attribute` is the JAX package's function, with
  one change: an op with a ``launch_ts`` joins the deepest annotation
  covering its launch (else the latest started before it); an op without
  one joins as in the JAX package (the annotation covering its
  midpoint).  It reports device seconds per span, ``host_gap_s`` (device
  idle inside ``gbdt.iteration`` windows), collective time and the
  device time per program.

* **Cost model** — :func:`finalize_report` gives each recorded kernel its
  launches, bytes, operations and roofline shares against the card's row
  of ``obs/chip_specs.py`` (integer kernels against its int32 rate).

A capture that fails to start, a trace that fails to parse: each
degrades to a ``device_attribution`` section with an ``error`` field.
Training never dies for observability's sake.
"""
from __future__ import annotations

import glob
import gzip
import json
import os
import time
from typing import Any, Dict, List, Optional, Tuple

from . import telemetry

__all__ = [
    "profile_dir", "maybe_profile", "capture", "step", "launch", "record_kernel_cost", "kernel_costs", "reset",
    "parse_capture", "attribute", "finalize_report", "ATTRIBUTION_SECTION",
]

PROFILE_ENV = "LGBM_TPU_PROFILE"
ATTRIBUTION_SECTION = "device_attribution"

# span-name prefixes of our annotations (the telemetry span tree and the
# step markers); everything else on the host timeline is torch internals
SPAN_PREFIXES = ("engine.", "gbdt.", "tree.", "serve.", "io.", "mesh.",
                 "collective.", "obj.", "snapshot.", "bench.", "profile.",
                 "stream.")
# the kernel wrappers' annotations: they name an op's program
KERNEL_PREFIX = "kernel."
# training-window spans: their wall clock minus in-window device busy
# time is the host gap (idle device between launches)
WINDOW_SPANS = ("gbdt.block", "gbdt.block_compile", "gbdt.iteration")
COLLECTIVE_OPS = ("all-reduce", "all-gather", "reduce-scatter",
                  "all-to-all", "collective-permute", "psum", "nccl")
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATEGORIES = ("cuda_runtime", "cuda_driver")


def profile_dir() -> str:
    return os.environ.get(PROFILE_ENV, "")


def profile_windows() -> int:
    """Captured windows after warmup (bounded trace size)."""
    return max(1, int(os.environ.get("LGBM_TPU_PROFILE_WINDOWS", 2)))


def profile_window_iters() -> int:
    """Iterations per captured window."""
    return max(1, int(os.environ.get("LGBM_TPU_PROFILE_ITERS", 2)))


# ---------------------------------------------------------------------------
# capture state (one live capture per process)
# ---------------------------------------------------------------------------
_active_dir: Optional[str] = None
_prof = None
_device = None
# kernel name -> {"op_kind", "launches", "bytes": [...], "ops": [...]}
_kernel_costs: Dict[str, Dict[str, Any]] = {}


def _annotate(name: str):
    import torch
    return torch.profiler.record_function(name)


class _NoopCtx:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP_CTX = _NoopCtx()


def step(name: str, num: int):
    """A ``record_function(name)`` step marker (``num`` in its args) while
    a capture is live, else a shared no-op."""
    if _active_dir is None:
        return _NOOP_CTX
    import torch
    return torch.profiler.record_function(name, str(int(num)))


def record_kernel_cost(name: str, nbytes, ops, op_kind: str = "int32"
                       ) -> None:
    """One launch of kernel ``name``: ``nbytes`` of traffic and ``ops``
    operations of ``op_kind`` (``int32`` or ``f32``), numbers or 0-d
    tensors (read when the report is made, so a launch adds no host
    synchronization).  Only while a capture is live."""
    if _active_dir is None:
        return
    e = _kernel_costs.setdefault(name, {"op_kind": op_kind, "launches": 0,
                                        "bytes": [], "ops": []})
    e["launches"] += 1
    e["bytes"].append(nbytes)
    e["ops"].append(ops)


def launch(name: str, fn, cost=None):
    """``fn()`` — a kernel wrapper's launch (or its plain version).  While
    a capture is live it runs inside ``record_function("kernel.<name>")``
    and ``cost(result) -> (bytes, ops, op_kind)`` is recorded for it,
    under the ``profile.cost`` annotation; otherwise ``fn()`` alone (one
    module-attribute read)."""
    if _active_dir is None:
        return fn()
    with _annotate(KERNEL_PREFIX + name):
        out = fn()
    if cost is not None:
        with _annotate("profile.cost"):
            nbytes, ops, kind = cost(out)
        record_kernel_cost(name, nbytes, ops, kind)
    return out


def kernel_costs() -> Dict[str, Dict[str, Any]]:
    """The recorded cost table, summed: name -> launches, bytes, ops."""
    out = {}
    for name, e in _kernel_costs.items():
        out[name] = {"op_kind": e["op_kind"], "launches": e["launches"],
                     "bytes": float(sum(float(b) for b in e["bytes"])),
                     "ops": float(sum(float(o) for o in e["ops"]))}
    return out


def _start_capture(out_dir: str, device=None) -> bool:
    """Start ``torch.profiler`` into ``out_dir`` and install the span
    annotator.  Returns False (and logs once) when it cannot start."""
    global _active_dir, _prof, _device, _kernel_costs
    if _active_dir is not None:
        return False                    # one capture at a time
    # a capture is only useful with live spans to annotate
    telemetry.enable()
    try:
        import torch
        from torch.profiler import ProfilerActivity
        dev = torch.device(device) if device is not None else (
            torch.device("cuda") if torch.cuda.is_available()
            else torch.device("cpu"))
        acts = [ProfilerActivity.CPU]
        if dev.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        os.makedirs(out_dir, exist_ok=True)
        prof = torch.profiler.profile(activities=acts)
        prof.start()
    except Exception as exc:            # noqa: BLE001 - degrade, never die
        from ..utils.log import log_once
        log_once("profiler_start_failed",
                 f"device-time capture failed to start ({exc}); "
                 f"continuing unprofiled", level="warning")
        return False
    _prof, _device, _active_dir = prof, dev, out_dir
    _kernel_costs = {}
    telemetry.set_annotator(_annotate)
    return True


def _stop_capture(sync=None) -> Optional[str]:
    """Stop the live capture (after ``sync()`` waits for the work in
    flight, so the captured iterations' kernels land in the trace) and
    write its chrome trace.  Returns the trace file, or None."""
    global _active_dir, _prof
    out, prof = _active_dir, _prof
    _active_dir, _prof = None, None
    telemetry.set_annotator(None)
    if out is None or prof is None:
        return None
    try:
        if sync is not None:
            sync()
        elif _device is not None and _device.type == "cuda":
            import torch
            torch.cuda.synchronize(_device)
    except Exception:                   # noqa: BLE001 - the trace still
        pass                            # stops
    try:
        prof.stop()
        path = os.path.join(out, f"lgbm_torch_{os.getpid()}_"
                                 f"{time.time_ns()}.trace.json")
        prof.export_chrome_trace(path)
    except Exception as exc:            # noqa: BLE001 - degrade, never die
        from ..utils.log import log_warning
        log_warning(f"device-time capture failed to stop cleanly: {exc}")
        return None
    return path


def reset() -> None:
    """Forget capture and cost state (tests); stops a leaked capture."""
    global _kernel_costs
    if _active_dir is not None:
        _stop_capture()
    _kernel_costs = {}


class capture:
    """``with capture(out_dir, device=...) as c:`` — a plain bounded
    capture for tools: annotated spans inside the block land in the
    trace; on exit ``c.report`` holds the attribution (also the
    telemetry summary section)."""

    def __init__(self, out_dir: str, sync=None, device=None,
                 section: str = ATTRIBUTION_SECTION):
        self.out_dir = out_dir
        self.sync = sync
        self.device = device
        self.section = section
        self.report: Optional[Dict[str, Any]] = None

    def __enter__(self) -> "capture":
        self._started = _start_capture(self.out_dir, self.device)
        return self

    def __exit__(self, *exc) -> bool:
        if self._started:
            dev = _device
            path = _stop_capture(self.sync)
            self.report = finalize_report(path or self.out_dir, dev)
            telemetry.set_section(self.section, self.report)
        return False


# ---------------------------------------------------------------------------
# windowed training session
# ---------------------------------------------------------------------------
class _ProfileSession:
    """Windowed capture driven by the training loop: the first iteration
    is warmup, then ``profile_windows()`` windows of
    ``profile_window_iters()`` iterations are captured, then the capture
    stops and its report becomes the summary section."""

    def __init__(self, kind: str, out_dir: str, sync=None, device=None):
        self.kind = kind
        self.out_dir = out_dir
        self.sync = sync
        self.device = device
        self.state = "warmup"           # -> capturing -> done
        self.windows_left = profile_windows()
        self.chunk = profile_window_iters()
        self._iters = 0
        self.report: Optional[Dict[str, Any]] = None

    def window(self, it: int = -1) -> bool:
        """One iteration finished.  Advances warmup -> capture -> done.
        Returns True when this boundary did heavy profiler work (start,
        or stop and parse): the caller keeps it out of its own host-gap
        accounting."""
        if self.state == "warmup":
            self.state = "capturing"
            if not _start_capture(self.out_dir, self.device):
                self.state = "done"
            return True
        if self.state == "capturing":
            self._iters += 1
            if self._iters >= self.chunk:
                self._iters = 0
                self.windows_left -= 1
                if self.windows_left <= 0:
                    self._finish(it)
                    return True
        return False

    def _finish(self, it: int = -1) -> None:
        if self.state != "capturing":
            return
        self.state = "done"
        dev = _device
        path = _stop_capture(self.sync)
        self.report = finalize_report(path or self.out_dir, dev)
        self.report["kind"] = self.kind
        self.report["windows"] = profile_windows()
        self.report["window_iters"] = self.chunk
        if it >= 0:
            self.report["captured_through_iteration"] = int(it)
        telemetry.set_section(ATTRIBUTION_SECTION, self.report)

    def close(self) -> None:
        """End of training: stop a capture still running (a short run
        ends before its window budget is spent)."""
        self._finish()


class maybe_profile:
    """``with maybe_profile("gbdt", device=dev) as prof:`` — a live
    :class:`_ProfileSession` when ``LGBM_TPU_PROFILE`` names a directory,
    else None (one environment read per run)."""

    def __init__(self, kind: str, sync=None, device=None):
        self.kind = kind
        self.sync = sync
        self.device = device
        self.session: Optional[_ProfileSession] = None

    def __enter__(self) -> Optional[_ProfileSession]:
        out = profile_dir()
        if out:
            self.session = _ProfileSession(self.kind, out, sync=self.sync,
                                           device=self.device)
        return self.session

    def __exit__(self, *exc) -> bool:
        if self.session is not None:
            self.session.close()
        return False


# ---------------------------------------------------------------------------
# trace parsing (torch's chrome trace JSON, stdlib only)
# ---------------------------------------------------------------------------
def find_trace_file(path: str) -> Optional[str]:
    """A capture directory or trace file -> the newest ``*.trace.json``
    (or ``.json.gz``) in it."""
    if os.path.isfile(path):
        return path
    hits = []
    for pat in ("*.trace.json", "*.trace.json.gz", "*.pt.trace.json"):
        hits += glob.glob(os.path.join(path, pat))
    return max(hits, key=os.path.getmtime) if hits else None


def _short_kernel_name(name: str) -> str:
    """``void hist_kernel<true, 4>(unsigned char const*, ...)`` ->
    ``hist_kernel``; other names (copies, sets) as they are."""
    if not name.startswith("void "):
        return name
    n = name[5:]
    for cut in ("<", "("):
        i = n.find(cut)
        if i > 0:
            n = n[:i]
    return n.strip() or name


def _outermost(events: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """Per thread, the events not nested inside another one."""
    by_tid: Dict[Any, List[Dict[str, Any]]] = {}
    for e in events:
        by_tid.setdefault(e["tid"], []).append(e)
    out = []
    for evs in by_tid.values():
        evs.sort(key=lambda e: (e["ts"], -e["dur"]))
        end = -1.0
        for e in evs:
            if e["ts"] >= end:
                out.append(e)
                end = e["ts"] + e["dur"]
    return out


def _covering(annos: List[Dict[str, Any]], t: float
              ) -> Optional[Dict[str, Any]]:
    """The deepest (latest-starting) annotation covering time ``t``."""
    owner = None
    for a in annos:                     # sorted by ts: last hit wins
        if a["ts"] > t:
            break
        if a["ts"] + a["dur"] >= t:
            owner = a
    return owner


def parse_capture(path: str) -> Dict[str, Any]:
    """Parse one capture into ``{"annotations": [...], "ops": [...],
    "path": file, "op_source": "device" | "cpu_op"}``.  Times are seconds
    on the trace's clock; a device op carries ``launch_ts``, the host
    time of its launch."""
    f = find_trace_file(path)
    if f is None:
        raise FileNotFoundError(f"no *.trace.json under {path!r}")
    opener = gzip.open if f.endswith(".gz") else open
    with opener(f, "rt", encoding="utf-8") as fh:
        data = json.load(fh)
    events = data.get("traceEvents", data if isinstance(data, list) else [])
    annos: List[Dict[str, Any]] = []
    kannos: List[Dict[str, Any]] = []
    dev_ops: List[Dict[str, Any]] = []
    cpu_ops: List[Dict[str, Any]] = []
    launches: Dict[Any, float] = {}
    for ev in events:
        if not ev or ev.get("ph") != "X":
            continue
        cat = ev.get("cat", "")
        name = ev.get("name", "")
        args = ev.get("args") or {}
        ts = float(ev.get("ts", 0.0)) / 1e6
        dur = float(ev.get("dur", 0.0)) / 1e6
        if cat in DEVICE_CATEGORIES:
            dev_ops.append({"name": name, "ts": ts, "dur": dur,
                            "module": _short_kernel_name(name),
                            "corr": args.get("correlation")})
        elif cat in LAUNCH_CATEGORIES:
            corr = args.get("correlation")
            if corr is not None:
                launches[corr] = ts
        elif cat == "cpu_op":
            cpu_ops.append({"name": name, "ts": ts, "dur": dur,
                            "module": name, "tid": ev.get("tid")})
        elif cat == "user_annotation":
            if name.startswith(SPAN_PREFIXES):
                annos.append({"name": name, "ts": ts, "dur": dur})
            elif name.startswith(KERNEL_PREFIX):
                kannos.append({"name": name[len(KERNEL_PREFIX):],
                               "ts": ts, "dur": dur})
    annos.sort(key=lambda a: a["ts"])
    kannos.sort(key=lambda a: a["ts"])
    if dev_ops:
        ops = []
        for o in dev_ops:
            op = {"name": o["name"], "ts": o["ts"], "dur": o["dur"],
                  "module": o["module"]}
            lt = launches.get(o["corr"])
            if lt is not None:
                op["launch_ts"] = lt
                k = _covering(kannos, lt)
                if k is not None:
                    op["module"] = k["name"]
            ops.append(op)
        source = "device"
    else:
        ops = []
        for o in _outermost(cpu_ops):
            k = _covering(kannos, o["ts"])
            ops.append({"name": o["name"], "ts": o["ts"], "dur": o["dur"],
                        "module": k["name"] if k is not None
                        else o["module"]})
        source = "cpu_op"
    ops.sort(key=lambda o: o["ts"])
    return {"annotations": annos, "ops": ops, "path": f,
            "op_source": source}


def _interval_union(iv: List[Tuple[float, float]]) -> float:
    total, end = 0.0, -1.0
    for s, e in sorted(iv):
        if s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def _is_collective(op_name: str) -> bool:
    n = op_name.lower()
    return any(n.startswith(c) or f"/{c}" in n for c in COLLECTIVE_OPS)


def attribute(parsed: Dict[str, Any]) -> Dict[str, Any]:
    """Reduce a parsed capture to the per-span device-time table.

    An op with a ``launch_ts`` joins the deepest annotation covering its
    launch, else the latest annotation started at or before it.  An op
    without one joins the deepest annotation covering its midpoint (the
    latest-starting cover: spans nest), else the latest started at or
    before its start — the JAX package's rule."""
    annos, ops = parsed["annotations"], parsed["ops"]
    spans: Dict[str, Dict[str, Any]] = {}
    programs: Dict[str, float] = {}
    device_total = attributed = collective_s = 0.0
    for op in ops:
        device_total += op["dur"]
        mod = op["module"] or "<unnamed>"
        programs[mod] = programs.get(mod, 0.0) + op["dur"]
        if _is_collective(op["name"]):
            collective_s += op["dur"]
        key = op.get("launch_ts")
        start = op["ts"] if key is None else key
        mid = op["ts"] + op["dur"] / 2.0 if key is None else key
        owner = None
        for a in annos:                 # sorted by ts: last hit wins
            if a["ts"] > mid:
                break
            if a["ts"] + a["dur"] >= mid:
                owner = a
        if owner is None:
            for a in annos:
                if a["ts"] > start:
                    break
                owner = a               # latest started at-or-before
        if owner is None:
            continue
        attributed += op["dur"]
        agg = spans.setdefault(owner["name"],
                               {"device_s": 0.0, "ops": 0})
        agg["device_s"] += op["dur"]
        agg["ops"] += 1

    # host gap: device idle inside the training windows
    windows = [(a["ts"], a["ts"] + a["dur"]) for a in annos
               if a["name"] in WINDOW_SPANS]
    window_wall = sum(e - s for s, e in windows)
    busy_in_windows = _interval_union(
        [(max(o["ts"], s), min(o["ts"] + o["dur"], e))
         for o in ops for s, e in windows
         if o["ts"] < e and o["ts"] + o["dur"] > s])
    points = ([a["ts"] for a in annos] + [o["ts"] for o in ops])
    ends = ([a["ts"] + a["dur"] for a in annos]
            + [o["ts"] + o["dur"] for o in ops])
    capture_wall = (max(ends) - min(points)) if points else 0.0
    device_busy = _interval_union([(o["ts"], o["ts"] + o["dur"])
                                   for o in ops])
    top = sorted(programs.items(), key=lambda kv: -kv[1])[:3]
    return {
        "source": parsed.get("path"),
        "device_time_s": round(device_total, 6),
        "attributed_s": round(attributed, 6),
        "coverage": round(attributed / device_total, 4)
        if device_total else None,
        "collective_s": round(collective_s, 6),
        "collective_frac": round(collective_s / device_total, 4)
        if device_total else None,
        "capture_wall_s": round(capture_wall, 6),
        "device_busy_s": round(device_busy, 6),
        "host_gap_s": round(max(0.0, window_wall - busy_in_windows), 6),
        "window_wall_s": round(window_wall, 6),
        "spans": {k: {"device_s": round(v["device_s"], 6),
                      "ops": v["ops"]}
                  for k, v in sorted(spans.items(),
                                     key=lambda kv: -kv[1]["device_s"])},
        "programs": {k: round(v, 6) for k, v in
                     sorted(programs.items(), key=lambda kv: -kv[1])},
        "top_programs": [[k, round(v, 6)] for k, v in top],
        "annotations": len(annos),
        "ops": len(ops),
    }


def _kernel_spans(parsed: Dict[str, Any], names) -> Dict[str, Dict]:
    """For each port kernel in ``names``: the spans its launches joined,
    with device seconds and ops."""
    annos = parsed["annotations"]
    out: Dict[str, Dict[str, Dict[str, Any]]] = {}
    for op in parsed["ops"]:
        if op["module"] not in names:
            continue
        a = _covering(annos, op.get("launch_ts", op["ts"]))
        span = a["name"] if a is not None else None
        agg = out.setdefault(op["module"], {}).setdefault(
            span, {"device_s": 0.0, "ops": 0})
        agg["device_s"] += op["dur"]
        agg["ops"] += 1
    return {k: {s: {"device_s": round(v["device_s"], 6), "ops": v["ops"]}
                for s, v in d.items()} for k, d in out.items()}


def finalize_report(path: str, device=None) -> Dict[str, Any]:
    """Parse and attribute a capture and join the recorded kernel costs
    into roofline columns.  Never raises: a failure lands as an
    ``error`` field, so the summary section always exists."""
    try:
        parsed = parse_capture(path)
        report = attribute(parsed)
        report["op_source"] = parsed["op_source"]
        from .chip_specs import device_kind, peaks_for, roofline
        peaks = peaks_for(device_kind(device))
        costs = kernel_costs()
        rows = []
        for name, cost in sorted(costs.items()):
            dev_s = report["programs"].get(name)
            rate_key = ("int32_ops_per_s" if cost["op_kind"] == "int32"
                        else "flops_per_s")
            p = dict(peaks, flops_per_s=peaks.get(rate_key))
            row = {"kernel": name, "launches": cost["launches"],
                   "op_kind": cost["op_kind"], "device_s": dev_s}
            row.update(roofline(cost["ops"], cost["bytes"], dev_s, p))
            rows.append(row)
        report["kernel_spans"] = _kernel_spans(parsed, set(costs))
        report["cost_model"] = {
            "device_kind": peaks.get("kind"),
            "peaks": {k: peaks.get(k) for k in
                      ("flops_per_s", "int32_ops_per_s", "hbm_bytes_per_s",
                       "source", "sentinel") if peaks.get(k) is not None},
            "kernels": rows,
        }
        return report
    except Exception as exc:            # noqa: BLE001 - degrade, never die
        return {"error": f"{type(exc).__name__}: {exc}", "source": path}
