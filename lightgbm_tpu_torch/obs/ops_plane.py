"""Live ops plane: ``/metrics``, ``/healthz`` and ``/drain`` over HTTP.

A copy of the JAX package's ``obs/ops_plane.py`` (stdlib only): the run
summary of ``obs/telemetry.py`` is read after a run; a serving replica or
a long training run needs the same numbers while it runs.

* a **metrics registry** (:class:`MetricsRegistry`) fed by the telemetry
  hooks through one seam (``telemetry.set_sink``): counters and gauges
  mirror the run summary live, every span close feeds a bounded
  rolling-window quantile sketch of its duration (the last
  ``LGBM_TPU_OPS_SKETCH`` samples, default 4096), and the runtime lock
  contract (``obs/lock_contract.py``) feeds per-lock wait sketches.  Not
  mounted, the sink is None and telemetry costs what it did before;
* an **HTTP daemon thread** (``http.server.ThreadingHTTPServer`` on
  ``127.0.0.1:$LGBM_TPU_OPS_PORT``; ``0`` picks an ephemeral port)
  serving

  - ``GET /metrics`` — Prometheus text format v0.0.4
    (:meth:`MetricsRegistry.render_prometheus`): counters as
    ``lgbm_tpu_<name>_total``, gauges as ``lgbm_tpu_<name>``, events as
    ``lgbm_tpu_events_total{family=..,name=..}``, span sketches as
    ``lgbm_tpu_span_seconds{span=..,quantile=..}``, lock waits as
    ``lgbm_tpu_lock_wait_seconds{lock=..,quantile=..}``, and
    ``lgbm_tpu_health_state`` one-hot;
  - ``GET /healthz`` — the health state machine (``obs/health.py``) as
    JSON; 200 while live, 503 once stalled or degraded;
  - ``GET|POST /drain`` — runs the registered drain hooks (the serving
    harness registers one: stop accepting, flush the queue, report) and
    returns their reports.

Mounted by ``lgb.train``, ``train_streaming`` and ``PredictionServer``
through :func:`mount` (idempotent: the first mount starts the thread,
later ones attach as owners).  Mounting never touches the device.
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from .lock_contract import named_lock

__all__ = [
    "RollingQuantiles", "MetricsRegistry", "OpsPlane", "enabled",
    "mount", "plane", "shutdown", "sketch_cap",
]


def enabled() -> bool:
    return os.environ.get("LGBM_TPU_OPS_PORT", "") != ""


def sketch_cap() -> int:
    return max(16, int(os.environ.get("LGBM_TPU_OPS_SKETCH", "4096")))


class RollingQuantiles:
    """Bounded rolling-window quantile sketch: a fixed-size ring of the
    last ``cap`` samples.  ``count`` keeps the all-time total; the
    quantiles describe the window — exactly what a live latency
    readout wants (an all-time list both grows without bound and
    freezes the percentiles on ancient history)."""

    __slots__ = ("_buf", "_cap", "count")

    def __init__(self, cap: Optional[int] = None):
        self._cap = int(cap) if cap else sketch_cap()
        self._buf: List[float] = []
        self.count = 0

    def observe(self, v: float) -> None:
        if len(self._buf) < self._cap:
            self._buf.append(float(v))
        else:
            self._buf[self.count % self._cap] = float(v)
        self.count += 1

    def quantiles(self, qs=(50.0, 99.0, 99.9)) -> Dict[float, float]:
        if not self._buf:
            return {}
        a = np.asarray(self._buf)
        return {float(q): float(np.percentile(a, q)) for q in qs}

    def stats_ms(self) -> Dict[str, Any]:
        """The serving-stats shape: count + p50/p99/p999 milliseconds."""
        q = self.quantiles()
        return {"count": self.count,
                "p50": round(q.get(50.0, 0.0) * 1e3, 3),
                "p99": round(q.get(99.0, 0.0) * 1e3, 3),
                "p999": round(q.get(99.9, 0.0) * 1e3, 3)}


def _sanitize(name: str) -> str:
    return "".join(c if c.isalnum() or c == "_" else "_" for c in name)


def _fmt(v: Any) -> str:
    if isinstance(v, bool):
        return "1" if v else "0"
    if isinstance(v, (int, float)):
        return repr(float(v)) if isinstance(v, float) else str(v)
    return "NaN"


class MetricsRegistry:
    """The telemetry sink (see ``telemetry.set_sink``): mirrors
    counters/gauges/events live and keeps one rolling duration sketch
    per span name.  Its lock is leaf-level — taken inside the telemetry
    lock on the write path, alone on the render path."""

    def __init__(self):
        self._lock = named_lock("metrics_registry")
        self.counters: Dict[str, float] = {}
        self.gauges: Dict[str, Any] = {}
        self.events: Dict[str, int] = {}
        self.spans: Dict[str, RollingQuantiles] = {}
        # per-lock wait sketches + contended counts, fed by the runtime
        # lock contract (obs/lock_contract.py) when it is armed
        self.lock_waits: Dict[str, RollingQuantiles] = {}
        self.lock_contended: Dict[str, int] = {}

    # -- sink interface (called from telemetry, under its lock) ---------
    def counter(self, name: str, add: float, value: float) -> None:
        with self._lock:
            self.counters[name] = value

    def gauge(self, name: str, value: Any) -> None:
        with self._lock:
            self.gauges[name] = value

    def event(self, key: str, count: int) -> None:
        with self._lock:
            self.events[key] = count

    def span(self, name: str, dur_s: float) -> None:
        with self._lock:
            sk = self.spans.get(name)
            if sk is None:
                sk = self.spans[name] = RollingQuantiles()
            # RollingQuantiles.observe, inline: this runs for every span
            if len(sk._buf) < sk._cap:
                sk._buf.append(float(dur_s))
            else:
                sk._buf[sk.count % sk._cap] = float(dur_s)
            sk.count += 1

    def lock_wait(self, name: str, wait_s: float,
                  contended: bool = False) -> None:
        with self._lock:
            sk = self.lock_waits.get(name)
            if sk is None:
                sk = self.lock_waits[name] = RollingQuantiles()
            sk.observe(wait_s)
            if contended:
                self.lock_contended[name] = \
                    self.lock_contended.get(name, 0) + 1

    # -- render ---------------------------------------------------------
    def render_prometheus(self) -> str:
        from . import health
        out: List[str] = []
        with self._lock:
            counters = dict(self.counters)
            gauges = dict(self.gauges)
            events = dict(self.events)
            sketches = {k: (v.count, v.quantiles())
                        for k, v in self.spans.items()}
            lock_sketches = {k: (v.count, v.quantiles())
                             for k, v in self.lock_waits.items()}
            lock_contended = dict(self.lock_contended)
        for name in sorted(counters):
            mn = f"lgbm_tpu_{_sanitize(name)}_total"
            out.append(f"# TYPE {mn} counter")
            out.append(f"{mn} {_fmt(counters[name])}")
        for name in sorted(gauges):
            v = gauges[name]
            if not isinstance(v, (int, float, bool)):
                continue            # non-numeric gauges stay JSON-only
            mn = f"lgbm_tpu_{_sanitize(name)}"
            out.append(f"# TYPE {mn} gauge")
            out.append(f"{mn} {_fmt(v)}")
        if events:
            out.append("# TYPE lgbm_tpu_events_total counter")
            for key in sorted(events):
                family, _, name = key.partition(":")
                out.append(
                    f'lgbm_tpu_events_total{{family="{family}",'
                    f'name="{name}"}} {events[key]}')
        if sketches:
            out.append("# TYPE lgbm_tpu_span_seconds summary")
            for name in sorted(sketches):
                count, q = sketches[name]
                sn = _sanitize(name)
                for qv, val in sorted(q.items()):
                    out.append(
                        f'lgbm_tpu_span_seconds{{span="{sn}",'
                        f'quantile="{qv / 100.0:g}"}} {_fmt(val)}')
                out.append(
                    f'lgbm_tpu_span_seconds_count{{span="{sn}"}} {count}')
        if lock_sketches:
            out.append("# TYPE lgbm_tpu_lock_wait_seconds summary")
            for name in sorted(lock_sketches):
                count, q = lock_sketches[name]
                ln = _sanitize(name)
                for qv, val in sorted(q.items()):
                    out.append(
                        f'lgbm_tpu_lock_wait_seconds{{lock="{ln}",'
                        f'quantile="{qv / 100.0:g}"}} {_fmt(val)}')
                out.append(
                    f'lgbm_tpu_lock_wait_seconds_count{{lock="{ln}"}} '
                    f'{count}')
        if lock_contended:
            out.append("# TYPE lgbm_tpu_lock_contended_total counter")
            for name in sorted(lock_contended):
                out.append(
                    f'lgbm_tpu_lock_contended_total'
                    f'{{lock="{_sanitize(name)}"}} '
                    f'{lock_contended[name]}')
        st = health.state()
        out.append("# TYPE lgbm_tpu_health_state gauge")
        for s in ("warming", "ready", "draining", "degraded", "stalled"):
            out.append(f'lgbm_tpu_health_state{{state="{s}"}} '
                       f'{1 if st["state"] == s else 0}')
        return "\n".join(out) + "\n"


class _Handler:
    """Request handler factory bound to a plane instance (the stdlib
    handler is a class, so the plane rides a closure)."""

    @staticmethod
    def build(plane: "OpsPlane"):
        from http.server import BaseHTTPRequestHandler

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):   # silence per-request stderr
                pass

            def _send(self, code: int, body: str, ctype: str) -> None:
                data = body.encode()
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def _route(self) -> None:
                from . import health
                path = self.path.split("?", 1)[0].rstrip("/") or "/"
                if path == "/metrics":
                    self._send(200, plane.registry.render_prometheus(),
                               "text/plain; version=0.0.4; charset=utf-8")
                elif path == "/healthz":
                    st = health.state()
                    st["owners"] = sorted(plane.owners)
                    st["uptime_s"] = round(time.time() - plane.t0, 3)
                    code = 503 if st["state"] in ("stalled",
                                                  "degraded") else 200
                    self._send(code, json.dumps(st), "application/json")
                elif path == "/drain":
                    self._send(200, json.dumps(plane.drain()),
                               "application/json")
                else:
                    self._send(404, json.dumps(
                        {"error": f"unknown path {path!r}",
                         "paths": ["/metrics", "/healthz", "/drain"]}),
                        "application/json")

            def do_GET(self):       # noqa: N802 - stdlib handler API
                self._route()

            def do_POST(self):      # noqa: N802 - stdlib handler API
                self._route()

        return Handler


class OpsPlane:
    """The mounted plane: registry + HTTP daemon thread + drain hooks."""

    def __init__(self, port: int):
        from http.server import ThreadingHTTPServer
        from . import telemetry
        self.t0 = time.time()
        self.owners: set = set()
        self.registry = MetricsRegistry()
        # registered from the owning (main) thread, swapped out by the
        # HTTP /drain thread: the hook list needs its own leaf lock
        self._hooks_lock = named_lock("ops_drain")
        self._drain_hooks: List[Callable[[], Any]] = []
        self._server = ThreadingHTTPServer(
            ("127.0.0.1", int(port)), _Handler.build(self))
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(
            target=self._server.serve_forever, name="lgbm-torch-ops",
            daemon=True)
        self._thread.start()
        # the registry mirrors the run summary: the summary must be
        # accumulating for there to be anything to mirror
        telemetry.enable()
        telemetry.set_sink(self.registry)
        from ..utils.log import log_info
        log_info(f"ops plane listening on 127.0.0.1:{self.port} "
                 f"(/metrics /healthz /drain)")

    def register_drain(self, fn: Callable[[], Any]) -> None:
        with self._hooks_lock:
            self._drain_hooks.append(fn)

    def drain(self) -> Dict[str, Any]:
        """Run every registered drain hook (serving: stop accepting,
        flush the queue) and report.  Idempotent — hooks run once."""
        from . import health
        with self._hooks_lock:
            hooks, self._drain_hooks = self._drain_hooks, []
        health.mark_draining(requested=True)
        reports = []
        for fn in hooks:
            try:
                reports.append(fn())
            # a failing hook must not mask the other hooks' drains; the
            # error lands in the report
            except Exception as exc:    # noqa: BLE001
                reports.append({"error": f"{type(exc).__name__}: {exc}"})
        return {"drained": bool(hooks), "reports": reports,
                "health": health.state()}

    def shutdown(self) -> None:
        from . import telemetry
        telemetry.set_sink(None)
        self._server.shutdown()
        self._server.server_close()
        self._thread.join(timeout=5.0)


_lock = named_lock("ops_plane")
_plane: Optional[OpsPlane] = None


def plane() -> Optional[OpsPlane]:
    return _plane


def mount(owner: str) -> Optional[OpsPlane]:
    """Mount the ops plane for ``owner`` (``"train"`` / ``"serve"``).
    Returns None unless ``LGBM_TPU_OPS_PORT`` is set; the first mount
    starts the HTTP thread and installs the telemetry sink, later
    mounts just attach.  Never raises into the training or serving
    path: a busy port degrades to a logged warning."""
    global _plane
    if not enabled():
        return None
    with _lock:
        if _plane is None:
            from . import health
            try:
                _plane = OpsPlane(int(os.environ["LGBM_TPU_OPS_PORT"]))
            # a busy port or a denied bind degrades the ops plane, never
            # the training run
            except Exception as exc:    # noqa: BLE001
                from ..utils.log import log_once
                log_once("ops_plane_bind_failed",
                         f"ops plane failed to start "
                         f"(LGBM_TPU_OPS_PORT="
                         f"{os.environ.get('LGBM_TPU_OPS_PORT')}): {exc}",
                         level="warning")
                return None
            health._set_active(True)
        _plane.owners.add(owner)
        return _plane


def shutdown() -> None:
    """Stop the HTTP thread and uninstall the sink (tests; graceful
    process teardown)."""
    global _plane
    with _lock:
        if _plane is not None:
            _plane.shutdown()
            _plane = None
