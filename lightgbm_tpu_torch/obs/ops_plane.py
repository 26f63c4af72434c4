"""Rolling latency quantiles for the serving harness.

The JAX package's ``obs/ops_plane.py`` is a live ``/metrics`` +
``/healthz`` + ``/drain`` HTTP surface fed by its telemetry; the port
has only its bounded quantile sketch so far, copied here for
``serve/server.py``'s per-bucket latency.  The rest of the ops plane
waits for ROADMAP A13.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np

__all__ = ["RollingQuantiles"]

# samples in the ring: enough for a stable p99.9 over the recent window
SKETCH_CAP = 4096


class RollingQuantiles:
    """Bounded rolling-window quantile sketch: a fixed-size ring of the
    last ``cap`` samples.  ``count`` keeps the all-time total; the
    quantiles describe the window — exactly what a live latency
    readout wants (an all-time list both grows without bound and
    freezes the percentiles on ancient history)."""

    __slots__ = ("_buf", "_cap", "count")

    def __init__(self, cap: Optional[int] = None):
        self._cap = int(cap) if cap else SKETCH_CAP
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
