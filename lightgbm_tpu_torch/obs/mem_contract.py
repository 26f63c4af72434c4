"""Runtime memory watermark contract (``LGBM_TPU_MEM_CONTRACT=1``).

The JAX package's ``obs/mem_contract.py`` on torch's allocator.  Under
the contract the training loop samples device memory once an iteration
(the serving harness once a batch) and holds two properties over the
steady state:

* **leak gate** — once warmup is over (the first samples: first-touch
  allocations land there), the sampled live bytes may not grow past
  ``baseline + tolerance``.  The comparison is against the steady
  baseline, not the previous sample, so a slow creep accumulates into a
  violation.  Tolerance: ``LGBM_TPU_MEM_TOL_BYTES`` (default 1 MiB) +
  ``LGBM_TPU_MEM_TOL_FRAC`` (default 0.02) x baseline.
* **in-place score update** — the port adds each tree's values into the
  score state in place (the JAX package donates the buffer instead), so
  at an iteration boundary at most one live tensor of the score state's
  shape, dtype and device may exist (:meth:`Watermark.check_inplace`;
  other models alive in the process count into the first check's
  baseline, so only growth during the run is flagged).

A violation emits a ``mem:watermark_violation`` event naming the span
that crossed the watermark; the report lands in the run summary as the
``mem_contract`` / ``serve_mem_contract`` section.

Sampling sources:

1. on the card, ``torch.cuda.memory_allocated`` and
   ``max_memory_allocated`` (``"memory_allocated"``);
2. on the CPU, the bytes of the distinct storages of the live
   ``torch.Tensor`` objects that ``gc.get_objects()`` finds
   (``"live_tensors"``): the counterpart of ``jax.live_arrays``, slow,
   and paid only under the contract.

:func:`peak_hbm_bytes` is the process's device peak for reports, or
``(None, reason)`` off the card.
"""
from __future__ import annotations

import gc
import os
from typing import Any, Callable, Dict, List, Optional, Tuple

__all__ = [
    "enabled", "device_memory_sample", "peak_hbm_bytes", "count_live_like",
    "Watermark", "maybe_watermark",
]


def enabled() -> bool:
    return os.environ.get("LGBM_TPU_MEM_CONTRACT", "") == "1"


def _tol_bytes() -> int:
    return int(os.environ.get("LGBM_TPU_MEM_TOL_BYTES", 1 << 20))


def _tol_frac() -> float:
    return float(os.environ.get("LGBM_TPU_MEM_TOL_FRAC", 0.02))


def _live_tensors(device_type: Optional[str] = None):
    """Every live tensor the garbage collector tracks (on ``device_type``
    when given)."""
    import torch
    out = []
    for o in gc.get_objects():
        if issubclass(type(o), torch.Tensor):
            try:
                if device_type is None or o.device.type == device_type:
                    out.append(o)
            except RuntimeError:        # a tensor without storage
                pass
    return out


def _on_card(device) -> bool:
    import torch
    if device is not None:
        return torch.device(device).type == "cuda"
    return torch.cuda.is_available() and torch.cuda.is_initialized()


def device_memory_sample(device=None) -> Tuple[int, Optional[int], str]:
    """-> ``(live_bytes, peak_bytes or None, source)``.  Never raises."""
    import torch
    try:
        if _on_card(device):
            dev = torch.device(device) if device is not None else None
            return (int(torch.cuda.memory_allocated(dev)),
                    int(torch.cuda.max_memory_allocated(dev)) or None,
                    "memory_allocated")
        seen = {}
        for t in _live_tensors("cpu"):
            st = t.untyped_storage()
            seen[st.data_ptr()] = st.nbytes()
        return sum(seen.values()), None, "live_tensors"
    except Exception:                   # noqa: BLE001 - absence is the
        return 0, None, "unavailable"   # signal


def peak_hbm_bytes(device=None) -> Tuple[Optional[int], Optional[str]]:
    """The process's device memory peak: ``(bytes, None)`` on the card,
    else ``(None, reason)``."""
    import torch
    if not torch.cuda.is_available():
        return None, "no CUDA device: no allocator peak"
    try:
        return int(torch.cuda.max_memory_allocated(device)), None
    except Exception as exc:            # noqa: BLE001
        return None, f"max_memory_allocated failed: {type(exc).__name__}"


def count_live_like(shape, dtype, device) -> int:
    """Live tensors of ``(shape, dtype, device)`` in this process (views
    of one storage count once) — the in-place update probe."""
    import torch
    try:
        dev = torch.device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        storages = set()
        for t in _live_tensors(dev.type):
            if tuple(t.shape) == tuple(shape) and t.dtype == dtype \
                    and t.device == dev:
                storages.add(t.untyped_storage().data_ptr())
        return len(storages)
    except Exception:                   # noqa: BLE001 - best effort
        return -1


class Watermark:
    """Per-run watermark state: :meth:`sample` at every iteration / batch
    boundary, :meth:`finalize` once at the end (writes the summary
    section).  ``sampler`` is injectable for unit tests."""

    def __init__(self, kind: str, warmup: int = 1,
                 sampler: Optional[Callable[[], Tuple[int, Optional[int],
                                                      str]]] = None,
                 device=None):
        self.kind = kind
        self.warmup = max(0, int(warmup))
        self._sampler = sampler or (lambda: device_memory_sample(device))
        self.samples: List[Dict[str, Any]] = []
        self.violations: List[Dict[str, Any]] = []
        self.baseline: Optional[int] = None
        self.source = "unsampled"
        self.max_bytes = 0
        self.peak_bytes: Optional[int] = None
        self.inplace_checked = False
        self.inplace_ok = True
        self._inplace_base: Optional[int] = None

    def sample(self, span: str, **attrs) -> None:
        live, peak, source = self._sampler()
        self.source = source
        self.max_bytes = max(self.max_bytes, live)
        if peak is not None:
            self.peak_bytes = peak
        idx = len(self.samples)
        rec = {"span": span, "bytes": int(live), "idx": idx}
        rec.update(attrs)
        self.samples.append(rec)
        if source == "unavailable":
            return
        if idx < self.warmup:
            return
        if self.baseline is None:
            self.baseline = int(live)
            return
        tol = _tol_bytes() + int(_tol_frac() * self.baseline)
        if live > self.baseline + tol:
            grew = int(live - self.baseline)
            self.violations.append(
                {"span": span, "grew_bytes": grew, "bytes": int(live),
                 "baseline": self.baseline, "tol_bytes": tol, "idx": idx})
            from .telemetry import event
            event("mem", "watermark_violation", contract=self.kind,
                  span=span, grew_bytes=grew, baseline=self.baseline,
                  tol_bytes=tol)
            from ..utils.log import log_warning
            log_warning(
                f"mem contract violated in {self.kind}: live bytes grew "
                f"{grew} over the steady baseline {self.baseline} "
                f"(tol {tol}) at span {span!r} — a per-iteration leak")

    def check_inplace(self, shape, dtype, device, expected: int = 1) -> None:
        """More than ``expected`` live ``(shape, dtype, device)`` tensors at
        an iteration boundary means the score update stopped being in
        place.  Tensors of that shape already alive at the first check
        (other models' score states) raise the allowance to their count:
        what is flagged is growth during the run."""
        n = count_live_like(shape, dtype, device)
        if n < 0:
            return
        self.inplace_checked = True
        if self._inplace_base is None:
            self._inplace_base = max(n, expected)
        if n > self._inplace_base:
            self.inplace_ok = False
            self.violations.append(
                {"span": f"{self.kind}.inplace", "live_score_tensors": n,
                 "expected": expected})
            from .telemetry import event
            event("mem", "watermark_violation", contract=self.kind,
                  span=f"{self.kind}.inplace", live_score_tensors=n,
                  expected=expected)

    def report(self) -> Dict[str, Any]:
        return {
            "kind": self.kind,
            "source": self.source,
            "windows_sampled": len(self.samples),
            "baseline_bytes": self.baseline,
            "max_bytes": self.max_bytes,
            "peak_bytes": self.peak_bytes,
            "tol_bytes": (_tol_bytes()
                          + int(_tol_frac() * (self.baseline or 0))),
            "violations": self.violations[:16],
            "violation_count": len(self.violations),
            "inplace_checked": self.inplace_checked,
            "inplace_ok": self.inplace_ok,
            "steady_ok": not self.violations,
        }

    def finalize(self, section: Optional[str] = None) -> Dict[str, Any]:
        rep = self.report()
        from .telemetry import set_section
        set_section(section or "mem_contract", rep)
        return rep


class maybe_watermark:
    """``with maybe_watermark("gbdt", device=dev) as wm:`` — a live
    :class:`Watermark` under ``LGBM_TPU_MEM_CONTRACT=1`` (its section
    written on exit), else None."""

    def __init__(self, kind: str, section: Optional[str] = None,
                 warmup: int = 1, device=None):
        self.kind = kind
        self.section = section
        self.warmup = warmup
        self.device = device
        self.wm: Optional[Watermark] = None

    def __enter__(self) -> Optional[Watermark]:
        if enabled():
            self.wm = Watermark(self.kind, warmup=self.warmup,
                                device=self.device)
        return self.wm

    def __exit__(self, *exc) -> bool:
        if self.wm is not None:
            self.wm.finalize(self.section)
        return False
