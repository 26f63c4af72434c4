"""Per-device-kind peak tables for the roofline columns.

The port's copy of the JAX package's ``obs/chip_specs.py``, with the
port's card in place of the TPU rows.  The device-time attribution layer
(``obs/profiler.py``) turns each kernel's bytes and operations (counted
by its wrapper while a capture is live) and its measured device time
into shares of these nameplate peaks.

Numbers are nameplate (vendor-published) peaks, not measurements; a
share against them is conservative.  The ``cpu`` entry is an explicit
SENTINEL: the CPU tests run the whole attribution pipeline on the plain
versions, where a share of a machine-dependent peak would mean nothing;
the sentinel keeps the arithmetic exercised and every report flagged
``sentinel: true``.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

__all__ = ["CHIP_PEAKS", "device_kind", "peaks_for", "roofline"]

# kind -> {flops_per_s (float32), hbm_bytes_per_s, source, ...}
CHIP_PEAKS: Dict[str, Dict[str, Any]] = {
    "h100": {
        "flops_per_s": 67e12, "hbm_bytes_per_s": 3.35e12,
        "bf16_flops_per_s": 989e12,
        # 132 SMs x 64 int32 adds a clock x 1,980 MHz
        "int32_ops_per_s": 132 * 64 * 1980e6,
        "source": ("H100 SXM5 nameplate (NVIDIA H100 data sheet): HBM3 "
                   "3.35 TB/s, FP32 67 TFLOP/s, BF16 dense 989 TFLOP/s; "
                   "int32: 64 adds a clock an SM at compute capability "
                   "9.0 (CUDA C++ Programming Guide) x 132 SMs x 1,980 "
                   "MHz")},
    # sentinel, not a measurement: keeps the roofline arithmetic (and
    # its CPU tests) runnable on the plain versions
    "cpu": {"flops_per_s": 1e11, "hbm_bytes_per_s": 5e10,
            "int32_ops_per_s": 1e11,
            "source": "CPU SENTINEL (CPU-test mechanics only)",
            "sentinel": True},
}


def _normalize(kind: str) -> Optional[str]:
    k = (kind or "").lower()
    if "h100" in k:
        return "h100"
    if "cpu" in k or "host" in k:
        return "cpu"
    return None


def device_kind(device=None) -> str:
    """The kind of ``device`` (default: the current CUDA device when one
    is available, else the CPU): ``torch.cuda.get_device_name`` or
    ``"cpu"``."""
    import torch
    dev = torch.device(device) if device is not None else None
    if dev is not None and dev.type != "cuda":
        return dev.type
    try:
        if torch.cuda.is_available():
            return str(torch.cuda.get_device_name(dev))
    except Exception:                   # noqa: BLE001 - best-effort probe
        return "unknown"
    return "cpu"


def peaks_for(kind: Optional[str] = None) -> Dict[str, Any]:
    """Peak table entry for ``kind`` (default: the current device).
    Unknown kinds return an explicit no-peaks entry: roofline columns are
    then ``null`` instead of a made-up peak."""
    raw = kind if kind is not None else device_kind()
    key = _normalize(raw)
    if key is None:
        return {"kind": raw, "flops_per_s": None, "hbm_bytes_per_s": None,
                "source": f"no peak table entry for {raw!r}"}
    out = dict(CHIP_PEAKS[key])
    out["kind"] = raw
    out["key"] = key
    return out


def roofline(flops: Optional[float], bytes_accessed: Optional[float],
             device_time_s: Optional[float],
             peaks: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Roofline columns for one kernel (the JAX package's arithmetic).

    Static half: arithmetic intensity (operations per byte) and the
    ridge point.  Measured half (with device time): achieved operations
    and bytes per second as percentages of peak and a ``bound`` verdict —
    ``compute`` / ``memory`` when the larger share is meaningful, ``host``
    when both are under 5% (the device is starved)."""
    p = peaks if peaks is not None else peaks_for()
    pf, pb = p.get("flops_per_s"), p.get("hbm_bytes_per_s")
    out: Dict[str, Any] = {
        "flops": flops, "bytes_accessed": bytes_accessed,
        "arith_intensity": (flops / bytes_accessed
                            if flops and bytes_accessed else None),
        "ridge_flops_per_byte": (pf / pb if pf and pb else None),
        "pct_peak_flops": None, "pct_peak_bw": None, "bound": None,
    }
    if device_time_s and device_time_s > 0:
        if flops and pf:
            out["pct_peak_flops"] = round(
                100.0 * flops / device_time_s / pf, 3)
        if bytes_accessed and pb:
            out["pct_peak_bw"] = round(
                100.0 * bytes_accessed / device_time_s / pb, 3)
        cf = out["pct_peak_flops"] or 0.0
        cb = out["pct_peak_bw"] or 0.0
        if max(cf, cb) < 5.0:
            out["bound"] = "host"
        else:
            out["bound"] = "compute" if cf >= cb else "memory"
    elif out["arith_intensity"] is not None \
            and out["ridge_flops_per_byte"] is not None:
        out["bound"] = ("compute" if out["arith_intensity"]
                        >= out["ridge_flops_per_byte"] else "memory")
    return out
