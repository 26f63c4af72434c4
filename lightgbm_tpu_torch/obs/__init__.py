"""Low-overhead training telemetry (see ``obs/telemetry.py``).

The import seam for the rest of the package::

    from ..obs import span, counter_add, event
    with span("snapshot.write") as s:
        ...
        s["bytes"] = n

The runtime contracts and the live health plane are modules of this
package: ``lock_contract``, ``determinism``,
``health``, ``ops_plane``, ``num_contract``, ``mem_contract``,
``trace_contract``, ``chip_specs`` and ``profiler``
(``from ..obs import health, ops_plane``).
"""
from .telemetry import (counter_add, disable, enable, enabled, event,
                        gauge_set, get_sink, hold_trace, merged_summary,
                        release_trace, reset, set_annotator,
                        set_clock_offset, set_rank, set_section, set_sink,
                        span, summary, trace_path, write_summary)

__all__ = [
    "enabled", "enable", "disable", "reset", "span", "counter_add",
    "gauge_set", "event", "summary", "merged_summary", "write_summary",
    "trace_path", "set_section", "set_annotator", "set_sink",
    "get_sink", "set_clock_offset", "set_rank", "hold_trace",
    "release_trace",
]
