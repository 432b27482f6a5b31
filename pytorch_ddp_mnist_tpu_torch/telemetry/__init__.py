"""telemetry/ — the port's copies of the three stdlib-only modules of the
JAX package's `telemetry/` that the serve path imports:

  * `registry.py` — counters / gauges / histograms, get-or-create by name,
    the whole process snapshot-able as ONE JSON dict;
  * `events.py`   — the schema-v1 JSONL event trace with nestable spans
    and the explicit-parent `emit_span` of the serve path; a no-op
    `NullTracer` until `enable()`;
  * `flight.py`   — the bounded ring-buffer flight recorder, dumped to disk
    on drain, failure or SIGTERM.

The JAX package's `telemetry/__init__` imports jax, so the port keeps its
own copies. `analysis.py` holds only the fleet/reload record contract the
replica fleet answers to; the rest of that package (runtime collectors,
analysis, export, health, Prometheus, costs) is not ported yet (ROADMAP.md
queue 1, item 12).
"""

from . import events, flight  # noqa: F401
from .events import EventTrace, NullTracer, disable, enable, get_tracer  # noqa: F401
from .registry import (Counter, Gauge, Histogram, MetricsRegistry,  # noqa: F401
                       get_registry)
