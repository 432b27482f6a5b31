"""telemetry/ — the port's copies of the JAX package's `telemetry/`
modules that the trainer and the serve path write with:

  * `registry.py` — counters / gauges / histograms, get-or-create by name,
    the whole process snapshot-able as ONE JSON dict;
  * `events.py`   — the schema-v1 JSONL event trace with nestable spans
    and the explicit-parent `emit_span` of the serve path; a no-op
    `NullTracer` until `enable()`;
  * `flight.py`   — the bounded ring-buffer flight recorder, dumped to disk
    on drain, failure or SIGTERM;
  * `runtime.py`  — collectors: the capture counter (`xla.compiles`: CUDA-graph captures), `torch.cuda`
    memory statistics under the JAX gauge names, host RSS;
  * `health.py`   — the live training-health watchdog and its policies;
  * `prom.py`     — `/metrics` (Prometheus text) and `/healthz` from a
    stdlib HTTP thread;
  * `dispatch.py` — the per-step host-boundary profiler;
  * `cluster.py`  — the per-rank collective journal, its hang watchdog,
    and the journal read side (desync, skew, who-is-where);
  * `analysis.py` — the fleet/reload record contract, the dispatch
    record names and the shared `skew` math.

The JAX package's `telemetry/__init__` imports jax, so the port keeps its
own copies. The rest of that package (the trace and cost reports, the
Perfetto export, the performance ledger) is the read side, not ported yet
(ROADMAP.md queue 1, item 12c).
"""

from . import cluster, dispatch, events, flight  # noqa: F401
from .cluster import (CollectiveJournal, CollectiveWatchdog,  # noqa: F401
                      NullJournal, cluster_report, disable_journal,
                      enable_journal, format_cluster_report, get_journal,
                      journal_files, load_journal, who_is_where)
from .dispatch import DispatchProfiler, NullProfiler  # noqa: F401
from .events import EventTrace, NullTracer, disable, enable, get_tracer  # noqa: F401
from .health import (HealthConfig, HealthEvent,  # noqa: F401
                     TrainingHealthError, Watchdog, device_health_aux,
                     health_summary)
from .prom import (metric_name, render_prometheus,  # noqa: F401
                   start_metrics_server)
from .registry import (Counter, Gauge, Histogram, MetricsRegistry,  # noqa: F401
                       get_registry)
from .runtime import (collect_memory, device_memory_stats,  # noqa: F401
                      host_rss_bytes, install_compile_listener,
                      install_memory_watermarks, note_capture,
                      record_memory_point)
