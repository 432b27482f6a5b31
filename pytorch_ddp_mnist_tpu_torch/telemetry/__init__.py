"""telemetry/ — the port's copies of the JAX package's `telemetry/`
modules, the write side the trainer and the serve path run and the read
side that turns their files into reports and gates:

  * `registry.py` — counters / gauges / histograms, get-or-create by name,
    the whole process snapshot-able as ONE JSON dict;
  * `events.py`   — the schema-v1 JSONL event trace with nestable spans
    and the explicit-parent `emit_span` of the serve path; a no-op
    `NullTracer` until `enable()`;
  * `flight.py`   — the bounded ring-buffer flight recorder, dumped to disk
    on drain, failure or SIGTERM;
  * `runtime.py`  — collectors: the cached process index, the capture
    counter (`xla.compiles`: CUDA-graph captures) and its per-label
    attribution (`label_compiles`), `torch.cuda` memory statistics under
    the JAX gauge names, host RSS;
  * `health.py`   — the live training-health watchdog and its policies;
  * `prom.py`     — `/metrics` (Prometheus text) and `/healthz` from a
    stdlib HTTP thread;
  * `dispatch.py` — the per-step host-boundary profiler;
  * `cluster.py`  — the per-rank collective journal, its hang watchdog,
    and the journal read side (desync, skew, who-is-where);
  * `analysis.py` — the trace read side: the record contracts, the phase,
    serve, data, efficiency and dispatch-overhead reports and their
    regression gates, and the names the writers share;
  * `export.py`   — merged trace (+ journals, + ledger series) -> Chrome
    trace-event JSON; `profiler_trace` is the torch.profiler hatch;
  * `ledger.py`   — the performance ledger over every artifact generation;
  * `costs.py`    — program forensics: per-program cost and memory records
    of the captured DDP step matrix and the serve ladder on the card, the
    measured-vs-analytic attribution, the compile/memory gate, OOM
    forensics.

The JAX package's `telemetry/__init__` imports jax, so the port keeps its
own copies. Front doors: `train --telemetry DIR` (and `--health`,
`--metrics_port`, `--profile_dispatch`, `--journal`), `python -m
pytorch_ddp_mnist_tpu_torch trace report|export|cost` and `... ledger
report|gate`.
"""

from . import (analysis, cluster, costs, dispatch, events,  # noqa: F401
               export, flight, ledger)
from .analysis import (analyze, compare, compare_overhead,  # noqa: F401
                       cost_record_errors, dispatch_record_errors,
                       load_trace, overhead_from_artifact, overhead_report,
                       serve_report, serve_structure_errors,
                       span_structure_errors, trace_files)
from .cluster import (CollectiveJournal, CollectiveWatchdog,  # noqa: F401
                      NullJournal, cluster_report, disable_journal,
                      enable_journal, format_cluster_report, get_journal,
                      journal_files, load_journal, who_is_where)
from .costs import (CostRecord, attribution_from_artifact,  # noqa: F401
                    build_cost_report, compare_cost, harvest_serve_ladder,
                    harvest_step_matrix, looks_like_oom,
                    record_oom_forensics, register_program)
from .dispatch import DispatchProfiler, NullProfiler  # noqa: F401
from .events import EventTrace, NullTracer, disable, enable, get_tracer  # noqa: F401
from .export import (chrome_trace, profiler_trace,  # noqa: F401
                     write_chrome_trace)
from .health import (HealthConfig, HealthEvent,  # noqa: F401
                     TrainingHealthError, Watchdog, device_health_aux,
                     health_summary)
from .prom import (metric_name, render_prometheus,  # noqa: F401
                   start_metrics_server)
from .registry import (Counter, Gauge, Histogram, MetricsRegistry,  # noqa: F401
                       get_registry)
from .runtime import (collect_memory, compile_attribution,  # noqa: F401
                      current_compile_label, device_memory_stats,
                      host_rss_bytes, install_compile_listener,
                      install_memory_watermarks, label_compiles,
                      note_capture, process_index_cached,
                      record_memory_point)
