"""Serving metrics: latency percentiles, queue depth, batch occupancy,
request counters — one JSON-able snapshot, backed by the telemetry
registry (port of `pytorch_ddp_mnist_tpu/serve/metrics.py`: the same
`snapshot()` and `attribution()` schema).

Latencies land in a `telemetry.registry.Histogram` (log-spaced, 2 us
floor, 12 buckets/decade — constant memory at any request rate, percentile
error bounded by the ~21% bucket ratio, always pessimistic), and the
counters/gauges are registry `Counter`/`Gauge` objects under `serve.*`
names. A `ServeMetrics` constructed with the process-wide registry (what
`cli/serve.py` does) is visible in the `{"op": "stats"}` snapshot; the
default is a PRIVATE registry so tests and embedded services stay
hermetic.
"""

from __future__ import annotations

import collections
import math
import threading
import time
from typing import Callable, Optional

from ..telemetry.registry import Histogram, MetricsRegistry
from .tracing import STAGES

# Rolling SLO window length: big enough for a stable p99 (>=100 samples
# past the 99th percentile boundary), small enough that the monitor
# reflects the CURRENT regime, not the whole run — which is the point:
# the cumulative histogram answers "how was the run", this answers "how
# is the service RIGHT NOW".
SLO_WINDOW = 512


def nearest_rank(sorted_vals, q: float) -> float:
    """Exact nearest-rank q-quantile of an ALREADY-SORTED sequence; 0.0
    when empty. The one percentile convention the serve side shares
    (SLOWindow, the loadgen's client-side clock) — two copies of the
    rounding rule would let client-vs-server deltas compare values ranked
    under different conventions. Deliberately the SAME ceil(q*n) formula
    as the JAX package's `telemetry.analysis._percentile`: its `trace
    report --serve` and the live SLO window must never disagree on
    identical samples."""
    if not sorted_vals:
        return 0.0
    rank = max(1, math.ceil(q * len(sorted_vals)))
    return sorted_vals[min(rank, len(sorted_vals)) - 1]


class SLOWindow:
    """Rolling latency/throughput monitor over the most recent
    completions: exact p99 over a bounded window, and the observed
    service rate (completions per second across the window's wall span).

    This is the live half predicted-p99 admission reads (reject on
    PREDICTED p99 = queue depth x observed service rate instead of raw
    queue length): the cumulative `serve.latency_s` histogram
    cannot answer it — a morning of fast traffic forever dilutes an
    afternoon collapse. Constant memory (two bounded deques plus one
    cached sorted copy); the sort is paid at most once per COMPLETION
    (the cache invalidates on `record`), never per read — predicted-p99
    admission reads a percentile on every arrival, and re-sorting 512
    floats per offered request would make the admission check inflate the
    very queue delay it predicts."""

    def __init__(self, window: int = SLO_WINDOW):
        if window < 2:
            raise ValueError(f"window must be >= 2; got {window}")
        self.window = int(window)
        self._lat: "collections.deque[float]" = collections.deque(
            maxlen=self.window)
        self._done_t: "collections.deque[float]" = collections.deque(
            maxlen=self.window)
        self._sorted: "Optional[list]" = None
        # The window is WRITTEN by the serve event loop (record() per
        # completion) and READ by other threads through the
        # serve.rolling_p99_s / serve.service_rate_rps gauge callables —
        # and percentile()'s "read" also WRITES the sorted cache. One lock
        # makes each method atomic; no caller holds it across an await.
        self._lock = threading.Lock()

    def record(self, latency_s: float, t_done: float) -> None:
        with self._lock:
            self._lat.append(float(latency_s))
            self._done_t.append(float(t_done))
            self._sorted = None

    @property
    def n(self) -> int:
        return len(self._lat)

    def percentile(self, q: float) -> float:
        """Exact q-quantile over the window (nearest-rank); 0.0 empty."""
        with self._lock:
            if self._sorted is None:
                self._sorted = sorted(self._lat)
            return nearest_rank(self._sorted, q)

    def service_rate(self) -> Optional[float]:
        """Completions/sec over the window's first..last completion wall
        span; None until two completions exist or when the span is zero
        (injected clocks)."""
        with self._lock:
            if len(self._done_t) < 2:
                return None
            span = self._done_t[-1] - self._done_t[0]
            if span <= 0:
                return None
            return (len(self._done_t) - 1) / span

    def snapshot(self) -> dict:
        rate = self.service_rate()
        return {
            "window_n": self.n,
            "rolling_p50_ms": round(self.percentile(0.50) * 1e3, 3),
            "rolling_p99_ms": round(self.percentile(0.99) * 1e3, 3),
            "service_rate_rps": round(rate, 2) if rate is not None else None,
        }


class LatencyHistogram(Histogram):
    """DEPRECATED thin alias of `telemetry.registry.Histogram` — import
    that instead. Kept so existing callers (and their tests) run unchanged;
    the seconds-unit property spellings survive here."""

    @property
    def total_s(self) -> float:
        return self.total

    @property
    def max_s(self) -> float:
        return self.max

    @property
    def mean_s(self) -> float:
        return self.mean


class ServeMetrics:
    """Aggregated serving counters + latency histogram.

    `depth_fn` (optional) reads the live queue depth at snapshot time, so
    the gauge reflects the instant, not an average. The requests/sec
    counter is completed requests over the first-arrival..last-completion
    wall span — the achieved (not offered) rate. `registry` (optional)
    selects where the `serve.*` metrics live; pass
    `telemetry.get_registry()` to publish into the process-wide snapshot.
    """

    def __init__(self, depth_fn: Optional[Callable[[], int]] = None,
                 clock: Callable[[], float] = time.monotonic,
                 registry: Optional[MetricsRegistry] = None):
        self.registry = registry if registry is not None else MetricsRegistry()
        # the deprecated subclass keeps .latency's *_s spellings working
        # for external readers of the old private type; a SECOND metrics
        # instance on the same registry adopts the live histogram instead
        # (get-or-adopt — the same merge semantics the counters below get
        # from the registry's get-or-create)
        try:
            self.latency = LatencyHistogram("serve.latency_s")
            self.registry.register("serve.latency_s", self.latency)
        except ValueError:
            adopted = self.registry.histogram("serve.latency_s")
            if not isinstance(adopted, LatencyHistogram):
                # property-only subclass, no extra state: reclassing keeps
                # the *_s compat spellings working regardless of which
                # owner created the live histogram first
                adopted.__class__ = LatencyHistogram
            self.latency = adopted
        self._completed = self.registry.counter("serve.completed")
        self._rejected = self.registry.counter("serve.rejected")
        self._failed = self.registry.counter("serve.failed")
        self._batches = self.registry.counter("serve.batches")
        self._batched_rows = self.registry.counter("serve.batched_rows")
        self._bucket_rows = self.registry.counter("serve.bucket_rows")
        self.depth_fn = depth_fn
        if depth_fn is not None:
            self.registry.gauge("serve.queue_depth").set_fn(depth_fn)
        self.clock = clock
        self._t_first: Optional[float] = None
        self._t_last: Optional[float] = None
        # Rolling SLO monitor (live p99 + observed service rate): always
        # on — two bounded deques cost nothing — and published as registry
        # gauges so {"op": "stats"}/"health"
        # read the same live numbers. set_fn (not set) so a scrape reads
        # the instant; a second ServeMetrics on the same registry rebinds
        # the gauges to its own window, same get-or-adopt story as above.
        self.slo = SLOWindow()
        self.registry.gauge("serve.rolling_p99_s").set_fn(
            lambda: self.slo.percentile(0.99) if self.slo.n else None)
        self.registry.gauge("serve.service_rate_rps").set_fn(
            self.slo.service_rate)
        # Request-scoped attribution (serve/tracing.py): one histogram per
        # pipeline stage, fed by ServeTracer.finish on every completed
        # request — the same stage names the JSONL spans and the
        # JAX package's `trace report --serve` table use. Per-stage observed service
        # rate (completions / stage-busy-seconds = 1 / mean stage time)
        # rides as a derived gauge: the capacity number a fleet router
        # needs per stage, not just end-to-end. `serve.predicted_p99_s`
        # is the admission predictor — rolling p99 + depth / service rate
        # (what a request arriving NOW should expect its tail to be).
        self._stage_hists = {}
        for stage in STAGES:
            h = self.registry.histogram(f"serve.stage.{stage}_s")
            self._stage_hists[stage] = h
            self.registry.gauge(f"serve.stage.{stage}_rate_rps").set_fn(
                (lambda hist: lambda: (hist.n / hist.total
                                       if hist.total > 0 else None))(h))
        # the histograms in STAGES order, for the tuple-shaped hot-path
        # recorder (record_stage_values: one zip, no key lookups)
        self._stage_hist_list = [self._stage_hists[s] for s in STAGES]
        self.registry.gauge("serve.predicted_p99_s").set_fn(
            self.predicted_p99)

    # counter values under their historical attribute names
    @property
    def completed(self) -> int:
        return self._completed.value

    @property
    def rejected(self) -> int:
        return self._rejected.value

    @property
    def failed(self) -> int:
        return self._failed.value

    @property
    def batches(self) -> int:
        return self._batches.value

    @property
    def batched_rows(self) -> int:
        return self._batched_rows.value

    @property
    def bucket_rows(self) -> int:
        return self._bucket_rows.value

    # -- recording hooks --------------------------------------------------

    def record_arrival(self) -> None:
        if self._t_first is None:
            self._t_first = self.clock()

    def record_done(self, latency_s: float) -> None:
        self.latency.record(latency_s)
        self._completed.inc()
        self._t_last = self.clock()
        self.slo.record(latency_s, self._t_last)

    def record_reject(self) -> None:
        self._rejected.inc()
        if self._t_first is None:
            self._t_first = self.clock()
        self._t_last = self.clock()

    def record_failure(self) -> None:
        """A request that was admitted but errored (bad payload, engine
        exception) — neither completed nor rejected, but it DID arrive:
        dropping it from the counters would make a fault storm read as a
        healthy low-traffic interval."""
        self._failed.inc()
        self._t_last = self.clock()

    def record_batch(self, real_rows: int, bucket: int) -> None:
        """One batcher flush: `real_rows` requests padded into `bucket`."""
        self._batches.inc()
        self._batched_rows.inc(real_rows)
        self._bucket_rows.inc(bucket)

    def record_stages(self, stages: dict) -> None:
        """One completed request's per-stage durations (`<stage>_s` keys,
        serve/tracing.py's telescoped breakdown) into the stage
        histograms — the dict-shaped spelling for external feeders; the
        tracer's per-completion hot path uses `record_stage_values`."""
        for stage, hist in self._stage_hists.items():
            v = stages.get(f"{stage}_s")
            if isinstance(v, (int, float)) and v >= 0:
                hist.record(v)

    def record_stage_values(self, values) -> None:
        """One completed request's telescoped stage durations as a bare
        tuple in STAGES order (`tracing.RequestCtx.stage_values`): the
        allocation-light recorder the tracer calls once per completion
        at peak service rate — no dict, no key formatting."""
        for hist, v in zip(self._stage_hist_list, values):
            if v >= 0:
                hist.record(v)

    def predicted_p99(self) -> Optional[float]:
        """The admission predictor (seconds): rolling observed p99 plus
        the time the CURRENT queue takes to drain at the observed service
        rate — what a request arriving this instant should expect its
        tail to be. None until the SLO window has both a percentile and a
        rate (predicting from nothing would reject on a guess)."""
        if not self.slo.n:
            return None
        rate = self.slo.service_rate()
        if rate is None or rate <= 0:
            return None
        depth = self.depth_fn() if self.depth_fn is not None else 0
        return self.slo.percentile(0.99) + depth / rate

    # -- snapshot ---------------------------------------------------------

    def attribution(self) -> dict:
        """The live per-stage latency attribution — stage p50/p99 (ms),
        in pipeline order, plus each stage's SHARE of the telescoped
        per-request time (stage total / sum of stage totals: the stages
        decompose e2e, so the shares sum to 100%) and the current
        predicted p99 — under EXACTLY the stage names the JSONL trace
        uses (serve/tracing.py STAGES): the `{"op": "stats"}` dashboard,
        the bench artifact's `stage_attribution` stamp, and `trace
        report --serve` must never disagree on naming."""
        pred = self.predicted_p99()
        denom = sum(h.total for h in self._stage_hists.values())
        return {
            "stages": {
                stage: {"n": h.n,
                        "p50_ms": round(h.percentile(0.50) * 1e3, 3),
                        "p99_ms": round(h.percentile(0.99) * 1e3, 3),
                        "share_pct": (round(100.0 * h.total / denom, 2)
                                      if denom > 0 else None)}
                for stage, h in self._stage_hists.items() if h.n
            },
            "predicted_p99_ms": (round(pred * 1e3, 3)
                                 if pred is not None else None),
        }

    def snapshot(self) -> dict:
        """JSON-able state: the serving dashboard in one dict."""
        arrived = self.completed + self.rejected + self.failed
        span = ((self._t_last - self._t_first)
                if self._t_first is not None and self._t_last is not None
                else 0.0)
        lat = self.latency
        return {
            "requests": arrived,
            "completed": self.completed,
            "rejected": self.rejected,
            "failed": self.failed,
            "reject_rate": round(self.rejected / arrived, 4) if arrived
                           else 0.0,
            "achieved_rps": round(self.completed / span, 2) if span > 0
                            else None,
            "latency_ms": {
                "p50": round(lat.percentile(0.50) * 1e3, 3),
                "p95": round(lat.percentile(0.95) * 1e3, 3),
                "p99": round(lat.percentile(0.99) * 1e3, 3),
                "mean": round(lat.mean * 1e3, 3),
                "max": round(lat.max * 1e3, 3),
            },
            "batches": self.batches,
            # real rows per flush / bucket rows actually computed: 1.0 means
            # every padded slot carried a request (perfect coalescing)
            "batch_occupancy": round(self.batched_rows / self.bucket_rows, 4)
                               if self.bucket_rows else None,
            "mean_batch_size": round(self.batched_rows / self.batches, 2)
                               if self.batches else None,
            "queue_depth": self.depth_fn() if self.depth_fn else None,
            # the rolling SLO view (recent window), beside the cumulative
            # percentiles above — "right now" vs "the whole run"
            "slo": self.slo.snapshot(),
            # request-scoped tail attribution: per-stage p50/p99 + the
            # predicted p99 admission signal
            "attribution": self.attribution(),
        }
