"""Metrics registry: counters, gauges, histograms — one JSON snapshot (the
port's copy of `pytorch_ddp_mnist_tpu/telemetry/registry.py`, which the
port cannot import: that package's `__init__` imports jax).

Any subsystem creates named metrics (get-or-create, so wiring order never
matters), and `MetricsRegistry.snapshot()` renders the whole process state
as one JSON-able dict — the payload of the serve `{"op": "stats"}` endpoint
and the final record of a `--telemetry` JSONL trace.

`Histogram`: values land in a log-spaced bucket map (floor 2 us, 12
buckets/decade for the seconds-unit default) rather than an unbounded
sample list — constant memory at any rate, percentile error bounded by the
bucket ratio (~21%), always reported pessimistically (the winning bucket's
UPPER edge, clamped to the recorded max).
"""

from __future__ import annotations

import math
import threading
from typing import Callable, Dict, Optional

# 12 buckets per decade: ratio 10^(1/12) ~ 1.21 between edges.
_BUCKETS_PER_DECADE = 12
_FLOOR = 2e-6


class Counter:
    """Monotonic counter. `inc()` only goes up; `set_total` exists for
    absorbing an externally maintained total (e.g. an engine's
    compile_count probe) without double-counting increments."""

    def __init__(self, name: str):
        self.name = name
        self.value = 0

    def inc(self, n: int = 1) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name} cannot decrease (n={n})")
        self.value += n

    def set_total(self, total: int) -> None:
        """Adopt an external running total; never moves the value down."""
        self.value = max(self.value, int(total))


class Gauge:
    """Point-in-time value: `set()` a number, or bind a zero-arg callable
    with `set_fn` so the snapshot reads the instant (the serve queue-depth
    pattern), not a stale write."""

    def __init__(self, name: str):
        self.name = name
        self._value: Optional[float] = None
        self._fn: Optional[Callable[[], float]] = None

    def set(self, value) -> None:
        self._value, self._fn = value, None

    def set_fn(self, fn: Callable[[], float]) -> None:
        self._fn = fn

    @property
    def value(self):
        if self._fn is not None:
            try:
                return self._fn()
            except Exception:
                return None  # a dead provider must not kill the snapshot
        return self._value


class Histogram:
    """Log-bucketed value recorder with percentile estimation (the
    generalized serve LatencyHistogram — see module docstring for the
    accuracy contract). Unit-agnostic: record seconds, bytes, rows."""

    def __init__(self, name: str = "", *, floor: float = _FLOOR,
                 buckets_per_decade: int = _BUCKETS_PER_DECADE):
        self.name = name
        self.floor = floor
        self.buckets_per_decade = buckets_per_decade
        self.counts: Dict[int, int] = {}
        self.n = 0
        self.total = 0.0
        self.max = 0.0

    def _index(self, value: float) -> int:
        if value <= self.floor:
            return 0
        return 1 + int(self.buckets_per_decade
                       * math.log10(value / self.floor))

    def _edge(self, index: int) -> float:
        # upper edge of bucket `index` (bucket 0 = [0, floor])
        return self.floor * 10 ** (index / self.buckets_per_decade)

    def record(self, value: float) -> None:
        i = self._index(value)
        self.counts[i] = self.counts.get(i, 0) + 1
        self.n += 1
        self.total += value
        self.max = max(self.max, value)

    def percentile(self, q: float) -> float:
        """Estimated q-quantile (q in [0, 1]); 0.0 when empty. Clamped to
        the recorded max so a sparse tail bucket cannot report a value
        larger than any sample actually reached."""
        if self.n == 0:
            return 0.0
        rank = q * self.n
        seen = 0
        for i in sorted(self.counts):
            seen += self.counts[i]
            if seen >= rank:
                return min(self._edge(i), self.max)
        return self.max

    @property
    def mean(self) -> float:
        return self.total / self.n if self.n else 0.0

    def snapshot(self) -> dict:
        return {
            "n": self.n,
            "mean": self.mean,
            "max": self.max,
            # the exact recorded sum (not a bucket estimate): the whole
            # bill a rate-style reader wants — e.g. xla.compile_s total is
            # the process's compile-time spend, the bench/cost stamp field
            "total": self.total,
            "p50": self.percentile(0.50),
            "p95": self.percentile(0.95),
            "p99": self.percentile(0.99),
        }


class MetricsRegistry:
    """Named metrics, get-or-create, one `snapshot()` dict.

    Creation is idempotent per (name, type): asking for an existing name
    returns the live instance, so producer and consumer never need to agree
    on wiring order; asking for it as a DIFFERENT type raises (a counter
    silently shadowing a gauge would corrupt both readings). Thread-safe
    creation — recording on the returned objects is plain attribute math,
    same as the pre-registry counters."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}

    def _get(self, table: dict, name: str, make):
        others = [t for t in (self._counters, self._gauges, self._histograms)
                  if t is not table]
        with self._lock:
            if name not in table:
                if any(name in t for t in others):
                    raise ValueError(f"metric {name!r} already registered "
                                     f"as a different type")
                table[name] = make(name)
            return table[name]

    def counter(self, name: str) -> Counter:
        return self._get(self._counters, name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(self._gauges, name, Gauge)

    def histogram(self, name: str, **kw) -> Histogram:
        return self._get(self._histograms, name,
                         lambda n: Histogram(n, **kw))

    def register(self, name: str, metric) -> None:
        """Adopt an externally constructed metric instance (including
        subclasses — the serve LatencyHistogram alias) under `name`.
        Raises on any existing registration: two owners of one name would
        silently split the recorded stream."""
        table = (self._counters if isinstance(metric, Counter) else
                 self._gauges if isinstance(metric, Gauge) else
                 self._histograms if isinstance(metric, Histogram) else None)
        if table is None:
            raise TypeError(f"not a registry metric: {type(metric).__name__}")
        with self._lock:
            if any(name in t for t in (self._counters, self._gauges,
                                       self._histograms)):
                raise ValueError(f"metric {name!r} already registered")
            table[name] = metric

    def snapshot(self) -> dict:
        """The whole process's metric state as one JSON-able dict.

        The table LISTING is taken under the lock and rendered outside it:
        a snapshot can run concurrently with another thread lazily creating
        metrics — a Python-level comprehension over the live dicts would
        die with "dictionary changed size during iteration". Rendering
        outside the lock keeps gauge provider callables (which may touch
        arbitrary code, including metric creation) deadlock-free; the
        per-metric reads are attribute math, worst case one update stale."""
        with self._lock:
            counters = sorted(self._counters.items())
            gauges = sorted(self._gauges.items())
            histograms = sorted(self._histograms.items())
        return {
            "counters": {n: c.value for n, c in counters},
            "gauges": {n: g.value for n, g in gauges},
            "histograms": {n: h.snapshot() for n, h in histograms},
        }


# The process-wide registry every subsystem shares by default. Tests and
# hermetic benches construct private MetricsRegistry instances instead.
_GLOBAL = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    return _GLOBAL
