"""Open-loop load generator for the serve path (port of
`pytorch_ddp_mnist_tpu/serve/loadgen.py`: the same seeded arrival
timelines and request rows, bit for bit).

Closed-loop benchmarks (N workers, each waiting for its response before the
next request) cannot see queueing collapse: the client slows down exactly
when the server does. This generator schedules arrivals on an ABSOLUTE
timeline — exponential inter-arrival gaps at `offered_rps` (or the ramp and
spike shapes), drawn from a seeded numpy Generator — and fires each request
at its scheduled instant whether or not earlier ones have returned.
Latency percentiles therefore include queueing delay, and offered vs
achieved throughput (+ reject rate) exposes saturation honestly.

Each request also stamps its CLIENT-side send time: `client_latency_ms`
is the latency the caller perceived (send -> response), while the server's
own `latency_ms` starts at admission. The percentile-level delta between
them (`front_door_overhead_ms`) is the front-door cost — event-loop
scheduling before the handler runs. Both sides use the same exact
nearest-rank convention AND the same population (the last min(n, 512)
completions by completion time — the SLO window's own selection rule).
"""

from __future__ import annotations

import asyncio
import time
from typing import Optional

import numpy as np

from . import Rejected, ServeService

from .metrics import nearest_rank

IN_DIM = 784

# Arrival shapes for `arrival_times` (cli/bench `--shape`). All three
# offer the SAME total load (n requests, n/offered_rps nominal seconds);
# they differ only in how that mass lands on the timeline.
SHAPES = ("poisson", "ramp", "spike")


def arrival_times(n: int, offered_rps: float, *, shape: str = "poisson",
                  seed: int = 0) -> np.ndarray:
    """Absolute arrival instants (seconds from start) for `n` requests at
    nominal `offered_rps`, under one of three offered-load shapes:

    - ``poisson``: homogeneous Poisson — exponential inter-arrival gaps.
      This branch is bitwise-identical to the generator's original
      timeline (same seed -> same floats), so every existing artifact
      and pinned test keeps its exact arrivals.
    - ``ramp``: linear rate ramp from 0.2x to 1.8x the nominal rate over
      the run — the warm-up curve that exposes whether admission tuned
      at steady state also holds while load is still climbing.
    - ``spike``: 0.5x baseline with a 3x burst through the middle fifth
      of the run — the flash-crowd shape that stresses failover + drain
      (the JAX package's chaos smoke kills a replica inside the burst).

    The inhomogeneous shapes are exact thinning-free draws: simulate a
    unit-rate Poisson process (cumsum of Exp(1)) and time-warp it through
    the inverse cumulative intensity Lambda^-1 — for ramp a closed-form
    quadratic root, for spike a piecewise-linear inversion whose tail
    continues at the final segment's rate (random mass can overshoot the
    nominal window; arrivals must stay monotone, never clip)."""
    if shape not in SHAPES:
        raise ValueError(f"unknown arrival shape {shape!r}; "
                         f"choose from {SHAPES}")
    rng = np.random.default_rng(seed)
    if shape == "poisson":
        return np.cumsum(rng.exponential(1.0 / offered_rps, size=n))
    u = np.cumsum(rng.exponential(1.0, size=n))  # unit-rate arrivals
    T = n / offered_rps                          # nominal duration
    if shape == "ramp":
        # lambda(t) = r*(0.2 + 1.6*t/T)  =>  Lambda(t) = r*(0.2t + 0.8t²/T)
        # (integrates to exactly n over [0, T]); solve Lambda(t) = u
        v = u / offered_rps
        return (T / 1.6) * (np.sqrt(0.04 + 3.2 * v / T) - 0.2)
    # spike: (fraction-of-T, rate-multiplier) segments; multipliers are
    # mass-balanced (0.4*0.5 + 0.2*3.0 + 0.4*0.5 = 1.0) so nominal total
    # stays n
    segs = ((0.4, 0.5), (0.2, 3.0), (0.4, 0.5))
    durs = np.array([f * T for f, _ in segs])
    rates = np.array([m * offered_rps for _, m in segs])
    mass_edges = np.concatenate([[0.0], np.cumsum(rates * durs)])
    time_edges = np.concatenate([[0.0], np.cumsum(durs)])
    seg = np.minimum(np.searchsorted(mass_edges[1:], u, side="left"),
                     len(segs) - 1)
    return time_edges[seg] + (u - mass_edges[seg]) / rates[seg]


def request_rows(n: int, dtype: str = "float32",
                 seed: int = 0) -> np.ndarray:
    """Deterministic synthetic request payloads: (n, 784) pixel rows in the
    engine's input dtype (uint8 raw pixels or pre-normalized float32)."""
    rng = np.random.default_rng(seed)
    raw = rng.integers(0, 256, size=(n, IN_DIM), dtype=np.uint8)
    if dtype == "uint8":
        return raw
    from ..data.mnist import normalize_images
    return normalize_images(raw.reshape(n, 28, 28)).astype(np.float32)


async def run_open_loop(service: ServeService, *, offered_rps: float,
                        n_requests: int, seed: int = 0,
                        rows: Optional[np.ndarray] = None,
                        shape: str = "poisson") -> dict:
    """Drive `n_requests` through the service at `offered_rps` under the
    given arrival `shape` (see `arrival_times`); returns {offered_rps,
    duration_s, predictions, snapshot...}.

    Arrival times are precomputed and each request fires as its own task
    at its absolute slot — a slow response never delays later arrivals
    (open loop). Rejects count in the metrics and leave a None
    prediction."""
    if offered_rps <= 0:
        raise ValueError(f"offered_rps must be > 0; got {offered_rps}")
    if n_requests < 1:
        raise ValueError(f"n_requests must be >= 1; got {n_requests}")
    arrivals = arrival_times(n_requests, offered_rps, shape=shape,
                             seed=seed)
    if rows is None:
        rows = request_rows(n_requests, service.engine.input_dtype,
                            seed=seed + 1)
    elif len(rows) < n_requests:
        rows = rows[np.arange(n_requests) % len(rows)]

    preds: "list[Optional[int]]" = [None] * n_requests
    # client-perceived latency per COMPLETED request: send stamp taken
    # before the handler coroutine even gets scheduled, so event-loop
    # queueing ahead of admission (the front door) is on the clock.
    # Completion time rides along so the front-door delta below can
    # select the SAME population the server's SLO window holds.
    client_lat: "list[Optional[float]]" = [None] * n_requests
    client_done_t: "list[Optional[float]]" = [None] * n_requests

    async def one(i: int) -> None:
        t_send = time.monotonic()
        try:
            preds[i] = await service.handle(rows[i])
            client_done_t[i] = time.monotonic()
            client_lat[i] = client_done_t[i] - t_send
        except Rejected:
            pass  # counted by service.metrics

    t0 = time.monotonic()
    tasks = []
    for i in range(n_requests):
        delay = arrivals[i] - (time.monotonic() - t0)
        if delay > 0:
            await asyncio.sleep(delay)
        else:
            # behind schedule: fire immediately, but still YIELD once per
            # arrival. Real open-loop clients live across a transport, so
            # the server's loop interleaves accepts with its own
            # completion callbacks; an in-process spawn loop that never
            # yields would instead starve every completion behind the
            # whole late burst — a harness artifact that reads as a
            # reject storm the real deployment would not have.
            await asyncio.sleep(0)
        tasks.append(asyncio.ensure_future(one(i)))
    await asyncio.gather(*tasks)
    duration = time.monotonic() - t0
    snap = service.metrics.snapshot()
    done = sorted(v for v in client_lat if v is not None)
    client_ms = {
        "p50": round(nearest_rank(done, 0.50) * 1e3, 3),
        "p95": round(nearest_rank(done, 0.95) * 1e3, 3),
        "p99": round(nearest_rank(done, 0.99) * 1e3, 3),
        "mean": round(sum(done) / len(done) * 1e3, 3) if done else 0.0,
        "max": round(done[-1] * 1e3, 3) if done else 0.0,
    }
    # percentile-level delta vs the server's own e2e. Both sides of the
    # subtraction use the SAME exact nearest-rank convention AND the same
    # population-selection rule: the server side is the SLO window (its
    # last `window` completions, in completion order — NOT the snapshot's
    # log-bucketed histogram, whose ~21%-wide buckets would swamp the
    # sub-ms overhead being measured), so the client side restricts
    # itself to its own last min(n, window) completions by completion
    # time. Past the window span the two sides are then still the same
    # requests — an all-run client percentile minus a window server
    # percentile would measure distribution drift across the run, not the
    # front door. (May still be noisy-negative at sub-ms scale: the two
    # clocks rank the shared population independently.)
    slo = service.metrics.slo
    tail = sorted(lat for _t, lat in
                  sorted((t, lat) for t, lat in
                         zip(client_done_t, client_lat)
                         if lat is not None)[-slo.window:])
    front_door = {name: round(nearest_rank(tail, q) * 1e3
                              - slo.percentile(q) * 1e3, 3)
                  for name, q in (("p50", 0.50), ("p95", 0.95),
                                  ("p99", 0.99))}
    return {
        "offered_rps": round(float(offered_rps), 2),
        "shape": shape,
        "n_requests": int(n_requests),
        "duration_s": round(duration, 4),
        "predictions": preds,
        "client_latency_ms": client_ms,
        "front_door_overhead_ms": front_door,
        **snap,
    }


def run_loadgen(service: ServeService, *, offered_rps: float,
                n_requests: int, seed: int = 0,
                shape: str = "poisson") -> dict:
    """Synchronous wrapper: open-loop run + graceful drain on one fresh
    event loop (the bench / CLI-selftest entry)."""
    from . import run_until_drained
    return run_until_drained(
        service, run_open_loop(service, offered_rps=offered_rps,
                               n_requests=n_requests, seed=seed,
                               shape=shape))
