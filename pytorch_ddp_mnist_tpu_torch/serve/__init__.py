"""serve/ — micro-batching inference on the card: checkpoint in, request
service out (port of `pytorch_ddp_mnist_tpu/serve/`).

An engine that captures a bucketed ladder of batch shapes as CUDA graphs
so no request ever pays a capture (`engine.py`), an asyncio micro-batcher
that coalesces requests up to a size/deadline knob (`batcher.py`),
bounded-queue admission control with backpressure, graceful drain and an
optional predicted-p99 SLO boundary (`admission.py`), latency-percentile
metrics with per-stage attribution (`metrics.py`), request-scoped stage
tracing (`tracing.py`) and an open-loop load generator with
poisson/ramp/spike arrival shapes (`loadgen.py`). `ServeService` wires
them into the one request path every front door (cli/serve.py's TCP
server and selftest, bench.py --mode serve, tests) shares;
`FleetService` (`fleet.py`) replicates the engine N ways on the card
behind the same admission layer with SLO-aware routing, a wedge watchdog,
bounded request failover and supervised restarts, and `ReloadWatcher`
(`reload.py`) hot-swaps the fleet to newly committed step checkpoints
behind per-replica drains. Everything here runs on the CPU too
(`device="cpu"`), the forward eagerly, which is how the tests drive it.
"""

from __future__ import annotations

import asyncio

from .admission import ADMIT_MODES, AdmissionController, Rejected  # noqa: F401
from .batcher import MicroBatcher  # noqa: F401
from .engine import InferenceEngine, bucket_ladder  # noqa: F401
from .fleet import (FleetService, FleetUnavailable, ReplicaCrashed,  # noqa: F401
                    ReplicaFailure, ReplicaWedged)
from .metrics import LatencyHistogram, ServeMetrics, SLOWindow  # noqa: F401
from .reload import ReloadWatcher  # noqa: F401
from .tracing import ServeTracer  # noqa: F401


class ServeService:
    """admission -> batcher -> engine, with per-request latency metrics
    and request-scoped stage tracing.

    `handle(row)` is the whole request path: admit (or raise `Rejected`),
    coalesce, run, scatter, record. Construction wires the metrics' queue-
    depth gauge to the controller, the batcher's occupancy recorder to the
    same metrics object, and one `ServeTracer` (serve/tracing.py) through
    all three — every request gets a request_id at the front door and a
    per-stage latency breakdown at the back, so a snapshot is always
    internally consistent AND decomposable.

    `admit_mode="predicted_p99"` (+ `slo_p99_s`) switches admission from
    the raw depth budget to the SLO boundary: reject when the metrics'
    predicted p99 (rolling p99 + queue-drain time) would bust the SLO —
    see serve/admission.py.
    """

    def __init__(self, engine: InferenceEngine, *, max_batch=None,
                 max_delay_ms: float = 2.0, max_depth: int = 256,
                 retry_after_s: float = 0.05, clock=None, registry=None,
                 admit_mode: str = "depth", slo_p99_s=None, fast=None):
        import time
        clock = clock or time.monotonic
        self.engine = engine
        # registry=None keeps the service hermetic (its own private
        # registry); the CLI/bench front doors pass telemetry.get_registry()
        # so serve.* metrics publish into the process-wide snapshot.
        self.metrics = ServeMetrics(depth_fn=lambda: self.admission.depth,
                                    clock=clock, registry=registry)
        self.admission = AdmissionController(
            max_depth, retry_after_s=retry_after_s, mode=admit_mode,
            slo_p99_s=slo_p99_s,
            predictor=(self.metrics.predicted_p99
                       if admit_mode == "predicted_p99" else None))
        self.tracer = ServeTracer(clock=clock, metrics=self.metrics)
        # fast=None auto-selects the staged fast path when the engine has
        # the staging surface; fast=False is the A/B knob (--no_fast) that
        # forces the legacy stack-at-flush path
        self.batcher = MicroBatcher(engine, max_batch=max_batch,
                                    max_delay_ms=max_delay_ms,
                                    metrics=self.metrics, clock=clock,
                                    tracer=self.tracer, fast=fast)
        self.clock = clock

    async def handle(self, row) -> int:
        """Serve one request row -> predicted class. Raises `Rejected`
        under backpressure or drain (metrics count it either way)."""
        rctx = self.tracer.begin()      # request_id + arrival stamp, even
        self.metrics.record_arrival()   # for requests admission refuses
        try:
            self.admission.admit()
        except Rejected:
            self.metrics.record_reject()
            raise
        self.tracer.admitted(rctx)
        t0 = self.clock()
        try:
            pred = await self.batcher.submit(row, rctx)
        except Exception:
            # admitted but errored (bad payload, engine failure): counted —
            # a fault storm must not read as a healthy low-traffic interval
            self.metrics.record_failure()
            self.tracer.finish(rctx, ok=False)
            raise
        finally:
            self.admission.release()
        self.metrics.record_done(self.clock() - t0)
        self.tracer.finish(rctx, ok=True)
        return pred

    async def shutdown(self) -> None:
        """Graceful drain: refuse new work, serve everything admitted
        (on the fast path that includes awaiting the reply thread's
        outstanding futures), stop the reply thread, drain any in-flight
        device work (engine.close — a no-op after a clean drain,
        load-bearing on an aborted one), then leave the slowest-request
        exemplar trees in the flight ring (the post-mortem the drain-time
        dump carries)."""
        self.admission.begin_drain()
        await self.batcher.drain()
        await self.admission.drained()
        self.batcher.close()
        close = getattr(self.engine, "close", None)
        if close is not None:   # duck-typed wrapper engines have no pool
            close()
        self.tracer.flush_exemplars()


def run_until_drained(service: ServeService, coro):
    """Run `coro` on a fresh event loop, then drain the service — the
    synchronous front doors' (bench, CLI selftest) shared harness."""
    async def _main():
        try:
            return await coro
        finally:
            await service.shutdown()
    return asyncio.run(_main())
