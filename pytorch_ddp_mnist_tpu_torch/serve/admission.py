"""Admission control: a bounded request queue with backpressure and a
graceful drain (port of `pytorch_ddp_mnist_tpu/serve/admission.py`: the
same modes and decisions).

An open-loop client population does not slow down because the server is
busy — at overload the only choices are unbounded queue growth (every
request eventually served, none within its deadline) or early rejection.
The controller bounds in-flight depth at `max_depth`: past it, requests are
refused IMMEDIATELY with a retry-after hint, keeping the latency of the
admitted population flat while the reject rate absorbs the overload (the
queue protects the batcher, the batcher protects the card).

Shutdown is a drain, not a drop: `begin_drain()` closes the door (new
arrivals rejected as draining) while everything already admitted runs to
completion; `await drained()` returns once in-flight work hits zero.

Two admission modes (cli/serve.py `--admit`):

  * `depth` (default): reject when in-flight depth hits `max_depth` — the
    original bounded queue. Simple, but it only reacts AFTER the queue is
    long: every request admitted on the way there still eats the full
    backlog's latency.
  * `predicted_p99`: reject when the PREDICTED p99 — the rolling observed
    p99 plus this request's expected queue-drain time (depth / observed
    service rate, both from the serve metrics' SLO window) — exceeds
    `slo_p99_s`. This turns the SLO itself into the admission boundary:
    under overload the controller starts refusing while the queue is
    still short, keeping the ADMITTED population inside its latency
    budget instead of uniformly degrading everyone. `max_depth` stays as
    the memory backstop, the mode degrades to it until the predictor has
    observations, and an EMPTY server (depth 0) always admits — the probe
    that refreshes a stale window, without which a transient overload
    would reject forever.
"""

from __future__ import annotations

import asyncio
from typing import Callable, Optional

from ..telemetry import flight

ADMIT_MODES = ("depth", "predicted_p99")


class Rejected(Exception):
    """Request refused by admission control; `retry_after_s` is the hint a
    transport should surface (HTTP Retry-After analog)."""

    def __init__(self, reason: str, retry_after_s: float):
        super().__init__(reason)
        self.reason = reason
        self.retry_after_s = retry_after_s


class AdmissionController:
    def __init__(self, max_depth: int = 256, *, retry_after_s: float = 0.05,
                 mode: str = "depth", slo_p99_s: Optional[float] = None,
                 predictor: Optional[Callable[[], Optional[float]]] = None):
        if max_depth < 1:
            raise ValueError(f"max_depth must be >= 1; got {max_depth}")
        if mode not in ADMIT_MODES:
            raise ValueError(f"mode must be one of {ADMIT_MODES}; "
                             f"got {mode!r}")
        if mode == "predicted_p99":
            if slo_p99_s is None or slo_p99_s <= 0:
                raise ValueError(f"predicted_p99 mode needs slo_p99_s > 0; "
                                 f"got {slo_p99_s!r}")
            if predictor is None:
                raise ValueError("predicted_p99 mode needs a predictor "
                                 "(ServeMetrics.predicted_p99 — ServeService "
                                 "wires it)")
        self.max_depth = int(max_depth)
        self.retry_after_s = float(retry_after_s)
        self.mode = mode
        self.slo_p99_s = float(slo_p99_s) if slo_p99_s is not None else None
        # zero-arg callable -> predicted p99 seconds (None until the SLO
        # window has observations — the mode degrades to the depth
        # backstop until then, never rejects on a guess)
        self.predictor = predictor
        self.depth = 0          # admitted and not yet released
        self.admitted = 0
        self.rejected = 0
        self.rejected_predicted = 0  # rejects owed to the SLO boundary
        self.draining = False
        self._empty: Optional[asyncio.Event] = None

    def admit(self) -> None:
        """Take one slot or raise Rejected. Pair with `release()`.

        Both reject branches feed the flight recorder (bounded ring, no
        I/O): a drained or overloaded server that later dies leaves WHICH
        requests it was refusing, and why, in the post-mortem dump —
        aggregate reject counts live in the metrics registry, the recorder
        keeps the most recent individual refusals."""
        if self.draining:
            self.rejected += 1
            flight.record("serve_reject", reason="draining",
                          depth=self.depth, rejected_total=self.rejected)
            raise Rejected("draining: server is shutting down",
                           self.retry_after_s)
        if self.depth >= self.max_depth:
            self.rejected += 1
            flight.record("serve_reject", reason="queue_full",
                          depth=self.depth, max_depth=self.max_depth,
                          rejected_total=self.rejected)
            raise Rejected(
                f"queue depth {self.depth} at budget {self.max_depth}",
                self.retry_after_s)
        # An EMPTY server always admits (depth 0 skips the SLO boundary):
        # the queue-drain term is zero, and the admitted request is the
        # probe that refreshes the rolling window. Without it a transient
        # overload livelocks — the window only updates on completions, so
        # a stale past-SLO p99 would reject 100% of traffic forever on an
        # otherwise idle server.
        if self.mode == "predicted_p99" and self.depth > 0:
            predicted = self.predictor()
            if predicted is not None and predicted > self.slo_p99_s:
                self.rejected += 1
                self.rejected_predicted += 1
                flight.record("serve_reject", reason="predicted_p99",
                              predicted_p99_s=round(float(predicted), 6),
                              slo_p99_s=self.slo_p99_s, depth=self.depth,
                              rejected_total=self.rejected)
                raise Rejected(
                    f"predicted p99 {predicted * 1e3:.1f}ms past SLO "
                    f"{self.slo_p99_s * 1e3:.1f}ms (depth {self.depth})",
                    self.retry_after_s)
        self.depth += 1
        self.admitted += 1

    def release(self) -> None:
        assert self.depth > 0, "release() without a matching admit()"
        self.depth -= 1
        if self.depth == 0 and self._empty is not None:
            self._empty.set()

    def begin_drain(self) -> None:
        """Stop admitting; already-admitted requests run to completion."""
        self.draining = True

    async def drained(self) -> None:
        """Resolve once draining AND no request is in flight."""
        self.begin_drain()
        if self.depth == 0:
            return
        if self._empty is None:
            self._empty = asyncio.Event()
        while self.depth > 0:
            self._empty.clear()
            await self._empty.wait()
