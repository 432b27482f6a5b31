"""Replica fleet: N supervised engines behind one admission layer (port of
`pytorch_ddp_mnist_tpu/serve/fleet.py`; its states, failure classes,
event names, causes, snapshot keys and metric names letter for letter).

One engine is a single point of failure twice over: a crashed bucket
launch fails every coalesced request with it, and a wedged fetch holds
its waiters forever. `FleetService` replicates the engine N ways behind
the existing admission controller and keeps the `ServeService` surface
(`handle(row)`, `shutdown()`, `.metrics`, `.admission`, `.engine`), so
every front door (cli/serve.py, bench.py --mode serve, the load
generator, serve_chaos.py, the tests) runs unchanged on a fleet.

On one card a fleet is N engines that share it, each with its own CUDA
stream and its own captured bucket graphs (serve/engine.py); the forward
stays the three captured `torch.matmul`s of the single engine, and no
hand-written kernel runs here.

* **Routing**: every admitted request goes to the healthy replica with
  the fewest requests in flight, tie-broken by the replica's OWN rolling
  `SLOWindow` p99 (a straggler keeps taking some traffic, so its window
  keeps refreshing, but never the bulk).
* **Supervision**: a loop-side watchdog task ages every replica's
  dispatched-but-unanswered flushes (`MicroBatcher.oldest_inflight_age`).
  A flush older than `wedge_timeout_s` declares the replica WEDGED: its
  waiters are released with `ReplicaWedged` on the loop (the wedged reply
  thread's late scatter finds its journal entry gone and delivers
  nothing), the reply thread is abandoned (daemon, never joined), and the
  replica restarts off-loop.
* **Failover**: a replica-scoped failure raising out of `submit` (engine
  crash, wedge release) quarantines the replica and RETRIES the request
  on a survivor under `retry_budget` additional attempts: an accepted
  request is lost only when the budget runs out or no healthy replica
  appears within the bounded wait. Client errors (a malformed row's
  `ValueError`) never count against the replica and never retry.
* **Restart**: a quarantined replica rebuilds its engine (its whole
  bucket ladder captured again) in the executor, off the event loop, from
  the fleet's CURRENT params generation, so a replica crashing during a
  hot reload comes back on the new weights, and rejoins routing. The
  build captures on the executor thread while the siblings serve
  (serve/engine.py: thread-local capture mode, one capture at a time).

Hot reload (serve/reload.py) drives `apply_reload`: new-generation
engines are staged off-loop FIRST (every ladder captured, so capacity
never dips for a capture), then each replica is swapped behind its own
drain: routing skips it, its outstanding futures resolve on the OLD
engine, and only then does the new engine take the slot, so no request
spans a swap. Each swap records `outstanding_at_swap` (always 0) as a
`reload_event` point.

Every state transition publishes: `serve.fleet.*` registry metrics,
`fleet_event` telemetry points and flight-recorder entries. The whole
fleet runs on the CPU too (`device="cpu"` engines), which is how the
tests drive it.
"""

from __future__ import annotations

import asyncio
import time
from typing import Callable, List, Optional

from ..telemetry import flight
from ..telemetry.events import get_tracer
from .admission import AdmissionController, Rejected
from .batcher import MicroBatcher
from .metrics import ServeMetrics, SLOWindow
from .tracing import ServeTracer

# Replica lifecycle: HEALTHY takes traffic; DRAINING is a reload swap in
# progress (router skips it, outstanding work completes on the old
# engine); RESTARTING is quarantined with an off-loop rebuild running;
# DEAD is a restart that itself failed — terminal until shutdown.
HEALTHY, DRAINING, RESTARTING, DEAD = "healthy", "draining", "restarting", "dead"


class ReplicaFailure(RuntimeError):
    """A replica-scoped serve failure: the request was fine, the replica
    was not — the fleet's retry path catches exactly this family (plus
    unclassified engine errors) and never a client error."""


class ReplicaCrashed(ReplicaFailure):
    """The replica's engine raised mid-dispatch (or its waiters were
    released after a sibling request crashed it)."""


class ReplicaWedged(ReplicaFailure):
    """The supervisor aged an in-flight flush past the wedge timeout and
    released its waiters."""


class FleetUnavailable(ReplicaFailure):
    """No healthy replica appeared within the bounded wait — the one way
    an accepted request is lost besides retry-budget exhaustion."""


class Replica:
    """One engine + its private batcher + its own rolling SLO window.

    The per-replica `SLOWindow` is the routing signal: the shared
    `ServeMetrics` aggregates the fleet, but routing needs to know which
    REPLICA is slow. `inflight` counts admitted-to-this-replica,
    unanswered requests — the router's load measure (queue depth alone
    misses dispatched-but-unfetched work)."""

    __slots__ = ("idx", "engine", "batcher", "slo", "state", "inflight",
                 "generation", "restarts")

    def __init__(self, idx: int, engine, batcher):
        self.idx = idx
        self.engine = engine
        self.batcher = batcher
        self.slo = SLOWindow()
        self.state = HEALTHY
        self.inflight = 0
        self.generation = 0
        self.restarts = 0

    def snapshot(self) -> dict:
        return {
            "idx": self.idx,
            "state": self.state,
            "inflight": self.inflight,
            "generation": self.generation,
            "restarts": self.restarts,
            "rolling_p99_ms": round(self.slo.percentile(0.99) * 1e3, 3),
            "window_n": self.slo.n,
        }


class FleetService:
    """N replicated engines behind one admission layer, drop-in for
    `ServeService`.

    `build_engine(params)` constructs ONE engine (its whole ladder
    captured) from a params tree (the JAX layout, of tensors or arrays:
    the tree a reload's checkpoint decodes to must fit it); the fleet
    calls it N times at construction, per
    restart, and per reload generation — always in the executor except at
    construction, so the event loop never hosts a capture. `params` is
    the initial generation; `serving_step` labels it (the reload watcher
    advances both).
    """

    def __init__(self, build_engine: Callable, params, *,
                 n_replicas: int = 2, max_batch=None,
                 max_delay_ms: float = 2.0, max_depth: int = 256,
                 retry_after_s: float = 0.05, clock=None, registry=None,
                 admit_mode: str = "depth", slo_p99_s=None, fast=None,
                 wedge_timeout_s: float = 0.25, retry_budget: int = 2,
                 no_replica_wait_s: Optional[float] = None,
                 serving_step: int = -1):
        if n_replicas < 1:
            raise ValueError(f"n_replicas must be >= 1; got {n_replicas}")
        if retry_budget < 0:
            raise ValueError(f"retry_budget must be >= 0; got {retry_budget}")
        if wedge_timeout_s <= 0:
            raise ValueError(
                f"wedge_timeout_s must be > 0; got {wedge_timeout_s}")
        clock = clock or time.monotonic
        self.clock = clock
        self._build_engine = build_engine
        self._params = params
        self.serving_step = int(serving_step)
        self.wedge_timeout_s = float(wedge_timeout_s)
        self.retry_budget = int(retry_budget)
        # how long an admitted request waits for SOME replica to come
        # back before it is lost: long enough to ride out one restart
        # (ladder capture), short enough that a dead fleet fails loudly
        self.no_replica_wait_s = (float(no_replica_wait_s)
                                  if no_replica_wait_s is not None
                                  else max(10 * self.wedge_timeout_s, 5.0))
        self._batcher_kw = dict(max_batch=max_batch,
                                max_delay_ms=max_delay_ms, fast=fast)
        self.metrics = ServeMetrics(depth_fn=lambda: self.admission.depth,
                                    clock=clock, registry=registry)
        self.admission = AdmissionController(
            max_depth, retry_after_s=retry_after_s, mode=admit_mode,
            slo_p99_s=slo_p99_s,
            predictor=(self.metrics.predicted_p99
                       if admit_mode == "predicted_p99" else None))
        self.tracer = ServeTracer(clock=clock, metrics=self.metrics)
        self.replicas: List[Replica] = [
            Replica(i, self._make_engine(i, params), None)
            for i in range(n_replicas)]
        for rep in self.replicas:
            rep.batcher = self._new_batcher(rep.engine)
        self._generation = 0
        # -- serve.fleet.* observability --------------------------------
        reg = self.metrics.registry
        self._retried = reg.counter("serve.fleet.retried_requests")
        self._retry_exhausted = reg.counter("serve.fleet.retry_exhausted")
        self._crashes = reg.counter("serve.fleet.crashes")
        self._wedges = reg.counter("serve.fleet.wedges")
        self._restarts = reg.counter("serve.fleet.restarts")
        self._failovers = reg.counter("serve.fleet.failed_over_requests")
        reg.gauge("serve.fleet.replicas").set(n_replicas)
        reg.gauge("serve.fleet.healthy").set_fn(
            lambda: sum(1 for r in self.replicas if r.state == HEALTHY))
        reg.gauge("serve.fleet.generation").set_fn(lambda: self._generation)
        reg.gauge("serve.fleet.serving_step").set_fn(
            lambda: self.serving_step)
        # supervisor/restart task plumbing: the watchdog spawns lazily on
        # the first handled request (it needs the running loop), restart
        # tasks are tracked so shutdown can wait for or cancel them
        self._supervisor: Optional[asyncio.Task] = None
        self._tasks: "set[asyncio.Task]" = set()
        self._healthy_event: Optional[asyncio.Event] = None
        self._closed = False

    # -- construction helpers ---------------------------------------------

    def _make_engine(self, idx: int, params):
        engine = self._build_engine(params)
        try:
            engine.replica = idx   # fault-point + forensics label
        except AttributeError:
            pass                   # duck-typed test engines without slots
        return engine

    def _new_batcher(self, engine) -> MicroBatcher:
        return MicroBatcher(engine, metrics=self.metrics, clock=self.clock,
                            tracer=self.tracer, **self._batcher_kw)

    @staticmethod
    def _close_engine(engine) -> None:
        """Best-effort engine retirement (duck-typed test engines have no
        pool to drain; a dead engine's own teardown failure is noise)."""
        close = getattr(engine, "close", None)
        if close is not None:
            try:
                close()
            except Exception:  # noqa: BLE001 — teardown only
                pass

    # -- routing ------------------------------------------------------------

    def _healthy(self) -> List[Replica]:
        return [r for r in self.replicas if r.state == HEALTHY]

    @property
    def engine(self):
        """A representative engine (loadgen reads `input_dtype`, bench
        warms buckets): the first non-dead replica's — every replica
        serves the same params, so any one speaks for the fleet."""
        for rep in self.replicas:
            if rep.state != DEAD:
                return rep.engine
        return self.replicas[0].engine

    @property
    def batcher(self):
        """Compat shim for front doors that read `service.batcher`
        attributes (fast_path, flush counters): the first replica's."""
        return self.replicas[0].batcher

    def _pick_now(self) -> Optional[Replica]:
        healthy = self._healthy()
        if not healthy:
            return None
        return min(healthy, key=lambda r: (r.inflight,
                                           r.slo.percentile(0.99), r.idx))

    async def _pick(self) -> Replica:
        """The healthy replica with the least load, waiting (bounded) for
        one to appear when the whole fleet is quarantined — a restart in
        progress should cost latency, not accepted requests."""
        rep = self._pick_now()
        if rep is not None:
            return rep
        deadline = time.monotonic() + self.no_replica_wait_s
        while True:
            if self._closed:
                raise FleetUnavailable("fleet is shutting down")
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise FleetUnavailable(
                    f"no healthy replica within {self.no_replica_wait_s:.1f}s "
                    f"(states: {[r.state for r in self.replicas]})")
            self._healthy_event = self._healthy_event or asyncio.Event()
            self._healthy_event.clear()
            try:
                await asyncio.wait_for(self._healthy_event.wait(),
                                       timeout=min(remaining,
                                                   self.wedge_timeout_s))
            except asyncio.TimeoutError:
                pass
            rep = self._pick_now()
            if rep is not None:
                return rep

    def _wake_routers(self) -> None:
        if self._healthy_event is not None:
            self._healthy_event.set()

    # -- the request path ---------------------------------------------------

    async def handle(self, row) -> int:
        """Serve one request row -> predicted class: admit once, then
        route/submit with replica failover under the retry budget.
        Raises `Rejected` under backpressure/drain; client errors
        propagate unretried; a replica failure surfaces only after the
        budget exhausts."""
        self._ensure_supervisor()
        rctx = self.tracer.begin()
        self.metrics.record_arrival()
        try:
            self.admission.admit()
        except Rejected:
            self.metrics.record_reject()
            raise
        self.tracer.admitted(rctx)
        t0 = self.clock()
        try:
            pred = await self._submit_with_failover(row, rctx)
        except Exception:
            self.metrics.record_failure()
            self.tracer.finish(rctx, ok=False)
            self.admission.release()
            raise
        self.admission.release()
        self.metrics.record_done(self.clock() - t0)
        self.tracer.finish(rctx, ok=True)
        return pred

    async def _submit_with_failover(self, row, rctx) -> int:
        attempts = 0
        t0 = self.clock()
        while True:
            rep = await self._pick()
            rep.inflight += 1
            try:
                pred = await rep.batcher.submit(row, rctx)
            except (ValueError, TypeError):
                raise         # client error: not the replica's fault
            except Rejected:
                raise
            except asyncio.CancelledError:
                raise
            except Exception as e:
                # replica-scoped: quarantine (idempotent — fail_all
                # storms arrive one exception per waiter) and retry on a
                # survivor under the budget
                self._quarantine(
                    rep, kind=("wedge" if isinstance(e, ReplicaWedged)
                               else "crash"),
                    cause=e)
                if attempts >= self.retry_budget:
                    self._retry_exhausted.inc()
                    get_tracer().point(
                        "fleet_event", event="retry_exhausted",
                        replica=rep.idx, request=rctx.request_id,
                        attempts=attempts + 1)
                    raise
                attempts += 1
                self._retried.inc()
                get_tracer().point("fleet_event", event="retry",
                                   replica=rep.idx,
                                   request=rctx.request_id,
                                   attempt=attempts,
                                   error=str(e)[:200])
                continue
            finally:
                rep.inflight -= 1
            done = self.clock()
            rep.slo.record(done - t0, done)
            return pred

    # -- supervision --------------------------------------------------------

    def _ensure_supervisor(self) -> None:
        if (self._supervisor is None or self._supervisor.done()) \
                and not self._closed:
            loop = asyncio.get_running_loop()
            self._healthy_event = self._healthy_event or asyncio.Event()
            self._supervisor = loop.create_task(self._supervise())

    async def _supervise(self) -> None:
        """The batch watchdog: periodically age every healthy replica's
        oldest in-flight flush; past the wedge timeout, declare the
        replica wedged and fail it over. Loop-side by construction —
        future completion and journal reads stay on the loop."""
        interval = max(self.wedge_timeout_s / 4.0, 0.01)
        while not self._closed:
            await asyncio.sleep(interval)
            now = self.clock()
            for rep in self.replicas:
                if rep.state != HEALTHY:
                    continue
                age = rep.batcher.oldest_inflight_age(now)
                if age > self.wedge_timeout_s:
                    self._quarantine(rep, kind="wedge", cause=RuntimeError(
                        f"oldest in-flight batch aged {age * 1e3:.0f} ms "
                        f"> wedge timeout "
                        f"{self.wedge_timeout_s * 1e3:.0f} ms"))

    def _quarantine(self, rep: Replica, *, kind: str,
                    cause: BaseException) -> None:
        """Loop-side replica takedown, idempotent: flip the state so the
        router skips it, release every waiter it still owes (they retry
        via `handle`'s failover loop), abandon its reply thread, and
        schedule the off-loop restart."""
        if rep.state != HEALTHY or self._closed:
            return
        rep.state = RESTARTING
        (self._wedges if kind == "wedge" else self._crashes).inc()
        detail = f"{type(cause).__name__}: {cause}"[:300]
        flight.record("fleet_event", event="quarantine", replica=rep.idx,
                      cause=kind, error=detail)
        get_tracer().point("fleet_event", event="quarantine",
                           replica=rep.idx, cause=kind, error=detail)
        exc_cls = ReplicaWedged if kind == "wedge" else ReplicaCrashed
        released = rep.batcher.fail_all(exc_cls(
            f"replica {rep.idx} {kind}: {detail}"))
        if released:
            self._failovers.inc(released)
        # never join: on a wedge the reply thread is blocked inside the
        # very fetch being escaped (daemon — it cannot hold the process)
        rep.batcher.close(wait=False)
        loop = asyncio.get_running_loop()
        task = loop.create_task(self._restart(rep))
        self._tasks.add(task)
        task.add_done_callback(self._tasks.discard)

    async def _restart(self, rep: Replica) -> None:
        """Rebuild a quarantined replica's engine off-loop and rejoin it
        to routing on the fleet's CURRENT generation (re-staged if a
        reload lands mid-rebuild — a restarted replica must never serve
        stale weights next to new-generation siblings)."""
        loop = asyncio.get_running_loop()
        t0 = time.monotonic()
        old_engine = rep.engine
        while True:
            gen, params = self._generation, self._params
            try:
                engine = await loop.run_in_executor(
                    None, self._make_engine, rep.idx, params)
            except Exception as e:  # noqa: BLE001 — a failed rebuild is
                # terminal for the replica, never for the fleet
                rep.state = DEAD
                detail = f"{type(e).__name__}: {e}"[:300]
                flight.record("fleet_event", event="dead", replica=rep.idx,
                              error=detail)
                get_tracer().point("fleet_event", event="dead",
                                   replica=rep.idx, error=detail)
                return
            if gen == self._generation:
                break
            self._close_engine(engine)  # reload landed mid-rebuild: re-stage
        # retire the old engine off-loop too: close() waiting on its
        # abandoned in-flight work must not stall request routing
        await loop.run_in_executor(None, self._close_engine, old_engine)
        rep.engine = engine
        rep.batcher = self._new_batcher(engine)
        rep.generation = gen
        rep.restarts += 1
        rep.state = HEALTHY
        self._restarts.inc()
        dur = time.monotonic() - t0
        flight.record("fleet_event", event="restart", replica=rep.idx,
                      generation=gen, dur_s=round(dur, 4))
        get_tracer().point("fleet_event", event="restart", replica=rep.idx,
                           generation=gen, dur_s=round(dur, 4))
        self._wake_routers()

    # -- hot reload (driven by serve/reload.py) -----------------------------

    async def apply_reload(self, params, step: int) -> int:
        """Swap every replica to `params` with zero downtime: stage ALL
        new-generation engines off-loop first (capacity never dips for a
        capture), then swap replica-by-replica behind a drain — routing
        skips the draining replica, its outstanding futures resolve on
        the OLD engine, and only then does the new engine take the slot.
        No request spans a swap; each swap's `reload_event` point records
        `outstanding_at_swap` (always 0 — the machine-checkable
        invariant). Returns the number of replicas swapped; replicas
        mid-restart rejoin on the new generation via `_restart`'s
        re-stage loop."""
        loop = asyncio.get_running_loop()
        self._generation += 1
        gen = self._generation
        self._params = params
        self.serving_step = int(step)
        staged = {}
        for rep in self.replicas:
            if rep.state in (HEALTHY, DRAINING):
                staged[rep.idx] = await loop.run_in_executor(
                    None, self._make_engine, rep.idx, params)
        swapped = 0
        for rep in self.replicas:
            engine = staged.get(rep.idx)
            if engine is None:
                continue
            if rep.state != HEALTHY or self._closed:
                self._close_engine(engine)  # quarantined mid-reload:
                continue         # _restart re-stages the new generation
            rep.state = DRAINING
            await rep.batcher.drain()
            outstanding = len(rep.batcher._outstanding)
            rep.batcher.close()          # drained: the join is instant
            old = rep.engine
            rep.engine = engine
            rep.batcher = self._new_batcher(engine)
            rep.generation = gen
            rep.state = HEALTHY
            self._wake_routers()
            swapped += 1
            get_tracer().point("reload_event", event="swapped",
                               replica=rep.idx, step=int(step),
                               generation=gen,
                               outstanding_at_swap=outstanding)
            flight.record("reload_event", event="swapped", replica=rep.idx,
                          step=int(step), outstanding_at_swap=outstanding)
            await loop.run_in_executor(None, self._close_engine, old)
        return swapped

    # -- observability ------------------------------------------------------

    def fleet_snapshot(self) -> dict:
        """The live fleet view the `{"op": "health"}` front door and the
        bench artifact share: per-replica state + the failure/retry
        counters, one JSON-able dict."""
        healthy = len(self._healthy())
        return {
            "replicas": len(self.replicas),
            "healthy": healthy,
            "degraded": healthy < len(self.replicas),
            "generation": self._generation,
            "serving_step": self.serving_step,
            "retried_requests": self._retried.value,
            "retry_exhausted": self._retry_exhausted.value,
            "failed_over_requests": self._failovers.value,
            "crashes": self._crashes.value,
            "wedges": self._wedges.value,
            "restarts": self._restarts.value,
            "per_replica": [r.snapshot() for r in self.replicas],
        }

    # -- teardown -----------------------------------------------------------

    async def shutdown(self) -> None:
        """Graceful fleet drain: refuse new work, let every healthy
        replica serve what it accepted, settle restart tasks, then close
        every batcher/engine. Mirrors `ServeService.shutdown` so
        `run_until_drained` works unchanged."""
        self._closed = True
        self.admission.begin_drain()
        for rep in self.replicas:
            if rep.state in (HEALTHY, DRAINING):
                await rep.batcher.drain()
        await self.admission.drained()
        if self._supervisor is not None:
            self._supervisor.cancel()
            try:
                await self._supervisor
            except (asyncio.CancelledError, Exception):  # noqa: BLE001
                pass
        for task in list(self._tasks):
            task.cancel()
        if self._tasks:
            await asyncio.gather(*list(self._tasks), return_exceptions=True)
        for rep in self.replicas:
            rep.batcher.close(wait=rep.state in (HEALTHY, DRAINING))
            self._close_engine(rep.engine)
        self.tracer.flush_exemplars()
