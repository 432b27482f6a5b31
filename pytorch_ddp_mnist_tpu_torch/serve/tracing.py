"""Request-scoped tracing: every served request carries a decomposable
latency story (port of `pytorch_ddp_mnist_tpu/serve/tracing.py`: the same
stage catalog, coalesce reasons and schema-v1 span records).

  * `ServeTracer.begin()` stamps a `request_id` at the front door
    (`ServeService.handle`), before admission.
  * A `RequestCtx` rides the request through admission -> batcher pending
    -> flush -> engine -> reply, collecting monotonic stamps at every
    stage boundary. Stage durations (the catalog below) telescope: they
    sum to the request's e2e up to the few instructions between adjacent
    stamps.
  * A `BatchCtx` is stamped per flush (batch_id, bucket, occupancy,
    coalesce reason: size vs deadline vs drain) and every member request
    records its batch_id.
  * Stage durations land in `serve.stage.*_s` registry histograms ALWAYS
    (plain clock reads); schema-v1 span RECORDS are emitted only when
    `telemetry.enable()` has swapped in a real EventTrace — the NullTracer
    default keeps the disabled path at zero extra host syncs and zero
    span records.
  * The slowest-`EXEMPLAR_K` requests (full stage trees) are kept in a
    bounded heap and flushed to the flight recorder at drain.

Stage catalog:

    admission    front door -> admission decision
    queue        batcher enqueue -> the flush that took the request
                 (coalescing wait: the max_delay_ms story)
    batch_form   flush start -> rows stacked/validated
    pad_h2d      stacked -> padded to bucket + host-to-device copy issued
    compute      dispatch -> logits/preds FETCHED (the captured replay and
                 the device-to-host copy are one unit: both are queued on
                 the engine's stream behind one event, and splitting them
                 would need a second event wait on the hot path)
    reply        fetch complete -> the request coroutine resumed with its
                 prediction (future scatter + event-loop wake: loop
                 starvation shows up here, nowhere else)

All stamps use the service's injectable clock, so tests drive attribution
deterministically under a fake clock; at span-emission time durations are
shifted into the perf_counter/time.time frames the schema requires.

Fast-path threading contract: a `BatchCtx` is stamped from two execution
contexts — `t0`/`mark_formed`/`mark_h2d` on the event loop at flush time,
`mark_computed` on the batcher's reply thread when the fetch lands — but
every cross-thread hop is sequenced (queue put/get, then
`call_soon_threadsafe`), so the stamps are monotone in pipeline order and
`batch_end` / `ServeTracer.finish` (span emission, exemplar heap, stage
histograms) still run EXCLUSIVELY on the loop: the EventTrace writer's
single-thread contract is preserved.
"""

from __future__ import annotations

import heapq
import os
import time
from typing import Callable, List, Optional, Tuple

from ..telemetry import events, flight

# The stage catalog — the ONE naming truth shared by the JSONL span attrs,
# the serve.stage.*_s registry histograms, the {"op": "stats"} attribution
# section, and the JAX package's `trace report --serve` table (they must
# never disagree).
STAGES = ("admission", "queue", "batch_form", "pad_h2d", "compute", "reply")
# Why a flush fired: full batch (size), oldest request's deadline
# (deadline), graceful drain (drain), or a direct flush() call (manual —
# tests and embedded callers).
COALESCE_REASONS = ("size", "deadline", "drain", "manual")
# Slowest-request exemplars kept for the flight recorder: enough to see a
# pattern in the tail, bounded so a soak never grows it.
EXEMPLAR_K = 8

REQUEST_SPAN = "serve.request"
BATCH_SPAN = "serve.batch"
# the `<stage>_s` attribute spellings, precomputed ONCE: the per-request
# hot path must not pay six f-string formats per completion
STAGE_KEYS = tuple(f"{s}_s" for s in STAGES)
# batch child stage spans, in pipeline order (the checker validates their
# start stamps are monotone in this order within one batch)
BATCH_STAGE_SPANS = ("serve.batch_form", "serve.pad_h2d", "serve.compute")


class BatchCtx:
    """Stage stamps for one batcher flush. Shared by every request the
    flush carried; the engine marks the H2D and compute boundaries."""

    __slots__ = ("batch_id", "coalesce", "clock", "t0", "t_formed",
                 "t_h2d", "t_computed", "bucket", "n_real")

    def __init__(self, batch_id: str, coalesce: str,
                 clock: Callable[[], float]):
        self.batch_id = batch_id
        self.coalesce = coalesce
        self.clock = clock
        self.t0 = clock()
        self.t_formed: Optional[float] = None
        self.t_h2d: Optional[float] = None
        self.t_computed: Optional[float] = None
        self.bucket: Optional[int] = None
        self.n_real: Optional[int] = None

    def mark_formed(self) -> None:
        """Rows stacked + validated (end of batch_form)."""
        self.t_formed = self.clock()

    def mark_h2d(self, bucket: int) -> None:
        """Padded to `bucket` and device transfer issued (end of
        pad_h2d)."""
        self.bucket = int(bucket)
        self.t_h2d = self.clock()

    def mark_computed(self) -> None:
        """Logits/preds fetched back to host (end of compute)."""
        self.t_computed = self.clock()

    @property
    def complete(self) -> bool:
        return (self.t_formed is not None and self.t_h2d is not None
                and self.t_computed is not None)

    def occupancy(self) -> Optional[float]:
        if not self.bucket or self.n_real is None:
            return None
        return self.n_real / self.bucket


class RequestCtx:
    """One request's stamps, front door to reply. `batch` is filled by the
    flush that carried it (None for requests that failed before one)."""

    __slots__ = ("request_id", "t_arrival", "t_admit", "t_enqueue",
                 "batch", "t_done", "ok")

    def __init__(self, request_id: str, t_arrival: float):
        self.request_id = request_id
        self.t_arrival = t_arrival
        self.t_admit: Optional[float] = None
        self.t_enqueue: Optional[float] = None
        self.batch: Optional[BatchCtx] = None
        self.t_done: Optional[float] = None
        self.ok: Optional[bool] = None

    def stage_values(self) -> "Optional[Tuple[float, ...]]":
        """The telescoped per-stage breakdown as a bare tuple in STAGES
        order (None for a request without a fully stamped batch — a
        failed request has no honest decomposition). The hot path
        records from THIS: no dict, no per-request key formatting."""
        b = self.batch
        if (self.t_admit is None or self.t_enqueue is None
                or self.t_done is None or b is None or not b.complete):
            return None
        return (self.t_admit - self.t_arrival,
                b.t0 - self.t_enqueue,
                b.t_formed - b.t0,
                b.t_h2d - b.t_formed,
                b.t_computed - b.t_h2d,
                self.t_done - b.t_computed)

    def stage_durations(self) -> dict:
        """`stage_values` under its `<stage>_s` key spellings (the span
        attrs / exemplar-tree shape); {} when incomplete."""
        vals = self.stage_values()
        return {} if vals is None else dict(zip(STAGE_KEYS, vals))

    def e2e_s(self) -> Optional[float]:
        if self.t_done is None:
            return None
        return self.t_done - self.t_arrival


class ServeTracer:
    """The request/batch stage clock for one ServeService.

    Always active as a STAGE CLOCK (metrics + exemplars are plain host
    arithmetic); emits schema-v1 span records only while the process-wide
    telemetry tracer is a real EventTrace. One instance per service, used
    from the service's single event loop — same threading contract as
    EventTrace itself."""

    def __init__(self, *, clock: Callable[[], float] = time.monotonic,
                 metrics=None, exemplar_k: int = EXEMPLAR_K):
        self.clock = clock
        self.metrics = metrics
        self.exemplar_k = int(exemplar_k)
        self._req_seq = 0
        self._batch_seq = 0
        self._fin_seq = 0
        self._prefix = f"{os.getpid():x}"
        # min-heap of (e2e_s, finish-seq, tree): the K SLOWEST requests
        # ever seen. The finish counter is the tie-breaker — it is unique
        # PER HEAP ENTRY, so equal e2e values (coarse or injected clocks)
        # never fall through to comparing the tree dicts (TypeError)
        self._exemplars: List[Tuple[float, int, dict]] = []

    # -- request lifecycle -------------------------------------------------

    def begin(self) -> RequestCtx:
        """Front door: assign the request_id and stamp arrival."""
        self._req_seq += 1
        return RequestCtx(f"{self._prefix}-{self._req_seq}", self.clock())

    def admitted(self, rctx: RequestCtx) -> None:
        rctx.t_admit = self.clock()

    def enqueued(self, rctx: RequestCtx, t: Optional[float] = None) -> None:
        """Entered the batcher's pending set; `t` lets the batcher reuse
        its own deadline stamp so queue_s and flush_due never disagree."""
        rctx.t_enqueue = self.clock() if t is None else t

    def batch_begin(self, coalesce: str) -> BatchCtx:
        self._batch_seq += 1
        return BatchCtx(f"{self._prefix}-b{self._batch_seq}", coalesce,
                        self.clock)

    def batch_end(self, bctx: BatchCtx, n_real: int) -> None:
        """Flush finished its engine call: record the batch shape and emit
        the batch span (+ stage children) when tracing is enabled."""
        bctx.n_real = int(n_real)
        tracer = events.get_tracer()
        if not tracer.enabled or not bctx.complete:
            return
        off_mono = time.perf_counter() - self.clock()
        off_wall = time.time() - self.clock()
        occ = bctx.occupancy()
        parent = tracer.emit_span(
            BATCH_SPAN,
            t0_mono=bctx.t0 + off_mono, t0_wall=bctx.t0 + off_wall,
            dur_s=bctx.t_computed - bctx.t0,
            attrs={"batch_id": bctx.batch_id, "bucket": bctx.bucket,
                   "n_real": bctx.n_real,
                   "occupancy": round(occ, 4) if occ is not None else None,
                   "coalesce": bctx.coalesce})
        for name, (t0, t1) in zip(BATCH_STAGE_SPANS, (
                (bctx.t0, bctx.t_formed),
                (bctx.t_formed, bctx.t_h2d),
                (bctx.t_h2d, bctx.t_computed))):
            tracer.emit_span(name, t0_mono=t0 + off_mono,
                             t0_wall=t0 + off_wall, dur_s=t1 - t0,
                             parent=parent,
                             attrs={"batch_id": bctx.batch_id})

    def finish(self, rctx: RequestCtx, *, ok: bool) -> None:
        """Reply delivered (or the request failed): stamp completion, feed
        the stage histograms, emit the request span, keep the exemplar.

        This runs once per completed request at peak service rate, so
        the common path (tracing disabled, exemplar heap full) touches
        no dicts and formats no strings: the stage breakdown rides a
        bare tuple into the histograms, and the keyed spellings are only
        built for an admitted exemplar or an enabled span."""
        rctx.t_done = self.clock()
        rctx.ok = ok
        vals = rctx.stage_values() if ok else None
        if vals is not None and self.metrics is not None:
            self.metrics.record_stage_values(vals)
        e2e = rctx.e2e_s()
        if vals is not None and e2e is not None:
            # heap admission FIRST: at high rps most requests cannot
            # displace the minimum, and must not pay tree construction
            full = len(self._exemplars) >= self.exemplar_k
            if not full or e2e > self._exemplars[0][0]:
                self._fin_seq += 1
                tree = {"request_id": rctx.request_id,
                        "e2e_s": round(e2e, 6),
                        "stages": {k: round(v, 6)
                                   for k, v in zip(STAGE_KEYS, vals)},
                        "batch_id": rctx.batch.batch_id,
                        "bucket": rctx.batch.bucket,
                        "coalesce": rctx.batch.coalesce}
                item = (e2e, self._fin_seq, tree)
                if full:
                    heapq.heapreplace(self._exemplars, item)
                else:
                    heapq.heappush(self._exemplars, item)
        tracer = events.get_tracer()
        if not tracer.enabled or e2e is None:
            return
        off_mono = time.perf_counter() - self.clock()
        off_wall = time.time() - self.clock()
        attrs = {"request_id": rctx.request_id, "ok": ok}
        if rctx.batch is not None:
            attrs["batch"] = rctx.batch.batch_id
        if vals is not None:
            attrs.update((k, round(v, 9))
                         for k, v in zip(STAGE_KEYS, vals))
        tracer.emit_span(REQUEST_SPAN,
                         t0_mono=rctx.t_arrival + off_mono,
                         t0_wall=rctx.t_arrival + off_wall,
                         dur_s=e2e, attrs=attrs)

    # -- exemplars ---------------------------------------------------------

    def exemplars(self) -> List[dict]:
        """Slowest-K request trees, slowest first."""
        return [t for _, _, t in sorted(self._exemplars,
                                        key=lambda it: -it[0])]

    def flush_exemplars(self) -> int:
        """Record the slowest-K request trees into the flight-recorder ring
        (drain-time post-mortem evidence; the ring is bounded and writes no
        I/O) and reset the heap. Returns how many were recorded."""
        trees = self.exemplars()
        for rank, tree in enumerate(trees):
            flight.record("serve_exemplar", rank=rank, **tree)
        self._exemplars.clear()
        return len(trees)
