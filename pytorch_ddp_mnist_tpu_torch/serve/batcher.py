"""Async micro-batching queue: coalesce single-row requests into bucketed
engine calls (port of `pytorch_ddp_mnist_tpu/serve/batcher.py`).

One request per forward pass wastes the card (a (1, 784) product is pure
launch overhead), while unbounded coalescing holds early arrivals hostage
to late ones. The batcher bounds both sides — a flush fires when
`max_batch` rows are pending (throughput side) or when the OLDEST pending
request has waited `max_delay_ms` (latency side), whichever comes first.

Two flush paths share that policy:

* **fast path** (a real `InferenceEngine`, the default): `submit` writes
  each request's row straight into the engine's pinned staging slab at
  enqueue time, so `batch_form` collapses to index bookkeeping — no
  np.stack, no fresh allocation per flush. The flush LAUNCHES the bucket's
  graph (`engine.dispatch_staged`: H2D, replay, D2H and an event, all
  queued on the engine's stream) and returns to the loop immediately. The
  reply is then ROUTED one loop pass later, cheapest-first: results
  already in host memory (the event has completed) are fetched INLINE;
  fetches whose recent cost (EWMA) sits under the inline budget (~one
  coalescing deadline) are taken inline too; work still in flight goes to
  a dedicated **reply thread** that waits on the event off-loop and
  re-enters the loop via `call_soon_threadsafe` to scatter. The reply
  thread's only CUDA work is that wait and reading pinned memory.
* **legacy path** (duck-typed engine wrappers without the staging API, or
  `fast=False`): rows accumulate as tuples, the flush stacks/pads/runs/
  scatters synchronously.

The deadline clock is injectable (`clock=`) and the flush decision is a pure
function of (now, pending) — `flush_due(now)` — so tests drive coalescing
deterministically under a fake clock instead of racing real timers.

Threading contract: `submit`/`flush`/`drain` stay event-loop-only; the
reply thread (`_reply_worker`) only fetches and enqueues the loop-side
`_scatter` callback — futures, tracer spans, and metrics are touched
exclusively on the loop.

Fleet supervision (serve/fleet.py): every fast-path flush is journaled
from dispatch to scatter; `oldest_inflight_age` is what the fleet's wedge
watchdog ages, `fail_all` releases every waiter of a replica taken down,
and `close(wait=False)` abandons a reply thread blocked in a wedged fetch.
A late `_scatter` whose journal entry `fail_all` removed delivers nothing.
"""

from __future__ import annotations

import asyncio
import queue
import threading
import time
from typing import Callable, List, Optional, Tuple

import numpy as np

from .engine import IN_DIM

# Staging-capable engines expose exactly this surface; anything less (the
# tests' recording wrappers, embedded duck-typed engines) gets the legacy
# stack-at-flush path.
_FAST_API = ("staging", "dispatch_staged", "fetch_staged")

# Floor of the reply router's inline-fetch budget (seconds): a flush
# whose recent fetches ran under max(budget, max_delay_ms) is fetched ON
# the loop — blocking it for at most about one coalescing deadline, which
# is time the oldest request would have waited anyway — instead of paying
# a cross-thread handoff (one GIL switch interval each way on a
# contended host). Fetches past the budget (real card compute) go
# to the reply thread, where blocking belongs.
INLINE_FETCH_BUDGET_S = 2e-3


class MicroBatcher:
    """Coalesces `submit`ted rows into engine calls.

    Not thread-safe: like any asyncio building block it lives on one event
    loop. On the fast path the engine call is DISPATCHED from the loop but
    fetched on the reply thread, so the loop never blocks on device
    execution; on the legacy path the call is synchronous (at MNIST-MLP
    scale a bucket forward is far cheaper than a loop tick).
    """

    def __init__(self, engine, *, max_batch: Optional[int] = None,
                 max_delay_ms: float = 2.0, metrics=None,
                 clock: Callable[[], float] = time.monotonic, tracer=None,
                 fast: Optional[bool] = None):
        self.engine = engine
        self.max_batch = int(max_batch or engine.max_batch)
        if not 1 <= self.max_batch <= engine.max_batch:
            raise ValueError(
                f"max_batch {self.max_batch} outside [1, {engine.max_batch}]"
                f" (the engine's largest captured bucket)")
        if max_delay_ms < 0:
            raise ValueError(f"max_delay_ms must be >= 0; got {max_delay_ms}")
        self.max_delay_s = max_delay_ms / 1000.0
        self.metrics = metrics
        self.clock = clock
        # serve.tracing.ServeTracer (or None for the standalone/legacy
        # construction): stamps the per-flush BatchCtx and links every
        # member request's ctx to it
        self.tracer = tracer
        self.engine_in_dim = IN_DIM
        # fast path only when the engine actually has the staging surface;
        # fast=False forces legacy (the A/B knob bench.py --no_fast rides)
        has_api = all(hasattr(engine, m) for m in _FAST_API)
        self.fast_path = has_api if fast is None else bool(fast) and has_api
        # (row, future, t_enqueue, rctx) tuples awaiting a flush; on the
        # fast path `row` is None — the row already lives in the engine's
        # staging slab at its enqueue index. rctx is the request's tracing
        # context (None from bare submit() callers).
        self._pending: List[Tuple[Optional[np.ndarray], asyncio.Future,
                                  float, object]] = []
        self._timer: Optional[asyncio.TimerHandle] = None
        self.flushes = 0
        # flushes completed inline on the loop — results already
        # device-complete when the router ran, or fetched within the
        # inline budget — vs handed to the reply thread (the routing's
        # observable)
        self.inline_replies = 0
        # PER-BUCKET EWMAs of recent fetch_staged wall times, the
        # router's cost model: a bucket with no history never blocks the
        # loop on a guess — and small-bucket history never vouches for a
        # top-bucket flush whose compute is proportionally longer (the
        # mispredict would stall the loop for the whole bucket compute).
        # Written from whichever context fetched last (loop or reply
        # thread) — a benign last-writer-wins float heuristic, never a
        # correctness input.
        self._fetch_ewma: "dict[int, float]" = {}
        self._inline_budget_s = max(self.max_delay_s,
                                    INLINE_FETCH_BUDGET_S)
        # fast path plumbing: the loop captured at submit time (the one
        # the reply thread re-enters), futures not yet resolved (drain
        # awaits them), and the fetch work queue feeding the reply thread
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._outstanding: "set[asyncio.Future]" = set()
        self._reply_q: "queue.Queue" = queue.Queue()
        self._reply_thread: Optional[threading.Thread] = None
        # In-flight journal for the fleet supervisor (serve/fleet.py):
        # id(batch) -> (t_dispatch, batch) for every fast-path flush
        # dispatched but not yet scattered. Loop-side only (opened in
        # _flush_fast, closed in _scatter); `fail_all` empties it.
        self._inflight_meta: "dict[int, tuple]" = {}
        if self.fast_path:
            # spawn eagerly: thread startup is construction-time cost,
            # never first-request latency (close() stops it; a later
            # flush would respawn)
            self._ensure_reply_thread()

    @property
    def depth(self) -> int:
        return len(self._pending)

    def flush_due(self, now: float) -> bool:
        """True when the pending set must flush at time `now`: full batch,
        or the oldest request's deadline has arrived."""
        if not self._pending:
            return False
        if len(self._pending) >= self.max_batch:
            return True
        return now - self._pending[0][2] >= self.max_delay_s

    async def submit(self, row, rctx=None) -> int:
        """Enqueue one request row; resolves to its predicted class.
        `rctx` (a `serve.tracing.RequestCtx`) gets the enqueue stamp and,
        at flush time, a link to the batch that carried the request.

        A malformed row raises HERE, synchronously to its own caller — it
        must never reach the flush (and on the fast path must never touch
        the staging slab), where one bad row would poison the whole
        coalesced batch."""
        row = np.asarray(row).reshape(-1)   # (1, 784) and (784,) both fine
        if row.shape != (self.engine_in_dim,):
            raise ValueError(f"request row must have {self.engine_in_dim} "
                             f"pixels; got shape {np.asarray(row).shape}")
        loop = asyncio.get_running_loop()
        self._loop = loop
        fut: asyncio.Future = loop.create_future()
        t_enq = self.clock()
        if rctx is not None and self.tracer is not None:
            # one stamp serves both the flush-deadline bookkeeping and the
            # queue stage — they must never disagree about when waiting
            # started
            self.tracer.enqueued(rctx, t_enq)
        if self.fast_path:
            # zero-copy batch forming: the row lands at its final batch
            # index in the persistent staging slab NOW; the flush is left
            # with index bookkeeping only (the assignment casts to the
            # engine dtype exactly like _as_rows did). Passing ourselves
            # claims the slab — a second batcher filling the same engine
            # concurrently fails loudly instead of corrupting silently.
            self.engine.staging(self)[len(self._pending)] = row
            self._pending.append((None, fut, t_enq, rctx))
        else:
            self._pending.append((row, fut, t_enq, rctx))
        if len(self._pending) >= self.max_batch:
            self.flush(reason="size")
        elif self._timer is None:
            # one timer per oldest-pending request: it fires at that
            # request's deadline and flush() re-arms for the next batch
            self._timer = loop.call_later(self.max_delay_s, self._on_timer)
        return await fut

    def _on_timer(self) -> None:
        self._timer = None
        if self.flush_due(self.clock()):
            self.flush(reason="deadline")
        elif self._pending:
            # injected-clock drift (tests): re-arm for the remainder
            remain = self.max_delay_s - (self.clock() - self._pending[0][2])
            self._timer = asyncio.get_event_loop().call_later(
                max(remain, 0.0), self._on_timer)

    def flush(self, reason: str = "manual") -> int:
        """Flush every pending row through the engine; returns the number
        of rows flushed. On the fast path the engine call is DISPATCHED
        and the reply thread fills the futures once results land on the
        host; on the legacy path everything completes synchronously here.
        `reason` records WHY the batch formed (size / deadline / drain /
        manual) on its tracing context — the coalescing knob's observable
        output."""
        if self._timer is not None:
            self._timer.cancel()
            self._timer = None
        batch, self._pending = self._pending, []
        if not batch:
            return 0
        bctx = (self.tracer.batch_begin(reason)
                if self.tracer is not None else None)
        if self.fast_path:
            return self._flush_fast(batch, bctx)
        try:
            rows = np.stack([r for r, _, _, _ in batch])
            x = self.engine._as_rows(rows)
            if bctx is not None:
                bctx.mark_formed()
            # the bctx arg only when tracing is wired: duck-typed engine
            # wrappers with the original one-arg _run_bucket keep working
            _, preds, bucket = (self.engine._run_bucket(x, bctx)
                                if bctx is not None
                                else self.engine._run_bucket(x))
        except Exception as e:  # scatter the failure — a waiter must never
            for _, fut, _, _ in batch:                    # hang on a crash
                if not fut.done():
                    fut.set_exception(e)
            return len(batch)
        self.flushes += 1
        if self.metrics is not None:
            self.metrics.record_batch(len(batch), bucket)
        if bctx is not None:
            self.tracer.batch_end(bctx, n_real=len(batch))
        for (_, fut, _, rctx), pred in zip(batch, preds):
            if rctx is not None:
                rctx.batch = bctx
            if not fut.done():
                fut.set_result(int(pred))
        return len(batch)

    # -- fast path: dispatch on the loop, fetch on the reply thread --------

    def _flush_fast(self, batch, bctx) -> int:
        """The staged flush: rows are ALREADY in the engine's staging slab
        (written at enqueue), so forming the batch is this clock stamp —
        then dispatch H2D + compute and hand the in-flight handle to the
        reply thread. The loop is free again in microseconds."""
        if bctx is not None:
            bctx.mark_formed()
        try:
            handle = self.engine.dispatch_staged(len(batch), bctx)
        except Exception as e:  # dispatch failed (OOM forensics already
            for _, fut, _, _ in batch:          # recorded): scatter it —
                if not fut.done():              # a waiter must never hang
                    fut.set_exception(e)
            return len(batch)
        self.flushes += 1
        self._inflight_meta[id(batch)] = (self.clock(), batch)
        for _, fut, _, _ in batch:
            self._outstanding.add(fut)
            fut.add_done_callback(self._outstanding.discard)
        # Defer the reply decision ONE loop pass (lets a short
        # executable finish while other callbacks run), then route it.
        self._loop.call_soon(self._route_reply, (handle, batch, bctx))
        return len(batch)

    def _route_reply(self, item) -> None:
        """Loop-side reply routing, cheapest-first:

        1. results already device-complete -> fetch inline (a no-wait
           asarray; zero cross-thread handoff — which costs one GIL
           switch interval each way on a contended host);
        2. recent fetches OF THIS BUCKET ran under the inline budget
           (~one coalescing deadline) -> fetch inline anyway: blocking
           the loop for less than the deadline the oldest request
           already tolerated beats paying the handoff twice per flush;
        3. else (card-scale compute, or no history for this
           bucket yet) -> the reply thread blocks on the fetch OFF the
           loop.
        """
        handle, batch, bctx = item
        ewma = self._fetch_ewma.get(handle.bucket)
        # inline_ok is False only for a deliberately wedged handle (fault
        # injection): EWMA history must never vouch a hung fetch onto the
        # loop, which would blind the fleet watchdog under test
        if handle.ready() or (ewma is not None
                              and ewma <= self._inline_budget_s
                              and getattr(handle, "inline_ok", True)):
            self.inline_replies += 1
            self._scatter(self._fetch_payload(handle, batch, bctx))
        else:
            self._ensure_reply_thread()
            self._reply_q.put((handle, batch, bctx, self._loop))

    def _fetch_payload(self, handle, batch, bctx):
        """Fetch one flush's results into a scatter payload (result or
        the fetch's own exception). Runs on the reply thread for
        in-flight work, on the loop for the inline cases — either way
        the engine's exactly-two-fetches-per-flush budget holds.

        The router's cost model only learns from fetches that actually
        WAITED (not device-complete when the fetch started): a no-wait
        fetch measures pure copy cost, and letting it drag the EWMA down
        would license an inline fetch of a not-yet-ready flush at the
        next quiet-to-busy transition — blocking the loop for a full
        bucket compute, the exact stall the budget bounds."""
        waited = not handle.ready()
        t0 = time.monotonic()
        try:
            _, preds = self.engine.fetch_staged(handle)
            if bctx is not None:
                bctx.mark_computed()
            payload = (batch, bctx, handle.bucket, preds, None)
        except Exception as e:  # noqa: BLE001 — fetch fault barrier:
            # the error is delivered to every waiter via the scatter
            # (re-raised at each await site); swallowing only a narrow
            # set would strand waiters on an unforeseen one
            payload = (batch, bctx, handle.bucket, None, e)
        if waited:
            dur = time.monotonic() - t0
            prev = self._fetch_ewma.get(handle.bucket)
            self._fetch_ewma[handle.bucket] = (
                dur if prev is None else 0.5 * prev + 0.5 * dur)
        return payload

    def _ensure_reply_thread(self) -> None:
        if self._reply_thread is None or not self._reply_thread.is_alive():
            self._reply_thread = threading.Thread(
                target=self._reply_worker, name="serve-reply", daemon=True)
            self._reply_thread.start()

    def _reply_worker(self) -> None:
        """The dedicated reply thread (spawned by `_ensure_reply_thread`):
        wait for each flush's event OFF the event loop, then re-enter the loop via
        `call_soon_threadsafe` to scatter. Touches no future, tracer, or
        metrics state itself — that is `_scatter`'s, on the loop."""
        while True:
            item = self._reply_q.get()
            if item is None:
                return
            handle, batch, bctx, loop = item
            payload = self._fetch_payload(handle, batch, bctx)
            try:
                loop.call_soon_threadsafe(self._scatter, payload)
            except RuntimeError:
                # loop already closed (abandoned service, no drain): the
                # futures' awaiters are gone with it; nothing to deliver
                return

    def _scatter(self, payload) -> None:
        """Loop-side completion of one fast-path flush: metrics, the
        batch-end span, and the per-request future fill (exactly what the
        legacy flush tail does, minus the fetch that already happened
        off-loop)."""
        batch, bctx, bucket, preds, err = payload
        # a journal entry missing here means `fail_all` already failed this
        # flush over (a quarantined replica's late fetch finally landing):
        # end the batch span, but record no batch and fill no future; the
        # requests were retried elsewhere
        abandoned = (self._inflight_meta.pop(id(batch), None) is None
                     and self.fast_path)
        if abandoned:
            if bctx is not None:
                self.tracer.batch_end(bctx, n_real=len(batch))
            return
        if err is not None:
            for _, fut, _, _ in batch:
                if not fut.done():
                    fut.set_exception(err)
            return
        if self.metrics is not None:
            self.metrics.record_batch(len(batch), bucket)
        if bctx is not None:
            self.tracer.batch_end(bctx, n_real=len(batch))
        for (_, fut, _, rctx), pred in zip(batch, preds):
            if rctx is not None:
                rctx.batch = bctx
            if not fut.done():
                fut.set_result(int(pred))

    async def drain(self) -> None:
        """Flush whatever is pending and return once it is served — on
        the fast path that means awaiting every outstanding future the
        reply thread still owes (the legacy path resolves them inside
        flush)."""
        self.flush(reason="drain")
        if self._outstanding:
            await asyncio.gather(*list(self._outstanding),
                                 return_exceptions=True)
        # gather returns without yielding when every future was already
        # done, before their discard callbacks ran: drop the answered ones
        # here, so `_outstanding` after a drain counts only the unanswered
        # (the fleet's `outstanding_at_swap`)
        self._outstanding.difference_update(
            [f for f in self._outstanding if f.done()])

    # -- fleet supervision surface (serve/fleet.py) -------------------------

    def oldest_inflight_age(self, now: float) -> float:
        """Age (seconds) of the oldest dispatched-but-unscattered flush at
        `now`, 0.0 when nothing is in flight: what the fleet supervisor
        compares against its wedge timeout. Loop-side."""
        if not self._inflight_meta:
            return 0.0
        return now - min(t for t, _ in self._inflight_meta.values())

    def fail_all(self, exc: BaseException) -> int:
        """Failover: deliver `exc` to every in-flight AND pending request
        of this batcher and forget them; returns how many waiters were
        released. Loop-side; a wedged flush's late `_scatter` then finds
        its journal entry gone and delivers nothing twice."""
        n = 0
        if self._timer is not None:
            self._timer.cancel()
            self._timer = None
        for _, batch in list(self._inflight_meta.values()):
            for _, fut, _, _ in batch:
                if not fut.done():
                    fut.set_exception(exc)
                    n += 1
        self._inflight_meta.clear()
        pending, self._pending = self._pending, []
        for _, fut, _, _ in pending:
            if not fut.done():
                fut.set_exception(exc)
                n += 1
        return n

    def close(self, wait: bool = True) -> None:
        """Stop the reply thread (sentinel + join). Call after `drain` —
        anything still queued is fetched and delivered first because the
        sentinel lands behind it. Idempotent; the next fast-path flush
        would simply spawn a fresh thread.

        `wait=False` abandons instead of joining: the sentinel is queued
        so a live thread exits once it finishes what it is on, but a
        thread blocked inside a wedged fetch is left behind (daemon: it
        cannot hold the process). That is the fleet's retirement path for
        a wedged replica, where joining would block the supervisor for
        exactly the hang being escaped."""
        if self._reply_thread is not None and self._reply_thread.is_alive():
            self._reply_q.put(None)
            if wait:
                self._reply_thread.join(timeout=10.0)
        self._reply_thread = None
