"""Background decode workers, the pipeline's parallel middle stage (port of
`pytorch_ddp_mnist_tpu/pipeline/workers.py`).

N threads run a `ShardReader`'s loads concurrently while the consumer sees
the batches in plan order: each worker takes the next `(i, rows)` of the
shared lazy plan, loads it (numpy gather and normalise only: a worker
never touches CUDA), and posts the result into a reorder buffer keyed by
batch index; the consumer pops index `start`, `start + 1`, ... as they
complete. Order is enforced at the buffer, not by the schedule, so a slow
batch stalls only the slot budget.

Contracts (the JAX docstring's):

  * backpressure: at most `num_workers * queue_depth` batches exist beyond
    the consumer at any moment (a counting semaphore: a worker takes a
    slot before it pulls work, the consumer gives it back when it pops
    the batch);
  * errors in order: a load that raises parks the error in its batch's
    slot, and the consumer re-raises the original exception when it
    reaches that index, after the batches before it; a broken plan
    iterator surfaces the same way;
  * shutdown: the consumer's exit (exhaustion, an error or an early
    `close()`) stops the workers and joins them; a worker waiting on the
    semaphore wakes within 0.1 s and sees the stop flag;
  * one-shot: a pool serves one epoch (`feed` builds one per call); a
    second iteration raises by name;
  * telemetry: `data.batch_wait_s` (the consumer's wait per batch),
    `data.queue_depth` (the reorder buffer's depth at each pop),
    `data.batches` and `data.workers` in the port's registry
    (telemetry/registry.py). Host clock reads only: no device work.

Chaos: each worker fires the `loader_next` fault point
(utils/faultpoints.py, `loader_stall`) before each load, so a stall holds
up production and the consumer waits on the bounded buffer, as on a slow
disk.
"""

from __future__ import annotations

import threading
import time
from typing import Optional

from ..utils import faultpoints
from .reader import ShardReader


class _WorkerFailure:
    """A load (or plan) error, parked in the reorder buffer at the batch
    index it belongs to so the consumer re-raises it in order."""

    __slots__ = ("error",)

    def __init__(self, error: BaseException):
        self.error = error


class WorkerPool:
    """One epoch of parallel loads over `reader`, consumed by iterating the
    pool once."""

    def __init__(self, reader: ShardReader, num_workers: int, *,
                 start: int = 0, queue_depth: int = 2, registry=None):
        if num_workers < 1:
            raise ValueError(f"num_workers must be >= 1; got {num_workers}")
        if queue_depth < 1:
            raise ValueError(f"queue_depth must be >= 1; got {queue_depth}")
        self._reader = reader
        self._num_workers = int(num_workers)
        self._start = int(start)
        self._slots = threading.BoundedSemaphore(
            self._num_workers * int(queue_depth))
        self._plan_lock = threading.Lock()
        self._plan = reader.plan(self._start)
        self._plan_done = False
        self._issued = self._start        # next batch index the plan owes
        self._cv = threading.Condition()
        self._done: dict = {}             # batch index -> batch | failure
        self._end: Optional[int] = None   # one past the last issued index
        self._stop = threading.Event()
        self._threads: list = []
        self._iterated = False
        if registry is None:
            from ..telemetry import get_registry
            registry = get_registry()
        self._wait_hist = registry.histogram("data.batch_wait_s")
        self._depth_gauge = registry.gauge("data.queue_depth")
        self._batch_counter = registry.counter("data.batches")
        registry.gauge("data.workers").set(self._num_workers)

    # -- producer side -----------------------------------------------------

    def _work(self) -> None:
        while not self._stop.is_set():
            # bounded wait so a stopped pool never strands a worker here
            if not self._slots.acquire(timeout=0.1):
                continue
            with self._plan_lock:
                if self._plan_done:
                    self._slots.release()
                    return
                try:
                    i, rows = next(self._plan)
                    self._issued = i + 1
                except StopIteration:
                    self._plan_done = True
                    self._slots.release()
                    with self._cv:
                        self._end = self._issued
                        self._cv.notify_all()
                    return
                except BaseException as e:  # broken plan: surfaces in order
                    self._plan_done = True
                    err_at = self._issued
                    with self._cv:
                        self._done[err_at] = _WorkerFailure(e)
                        self._end = err_at + 1
                        self._cv.notify_all()
                    return
            try:
                faultpoints.fire("loader_next", batch=i)
                item = self._reader.load(rows)
            except BaseException as e:  # noqa: BLE001 — parked in the
                # reorder buffer and re-raised by the consumer in order
                item = _WorkerFailure(e)
            with self._cv:
                self._done[i] = item
                self._cv.notify_all()

    # -- consumer side -----------------------------------------------------

    def __iter__(self):
        if self._iterated:
            raise RuntimeError(
                "WorkerPool is one-shot: its plan iterator is consumed — "
                "build a fresh pool (pipeline.feed) per epoch")
        self._iterated = True
        return self._consume()

    def _consume(self):
        self._threads = [
            threading.Thread(target=self._work, daemon=True,
                             name=f"pdmt-input-worker-{w}")
            for w in range(self._num_workers)
        ]
        for t in self._threads:
            t.start()
        try:
            i = self._start
            while True:
                t0 = time.perf_counter()
                with self._cv:
                    while i not in self._done and (self._end is None
                                                   or i < self._end):
                        self._cv.wait(0.1)
                    if i not in self._done:
                        return              # plan exhausted, all yielded
                    item = self._done.pop(i)
                    depth_now = len(self._done)
                self._wait_hist.record(time.perf_counter() - t0)
                self._depth_gauge.set(depth_now)
                self._slots.release()
                if isinstance(item, _WorkerFailure):
                    raise item.error
                self._batch_counter.inc()
                yield item
                i += 1
        finally:
            self._shutdown()

    def _shutdown(self) -> None:
        self._stop.set()
        with self._cv:
            self._cv.notify_all()
        for t in self._threads:
            t.join(timeout=5)
