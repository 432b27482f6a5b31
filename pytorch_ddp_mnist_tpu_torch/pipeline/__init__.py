"""The staged input pipeline (port of `pytorch_ddp_mnist_tpu/pipeline/`):

    source  ->  plan (lazy index batches, rank-sharded)       reader.py
            ->  N decode workers, bounded reorder buffer      workers.py
            ->  depth-K prefetch on a CUDA side stream        prefetch.py
            ->  the train loop

`feed()` is the front door: train/loop.py `fit` iterates it instead of a
bare loader. `workers=0, depth=1` is the legacy synchronous path, and any
configuration gives the batches of unpiped iteration over the same source,
in the same order, bit for bit. The streaming loop's captured step takes
its batches through `prefetch.SlotRing` (its static slots as a ring of
depth + 1) fed by `host_iter`. The consumer side adds no device sync:
worker handoff and the `data.*` metrics are host clock reads.
"""

from __future__ import annotations

import time

from .prefetch import SlotRing, prefetch
from .reader import ShardReader, pipeline_capable, sequential_iter
from .synthetic import SyntheticSource
from .workers import WorkerPool

__all__ = ["feed", "host_iter", "prefetch", "pipeline_capable",
           "ShardReader", "SlotRing", "SyntheticSource", "WorkerPool"]


def _recorded(it, registry=None):
    """Wrap a sequential host iterator with the metrics the worker pool
    publishes (`data.batch_wait_s`, `data.batches`), so a piped and an
    unpiped run expose the same telemetry. Clock reads only."""
    if registry is None:
        from ..telemetry import get_registry
        registry = get_registry()
    hist = registry.histogram("data.batch_wait_s")
    batches = registry.counter("data.batches")

    def recorded():
        inner = iter(it)
        while True:
            t0 = time.perf_counter()
            try:
                item = next(inner)
            except StopIteration:
                return
            hist.record(time.perf_counter() - t0)
            batches.inc()
            yield item

    return recorded()


def host_iter(source, *, workers: int = 0, start: int = 0,
              queue_depth: int = 2, registry=None):
    """The host half of the pipeline: parallel loads behind a reorder
    buffer when `workers > 0`, plain (recorded) iteration otherwise.
    `start` is the resume offset, an index-level skip in both. `workers >
    0` on a source that cannot split plan from load is refused by name: a
    "parallel" pipeline that quietly ran sequentially would mislabel every
    measurement."""
    if workers < 0:
        raise ValueError(f"workers must be >= 0; got {workers}")
    if workers == 0:
        return _recorded(sequential_iter(source, start), registry)
    return iter(WorkerPool(ShardReader(source), workers, start=start,
                           queue_depth=queue_depth, registry=registry))


def feed(source, *, workers: int = 0, depth: int = 1, start: int = 0,
         queue_depth: int = 2, put=None, device=None, registry=None):
    """`source` -> device-ready batches in source order: `workers` decode
    threads (0: synchronous reads), `depth` batches of copy lookahead,
    `start` the resume offset; `put` places a host batch (default: each
    array to `device`)."""
    return prefetch(host_iter(source, workers=workers, start=start,
                              queue_depth=queue_depth, registry=registry),
                    depth=depth, put=put, device=device)
