"""Rank-sharded batch-read plans, the pipeline's source stage (port of
`pytorch_ddp_mnist_tpu/pipeline/reader.py`).

A reader separates the epoch's index PLAN (a lazy stream of
`(batch_index, rows)`: the sampler's shard cut into wrap-padded batches,
data/loader.py `_batched_indices`) from the row LOAD (`read_batch(rows)`: a
memory gather, a sharded .nc pread or a synthetic generator), so that the
decode workers (pipeline/workers.py) can run loads concurrently while the
batch ORDER stays a function of the plan alone.

A source is pipeline-capable when it has what the port's loaders
(data/loader.py `BatchLoader`, `NetCDFShardLoader`) and
pipeline/synthetic.py `SyntheticSource` all have:

    source.sampler          ShardedSampler-shaped (set_epoch / indices)
    source.batch_size       rows a batch
    source.read_batch(rows) -> (x, y) numpy arrays of one index batch

Plain iterables go through `sequential_iter`: no parallel reads, the same
`start` (resume offset) rule.
"""

from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np

from ..data.loader import _batched_indices


def pipeline_capable(source) -> bool:
    """Whether `source` has the plan/load split the worker stage needs."""
    return (hasattr(source, "read_batch") and hasattr(source, "sampler")
            and hasattr(source, "batch_size"))


class ShardReader:
    """The plan/load split over one pipeline-capable source.

    `plan(start)` yields `(batch_index, rows)` lazily from the sampler's
    current epoch, dropping the first `start` batches at the index level
    (skipped rows are never read). `load(rows)` is the source's
    `read_batch`: stateless per batch, safe from worker threads (numpy
    gathers and positional preads share no cursor)."""

    def __init__(self, source):
        if not pipeline_capable(source):
            raise ValueError(
                f"{type(source).__name__} is not pipeline-capable: the "
                f"worker stage needs sampler/batch_size/read_batch(rows) "
                f"(see pipeline/reader.py) — use workers=0 for plain "
                f"sequential iteration")
        self.source = source

    def __len__(self) -> int:
        return len(self.source)

    def plan(self, start: int = 0) -> Iterator[Tuple[int, np.ndarray]]:
        for i, rows in enumerate(_batched_indices(self.source.sampler,
                                                  self.source.batch_size)):
            if i >= start:
                yield i, rows

    def load(self, rows: np.ndarray):
        return self.source.read_batch(rows)


def reshard_source(source, num_replicas: int, rank: int):
    """Re-point a pipeline-capable source at another rank geometry in
    place: `source.sampler` becomes its `reshard(num_replicas, rank)` twin
    (same permutation and seed, new shard, same epoch); the load side is
    row-addressed and does not change. Returns `source`."""
    if not pipeline_capable(source):
        raise ValueError(
            f"{type(source).__name__} is not pipeline-capable: elastic "
            f"re-sharding swaps source.sampler (see pipeline/reader.py)")
    sampler = source.sampler
    if not hasattr(sampler, "reshard"):
        raise ValueError(
            f"{type(sampler).__name__} has no reshard(); elastic "
            f"re-sharding needs parallel.sampler.ShardedSampler")
    source.sampler = sampler.reshard(num_replicas=num_replicas, rank=rank)
    return source


def sequential_iter(source, start: int = 0):
    """The workers=0 path: plain iteration from batch `start`, through
    `iter_from` where the source has it (an index-level skip), else by
    discarding the first `start` batches."""
    if start == 0:
        return iter(source)
    if hasattr(source, "iter_from"):
        return source.iter_from(start)

    def dropped():
        it = iter(source)
        for _ in range(start):
            next(it, None)
        yield from it

    return dropped()
