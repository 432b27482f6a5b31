"""A synthetic pipeline source with a read-latency knob (port of
`pytorch_ddp_mnist_tpu/pipeline/synthetic.py`).

`bench --mode input` needs a source whose cost is a knob: this one makes
batches from (seed, row index) and sleeps `latency_s` per batch at read
time, so the legacy synchronous loop can be made input-bound and the
pipeline's share of that wait measured. Rows are gathered from a 251-row
base table (a prime, so rows % 251 does not line up with the batch size),
so memory stays O(features) whatever the epoch's length.

It is pipeline-capable (pipeline/reader.py): `sampler` is the port's own
`ShardedSampler` (the loaders' reshuffle), `batch_size`, `read_batch(rows)`,
plus the loader surface `__len__` / `__iter__` / `iter_from`. For the same
seed its batches are the JAX package's `SyntheticSource`'s, bit for bit.
"""

from __future__ import annotations

import math
import time
from typing import Iterator, Tuple

import numpy as np

from ..data.loader import _batched_indices
from ..parallel.sampler import ShardedSampler

_TABLE_ROWS = 251   # prime: rows % 251 decorrelates from batch_size


class SyntheticSource:
    """A loader-shaped batch source of synthetic rows. `latency_s` is slept
    per `read_batch`: in a worker when piped, in the consumer when not."""

    def __init__(self, n_batches: int = 64, batch_size: int = 128, *,
                 features: int = 784, classes: int = 10,
                 latency_s: float = 0.0, seed: int = 0):
        if n_batches < 1 or batch_size < 1:
            raise ValueError(f"n_batches/batch_size must be >= 1; got "
                             f"{n_batches}/{batch_size}")
        self.batch_size = int(batch_size)
        self.features = int(features)
        self.classes = int(classes)
        self.latency_s = float(latency_s)
        n_rows = int(n_batches) * self.batch_size
        self.sampler = ShardedSampler(n_rows, num_replicas=1, rank=0,
                                      shuffle=True, seed=seed)
        rng = np.random.default_rng(seed)
        self._table = rng.standard_normal(
            (_TABLE_ROWS, self.features)).astype(np.float32)

    def __len__(self) -> int:
        return math.ceil(len(self.sampler) / self.batch_size)

    def read_batch(self, rows: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        if self.latency_s > 0:
            time.sleep(self.latency_s)
        x = self._table[rows % _TABLE_ROWS]
        y = (rows % self.classes).astype(np.int32)
        return x, y

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        return self.iter_from(0)

    def iter_from(self, start: int) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """Sequential iteration from batch `start`, skipping at the index
        level; the `loader_next` fault point fires before each load."""
        from ..utils import faultpoints
        for i, b in enumerate(_batched_indices(self.sampler,
                                               self.batch_size)):
            if i >= start:
                faultpoints.fire("loader_next", batch=i)
                yield self.read_batch(b)
