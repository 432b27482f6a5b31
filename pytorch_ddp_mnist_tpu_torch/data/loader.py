"""In-memory batch loader (port of `pytorch_ddp_mnist_tpu/data/loader.py`'s
`_batched_indices` + `BatchLoader`).

Every batch has the full batch size: the final partial batch is padded by
wrapping to the shard's head, the same repetition trick DistributedSampler
uses to pad the epoch. The loader yields numpy arrays; the train loop moves
each batch to its device.
"""

from __future__ import annotations

import math
from typing import Iterator, Tuple

import numpy as np


def _batched_indices(sampler, batch_size: int) -> Iterator[np.ndarray]:
    """Split this rank's shard into fixed-size index batches, wrap-padding
    the final one."""
    shard = np.asarray(sampler.indices())
    for start in range(0, shard.size, batch_size):
        b = shard[start:start + batch_size]
        if b.size < batch_size:
            b = np.concatenate([b, np.resize(shard, batch_size - b.size)])
        yield b


class BatchLoader:
    """Yields (x, y) numpy batches for `sampler`'s shard: `images` is the
    pre-normalised (n, 784) float32 array, labels come out as int32."""

    def __init__(self, images: np.ndarray, labels: np.ndarray, sampler,
                 batch_size: int):
        self.images = np.ascontiguousarray(images)
        self.labels = np.asarray(labels)
        self.sampler = sampler
        self.batch_size = int(batch_size)

    def __len__(self) -> int:
        return math.ceil(len(self.sampler) / self.batch_size)

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        for b in _batched_indices(self.sampler, self.batch_size):
            yield self.images[b], self.labels[b].astype(np.int32)
