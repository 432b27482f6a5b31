"""In-memory batch loader and its device prefetch (port of
`pytorch_ddp_mnist_tpu/data/loader.py`'s `_batched_indices`,
`BatchLoader` and `device_prefetch` at depth 1).

Every batch has the full batch size: the final partial batch is padded by
wrapping to the shard's head, the same repetition trick DistributedSampler
uses to pad the epoch. The loader yields numpy arrays; `device_prefetch`
copies each into one of two static device slots, which the streaming
loop's captured step reads (train/loop.py `fit`).
"""

from __future__ import annotations

import math
from typing import Iterable, Iterator, Tuple

import numpy as np
import torch


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


def device_prefetch(batches: Iterable, slots: Tuple[torch.Tensor, ...],
                    pinned: Tuple[torch.Tensor, ...] | None = None
                    ) -> Iterator[int]:
    """Copy each host batch (a tuple of numpy arrays, as BatchLoader yields
    them) into device slot k % 2 of `slots` (a tuple of (2, ...) device
    tensors, one per array) and yield k % 2 once the copy is ordered before
    the current stream's next work: the port of the JAX package's
    `device_prefetch` (`pytorch_ddp_mnist_tpu/data/loader.py:214`) at depth
    1, for a step that reads its batch from fixed addresses.

    On a card the copy of batch k + 1 runs on a side stream while the step
    of batch k runs: through `pinned` (a tuple of (2, ...) pinned host
    tensors, reused; made here when None) it waits for the step that last
    read slot (k + 1) % 2, and the current stream waits for it by a CUDA
    event. No pinned slot is rewritten before the copy out of it has
    finished. On the CPU the copy is a plain one."""
    device = slots[0].device
    if device.type != "cuda":
        for k, batch in enumerate(batches):
            for slot, a in zip(slots, batch):
                slot[k % 2].copy_(torch.as_tensor(a))
            yield k % 2
        return
    if pinned is None:
        pinned = tuple(torch.empty(s.shape, dtype=s.dtype, pin_memory=True)
                       for s in slots)
    compute = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device)
    copied = [None, None]   # the copy into slot j has finished
    read = [None, None]     # the step that read slot j has finished
    for k, batch in enumerate(batches):
        j = k % 2
        if copied[j] is not None:
            copied[j].synchronize()
        for host, a in zip(pinned, batch):
            host[j].copy_(torch.as_tensor(a))
        with torch.cuda.stream(side):
            if read[j] is not None:
                side.wait_event(read[j])
            for slot, host in zip(slots, pinned):
                slot[j].copy_(host[j], non_blocking=True)
            copied[j] = side.record_event()
        compute.wait_event(copied[j])
        yield j
        read[j] = compute.record_event()
