"""Batch loaders, in memory and sharded from a NetCDF file, and their
device prefetch (port of `pytorch_ddp_mnist_tpu/data/loader.py`'s
`_batched_indices`, `BatchLoader`, `NetCDFShardLoader` and
`device_prefetch`).

Every batch has the full batch size: the final partial batch is padded by
wrapping to the shard's head, the same repetition trick DistributedSampler
uses to pad the epoch. The loaders yield numpy arrays and are
pipeline-capable (pipeline/reader.py: `sampler`, `batch_size`,
`read_batch(rows)`); `device_prefetch` copies each batch into one of two
static device slots, which the streaming loop's captured step reads: the
depth-1 case of pipeline/prefetch.py `SlotRing`.
"""

from __future__ import annotations

import math
from typing import Iterable, Iterator, Tuple

import numpy as np
import torch

from ..utils import faultpoints
from .mnist import normalize_images


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

    def read_batch(self, b: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """One index batch -> (x, y): the pipeline's load half, stateless
        per batch, safe from worker threads (numpy gathers share no
        cursor)."""
        return self.images[b], self.labels[b].astype(np.int32)

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        return self.iter_from(0)

    def iter_from(self, start: int) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """This epoch's batches from batch `start`: the skipped batches'
        rows are dropped at the index level, never gathered. The
        `loader_next` fault point (utils/faultpoints.py, `loader_stall`)
        fires before each load."""
        for i, b in enumerate(_batched_indices(self.sampler, self.batch_size)):
            if i >= start:
                faultpoints.fire("loader_next", batch=i)
                yield self.read_batch(b)


def open_reader(path: str):
    """(reader, core) of a NetCDF or IDX file: the native core where it
    builds ("native"), else the pure-Python parser ("python"). Both have
    `variables` and `read(name, rows=None)`."""
    from .native import NativeReader, native_available
    if native_available():
        return NativeReader(path), "native"
    from .netcdf import NetCDFReader
    return NetCDFReader(path), "python"


class NetCDFShardLoader:
    """Disk-sharded loader: each batch is a row gather from the shared .nc
    file for this rank's sampler indices only, the PnetCDF independent-I/O
    analog (mnist_pnetcdf_cpu_mp.py:32,46) without MPI: positional preads
    through the native C++ core (data/native.py), or through the
    pure-Python parser (data/netcdf.py) where the core cannot be built.
    `core` names the one in use ("native" or "python").

    Batches are bitwise BatchLoader's over the same sampler state: gather
    then normalise is elementwise, so normalize(all)[idx] ==
    normalize(gather(idx)). `sampler` may be None at construction (so
    `num_samples` can size it) but is assigned before iterating. Labels are
    read whole at construction (one coalesced read of n bytes, the serial
    reference's collective label read, mnist_pnetcdf_cpu.py:47); a batch
    reads its images only.

    `num_workers > 0` reads ahead: that many threads gather and normalise
    upcoming batches into bounded queues while the consumer trains (the
    reference's DataLoader workers, mnist_pnetcdf_cpu.py:58-60, as
    threads). Worker w makes batches w, w + N, ... and the consumer takes
    the queues in turn, so the order is the synchronous one.
    """

    def __init__(self, path: str, sampler=None, *, batch_size: int,
                 num_workers: int = 0):
        self.path = path
        self.sampler = sampler
        self.batch_size = int(batch_size)
        self.num_workers = int(num_workers)
        self._reader, self.core = open_reader(path)
        images = self._reader.variables["images"]
        shape = images[0] if self.core == "native" else images.shape
        self.num_samples = int(shape[0])
        self._labels = self._reader.read("labels")

    def read_head(self, n: int) -> Tuple[np.ndarray, np.ndarray]:
        """The file's first `n` rows whole, (uint8 (n, 28, 28), uint8 (n,)):
        the resident-dataset path's read (one coalesced read on the native
        core)."""
        rows = None if n >= self.num_samples else np.arange(n)
        return self._reader.read("images", rows), self._labels[:n]

    def __len__(self) -> int:
        return math.ceil(len(self.sampler) / self.batch_size)

    def read_batch(self, b: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """One index batch -> (x (B, 784) float32, y (B,) int32). Safe from
        worker threads: both cores read by positional preads."""
        return (normalize_images(self._reader.read("images", b)),
                self._labels[b].astype(np.int32))

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        batches = list(_batched_indices(self.sampler, self.batch_size))
        if self.num_workers <= 0 or len(batches) <= 1:
            for i, b in enumerate(batches):
                faultpoints.fire("loader_next", batch=i)
                yield self.read_batch(b)
            return
        yield from self._iter_readahead(batches)

    def _iter_readahead(self, batches):
        """N worker threads, bounded queues, strict batch order."""
        import queue
        import threading

        nw = min(self.num_workers, len(batches))
        qs = [queue.Queue(maxsize=2) for _ in range(nw)]
        stop = threading.Event()

        def work(w: int) -> None:
            try:
                for i in range(w, len(batches), nw):
                    faultpoints.fire("loader_next", batch=i)
                    item = self.read_batch(batches[i])
                    while not stop.is_set():
                        try:
                            qs[w].put(item, timeout=0.1)
                            break
                        except queue.Full:
                            continue
                    if stop.is_set():
                        return
            except Exception as e:  # noqa: BLE001 — raised in the consumer
                qs[w].put(e)

        threads = [threading.Thread(target=work, args=(w,), daemon=True)
                   for w in range(nw)]
        for t in threads:
            t.start()
        try:
            for i in range(len(batches)):
                item = qs[i % nw].get()
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()
            for q in qs:  # unblock any worker parked in put()
                try:
                    q.get_nowait()
                except queue.Empty:
                    pass
            for t in threads:
                t.join(timeout=5)


def device_prefetch(batches: Iterable, slots: Tuple[torch.Tensor, ...],
                    pinned: Tuple[torch.Tensor, ...] | None = None
                    ) -> Iterator[int]:
    """Copy each host batch (a tuple of numpy arrays, as BatchLoader yields
    them) into device slot k % 2 of `slots` (a tuple of (2, ...) device
    tensors, one per array) and yield k % 2 once the copy is ordered before
    the current stream's next work: the JAX package's `device_prefetch`
    (`pytorch_ddp_mnist_tpu/data/loader.py:214`), an alias of its
    pipeline's prefetch at depth 1, here pipeline/prefetch.py `SlotRing`
    of two slots at depth 1. `pinned` are the (2, ...) pinned host slabs
    (made here when None, on a card)."""
    from ..pipeline.prefetch import SlotRing
    return SlotRing(slots, pinned).feed(batches, depth=1)
