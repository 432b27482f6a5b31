"""Depth-K device prefetch, the pipeline's host-to-device stage (port of
`pytorch_ddp_mnist_tpu/pipeline/prefetch.py`, on CUDA streams instead of
`jax.device_put`).

`prefetch(source, depth=K, put=...)` keeps up to K batches' copies in
flight while the consumer steps on the current one: `put(batch)` starts
batch k + K's copy before batch k is handed over, and `ready(item)` orders
a copy before the consumer's work when the item is handed over. Order is
the source's. If the source or a `put` raises, every copy already started
is waited for (`drain`, secondary errors swallowed) before the original
exception is re-raised, so the device owes nothing by the time the caller
sees it. The default put copies a batch's arrays from pinned host memory
on a side stream and records an event; its ready makes the current stream
wait for that event.

`SlotRing` is the `put` of the streaming loop's captured step (train/
loop.py `fit`), whose graph reads its batch from fixed addresses: a ring
of K + 1 device slots and K + 1 pinned host slabs. Batch m goes to slot
m % (K + 1):

  * the host writes pinned slab j only after the copy out of it (batch
    m - K - 1's) has finished (its event);
  * the copy into device slot j runs on a side stream that first waits
    for the work queued on the compute stream so far, which holds the
    step of batch m - K - 1, the last one that read slot j (or, at an
    epoch's start, the last epoch's steps);
  * the compute stream waits for batch k's copy (its event) just before
    step k is queued (`ready`), not when the copy starts.

With K = 1 this is data/loader.py `device_prefetch`, the two-slot double
buffer. On the CPU the copies are plain ones. Nothing here runs in the
decode workers: they make numpy arrays, and the copies start on the
consumer's thread.
"""

from __future__ import annotations

from collections import deque
from typing import Callable, Optional

import numpy as np
import torch


def _drain(pending: deque, drain: Callable) -> None:
    """Wait for every copy already started, swallowing secondary errors:
    the primary exception is already propagating."""
    while pending:
        item = pending.popleft()
        try:
            drain(item)
        except Exception:  # noqa: BLE001 — teardown only; the original
            pass           # error is re-raised by the caller


class _StreamPut:
    """The default put, ready and drain of `prefetch` to `device`: each
    array of a tuple batch copied from pinned host memory (non-blocking)
    on a side stream, an event recorded after the copies; on the CPU a
    plain copy."""

    def __init__(self, device: torch.device):
        self.device = device
        self.cuda = device.type == "cuda"
        if self.cuda:
            self.compute = torch.cuda.current_stream(device)
            self.side = torch.cuda.Stream(device)

    def put(self, batch):
        host = [torch.as_tensor(np.asarray(a)) for a in batch]
        if not self.cuda:
            return tuple(t.to(self.device) for t in host), None
        with torch.cuda.stream(self.side):
            out = tuple(t.pin_memory().to(self.device, non_blocking=True)
                        for t in host)
            event = self.side.record_event()
        for t in out:    # used on the compute stream: keep its memory
            t.record_stream(self.compute)
        return out, event

    def ready(self, item):
        out, event = item
        if event is not None:
            self.compute.wait_event(event)
        return out

    @staticmethod
    def drain(item) -> None:
        if item[1] is not None:
            item[1].synchronize()


def prefetch(source, *, depth: int = 1, put: Optional[Callable] = None,
             device=None, ready: Optional[Callable] = None,
             drain: Optional[Callable] = None):
    """Iterate `source` with `depth` batches of copy lookahead.

    `put(batch)` starts a batch's copy; `ready(item)` returns what the
    consumer gets (default: the item as it is); `drain(item)` waits for one
    started copy. Without `put`, the batch's arrays go to `device` on a
    side stream (`_StreamPut`). Validation is eager: a bad depth raises
    here, not at the first batch."""
    if depth < 1:
        raise ValueError(f"depth must be >= 1; got {depth}")
    if put is None:
        if device is None:
            raise ValueError("prefetch needs put= or device=")
        stream = _StreamPut(torch.device(device))
        put, ready, drain = stream.put, stream.ready, stream.drain
    return _prefetch_gen(source, depth, put, ready or (lambda item: item),
                         drain or (lambda _item: None))


def _prefetch_gen(source, depth: int, put: Callable, ready: Callable,
                  drain: Callable):
    pending: deque = deque()
    it = iter(source)
    try:
        exhausted = False
        while len(pending) < depth and not exhausted:
            try:
                pending.append(put(next(it)))
            except StopIteration:
                exhausted = True
        if not exhausted:
            for batch in it:
                # append BEFORE yielding: the consumer can close the
                # generator at the yield, and a copy not yet in `pending`
                # would escape the drain
                pending.append(put(batch))
                yield ready(pending.popleft())
        while pending:
            yield ready(pending.popleft())
    except BaseException:
        _drain(pending, drain)
        raise


class SlotRing:
    """The static batch slots of a captured step as a ring (see the module
    docstring): `slots` is a tuple of (R, ...) device tensors, one per
    array of a batch; `pinned` the matching (R, ...) pinned host slabs
    (made here when None, on a card). `feed(batches, depth)` yields each
    batch's slot index in order, at most `depth` = R - 1 copies ahead; an
    epoch's first batch goes to slot 0, as the step's cursor starts
    there, and a resumed epoch's first batch, step `start`, to slot
    start % R, where the cursor reads it. One ring serves every epoch of
    a run."""

    def __init__(self, slots, pinned=None):
        self.slots = tuple(slots)
        self.size = int(self.slots[0].shape[0])
        self.device = self.slots[0].device
        self._n = 0
        self._cuda = self.device.type == "cuda"
        if self._cuda:
            self.pinned = pinned if pinned is not None else tuple(
                torch.empty(s.shape, dtype=s.dtype, pin_memory=True)
                for s in self.slots)
            self._compute = torch.cuda.current_stream(self.device)
            self._side = torch.cuda.Stream(self.device)
            self._copied = [None] * self.size

    def put(self, batch) -> int:
        m, self._n = self._n, self._n + 1
        j = m % self.size
        if not self._cuda:
            for slot, a in zip(self.slots, batch):
                slot[j].copy_(torch.as_tensor(np.asarray(a)))
            return j
        if self._copied[j] is not None:
            self._copied[j].synchronize()     # pinned slab j is free
        for host, a in zip(self.pinned, batch):
            host[j].copy_(torch.as_tensor(np.asarray(a)))
        with torch.cuda.stream(self._side):
            if self._copied[j] is not None:
                # the last reader of slot j (batch m - size's step, or a
                # step of the epoch before) is queued on the compute
                # stream by now
                self._side.wait_stream(self._compute)
            for slot, host in zip(self.slots, self.pinned):
                slot[j].copy_(host[j], non_blocking=True)
            self._copied[j] = self._side.record_event()
        return j

    def ready(self, j: int) -> int:
        """Order slot j's copy before the compute stream's next work."""
        if self._cuda:
            self._compute.wait_event(self._copied[j])
        return j

    def drain(self, j: int) -> None:
        if self._cuda and self._copied[j] is not None:
            self._copied[j].synchronize()

    def feed(self, batches, depth: int = 1, start: int = 0):
        if not 1 <= depth < self.size:
            raise ValueError(f"a ring of {self.size} slots takes a depth of "
                             f"1..{self.size - 1}; got {depth}")
        self._n = int(start)
        return prefetch(batches, depth=depth, put=self.put, ready=self.ready,
                        drain=self.drain)
