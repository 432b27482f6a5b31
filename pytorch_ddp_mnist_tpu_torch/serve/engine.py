"""Inference engine: a params checkpoint turned into a warm, bucketed forward
pass that never captures mid-request (port of
`pytorch_ddp_mnist_tpu/serve/engine.py`).

The JAX engine AOT-compiles one executable per rung of a bucket ladder of
batch shapes (powers of two up to `max_batch`) at construction and serves
every request from those executables. On a card the counterpart of an AOT
executable is a CUDA graph: the engine captures ONE graph per rung at
construction, over a static device input of shape (bucket, 784) in the
engine's input dtype (float32 rows, or raw uint8 pixels normalised first
by data/mnist.py `device_normalize`, bitwise the JAX op chain) and static
outputs (bucket, 10) float32 logits and (bucket,) int32 preds. A request
only ever REPLAYS a graph: a bucket without one raises by name, and
`capture_count` (the counterpart of `compile_count`) equals
`len(buckets)` after construction and never grows. The forward is the JAX
package's `mlp_apply(train=False)` (models/mlp.py), outside any
hand-written kernel there and here: its three products are torch.matmul.
True f32 products: the engine turns TF32 off on the card, as the trainer
does, before it captures.

Every call runs on the engine's own CUDA stream, under one lock, as one
sequence: copy the bucket's leading rows host-to-device (non-blocking,
from pinned memory) into the graph's static input, replay, copy logits and
preds device-to-host (non-blocking) into pinned output buffers that belong
to the call's host slab, and record an event. The next call's replay is
queued behind this call's device-to-host copies, so a static output is
never overwritten before it was copied out; every slab has its own output
buffers, so an in-flight batch's results stay where they landed until its
fetch. `InflightBatch.ready()` is the event's `query()`; a fetch waits on
the event and copies the real rows out. On the CPU (`device="cpu"`, the
tests) the same sequence runs the forward eagerly on the same static
buffers, with no graph, no stream and no event.

The serve fast path: the engine owns a small pool of top-rung-shaped
pinned host slabs (`STAGING_SLOTS`), every rung's staging array is a
leading-rows view of one, and the micro-batcher writes request rows
straight into the active slab's numpy view at enqueue time.
`dispatch_staged` zeroes the pad tail, launches, and swaps slabs so the
next flush accumulates while this one is in flight (double-buffered H2D).
A slab goes back to the pool only at its fetch (after the event: its
host-to-device read has completed) or at `close()`; growth past the pool
is counted (`staging_grown`), never silent. Direct `forward` / `predict`
replay the same graphs from slabs of their own, dispatching every
`max_batch` chunk before fetching any.

Served equals direct, bitwise: a request's rows take the same bucket graph
whether they arrive alone or coalesced into a flush of the same bucket,
padded with zeros both ways. The JAX engine's mesh replication is not
here (cli/serve.py names it).

Fleet plumbing (serve/fleet.py): `replica` is the slot this engine fills
(None outside a fleet), and every launch counts a per-engine ordinal. The
`serve_engine` fault point fires with both before any device work, so
`engine_crash:after=N:replica=R` kills exactly one replica at a set point
in a burst and leaves the slab pool as it was. `dispatch_staged` claims
the `serve_wedge` point: a claimed batch reports not-ready and its fetch
sleeps out `delay_s`, a device that stopped answering in handle form, and
the fleet watchdog's in-flight aging is what must notice.

Several engines share one card in a fleet, and a restart or a reload
builds an engine on an executor thread while its siblings serve. So every
capture takes one process-wide lock and runs in the thread-local capture
mode, directly on `torch.cuda.CUDAGraph` (not the `torch.cuda.graph`
context, whose entry synchronizes the device and empties the allocator's
cache): a sibling thread's event query, wait or allocation stays legal
while a capture is open, and a sync in the capturing thread's own
forward still fails its capture.
"""

from __future__ import annotations

import threading
import time
from bisect import bisect_left
from typing import Optional, Sequence

import numpy as np
import torch

from ..data.mnist import device_normalize
from ..models.mlp import MLP_DIMS, init_params, mlp_apply
from ..telemetry.runtime import label_compiles, note_capture
from ..train.checkpoint import load_checkpoint
from ..train.graphs import side_stream
from ..utils import faultpoints

IN_DIM = MLP_DIMS[0]
OUT_DIM = MLP_DIMS[-1]

# Host staging slabs the engine keeps warm for the serve fast path: two is
# the double buffer (flush N+1 accumulates and dispatches while flush N is
# in flight); the pool grows past it only when replies lag more than one
# flush behind, and growth is counted (`staging_grown`), never silent.
STAGING_SLOTS = 2
# eager forwards of each rung on a side stream before its capture: cuBLAS's
# handle and workspace exist before the graph is recorded
WARMUP_CALLS = 2
# one capture at a time in the process: the engines of a fleet build on
# executor threads, and two open captures would contend for the
# allocator's capture pools
_CAPTURE_LOCK = threading.Lock()

_DTYPES = {"float32": (np.float32, torch.float32),
           "uint8": (np.uint8, torch.uint8)}


class _Slab:
    """One call's host memory: the input rows and the logits / preds the
    device copies back, as (pinned, on a card) tensors and numpy views."""

    __slots__ = ("x", "logits", "preds", "x_np", "logits_np", "preds_np")

    def __init__(self, rows: int, dtype: torch.dtype, pin: bool):
        self.x = torch.zeros((rows, IN_DIM), dtype=dtype, pin_memory=pin)
        self.logits = torch.empty((rows, OUT_DIM), dtype=torch.float32,
                                  pin_memory=pin)
        self.preds = torch.empty((rows,), dtype=torch.int32, pin_memory=pin)
        self.x_np = self.x.numpy()
        self.logits_np = self.logits.numpy()
        self.preds_np = self.preds.numpy()


class _Rung:
    """One bucket: its static device input and outputs and, on a card, the
    graph captured over them."""

    __slots__ = ("bucket", "x", "logits", "preds", "graph", "capture_s",
                 "pool_bytes")

    def __init__(self, bucket: int, dtype: torch.dtype, device):
        self.bucket = bucket
        self.x = torch.zeros((bucket, IN_DIM), dtype=dtype, device=device)
        self.logits = self.preds = self.graph = None
        self.capture_s = self.pool_bytes = None


class InflightBatch:
    """One launched bucket call whose results have not been fetched yet:
    its event (None on the CPU, where the call completed eagerly), the host
    slab its rows rode in on and its results land in, and the real row
    count to trim back to."""

    __slots__ = ("event", "slab", "n", "bucket", "wedged_until")

    def __init__(self, event, slab: _Slab, n: int, bucket: int):
        self.event = event
        self.slab = slab
        self.n = n
        self.bucket = bucket
        # injected-wedge deadline (`engine_wedge`): until this monotonic
        # instant the batch reports not-ready and its fetch blocks. 0.0
        # (never) outside chaos runs.
        self.wedged_until = 0.0

    def ready(self) -> bool:
        """Non-blocking: True when the results are in host memory, so a
        fetch would return without waiting (the batcher's inline reply)."""
        if self.wedged_until and time.monotonic() < self.wedged_until:
            return False
        return self.event is None or self.event.query()

    @property
    def inline_ok(self) -> bool:
        """False while an injected wedge holds this batch: the reply router
        must never take a wedged fetch inline, which would block the loop
        and blind the watchdog the wedge exists to test."""
        return not (self.wedged_until
                    and time.monotonic() < self.wedged_until)


def bucket_ladder(max_batch: int, multiple_of: int = 1) -> "tuple[int, ...]":
    """Ascending power-of-two batch buckets up to `max_batch`, each a
    multiple of `multiple_of` (the JAX engine's mesh device count). The
    JAX package's `bucket_ladder`: `max_batch` itself is always the top
    rung so the ladder covers the batcher's largest flush even when the
    cap is not a power of two."""
    if max_batch < 1:
        raise ValueError(f"max_batch must be >= 1; got {max_batch}")
    if max_batch % multiple_of != 0:
        raise ValueError(
            f"max_batch {max_batch} must be a multiple of the mesh device "
            f"count {multiple_of} (each bucket shards equal rows per "
            f"replica)")
    ladder = []
    b = 1
    while b < max_batch:
        if b % multiple_of == 0:
            ladder.append(b)
        b *= 2
    ladder.append(max_batch)
    return tuple(ladder)


def default_device() -> torch.device:
    """cuda:0; with no card it raises, naming it (pass device='cpu')."""
    if not torch.cuda.is_available():
        raise RuntimeError("the serve engine runs on the card: no CUDA card "
                           "is available (torch.cuda.is_available() is "
                           "False); pass device='cpu' for the CPU")
    return torch.device("cuda", 0)


class InferenceEngine:
    """Warm bucketed forward pass over a params tree (`{"fc1": {"w", "b"},
    "fc2": {"w", "b"}, "fc3": {"w"}}` of tensors or arrays, the JAX
    layout; copied) on `device` (default cuda:0).

    `predict(x)` / `forward(x)` pad the batch to the smallest bucket that
    holds it and replay that bucket's graph; results come back trimmed to
    the real rows. Two requests for the same rows are bitwise identical
    whether they arrive alone or coalesced into a larger flush of the SAME
    bucket."""

    def __init__(self, params, *, max_batch: int = 128, device=None,
                 input_dtype: str = "float32",
                 buckets: Optional[Sequence[int]] = None):
        if input_dtype not in _DTYPES:
            raise ValueError(f"input_dtype must be 'float32' or 'uint8'; "
                             f"got {input_dtype!r}")
        self.max_batch = int(max_batch)
        self.input_dtype = input_dtype
        self._np_dtype, self._dtype = _DTYPES[input_dtype]
        self.device = (default_device() if device is None
                       else torch.device(device))
        self.buckets = (tuple(sorted(set(int(b) for b in buckets)))
                        if buckets is not None
                        else bucket_ladder(self.max_batch))
        for b in self.buckets:
            if not 1 <= b <= self.max_batch:
                raise ValueError(f"bucket {b} outside [1, {self.max_batch}]"
                                 f" (the staging slabs hold max_batch rows)")
        self._cuda = self.device.type == "cuda"
        self._params = {n: {k: torch.as_tensor(v).detach().to(
                                self.device, torch.float32, copy=True)
                            for k, v in layer.items()}
                        for n, layer in params.items()}
        self._stream = None
        if self._cuda:
            # true f32 products, as the trainer's (cli/train.py): cuBLAS
            # must not take a reduced-precision path in a captured graph
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
            self._stream = torch.cuda.Stream(self.device)
        # bucket -> rung; populated ONLY here. Serving looks rungs up and
        # never captures, so a missing shape raises by name.
        self._rungs = {}
        self.capture_count = 0
        for b in self.buckets:
            rung = _Rung(b, self._dtype, self.device)
            if self._cuda:
                self._capture(rung)
            self._rungs[b] = rung
            self.capture_count += 1
        # one launch sequence (H2D, replay, D2H, event) at a time: two
        # interleaved would let one call's replay read the other's rows
        self._launch_lock = threading.Lock()
        # -- serve fast path: persistent staging + in-flight tracking -----
        # The lock guards the pool handoff between the event loop
        # (dispatch_staged) and the reply thread (fetch_staged / close).
        self._staging_lock = threading.Lock()
        self._staging_pool = [self._new_slab()
                              for _ in range(STAGING_SLOTS - 1)]
        self._active_slab = self._new_slab()
        self._inflight: dict = {}
        self.staging_grown = 0
        # whoever is currently FILLING the active slab (a MicroBatcher
        # passes itself): two concurrent writers would silently corrupt
        # each other's batches, so the second one fails loudly instead
        self._staging_writer = None
        # fleet plumbing: the replica slot this engine fills (None outside
        # a fleet) and the launch ordinal the serve fault points match on
        self.replica: Optional[int] = None
        self._serve_calls = 0

    @classmethod
    def from_checkpoint(cls, path: str, **kw) -> "InferenceEngine":
        """Load params from a reference-layout `.pt` / `.pth` (the port's,
        the JAX package's or the reference's own), a `.npz` params tree,
        or a flax `.msgpack` (the JAX package's or the port's,
        train/checkpoint.py)."""
        return cls(load_checkpoint(path, init_params(0)), **kw)

    @classmethod
    def from_seed(cls, seed: int, **kw) -> "InferenceEngine":
        """Fresh params: the JAX package's `init_mlp(jax.random.key(seed))`,
        bit for bit (models/mlp.py `init_params`)."""
        return cls(init_params(seed), **kw)

    # -- the forward and its capture ----------------------------------------

    def _fn(self, x: torch.Tensor):
        if x.dtype == torch.uint8:
            x = device_normalize(x)
        logits = mlp_apply(self._params, x.to(torch.float32), train=False)
        return logits, torch.argmax(logits, dim=-1).to(torch.int32)

    def _capture(self, rung: _Rung) -> None:
        """Warm the rung's forward on a side stream, then capture it there
        in the thread-local mode, under the process-wide capture lock (see
        the module docstring). The capture is one `xla.compiles` of label
        `serve.bucket<N>` (telemetry/runtime.py `note_capture`); the rung
        keeps its seconds and its graph pool's bytes."""
        dev = self.device
        t0 = time.perf_counter()
        with _CAPTURE_LOCK, torch.cuda.device(dev), \
                label_compiles(f"serve.bucket{rung.bucket}"):
            current = torch.cuda.current_stream(dev)
            side = side_stream(dev)
            side.wait_stream(current)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.stream(side):
                for _ in range(WARMUP_CALLS):
                    self._fn(rung.x)
                reserved = torch.cuda.memory_reserved(dev)
                graph.capture_begin(capture_error_mode="thread_local")
                try:
                    try:
                        logits, preds = self._fn(rung.x)
                    finally:
                        graph.capture_end()
                except RuntimeError as e:
                    raise RuntimeError(
                        f"serve engine: capturing bucket {rung.bucket} as "
                        f"a CUDA graph failed: {e}") from e
                rung.pool_bytes = torch.cuda.memory_reserved(dev) - reserved
            current.wait_stream(side)
            rung.capture_s = time.perf_counter() - t0
            note_capture(rung.capture_s)
        rung.logits, rung.preds, rung.graph = logits, preds, graph

    def capture_stats(self) -> dict:
        """{bucket: {"capture_s", "pool_bytes"}} of the rungs captured on
        the card (empty on the CPU, where nothing is captured)."""
        return {b: {"capture_s": r.capture_s, "pool_bytes": r.pool_bytes}
                for b, r in self._rungs.items() if r.graph is not None}

    def _fault_ctx(self) -> dict:
        ctx = {"after": self._serve_calls}
        if self.replica is not None:
            ctx["replica"] = self.replica
        return ctx

    def _launch(self, slab: _Slab, bucket: int, bctx=None):
        """Run `bucket`'s rung on the slab's leading rows; results land in
        the slab's output buffers. Returns the call's event (None on the
        CPU, where the call is complete on return)."""
        rung = self._rungs.get(bucket)
        if rung is None:
            raise KeyError(f"bucket {bucket} has no captured graph (ladder "
                           f"{self.buckets}); requests never capture one")
        with self._launch_lock:
            # before any device work: an injected crash leaves the slab
            # pool and the card as they were
            self._serve_calls += 1
            faultpoints.fire("serve_engine", **self._fault_ctx())
            if not self._cuda:
                rung.x.copy_(slab.x[:bucket])
                if bctx is not None:
                    bctx.mark_h2d(bucket)
                logits, preds = self._fn(rung.x)
                slab.logits[:bucket].copy_(logits)
                slab.preds[:bucket].copy_(preds)
                return None
            with torch.cuda.stream(self._stream):
                rung.x.copy_(slab.x[:bucket], non_blocking=True)
                if bctx is not None:
                    bctx.mark_h2d(bucket)
                rung.graph.replay()
                slab.logits[:bucket].copy_(rung.logits, non_blocking=True)
                slab.preds[:bucket].copy_(rung.preds, non_blocking=True)
                return self._stream.record_event()

    # -- serving ----------------------------------------------------------

    def bucket_for(self, n: int) -> int:
        """Smallest bucket holding `n` rows (a bisect over the ascending
        ladder: this runs once per flush on the serve hot path)."""
        i = bisect_left(self.buckets, n)
        if i == len(self.buckets):
            raise ValueError(f"batch of {n} rows exceeds the largest "
                             f"bucket {self.buckets[-1]} "
                             f"(max_batch {self.max_batch})")
        return self.buckets[i]

    def _new_slab(self, rows: Optional[int] = None) -> _Slab:
        return _Slab(rows or self.max_batch, self._dtype, self._cuda)

    def _dispatch(self, x: np.ndarray, bctx=None) -> InflightBatch:
        """Pad `x` to its bucket in a slab of its own and launch, without
        fetching (the multi-chunk `forward`/`predict` overlap, and the
        legacy batcher path's first half)."""
        n = x.shape[0]
        bucket = self.bucket_for(n)
        slab = self._new_slab(bucket)      # zeros: the pad tail is inert
        slab.x_np[:n] = x
        return InflightBatch(self._launch(slab, bucket, bctx), slab, n,
                             bucket)

    @staticmethod
    def _wait(handle: InflightBatch) -> None:
        if handle.event is not None:
            handle.event.synchronize()

    def _run_bucket(self, x: np.ndarray, bctx=None):
        """Pad `x` to its bucket, run, and FETCH. Returns (logits, preds,
        bucket) for the REAL rows only; `bctx` (a `serve.tracing.BatchCtx`)
        gets the pad/H2D and compute stamps."""
        h = self._dispatch(x, bctx)
        self._wait(h)
        out = (h.slab.logits_np[:h.n].copy(), h.slab.preds_np[:h.n].copy(),
               h.bucket)
        if bctx is not None:
            bctx.mark_computed()
        return out

    # -- the serve fast path: persistent staging ---------------------------

    def staging(self, owner=None) -> np.ndarray:
        """The host slab (numpy view) the NEXT staged flush dispatches
        from. The batcher writes request row i into `staging()[i]` at
        enqueue time.

        `owner` (the batcher, when writing rows) claims the active slab
        until the next `dispatch_staged`: the slab is engine-global state,
        so a SECOND concurrent filler would silently overwrite the first's
        rows and serve wrong predictions — that misuse raises here
        instead. Sequential services over one shared engine (each drains
        before the next serves) stay fine: every dispatch releases the
        claim."""
        if owner is not None:
            if self._staging_writer is None:
                self._staging_writer = owner
            elif self._staging_writer is not owner:
                raise RuntimeError(
                    "engine staging slab is already being filled by "
                    "another batcher — one engine serves ONE batcher at "
                    "a time (the fast path's staging is engine-global "
                    "state)")
        return self._active_slab.x_np

    def dispatch_staged(self, n: int, bctx=None) -> InflightBatch:
        """Dispatch rows 0..n of the active staging slab: zero the pad
        tail (padding stays inert whatever the slab carried last flush),
        launch WITHOUT fetching, and swap the active slab so the caller
        accumulates the next flush while this one is in flight (the
        double buffer). `fetch_staged` (any thread) completes it."""
        if not 1 <= n <= self.max_batch:
            raise ValueError(f"staged flush of {n} rows outside "
                             f"[1, {self.max_batch}]")
        bucket = self.bucket_for(n)
        self._staging_writer = None    # the claim ends with the flush
        slab = self._active_slab
        if n != bucket:
            slab.x_np[n:bucket] = 0
        handle = InflightBatch(self._launch(slab, bucket, bctx), slab, n,
                               bucket)
        # injected wedge (`engine_wedge:delay_s=S:replica=R`): the batch
        # reports not-ready and its fetch blocks until the deadline, so
        # the reply thread hangs off-loop as on a card that stopped
        # answering
        spec = faultpoints.claim("serve_wedge", **self._fault_ctx())
        if spec is not None:
            handle.wedged_until = time.monotonic() + spec.delay_s
        with self._staging_lock:
            self._inflight[id(handle)] = handle
            if self._staging_pool:
                self._active_slab = self._staging_pool.pop()
            else:
                # replies are lagging more than a full flush behind: grow
                # the pool rather than overwrite a slab the device may
                # still be reading — counted, so the steady-state
                # zero-allocation pin can see any growth
                self._active_slab = self._new_slab()
                self.staging_grown += 1
        return handle

    def fetch_staged(self, handle: InflightBatch):
        """Wait for `handle`'s event and return its (logits, preds) trimmed
        to the real rows, copied out of the slab. The slab rides back into
        the staging pool EVEN when the wait raises (a failed flush's device
        work is over either way — leaking the slab per failure would bleed
        the pool on a long-running server). A wedged handle blocks here
        until its deadline (on the reply thread: the router never inlines
        it). A handle that `close()` abandoned meanwhile (a quarantined
        replica's reply thread waking late) reads nothing: its slab is back
        in the pool, and the fetch raises by name instead."""
        if handle.wedged_until:
            time.sleep(max(0.0, handle.wedged_until - time.monotonic()))
        try:
            self._wait(handle)
            with self._staging_lock:
                abandoned = id(handle) not in self._inflight
            if abandoned:
                raise RuntimeError(
                    f"in-flight batch of {handle.n} rows (bucket "
                    f"{handle.bucket}) was abandoned by close() before its "
                    f"fetch; its slab is back in the pool")
            logits = handle.slab.logits_np[:handle.n].copy()
            preds = handle.slab.preds_np[:handle.n].copy()
        finally:
            self._release(handle)
        return logits, preds

    def _release(self, handle: InflightBatch) -> None:
        with self._staging_lock:
            if self._inflight.pop(id(handle), None) is not None:
                self._staging_pool.append(handle.slab)

    @property
    def inflight_count(self) -> int:
        with self._staging_lock:
            return len(self._inflight)

    def close(self) -> None:
        """Wait for every staged dispatch still in flight and return its
        slab to the pool (by the time close returns the device owes
        nothing). Idempotent, and the engine stays serveable afterwards —
        close quiesces, it does not poison."""
        self._staging_writer = None   # an aborted filler's claim dies too
        with self._staging_lock:
            pending = list(self._inflight.values())
            self._inflight.clear()
        for h in pending:
            try:
                self._wait(h)
            except Exception:  # noqa: BLE001 — teardown drain only: an
                pass           # abandoned call's own failure has no
                               # waiter left to deliver to
            with self._staging_lock:
                self._staging_pool.append(h.slab)

    def _as_rows(self, x) -> np.ndarray:
        x = np.asarray(x, self._np_dtype)
        if x.ndim == 1:
            x = x[None, :]
        if x.ndim != 2 or x.shape[1] != IN_DIM:
            raise ValueError(f"expected (n, {IN_DIM}) rows; got {x.shape}")
        return np.ascontiguousarray(x)

    def _dispatch_chunks(self, x) -> "list[InflightBatch]":
        """Launch EVERY max_batch chunk before anything is fetched, so the
        chunks queue back to back on the engine's stream."""
        return [self._dispatch(x[i:i + self.max_batch])
                for i in range(0, len(x), self.max_batch)]

    def _fetch_chunks(self, handles, which: str) -> np.ndarray:
        """One output (`logits_np` / `preds_np`) per launched chunk. If a
        wait fails, the remaining chunks are waited for before the error
        propagates (the device owes nothing once the caller sees it)."""
        outs = []
        for i, h in enumerate(handles):
            try:
                self._wait(h)
            except BaseException:
                for later in handles[i + 1:]:
                    try:
                        self._wait(later)
                    except Exception:  # noqa: BLE001 — teardown drain:
                        pass           # the primary error is the one the
                                       # caller must see
                raise
            outs.append(getattr(h.slab, which)[:h.n])
        return np.concatenate(outs, axis=0)

    def forward(self, x) -> np.ndarray:
        """Logits (n, 10) float32 for `x` (n, 784); chunks batches larger
        than max_batch, every chunk launched before the first fetch."""
        return self._fetch_chunks(self._dispatch_chunks(self._as_rows(x)),
                                  "logits_np")

    def predict(self, x) -> np.ndarray:
        """Argmax classes (n,) int32 for `x` (n, 784); same chunking as
        `forward`."""
        return self._fetch_chunks(self._dispatch_chunks(self._as_rows(x)),
                                  "preds_np")
