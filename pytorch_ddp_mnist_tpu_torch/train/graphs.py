"""Compiled per-step loops: one training step captured as a CUDA graph and
replayed once a step (the port's counterpart of the JAX package's jitted
step and `lax.scan` epoch, `pytorch_ddp_mnist_tpu/train/loop.py:80` and
`train/scan.py:1-10`).

JAX never runs a training step as a string of eager ops: the streaming
step is one `jax.jit` program and the resident-dataset epoch one
`lax.scan`. On a card the counterpart of a compiled program is a CUDA
graph, which replays a fixed sequence of kernels with no host dispatch
between them. A graph replays fixed addresses and fixed launch arguments,
so everything a step reads that changes from step to step lives in a
static device buffer that the host fills and the step indexes with a
device step cursor:

  * the step's rows: the epoch's index buffer (S, B) over the resident
    dataset (train/scan.py), or the streaming loop's two batch slots
    (train/loop.py, data/loader.py `device_prefetch`);
  * the step's key: the epoch's key table (S, 2), or (S, n, 2) for n
    replicas (ops/threefry.py `step_key_words`), which the kernels and the
    mask entry read from device memory (K1-rng's seed too: word 0 of the
    row, ops/fused_step.py `fused_loss_and_grads_rng` of a row);
  * the cursor, a 0-d int64 tensor, and the (S,) loss buffer.

`StepLoop` holds one captured step and its cursor and loss buffer. Each
replay runs one step: the body reads row `cursor` of its buffers, runs the
step's kernels and SGD in place on the run's parameters, writes the loss
into `losses[cursor]` and adds 1 to the cursor. Before each epoch the host
loads the epoch's indices and keys into the buffers (`StaticInput`,
non-blocking copies from pinned memory) and zeroes the cursor; after it
the host reads the loss buffer once. One step is captured, not an epoch:
the capture costs one step of host work, no epoch needs a new capture,
and a one-epoch run gains as much as a long one.

The capture (`StepLoop._capture`):
  * warms the body up on a side stream on CLONES of the state, a scratch
    cursor and a scratch loss buffer, so that warm-up trains nothing, and
    so that what a body sets up lazily (the kernel libraries, the
    tensor-map encoder, cuBLAS's handle, autograd's streams) exists before
    the capture;
  * captures the body once under `torch.cuda.set_sync_debug_mode("error")`,
    so a body that would wait for the card (`.item()`, `.cpu()`,
    `torch.tensor(..., device=cuda)`) raises, naming the path, instead of
    invalidating the capture;
  * takes the warm-up's and the capture's own wrapper calls out of
    `ops.fused_step.launch_count` and adds the captured launches on every
    replay, so the counts are those of the eager loop.

On the CPU there is no graph: the same body runs eagerly on the same
buffers, so the CPU tests exercise the plumbing that the card replays. A
card runs it eagerly only where the loop is built with `eager=True`
(train/scan.py `CachedSteps`, train/loop.py `_captured_steps`: what
chip_smoke.py's turns and the card tests build); no entry point, flag or
environment variable selects it. A capture or replay that fails raises,
naming the path, and nothing falls back to an eager loop. Every
reduction keeps its fixed order (the body is the eager step's ops, in its
order), and no atomics are added.

`counts["captures"]` counts this process's captures; chip_smoke.py reads
it (one a run).
"""

from __future__ import annotations

import copy
import warnings
from typing import Callable

import numpy as np
import torch

from ..ops import fused_step
from ..parallel.mesh import WorldMesh

# steps the body runs on clones before its capture
WARMUP_STEPS = 2

# captures in this process (chip_smoke.py reads it)
counts = {"captures": 0}

# the launch counters a captured step adds to on every replay
_COUNTERS = (fused_step.launch_count,)


class StaticInput:
    """A static device buffer of a captured step and its pinned host slot.
    `load(host)` writes a host array or tensor of the buffer's shape into
    it: copied into the pinned slot, then to the device by a non-blocking
    copy on the current stream, behind the steps that read the buffer
    before. The slot is not rewritten before the copy out of it has
    finished (an event the next load waits for)."""

    def __init__(self, shape, dtype: torch.dtype, device):
        self.device = torch.device(device)
        self.buf = torch.zeros(tuple(shape), dtype=dtype, device=self.device)
        self._pinned = None
        self._copied = None
        if self.device.type == "cuda":
            self._pinned = torch.empty(tuple(shape), dtype=dtype,
                                       pin_memory=True)

    def load(self, host) -> None:
        src = torch.as_tensor(np.asarray(host) if not isinstance(
            host, torch.Tensor) else host)
        if tuple(src.shape) != tuple(self.buf.shape):
            raise ValueError(f"a static input of shape {tuple(self.buf.shape)} "
                             f"cannot take {tuple(src.shape)}")
        if self._pinned is None:
            self.buf.copy_(src)
            return
        if self._copied is not None:
            self._copied.synchronize()
        self._pinned.copy_(src)
        self.buf.copy_(self._pinned, non_blocking=True)
        self._copied = torch.cuda.current_stream(self.device).record_event()


def _set_sync_debug_mode(mode) -> None:
    """torch.cuda.set_sync_debug_mode without its warning that the mode is
    a prototype (it is used here only to name a sync inside a capture)."""
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message="Synchronization debug mode")
        torch.cuda.set_sync_debug_mode(mode)


def _restore(saved) -> None:
    for counter, before in zip(_COUNTERS, saved):
        counter.update(before)


class StepLoop:
    """One training step, captured as a CUDA graph on a card and replayed
    once a step, or run eagerly: `body(state, cursor, losses)` runs step
    `cursor` of the epoch on `state` (a params tree or a model, updated in
    place), reading its inputs from static buffers it closes over, writes
    its loss into `losses[cursor]` and adds 1 to `cursor`.

    `start_epoch()` zeroes the cursor; `step()` runs one step (the first
    one on a card captures the body first); `losses()` is a copy of the
    epoch's loss buffer on the device; `epoch()` is the three for the
    loop's `nsteps` steps. `capture` (a card, and not a loop built with
    `eager=True`) selects the graph; `what` names the path in errors."""

    def __init__(self, body: Callable, state, nsteps: int, device, *,
                 capture: bool, what: str):
        self.body, self.state, self.nsteps = body, state, int(nsteps)
        self.device = torch.device(device)
        if capture and self.device.type != "cuda":
            raise ValueError(f"{what}: a CUDA graph needs a CUDA device, "
                             f"not {self.device}")
        self.capture, self.what = capture, what
        self.cursor = torch.zeros((), dtype=torch.int64, device=self.device)
        self._losses = torch.zeros(self.nsteps, dtype=torch.float32,
                                   device=self.device)
        self.graph = None
        self._per_replay = None

    def start_epoch(self) -> None:
        self.cursor.zero_()

    def step(self) -> None:
        if not self.capture:
            self.body(self.state, self.cursor, self._losses)
            return
        if self.graph is None:
            self._capture()
        try:
            self.graph.replay()
        except RuntimeError as e:
            raise RuntimeError(f"{self.what}: replaying the captured step "
                               f"failed: {e}") from e
        for counter, added in zip(_COUNTERS, self._per_replay):
            for k, v in added.items():
                counter[k] += v

    def losses(self) -> torch.Tensor:
        return self._losses.clone()

    def epoch(self) -> torch.Tensor:
        self.start_epoch()
        for _ in range(self.nsteps):
            self.step()
        return self.losses()

    def _capture(self) -> None:
        saved = [dict(c) for c in _COUNTERS]
        current = torch.cuda.current_stream(self.device)
        # warm-up on clones: it trains nothing and leaves the cursor and
        # the losses as they are
        scratch = copy.deepcopy(self.state)
        cursor = torch.zeros_like(self.cursor)
        losses = torch.zeros_like(self._losses)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(current)
        try:
            with torch.cuda.device(self.device), torch.cuda.stream(side):
                for _ in range(WARMUP_STEPS):
                    cursor.zero_()
                    self.body(scratch, cursor, losses)
        except RuntimeError as e:
            raise RuntimeError(f"{self.what}: the step failed in its warm-up "
                               f"before capture: {e}") from e
        current.wait_stream(side)
        del scratch, cursor, losses
        _restore(saved)
        graph = torch.cuda.CUDAGraph()
        mode = torch.cuda.get_sync_debug_mode()
        try:
            with torch.cuda.device(self.device), torch.cuda.graph(graph):
                _set_sync_debug_mode("error")
                try:
                    self.body(self.state, self.cursor, self._losses)
                finally:
                    _set_sync_debug_mode(mode)
        except RuntimeError as e:
            _restore(saved)
            raise RuntimeError(f"{self.what}: capturing the step as a CUDA "
                               f"graph failed: {e}") from e
        self._per_replay = [{k: c[k] - s[k] for k in c if c[k] != s[k]}
                            for c, s in zip(_COUNTERS, saved)]
        _restore(saved)
        self.graph = graph
        counts["captures"] += 1


def on_one_device(mesh, device) -> bool:
    """Whether a loop over `mesh` (None: serial) runs on `device` alone: a
    single-process mesh whose replicas all sit there. A world of processes
    of any size, one rank too, and a mesh across cards keep their eager
    loops: a world's mean is a collective (over gloo through the host, over
    NCCL not captured)."""
    if mesh is None:
        return True
    return not isinstance(mesh, WorldMesh) and all(
        torch.device(d) == device for d in mesh)
