"""Train/eval loop (port of the serial streaming path of
`pytorch_ddp_mnist_tpu/train/loop.py`).

Per epoch, as the reference's `main()` (ddp_tutorial_multi_gpu.py:65-118):
reshuffle through sampler.set_epoch(e), run the train pass, evaluate the
FULL test set with dropout off, and print
`Epoch=e, train_loss=..., val_loss=...` with the reference's units.

The dropout masks follow the JAX trainer's key chain: the train key is
jax's threefry key `--seed + 1` (ops/threefry.py `key_data`), split once
per step (`key, sub = split(key)`, as `make_train_step` does), and the
step's mask is jax's `dropout_mask(sub, B)`, bit for bit. Both steps are
`KeyedStep`s that read `sub` from the epoch's key table on the device: the
`xla` step draws the mask with the mask entry (ops/fused_step.py
`keyed_dropout_mask`: autograd needs the tensor); the `pallas` step draws
it inside K1-split or K1-mma.

JAX runs the streaming step as one `jax.jit` program fed by
`pipeline.feed`; here, on a card, `fit` captures the step as a CUDA
graph and replays it once a batch (train/graphs.py `StepLoop`): the
epoch's key table is loaded into a static buffer before its first step,
each batch is copied by pipeline/prefetch.py `SlotRing` into one of
`prefetch_depth + 1` static batch slots on a side stream while the steps
before run, and the step reads its slot and its key row through a device
cursor. Serial, or
over a single-process mesh of the model's card; a world of processes (one
rank too), a mesh across cards and a step that is not a `KeyedStep` keep
the eager loop, a batch copied to the card a step. `_captured_steps` built
with `eager=True` (chip_smoke.py's turns and the card tests) runs the
captured loop's step eagerly on its buffers.

`--dropout_rng torch` (`make_torch_dropout_train_step`, a `MaskedStep`)
takes the reference's own mask stream instead: torch's CPU `bernoulli_` on
a generator seeded `--seed` (parallel/torch_rng.py), drawn on the host a
batch at a time in step order and handed to the plain autograd step as a
(B, 128) mask. On a card the mask rides with its batch: the ring copies
it into a third set of static slots on the same side stream as the
batch, so the captured step reads the same slot of the masks as of the
rows, and every replay trains on its own batch's mask.

As in the JAX package, the per-step losses stay on the device and are
fetched once per epoch: no per-step `.item()`. The printed train_loss keeps
the reference accumulator quirk Σ(batch_mean / B), and mean loss, accuracy
and throughput ride alongside; `eval_perm` (`--eval_shuffle`) segments the
val loss's batches in a shuffled order, as the reference's shuffled test
loader does.

The batches come through the staged input pipeline (pipeline/, the JAX
`fit`'s `pipeline.feed`): `input_workers` decode threads behind a reorder
buffer (0: synchronous reads) and `prefetch_depth` batches of copy
lookahead. On a card the captured step's batch slots are a ring of
`prefetch_depth + 1` (pipeline/prefetch.py `SlotRing`): step s reads slot
s % (depth + 1). A `MaskedStep`'s masks are drawn on the consumer's side
after the reorder buffer, in step order, so any worker count draws the
same masks. Every configuration trains on the batches of the unpiped
loop, in its order, bit for bit.

A data-parallel step with comm state (`--ddp_comm int8` with error
feedback, parallel/ddp.py) keeps its residual in a device tensor the step
updates in place; the captured loop's warm-up restores it, and the
TrainState carries it out (`resid`).

Resume and step checkpoints (the JAX `fit`'s): `start_epoch` runs the
epochs [start_epoch, epochs) with their own sampler shuffles, and
`start_offset` starts the first of them at batch `start_offset`: the
loader skips at the index level, the captured loop's cursor and the slot
ring start at that step, and the key table holds the steps from there,
split from the restored key (the key after `start_offset` steps, so the
rows are the unbroken epoch's). `step_hook(epoch, offset, global_step,
state)` fires every `ckpt_every_steps` steps of an epoch and at its end
(`step_ckpt_positions`), with the key after that step; each step is the
`step` fault point (utils/faultpoints.py, `kill`), fired after the hook,
and each reported loss the `loss` poison point. `epoch_hook(epoch,
state)` fires after each epoch's line.

In-run telemetry (the JAX `fit`'s): each epoch is an `epoch` span of the
process's tracer (telemetry/events.py; a no-op until `--telemetry`) with
`data_wait`, `step_compute` and `eval` children timed by the loop's own
timers, and a `mem_watermark` point. `watchdog` (telemetry/health.py)
observes once an epoch over the fetched losses; the plain autograd step
built for it (`make_train_step(health=True)`) also writes the health
auxiliary vector of each step into a static (S, 3) buffer beside the
loss buffer (inside the graph on a card), fetched with the losses in the
epoch's one fetch. `journal` (telemetry/cluster.py) records each step's
collectives from the DP step's schedule and brackets the epoch's fetch as
a `flush`; `dispatch_profiler` (telemetry/dispatch.py) times the step
boundary, `dispatch` being the step's launches or `graph.replay()`. None
of them adds a host sync, except the profiler's sampled drain, one every
K steps and never inside a capture.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, List

import numpy as np
import torch

from ..models.mlp import DROPOUT_RATE, MLP, MLP_DIMS, mlp_apply
from ..ops.fused_step import KeyedStep, dropout_mask, keyed_dropout_mask
from ..ops.loss import cross_entropy
from ..ops.sgd import sgd_step
from ..ops import threefry
from ..ops.threefry import keep_from_words
from ..parallel.torch_rng import MaskStream
from ..pipeline import host_iter, prefetch
from ..pipeline.prefetch import SlotRing
from ..telemetry.dispatch import NullProfiler
from ..telemetry.events import get_tracer
from ..telemetry.runtime import record_memory_point
from ..utils import faultpoints
from ..utils.profiling import CumulativeTimer
from . import graphs


@dataclass
class TrainState:
    """The model (its parameters are the trained state; SGD has no other),
    the train key: the (k0, k1) words of the threefry key whose split
    chain keys the dropout masks, and the int8 strategy's error-feedback
    residual (a device tensor, or None)."""
    model: MLP
    key: tuple
    resid: object = None


def keyed_keep(words, batch: int, width: int, device) -> torch.Tensor:
    """The (batch, width) bool keep draw of jax's
    `bernoulli(key, 0.8, (batch, width))` for the key in the table row
    `words`, read from device memory: the mask entry (a kernel) at the
    reference MLP's width 128, plain tensor ops on the device at the zoo's
    other widths."""
    if width == MLP_DIMS[1]:
        return keyed_dropout_mask(words, batch, device) > 0
    return keep_from_words(words.to(device), batch, width)


def xla_loss_and_grads(params, x, y, keep=None, *, dropout_mask=None,
                       apply=mlp_apply):
    """The plain autograd step's (mean loss, grads tree) on a params tree,
    with the forward's dropout from the bool keep draw `keep` (the keyed
    form) or from a streamed {0, 1} `dropout_mask` (the `--dropout_rng
    torch` form). The forward runs in x's dtype; the grads are f32, as the
    params are. `apply` is the model's forward (models/zoo.py)."""
    names = [(n, k) for n, layer in params.items() for k in layer]
    leaves = {n: {k: v.detach().requires_grad_(True) for k, v in layer.items()}
              for n, layer in params.items()}
    with torch.enable_grad():
        loss = cross_entropy(apply(leaves, x, train=True, keep=keep,
                                   dropout_mask=dropout_mask), y)
        flat = torch.autograd.grad(loss, [leaves[n][k] for n, k in names])
    grads = {n: {} for n in params}
    for (n, k), g in zip(names, flat):
        grads[n][k] = g
    return loss.detach(), grads


def make_train_step(lr: float, apply=mlp_apply, *,
                    health: bool = False) -> KeyedStep:
    """The plain autograd step (`--kernel xla`) as a KeyedStep:
    step(model, key, x, y) -> (key', mean loss as a 0-d device tensor). As
    the JAX package's `make_train_step`: `key, sub = split(key)` (the key
    table's row), then the forward's keyed dropout with the keep draw of
    `sub`, drawn by the mask entry reading the row from device memory (the
    fused step's mask, so both steps see the same masks from the same
    key). It trains in f32, as the JAX trainer's streaming `xla` path does
    whatever `--dtype` says. `apply` is a zoo model's forward
    (models/zoo.py); its keep draw has the model's hidden width
    (`keyed_keep`).

    `health=True` (the JAX step's) makes `run` return (loss, aux), aux the
    watchdog's 3-vector `telemetry.health.device_health_aux(loss, grads,
    params after SGD)`, computed on the device from what the step holds;
    the step carries `health_aux = True`. The loss and the update are the
    plain step's, bit for bit."""
    from ..models.zoo import hidden_width
    from ..telemetry.health import device_health_aux

    def run(model, words, x, y):
        params = model.params()
        keep = keyed_keep(words, x.shape[0], hidden_width(params), x.device)
        loss, grads = xla_loss_and_grads(params, x, y, keep, apply=apply)
        sgd_step(params, grads, lr)
        if health:
            return loss, device_health_aux(loss, grads, params)
        return loss

    step = KeyedStep(run)
    step.health_aux = health
    return step


class MaskedStep:
    """A train step of the streaming loop whose dropout masks come from
    the host (`--dropout_rng torch`):

      step.draw(batch) -> the next (batch, 128) float32 {0, 1} mask of the
          stream, drawn in step order;
      step.run(model, mask, x, y) -> loss: one step on a mask on x's
          device, SGD in place on the model's parameters; it reads the
          mask from device memory only, so it can be captured.

    `fit` runs it serially through the captured loop's slots; the train
    key passes through untouched (the TrainState keeps its form)."""

    def __init__(self, run, stream: MaskStream):
        self.run = run
        self.stream = stream

    def draw(self, batch: int) -> np.ndarray:
        hidden = MLP_DIMS[1]
        return self.stream.draw(batch * hidden, 1.0 - DROPOUT_RATE).reshape(
            batch, hidden)

    def with_masks(self, batches):
        """(x, y) host batches -> (x, y, mask), one draw a batch in order."""
        for x, y in batches:
            yield x, y, self.draw(len(x))


def make_torch_dropout_train_step(lr: float, seed: int, *,
                                  skip_steps: int = 0,
                                  batch_size: int | None = None) -> MaskedStep:
    """The `--dropout_rng torch` step (the JAX package's
    `make_torch_dropout_train_step`): the plain autograd step in f32 whose
    masks stream from torch's CPU `bernoulli_(0.8)` on a generator seeded
    `seed` (the nn.Dropout draw of ddp_tutorial_cpu.py:47), drawn on the
    host a step at a time. With `--sampler_rng torch` the serial run's
    shards, masks and SGD are a live torch run's that reseeds its global
    generator with `seed` after the model's init. `skip_steps` positions
    the stream for a resumed run: every step draws `batch_size` x 128
    masks (the loaders pad every batch to full size), so the stream skips
    that many values a step done."""
    def run(model, mask, x, y):
        params = model.params()
        loss, grads = xla_loss_and_grads(params, x, y, dropout_mask=mask)
        sgd_step(params, grads, lr)
        return loss

    stream = MaskStream(seed)
    if skip_steps:
        if batch_size is None:
            raise ValueError("skip_steps needs batch_size (the rows of a "
                             "step's mask)")
        stream.skip(int(skip_steps) * int(batch_size) * MLP_DIMS[1])
    return MaskedStep(run, stream)


def step_ckpt_positions(nsteps: int, epoch: int, i: int) -> tuple:
    """The sampler position a step checkpoint records after step `i`
    (0-based) of an epoch of `nsteps` steps: (epoch, i + 1), except that
    the epoch's last step gives (epoch + 1, 0): the state after it is the
    state the next epoch starts from, so a resume never replays an empty
    tail. The streaming and resident-dataset trainers share it."""
    if i + 1 >= nsteps:
        return epoch + 1, 0
    return epoch, i + 1


def _fire_step_hook(step_hook, every: int, nsteps: int, epoch: int, i: int,
                    state) -> None:
    """`step_hook(epoch', offset', global_step, state)` when step `i` of
    the epoch lands on the cadence: (i + 1) a multiple of `every`, or the
    epoch's last step. The cadence is epoch-local, so both trainers save
    at the same global steps for any nsteps and every."""
    if step_hook is None or not every:
        return
    if (i + 1) % every == 0 or i + 1 >= nsteps:
        ep, off = step_ckpt_positions(nsteps, epoch, i)
        step_hook(ep, off, epoch * nsteps + i + 1, state)


def key_chain(key, n: int) -> list:
    """The train key after each of `n` steps from `key` (`key, sub =
    split(key)` a step): the key a step checkpoint records."""
    out = []
    for _ in range(n):
        key = threefry.split(key)[0]
        out.append(key)
    return out


def poison_losses(losses: np.ndarray, first_step: int,
                  epoch: int) -> np.ndarray:
    """The `loss` poison point over fetched per-step losses, a step at a
    time (`values[j]` is global step first_step + j): what a `nan` spec
    does to the JAX streaming loop's reported loss of each step."""
    if not faultpoints.active():
        return losses
    losses = np.array(losses, copy=True)
    for j in range(losses.size):
        losses[j] = faultpoints.poison("loss", losses[j],
                                       step=first_step + j, epoch=epoch)
    return losses


@torch.no_grad()
def eval_math(model: MLP, x: torch.Tensor, y: torch.Tensor):
    """Per-sample test-set forward with dropout off: (model, x (n, 784),
    y (n,)) -> (per_sample_loss, correct), both (n,) float32 on x's device.
    The counterpart of the JAX package's `_eval_math`."""
    logits = model(x, train=False)
    logz = torch.log_softmax(logits.float(), dim=-1)
    per_sample = -torch.gather(logz, -1, y.long()[:, None])[:, 0]
    correct = (torch.argmax(logits, dim=-1) == y.long()).float()
    return per_sample, correct


def make_snapshot_eval_step() -> Callable:
    """Eval over STACKED per-epoch params snapshots, for the fused
    resident-dataset run's per-epoch val lines (the JAX package's
    `make_snapshot_eval_step`): (p_snaps with an (E, ...) leading axis on
    every leaf, x (n, 784), y (n,)) -> (per_sample (E, n), correct (E, n)),
    float32 on x's device. The epoch axis is a batch dimension of the
    products, so all E evals are one chain of batched matmuls and one
    fetch."""
    @torch.no_grad()
    def step(p_snaps, x, y):
        fc1, fc2, fc3 = p_snaps["fc1"], p_snaps["fc2"], p_snaps["fc3"]
        h = torch.relu(x @ fc1["w"] + fc1["b"][:, None, :])
        h = torch.relu(h @ fc2["w"] + fc2["b"][:, None, :])
        logits = h @ fc3["w"]
        logz = torch.log_softmax(logits.float(), dim=-1)
        labels = y.long()
        idx = labels[None, :, None].expand(logz.shape[0], -1, 1)
        per_sample = -torch.gather(logz, -1, idx)[..., 0]
        correct = (torch.argmax(logits, dim=-1) == labels).float()
        return per_sample, correct

    return step


def evaluate(model: MLP, x_test: torch.Tensor, y_test: torch.Tensor,
             batch_size: int, perm=None):
    """Full-test-set eval in one forward, one fetch: (val_loss_ref_unit,
    mean_loss, acc), see val_summary."""
    per_sample, correct = eval_math(model, x_test, y_test)
    return val_summary(per_sample.cpu().numpy(), correct.cpu().numpy(),
                       batch_size, perm=perm)


def val_summary(per_sample: np.ndarray, correct: np.ndarray,
                batch_size: int, perm=None):
    """Fetched per-sample eval values -> (val_loss_ref_unit, mean_loss,
    acc). The ref unit replicates the reference accumulator Σ(batch_mean/B)
    over the test batches, including the short last batch: sequential, or
    in the order `perm` (`--eval_shuffle`: the per-sample losses are
    permuted before they are segmented; accuracy is order-free, so
    `correct` is not)."""
    n = per_sample.shape[0]
    per_sample = np.asarray(per_sample, np.float64)
    if perm is not None:
        per_sample = per_sample[np.asarray(perm)]
    val_loss_ref_unit = 0.0
    for start in range(0, n, batch_size):
        b = min(batch_size, n - start)
        val_loss_ref_unit += per_sample[start:start + b].mean() / b
    return (float(val_loss_ref_unit), float(per_sample.mean()),
            float(np.asarray(correct).mean()))


def epoch_summary(epoch: int, losses: np.ndarray, batch_size: int,
                  val: tuple, dt: float,
                  io_seconds: float | None = None) -> str:
    """The reference epoch line (ddp_tutorial_multi_gpu.py:116) + the JAX
    package's extensions, character for character. `losses` are the
    epoch's per-batch mean losses (float32); train_loss keeps the reference
    unit Σ(batch_mean/B)."""
    val_ref_unit, val_mean, val_acc = val
    train_loss_ref_unit = float((losses / batch_size).sum())
    imgs = losses.size * batch_size
    io = (f" io={io_seconds:.2f}s/{100 * io_seconds / dt:.0f}%"
          if io_seconds is not None else "")
    return (f"Epoch={epoch}, train_loss={train_loss_ref_unit}, "
            f"val_loss={val_ref_unit}"
            f"  [mean_train={float(losses.mean()):.4f} "
            f"mean_val={val_mean:.4f} "
            f"acc={val_acc:.4f} {imgs / dt:.0f} img/s{io}]")


def _to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    t = torch.from_numpy(a)
    if device.type == "cuda":
        # pinned + non_blocking: the copy queues behind the running step
        # instead of making the host wait for it
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def _captured_steps(step, model: MLP, nsteps: int, batch: int, device,
                    eager: bool = False, ring: int = 2):
    """The streaming loop's step (a KeyedStep or a MaskedStep) as a
    train/graphs.py StepLoop: its static buffers are `ring` batch slots (x
    (ring, B, 784) f32, y (ring, B) int32; step s reads slot s % ring,
    which pipeline/prefetch.py `SlotRing` fills, `ring` = the prefetch
    depth + 1) and the epoch's key table, or, for a MaskedStep, `ring`
    mask slots (ring, B, 128) f32 filled with the batch. A step with comm
    state (parallel/ddp.py) has its residual restored after the capture's
    warm-up. A step with `health_aux` writes its aux vector into row s of
    the loop's `aux` buffer (S, 3) f32 (None otherwise). `eager` runs the
    step without a graph on a card. Returns (the loop, its slots, its key
    table's StaticInput or None)."""
    x_slots = torch.zeros((ring, batch, MLP_DIMS[0]), dtype=torch.float32,
                          device=device)
    y_slots = torch.zeros((ring, batch), dtype=torch.int32, device=device)
    if isinstance(step, MaskedStep):
        m_slots = torch.zeros((ring, batch, MLP_DIMS[1]), dtype=torch.float32,
                              device=device)
        slots, keys = (x_slots, y_slots, m_slots), None

        def inputs(at, slot):
            return m_slots.index_select(0, slot)[0]
    else:
        fold = step.fold
        keys = graphs.StaticInput(
            (nsteps, 2) if fold is None else (nsteps, len(fold), 2),
            torch.int32, device)
        table = keys.buf
        slots = (x_slots, y_slots)

        def inputs(at, slot):
            return table.index_select(0, at)[0]

    aux = (torch.zeros((nsteps, 3), dtype=torch.float32, device=device)
           if getattr(step, "health_aux", False) else None)

    def body(model, cursor, losses):
        at = cursor.view(1)
        slot = torch.remainder(at, ring)
        loss = step.run(model, inputs(at, slot),
                        x_slots.index_select(0, slot)[0],
                        y_slots.index_select(0, slot)[0])
        if aux is not None:
            loss, row = loss
            aux.index_copy_(0, at, row.reshape(1, 3))
        losses.index_copy_(0, at, loss.reshape(1))
        cursor.add_(1)

    comm = getattr(step, "comm", None)
    loop = graphs.StepLoop(body, model, nsteps, device,
                           capture=device.type == "cuda" and not eager,
                           what="the streaming step",
                           preserve=comm.state_tensors() if comm else ())
    loop.aux = aux
    return loop, slots, keys


def fit(state: TrainState, train_loader, x_test: np.ndarray,
        y_test: np.ndarray, *, epochs: int, batch_size: int,
        lr: float | None = None, train_step: Callable | None = None,
        eval_perm: Callable | None = None, input_workers: int = 0,
        prefetch_depth: int = 1, model_apply: Callable | None = None,
        registry=None, start_epoch: int = 0, start_offset: int = 0,
        ckpt_every_steps: int = 0, step_hook: Callable | None = None,
        epoch_hook: Callable | None = None, watchdog=None, journal=None,
        dispatch_profiler=None, log: Callable[[str], None] = print):
    """Run the reference training loop for epochs [start_epoch, epochs) on
    the model's device. Exactly one of `lr` (builds the plain autograd
    step) or `train_step` (e.g. ops.fused_step.make_fused_train_step) is
    given. Returns (state with the advanced key, per-epoch arrays of the
    per-step losses). In a world of processes the train step's loss is the
    world's mean, so every rank computes the same line; the CLI passes a
    `log` that prints on rank 0 only. A `KeyedStep` or `MaskedStep` on one
    device runs captured on a card (see the module docstring).
    `eval_perm(epoch)`, when given, is the order of the epoch's val-loss
    segmentation (`--eval_shuffle`). `input_workers` and `prefetch_depth`
    are the input pipeline's (see the module docstring): the same batches
    in the same order at any setting. `model_apply` is a zoo model's
    forward for the `lr` step (models/zoo.py). The pipeline's `data.*`
    metrics go to `registry` (default: the process's,
    telemetry/registry.py). `start_epoch`, `start_offset`,
    `ckpt_every_steps`, `step_hook` and `epoch_hook` resume a run and
    checkpoint it (see the module docstring): with the state saved after
    `start_offset` steps of epoch `start_epoch`, the run from there is the
    unbroken run's, bit for bit; the resumed epoch's line covers its
    remaining steps.

    `watchdog` (telemetry.health.Watchdog) observes once an epoch, after
    its line, over the fetched losses, the epoch's wall time and, on the
    `lr` path (whose step this loop then builds with `health=True`), the
    steps' aux vectors; it may raise TrainingHealthError (`--health
    abort`). `journal` (telemetry.cluster.CollectiveJournal) needs a step
    that declares its `collective_schedule` (the DP step does; any other
    is refused by name). `dispatch_profiler` (telemetry.dispatch) defaults
    to the no-op NullProfiler."""
    if (train_step is None) == (lr is None):
        raise ValueError("pass exactly one of lr= or train_step=")
    if input_workers < 0:
        raise ValueError(f"input_workers must be >= 0; got {input_workers}")
    if prefetch_depth < 1:
        raise ValueError(f"prefetch_depth must be >= 1; got {prefetch_depth}")
    if not 0 <= start_epoch <= epochs:
        raise ValueError(f"start_epoch={start_epoch} outside [0, {epochs}]")
    if start_offset < 0:
        raise ValueError(f"start_offset={start_offset} must be >= 0")
    step = (train_step if train_step is not None else
            make_train_step(lr, model_apply or mlp_apply,
                            health=watchdog is not None))
    step_health = bool(getattr(step, "health_aux", False))
    model, key = state.model, state.key
    device = next(model.parameters()).device
    comm, record = getattr(step, "comm", None), None
    if comm is not None:
        from ..parallel.ddp import make_ddp_comm_recorder
        comm.place_state(model.params(), state.resid)
        record = make_ddp_comm_recorder(step.ddp_mesh, comm, model.params())
    if journal is not None:
        schedule = getattr(step, "collective_schedule", None)
        if schedule is None:
            raise ValueError(
                "journal= needs a train step that declares its collective "
                "schedule (parallel.ddp.make_dp_train_step does); this "
                "step carries none — the journal cannot attribute "
                "collectives it cannot enumerate")
        journal.bind_program(getattr(step, "ddp_comm", "?"),
                             bool(getattr(step, "ddp_overlap", False)),
                             schedule(model.params()))
    tracer = get_tracer()     # a NullTracer unless --telemetry enabled it
    prof = (dispatch_profiler if dispatch_profiler is not None
            else NullProfiler())
    # the tensors every step writes in place: the profiler's sampled drain
    # waits for their devices
    live = model.params()
    keyed = isinstance(step, KeyedStep)
    masked = isinstance(step, MaskedStep)
    nsteps = len(train_loader)
    if start_epoch < epochs and start_offset >= nsteps:
        raise ValueError(f"start_offset={start_offset} >= the epoch's "
                         f"{nsteps} steps (a committed step checkpoint never "
                         f"records a full-epoch offset)")
    # a MaskedStep is serial, so always on one device
    captured = masked or (keyed and graphs.on_one_device(
        getattr(step, "ddp_mesh", None), device))
    if captured:
        loop, slots, keys = _captured_steps(step, model, nsteps,
                                            train_loader.batch_size, device,
                                            ring=prefetch_depth + 1)
        ring = SlotRing(slots)
    # the test set goes to the device once, not once per epoch
    x_test_dev = torch.as_tensor(x_test, device=device)
    y_test_dev = torch.as_tensor(y_test, device=device)
    history: List[np.ndarray] = []
    hooked = step_hook is not None and ckpt_every_steps
    for epoch in range(start_epoch, epochs):
        with tracer.span("epoch", epoch=epoch):
            t0 = time.perf_counter()
            io_timer = CumulativeTimer("loader-wait")
            step_timer = CumulativeTimer("step-dispatch")
            offset = start_offset if epoch == start_epoch else 0
            train_loader.sampler.set_epoch(epoch)
            batches = host_iter(train_loader, workers=input_workers,
                                start=offset, registry=registry)
            if masked:   # each batch with its mask, drawn in step order
                batches = step.with_masks(batches)
            chain = None
            if keyed and hooked:    # the key after each step, for the saves
                chain = key_chain(key, nsteps - offset)
            if keyed and captured:   # rows offset.. of the epoch's table
                epoch_key, words = step.key_words(key, nsteps, start=offset)
                keys.load(words)
            elif keyed:   # the epoch's step keys on the device, one copy
                epoch_key, table = step.key_table(key, nsteps, device,
                                                  start=offset)
            if captured:
                loop.start_epoch(offset)
                batches = ring.feed(batches, prefetch_depth, start=offset)
            else:
                batches = prefetch(batches, depth=prefetch_depth,
                                   device=device)
            losses, aux, i = [], [], offset
            while True:
                with io_timer:   # host time blocked on the input pipeline
                    batch = next(batches, None)
                if batch is None:
                    break
                if not captured:
                    x, y = batch
                if i == nsteps:
                    raise RuntimeError(f"the loader gave more than the "
                                       f"{nsteps} batches its len() said")
                # python_prestep opens here: the batch is in hand
                prof.mark_prestep()
                jt0, jt0w = ((time.perf_counter(), time.time())
                             if journal is not None else (0.0, 0.0))
                prof.begin_dispatch(live)
                with step_timer:
                    if captured:
                        loop.step()
                    elif keyed:
                        loss = step.run(model, table[i], x, y)
                        if step_health:
                            loss, row = loss
                            aux.append(row)
                        losses.append(loss)
                    else:
                        key, loss = step(model, key, x, y)
                        losses.append(loss)
                prof.end_dispatch(epoch * nsteps + i)
                if journal is not None:
                    journal.record_step(epoch * nsteps + i, jt0,
                                        time.perf_counter(), jt0w)
                if hooked:
                    _fire_step_hook(step_hook, ckpt_every_steps, nsteps,
                                    epoch, i, TrainState(
                                        model,
                                        chain[i - offset] if chain else key,
                                        comm.resid if comm else None))
                # after the hook: a kill at step K never races step K's save
                faultpoints.fire("step", step=epoch * nsteps + i + 1,
                                 epoch=epoch)
                i += 1
            if i != nsteps:
                raise RuntimeError(f"the loader gave {i - offset} batches "
                                   f"from batch {offset} where its len() "
                                   f"said {nsteps}")
            if keyed:
                key = epoch_key
            # the epoch's one fetch, the aux rows riding in it; the journal
            # brackets it: it waits for every step's collectives
            t_fetch = time.perf_counter()
            fseq = (journal.enter("flush", axis="dp", steps=i - offset)
                    if journal is not None else -1)
            if captured:
                dev = loop.losses()[offset:]
                aux = loop.aux[offset:] if loop.aux is not None else None
            else:
                dev = torch.stack(losses)
                aux = torch.stack(aux) if aux else None
            if aux is not None:
                both = torch.cat([dev.reshape(-1, 1), aux], 1).cpu().numpy()
                losses, aux = both[:, 0].copy(), both[:, 1:]
            else:
                losses = dev.cpu().numpy()
            if journal is not None:
                journal.exit(fseq)
            fetch_s = time.perf_counter() - t_fetch
            prof.note_sync_wait(fetch_s)
            losses = poison_losses(losses, epoch * nsteps + offset + 1,
                                   epoch)
            tracer.complete_span("data_wait", io_timer.total,
                                 batches=step_timer.count)
            tracer.complete_span("step_compute", step_timer.total + fetch_s,
                                 steps=step_timer.count, fetch_s=fetch_s)
            prof.flush_epoch(epoch, steps=step_timer.count,
                             step_total_s=step_timer.total)
            if record is not None:
                record(losses.size, model.params())
            t_eval = time.perf_counter()
            val = evaluate(model, x_test_dev, y_test_dev, batch_size,
                           perm=eval_perm(epoch) if eval_perm else None)
            tracer.complete_span("eval", time.perf_counter() - t_eval)
            record_memory_point(tracer)
            dt = time.perf_counter() - t0
            log(epoch_summary(epoch, losses, batch_size, val, dt,
                              io_seconds=io_timer.total))
            history.append(losses)
            now = TrainState(model, key, comm.resid if comm else None)
            if watchdog is not None:
                watchdog.observe(losses, aux=aux, state=now, epoch=epoch,
                                 step=(epoch + 1) * nsteps,
                                 ckpt_epoch=epoch + 1, ckpt_offset=0,
                                 dt_s=dt, imgs=losses.size * batch_size)
            if epoch_hook is not None:
                epoch_hook(epoch, now)
    return TrainState(model, key, comm.resid if comm else None), history
