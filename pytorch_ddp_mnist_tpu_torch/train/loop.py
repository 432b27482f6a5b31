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
`device_prefetch`; here, on a card, `fit` captures the step as a CUDA
graph and replays it once a batch (train/graphs.py `StepLoop`): the
epoch's key table is loaded into a static buffer before its first step,
each batch is copied by data/loader.py `device_prefetch` into one of two
static batch slots on a side stream while the step before runs, and the
step reads its slot and its key row through a device cursor. Serial, or
over a single-process mesh of the model's card; a world of processes (one
rank too), a mesh across cards and a step that is not a `KeyedStep` keep
the eager loop, a batch copied to the card a step. `_captured_steps` built
with `eager=True` (chip_smoke.py's turns and the card tests) runs the
captured loop's step eagerly on its buffers.

As in the JAX package, the per-step losses stay on the device and are
fetched once per epoch: no per-step `.item()`. The printed train_loss keeps
the reference accumulator quirk Σ(batch_mean / B), and mean loss, accuracy
and throughput ride alongside. Telemetry, the input pipeline's workers,
fault points, the collective journal, the health watchdog and mid-epoch
resume are not ported yet (ROADMAP.md queue 1).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, List

import numpy as np
import torch

from ..data.loader import device_prefetch
from ..models.mlp import MLP, MLP_DIMS, mlp_apply
from ..ops.fused_step import KeyedStep, dropout_mask, keyed_dropout_mask
from ..ops.loss import cross_entropy
from ..ops.sgd import sgd_step
from . import graphs


@dataclass
class TrainState:
    """The model (its parameters are the trained state; SGD has no other)
    and the train key: the (k0, k1) words of the threefry key whose split
    chain keys the dropout masks."""
    model: MLP
    key: tuple


def xla_loss_and_grads(params, x, y, keep):
    """The plain autograd step's (mean loss, grads tree) on a params tree,
    with the forward's keyed dropout from the bool keep draw `keep`. The
    forward runs in x's dtype; the grads are f32, as the params are."""
    names = [(n, k) for n, layer in params.items() for k in layer]
    leaves = {n: {k: v.detach().requires_grad_(True) for k, v in layer.items()}
              for n, layer in params.items()}
    with torch.enable_grad():
        loss = cross_entropy(mlp_apply(leaves, x, train=True, keep=keep), y)
        flat = torch.autograd.grad(loss, [leaves[n][k] for n, k in names])
    grads = {n: {} for n in params}
    for (n, k), g in zip(names, flat):
        grads[n][k] = g
    return loss.detach(), grads


def make_train_step(lr: float) -> KeyedStep:
    """The plain autograd step (`--kernel xla`) as a KeyedStep:
    step(model, key, x, y) -> (key', mean loss as a 0-d device tensor). As
    the JAX package's `make_train_step`: `key, sub = split(key)` (the key
    table's row), then the forward's keyed dropout with the keep draw of
    `sub`, drawn by the mask entry reading the row from device memory (the
    fused step's mask, so both steps see the same masks from the same
    key). It trains in f32, as the JAX trainer's streaming `xla` path does
    whatever `--dtype` says."""
    def run(model, words, x, y):
        keep = keyed_dropout_mask(words, x.shape[0], x.device) > 0
        params = model.params()
        loss, grads = xla_loss_and_grads(params, x, y, keep)
        sgd_step(params, grads, lr)
        return loss

    return KeyedStep(run)


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
             batch_size: int):
    """Full-test-set eval in one forward, one fetch: (val_loss_ref_unit,
    mean_loss, acc), see val_summary."""
    per_sample, correct = eval_math(model, x_test, y_test)
    return val_summary(per_sample.cpu().numpy(), correct.cpu().numpy(),
                       batch_size)


def val_summary(per_sample: np.ndarray, correct: np.ndarray,
                batch_size: int):
    """Fetched per-sample eval values -> (val_loss_ref_unit, mean_loss,
    acc). The ref unit replicates the reference accumulator Σ(batch_mean/B)
    over sequential test batches, including the short last batch."""
    n = per_sample.shape[0]
    per_sample = np.asarray(per_sample, np.float64)
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


def _captured_steps(step: KeyedStep, model: MLP, nsteps: int, batch: int,
                    device, eager: bool = False):
    """The streaming loop's step as a train/graphs.py StepLoop: its static
    buffers are two batch slots (x (2, B, 784) f32, y (2, B) int32; step s
    reads slot s % 2, which `device_prefetch` fills) and the epoch's key
    table. `eager` runs the step without a graph on a card. Returns (the
    loop, its slots, its key table's StaticInput)."""
    x_slots = torch.zeros((2, batch, MLP_DIMS[0]), dtype=torch.float32,
                          device=device)
    y_slots = torch.zeros((2, batch), dtype=torch.int32, device=device)
    fold = step.fold
    keys = graphs.StaticInput(
        (nsteps, 2) if fold is None else (nsteps, len(fold), 2), torch.int32,
        device)
    table = keys.buf

    def body(model, cursor, losses):
        at = cursor.view(1)
        slot = torch.remainder(at, 2)
        loss = step.run(model, table.index_select(0, at)[0],
                        x_slots.index_select(0, slot)[0],
                        y_slots.index_select(0, slot)[0])
        losses.index_copy_(0, at, loss.reshape(1))
        cursor.add_(1)

    loop = graphs.StepLoop(body, model, nsteps, device,
                           capture=device.type == "cuda" and not eager,
                           what="the streaming step")
    return loop, (x_slots, y_slots), keys


def fit(state: TrainState, train_loader, x_test: np.ndarray,
        y_test: np.ndarray, *, epochs: int, batch_size: int,
        lr: float | None = None, train_step: Callable | None = None,
        log: Callable[[str], None] = print):
    """Run the reference training loop for `epochs` epochs on the model's
    device. Exactly one of `lr` (builds the plain autograd step) or
    `train_step` (e.g. ops.fused_step.make_fused_train_step) is given.
    Returns (state with the advanced key, per-epoch arrays of the per-step
    losses). In a world of processes the train step's loss is the world's
    mean, so every rank computes the same line; the CLI passes a `log`
    that prints on rank 0 only. A `KeyedStep` on one device runs captured
    on a card (see the module docstring)."""
    if (train_step is None) == (lr is None):
        raise ValueError("pass exactly one of lr= or train_step=")
    step = train_step if train_step is not None else make_train_step(lr)
    model, key = state.model, state.key
    device = next(model.parameters()).device
    keyed = isinstance(step, KeyedStep)
    nsteps = len(train_loader) if keyed else None
    captured = keyed and graphs.on_one_device(getattr(step, "ddp_mesh", None),
                                              device)
    if captured:
        loop, slots, keys = _captured_steps(step, model, nsteps,
                                            train_loader.batch_size, device)
        pinned = (tuple(torch.empty(s.shape, dtype=s.dtype, pin_memory=True)
                        for s in slots) if device.type == "cuda" else None)
    # the test set goes to the device once, not once per epoch
    x_test_dev = torch.as_tensor(x_test, device=device)
    y_test_dev = torch.as_tensor(y_test, device=device)
    history: List[np.ndarray] = []
    for epoch in range(epochs):
        t0 = time.perf_counter()
        io_seconds = 0.0
        train_loader.sampler.set_epoch(epoch)
        if captured:
            epoch_key, words = step.key_words(key, nsteps)
            keys.load(words)
            loop.start_epoch()
            batches = device_prefetch(iter(train_loader), slots, pinned)
        else:
            if keyed:   # the epoch's step keys on the device, one copy
                epoch_key, table = step.key_table(key, nsteps, device)
            batches = iter(train_loader)
        losses, taken = [], 0
        while True:
            t_io = time.perf_counter()
            batch = next(batches, None)
            if batch is not None and not captured:
                x, y = (_to_device(a, device) for a in batch)
            io_seconds += time.perf_counter() - t_io
            if batch is None:
                break
            if keyed and taken == nsteps:
                raise RuntimeError(f"the loader gave more than the {nsteps} "
                                   f"batches its len() said")
            if captured:
                loop.step()
            elif keyed:
                losses.append(step.run(model, table[taken], x, y))
            else:
                key, loss = step(model, key, x, y)
                losses.append(loss)
            taken += 1
        if keyed:
            if taken != nsteps:
                raise RuntimeError(f"the loader gave {taken} batches where "
                                   f"its len() said {nsteps}")
            key = epoch_key
        # the epoch's one fetch
        losses = (loop.losses() if captured else torch.stack(losses)) \
            .cpu().numpy()
        val = evaluate(model, x_test_dev, y_test_dev, batch_size)
        dt = time.perf_counter() - t0
        log(epoch_summary(epoch, losses, batch_size, val, dt,
                          io_seconds=io_seconds))
        history.append(losses)
    return TrainState(model, key), history
