"""Train/eval loop (port of the serial streaming path of
`pytorch_ddp_mnist_tpu/train/loop.py`).

Per epoch, as the reference's `main()` (ddp_tutorial_multi_gpu.py:65-118):
reshuffle through sampler.set_epoch(e), run the train pass, evaluate the
FULL test set with dropout off, and print
`Epoch=e, train_loss=..., val_loss=...` with the reference's units.

The dropout masks follow the JAX trainer's key chain: the train key is
jax's threefry key `--seed + 1` (ops/threefry.py `key_data`), split once
per step (`key, sub = split(key)`, as `make_train_step` does), and the
step's mask is jax's `dropout_mask(sub, B)`, bit for bit. The `xla` step
draws it with the mask entry (ops/fused_step.py `dropout_mask`: autograd
needs the tensor); the `pallas` step (a `KeyedStep`) draws it inside
K1-split or K1-mma, from the epoch's key table, which `fit` builds on the
host before the epoch's first step and copies to the device once.

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

from ..models.mlp import MLP, mlp_apply
from ..ops import threefry
from ..ops.fused_step import KeyedStep, dropout_mask
from ..ops.loss import cross_entropy
from ..ops.sgd import sgd_step


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


def make_train_step(lr: float) -> Callable:
    """The plain autograd step (`--kernel xla`): step(model, key, x, y) ->
    (key', mean loss as a 0-d device tensor). As the JAX package's
    `make_train_step`: `key, sub = split(key)`, then the forward's keyed
    dropout with the keep draw of `sub` (the fused step's mask, so both
    steps see the same masks from the same key). It trains in f32, as the
    JAX trainer's streaming `xla` path does whatever `--dtype` says."""
    def step(model, key, x, y):
        key, sub = threefry.split(key)
        keep = dropout_mask(sub, x.shape[0], x.device) > 0
        params = model.params()
        loss, grads = xla_loss_and_grads(params, x, y, keep)
        sgd_step(params, grads, lr)
        return key, loss

    return step


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
    that prints on rank 0 only."""
    if (train_step is None) == (lr is None):
        raise ValueError("pass exactly one of lr= or train_step=")
    step = train_step if train_step is not None else make_train_step(lr)
    keyed = isinstance(step, KeyedStep)
    model, key = state.model, state.key
    device = next(model.parameters()).device
    # the test set goes to the device once, not once per epoch
    x_test_dev = torch.as_tensor(x_test, device=device)
    y_test_dev = torch.as_tensor(y_test, device=device)
    history: List[np.ndarray] = []
    for epoch in range(epochs):
        t0 = time.perf_counter()
        io_seconds = 0.0
        train_loader.sampler.set_epoch(epoch)
        if keyed:   # the epoch's step keys on the device, one copy
            nsteps = len(train_loader)
            epoch_key, table = step.key_table(key, nsteps, device)
        losses = []
        batches = iter(train_loader)
        while True:
            t_io = time.perf_counter()
            batch = next(batches, None)
            if batch is not None:
                x, y = (_to_device(a, device) for a in batch)
            io_seconds += time.perf_counter() - t_io
            if batch is None:
                break
            if keyed:
                loss = step.run(model, table[len(losses)], x, y)
            else:
                key, loss = step(model, key, x, y)
            losses.append(loss)
        if keyed:
            if len(losses) != nsteps:
                raise RuntimeError(f"the loader gave {len(losses)} batches "
                                   f"where its len() said {nsteps}")
            key = epoch_key
        losses = torch.stack(losses).cpu().numpy()  # the epoch's one fetch
        val = evaluate(model, x_test_dev, y_test_dev, batch_size)
        dt = time.perf_counter() - t0
        log(epoch_summary(epoch, losses, batch_size, val, dt,
                          io_seconds=io_seconds))
        history.append(losses)
    return TrainState(model, key), history
