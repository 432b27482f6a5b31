"""Resident-dataset training: the dataset lives on the device, epochs run
with no host round trip per step (port of the serial parts of
`pytorch_ddp_mnist_tpu/train/scan.py`).

The host computes each epoch's batch INDICES from the sampler (bitwise the
JAX package's), the raw uint8 pixels sit on the device (`resident_images`,
~47 MB for MNIST) and are gathered and normalised there. Per kernel:

  * `pallas_epoch`: one whole-epoch kernel call per epoch
    (ops/epoch_step.py, K2). The key chain is JAX's: one
    `key, sub = split(key)` per epoch, then `split(sub, nsteps)` gives the
    per-step keys. Under `impl="threefry2x32"` their words go to the kernel,
    which draws jax's exact masks (K3); under `impl="rbg"` word 0 of `sub`
    seeds the kernel's Philox stream (K2c), as word 0 of the rbg key seeds
    the TPU core PRNG in the JAX package. `superstep` K runs K steps per
    kernel iteration (the same bits); a ragged epoch is padded at the index
    level and the kernel skips the padded steps.
  * `xla` / `pallas` / `pallas_rng`: a host loop of per-step calls on data
    already on the device, with no per-step sync: `key, sub = split(key)`
    per step. `xla` and `pallas` draw the mask `dropout_mask(sub)` (bitwise
    JAX's, on the card by the K3 device function); `xla` is the autograd
    step with the forward's keyed dropout, `pallas` the fused step (K1).
    `pallas_rng` hands word 0 of `sub` to the fused step as its seed and the
    kernel draws the mask itself (K1-rng), as JAX's `_loss_and_grads` does.
    JAX runs these steps as one `lax.scan`; capturing them in a CUDA graph
    is queued in ROADMAP.md.

`dtype="bfloat16"` is JAX's recipe: the gathered batch is cast to bf16;
`xla` then runs the whole forward and backward in bf16 (the params cast to
it, f32 grads), and the kernels run their bf16-operand modes (K1-bf16,
K2-bf16) with f32 master weights.

Keys are `(k0, k1)` tuples of the threefry key words (ops/threefry.py).
The per-step losses stay on the device and are fetched once per epoch
(once per run with `fused=True`), so `fit_cached` prints the reference
epoch line as `fit` does.
"""

from __future__ import annotations

import time
from typing import Callable, List

import numpy as np
import torch

from ..data.loader import _batched_indices
from ..data.mnist import device_normalize
from ..models.mlp import MLP
from ..ops import threefry
from ..ops.epoch_step import epoch_fused_sgd
from ..ops.fused_step import (dropout_mask, fused_loss_and_grads,
                              fused_loss_and_grads_rng)
from ..ops.sgd import sgd_step
from .loop import (_to_device, epoch_summary, evaluate,
                   make_snapshot_eval_step, val_summary, xla_loss_and_grads)

__all__ = ["device_normalize", "resident_images", "epoch_batch_indices",
           "check_run_args", "make_run_fn", "make_epoch_fn", "fit_cached"]

KERNELS = ("xla", "pallas", "pallas_rng", "pallas_epoch")
DTYPES = ("float32", "bfloat16")
IMPLS = ("threefry2x32", "rbg")


def _compute_dtype(dtype: str) -> torch.dtype:
    return torch.bfloat16 if dtype == "bfloat16" else torch.float32


def _gathered_x(x_all: torch.Tensor, batch_idx: torch.Tensor,
                compute_dt: torch.dtype = torch.float32) -> torch.Tensor:
    """Gather a batch from the resident dataset, normalising on the device
    (in f32) when the dataset is uint8-resident, then cast to the compute
    dtype. Returns (B, 784)."""
    x = x_all.index_select(0, batch_idx)
    if x.dtype == torch.uint8:
        x = device_normalize(x)
    return x.to(torch.float32).to(compute_dt)


def resident_images(images: np.ndarray) -> np.ndarray:
    """Host-side prep of the device-resident dataset: raw uint8 stays uint8
    (flattened; normalisation happens on the device per gather); anything
    else is taken as pre-normalised float32."""
    arr = np.asarray(images)
    if arr.dtype == np.uint8:
        return np.ascontiguousarray(arr.reshape(arr.shape[0], -1))
    return np.asarray(arr, np.float32)


def epoch_batch_indices(sampler, batch_size: int) -> np.ndarray:
    """(nbatches, batch_size) int32: this rank's epoch as full batches, the
    last one wrap-padded (the loaders' math)."""
    return np.stack(list(_batched_indices(sampler, batch_size))).astype(np.int32)


def check_run_args(kernel: str, dtype: str, unroll: int, superstep: int,
                   impl: str) -> None:
    """Raise ValueError, by name, on what the JAX scan layer refuses and on
    the two JAX options the port has no counterpart for (a step scan to
    unroll; the TPU rbg stream per step)."""
    if kernel not in KERNELS:
        raise ValueError(f"unknown kernel {kernel!r}")
    if dtype not in DTYPES:
        raise ValueError(f"unknown dtype {dtype!r}")
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}; got {impl!r}")
    if superstep != 1:
        if kernel != "pallas_epoch":
            raise ValueError(
                f"superstep={superstep} is a whole-epoch-kernel knob (K SGD "
                f"sub-steps per grid iteration); kernel={kernel!r} has a "
                f"per-step loop — use kernel='pallas_epoch'")
        if superstep not in (2, 4, 8):
            raise ValueError(
                f"superstep must be 1, 2, 4 or 8 (sub-step loss rows must "
                f"stay inside one 8-row loss tile); got {superstep}")
    if unroll != 1:
        if kernel == "pallas_epoch":
            raise ValueError(
                "kernel 'pallas_epoch' has no per-step scan to unroll (the "
                "whole epoch is one kernel); drop unroll")
        raise ValueError(f"unroll={unroll} unrolls the JAX package's step "
                         f"scan; the port's steps are a host loop with "
                         f"nothing to unroll — drop unroll")
    if impl == "rbg" and kernel != "pallas_epoch":
        raise ValueError(
            f"impl 'rbg' with kernel={kernel!r} would draw the TPU rbg stream "
            f"per step, which the port does not have; rbg selects the "
            f"epoch kernel's Philox stream (kernel='pallas_epoch') only. Use "
            f"impl='threefry2x32' here")


def _clone(params):
    return {n: {k: v.detach().to(torch.float32).clone() for k, v in layer.items()}
            for n, layer in params.items()}


def _steps_epoch(params, key, x_all, y_all, idx_e, lr, kernel, compute_dt):
    """One epoch of per-step calls (`xla`, `pallas` or `pallas_rng`), SGD
    in place on `params`. Returns (key, losses (S,) on the device)."""
    batch = idx_e.shape[1]
    losses = []
    for rows in idx_e:
        key, sub = threefry.split(key)
        x = _gathered_x(x_all, rows, compute_dt)
        y = y_all.index_select(0, rows)
        if kernel == "pallas_rng":
            loss, grads = fused_loss_and_grads_rng(params, x, y, sub[0])
        else:
            mask = dropout_mask(sub, batch, x.device)
            if kernel == "pallas":
                loss, grads = fused_loss_and_grads(params, x, y, mask)
            else:
                loss, grads = xla_loss_and_grads(params, x, y, mask > 0)
        sgd_step(params, grads, lr)
        losses.append(loss)
    return key, torch.stack(losses)


def _kernel_epoch(params, key, x_all, y_all, idx_e, lr, impl, compute_bf16,
                  superstep):
    """One epoch through the whole-epoch kernel. Returns (new params, key,
    losses (S,) on the device)."""
    key, sub = threefry.split(key)
    nsteps, batch = idx_e.shape
    rows = idx_e.reshape(-1)
    # a ragged step count is padded here, at the index level (a few more
    # gathered rows of row 0); the kernel skips the padded steps
    pad_steps = (-nsteps) % superstep
    if pad_steps:
        rows = torch.cat([rows, rows.new_zeros(pad_steps * batch)])
    # raw uint8 rows go to the kernel as they are; it normalises them
    xp = x_all.index_select(0, rows)
    yp = y_all.index_select(0, rows)
    kw = dict(compute_bf16=compute_bf16, steps_per_iter=superstep,
              valid_steps=nsteps)
    if impl == "threefry2x32":
        words = threefry.split(sub, nsteps) + [(0, 0)] * pad_steps
        keys = _to_device(threefry.to_int32_words(words).numpy(), xp.device)
        params, losses = epoch_fused_sgd(params, xp, yp, keys, lr, batch,
                                         rng_impl="threefry", **kw)
    else:
        params, losses = epoch_fused_sgd(params, xp, yp, sub[0], lr, batch,
                                         rng_impl="core", **kw)
    return params, key, losses


def make_run_fn(lr: float, *, dtype: str = "float32", kernel: str = "xla",
                snapshots: bool = False, unroll: int = 1, superstep: int = 1,
                impl: str = "threefry2x32") -> Callable:
    """The whole E-epoch run: run(params, key, x_all, y_all, idxs (E, S, B))
    -> (params', key', losses (E, S)) or, with `snapshots`, also
    (p_snaps with a leading (E,) axis on every leaf, [key after each
    epoch]). Nothing is fetched from the device; `params` is not written.

    `impl` names the PRNG engine of the train key, as the JAX package's key
    type does there (see the module docstring). `superstep` (kernel
    'pallas_epoch' only; K in {1, 2, 4, 8}): K steps per epoch-kernel
    iteration, the same bits."""
    check_run_args(kernel, dtype, unroll, superstep, impl)
    compute_dt = _compute_dtype(dtype)

    def run(params, key, x_all, y_all, idxs):
        params = _clone(params)
        idxs = _to_device(np.asarray(idxs, np.int32), x_all.device)
        losses, p_snaps, k_snaps = [], [], []
        for idx_e in idxs:
            if kernel == "pallas_epoch":
                params, key, ls = _kernel_epoch(
                    params, key, x_all, y_all, idx_e, lr, impl,
                    dtype == "bfloat16", superstep)
            else:
                key, ls = _steps_epoch(params, key, x_all, y_all, idx_e, lr,
                                       kernel, compute_dt)
            losses.append(ls)
            if snapshots:
                p_snaps.append(_clone(params))
                k_snaps.append(key)
        losses = torch.stack(losses)
        if not snapshots:
            return params, key, losses
        stacked = {n: {k: torch.stack([p[n][k] for p in p_snaps])
                       for k in layer} for n, layer in params.items()}
        return params, key, losses, (stacked, k_snaps)

    return run


def make_epoch_fn(lr: float, *, dtype: str = "float32", kernel: str = "xla",
                  impl: str = "threefry2x32") -> Callable:
    """One epoch: epoch(params, key, x_all, y_all, idx (S, B)) -> (params',
    key', losses (S,)), the one-element case of make_run_fn."""
    run = make_run_fn(lr, dtype=dtype, kernel=kernel, impl=impl)

    def epoch(params, key, x_all, y_all, idx):
        params, key, losses = run(params, key, x_all, y_all,
                                  np.asarray(idx)[None])
        return params, key, losses[0]

    return epoch


def _load_params(model: MLP, params) -> None:
    with torch.no_grad():
        for name, layer in model.params().items():
            for k, p in layer.items():
                p.copy_(params[name][k])


def fit_cached(model: MLP, key, x_train, y_train, sampler, x_test, y_test, *,
               epochs: int, batch_size: int, lr: float, kernel: str = "xla",
               impl: str = "threefry2x32", fused: bool = False,
               dtype: str = "float32", mesh=None, ckpt_every_steps: int = 0,
               step_hook=None, start_offset: int = 0, watchdog=None,
               dispatch_profiler=None,
               log: Callable[[str], None] = print):
    """The `fit` loop with the dataset resident on the model's device.
    Prints the reference epoch line per epoch; writes the trained weights
    into `model`. Returns (key, per-epoch arrays of the per-step losses).

    `fused=True` runs ALL epochs with no host sync between them (one fetch
    at the end), keeping per-epoch params snapshots so the per-epoch val
    lines are still printed, after the device is done; the img/s of the
    line is then the run average.

    The JAX trainer's mesh, step-granular checkpoints, live watchdog and
    dispatch profiler are not ported yet and are refused by name."""
    refused = [
        (mesh is not None, "a device mesh (DDP)", "queue 1, item 6"),
        (bool(ckpt_every_steps) or step_hook is not None or start_offset,
         "step-granular checkpoints (ckpt_every_steps/step_hook/"
         "start_offset)", "queue 1, item 8"),
        (watchdog is not None, "the live health watchdog", "queue 1, item 12"),
        (dispatch_profiler is not None, "the dispatch profiler",
         "queue 1, item 12"),
    ]
    for given, what, where in refused:
        if given:
            raise ValueError(f"{what} is not ported to the PyTorch package "
                             f"yet; see ROADMAP.md {where}")
    device = next(model.parameters()).device
    x_all = torch.from_numpy(resident_images(x_train)).to(device)
    y_all = torch.from_numpy(np.asarray(y_train, np.int32)).to(device)
    x_test_dev = torch.as_tensor(np.asarray(x_test), device=device)
    y_test_dev = torch.as_tensor(np.asarray(y_test), device=device)
    params = _clone(model.params())
    history: List[np.ndarray] = []

    if fused:
        idxs = []
        for epoch in range(epochs):
            sampler.set_epoch(epoch)
            idxs.append(epoch_batch_indices(sampler, batch_size))
        run = make_run_fn(lr, dtype=dtype, kernel=kernel, snapshots=True,
                          impl=impl)
        t0 = time.perf_counter()
        params, key, losses, (p_snaps, _) = run(params, key, x_all, y_all,
                                                np.stack(idxs))
        losses = losses.cpu().numpy()      # the run's one fetch
        per_epoch_dt = (time.perf_counter() - t0) / max(epochs, 1)
        per_sample, correct = make_snapshot_eval_step()(p_snaps, x_test_dev,
                                                        y_test_dev)
        per_sample, correct = per_sample.cpu().numpy(), correct.cpu().numpy()
        for epoch in range(epochs):
            val = val_summary(per_sample[epoch], correct[epoch], batch_size)
            log(epoch_summary(epoch, losses[epoch], batch_size, val,
                              per_epoch_dt))
            history.append(losses[epoch])
        _load_params(model, params)
        return key, history

    epoch_fn = make_epoch_fn(lr, dtype=dtype, kernel=kernel, impl=impl)
    for epoch in range(epochs):
        t0 = time.perf_counter()
        sampler.set_epoch(epoch)
        idx = epoch_batch_indices(sampler, batch_size)
        params, key, losses = epoch_fn(params, key, x_all, y_all, idx)
        losses = losses.cpu().numpy()      # the epoch's one fetch
        _load_params(model, params)
        val = evaluate(model, x_test_dev, y_test_dev, batch_size)
        log(epoch_summary(epoch, losses, batch_size, val,
                          time.perf_counter() - t0))
        history.append(losses)
    return key, history
