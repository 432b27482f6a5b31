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
  * `xla` / `pallas` / `pallas_rng`: per-step calls on data already on
    the device, the key chain `key, sub = split(key)` per step. JAX runs
    these steps as one `lax.scan`; here one step is captured as a CUDA
    graph and replayed once a step (`CachedSteps` on train/graphs.py
    `StepLoop`): the epoch's batch indices and its keys (ops/threefry.py
    `step_key_words`) are loaded into static device buffers before its
    first step, and step s reads row s of each through a device cursor, so
    the host only replays the graph and fetches the losses once an epoch.
    `xla` draws the mask `dropout_mask(sub)` (bitwise JAX's, by the mask
    entry reading the key from the table, `keyed_dropout_mask`) for the
    autograd step with the forward's keyed dropout; `pallas` runs the
    fused step (K1) with the same mask drawn inside it
    (`fused_loss_and_grads_keyed`); `pallas_rng` hands word 0 of `sub` to
    the fused step as its seed, read by the kernel from the table, and the
    kernel draws the mask itself (K1-rng), as JAX's `_loss_and_grads`
    does. The graph gives the bits of the same step run eagerly on the
    same buffers, which the CPU runs, and which a card runs only in a
    `CachedSteps` built with `eager=True` (chip_smoke.py's turns and the
    card tests).

`dtype="bfloat16"` is JAX's recipe: the gathered batch is cast to bf16;
`xla` then runs the whole forward and backward in bf16 (the params cast to
it, f32 grads), and the kernels run their bf16-operand modes (K1-bf16,
K2-bf16) with f32 master weights.

Data parallel (`mesh=`, a tuple of replica devices from
parallel/mesh.py; `make_dp_run_fn`, `make_dp_epoch_fn`): the index array
is (E, S, n*B), and each step's global row is split into n consecutive
B-row shards, one per replica (the JAX package's P(None, None, 'dp')).
`pallas_epoch` runs each epoch as ONE launch of the DP epoch kernel (K6),
whose in-kernel ring takes every step's gradient mean; the replicas' keys
are `split(fold_in(sub, r), S)` (threefry) or the kernel's Philox at
replica word r (rbg). The per-step kernels fold the replica into each
step's key (`fold_in(sub, r)`, the (S, n, 2) key table) and average in
fixed origin order (parallel/ddp.py `replica_mean`); on a mesh whose
replicas share the dataset's device the whole mesh step is the captured
step. The reported loss is the replicas' mean.
A 1-replica mesh runs the serial epoch kernel with the serial key chain
(no ring, as in JAX).

Across processes (a `WorldMesh`, parallel/mesh.py) every process holds the
dataset on its device and builds the same global sampler, and rank r takes
the contiguous columns [r*L*B, (r+1)*L*B) of each step's global rows for
its L local replicas (`epoch_rows`: the JAX path's P(None, DATA_AXIS)
slicing of one global batch): the idxs of `make_dp_run_fn` are then this
process's, (E, S, L*B). The per-step kernels fold the GLOBAL replica
index into the key and take the world's fixed-order mean
(parallel/ddp.py `world_mean`), so a world is bitwise the single-process
mesh of as many replicas fed the world's rows in rank order. A world,
one rank too, and a mesh across cards run their steps in an eager host
loop (`_dp_steps_epoch`) on the same (S, n, 2) key table: a world's mean
is a collective (over gloo through the host).
`pallas_epoch` across processes is refused by name: K6's ring runs among
the replicas of one cooperative launch (ROADMAP.md queue 2, item 6).

The gradient-communication strategy of a DP run (`comm`, with
`bf16_rounding`, `overlap`, `quant_block`, `error_feedback`; parallel/
collectives.py `DPComm`) replaces the pmean mean in every per-step DP loop:
the captured step on a one-card mesh (its int8 residual a device tensor
the step updates in place, restored after the capture's warm-up; its
rounding keys drawn on the device from the key table's rows), and the
eager loop of a world or a mesh across cards. `pallas_epoch` refuses
`comm` and `overlap` by name, as JAX does: K6 takes its mean in its ring.
`model` / `param_scale` select a zoo model (models/zoo.py), on `xla` only.

Keys are `(k0, k1)` tuples of the threefry key words (ops/threefry.py).
The per-step losses stay on the device and are fetched once per epoch
(once per run with `fused=True`), so `fit_cached` prints the reference
epoch line as `fit` does.
"""

from __future__ import annotations

import math
import time
from typing import Callable, List

import numpy as np
import torch

from ..data.loader import _batched_indices
from ..data.mnist import device_normalize
from ..models.mlp import MLP, mlp_apply
from ..models.zoo import hidden_width, is_default_model, model_apply
from ..ops import threefry
from ..ops.epoch_step import RINGS, epoch_fused_sgd
from ..ops.fused_step import (fused_loss_and_grads_keyed,
                              fused_loss_and_grads_rng)
from ..ops.sgd import sgd_step
from ..parallel import collectives
from ..parallel.ddp import (make_ddp_comm_recorder, on_device, replica_mean,
                            replicate_state)
from ..parallel.mesh import as_mesh, first_replica, replicas, world_size
from ..pipeline import prefetch
from . import graphs
from .loop import (_to_device, epoch_summary, evaluate, keyed_keep,
                   make_snapshot_eval_step, val_summary, xla_loss_and_grads)

__all__ = ["device_normalize", "resident_images", "epoch_batch_indices",
           "epoch_rows",
           "check_run_args", "CachedSteps", "make_run_fn", "make_epoch_fn",
           "check_ring", "make_dp_run_fn", "make_dp_epoch_fn", "fit_cached"]

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


def epoch_rows(sampler, batch_size: int, mesh=None) -> np.ndarray:
    """(nbatches, rows) int32: this process's rows of each step of the
    epoch on the resident-dataset path. `sampler` is the GLOBAL sampler
    (num_replicas=1) and `batch_size` the global batch; in a world of W
    processes with L local replicas, rank r takes the contiguous columns
    [r*L*B, (r+1)*L*B) of each global batch, as the JAX path's
    P(None, DATA_AXIS) gives a process its devices' rows."""
    idx = epoch_batch_indices(sampler, batch_size)
    world = 1 if mesh is None else world_size(mesh)
    if world == 1:
        return idx
    if sampler.num_replicas != 1:
        raise ValueError(
            f"the resident-dataset path of a world of {world} processes "
            f"takes the global sampler (num_replicas=1) and slices each "
            f"step's rows by rank; got a sampler of {sampler.num_replicas} "
            f"shards")
    rows = batch_size // world
    return np.ascontiguousarray(idx[:, mesh.rank * rows:(mesh.rank + 1) * rows])


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
                         f"scan; the port replays one captured step a step, "
                         f"with nothing to unroll — drop unroll")
    if impl == "rbg" and kernel != "pallas_epoch":
        raise ValueError(
            f"impl 'rbg' with kernel={kernel!r} would draw the TPU rbg stream "
            f"per step, which the port does not have; rbg selects the "
            f"epoch kernel's Philox stream (kernel='pallas_epoch') only. Use "
            f"impl='threefry2x32' here")


def _clone(params):
    return {n: {k: v.detach().to(torch.float32).clone() for k, v in layer.items()}
            for n, layer in params.items()}


def _loss_and_grads(params, x_all, y_all, rows, key, kernel, compute_dt,
                    apply=mlp_apply):
    """One step's (loss, grads) on the gathered `rows` with the dropout of
    `key`, a row of the epoch's key table on the device, which every kernel
    reads there: `pallas` draws the mask in the kernel, `pallas_rng` takes
    word 0 as the kernel's seed, `xla` draws `dropout_mask` of the key with
    the mask entry (train/loop.py `keyed_keep`: at a zoo model's other
    hidden widths in plain tensor ops) for the forward `apply`."""
    x = _gathered_x(x_all, rows, compute_dt)
    y = y_all.index_select(0, rows)
    if kernel == "pallas":
        return fused_loss_and_grads_keyed(params, x, y, key)
    if kernel == "pallas_rng":
        return fused_loss_and_grads_rng(params, x, y, key)
    keep = keyed_keep(key, rows.shape[0], hidden_width(params), x.device)
    return xla_loss_and_grads(params, x, y, keep, apply=apply)


class CachedSteps:
    """The per-step loop of kernel `xla`, `pallas` or `pallas_rng` over the
    resident dataset (x_all, y_all), serial or over a single-process `mesh`
    whose replicas share the dataset's device, with SGD in place on
    `params`: one step captured as a CUDA graph on a card (train/graphs.py
    `StepLoop`), run eagerly on the CPU or with `eager`.

    Its static buffers are the epoch's (S, rows) batch indices (`rows` =
    n * B on a mesh: replica r takes columns r*B..(r+1)*B) and its (S, 2)
    key table, (S, n, 2) on a mesh (the replicas' `fold_in(sub, g)`).
    `epoch(key, idx)` loads them, runs the S steps and returns (key after
    the epoch, the (S,) losses on the device: the replicas' mean on a
    mesh). On a mesh the mean and the update are `comm`'s (a
    collectives.DPComm, default pmean), whose residual (int8 with error
    feedback) is placed here if it is not yet; `apply` is a zoo model's
    forward."""

    def __init__(self, params, x_all, y_all, idx_shape, lr: float,
                 kernel: str, compute_dt, mesh=None, *, eager: bool = False,
                 comm=None, apply=mlp_apply):
        device = x_all.device
        nsteps, rows = idx_shape
        self.params = params
        self.fold = (None if mesh is None else
                     range(first_replica(mesh), first_replica(mesh) + len(mesh)))
        self.idx = graphs.StaticInput((nsteps, rows), torch.int32, device)
        self.keys = graphs.StaticInput(
            (nsteps, 2) if mesh is None else (nsteps, len(mesh), 2),
            torch.int32, device)
        idx, keys = self.idx.buf, self.keys.buf
        if mesh is not None and comm is None:
            comm = collectives.DPComm(mesh, lr)
        if comm is not None and comm.stateful and comm.resid is None:
            comm.place_state(params)
        self.comm = comm

        def step(params, step_rows, words):
            if mesh is None:
                loss, grads = _loss_and_grads(params, x_all, y_all, step_rows,
                                              words, kernel, compute_dt, apply)
                sgd_step(params, grads, lr)
                return loss
            batch = rows // len(mesh)
            losses, grads = [], []
            for r in range(len(mesh)):
                loss, g = _loss_and_grads(
                    params, x_all, y_all,
                    step_rows[r * batch:(r + 1) * batch], words[r], kernel,
                    compute_dt, apply)
                losses.append(loss)
                grads.append(g)
            return comm.update(params, losses, grads, words)

        def body(params, cursor, losses):
            at = cursor.view(1)
            loss = step(params, idx.index_select(0, at)[0],
                        keys.index_select(0, at)[0])
            losses.index_copy_(0, at, loss.reshape(1))
            cursor.add_(1)

        where = ("" if mesh is None else f" over {len(mesh)} replicas"
                 f" ({comm.comm}{'+overlap' if comm.overlap else ''})")
        self.loop = graphs.StepLoop(
            body, params, nsteps, device,
            capture=device.type == "cuda" and not eager,
            what=f"the cached {kernel} step ({compute_dt}){where}",
            preserve=comm.state_tensors() if comm is not None else ())

    def load(self, key, idx, offset: int = 0):
        """Load an epoch's (S, rows) indices and the keys of its steps
        offset..S-1 (from `key`, the key after `offset` steps: a resume's),
        into their rows of the table. Returns the key after the epoch."""
        key, words = threefry.step_key_words(key, self.loop.nsteps, self.fold,
                                             offset)
        self.idx.load(np.asarray(idx, np.int32))
        self.keys.load(words)
        return key

    def run(self, c0: int, c1: int) -> torch.Tensor:
        """Steps c0..c1-1 of the loaded epoch; their losses on the device."""
        return self.loop.run(c0, c1)

    def epoch(self, key, idx):
        key = self.load(key, idx)
        return key, self.loop.epoch()


def dp_kernel(comm: str, overlap: bool = False, model: str = "mlp",
              param_scale: int = 1, device_type: str = "cuda") -> str:
    """The kernel of a DP step under the trainer's `--kernel auto`
    (train/config.py `resolve_kernel`, `check_comm_and_input_knobs`): the
    fused step (K1 keyed) on a card at the reference model; `xla` for
    int8, --overlap, a zoo model's other shapes, and on the CPU."""
    if overlap or comm == "int8" or not is_default_model(model, param_scale):
        return "xla"
    from .config import resolve_kernel
    return resolve_kernel("auto", "float32", device_type)


def dp_steps(params, x_all, y_all, comm: str, overlap: bool = False, *,
             replicas: int, nsteps: int, batch: int, lr: float = 0.01,
             model: str = "mlp", param_scale: int = 1, kernel: str = "auto",
             eager: bool = False) -> CachedSteps:
    """The data-parallel step program: `CachedSteps` over a mesh of
    `replicas` replicas of the dataset's device, `batch` rows a replica,
    `nsteps` steps an epoch, its mean and update those of a
    collectives.DPComm of `comm` (`overlap`: the bucketed form), the
    kernel `dp_kernel`'s unless named. The one builder of the programs
    that bench.py `--mode ddp` times and telemetry/costs.py prices, so the
    cost records are of the programs the bench measures."""
    device = x_all.device
    if kernel == "auto":
        kernel = dp_kernel(comm, overlap, model, param_scale, device.type)
    mesh = (device,) * replicas
    dp = collectives.DPComm(mesh, lr, comm, overlap=overlap)
    from ..models.zoo import resolve_model
    return CachedSteps(params, x_all, y_all, (nsteps, replicas * batch), lr,
                       kernel, torch.float32, mesh, eager=eager, comm=dp,
                       apply=resolve_model(model, param_scale).apply)


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


def _host_indices(idxs, host: bool):
    """A run's (E, S, rows) indices: int32 numpy, or a device tensor that
    fit_cached's prefetch placed ahead (kept as it is unless the run needs
    them on the host: the captured loop loads its static buffer from
    them)."""
    if isinstance(idxs, torch.Tensor):
        return idxs.cpu().numpy().astype(np.int32) if host else idxs
    return np.asarray(idxs, np.int32)


def _one_epoch(idx):
    """An epoch's indices as a run's (1, S, rows)."""
    return (idx if isinstance(idx, torch.Tensor) else np.asarray(idx))[None]


def _placed(idxs, device) -> torch.Tensor:
    """The indices on `device`: copied there (pinned, non-blocking), or as
    they are when already placed."""
    if isinstance(idxs, torch.Tensor):
        return idxs.to(device)
    return _to_device(idxs, device)


def make_run_fn(lr: float, *, dtype: str = "float32", kernel: str = "xla",
                snapshots: bool = False, unroll: int = 1, superstep: int = 1,
                impl: str = "threefry2x32", model: str = "mlp",
                param_scale: int = 1) -> Callable:
    """The whole E-epoch run: run(params, key, x_all, y_all, idxs (E, S, B))
    -> (params', key', losses (E, S)) or, with `snapshots`, also
    (p_snaps with a leading (E,) axis on every leaf, [key after each
    epoch]). Nothing is fetched from the device; `params` is not written.

    `impl` names the PRNG engine of the train key, as the JAX package's key
    type does there (see the module docstring). `superstep` (kernel
    'pallas_epoch' only; K in {1, 2, 4, 8}): K steps per epoch-kernel
    iteration, the same bits. The per-step kernels run one captured step a
    step on a card, one capture a run (`CachedSteps`). `model` /
    `param_scale` select a zoo model (models/zoo.py; `xla` only)."""
    from ..models.zoo import resolve_model
    check_run_args(kernel, dtype, unroll, superstep, impl)
    check_model(model, param_scale, kernel)
    compute_dt = _compute_dtype(dtype)
    apply = resolve_model(model, param_scale).apply

    def run(params, key, x_all, y_all, idxs):
        params = _clone(params)
        idxs = _host_indices(idxs, kernel != "pallas_epoch")
        if kernel == "pallas_epoch":
            idx_dev = _placed(idxs, x_all.device)
        else:
            steps = CachedSteps(params, x_all, y_all, idxs.shape[1:], lr,
                                kernel, compute_dt, apply=apply)
        losses, p_snaps, k_snaps = [], [], []
        for e in range(idxs.shape[0]):
            if kernel == "pallas_epoch":
                params, key, ls = _kernel_epoch(
                    params, key, x_all, y_all, idx_dev[e], lr, impl,
                    dtype == "bfloat16", superstep)
            else:
                key, ls = steps.epoch(key, idxs[e])
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
                  impl: str = "threefry2x32", model: str = "mlp",
                  param_scale: int = 1) -> Callable:
    """One epoch: epoch(params, key, x_all, y_all, idx (S, B)) -> (params',
    key', losses (S,)), the one-element case of make_run_fn."""
    run = make_run_fn(lr, dtype=dtype, kernel=kernel, impl=impl,
                      model=model, param_scale=param_scale)

    def epoch(params, key, x_all, y_all, idx):
        params, key, losses = run(params, key, x_all, y_all,
                                  _one_epoch(idx))
        return params, key, losses[0]

    return epoch


def check_ring(ring: str, kernel: str, n_dev: int) -> None:
    """`ring` selects the DP epoch kernel's in-kernel allreduce; refused by
    name wherever it would be a silent no-op (JAX `_check_ring`)."""
    if ring not in RINGS:
        raise ValueError(f"ring must be 'auto', 'allgather' or "
                         f"'reduce_scatter'; got {ring!r}")
    if ring == "auto":
        return
    if kernel != "pallas_epoch" or n_dev == 1:
        raise ValueError(
            f"ring={ring!r} selects the DP epoch kernel's in-kernel "
            f"allreduce strategy; it needs kernel='pallas_epoch' on a "
            f"multi-device mesh (got kernel={kernel!r}, {n_dev} device(s))")


def _dp_steps_epoch(mesh, params, key, data, idx_e, lr, kernel, compute_dt,
                    comm, apply=mlp_apply):
    """One epoch of per-step DP calls in an eager host loop, for a world of
    processes and a mesh across cards: per step `key, sub = split(key)`,
    local replica r takes shard r of the step's rows with the dropout of
    `fold_in(sub, g)`, g its global index, read from row (s, r) of the
    epoch's (S, n, 2) key table, built before the first step; then `comm`
    (a collectives.DPComm) takes the world's mean by its strategy and
    writes SGD into `params` in place. Returns (key, losses (S,), the
    world's mean per step)."""
    n, first = len(mesh), first_replica(mesh)
    batch = idx_e.shape[1] // n
    shards = [data[d][2][:, r * batch:(r + 1) * batch]
              for r, d in enumerate(mesh)]
    device = idx_e.device
    # the epoch's keys on the device, one copy
    key, table = threefry.step_key_table(key, idx_e.shape[0], device,
                                         range(first, first + n))
    losses = []
    for s in range(idx_e.shape[0]):
        step_losses, grads = [], []
        for r, dev in enumerate(mesh):
            x_all, y_all, _ = data[dev]
            loss, g = _loss_and_grads(on_device(params, dev), x_all, y_all,
                                      shards[r][s], table[s, r].to(dev),
                                      kernel, compute_dt, apply)
            step_losses.append(loss)
            grads.append(g)
        losses.append(comm.update(params, step_losses, grads, table[s]))
    return key, torch.stack(losses)


def _dp_kernel_epoch(mesh, reps, key, data, idx_e, lr, impl, compute_bf16,
                     ring, superstep):
    """One epoch through the DP epoch kernel (K6) on the per-replica params
    `reps`. Returns (reps', key, losses (S,): the replicas' mean)."""
    n = len(mesh)
    if n == 1:     # the serial kernel and key chain: no ring, as in JAX
        x_all, y_all, idx = data[mesh[0]]
        params, key, losses = _kernel_epoch(reps[0], key, x_all, y_all, idx,
                                            lr, impl, compute_bf16, superstep)
        return [params], key, losses
    key, sub = threefry.split(key)
    nsteps = idx_e.shape[0]
    batch = idx_e.shape[1] // n
    xps, yps, seeds = [], [], []
    for r, dev in enumerate(mesh):
        x_all, y_all, idx = data[dev]
        rows = idx[:, r * batch:(r + 1) * batch].reshape(-1)
        xps.append(x_all.index_select(0, rows))
        yps.append(y_all.index_select(0, rows))
        if impl == "threefry2x32":
            words = threefry.split(threefry.fold_in(sub, r), nsteps)
            seeds.append(_to_device(threefry.to_int32_words(words).numpy(),
                                    xps[-1].device))
    kw = dict(compute_bf16=compute_bf16, axis_size=n, ring=ring)
    if impl == "threefry2x32":
        reps, losses = epoch_fused_sgd(reps, xps, yps, seeds, lr, batch,
                                       rng_impl="threefry", **kw)
    else:
        reps, losses = epoch_fused_sgd(reps, xps, yps, sub[0], lr, batch,
                                       rng_impl="core", **kw)
    return reps, key, replica_mean(losses, idx_e.device)


def check_dp_run_args(mesh, kernel: str, dtype: str, unroll: int,
                      superstep: int, impl: str, ring: str,
                      comm: str, *, bf16_rounding: str = "nearest",
                      overlap: bool = False, quant_block: int | None = None,
                      error_feedback: bool = True, model: str = "mlp",
                      param_scale: int = 1) -> None:
    """The DP scan layer's refusals, by name: those of `check_run_args`,
    the ring's, the comm strategy's and its knobs', a comm strategy or
    `overlap` on the epoch kernel, a zoo model off `xla`, a superstep on a
    multi-replica mesh (JAX `make_dp_run_fn`), and the epoch kernel across
    processes."""
    check_run_args(kernel, dtype, unroll, superstep, impl)
    check_model(model, param_scale, kernel)
    collectives.validate_comm(comm)
    collectives.validate_bf16_rounding(bf16_rounding, comm)
    collectives.validate_int8_options(quant_block, error_feedback, comm)
    if comm != "pmean" and kernel == "pallas_epoch":
        raise ValueError(
            f"comm={comm!r} selects the per-step gradient collective; "
            f"kernel 'pallas_epoch' performs its allreduce IN-kernel (the "
            f"ring — pick it with ring=) and never reads comm")
    if overlap and kernel == "pallas_epoch":
        raise ValueError(
            "overlap=True bucket-pipelines the per-step gradient "
            "collectives; kernel 'pallas_epoch' owns its comms IN-kernel "
            "and never reads it")
    if kernel == "pallas_epoch" and world_size(mesh) > 1:
        raise ValueError(
            f"kernel='pallas_epoch' across a world of {world_size(mesh)} "
            f"processes: the DP epoch kernel's ring (K6) runs among the "
            f"replicas of one cooperative launch, and across processes it "
            f"needs peer or IPC pointers and co-resident launches "
            f"(ROADMAP.md queue 2, item 6). Use kernel='pallas'")
    n = len(mesh)
    check_ring(ring, kernel, n)
    if superstep != 1 and n > 1:
        raise ValueError(
            f"superstep={superstep} is single-replica only (the DP ring's "
            f"per-iteration handshake); use superstep=1 on the {n}-device "
            f"mesh")


def check_model(model: str, param_scale: int, kernel: str) -> None:
    """A zoo model other than the reference MLP runs the plain autograd
    step only: the fused kernels take the reference MLP's shapes (JAX's
    refusal, by name)."""
    from ..models.zoo import validate_model
    validate_model(model, param_scale)
    if not is_default_model(model, param_scale) and kernel != "xla":
        raise ValueError(
            f"model={model!r} param_scale={param_scale} needs the plain "
            f"autograd step; kernel={kernel!r} hard-codes the reference "
            f"MLP's shapes — use kernel='xla'")


def _mesh_data(mesh, x_all, y_all, idxs):
    """{device: (x_all, y_all, idxs)} placed once per distinct device of
    the mesh (replicas sharing a device share its copy; nothing writes
    them)."""
    out = {}
    for dev in mesh:
        if dev not in out:
            out[dev] = (x_all.to(dev), y_all.to(dev), idxs.to(dev))
    return out


def make_dp_run_fn(mesh, lr: float, *, dtype: str = "float32",
                   kernel: str = "xla", snapshots: bool = False,
                   unroll: int = 1, superstep: int = 1, ring: str = "auto",
                   comm: str = "pmean", bf16_rounding: str = "nearest",
                   overlap: bool = False, quant_block: int | None = None,
                   error_feedback: bool = True,
                   bucket_elems: int | None = None,
                   model: str = "mlp", param_scale: int = 1,
                   impl: str = "threefry2x32") -> Callable:
    """The whole E-epoch DP run over `mesh` (a tuple of replica devices, or
    a WorldMesh of this process's): run(params, key, x_all, y_all, idxs
    (E, S, n*B)) -> (params', key', losses (E, S)) or, with `snapshots`,
    also (p_snaps, [keys]), as `make_run_fn`; n is the local replicas and
    idxs this process's rows. The losses are the world's mean per step;
    params' lies on x_all's device. `ring` (kernel 'pallas_epoch' on n > 1
    replicas) picks K6's allreduce; `superstep` is single-replica only.
    `comm` and its knobs pick the gradient communication (parallel/
    collectives.py `DPComm`, built fresh a run, its int8 residual zeros
    or `run(..., resid=)`; `run.comm` is the last run's); `model` /
    `param_scale` a zoo model (`xla` only). The per-step kernels on a mesh
    whose replicas share x_all's device run one captured step a step
    (`CachedSteps`; a world and a mesh across cards, `_dp_steps_epoch`)."""
    from ..models.zoo import resolve_model
    mesh = as_mesh(mesh)
    check_dp_run_args(mesh, kernel, dtype, unroll, superstep, impl, ring,
                      comm, bf16_rounding=bf16_rounding, overlap=overlap,
                      quant_block=quant_block,
                      error_feedback=error_feedback, model=model,
                      param_scale=param_scale)
    compute_dt = _compute_dtype(dtype)
    apply = resolve_model(model, param_scale).apply

    def run(params, key, x_all, y_all, idxs, resid=None):
        device = x_all.device
        params = _clone(params)
        captured = (kernel != "pallas_epoch"
                    and graphs.on_one_device(mesh, device))
        idxs = _host_indices(idxs, captured)
        dp = collectives.DPComm(mesh, lr, comm, bf16_rounding=bf16_rounding,
                                overlap=overlap, quant_block=quant_block,
                                error_feedback=error_feedback,
                                bucket_elems=bucket_elems)
        dp.place_state(params, resid)
        run.comm = dp
        if captured:
            steps = CachedSteps(params, x_all, y_all, idxs.shape[1:], lr,
                                kernel, compute_dt, mesh, comm=dp,
                                apply=apply)
        else:
            steps = None
            idx_dev = _placed(idxs, device)
            data = _mesh_data(mesh, x_all, y_all, idx_dev)
        if kernel == "pallas_epoch":
            reps = replicate_state(mesh, params)
        losses, p_snaps, k_snaps = [], [], []
        for e in range(idxs.shape[0]):
            if steps is not None:
                key, ls = steps.epoch(key, idxs[e])
            elif kernel == "pallas_epoch":
                step_data = {d: (xa, ya, ix[e])
                             for d, (xa, ya, ix) in data.items()}
                reps, key, ls = _dp_kernel_epoch(
                    mesh, reps, key, step_data, idx_dev[e], lr, impl,
                    dtype == "bfloat16", ring, superstep)
                params = on_device(reps[0], device)
            else:
                step_data = {d: (xa, ya, ix[e])
                             for d, (xa, ya, ix) in data.items()}
                key, ls = _dp_steps_epoch(mesh, params, key, step_data,
                                          idx_dev[e], lr, kernel, compute_dt,
                                          dp, apply)
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

    run.comm_state = collectives.carries_state(comm, error_feedback)
    run.comm = None
    return run


def make_dp_epoch_fn(mesh, lr: float, *, dtype: str = "float32",
                     kernel: str = "xla", ring: str = "auto",
                     comm: str = "pmean", impl: str = "threefry2x32",
                     **comm_kw) -> Callable:
    """One DP epoch: epoch(params, key, x_all, y_all, idx (S, n*B),
    resid=None) -> (params', key', losses (S,)), the one-element case of
    make_dp_run_fn (`comm_kw`: its strategy and model knobs); `epoch.comm`
    is the last epoch's DPComm, which holds its residual."""
    run = make_dp_run_fn(mesh, lr, dtype=dtype, kernel=kernel, ring=ring,
                         comm=comm, impl=impl, **comm_kw)

    def epoch(params, key, x_all, y_all, idx, resid=None):
        params, key, losses = run(params, key, x_all, y_all,
                                  _one_epoch(idx), resid)
        epoch.comm = run.comm
        return params, key, losses[0]

    epoch.comm = None
    return epoch


def _load_params(model: MLP, params) -> None:
    with torch.no_grad():
        for name, layer in model.params().items():
            for k, p in layer.items():
                p.copy_(params[name][k])


def _chunks(offset: int, nsteps: int, every: int) -> list:
    """An epoch's steps from `offset`, cut at the epoch-local multiples of
    `every` (0: one chunk): the boundaries of the unbroken run's chunks,
    so a resumed run saves where the unbroken one does."""
    bounds, c0 = [], offset
    while c0 < nsteps:
        c1 = min(nsteps, (c0 // every + 1) * every) if every else nsteps
        bounds.append((c0, c1))
        c0 = c1
    return bounds


def fit_cached(model: MLP, key, x_train, y_train, sampler, x_test, y_test, *,
               epochs: int, batch_size: int, lr: float, kernel: str = "xla",
               impl: str = "threefry2x32", fused: bool = False,
               dtype: str = "float32", mesh=None, ring: str = "auto",
               comm: str = "pmean", bf16_rounding: str = "nearest",
               overlap: bool = False, quant_block: int | None = None,
               error_feedback: bool = True, start_epoch: int = 0,
               start_offset: int = 0, ckpt_every_steps: int = 0,
               step_hook=None, epoch_hook=None, watchdog=None,
               dispatch_profiler=None, eval_perm: Callable | None = None,
               prefetch_depth: int = 1, resid=None,
               log: Callable[[str], None] = print):
    """The `fit` loop with the dataset resident on the model's device, over
    epochs [start_epoch, epochs). Prints the reference epoch line per
    epoch; writes the trained weights into `model`. Returns (key,
    per-epoch arrays of the per-step losses). `model` may be a zoo model
    (models/zoo.py; `xla` only).

    `fused=True` runs ALL epochs with no host sync between them (one fetch
    at the end), keeping per-epoch params snapshots so the per-epoch val
    lines are still printed, after the device is done; the img/s of the
    line is then the run average.

    `mesh` (a tuple of replica devices, or a WorldMesh, parallel/mesh.py)
    trains data parallel (`make_dp_run_fn`): `batch_size` is then the
    GLOBAL batch, `n` replicas of `batch_size // n` rows each over the
    world, and the model's device holds the dataset and the eval.
    `sampler` is the global sampler (num_replicas=1) on every process; in
    a world of W processes rank r trains on columns [r*b, (r+1)*b) of each
    global batch, b = `batch_size // W` (`epoch_rows`). `ring` picks K6's
    allreduce; `comm`, `bf16_rounding`, `overlap`, `quant_block` and
    `error_feedback` the per-step strategy (parallel/collectives.py), whose
    int8 residual starts from `resid` (or zeros) and is carried across the
    epochs (`fit_cached.comm` holds the last one).

    The per-step kernels run one captured step a step on a card, one
    capture a fit (`CachedSteps`; `fused=True`: one a run of
    make_run_fn).

    Step checkpoints (the JAX `fit_cached`'s): `ckpt_every_steps=N` cuts
    each epoch into chunks at its multiples of N (`_chunks`); the captured
    step replays a chunk from a cursor set to its first step (the same
    graph: no capture mid-fit) and the chunk's losses are its one fetch,
    and the other paths run the epoch function on the chunk's index rows
    with the key the chain has reached. After each chunk `step_hook(epoch,
    offset, global_step, state)` fires as in `fit` (train/loop.py
    `_fire_step_hook`, the model loaded with the chunk's params, the key
    after its last step, the residual), then the `step` fault point; each
    fetched chunk is the `loss` poison point. `start_epoch` and
    `start_offset` resume: the first epoch starts at step `start_offset`,
    its key table holding the steps from there, split from the restored
    key. The chunks are consecutive runs of the same steps, so a chunked or
    resumed run is the unbroken one, bit for bit. `fused=True` has no
    host control inside its run and `kernel='pallas_epoch'` splits its key
    once an epoch: both refuse step checkpoints and `start_offset` by name,
    as JAX does. `epoch_hook(epoch, state)` fires after each epoch's line.

    `prefetch_depth` (the input pipeline's host-to-device stage,
    pipeline/prefetch.py) keeps that many epochs' index arrays made (and,
    on the eager and epoch-kernel paths, copied to the device) ahead of the
    epoch that trains. The values are the same at any depth. `fused=True`
    places one index array for the run and refuses a depth other than 1 by
    name.

    `eval_perm(epoch)`, when given, is the order of the epoch's val-loss
    segmentation (`--eval_shuffle`), on every path.

    Telemetry (the JAX `fit_cached`'s): each epoch is an `epoch` span with
    `step_compute` and `eval` children and a `mem_watermark` point, and a
    fused run one `fused_run` span. `watchdog` (telemetry.health.Watchdog)
    observes once a chunk (once an epoch with no step checkpoints, and on
    `pallas_epoch`) over the chunk's fetched losses, with the positions a
    step checkpoint after it would record; `dispatch_profiler` times the
    chunk boundary, `dispatch` being the chunk's replays or its epoch
    function, `sync_wait` the chunk's fetch. `fused=True` refuses both by
    name, as JAX does."""
    from ..models.zoo import spec_of
    from ..telemetry.dispatch import NullProfiler
    from ..telemetry.events import get_tracer
    from ..telemetry.runtime import record_memory_point
    from ..utils import faultpoints
    from .loop import (TrainState, _fire_step_hook, key_chain,
                       step_ckpt_positions)
    if fused and watchdog is not None:
        raise ValueError(
            "live health monitoring (watchdog) observes at chunk/epoch "
            "boundaries the host controls; fused=True runs all epochs as "
            "ONE device program with no live host — use plain cached mode")
    if fused and getattr(dispatch_profiler, "armed", False):
        raise ValueError(
            "dispatch profiling decomposes the per-step/per-chunk host "
            "boundary; fused=True runs all epochs as ONE device program "
            "with no such boundary — use plain cached or streaming mode")
    if not 0 <= start_epoch <= epochs:
        raise ValueError(f"start_epoch={start_epoch} outside [0, {epochs}]")
    if start_offset < 0:
        raise ValueError(f"start_offset={start_offset} must be >= 0")
    if fused and (ckpt_every_steps or step_hook is not None or start_offset):
        raise ValueError(
            "step-granular checkpointing (ckpt_every_steps/step_hook/"
            "start_offset) needs per-chunk host control; fused=True runs "
            "all epochs with no host control between them — use plain "
            "cached mode")
    if kernel == "pallas_epoch" and (ckpt_every_steps or start_offset):
        raise ValueError(
            "step-granular checkpointing chunks the epoch, but kernel "
            "'pallas_epoch' derives its whole epoch's dropout stream from "
            "ONE per-epoch key split — chunking would fork the RNG chain; "
            "use kernel='xla'/'pallas' for step-granular checkpoints")
    if prefetch_depth < 1:
        raise ValueError(f"prefetch_depth must be >= 1; got {prefetch_depth}")
    if fused and prefetch_depth != 1:
        raise ValueError(
            "prefetch_depth pipelines per-epoch index placements; fused=True "
            "places ONE index array for the whole run — there is nothing to "
            "prefetch")
    name, scale = spec_of(model)
    apply = model_apply(model)
    zoo_kw = dict(model=name, param_scale=scale)
    comm_kw = dict(comm=comm, bf16_rounding=bf16_rounding, overlap=overlap,
                   quant_block=quant_block, error_feedback=error_feedback)
    rows = batch_size     # this process's rows a step
    if mesh is not None:
        mesh = as_mesh(mesh)
        if batch_size % replicas(mesh):
            raise ValueError(
                f"fit_cached: global batch {batch_size} does not divide over "
                f"the {replicas(mesh)} replicas of the mesh — pass batch_size "
                f"= per-replica batch x {replicas(mesh)}")
        check_dp_run_args(mesh, kernel, dtype, 1, 1, impl, ring, **comm_kw,
                          **zoo_kw)
        rows = batch_size // world_size(mesh)
    else:
        check_ring(ring, kernel, 1)
        check_model(name, scale, kernel)
        if comm != "pmean" or overlap:
            raise ValueError(
                f"comm={comm!r} overlap={overlap} selects the DP gradient "
                f"collective; it needs a mesh (mesh=, --parallel)")
    device = next(model.parameters()).device
    x_all = torch.from_numpy(resident_images(x_train)).to(device)
    y_all = torch.from_numpy(np.asarray(y_train, np.int32)).to(device)
    x_test_dev = torch.as_tensor(np.asarray(x_test), device=device)
    y_test_dev = torch.as_tensor(np.asarray(y_test), device=device)
    params = _clone(model.params())
    history: List[np.ndarray] = []
    fit_cached.comm = None
    run_epochs = range(start_epoch, epochs)
    tracer = get_tracer()     # a NullTracer unless --telemetry enabled it

    if fused:
        if not run_epochs:
            return key, history
        idxs = []
        for epoch in run_epochs:
            sampler.set_epoch(epoch)
            idxs.append(epoch_rows(sampler, batch_size, mesh))
        run = (make_run_fn(lr, dtype=dtype, kernel=kernel, snapshots=True,
                           impl=impl, **zoo_kw) if mesh is None else
               make_dp_run_fn(mesh, lr, dtype=dtype, kernel=kernel,
                              snapshots=True, ring=ring, impl=impl,
                              **comm_kw, **zoo_kw))
        t0 = time.perf_counter()
        args = () if mesh is None else (resid,)
        params, key, losses, (p_snaps, k_snaps) = run(
            params, key, x_all, y_all, np.stack(idxs), *args)
        fit_cached.comm = getattr(run, "comm", None)
        losses = losses.cpu().numpy()      # the run's one fetch
        per_epoch_dt = (time.perf_counter() - t0) / len(run_epochs)
        tracer.complete_span("fused_run", time.perf_counter() - t0,
                             epochs=len(run_epochs), steps=int(losses.size))
        per_sample, correct = _snapshot_eval(p_snaps, apply, x_test_dev,
                                             y_test_dev)
        for i, epoch in enumerate(run_epochs):
            val = val_summary(per_sample[i], correct[i], batch_size,
                              perm=eval_perm(epoch) if eval_perm else None)
            log(epoch_summary(epoch, losses[i], batch_size, val,
                              per_epoch_dt))
            history.append(losses[i])
            if epoch_hook is not None:
                # this epoch's params and key (no per-epoch residual)
                _load_params(model, {n: {k: v[i] for k, v in layer.items()}
                                     for n, layer in p_snaps.items()})
                epoch_hook(epoch, TrainState(model, k_snaps[i]))
        _load_params(model, params)
        return key, history

    steps = None     # the captured step, one for the whole fit
    captured = kernel != "pallas_epoch" and graphs.on_one_device(mesh, device)
    record = None
    nsteps = math.ceil(len(sampler) / batch_size)
    if start_epoch < epochs and start_offset >= nsteps:
        raise ValueError(f"start_offset={start_offset} >= the epoch's "
                         f"{nsteps} steps (a committed step checkpoint never "
                         f"records a full-epoch offset)")
    if captured:
        dp = None
        if mesh is not None:
            dp = collectives.DPComm(mesh, lr, **comm_kw)
            dp.place_state(params, resid)
            fit_cached.comm = dp
        steps = CachedSteps(params, x_all, y_all, (nsteps, rows), lr, kernel,
                            _compute_dtype(dtype), mesh, comm=dp,
                            apply=apply)
    else:
        epoch_fn = (make_epoch_fn(lr, dtype=dtype, kernel=kernel, impl=impl,
                                  **zoo_kw)
                    if mesh is None else
                    make_dp_epoch_fn(mesh, lr, dtype=dtype, kernel=kernel,
                                     ring=ring, impl=impl, **comm_kw,
                                     **zoo_kw))
    if mesh is not None and kernel != "pallas_epoch":
        record = make_ddp_comm_recorder(
            mesh, collectives.DPComm(mesh, lr, **comm_kw), params)

    def epoch_indices():
        for epoch in run_epochs:
            sampler.set_epoch(epoch)
            yield epoch_rows(sampler, batch_size, mesh)

    def current_resid():
        comm_now = fit_cached.comm
        return comm_now.resid if comm_now is not None else resid

    hooked = step_hook is not None and ckpt_every_steps
    prof = (dispatch_profiler if dispatch_profiler is not None
            else NullProfiler())
    # the epochs' index arrays, `prefetch_depth` ahead: made on the host
    # for the captured step (its static buffer takes them when the epoch
    # starts), copied to the device for the other paths
    placed = prefetch(epoch_indices(), depth=prefetch_depth,
                      put=(lambda idx: idx) if captured else
                      (lambda idx: _to_device(idx, device)))
    for epoch, idx in zip(run_epochs, placed):
        with tracer.span("epoch", epoch=epoch):
            t0 = time.perf_counter()
            offset = start_offset if epoch == start_epoch else 0
            if steps is not None:
                chain = (key_chain(key, nsteps - offset)
                         if hooked or watchdog is not None else None)
                epoch_key = steps.load(key, idx, offset)
            parts = []
            for c0, c1 in _chunks(offset, nsteps, ckpt_every_steps):
                # the chunk boundary is this trainer's step boundary
                prof.mark_prestep()
                t_chunk = time.perf_counter()
                prof.begin_dispatch(params)
                if steps is not None:
                    part = steps.run(c0, c1)
                    key = chain[c1 - offset - 1] if chain else epoch_key
                elif mesh is None:
                    params, key, part = epoch_fn(params, key, x_all, y_all,
                                                 idx[c0:c1])
                else:
                    params, key, part = epoch_fn(params, key, x_all, y_all,
                                                 idx[c0:c1], current_resid())
                    fit_cached.comm = epoch_fn.comm
                prof.end_dispatch(epoch * nsteps + c0)
                t_sync = time.perf_counter()
                part = part.cpu().numpy()      # the chunk's one fetch
                prof.note_sync_wait(time.perf_counter() - t_sync)
                part = faultpoints.poison_array(
                    "loss", part, first_step=epoch * nsteps + c0 + 1,
                    epoch=epoch)
                parts.append(part)
                if hooked or watchdog is not None:
                    _load_params(model, params)
                if hooked:
                    _fire_step_hook(step_hook, ckpt_every_steps, nsteps,
                                    epoch, c1 - 1,
                                    TrainState(model, key, current_resid()))
                # after the hook: a kill at step K never races step K's save
                faultpoints.fire("step", step=epoch * nsteps + c1,
                                 epoch=epoch)
                if watchdog is not None:
                    ck_ep, ck_off = step_ckpt_positions(nsteps, epoch,
                                                        c1 - 1)
                    watchdog.observe(
                        part, state=TrainState(model, key, current_resid()),
                        epoch=epoch, step=epoch * nsteps + c1,
                        ckpt_epoch=ck_ep, ckpt_offset=ck_off,
                        dt_s=time.perf_counter() - t_chunk,
                        imgs=part.size * batch_size)
            if steps is not None:
                key = epoch_key
            losses = np.concatenate(parts)
            tracer.complete_span("step_compute", time.perf_counter() - t0,
                                 steps=int(losses.size))
            prof.flush_epoch(epoch, steps=len(parts))
            if record is not None:
                record(losses.size, params)
            _load_params(model, params)
            t_eval = time.perf_counter()
            val = evaluate(model, x_test_dev, y_test_dev, batch_size,
                           perm=eval_perm(epoch) if eval_perm else None)
            tracer.complete_span("eval", time.perf_counter() - t_eval)
            record_memory_point(tracer)
            log(epoch_summary(epoch, losses, batch_size, val,
                              time.perf_counter() - t0))
            history.append(losses)
            if epoch_hook is not None:
                epoch_hook(epoch, TrainState(model, key, current_resid()))
    return key, history


fit_cached.comm = None


def _snapshot_eval(p_snaps, apply, x_test, y_test):
    """Per-epoch eval of stacked params snapshots, fetched: the reference
    MLP's batched program (loop.py `make_snapshot_eval_step`), a zoo
    model's forward a snapshot at a time."""
    if apply is mlp_apply and tuple(p_snaps["fc1"]["w"].shape[1:]) == (
            784, 128):
        per_sample, correct = make_snapshot_eval_step()(p_snaps, x_test,
                                                        y_test)
        return per_sample.cpu().numpy(), correct.cpu().numpy()
    epochs = next(iter(next(iter(p_snaps.values())).values())).shape[0]
    outs = []
    for e in range(epochs):
        params = {n: {k: v[e] for k, v in layer.items()}
                  for n, layer in p_snaps.items()}
        logits = apply(params, x_test, train=False)
        logz = torch.log_softmax(logits.float(), dim=-1)
        per = -torch.gather(logz, -1, y_test.long()[:, None])[:, 0]
        outs.append((per, (torch.argmax(logits, dim=-1)
                           == y_test.long()).float()))
    return (torch.stack([o[0] for o in outs]).cpu().numpy(),
            torch.stack([o[1] for o in outs]).cpu().numpy())
