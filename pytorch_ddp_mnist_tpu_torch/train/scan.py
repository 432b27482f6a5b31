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
dataset on its device and takes its index rows from its own sampler
shard: the idxs of `make_dp_run_fn` are then this process's, (E, S, L*B)
for its L local replicas. The per-step kernels fold the GLOBAL replica
index into the key and take the world's fixed-order mean
(parallel/ddp.py `world_mean`), so a world is bitwise the single-process
mesh of as many replicas fed the world's rows in rank order. A world,
one rank too, and a mesh across cards run their steps in an eager host
loop (`_dp_steps_epoch`) on the same (S, n, 2) key table: a world's mean
is a collective (over gloo through the host).
`pallas_epoch` across processes is refused by name: K6's ring runs among
the replicas of one cooperative launch (ROADMAP.md queue 2, item 6).

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
from ..models.mlp import MLP
from ..ops import threefry
from ..ops.epoch_step import RINGS, epoch_fused_sgd
from ..ops.fused_step import (fused_loss_and_grads_keyed,
                              fused_loss_and_grads_rng, keyed_dropout_mask)
from ..ops.sgd import sgd_step
from ..parallel.ddp import (on_device, replica_mean, replicate_state,
                            validate_comm, world_mean)
from ..parallel.mesh import as_mesh, first_replica, replicas, world_size
from . import graphs
from .loop import (_to_device, epoch_summary, evaluate,
                   make_snapshot_eval_step, val_summary, xla_loss_and_grads)

__all__ = ["device_normalize", "resident_images", "epoch_batch_indices",
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


def _loss_and_grads(params, x_all, y_all, rows, key, kernel, compute_dt):
    """One step's (loss, grads) on the gathered `rows` with the dropout of
    `key`, a row of the epoch's key table on the device, which every kernel
    reads there: `pallas` draws the mask in the kernel, `pallas_rng` takes
    word 0 as the kernel's seed, `xla` draws `dropout_mask` of the key with
    the mask entry."""
    x = _gathered_x(x_all, rows, compute_dt)
    y = y_all.index_select(0, rows)
    if kernel == "pallas":
        return fused_loss_and_grads_keyed(params, x, y, key)
    if kernel == "pallas_rng":
        return fused_loss_and_grads_rng(params, x, y, key)
    mask = keyed_dropout_mask(key, rows.shape[0], x.device)
    return xla_loss_and_grads(params, x, y, mask > 0)


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
    mesh)."""

    def __init__(self, params, x_all, y_all, idx_shape, lr: float,
                 kernel: str, compute_dt, mesh=None, *, eager: bool = False):
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

        def step_grads(params, step_rows, words):
            if mesh is None:
                return _loss_and_grads(params, x_all, y_all, step_rows, words,
                                       kernel, compute_dt)
            batch = rows // len(mesh)
            losses, grads = [], []
            for r in range(len(mesh)):
                loss, g = _loss_and_grads(
                    params, x_all, y_all,
                    step_rows[r * batch:(r + 1) * batch], words[r], kernel,
                    compute_dt)
                losses.append(loss)
                grads.append(g)
            return world_mean(mesh, losses, grads, device)

        def body(params, cursor, losses):
            at = cursor.view(1)
            loss, grads = step_grads(params, idx.index_select(0, at)[0],
                                     keys.index_select(0, at)[0])
            sgd_step(params, grads, lr)
            losses.index_copy_(0, at, loss.reshape(1))
            cursor.add_(1)

        where = "" if mesh is None else f" over {len(mesh)} replicas"
        self.loop = graphs.StepLoop(
            body, params, nsteps, device,
            capture=device.type == "cuda" and not eager,
            what=f"the cached {kernel} step ({compute_dt}){where}")

    def epoch(self, key, idx):
        key, words = threefry.step_key_words(key, self.loop.nsteps, self.fold)
        self.idx.load(np.asarray(idx, np.int32))
        self.keys.load(words)
        return key, self.loop.epoch()


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
    iteration, the same bits. The per-step kernels run one captured step a
    step on a card, one capture a run (`CachedSteps`)."""
    check_run_args(kernel, dtype, unroll, superstep, impl)
    compute_dt = _compute_dtype(dtype)

    def run(params, key, x_all, y_all, idxs):
        params = _clone(params)
        idxs = np.asarray(idxs, np.int32)
        if kernel == "pallas_epoch":
            idx_dev = _to_device(idxs, x_all.device)
        else:
            steps = CachedSteps(params, x_all, y_all, idxs.shape[1:], lr,
                                kernel, compute_dt)
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
                  impl: str = "threefry2x32") -> Callable:
    """One epoch: epoch(params, key, x_all, y_all, idx (S, B)) -> (params',
    key', losses (S,)), the one-element case of make_run_fn."""
    run = make_run_fn(lr, dtype=dtype, kernel=kernel, impl=impl)

    def epoch(params, key, x_all, y_all, idx):
        params, key, losses = run(params, key, x_all, y_all,
                                  np.asarray(idx)[None])
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


def _dp_steps_epoch(mesh, params, key, data, idx_e, lr, kernel, compute_dt):
    """One epoch of per-step DP calls in an eager host loop, for a world of
    processes and a mesh across cards: per step `key, sub = split(key)`,
    local replica r takes shard r of the step's rows with the dropout of
    `fold_in(sub, g)`, g its global index, read from row (s, r) of the
    epoch's (S, n, 2) key table, built before the first step; then SGD in
    place on `params` with the world's fixed-order mean gradient. Returns
    (key, losses (S,), the world's mean per step)."""
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
                                      kernel, compute_dt)
            step_losses.append(loss)
            grads.append(g)
        loss, mean = world_mean(mesh, step_losses, grads, device)
        sgd_step(params, mean, lr)
        losses.append(loss)
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
                      comm: str) -> None:
    """The DP scan layer's refusals, by name: those of `check_run_args`,
    the ring's, the comm strategy's, a superstep on a multi-replica mesh
    (JAX `make_dp_run_fn`), and the epoch kernel across processes."""
    check_run_args(kernel, dtype, unroll, superstep, impl)
    if kernel == "pallas_epoch" and world_size(mesh) > 1:
        raise ValueError(
            f"kernel='pallas_epoch' across a world of {world_size(mesh)} "
            f"processes: the DP epoch kernel's ring (K6) runs among the "
            f"replicas of one cooperative launch, and across processes it "
            f"needs peer or IPC pointers and co-resident launches "
            f"(ROADMAP.md queue 2, item 6). Use kernel='pallas'")
    n = len(mesh)
    check_ring(ring, kernel, n)
    validate_comm(comm)
    if superstep != 1 and n > 1:
        raise ValueError(
            f"superstep={superstep} is single-replica only (the DP ring's "
            f"per-iteration handshake); use superstep=1 on the {n}-device "
            f"mesh")


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
                   comm: str = "pmean",
                   impl: str = "threefry2x32") -> Callable:
    """The whole E-epoch DP run over `mesh` (a tuple of replica devices, or
    a WorldMesh of this process's): run(params, key, x_all, y_all, idxs
    (E, S, n*B)) -> (params', key', losses (E, S)) or, with `snapshots`,
    also (p_snaps, [keys]), as `make_run_fn`; n is the local replicas and
    idxs this process's rows. The losses are the world's mean per step;
    params' lies on x_all's device. `ring` (kernel 'pallas_epoch' on n > 1
    replicas) picks K6's allreduce; `superstep` is single-replica only;
    `comm` must be 'pmean'. The per-step kernels on a mesh whose replicas
    share x_all's device run one captured step a step (`CachedSteps`; a
    world and a mesh across cards, `_dp_steps_epoch`)."""
    mesh = as_mesh(mesh)
    check_dp_run_args(mesh, kernel, dtype, unroll, superstep, impl, ring,
                      comm)
    compute_dt = _compute_dtype(dtype)

    def run(params, key, x_all, y_all, idxs):
        device = x_all.device
        params = _clone(params)
        idxs = np.asarray(idxs, np.int32)
        if kernel != "pallas_epoch" and graphs.on_one_device(mesh, device):
            steps = CachedSteps(params, x_all, y_all, idxs.shape[1:], lr,
                                kernel, compute_dt, mesh)
        else:
            steps = None
            idx_dev = _to_device(idxs, device)
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
                                          idx_dev[e], lr, kernel, compute_dt)
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


def make_dp_epoch_fn(mesh, lr: float, *, dtype: str = "float32",
                     kernel: str = "xla", ring: str = "auto",
                     comm: str = "pmean",
                     impl: str = "threefry2x32") -> Callable:
    """One DP epoch: epoch(params, key, x_all, y_all, idx (S, n*B)) ->
    (params', key', losses (S,)), the one-element case of make_dp_run_fn."""
    run = make_dp_run_fn(mesh, lr, dtype=dtype, kernel=kernel, ring=ring,
                         comm=comm, impl=impl)

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
               dtype: str = "float32", mesh=None, ring: str = "auto",
               comm: str = "pmean", ckpt_every_steps: int = 0,
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

    `mesh` (a tuple of replica devices, or a WorldMesh, parallel/mesh.py)
    trains data parallel (`make_dp_run_fn`): `batch_size` is then the
    GLOBAL batch, `n` replicas of `batch_size // n` rows each over the
    world, and the model's device holds the dataset and the eval. In a
    world of W processes `sampler` is this process's shard and gives
    `batch_size // W` rows a step. `ring` picks K6's allreduce; `comm` must
    be 'pmean' (the other strategies are refused by name).

    The per-step kernels run one captured step a step on a card, one
    capture a fit (`CachedSteps`; `fused=True`: one a run of
    make_run_fn).

    The JAX trainer's step-granular checkpoints, live watchdog and
    dispatch profiler are not ported yet and are refused by name."""
    refused = [
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
    rows = batch_size     # this process's rows a step
    if mesh is not None:
        mesh = as_mesh(mesh)
        if batch_size % replicas(mesh):
            raise ValueError(
                f"fit_cached: global batch {batch_size} does not divide over "
                f"the {replicas(mesh)} replicas of the mesh — pass batch_size "
                f"= per-replica batch x {replicas(mesh)}")
        check_dp_run_args(mesh, kernel, dtype, 1, 1, impl, ring, comm)
        rows = batch_size // world_size(mesh)
    else:
        check_ring(ring, kernel, 1)
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
            idxs.append(epoch_batch_indices(sampler, rows))
        run = (make_run_fn(lr, dtype=dtype, kernel=kernel, snapshots=True,
                           impl=impl) if mesh is None else
               make_dp_run_fn(mesh, lr, dtype=dtype, kernel=kernel,
                              snapshots=True, ring=ring, impl=impl))
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

    steps = None     # the captured step, one for the whole fit
    if kernel != "pallas_epoch" and graphs.on_one_device(mesh, device):
        nsteps = math.ceil(len(sampler) / rows)
        steps = CachedSteps(params, x_all, y_all, (nsteps, rows), lr, kernel,
                            _compute_dtype(dtype), mesh)
    else:
        epoch_fn = (make_epoch_fn(lr, dtype=dtype, kernel=kernel, impl=impl)
                    if mesh is None else
                    make_dp_epoch_fn(mesh, lr, dtype=dtype, kernel=kernel,
                                     ring=ring, impl=impl))
    for epoch in range(epochs):
        t0 = time.perf_counter()
        sampler.set_epoch(epoch)
        idx = epoch_batch_indices(sampler, rows)
        if steps is not None:
            key, losses = steps.epoch(key, idx)
        else:
            params, key, losses = epoch_fn(params, key, x_all, y_all, idx)
        losses = losses.cpu().numpy()      # the epoch's one fetch
        _load_params(model, params)
        val = evaluate(model, x_test_dev, y_test_dev, batch_size)
        log(epoch_summary(epoch, losses, batch_size, val,
                          time.perf_counter() - t0))
        history.append(losses)
    return key, history
