"""Data-parallel training over a single-process mesh: the DDP analog (port
of the `comm="pmean"` subset of `pytorch_ddp_mnist_tpu/parallel/ddp.py`).

The reference semantics, as the JAX package reproduces them:
  * the params are replicated on every replica;
  * per step, each replica computes its gradients on its shard of the
    global batch with its OWN dropout mask (the replica index is folded
    into the step key: `fold_in(sub, r)`), and the gradients are AVERAGED
    across replicas (DDP's allreduce-mean);
  * the optimizer runs on identical averaged gradients, so the replicas
    stay identical.

The mean is taken in a FIXED origin order, `tot = g0; tot = tot + g1; ...`
times f32(1/n) (`replica_mean`), the order of the whole-epoch kernel's
all-gather ring, so every run gives the same bits. The JAX package's
`pmean` is an XLA all-reduce in an order of XLA's choosing divided by n:
the two agree to f32 rounding, not bitwise.

A mesh here is `parallel/mesh.py`'s tuple of replica devices. Its replicas
may share a device: then the replicated params are one set of tensors,
which the step updates in place (SGD is redundant per replica in DDP; on
one device the redundant copies would be the same bits). Replicas on other
devices than the model's get a copy of the params each step.

The other gradient-communication strategies (`sharded`, `bf16`, `int8`,
`overlap`) are refused by name (ROADMAP.md queue 1, item 11); the
process-level world (wireup, gloo, NCCL) is queue 1, item 6b.
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch

from ..ops import threefry
from ..ops.fused_step import dropout_mask
from ..ops.sgd import sgd_step
from .mesh import DATA_AXIS, Mesh, data_parallel_mesh

__all__ = ["DATA_AXIS", "dp_mesh", "shard_batch", "global_batch_from_local",
           "replicate_state", "replica_mean", "validate_comm",
           "make_dp_train_step"]

COMMS = ("pmean", "sharded", "bf16", "int8")


def dp_mesh(devices: Sequence | None = None) -> Mesh:
    return data_parallel_mesh(devices)


def validate_comm(comm: str) -> None:
    """Only the pmean strategy is ported; the others exit by name."""
    if comm == "pmean":
        return
    if comm in COMMS:
        raise ValueError(f"comm={comm!r} is not ported to the PyTorch package "
                         f"yet; see ROADMAP.md queue 1, item 11 (gradient "
                         f"communication). Use comm='pmean'")
    raise ValueError(f"comm must be one of {COMMS}; got {comm!r}")


def _check_batch_divisible(n_rows: int, n_shards: int, what: str) -> None:
    if n_rows % n_shards:
        raise ValueError(
            f"{what}: batch of {n_rows} rows does not divide over "
            f"{n_shards} device(s) of the 'dp' mesh — use a batch size "
            f"divisible by {n_shards}, or pad/drop the ragged final batch "
            f"(the BatchLoader wrap-pad does this)")


def _leaves(batch):
    return list(batch) if isinstance(batch, (tuple, list)) else [batch]


def shard_batch(mesh: Mesh, batch) -> list:
    """Split a batch (a tensor or array, or a tuple/list of them) along dim
    0 into len(mesh) consecutive shards, shard r on mesh[r]: the JAX
    package's P('dp') sharding. Returns one batch per replica, of the
    input's structure. A leading dim that does not divide raises a
    ValueError naming the sizes."""
    n = len(mesh)
    leaves = [torch.as_tensor(a) for a in _leaves(batch)]
    for a in leaves:
        _check_batch_divisible(int(a.shape[0]), n, "shard_batch")
    out = []
    for r, dev in enumerate(mesh):
        parts = [a[r * (a.shape[0] // n):(r + 1) * (a.shape[0] // n)].to(dev)
                 for a in leaves]
        out.append(type(batch)(parts) if isinstance(batch, (tuple, list))
                   else parts[0])
    return out


def global_batch_from_local(mesh: Mesh, local_batch) -> list:
    """This process's batch as the mesh's per-replica shards. In the JAX
    package it stitches every process's local rows into one global array;
    a single process's mesh is all local, so it is `shard_batch` (with the
    same named error for a ragged batch)."""
    return shard_batch(mesh, local_batch)


def replicate_state(mesh: Mesh, tree) -> list:
    """One copy of `tree` (a tensor, array or params tree) per replica, on
    its device: the DDP construction-time broadcast. Every replica gets its
    own tensors, so a replica's in-place update never touches another's."""
    def place(a, dev):
        if isinstance(a, dict):
            return {k: place(v, dev) for k, v in a.items()}
        if isinstance(a, np.ndarray):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        return a.detach().to(dev, copy=True)
    return [place(tree, dev) for dev in mesh]


def replica_mean(values: Sequence, device=None):
    """The mean over replicas of tensors or params trees, in FIXED origin
    order: tot = v0; tot = tot + v1; ...; tot * f32(1/n), on `device`
    (default: the first value's). The whole-epoch kernel's all-gather ring
    sums in this order."""
    n = len(values)
    if isinstance(values[0], dict):
        return {k: replica_mean([v[k] for v in values], device)
                for k in values[0]}
    device = values[0].device if device is None else torch.device(device)
    tot = values[0].to(device)
    for v in values[1:]:
        tot = tot + v.to(device)
    return tot * torch.tensor(1.0 / n, dtype=torch.float32, device=device)


def on_device(tree, device):
    """A params tree on `device` (itself where it lies there already)."""
    return {n: {k: v.to(device) for k, v in layer.items()}
            for n, layer in tree.items()}


def dp_step(mesh: Mesh, lr: float, loss_and_grads: Callable) -> Callable:
    """The shared body of the streaming DP steps: step(model, key, x, y) ->
    (key', loss). `key, sub = split(key)`; replica r takes shard r of the
    global batch and the mask of `fold_in(sub, r)`, and
    `loss_and_grads(params, x, y, mask, device)` gives its (loss, grads);
    then SGD in place on the model with the replicas' mean gradient, and
    the loss is the replicas' mean."""
    def step(model, key, x, y):
        key, sub = threefry.split(key)
        params = model.params()
        losses, grads = [], []
        for r, (xr, yr) in enumerate(shard_batch(mesh, (x, y))):
            mask = dropout_mask(threefry.fold_in(sub, r), xr.shape[0],
                                xr.device)
            loss, g = loss_and_grads(on_device(params, mesh[r]), xr, yr,
                                     mask)
            losses.append(loss)
            grads.append(g)
        device = x.device
        sgd_step(params, replica_mean(grads, device), lr)
        return key, replica_mean(losses, device)

    step.ddp_comm = "pmean"
    step.ddp_mesh = mesh
    step.ddp_devices = len(mesh)
    return step


def make_dp_train_step(mesh: Mesh, lr: float, *, dtype: str = "float32",
                       comm: str = "pmean") -> Callable:
    """The DP step with the plain autograd step per replica (JAX
    `make_dp_train_step`, comm='pmean'): step(model, key, x, y) -> (key',
    loss as a 0-d tensor), x (global_batch, 784) on the model's device,
    split over the mesh. Each replica's forward and backward run in
    `dtype` (the params cast to it, f32 grads), with the keyed dropout of
    its `fold_in` key; the update is SGD on the fixed-order mean."""
    from ..train.loop import xla_loss_and_grads
    validate_comm(comm)
    compute_dt = torch.bfloat16 if dtype == "bfloat16" else torch.float32

    def loss_and_grads(params, x, y, mask):
        return xla_loss_and_grads(params, x.to(compute_dt), y, mask > 0)

    return dp_step(tuple(mesh), lr, loss_and_grads)
