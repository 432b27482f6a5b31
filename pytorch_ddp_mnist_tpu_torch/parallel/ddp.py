"""Data-parallel training over a mesh of one process or of a world of
processes: the DDP analog (port of the `comm="pmean"` subset of
`pytorch_ddp_mnist_tpu/parallel/ddp.py`).

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

Across processes (a `WorldMesh`, parallel/mesh.py, after
parallel/wireup.py formed the process group) each process runs its local
replicas, replica r keyed by `fold_in(sub, global index of r)`, and
`world_mean` takes the mean over the whole world in the same fixed global
order: every process's flat buffer of grads and loss is all-gathered, then
summed `tot = v0; tot = tot + v1; ...` and scaled by f32(1/n), so the world
is bitwise the single-process mesh of as many replicas on the same rows.
No gradient goes through `dist.all_reduce`, whose order the backend picks.
Every process builds its params from the same seed; `check_replicated`
holds them equal at start-up.

The other gradient-communication strategies (`sharded`, `bf16`, `int8`,
`overlap`) are refused by name (ROADMAP.md queue 1, item 11).
"""

from __future__ import annotations

from typing import Callable, Sequence

import hashlib

import numpy as np
import torch

from ..ops.fused_step import KeyedStep, keyed_dropout_mask
from ..ops.sgd import sgd_step
from .mesh import (DATA_AXIS, Mesh, WorldMesh, as_mesh, data_parallel_mesh,
                   first_replica, replicas, world_size)

__all__ = ["DATA_AXIS", "dp_mesh", "shard_batch", "global_batch_from_local",
           "replicate_state", "check_replicated", "replica_mean",
           "world_mean", "validate_comm", "dp_step", "dp_keyed_step",
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
    """This process's batch (its sampler shard's rows) as its local
    replicas' shards. In the JAX package it stitches every process's local
    rows into one global array; here each process keeps its own rows, and
    the global batch exists only as the world's rows in rank order (what
    `world_mean` averages over). It is `shard_batch` over the local
    replicas, with the same named error for a ragged batch."""
    return shard_batch(mesh, local_batch)


def _digest(tree) -> str:
    h = hashlib.sha256()
    for name in sorted(tree):
        layer = tree[name]
        for k in (sorted(layer) if isinstance(layer, dict) else [None]):
            a = layer[k] if k is not None else layer
            h.update(np.ascontiguousarray(
                torch.as_tensor(a).detach().cpu().numpy()).tobytes())
    return h.hexdigest()


def check_replicated(mesh: Mesh, tree) -> None:
    """In a world of processes, gather a checksum of `tree` (every process
    built it from the same seed) and raise, naming the ranks, if any
    process's differs. A single process has nothing to check."""
    if world_size(mesh) == 1:
        return
    import torch.distributed as dist
    digests = [None] * world_size(mesh)
    dist.all_gather_object(digests, _digest(tree))
    bad = [r for r, d in enumerate(digests) if d != digests[0]]
    if bad:
        raise RuntimeError(
            f"the initial params differ across the world: rank(s) {bad} hold "
            f"other params than rank 0 (every rank builds them from the "
            f"same --seed; check that every rank got the same arguments)")


def replicate_state(mesh: Mesh, tree) -> list:
    """One copy of `tree` (a tensor, array or params tree) per local
    replica, on its device: the DDP construction-time broadcast. Every
    replica gets its own tensors, so a replica's in-place update never
    touches another's. In a world of processes every process builds `tree`
    from the same seed, as in JAX; `check_replicated` holds them equal."""
    check_replicated(mesh, tree)

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
    return tot * _inverse(n, device)


def _inverse(n: int, device) -> torch.Tensor:
    """f32(1/n) as a 0-d tensor on `device`, made by a fill kernel: no
    host-to-device copy, so a step captured in a CUDA graph can make it.
    The bits are those of `torch.tensor(1.0 / n, dtype=torch.float32)`."""
    return torch.full((), 1.0 / n, dtype=torch.float32, device=device)


def world_mean(mesh: Mesh, losses: Sequence, grads: Sequence, device=None):
    """The mean over the world's replicas of each local replica's (loss,
    grads tree), in FIXED global order: (loss, grads) on `device` (default:
    the first grads' device), bitwise `replica_mean` over the same values
    in one process. A single-process mesh is `replica_mean`. On a
    WorldMesh each local replica's five grads and its loss are flattened
    into one f32 buffer (118,273 floats for the reference MLP), the
    buffers are all-gathered over the default process group, and summed
    in global replica order (`tot = v0; tot = tot + v1; ...`) times
    f32(1/n) on `device`. Over NCCL the buffers stay on the card; over gloo
    they go through a host buffer (pinned where `device` is a card), and
    the sum still runs on `device`."""
    names = [(n, k) for n, layer in grads[0].items() for k in layer]
    device = (grads[0][names[0][0]][names[0][1]].device if device is None
              else torch.device(device))
    if not isinstance(mesh, WorldMesh):
        return replica_mean(losses, device), replica_mean(grads, device)
    import torch.distributed as dist
    for g, loss in zip(grads, losses):
        for t in [loss] + [g[n][k] for n, k in names]:
            if t.dtype != torch.float32:
                raise ValueError(f"world_mean averages f32 values; got "
                                 f"{t.dtype}")
    local = torch.stack([
        torch.cat([g[n][k].to(device).reshape(-1) for n, k in names]
                  + [loss.to(device).reshape(1)])
        for g, loss in zip(grads, losses)])
    world = world_size(mesh)
    if dist.get_backend() == "nccl":
        gathered = torch.empty((world,) + tuple(local.shape),
                               dtype=local.dtype, device=device)
        dist.all_gather_into_tensor(gathered, local)
    else:
        host = local.cpu()
        parts = [torch.empty_like(host) for _ in range(world)]
        dist.all_gather(parts, host)
        gathered = torch.stack(parts)
        if device.type == "cuda":
            gathered = gathered.pin_memory().to(device, non_blocking=True)
    rows = gathered.reshape(-1, local.shape[1])
    tot = rows[0]
    for v in rows[1:]:
        tot = tot + v
    tot = tot * _inverse(replicas(mesh), device)
    mean, at = {n: {} for n, _ in names}, 0
    for n, k in names:
        leaf = grads[0][n][k]
        mean[n][k] = tot[at:at + leaf.numel()].reshape(leaf.shape)
        at += leaf.numel()
    return tot[at], mean


def on_device(tree, device):
    """A params tree on `device` (itself where it lies there already)."""
    return {n: {k: v.to(device) for k, v in layer.items()}
            for n, layer in tree.items()}


def _dp_update(mesh: Mesh, lr: float, model, x, y, replica_step):
    """One DP step's body: local replica r takes shard r of this process's
    batch x and `replica_step(r, params on its device, x_r, y_r)` gives its
    (loss, grads); then SGD in place on the model with the world's mean
    gradient (`world_mean`). Returns the world's mean loss."""
    params = model.params()
    losses, grads = [], []
    for r, (xr, yr) in enumerate(shard_batch(mesh, (x, y))):
        loss, g = replica_step(r, on_device(params, mesh[r]), xr, yr)
        losses.append(loss)
        grads.append(g)
    loss, mean = world_mean(mesh, losses, grads, x.device)
    sgd_step(params, mean, lr)
    return loss


def _tag(step, mesh: Mesh):
    step.ddp_comm = "pmean"
    step.ddp_mesh = mesh
    step.ddp_devices = replicas(mesh)
    return step


def dp_keyed_step(mesh: Mesh, lr: float, loss_and_grads: Callable):
    """The streaming DP step whose replicas read their keys from the key
    table (the `pallas` step, and under `dp_step` the `xla` one), as an
    ops/fused_step.py `KeyedStep` whose table folds the local replicas'
    global indices into each step's key: row (s, r) is `fold_in(sub, g)`
    of step s's `sub`, g replica r's global index, and
    `loss_and_grads(params, x, y, words)` takes replica r's row (on its
    device). Then SGD in place on the model with the world's mean gradient
    (`world_mean`), and the loss is the world's mean. Every process splits
    the same replicated key, so no key is exchanged."""
    first = first_replica(mesh)

    def run(model, words, x, y):
        def replica_step(r, params, xr, yr):
            return loss_and_grads(params, xr, yr, words[r].to(mesh[r]))
        return _dp_update(mesh, lr, model, x, y, replica_step)

    return _tag(KeyedStep(run, fold=range(first, first + len(mesh))), mesh)


def dp_step(mesh: Mesh, lr: float, loss_and_grads: Callable) -> KeyedStep:
    """The streaming DP step of a mask input (the `xla` step): as
    `dp_keyed_step`, where replica r's mask is drawn by the mask entry
    reading the key of its table row (s, r) from device memory
    (`keyed_dropout_mask`, bitwise `dropout_mask(fold_in(sub, g))`) and
    `loss_and_grads(params, x, y, mask)` gives its (loss, grads).
    `step(model, key, x, y) -> (key', loss)` splits a host key as the JAX
    step does."""
    def masked(params, x, y, words):
        return loss_and_grads(params, x, y,
                              keyed_dropout_mask(words, x.shape[0], x.device))

    return dp_keyed_step(mesh, lr, masked)


def make_dp_train_step(mesh: Mesh, lr: float, *, dtype: str = "float32",
                       comm: str = "pmean") -> KeyedStep:
    """The DP step with the plain autograd step per replica (JAX
    `make_dp_train_step`, comm='pmean') as a KeyedStep (`dp_step`):
    step(model, key, x, y) -> (key', loss as a 0-d tensor), x (this
    process's batch, 784) on the model's device, split over the mesh's
    local replicas (a WorldMesh: the world's replicas across processes).
    Each replica's forward and backward run in `dtype` (the params cast to
    it, f32 grads), with the keyed dropout of its `fold_in` key, read from
    the key table; the update is SGD on the fixed-order mean."""
    from ..train.loop import xla_loss_and_grads
    validate_comm(comm)
    compute_dt = torch.bfloat16 if dtype == "bfloat16" else torch.float32

    def loss_and_grads(params, x, y, mask):
        return xla_loss_and_grads(params, x.to(compute_dt), y, mask > 0)

    return dp_step(as_mesh(mesh), lr, loss_and_grads)
