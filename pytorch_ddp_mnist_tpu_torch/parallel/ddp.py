"""Data-parallel training over a mesh of one process or of a world of
processes: the DDP analog (port of `pytorch_ddp_mnist_tpu/parallel/ddp.py`).

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

The gradient-communication strategy is selectable (`comm=`, `--ddp_comm`):
`pmean` above, `sharded`, `bf16` and `int8`, each optionally bucketed
(`overlap`); parallel/collectives.py `DPComm` runs them on the mesh and
across a world's ranks in the same fixed order. The step keeps JAX's key
derivation: replica r's key is `fold_in(sub, r)` (the key table's row),
and the bf16 strategy's stochastic-rounding key `fold_in(rkey, 7)`. The
int8 strategy's residual is comm state: `step.place_comm_state(params)`
makes it, and the step updates it in place.
"""

from __future__ import annotations

from typing import Callable, Sequence

import hashlib

import numpy as np
import torch

from ..ops.fused_step import KeyedStep
from . import collectives
from .collectives import validate_comm
from .mesh import (DATA_AXIS, Mesh, WorldMesh, as_mesh, data_parallel_mesh,
                   first_replica, replicas, world_size)

__all__ = ["DATA_AXIS", "dp_mesh", "shard_batch", "global_batch_from_local",
           "replicate_state", "check_replicated", "replica_mean",
           "world_mean", "validate_comm", "dp_step", "dp_keyed_step",
           "make_dp_train_step", "make_ddp_comm_recorder"]


def dp_mesh(devices: Sequence | None = None) -> Mesh:
    return data_parallel_mesh(devices)


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


def _dp_update(mesh: Mesh, comm, model, x, y, words, replica_step):
    """One DP step's body: local replica r takes shard r of this process's
    batch x and `replica_step(r, params on its device, x_r, y_r)` gives its
    (loss, grads); then `comm` (a collectives.DPComm) takes the world's
    strategy mean and writes SGD into the model in place. Returns the
    world's mean loss."""
    params = model.params()
    losses, grads = [], []
    for r, (xr, yr) in enumerate(shard_batch(mesh, (x, y))):
        loss, g = replica_step(r, on_device(params, mesh[r]), xr, yr)
        losses.append(loss)
        grads.append(g)
    return comm.update(params, losses, grads, words)


def _tag(step, mesh: Mesh, comm):
    """The metadata the loops and the telemetry read off a DP step (the
    JAX step's `ddp_*` attributes), and its comm state's placement."""
    step.comm = comm
    step.ddp_comm = comm.comm
    step.ddp_mesh = mesh
    step.ddp_devices = replicas(mesh)
    step.ddp_quant_block = comm.quant_block
    step.ddp_bucket_elems = comm.bucket_elems
    step.ddp_overlap = comm.overlap
    step.comm_state = comm.stateful
    step.cost_label = collectives.step_cost_label(comm.comm, comm.overlap)
    step.place_comm_state = comm.place_state

    def collective_schedule(params):
        return collectives.collective_schedule(
            params, replicas(mesh), comm.comm, overlap=comm.overlap,
            bucket_elems=comm.bucket_elems, quant_block=comm.quant_block)

    step.collective_schedule = collective_schedule
    return step


def dp_keyed_step(mesh: Mesh, lr: float, loss_and_grads: Callable,
                  comm=None):
    """The streaming DP step whose replicas read their keys from the key
    table (the `pallas` step, and under `dp_step` the `xla` one), as an
    ops/fused_step.py `KeyedStep` whose table folds the local replicas'
    global indices into each step's key: row (s, r) is `fold_in(sub, g)`
    of step s's `sub`, g replica r's global index, and
    `loss_and_grads(params, x, y, words)` takes replica r's row (on its
    device). Then `comm` (a collectives.DPComm; default pmean) takes the
    world's mean gradient by its strategy and writes SGD into the model in
    place; the loss is the world's mean. Every process splits the same
    replicated key, so no key is exchanged."""
    first = first_replica(mesh)
    comm = comm if comm is not None else collectives.DPComm(mesh, lr)

    def run(model, words, x, y):
        def replica_step(r, params, xr, yr):
            return loss_and_grads(params, xr, yr, words[r].to(mesh[r]))
        return _dp_update(mesh, comm, model, x, y, words, replica_step)

    return _tag(KeyedStep(run, fold=range(first, first + len(mesh))), mesh,
                comm)


def dp_step(mesh: Mesh, lr: float, loss_and_grads: Callable,
            comm=None, width: int = 128) -> KeyedStep:
    """The streaming DP step of a mask input (the `xla` step): as
    `dp_keyed_step`, where replica r's pre-scaled (B, `width`) mask is
    drawn from the key of its table row (s, r) in device memory (the mask
    entry `keyed_dropout_mask` at width 128, bitwise
    `dropout_mask(fold_in(sub, g))`; a zoo model's other widths in plain
    tensor ops, train/loop.py `keyed_keep`) and `loss_and_grads(params, x,
    y, mask)` gives its (loss, grads). `step(model, key, x, y) -> (key',
    loss)` splits a host key as the JAX step does."""
    from ..ops.fused_step import keyed_dropout_mask
    from ..train.loop import keyed_keep

    def mask_of(words, batch, device):
        if width == 128:
            return keyed_dropout_mask(words, batch, device)
        keep = keyed_keep(words, batch, width, device)
        return torch.where(keep, torch.full((), 1.25, device=device),
                           torch.zeros((), device=device))

    def masked(params, x, y, words):
        return loss_and_grads(params, x, y,
                              mask_of(words, x.shape[0], x.device))

    return dp_keyed_step(mesh, lr, masked, comm)


def make_dp_train_step(mesh: Mesh, lr: float, *, dtype: str = "float32",
                       comm: str = "pmean", bf16_rounding: str = "nearest",
                       overlap: bool = False, quant_block: int | None = None,
                       error_feedback: bool = True,
                       bucket_elems: int | None = None,
                       model: str = "mlp", param_scale: int = 1) -> KeyedStep:
    """The DP step with the plain autograd step per replica (JAX
    `make_dp_train_step`) as a KeyedStep (`dp_step`): step(model, key, x,
    y) -> (key', loss as a 0-d tensor), x (this process's batch, 784) on
    the model's device, split over the mesh's local replicas (a WorldMesh:
    the world's replicas across processes). Each replica's forward and
    backward run in `dtype` (the params cast to it, f32 grads), with the
    keyed dropout of its `fold_in` key, read from the key table; the
    update is SGD on the mean of `comm`'s strategy (parallel/
    collectives.py `DPComm`; `bf16_rounding`, `overlap`, `quant_block`,
    `error_feedback` and `bucket_elems` as there). `model` /
    `param_scale` select the workload (models/zoo.py). With int8 error
    feedback, `step.comm_state` is True and `step.place_comm_state(params,
    host=None)` makes the residual before the first step."""
    from ..models.zoo import resolve_model
    from ..train.loop import xla_loss_and_grads
    spec = resolve_model(model, param_scale)
    compute_dt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    mesh = as_mesh(mesh)
    dp = collectives.DPComm(mesh, lr, comm, bf16_rounding=bf16_rounding,
                            overlap=overlap, quant_block=quant_block,
                            error_feedback=error_feedback,
                            bucket_elems=bucket_elems)

    def loss_and_grads(params, x, y, mask):
        return xla_loss_and_grads(params, x.to(compute_dt), y, mask > 0,
                                  apply=spec.apply)

    return dp_step(mesh, lr, loss_and_grads, dp, width=spec.dims[1])


def make_ddp_comm_recorder(mesh: Mesh, comm, params):
    """The per-epoch recorder of the `ddp.*` metrics (JAX
    `make_ddp_comm_recorder`) in the port's registry: `record(steps,
    params)` adds `steps` steps' ring-model bytes to the
    `ddp.bytes_on_wire` counter and the port's all-gather bytes to
    `ddp.bytes_moved`; when the port's tracer is enabled it also times the
    strategy's comm probe (`make_comm_probe`) into the `ddp.collective_s`
    histogram, once an epoch. `comm` is the step's collectives.DPComm."""
    from ..telemetry import get_registry
    from ..telemetry.events import NullTracer, get_tracer
    n = replicas(mesh)
    kw = dict(bucket_elems=comm.bucket_elems, quant_block=comm.quant_block)
    wire_step = collectives.bytes_on_wire(params, n, comm.comm, **kw)
    moved_step = collectives.bytes_moved(params, n, comm.comm,
                                         overlap=comm.overlap, **kw)
    reg = get_registry()
    wire = reg.counter("ddp.bytes_on_wire")
    moved = reg.counter("ddp.bytes_moved")
    hist = reg.histogram("ddp.collective_s")
    box = {}

    def record(steps: int, params) -> None:
        wire.inc(steps * wire_step)
        moved.inc(steps * moved_step)
        tracer = get_tracer()
        if isinstance(tracer, NullTracer):
            return
        if "probe" not in box:
            box["probe"] = collectives.make_comm_probe(mesh, comm.comm, **kw)
        secs = collectives.measure_collective_seconds(box["probe"], params)
        for sec in secs:
            hist.record(sec)
        tracer.complete_span("ddp_comm_probe", sum(secs),
                             strategy=comm.comm, reps=len(secs))

    return record
