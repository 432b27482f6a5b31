"""Gradient-communication strategies of the DP step (port of
`pytorch_ddp_mnist_tpu/parallel/collectives.py`): one interface, four
programs, optionally bucket-pipelined.

  * `pmean`   — the reference DDP step: the f32 mean of every gradient,
    SGD on every replica (parallel/ddp.py `world_mean`, fixed order).
  * `sharded` — reduce-scatter -> sharded update -> all-gather
    (arXiv:2004.13336): the gradients are flattened into buckets padded to
    a multiple of n, replica g owns shard g of each bucket's mean and runs
    SGD on that shard only (`sgd_step_flat`), and the fresh shards are
    gathered back. Within rtol 1e-6 of pmean (bitwise at n = 2, 4, where
    `/ n` and `* (1/n)` round alike).
  * `bf16`    — the gradients are cast to bf16 (round to nearest, or
    `stochastic_round_bf16`), summed in bf16, and the mean and the update
    are f32.
  * `int8`    — block-scaled int8 (one f32 scale per `quant_block`
    elements) on both phases, with each replica's error-feedback residual
    (`int8_allreduce_mean`, EQuARX, arXiv:2506.17615).

`overlap=True` runs pmean / bf16 bucket by bucket (one collective a
bucket); sharded and int8 are bucketed already.

Buckets, leaf order and byte counts are the JAX package's: the leaves are
taken in jax's flatten order (sorted layer names, then sorted keys:
fc1.b, fc1.w, fc2.b, ...), and `bytes_on_wire` / `collective_schedule` are
its ring-model numbers, equal to JAX's for every strategy, n and model.

Transports. JAX runs each strategy inside a `shard_map` body. The port
computes every replica's part in FIXED global replica order, on two
transports (`Group`):

  * the replica mesh (n replicas in one process, parallel/mesh.py): the
    "collectives" are fixed-order sums over the replicas' tensors, as
    `replica_mean` takes them;
  * a world's ranks (parallel/wireup.py, gloo or NCCL): each collective is
    an all-gather of every rank's payload (its bytes, so any dtype rides
    gloo), followed by the same fixed-order sum on each rank, as
    `world_mean` does. A rank computes its own replicas' shards only and
    all-gathers them back, so a world is bitwise the mesh of as many
    replicas fed the same rows.

No backend-ordered `all_reduce` and no float atomics anywhere. The
all-gather that stands in for a reduce-scatter moves more bytes than the
ring model reckons: `bytes_moved` counts the port's realisation, beside
`bytes_on_wire`.

The rounding keys of `bf16_rounding="stochastic"` are JAX's: replica r's
step key `rkey = fold_in(sub, r)` (the key table's row), then
`fold_in(rkey, 7)` split once per leaf (or folded with the bucket index
under `overlap`); the bits are jax's threefry bits (ops/threefry.py
`random_bits`), drawn on the device from the key table the captured step
reads.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..ops import threefry
from .mesh import DATA_AXIS, as_mesh, first_replica, replicas, world_size

STRATEGIES = ("pmean", "sharded", "bf16", "int8")

# leaves are packed greedily into buckets of at most this many elements
# (16 MiB of f32); the reference MLP is one bucket
DEFAULT_BUCKET_ELEMS = 4 * 1024 * 1024

# int8 scaling-block granularity: one f32 scale per this many elements
QUANT_BLOCK = 256

M32 = 0xFFFFFFFF


def validate_comm(comm: str) -> None:
    """Refuse an unknown strategy by name."""
    if comm not in STRATEGIES:
        raise ValueError(f"unknown DDP comm strategy {comm!r}; "
                         f"choose one of {STRATEGIES}")


def step_cost_label(comm: str, overlap: bool = False,
                    form: str = "step") -> str:
    """`ddp.<form>.<comm>[+overlap]`, the JAX package's program label."""
    validate_comm(comm)
    return f"ddp.{form}.{comm}" + ("+overlap" if overlap else "")


def validate_bf16_rounding(bf16_rounding: str, comm: str) -> None:
    """'nearest' (default) or 'stochastic'; refused by name off bf16."""
    if bf16_rounding not in ("nearest", "stochastic"):
        raise ValueError(f"bf16_rounding must be 'nearest' or 'stochastic';"
                         f" got {bf16_rounding!r}")
    if bf16_rounding == "stochastic" and comm != "bf16":
        raise ValueError(
            f"bf16_rounding='stochastic' rounds the bf16 strategy's wire "
            f"cast; comm={comm!r} never casts — use comm='bf16'")


def validate_int8_options(quant_block: "int | None", error_feedback: bool,
                          comm: str) -> None:
    """The int8 strategy's knobs, refused by name on any other strategy.
    `quant_block=None` is "unset" and valid everywhere."""
    if quant_block is not None and (
            not isinstance(quant_block, (int, np.integer))
            or isinstance(quant_block, bool) or quant_block < 8):
        raise ValueError(
            f"quant_block must be an int >= 8 (one f32 scale per block); "
            f"got {quant_block!r}")
    if comm != "int8":
        if quant_block is not None and int(quant_block) != QUANT_BLOCK:
            raise ValueError(
                f"quant_block={quant_block} sizes the int8 strategy's "
                f"scaling blocks; comm={comm!r} never quantizes to int8 — "
                f"use comm='int8'")
        if error_feedback is not True:
            raise ValueError(
                f"error_feedback={error_feedback!r} carries the int8 "
                f"strategy's quantization residuals; comm={comm!r} has no "
                f"quantization error to feed back — use comm='int8'")


def carries_state(comm: str, error_feedback: bool = True) -> bool:
    """Whether the strategy carries per-replica error-feedback state."""
    return comm == "int8" and bool(error_feedback)


# ---------------------------------------------------------------- layout --

def leaf_names(params) -> list:
    """[(layer, key)] in jax's flatten order of a params dict: sorted layer
    names, then sorted keys."""
    return [(n, k) for n in sorted(params) for k in sorted(params[n])]


def tree_leaves(params) -> list:
    return [params[n][k] for n, k in leaf_names(params)]


def _leaf_size(leaf) -> int:
    return int(np.prod(tuple(leaf.shape))) if tuple(leaf.shape) else 1


def _count_leaf(n: int) -> np.ndarray:
    """A shape-only stand-in for a flat leaf of n elements."""
    return np.broadcast_to(np.float32(0), (int(n),))


def _leaves_of(params_or_count) -> list:
    if isinstance(params_or_count, (int, np.integer)):
        return [_count_leaf(int(params_or_count))]
    return tree_leaves(params_or_count)


def _leaf_buckets(leaves, bucket_elems: int):
    """Greedy static partition of leaf indices into buckets of at most
    `bucket_elems` elements (a larger leaf gets a bucket of its own)."""
    buckets, cur = [[]], 0
    for i, leaf in enumerate(leaves):
        size = _leaf_size(leaf)
        if buckets[-1] and cur + size > bucket_elems:
            buckets.append([])
            cur = 0
        buckets[-1].append(i)
        cur += size
    return buckets


def padded_size(n: int, n_devices: int) -> int:
    """`n` rounded up to a multiple of `n_devices`."""
    return -(-n // n_devices) * n_devices


def _bucket_layout(leaves, bucket_elems: int, align: int):
    """[(leaf indices, n_real, padded)] per bucket, each bucket's element
    count rounded up to a multiple of `align` (1 for pmean/bf16, n for
    sharded, n * quant_block for int8)."""
    out = []
    for bucket in _leaf_buckets(leaves, bucket_elems):
        n_real = sum(_leaf_size(leaves[i]) for i in bucket)
        out.append((bucket, n_real, padded_size(n_real, align)))
    return out


def comm_state_elems(params_or_count, n_devices: int, *,
                     bucket_elems: int = DEFAULT_BUCKET_ELEMS,
                     quant_block: int = QUANT_BLOCK) -> int:
    """Per-replica length of the int8 error-feedback residual."""
    return sum(padded for (_b, _n, padded) in
               _bucket_layout(_leaves_of(params_or_count), bucket_elems,
                              int(n_devices) * int(quant_block)))


def comm_state_zeros(params, n_devices: int, *,
                     bucket_elems: int = DEFAULT_BUCKET_ELEMS,
                     quant_block: int = QUANT_BLOCK) -> np.ndarray:
    """The fresh residual of a run: (n_devices, elems) f32 zeros."""
    return np.zeros((int(n_devices),
                     comm_state_elems(params, n_devices,
                                      bucket_elems=bucket_elems,
                                      quant_block=quant_block)), np.float32)


def bytes_on_wire(params_or_count, n_devices: int, comm: str, *,
                  bucket_elems: int = DEFAULT_BUCKET_ELEMS,
                  quant_block: int = QUANT_BLOCK) -> int:
    """Per-replica per-step wire bytes under the ring model (a ring
    allreduce of M bytes moves 2 (n-1)/n M, a reduce-scatter or all-gather
    (n-1)/n M), the JAX package's numbers. 0 for one replica."""
    validate_comm(comm)
    n = int(n_devices)
    if n <= 1:
        return 0
    leaves = _leaves_of(params_or_count)
    n_params = sum(_leaf_size(leaf) for leaf in leaves)
    ring = (n - 1) / n
    if comm == "pmean":
        return int(2 * ring * 4 * n_params)
    if comm == "sharded":
        padded = sum(p for (_b, _n, p) in
                     _bucket_layout(leaves, bucket_elems, n))
        return int(2 * ring * 4 * padded)
    if comm == "int8":
        padded = sum(p for (_b, _n, p) in
                     _bucket_layout(leaves, bucket_elems,
                                    n * int(quant_block)))
        payload = padded + 4 * (padded // int(quant_block))
        return int(2 * ring * payload)
    return int(2 * ring * 2 * n_params)


def bytes_moved(params_or_count, n_devices: int, comm: str, *,
                overlap: bool = False,
                bucket_elems: int = DEFAULT_BUCKET_ELEMS,
                quant_block: int = QUANT_BLOCK) -> int:
    """Per-replica per-step bytes the port's realisation receives across a
    world's ranks: each collective is an all-gather of every replica's
    payload (n - 1 payloads in), where the ring model's reduce-scatter
    takes (n - 1)/n of one. The loss rides a 4-byte gather of its own. On
    a single-process mesh nothing crosses a wire; this counts what the
    same step moves across ranks."""
    validate_comm(comm)
    n = int(n_devices)
    if n <= 1:
        return 0
    leaves = _leaves_of(params_or_count)
    n_params = sum(_leaf_size(leaf) for leaf in leaves)
    if comm == "pmean" and not overlap:
        return (n - 1) * 4 * (n_params + 1)     # grads and loss, one buffer
    loss = (n - 1) * 4
    if comm in ("pmean", "bf16"):
        return (n - 1) * (4 if comm == "pmean" else 2) * n_params + loss
    qb = int(quant_block)
    align = n * qb if comm == "int8" else n
    padded = sum(p for (_b, _n, p) in _bucket_layout(leaves, bucket_elems,
                                                      align))
    if comm == "sharded":      # grads in, then the fresh shards back
        return (n - 1) * 4 * padded + (n - 1) * 4 * (padded // n) + loss
    payload = padded + 4 * (padded // qb)
    return (n - 1) * payload + (n - 1) * (payload // n) + loss


def collective_schedule(params_or_count, n_devices: int, comm: str, *,
                        overlap: bool = False,
                        bucket_elems: int = DEFAULT_BUCKET_ELEMS,
                        quant_block: int = QUANT_BLOCK) -> list:
    """The ordered payload collectives one step issues, as dicts
    `{kind, dtype, axis, elems, bytes, bucket}` with the ring-model bytes
    of each (they sum to `bytes_on_wire`): the JAX package's schedule,
    entry for entry. One replica keeps the schedule's shape with zero
    bytes."""
    validate_comm(comm)
    n = int(n_devices)
    ring = (n - 1) / n if n > 1 else 0.0
    leaves = _leaves_of(params_or_count)

    def entry(kind, dtype, elems, nbytes, bucket):
        return {"kind": kind, "dtype": dtype, "axis": DATA_AXIS,
                "elems": int(elems), "bytes": int(round(nbytes)),
                "bucket": int(bucket)}

    out = []
    if comm in ("pmean", "bf16"):
        itemsize = 4 if comm == "pmean" else 2
        dtype = "float32" if comm == "pmean" else "bfloat16"
        if not overlap:
            for i, leaf in enumerate(leaves):
                elems = _leaf_size(leaf)
                out.append(entry("allreduce", dtype, elems,
                                 2 * ring * elems * itemsize, i))
        else:
            for b, (_bucket, _n_real, padded) in enumerate(
                    _bucket_layout(leaves, bucket_elems, 1)):
                out.append(entry("allreduce", dtype, padded,
                                 2 * ring * padded * itemsize, b))
    elif comm == "sharded":
        for b, (_bucket, _n_real, padded) in enumerate(
                _bucket_layout(leaves, bucket_elems, max(n, 1))):
            out.append(entry("reduce_scatter", "float32", padded,
                             ring * padded * 4, b))
            out.append(entry("all_gather", "float32", padded,
                             ring * padded * 4, b))
    else:
        qb = int(quant_block)
        for b, (_bucket, _n_real, padded) in enumerate(
                _bucket_layout(leaves, bucket_elems, max(n, 1) * qb)):
            blocks = padded // qb
            out.append(entry("all_to_all", "int8", padded, ring * padded, b))
            out.append(entry("all_to_all", "float32", blocks,
                             ring * blocks * 4, b))
            out.append(entry("all_gather", "int8", padded, ring * padded, b))
            out.append(entry("all_gather", "float32", blocks,
                             ring * blocks * 4, b))
    return out


# ------------------------------------------------------------- numerics --

def _as_words(key, device) -> torch.Tensor:
    if isinstance(key, torch.Tensor):
        return key.to(device)
    return torch.tensor([int(key[0]) & M32, int(key[1]) & M32],
                        dtype=torch.int64, device=device)


def round_bf16_with_bits(x: torch.Tensor, bits: torch.Tensor) -> torch.Tensor:
    """`stochastic_round_bf16` on given random bits (uint32 values in an
    int64 tensor of x's shape): add the low 16 bits to x's f32 bits, cut
    the low 16, the bf16 of that."""
    xb = x.to(torch.float32).contiguous().view(torch.int32).to(torch.int64) & M32
    r = (xb + (bits & 0xFFFF)) & 0xFFFF0000
    r = torch.where(r >= 1 << 31, r - (1 << 32), r).to(torch.int32)
    return r.view(torch.float32).to(torch.bfloat16)


def stochastic_round_bf16(key, x: torch.Tensor) -> torch.Tensor:
    """Stochastically round an f32 tensor to bf16, as JAX's
    `stochastic_round_bf16(key, x)`: `jax.random.bits(key, x.shape,
    uint32) & 0xFFFF` added below the bf16 mantissa cut, then truncated.
    `key` is a (k0, k1) tuple or a (2,) tensor of key words."""
    words = _as_words(key, x.device)
    bits = threefry.random_bits(words, x.numel()).reshape(x.shape)
    return round_bf16_with_bits(x, bits)


def quantize_block_int8(flat: torch.Tensor, quant_block: int):
    """Block-scaled int8 of a flat f32 vector (length a multiple of
    `quant_block`): per block scale = max|x| / 127 and q = round(x / scale)
    (half to even); an all-zero block keeps scale 0. Returns (q int8 (n,),
    scales f32 (n / quant_block,))."""
    blocks = flat.reshape(-1, quant_block)
    scale = torch.amax(torch.abs(blocks), dim=1) / 127.0
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    q = torch.round(blocks / safe[:, None]).to(torch.int8)
    return q.reshape(-1), scale


def dequantize_block_int8(q: torch.Tensor, scale: torch.Tensor,
                          quant_block: int) -> torch.Tensor:
    """q times its block's scale, f32."""
    return (q.to(torch.float32).reshape(-1, quant_block)
            * scale[:, None]).reshape(-1)


def _fixed_sum(parts):
    tot = parts[0]
    for v in parts[1:]:
        tot = tot + v
    return tot


# ------------------------------------------------------------ transport --

class Group:
    """The replicas a step's collectives run over: `n` in global order,
    this process holding `local` of them from global index `first`, on
    `device` (the process's update device). On a single-process mesh the
    gathers return the local tensors; across a world's ranks they are
    all-gathers over the default process group of each payload's bytes."""

    def __init__(self, mesh, device):
        self.mesh = as_mesh(mesh)
        self.n = replicas(self.mesh)
        self.local = len(self.mesh)
        self.first = first_replica(self.mesh)
        self.world = world_size(self.mesh)
        self.device = torch.device(device)

    def _gather_rows(self, local: torch.Tensor) -> torch.Tensor:
        """(world, *local.shape) of every process's `local`, rank order."""
        import torch.distributed as dist
        raw = local.contiguous().reshape(-1).view(torch.uint8)
        if dist.get_backend() == "nccl":
            out = torch.empty((self.world, raw.numel()), dtype=torch.uint8,
                              device=self.device)
            dist.all_gather_into_tensor(out, raw)
        else:
            host = raw.cpu()
            parts = [torch.empty_like(host) for _ in range(self.world)]
            dist.all_gather(parts, host)
            out = torch.stack(parts)
            if self.device.type == "cuda":
                out = out.pin_memory().to(self.device, non_blocking=True)
        return out.view(local.dtype).reshape((self.world,) + tuple(local.shape))

    def all_gather(self, parts) -> list:
        """One tensor per local replica (same shape and dtype) -> the n
        replicas' tensors in global order, on `device`."""
        parts = [p.to(self.device) for p in parts]
        if self.world == 1:
            return parts
        rows = self._gather_rows(torch.stack(parts))
        return list(rows.reshape((self.n,) + tuple(parts[0].shape)))

    def gather_processes(self, t: torch.Tensor) -> list:
        """One tensor per process -> the world's, in rank order."""
        t = t.to(self.device)
        if self.world == 1:
            return [t]
        return list(self._gather_rows(t))


# ------------------------------------------------------------ strategies --

class DPComm:
    """One DP step's gradient communication and update: `update(params,
    losses, grads, words)` takes each local replica's loss and grads tree
    (on any device) and the step's key-table rows `words` ((local, 2), the
    replicas' `fold_in(sub, r)`), runs the strategy, writes SGD into
    `params` in place (the process's one copy, on its device) and returns
    the mean loss over the world's replicas. Plain tensor ops with no host
    sync, so a captured step can run it.

    With error feedback (int8) the residual is a (local, elems) f32 device
    tensor, `resid`: `place_state(params, host=None)` makes it (zeros, or
    a saved array), and `update` writes it in place."""

    def __init__(self, mesh, lr: float, comm: str = "pmean", *,
                 bf16_rounding: str = "nearest", overlap: bool = False,
                 quant_block: "int | None" = None,
                 error_feedback: bool = True,
                 bucket_elems: "int | None" = None):
        validate_comm(comm)
        validate_bf16_rounding(bf16_rounding, comm)
        validate_int8_options(quant_block, error_feedback, comm)
        self.mesh = as_mesh(mesh)
        self.lr = lr
        self.comm = comm
        self.bf16_rounding = bf16_rounding
        self.overlap = bool(overlap)
        self.quant_block = QUANT_BLOCK if quant_block is None else int(
            quant_block)
        self.bucket_elems = (DEFAULT_BUCKET_ELEMS if bucket_elems is None
                             else int(bucket_elems))
        self.stateful = carries_state(comm, error_feedback)
        self.n = replicas(self.mesh)
        self.resid = None

    # -- comm state --------------------------------------------------------

    def place_state(self, params, host=None) -> None:
        """The residual of a run with error feedback: zeros, or `host`
        (this process's (local, elems) rows, or the world's (n, elems),
        of which it takes its own), shape-checked by name. A no-op for the
        other strategies."""
        if not self.stateful:
            return
        elems = comm_state_elems(params, self.n,
                                 bucket_elems=self.bucket_elems,
                                 quant_block=self.quant_block)
        device = tree_leaves(params)[0].device
        local = len(self.mesh)
        if host is None:
            self.resid = torch.zeros((local, elems), dtype=torch.float32,
                                     device=device)
            return
        host = torch.as_tensor(np.asarray(
            host.detach().cpu() if isinstance(host, torch.Tensor) else host,
            np.float32))
        if host.ndim == 2 and host.shape[0] == self.n and local != self.n:
            first = first_replica(self.mesh)
            host = host[first:first + local]
        if tuple(host.shape) != (local, elems):
            raise ValueError(
                f"error-feedback state of shape {tuple(host.shape)} does not "
                f"fit this run (expected ({local}, {elems}) for {self.n} "
                f"replica(s), quant_block={self.quant_block}) — it was saved "
                f"under a different mesh size or quantization geometry")
        self.resid = host.to(device).clone()

    def state_tensors(self) -> tuple:
        return (self.resid,) if self.resid is not None else ()

    # -- the step ------------------------------------------------------------

    @torch.no_grad()
    def update(self, params, losses, grads, words=None) -> torch.Tensor:
        from .ddp import world_mean
        from ..ops.sgd import sgd_step
        names = leaf_names(params)
        device = params[names[0][0]][names[0][1]].device
        if self.comm == "pmean" and not self.overlap:
            loss, mean = world_mean(self.mesh, losses, grads, device)
            sgd_step(params, mean, self.lr)
            return loss
        if self.stateful and self.resid is None:
            raise RuntimeError("the int8 strategy with error feedback needs "
                               "its residual: call place_state(params) first")
        group = Group(self.mesh, device)
        loss = _fixed_sum(group.all_gather(
            [v.to(torch.float32).reshape(()) for v in losses]))
        loss = loss * torch.full((), 1.0 / self.n, dtype=torch.float32,
                                 device=device)
        rnd = None
        if self.bf16_rounding == "stochastic":
            # fold_in(rkey, 7) of each local replica's step key, on device
            rnd = threefry.fold_in_words(words.to(device), 7)
        self._apply(group, params, grads, rnd)
        return loss

    def _apply(self, group, params, grads, rnd) -> None:
        """The strategy's mean and update of every leaf (not pmean without
        overlap, which is `world_mean` + `sgd_step`): `rnd` are the local
        replicas' `fold_in(rkey, 7)` words, or None."""
        p_leaves = tree_leaves(params)
        g_local = [tree_leaves(g) for g in grads]
        if self.comm == "sharded":
            self._sharded(group, p_leaves, g_local)
        elif self.comm == "bf16" and not self.overlap:
            self._bf16_leaves(group, p_leaves, g_local, rnd)
        else:
            self._bucketed(group, p_leaves, g_local, rnd)

    def _flat(self, leaves, idx, padded, device) -> torch.Tensor:
        flat = torch.cat([leaves[i].to(device).reshape(-1).to(torch.float32)
                          for i in idx])
        pad = padded - flat.numel()
        if pad:
            flat = torch.cat([flat, torch.zeros(pad, dtype=flat.dtype,
                                                device=device)])
        return flat

    def _write(self, p_leaves, idx, flat) -> None:
        off = 0
        for i in idx:
            size = p_leaves[i].numel()
            p_leaves[i].copy_(flat[off:off + size].reshape(p_leaves[i].shape))
            off += size

    def _sgd(self, p_leaves, idx, mean) -> None:
        """sgd_step_flat on each leaf of a bucket from the flat mean."""
        from ..ops.sgd import sgd_step_flat
        off = 0
        for i in idx:
            size = p_leaves[i].numel()
            p_leaves[i].copy_(sgd_step_flat(
                p_leaves[i].reshape(-1), mean[off:off + size],
                self.lr).reshape(p_leaves[i].shape))
            off += size

    def _sharded(self, group, p_leaves, g_local) -> None:
        """reduce-scatter -> SGD on this process's shards -> all-gather, a
        bucket at a time (`sharded_update`)."""
        from ..ops.sgd import sgd_step_flat
        n, dev = group.n, group.device
        for bucket in _leaf_buckets(p_leaves, self.bucket_elems):
            n_real = sum(p_leaves[i].numel() for i in bucket)
            shard = padded_size(n_real, n) // n
            g_all = group.all_gather([self._flat(g, bucket, shard * n, dev)
                                      for g in g_local])
            lo, hi = group.first * shard, (group.first + group.local) * shard
            g_shard = _fixed_sum([g[lo:hi] for g in g_all]) / n
            p_shard = self._flat(p_leaves, bucket, shard * n, dev)[lo:hi]
            fresh = sgd_step_flat(p_shard, g_shard, self.lr)
            flat_new = torch.cat(group.gather_processes(fresh))
            self._write(p_leaves, bucket, flat_new)

    def _bf16_leaves(self, group, p_leaves, g_local, rnd) -> None:
        """`bf16_allreduce_mean` then SGD, leaf by leaf."""
        n, dev = group.n, group.device
        keys = (threefry.split_words(rnd, len(p_leaves))
                if rnd is not None else None)
        for i, p in enumerate(p_leaves):
            parts = []
            for r, g in enumerate(g_local):
                gi = g[i].to(dev).to(torch.float32)
                if keys is None:
                    parts.append(gi.to(torch.bfloat16))
                else:
                    bits = threefry.random_bits(keys[r, i], gi.numel())
                    parts.append(round_bf16_with_bits(
                        gi, bits.reshape(gi.shape)))
            mean = _fixed_sum(group.all_gather(parts)).to(torch.float32) / n
            p.sub_(mean * self.lr)

    def _bucketed(self, group, p_leaves, g_local, rnd) -> None:
        """The bucket-pipelined apply (`_bucketized_apply`): pmean / bf16
        with overlap, and int8 always."""
        n, dev = group.n, group.device
        int8 = self.comm == "int8"
        qb = self.quant_block
        align = n * qb if int8 else 1
        off = 0
        for b, (bucket, _n_real, padded) in enumerate(
                _bucket_layout(p_leaves, self.bucket_elems, align)):
            flats = [self._flat(g, bucket, padded, dev) for g in g_local]
            if int8:
                mean = self._int8_bucket(group, flats, off, padded)
            elif self.comm == "bf16":
                if rnd is not None:
                    keys = threefry.fold_in_words(rnd, b)
                    casts = [round_bf16_with_bits(
                        f, threefry.random_bits(keys[r], padded))
                        for r, f in enumerate(flats)]
                else:
                    casts = [f.to(torch.bfloat16) for f in flats]
                mean = _fixed_sum(group.all_gather(casts)).to(
                    torch.float32) / n
            else:
                mean = _fixed_sum(group.all_gather(flats)) / n
            self._sgd(p_leaves, bucket, mean)
            off += padded

    def _int8_bucket(self, group, flats, off: int, padded: int):
        """`int8_allreduce_mean` of one padded bucket for this process's
        replicas: both phases quantised, each replica's local error and
        its own shard's phase-2 error (x n) into its residual."""
        n, qb = group.n, self.quant_block
        resid = (self.resid[:, off:off + padded] if self.stateful else None)
        g_eff = [f + resid[r] if resid is not None else f
                 for r, f in enumerate(flats)]
        qs = [quantize_block_int8(g, qb) for g in g_eff]
        if resid is not None:
            for r, (g, (q, s)) in enumerate(zip(g_eff, qs)):
                resid[r].copy_(g - dequantize_block_int8(q, s, qb))
        if n == 1:
            return dequantize_block_int8(qs[0][0], qs[0][1], qb)
        shard = padded // n
        bps = shard // qb
        q_all = group.all_gather([q for q, _ in qs])
        s_all = group.all_gather([s for _, s in qs])
        lo, hi = group.first * shard, (group.first + group.local) * shard
        blo, bhi = group.first * bps, (group.first + group.local) * bps
        deq = [q[lo:hi].to(torch.float32).reshape(-1, qb) * s[blo:bhi][:, None]
               for q, s in zip(q_all, s_all)]
        mean_local = _fixed_sum(deq).reshape(-1) / n
        qm, sm = quantize_block_int8(mean_local, qb)
        if resid is not None:
            err = mean_local - dequantize_block_int8(qm, sm, qb)
            for r in range(group.local):
                g = group.first + r
                own = resid[r, g * shard:(g + 1) * shard]
                own.copy_(own + err[r * shard:(r + 1) * shard] * n)
        qg = torch.cat(group.gather_processes(qm))
        sg = torch.cat(group.gather_processes(sm))
        return dequantize_block_int8(qg, sg, qb)


def _mesh_apply(params, grads, lr, comm, **kw):
    """A fresh params tree from the n replicas' grads trees on the replica
    mesh of their device, and the DPComm that made it; `params` is not
    written. `rnd` in kw: the replicas' `fold_in(rkey, 7)` words."""
    rnd = kw.pop("rnd", None)
    resid = kw.pop("resid", None)
    clone = {n: {k: v.detach().clone() for k, v in layer.items()}
             for n, layer in params.items()}
    device = tree_leaves(clone)[0].device
    dp = DPComm((device,) * len(grads), lr, comm, **kw)
    if resid is not None:
        dp.resid = torch.as_tensor(resid, dtype=torch.float32).to(
            device).clone()
    with torch.no_grad():
        dp._apply(Group(dp.mesh, device), clone, grads, rnd)
    return clone, dp


def int8_allreduce_mean(flat_gs, resids, quant_block: int):
    """JAX's `int8_allreduce_mean` on the replica mesh: the n replicas'
    padded flat gradients `flat_gs` (length a multiple of n *
    quant_block) and their residual slices `resids` (or None: error
    feedback off). Returns (the mean every replica applies, the new
    residuals or None)."""
    n = len(flat_gs)
    comm = DPComm((flat_gs[0].device,) * n, 0.0, "int8",
                  quant_block=quant_block, error_feedback=resids is not None)
    if resids is not None:
        comm.resid = torch.stack([r.to(torch.float32) for r in resids])
    group = Group(comm.mesh, flat_gs[0].device)
    mean = comm._int8_bucket(group, list(flat_gs), 0, flat_gs[0].numel())
    return mean, (list(comm.resid) if resids is not None else None)


def bf16_allreduce_mean(grads, *, rounding_keys=None):
    """JAX's `bf16_allreduce_mean` on the replica mesh: each replica's
    grads tree cast to bf16 leaf by leaf (round to nearest, or stochastic
    with replica r's per-leaf keys `rounding_keys[r]`, (L, 2) words),
    summed in bf16 in replica order, the mean in f32."""
    out = {name: {} for name in grads[0]}
    for i, (name, k) in enumerate(leaf_names(grads[0])):
        parts = []
        for r, g in enumerate(grads):
            leaf = g[name][k].to(torch.float32)
            parts.append(leaf.to(torch.bfloat16) if rounding_keys is None
                         else stochastic_round_bf16(rounding_keys[r][i], leaf))
        out[name][k] = _fixed_sum(parts).to(torch.float32) / len(grads)
    return out


def sharded_update(params, grads, lr: float, *,
                   bucket_elems: int = DEFAULT_BUCKET_ELEMS):
    """JAX's `sharded_update` on the replica mesh: a fresh params tree
    from the replicas' grads trees (reduce-scatter, SGD on each shard,
    all-gather)."""
    return _mesh_apply(params, grads, lr, "sharded",
                       bucket_elems=bucket_elems)[0]


def int8_apply_gradients(params, grads, lr: float, *, resid=None,
                         quant_block: int = QUANT_BLOCK,
                         bucket_elems: int = DEFAULT_BUCKET_ELEMS):
    """JAX's `int8_apply_gradients` on the replica mesh: (fresh params
    tree, new residual (n, elems) or None) from the replicas' grads trees
    and the residual (or None: error feedback off)."""
    fresh, dp = _mesh_apply(params, grads, lr, "int8", resid=resid,
                            quant_block=quant_block,
                            error_feedback=resid is not None,
                            bucket_elems=bucket_elems)
    return fresh, dp.resid


def apply_gradients(params, grads, lr: float, comm: str, *,
                    rounding_key=None, overlap: bool = False,
                    bucket_elems: int = DEFAULT_BUCKET_ELEMS):
    """JAX's stateless `apply_gradients` on the replica mesh: a fresh
    params tree from the replicas' grads trees under `comm` (int8 carries
    state and is refused by name: `int8_apply_gradients`).
    `rounding_key` are the replicas' `fold_in(rkey, 7)` words ((n, 2)) for
    bf16's stochastic rounding."""
    validate_comm(comm)
    if comm == "int8":
        raise ValueError(
            "comm='int8' carries error-feedback residual state through the "
            "step — use int8_apply_gradients (params, resid in; params', "
            "resid' out), not the stateless apply_gradients")
    if comm == "pmean" and not overlap:
        from .ddp import replica_mean
        from ..ops.sgd import sgd_step
        fresh = {n: {k: v.detach().clone() for k, v in layer.items()}
                 for n, layer in params.items()}
        return sgd_step(fresh, replica_mean(grads), lr)
    return _mesh_apply(params, grads, lr, comm, overlap=overlap,
                       bucket_elems=bucket_elems, rnd=rounding_key,
                       bf16_rounding="nearest" if rounding_key is None
                       else "stochastic")[0]


# ----------------------------------------------------------------- probe --

def make_comm_probe(mesh, comm: str, *, quant_block: int = QUANT_BLOCK,
                    bucket_elems: int = DEFAULT_BUCKET_ELEMS):
    """(params-shaped tree) -> reduced tree: the strategy's communication
    alone on `mesh`, every local replica contributing the tree (lr 0, so
    the update is the identity up to the strategy's rounding; error
    feedback off, as in JAX: the probe isolates the wire pattern)."""
    validate_comm(comm)
    mesh = as_mesh(mesh)

    def probe(tree):
        clone = {n: {k: v.detach().clone() for k, v in layer.items()}
                 for n, layer in tree.items()}
        dp = DPComm(mesh, 0.0, comm,
                    quant_block=quant_block if comm == "int8" else None,
                    error_feedback=comm != "int8", bucket_elems=bucket_elems)
        losses = [torch.zeros((), device=tree_leaves(clone)[0].device)
                  for _ in mesh]
        dp.update(clone, losses, [clone] * len(mesh))
        return clone

    return probe


def measure_collective_seconds(probe, params, reps: int = 3) -> list:
    """`reps` timed calls of a `make_comm_probe` program after one warm
    call, each waited for on the card: wall seconds per rep."""
    device = tree_leaves(params)[0].device

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    probe(params)
    sync()
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        probe(params)
        sync()
        out.append(time.perf_counter() - t0)
    return out
