"""The data-parallel mesh (port of `pytorch_ddp_mnist_tpu/parallel/mesh.py`'s
`data_parallel_mesh` and its axis name), of one process or of a world.

The JAX package's DP programs are single-process SPMD over a 1-D 'dp'
mesh of local devices. The port's mesh is an ordered tuple of
`torch.device` replica slots: replica r runs on `mesh[r]`. A device may
repeat, so n replicas can share one card (or the CPU); that is the
counterpart of the JAX tests' fake-device CPU mesh, and how the tests and
chip_smoke.py build an n-replica mesh on one card. The whole-epoch DP
kernel (K6) runs its ring among the replicas of one card; replicas on
several cards need peer pointers (ROADMAP.md queue 2, K6).

A world of processes (parallel/wireup.py) has a `WorldMesh`: the same
tuple of this process's replica slots (one per rank in the CLI: cuda:
(local_rank % device count), or the CPU), which also knows the world's
size in processes and this process's rank. Its replicas are numbered
globally in rank order: process p's local replica l is replica
`p * len(mesh) + l` of `replicas(mesh)`. A plain tuple is a world of one
process.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

DATA_AXIS = "dp"

Mesh = Tuple[torch.device, ...]


def data_parallel_mesh(devices: Sequence | None = None) -> Mesh:
    """The 1-D 'dp' mesh over `devices` (torch.device or anything
    torch.device takes), in order. The default is every local CUDA card;
    with no card it raises, naming it (pass `[torch.device("cpu")]` for a
    CPU replica)."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "data_parallel_mesh(): no CUDA card is available "
                "(torch.cuda.is_available() is False); pass the devices, "
                "e.g. [torch.device('cpu')], for a mesh on the CPU")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    mesh = tuple(torch.device(d) for d in devices)
    if not mesh:
        raise ValueError("a mesh needs at least one device")
    for d in mesh:
        if d.type not in ("cuda", "cpu"):
            raise ValueError(f"mesh device {d}: the port runs on cuda or cpu")
        if d.type == "cuda" and d.index is None:
            raise ValueError(f"mesh device {d}: give the card's ordinal "
                             f"(cuda:N)")
    return mesh


class WorldMesh(tuple):
    """This process's replica slots in a world of `world_size` processes,
    of which it is `rank`; every process holds as many. The collectives
    run on the default process group (parallel/wireup.py)."""

    def __new__(cls, devices: Sequence, *, world_size: int, rank: int):
        if not 0 <= rank < world_size:
            raise ValueError(f"rank {rank} is outside the world of "
                             f"{world_size}")
        self = super().__new__(cls, data_parallel_mesh(devices))
        self.world_size, self.rank = int(world_size), int(rank)
        return self


def world_size(mesh: Mesh) -> int:
    """Processes in the mesh's world (1 for a single-process mesh)."""
    return getattr(mesh, "world_size", 1)


def first_replica(mesh: Mesh) -> int:
    """The global index of this process's first replica."""
    return getattr(mesh, "rank", 0) * len(mesh)


def replicas(mesh: Mesh) -> int:
    """Replicas in the whole world: the global mean's n."""
    return world_size(mesh) * len(mesh)


def as_mesh(mesh) -> Mesh:
    """`mesh` as a tuple of devices, a WorldMesh kept as it is."""
    return mesh if isinstance(mesh, WorldMesh) else tuple(mesh)
