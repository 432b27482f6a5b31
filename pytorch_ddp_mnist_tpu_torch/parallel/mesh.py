"""The data-parallel mesh of a single process (port of
`pytorch_ddp_mnist_tpu/parallel/mesh.py`'s `data_parallel_mesh` and its
axis name).

The JAX package's DP programs are single-process SPMD over a 1-D 'dp'
mesh of local devices. The port's mesh is an ordered tuple of
`torch.device` replica slots: replica r runs on `mesh[r]`. A device may
repeat, so n replicas can share one card (or the CPU); that is the
counterpart of the JAX tests' fake-device CPU mesh, and how the tests and
chip_smoke.py build an n-replica mesh on one card. The whole-epoch DP
kernel (K6) runs its ring among the replicas of one card; replicas on
several cards need peer pointers (ROADMAP.md queue 2, K6).
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
