"""Multi-process wireup: the reference's `distributed` class on
`torch.distributed` (port of `pytorch_ddp_mnist_tpu/parallel/wireup.py`,
its env-derivation chains and `Runtime`).

The reference (mnist_cpu_mp.py:14-206) derives MASTER_ADDR/PORT, RANK and
WORLD_SIZE from SLURM, Open MPI (PMIx), MPICH (PMI) or the plain env
variables, calls `torch.distributed.init_process_group`, and exposes the
rank and size, `reduceMAX`, `barrier` and `finalize`. The same chains feed
`init_process_group(backend, init_method="tcp://<coordinator>", rank,
world_size, timeout)` here; torchrun (`torch.distributed.launch`, the
reference's `train_multi_gpu.sh:3`) exports the env chain's variables.

The backend follows the devices:
  * NCCL where every rank of a node has a card of its own;
  * gloo on the CPU, and where ranks share a card: NCCL refuses two ranks
    on one device.
The reference's spellings name their backend again (`nccl-slurm`,
`nccl-openmpi`, `nccl-mpich` ask for NCCL, `gloo` for gloo). A request the
devices cannot meet exits by name; no rank switches backend on its own.

A launcher's world forms a process group even at one rank, so a 1-rank
world runs the same collectives as a larger one; `single` (and `auto` with
no launcher variables) forms none. The JAX package's `tpu` method (a Cloud
TPU pod's metadata) has no counterpart and is refused by name, as are its
backend probes and outage retries (ROADMAP.md queue 1, item 8).
"""

from __future__ import annotations

import datetime
import os
import re
from dataclasses import dataclass

import torch

# seconds a rank waits in init_process_group and in any collective before
# it raises, so a rank that died cannot hold the others forever
WORLD_TIMEOUT_S = 300.0


def _first_host(nodelist: str) -> str:
    """First hostname of a SLURM nodelist, e.g. 'nid[0012-0015,0020]' ->
    nid0012 (the reference shells out to `scontrol show hostnames`)."""
    m = re.match(r"^([^\[,]+)\[([^\]]+)\]", nodelist)
    if m:
        prefix, ranges = m.groups()
        first = ranges.split(",")[0].split("-")[0]
        return prefix + first
    return nodelist.split(",")[0]


# the reference's literal --wireup_method spellings (mnist_cpu_mp.py:47-188)
# -> the env-derivation chain its branch used
METHOD_ALIASES = {
    "nccl-slurm": "slurm",
    "nccl-openmpi": "openmpi",
    "nccl-mpich": "mpich",
    "gloo": "env",
}
# ... and the backend each spelling names
BACKEND_REQUESTS = {"nccl-slurm": "nccl", "nccl-openmpi": "nccl",
                    "nccl-mpich": "nccl", "gloo": "gloo"}
METHODS = ("auto", "single", "slurm", "openmpi", "mpich", "env")


def resolve_method(name: str) -> str:
    """Canonicalize a wireup method name, accepting reference spellings."""
    return METHOD_ALIASES.get(name, name)


@dataclass
class Runtime:
    """The process's place in the world (reference get_rank/get_size/
    get_local_rank, mnist_cpu_mp.py:15-39), its device, and the backend of
    the process group it formed (None without one)."""
    method: str
    rank: int = 0
    size: int = 1
    local_rank: int = 0
    coordinator: str | None = None
    backend: str | None = None
    device: torch.device | None = None
    initialized: bool = False

    def _comm_device(self) -> torch.device:
        # NCCL moves CUDA tensors only; gloo's are staged on the host
        return self.device if self.backend == "nccl" else torch.device("cpu")

    def barrier(self) -> None:
        """Cross-process sync (reference barrier, mnist_cpu_mp.py:201-203)."""
        if not self.initialized:
            return
        import torch.distributed as dist
        if self.backend == "nccl":
            dist.barrier(device_ids=[self.device.index])
        else:
            dist.barrier()

    def reduce_max(self, value: float) -> float:
        """Global max of a host scalar (reference reduceMAX,
        mnist_cpu_mp.py:193-199), delivered to every rank: an
        all_reduce(MAX) of one f32."""
        if not self.initialized:
            return float(value)
        import torch.distributed as dist
        t = torch.tensor([value], dtype=torch.float32,
                         device=self._comm_device())
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        return float(t.item())

    def finalize(self) -> None:
        """Tear the process group down (reference finalize ->
        destroy_process_group, mnist_cpu_mp.py:205-206)."""
        if self.initialized:
            import torch.distributed as dist
            dist.destroy_process_group()
            self.initialized = False


def _require(var: str, method: str, launcher: str) -> str:
    """A launcher variable, or a named error saying which launcher sets it
    (the reference raises per variable, mnist_cpu_mp.py:57-89)."""
    val = os.environ.get(var)
    if val is None:
        raise RuntimeError(
            f"wireup method {method!r}: required environment variable {var} "
            f"is not set — it is normally exported by the {launcher} "
            f"launcher. Launch under {launcher}, or use --wireup_method env "
            f"with RANK/WORLD_SIZE/MASTER_ADDR/MASTER_PORT set manually.")
    return val


def _coordinator() -> str:
    env = os.environ
    return f"{env.get('MASTER_ADDR', '127.0.0.1')}:{env.get('MASTER_PORT', '29500')}"


def _derive(method: str):
    """(rank, size, local_rank, coordinator) from launcher env vars."""
    method = resolve_method(method)
    env = os.environ
    if method == "slurm":
        # reference SLURM branch: mnist_cpu_mp.py:47-89
        rank = int(_require("SLURM_PROCID", method, "SLURM (srun)"))
        size = int(_require("SLURM_NTASKS", method, "SLURM (srun)"))
        local = int(env.get("SLURM_LOCALID", 0))
        host = _first_host(env.get("SLURM_STEP_NODELIST",
                                   env.get("SLURM_NODELIST", "127.0.0.1")))
        port = 12000 + int(env.get("SLURM_JOBID", "0")) % 20000
        return rank, size, local, f"{host}:{port}"
    if method == "openmpi":
        # reference PMIx branch: mnist_cpu_mp.py:94-113
        rank = int(_require("OMPI_COMM_WORLD_RANK", method, "Open MPI (mpiexec)"))
        size = int(_require("OMPI_COMM_WORLD_SIZE", method, "Open MPI (mpiexec)"))
        local = int(env.get("OMPI_COMM_WORLD_LOCAL_RANK", 0))
        return rank, size, local, _coordinator()
    if method == "mpich":
        # reference PMI branch: mnist_cpu_mp.py:118-142
        rank = int(_require("PMI_RANK", method, "MPICH (mpiexec)"))
        size = int(_require("PMI_SIZE", method, "MPICH (mpiexec)"))
        local = int(env.get("MPI_LOCALRANKID", 0))
        return rank, size, local, _coordinator()
    if method == "env":
        # reference fallback branch: mnist_cpu_mp.py:147-185
        rank = int(env.get("RANK", "0"))
        size = int(env.get("WORLD_SIZE", "1"))
        local = int(env.get("LOCAL_RANK", "0"))
        return rank, size, local, _coordinator()
    raise ValueError(f"unknown wireup method {method!r}")


# per method, the variable that counts the ranks on this node
_LOCAL_SIZE_VARS = {"slurm": "SLURM_NTASKS_PER_NODE",
                    "openmpi": "OMPI_COMM_WORLD_LOCAL_SIZE",
                    "mpich": "MPI_LOCALNRANKS", "env": "LOCAL_WORLD_SIZE"}


def _local_size(method: str, size: int) -> int:
    """Ranks on this node: the launcher's count, or the whole world when
    it gives none (one node)."""
    raw = os.environ.get(_LOCAL_SIZE_VARS[method], "")
    return int(raw) if raw.isdigit() else size


def detect_method() -> str:
    """Probe the launcher env: SLURM, then Open MPI, MPICH and the plain
    env variables; none of them is a single process."""
    env = os.environ
    if "SLURM_PROCID" in env and "SLURM_NTASKS" in env:
        return "slurm"
    if "OMPI_COMM_WORLD_RANK" in env:
        return "openmpi"
    if "PMI_RANK" in env:
        return "mpich"
    if "RANK" in env and "WORLD_SIZE" in env:
        return "env"
    return "single"


def choose_backend(request: str | None, device_type: str, local_size: int,
                   cards: int) -> str:
    """The backend of a world whose ranks run on `device_type`, `local_size`
    of them on this node, which has `cards` CUDA cards: NCCL where each
    rank has a card of its own, gloo otherwise. `request` ('nccl', 'gloo'
    or None) is what the method's spelling named; one the devices cannot
    meet raises by name."""
    own_card = device_type == "cuda" and local_size <= cards
    if request == "gloo":
        return "gloo"
    if request == "nccl":
        if device_type != "cuda":
            raise RuntimeError(
                "wireup: NCCL was asked for (an nccl-* --wireup_method) but "
                "the ranks run on the CPU (--device cpu); NCCL moves CUDA "
                "tensors only. Use --wireup_method gloo (or env/auto, which "
                "pick gloo on the CPU)")
        if not own_card:
            raise RuntimeError(
                f"wireup: NCCL was asked for (an nccl-* --wireup_method) but "
                f"{local_size} ranks share this node's {cards} card(s); NCCL "
                f"refuses two ranks on one device. Use --wireup_method gloo "
                f"(or env/auto, which pick gloo where ranks share a card), "
                f"or run at most {cards} rank(s) a node")
    backend = "nccl" if own_card else "gloo"
    if backend == "nccl":
        import torch.distributed as dist
        if not dist.is_nccl_available():
            raise RuntimeError(
                "wireup: each rank has a card of its own, which takes NCCL, "
                "but this torch build has no NCCL; use --wireup_method gloo")
    return backend


def initialize_runtime(method: str = "auto", *,
                       device_type: str = "cuda") -> Runtime:
    """Resolve the world from the launcher's variables and, for a launcher's
    world, form the process group: `init_process_group(backend,
    init_method="tcp://<coordinator>", rank, world_size, timeout)`, then
    check the size of the group it formed. `device_type` 'cuda' puts rank r
    on cuda:(local_rank % device count) (no card raises by name), 'cpu' on
    the CPU. A single process forms no group and gets no device (the
    caller's `--device` stands)."""
    request = BACKEND_REQUESTS.get(method)
    method = resolve_method(method)
    if method == "tpu":
        raise RuntimeError(
            "wireup method 'tpu' reads a Cloud TPU pod's metadata; it has no "
            "counterpart on CUDA machines. Launch under torchrun, SLURM or "
            "MPI (--wireup_method auto), or use --wireup_method env with "
            "RANK/WORLD_SIZE/MASTER_ADDR/MASTER_PORT (ROADMAP.md queue 1, "
            "item 8)")
    if method not in METHODS:
        raise ValueError(f"unknown wireup method {method!r}")
    if method == "auto":
        method = detect_method()
    if method == "single":
        return Runtime(method="single")
    rank, size, local, coord = _derive(method)
    if not 0 <= rank < size:
        raise RuntimeError(f"wireup {method}: rank {rank} is outside the "
                           f"world of {size}")
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "wireup: no CUDA card is available (torch.cuda.is_available() is "
            "False) for this rank; pass --device cpu to run the world on "
            "the CPU")
    cards = torch.cuda.device_count() if device_type == "cuda" else 0
    backend = choose_backend(request, device_type, _local_size(method, size),
                             cards)
    device = (torch.device("cuda", local % cards) if device_type == "cuda"
              else torch.device("cpu"))
    rt = Runtime(method=method, rank=rank, size=size, local_rank=local,
                 coordinator=coord, backend=backend, device=device)
    import torch.distributed as dist
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=f"tcp://{coord}", rank=rank,
                            world_size=size,
                            timeout=datetime.timedelta(seconds=WORLD_TIMEOUT_S))
    rt.initialized = True
    formed = dist.get_world_size()
    if formed != size:
        rt.finalize()
        raise RuntimeError(
            f"wireup {method}: expected {size} processes, the process group "
            f"formed {formed} — rendezvous failed")
    return rt
