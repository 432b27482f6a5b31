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
TPU pod's metadata) has no counterpart and is refused by name.

Outages (the JAX module's backend probes, on CUDA): `looks_like_backend_loss`
tells a lost peer or a failed card (a gloo peer's closed or reset
connection, an NCCL error, the NCCL watchdog's collective timeout, a
sticky CUDA error) from a program error; `wait_for_backend` polls the card
with hang-bounded probes under a jittered backoff (`backoff_schedule`)
until it answers, and raises `BackendWedgedError` when it answers only
from a fresh process (`_subprocess_backend_healthy`): a sticky CUDA error
(an illegal address, a launch failure) poisons this process's context for
good, and the trainer then persists its state and re-execs
(cli/train.py `_train_with_outage_retry`). `$PDMT_BACKEND_WAIT` and
`$PDMT_HANG_TIMEOUT` (seconds) bound the waits, as in the JAX package.
`Runtime.barrier` is the `barrier` fault point (utils/faultpoints.py,
`collective_timeout`).
"""

from __future__ import annotations

import datetime
import math
import os
import re
import subprocess
import sys
import threading
import time
from dataclasses import dataclass

import torch

from ..telemetry import cluster
from ..utils import faultpoints

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

    def barrier(self, **ctx) -> None:
        """Cross-process sync (reference barrier, mnist_cpu_mp.py:201-203).
        The `barrier` fault point fires first, with the rank and `ctx`
        (the trainer's epoch-end barrier passes its epoch):
        `collective_timeout` raises the error a dead collective gives, on
        any world size. The collective journal (telemetry/cluster.py)
        brackets it as a host-blocking collective: the fault fires inside
        the bracket, so a timeout leaves the barrier's enter open, the
        evidence the hang report reads."""
        seq = cluster.get_journal().enter("barrier", axis="world")
        faultpoints.fire("barrier", rank=self.rank, **ctx)
        if self.initialized:
            import torch.distributed as dist
            if self.backend == "nccl":
                dist.barrier(device_ids=[self.device.index])
            else:
                dist.barrier()
        cluster.get_journal().exit(seq)

    def reduce_max(self, value: float) -> float:
        """Global max of a host scalar (reference reduceMAX,
        mnist_cpu_mp.py:193-199), delivered to every rank: an
        all_reduce(MAX) of one f32, journal-bracketed as `barrier` is."""
        if not self.initialized:
            return float(value)
        import torch.distributed as dist
        seq = cluster.get_journal().enter("allreduce", axis="world",
                                          nbytes=4)
        t = torch.tensor([value], dtype=torch.float32,
                         device=self._comm_device())
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        out = float(t.item())
        cluster.get_journal().exit(seq)
        return out

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
            "RANK/WORLD_SIZE/MASTER_ADDR/MASTER_PORT")
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


# -- outages ------------------------------------------------------------------


class BackendUnavailableError(RuntimeError):
    """The card stayed unavailable for the whole wait budget."""


class BackendWedgedError(BackendUnavailableError):
    """The card answers again from a fresh process, but not from this one:
    a sticky CUDA error poisoned this process's context (or a probe hung
    inside CUDA's initialisation and holds it). Only a new process can use
    the card: the caller re-execs or asks for a relaunch."""


def env_seconds(name: str, default: float) -> float:
    """Seconds from the environment variable `name`; unset, empty,
    malformed, negative or non-finite values give `default` (with a
    stderr note for the malformed ones)."""
    raw = os.environ.get(name)
    if raw is None or raw.strip() == "":
        return default
    try:
        val = float(raw)
    except ValueError:
        print(f"{name}={raw!r} is not a number; using {default:.0f}s",
              file=sys.stderr)
        return default
    if not math.isfinite(val) or val < 0:
        print(f"{name}={raw!r} is not a non-negative finite number of "
              f"seconds; using {default:.0f}s", file=sys.stderr)
        return default
    return val


def backend_wait_env(default: float) -> float:
    """$PDMT_BACKEND_WAIT (seconds), the JAX package's variable."""
    return env_seconds("PDMT_BACKEND_WAIT", default)


def backoff_schedule(base_s: float, cap_s: float, *, seed: int = 0,
                     factor: float = 2.0):
    """Endless jittered exponential backoff: attempt k waits jitter *
    min(cap_s, base_s * factor**k), jitter in [0.5, 1.5) drawn from
    `random.Random((seed << 20) ^ k)`: the JAX package's delays, the same
    for the same (seed, attempt), and seeded by rank so a world's ranks do
    not probe in lockstep."""
    import random
    if base_s <= 0 or cap_s < base_s or factor <= 1.0:
        raise ValueError(f"need 0 < base_s <= cap_s and factor > 1; got "
                         f"base_s={base_s}, cap_s={cap_s}, factor={factor}")
    attempt = 0
    while True:
        raw = min(cap_s, base_s * factor ** attempt)
        yield raw * (0.5 + random.Random((seed << 20) ^ attempt).random())
        attempt += 1


# lower-case substrings of the errors a lost peer or a failed card gives:
# gloo's and NCCL's (through torch.distributed), the NCCL watchdog's, the
# JAX package's gRPC status names (the `collective_timeout` fault raises
# one), and the sticky CUDA errors below. Narrow on purpose: a shape or
# dtype error must not match.
STICKY_CUDA_SIGNATURES = (
    "illegal memory access", "an illegal instruction",
    "unspecified launch failure", "misaligned address",
    "cudaerrorlaunchfailure", "cudaerrorillegaladdress",
    "device-side assert triggered", "uncorrectable ecc error",
    "cuda error: unknown error", "cudaerrordevicesunavailable",
)
BACKEND_LOSS_SIGNATURES = (
    "unavailable", "deadline exceeded", "deadline_exceeded",
    "connection closed by peer", "connection reset", "connection refused",
    "socket closed", "broken pipe", "connectfullmesh failed",
    "nccl error", "ncclremoteerror", "ncclsystemerror",
    "nccl communicator was aborted", "watchdog caught collective operation "
    "timeout", "collective operation timeout", "timed out waiting",
    "heartbeat",
) + STICKY_CUDA_SIGNATURES


def looks_like_backend_loss(e: BaseException) -> bool:
    """Whether the error reads as a lost peer or card (retrying may help),
    not as a program error (it would fail again)."""
    msg = str(e).lower()
    return any(sig in msg for sig in BACKEND_LOSS_SIGNATURES)


def is_sticky_cuda_error(e: BaseException) -> bool:
    """Whether the error is one that poisons this process's CUDA context:
    no call in this process can use the card again."""
    msg = str(e).lower()
    return any(sig in msg for sig in STICKY_CUDA_SIGNATURES)


_PROBE = {
    "cuda": ("import torch; torch.cuda.init(); "
             "x = torch.ones(1, device='cuda'); x.add_(1); "
             "torch.cuda.synchronize(); "
             "assert float(x.cpu()[0]) == 2.0"),
    "cpu": "import torch; assert float(torch.ones(1).add_(1)[0]) == 2.0",
}


def _probe_devices_bounded(timeout_s: float, device_type: str = "cuda"):
    """Probe the card from this process on a daemon thread (init, one op,
    a fetch), so a hung probe cannot hold the caller. Returns ('ok', the
    device count), ('error', a RuntimeError: worth a retry), ('fatal',
    another exception) or ('hang', wait_fn), where wait_fn(extra_s)
    re-joins the same probe and returns a fresh (status, payload)."""
    out = {}

    def probe():
        try:
            if device_type == "cuda":
                torch.cuda.init()
                x = torch.ones(1, device="cuda").add_(1)
                torch.cuda.synchronize()
                if float(x.cpu()[0]) != 2.0:
                    raise RuntimeError("the card's probe op gave a wrong "
                                       "value")
                out["devices"] = torch.cuda.device_count()
            else:
                out["devices"] = 1
        except Exception as e:  # noqa: BLE001 — classified in wait()
            out["error"] = e

    t = threading.Thread(target=probe, name="pdmt-backend-probe",
                         daemon=True)
    t.start()

    def wait(extra_s: float):
        t.join(extra_s)
        if t.is_alive():
            return "hang", wait
        if "error" in out:
            e = out["error"]
            return ("error" if isinstance(e, RuntimeError) else "fatal"), e
        return "ok", out["devices"]

    return wait(timeout_s)


def _subprocess_backend_healthy(timeout_s: float,
                                device_type: str = "cuda") -> bool:
    """Whether a FRESH interpreter can initialise the card and run one op
    within `timeout_s`: immune to this process's poisoned context."""
    try:
        return subprocess.run(
            [sys.executable, "-c", _PROBE[device_type]], timeout=timeout_s,
            capture_output=True).returncode == 0
    except (subprocess.SubprocessError, OSError):
        return False


def wait_for_fresh_backend(max_wait_s: float, poll_s: float = 10.0,
                           device_type: str = "cuda") -> int:
    """Poll the card from FRESH interpreters (`_subprocess_backend_healthy`)
    until one reaches it, without touching CUDA in this process; returns
    the probes it took. A CUDA initialisation that fails in a process
    stays failed there (the runtime keeps the device count it read at its
    first query), so a trainer that has not yet touched the card waits
    this way, and only then makes its own first CUDA call. Retries under
    `backoff_schedule` (capped at `poll_s`, seeded by $RANK) until
    `max_wait_s`, then raises BackendUnavailableError. Every probe goes to
    the flight recorder."""
    from ..telemetry import flight
    flight.record("backend_wait_start", max_wait_s=max_wait_s,
                  poll_s=poll_s, mode="fresh_process")
    deadline = time.monotonic() + max_wait_s
    try:
        seed = int(os.environ.get("RANK", "0"))
    except ValueError:
        seed = 0
    delays = backoff_schedule(min(1.0, poll_s), max(poll_s, 1.0), seed=seed)
    attempt = 0
    while True:
        left = deadline - time.monotonic()
        healthy = _subprocess_backend_healthy(min(45.0, max(left, 1.0)),
                                              device_type)
        attempt += 1
        flight.record("backend_health_poll", healthy=healthy,
                      attempt=attempt,
                      remaining_s=round(max(left, 0.0), 1))
        if healthy:
            if attempt > 1:
                flight.record("backend_recovered", attempts=attempt,
                              mode="fresh_process")
            return attempt
        left = deadline - time.monotonic()
        if left <= 0:
            flight.record("backend_unavailable", attempts=attempt,
                          budget_s=max_wait_s, mode="fresh_process")
            raise BackendUnavailableError(
                f"backend unavailable after {attempt} attempts over "
                f"{max_wait_s:.0f}s: no fresh process could initialise the "
                f"{device_type} backend and run one op")
        print(f"wireup: backend unavailable (attempt {attempt}), retrying "
              f"for another {left:.0f}s", file=sys.stderr, flush=True)
        time.sleep(min(next(delays), max(left, 0.05)))


def wait_for_backend(max_wait_s: float = 300.0, poll_s: float = 10.0,
                     hang_timeout_s: float | None = None,
                     device_type: str = "cuda"):
    """Poll the card until it answers (`_probe_devices_bounded`); returns
    its device count. Retries an erroring probe under `backoff_schedule`
    (capped at `poll_s`, seeded by $RANK) until `max_wait_s`, then raises
    BackendUnavailableError; a probe that raises something other than a
    RuntimeError re-raises at once. A probe that errors with a sticky CUDA
    error, or hangs past `hang_timeout_s` ($PDMT_HANG_TIMEOUT, default
    75 s), while a fresh process reaches the card, raises
    BackendWedgedError: this process cannot use the card again. Every
    attempt goes to the flight recorder."""
    from ..telemetry import flight
    if hang_timeout_s is None:
        hang_timeout_s = env_seconds("PDMT_HANG_TIMEOUT", 75.0)
    flight.record("backend_wait_start", max_wait_s=max_wait_s,
                  poll_s=poll_s, hang_timeout_s=hang_timeout_s)
    deadline = time.monotonic() + max_wait_s
    try:
        seed = int(os.environ.get("RANK", "0"))
    except ValueError:
        seed = 0
    delays = backoff_schedule(min(1.0, poll_s), max(poll_s, 1.0), seed=seed)
    attempt, waiter = 0, None

    def left() -> float:
        return deadline - time.monotonic()

    def pause() -> None:
        delay = min(next(delays), max(left(), 0.1))
        flight.record("backend_retry_wait", wait_s=round(delay, 2),
                      attempt=attempt)
        time.sleep(delay)

    while True:
        if waiter is None:
            status, payload = _probe_devices_bounded(
                min(hang_timeout_s, max(left(), 1.0)), device_type)
        else:
            status, payload = waiter(0.0)
        if status == "ok":
            if attempt:
                flight.record("backend_recovered", attempts=attempt,
                              devices=payload)
            return payload
        if status == "fatal":
            flight.record("backend_probe_fatal", error=str(payload)[:500])
            raise payload
        if status == "error":
            waiter = None
            attempt += 1
            flight.record("backend_probe_error", attempt=attempt,
                          remaining_s=round(max(left(), 0.0), 1),
                          error=str(payload)[:500])
            if is_sticky_cuda_error(payload) and \
                    _subprocess_backend_healthy(hang_timeout_s, device_type):
                flight.record("backend_wedged", attempts=attempt,
                              mode="sticky")
                raise BackendWedgedError(
                    f"the card answers a fresh process, but this process's "
                    f"CUDA context is poisoned ({payload}); only a new "
                    f"process can use it") from payload
            if left() <= 0:
                flight.record("backend_unavailable", attempts=attempt,
                              budget_s=max_wait_s)
                raise BackendUnavailableError(
                    f"backend unavailable after {attempt} attempts over "
                    f"{max_wait_s:.0f}s: {payload}") from payload
            print(f"wireup: backend unavailable (attempt {attempt}), "
                  f"retrying for another {left():.0f}s: {payload}",
                  file=sys.stderr, flush=True)
            pause()
            continue
        # a hung probe: watch the card from fresh processes while the
        # probe is re-checked at the top of the loop
        if waiter is None:
            waiter = payload
            attempt += 1
            flight.record("backend_probe_hang", attempt=attempt,
                          hang_timeout_s=hang_timeout_s)
            print(f"wireup: backend probe hung for {hang_timeout_s:.0f}s; "
                  f"polling health out-of-process", file=sys.stderr,
                  flush=True)
        if left() <= 0:
            flight.record("backend_unavailable", attempts=attempt,
                          budget_s=max_wait_s, mode="hang")
            raise BackendUnavailableError(
                f"backend probe hung (> {hang_timeout_s:.0f}s) and "
                f"out-of-process probes stayed unhealthy for the rest of the "
                f"{max_wait_s:.0f}s budget")
        healthy = _subprocess_backend_healthy(min(hang_timeout_s, left()),
                                              device_type)
        flight.record("backend_health_poll", healthy=healthy,
                      remaining_s=round(max(left(), 0.0), 1))
        if healthy:
            status, payload = waiter(min(hang_timeout_s, max(left(), 1.0)))
            if status == "ok":
                flight.record("backend_recovered", attempts=attempt,
                              devices=payload, mode="late_init")
                return payload
            if status in ("error", "fatal"):
                waiter = None
                continue
            flight.record("backend_wedged", attempts=attempt, mode="hang")
            raise BackendWedgedError(
                "the card answers a fresh process, but this process's probe "
                "hung inside CUDA's initialisation and still holds it; only "
                "a new process can use the card")
        pause()
