"""The serial and data-parallel trainer (port of the single-process
branches of `pytorch_ddp_mnist_tpu/cli/train.py`).

    python -m pytorch_ddp_mnist_tpu_torch train [--n_epochs N] [--limit N]
        [--batch_size 128] [--lr 0.01] [--seed 0] [--dtype float32|bfloat16]
        [--kernel auto|xla|pallas|pallas_rng|pallas_epoch] [--cached [--fused]]
        [--impl threefry2x32|rbg] [--device 0|cpu] [--parallel
        [--wireup_method auto|single|slurm|openmpi|mpich|env|nccl-slurm|
        nccl-openmpi|nccl-mpich|gloo]] [--checkpoint model.pt] [--path data/]
        [--netcdf [--num_workers N]] [--download] [--sampler_rng pcg64|torch]
        [--dropout_rng jax|torch] [--eval_shuffle] [--input_workers N]
        [--prefetch_depth K] [--model mlp|deep_mlp] [--param_scale N]
        [--ddp_comm pmean|sharded|bf16|int8] [--overlap] [--quant_block N]
        [--error_feedback on|off] [--bf16_rounding nearest|stochastic]
        [--ckpt_every_steps N [--ckpt_keep 3]] [--resume DIR|FILE
        [--start_epoch K]] [--fault SPEC] [--outage_retries N]
        [--telemetry DIR [--profile_dispatch [K]] [--journal]]
        [--health off|warn|checkpoint-and-warn|abort] [--metrics_port N]
        [--profile LOGDIR]

Trains the reference MLP on MNIST (or the synthetic stand-in), prints the
reference epoch line every epoch and saves `--checkpoint` (the reference's
`.pt` state_dict by default) after every epoch and at the end. It runs on CUDA device `--device` (default 0); with no card it
exits and names the missing card unless `--device cpu` asks for the CPU.
Without `--cached` it streams batches from the host (train/loop.py); with
it the dataset stays on the device (train/scan.py), `--kernel pallas_rng`
draws each step's dropout inside the fused kernel, and `--kernel
pallas_epoch` runs each epoch as one kernel. On a card the per-step
kernels (`xla`, `pallas`, `pallas_rng`) run one step captured as a CUDA
graph and replayed once a step (train/graphs.py), serially or over a mesh
of one card; a world of processes and a mesh across cards keep an eager
loop.

`--parallel` trains data parallel (parallel/ddp.py), `--batch_size` rows
per replica: the streaming step with each replica's own mask and the
fixed-order gradient mean, or `--cached` through the DP scan. Under a
launcher (torchrun, SLURM srun, Open MPI or MPICH mpiexec, or plain
RANK/WORLD_SIZE/MASTER_ADDR/MASTER_PORT; `--wireup_method`,
parallel/wireup.py) it runs as one rank of a world of processes: rank r
trains on cuda:(local_rank % device count) (the CPU under `--device cpu`)
over its own shard of the sampler (with `--cached`: its contiguous columns
of each global batch of the global sampler, as the JAX CLI's resident
path gives a process), the per-step gradient mean runs over
the ranks in fixed global order, and only rank 0 prints the banner and
the epoch lines and saves the checkpoint. `--kernel pallas_epoch` across
processes exits by name (ROADMAP.md queue 2, item 6). With no launcher,
`--parallel` runs over the mesh of every local card (`--device cpu`: one
CPU replica), where `--kernel pallas_epoch` takes the mean in the epoch
kernel's ring (K6); a machine with one card is a 1-replica mesh.

    torchrun --nproc_per_node 4 -m pytorch_ddp_mnist_tpu_torch train \
        --parallel --device cpu

Seeds: the weights are `MLP.from_seed(--seed)`, the JAX package's init
stream, bit for bit its `init_mlp(jax.random.key(seed))` (models/mlp.py;
drawn on the host, so every device starts from the same weights). Both
paths key their dropout masks by jax's threefry key `--seed + 1`, split as
the JAX trainer splits it, so with `--impl threefry2x32` (the default) the
masks are the JAX package's for the same seed. `--kernel pallas_rng` and
`--impl rbg` draw the port's own Philox stream instead (the TPU core PRNG
has no CUDA twin). The reference's own streams are there too: `--sampler_rng
torch` shuffles with torch's CPU `randperm` (DistributedSampler's),
`--dropout_rng torch` draws the masks from torch's CPU `bernoulli_` seeded
`--seed` (serial streaming only, on the plain autograd step), and
`--eval_shuffle` segments the val loss in torch's `randperm` order.

Data: the IDX files under `--path` (`--download` fetches them first), the
synthetic stand-in where there are none, or with `--netcdf` the converter's
mnist_{train,test}_images.nc, read through the native reader core
(csrc/reader.cc) where it builds; the `[data]` line names the core. The
streaming path feeds its batches through the input pipeline (pipeline/):
`--input_workers` decode threads and `--prefetch_depth` batches of copy
lookahead, bitwise the synchronous run; `--num_workers` is the NetCDF
loader's own read-ahead.

`--model` / `--param_scale` pick a zoo model (models/zoo.py; the plain
autograd step), and `--ddp_comm` with `--overlap`, `--quant_block`,
`--error_feedback` and `--bf16_rounding` the gradient-communication
strategy of `--parallel` (parallel/collectives.py), with the JAX CLI's
refusals of their combinations (train/config.py).

Checkpoints and faults (the JAX CLI's): rank 0 saves `--checkpoint` after
every epoch and, with `--ckpt_every_steps N`, commits step checkpoints
(params, key chain, sampler position, the int8 residual of a
single-process mesh) under `<--checkpoint>.steps/`
(train/ckpt_manager.py), every N steps of an epoch and at its end, each
stamped with the run geometry (`_run_geometry`). `--resume DIR` restores
the newest intact and finite one and continues bitwise; `--resume FILE
--start_epoch K` restores params (and, from `FILE.rng.npz`, the key
chain). `--fault` (and `$PDMT_FAULT`) installs the fault specs of
utils/faultpoints.py; every epoch ends at the world's barrier, the
`barrier` fault point. `--outage_retries N` retries a run that a lost
card or peer interrupts (`_train_with_outage_retry`). A serial run with
`$PDMT_BACKEND_WAIT` > 0 first waits that long for the card, probing it
from fresh processes, before its own first CUDA call.

In-run telemetry (the JAX CLI's): `--telemetry DIR` writes the JSONL
event trace (`events.jsonl`, `events.rank<r>.jsonl`: the fit's spans, the
capture counter `xla.compiles`, the memory watermarks, the final registry
snapshot), dumps the flight recorder there, and prints rank 0's
`[telemetry]` line, whose `xla_compiles` counts the run's CUDA-graph
captures;
`--health` runs the training-health watchdog (telemetry/health.py) with
its fatal-signal policy; `--metrics_port` serves `/metrics` and
`/healthz` on rank 0 (telemetry/prom.py); `--profile_dispatch K` splits
the step boundary into named phases (telemetry/dispatch.py); `--journal`
writes each rank's collective journal, opened by a startup barrier at seq
0 (telemetry/cluster.py); `--profile LOGDIR` records the run with
torch.profiler (utils/profiling.py). None of them changes what the run
computes.
"""

from __future__ import annotations

import contextlib
import os
import sys

import numpy as np
import torch

from ..data.download import download_mnist
from ..data.loader import BatchLoader, NetCDFShardLoader, open_reader
from ..data.mnist import get_mnist, normalize_images
from ..data.native import native_available, native_build_error
from ..models.mlp import param_count
from ..models.zoo import is_default_model, resolve_model
from ..ops import _build
from ..ops.fused_step import make_fused_train_step, make_pallas_dp_train_step
from ..ops.threefry import key_data
from ..parallel.ddp import check_replicated, dp_mesh, make_dp_train_step
from ..parallel.mesh import WorldMesh, replicas
from ..parallel.sampler import ShardedSampler
from ..parallel.torch_rng import torch_randperm
from ..parallel.wireup import Runtime, initialize_runtime
from ..train.checkpoint import save_checkpoint
from ..train.config import configure, resolve_kernel
from ..train.loop import TrainState, fit, make_torch_dropout_train_step
from ..train.scan import (_load_params, check_dp_run_args, check_run_args,
                          fit_cached)


def resolve_device(spec: str, what: str = "This trainer") -> torch.device:
    """`--device` -> torch.device: 'cpu', or a CUDA ordinal that must name
    a card of this machine (`what` names the program in the refusal)."""
    if spec == "cpu":
        return torch.device("cpu")
    try:
        index = int(spec)
    except ValueError:
        raise SystemExit(f"--device {spec!r}: expected a CUDA device ordinal "
                         f"or 'cpu'") from None
    if not torch.cuda.is_available():
        raise SystemExit(
            f"--device {index}: no CUDA card is available "
            f"(torch.cuda.is_available() is False). {what} runs on "
            f"the card; pass --device cpu to run on the CPU instead")
    count = torch.cuda.device_count()
    if not 0 <= index < count:
        raise SystemExit(f"--device {index}: no such CUDA card (this machine "
                         f"has {count})")
    return torch.device("cuda", index)


def resolve_world(method: str, device: torch.device):
    """(Runtime, mesh) of `--parallel`: a launcher's world of processes
    (one replica a rank, on the runtime's device), or, with no launcher,
    the mesh of every local card (one CPU replica under `--device cpu`).
    A wireup that cannot be met exits by name."""
    try:
        rt = initialize_runtime(method, device_type=device.type)
    except RuntimeError as e:
        raise SystemExit(str(e)) from None
    if not rt.initialized:
        return rt, (dp_mesh([device]) if device.type == "cpu" else dp_mesh())
    return rt, WorldMesh([rt.device], world_size=rt.size, rank=rt.rank)


# the outage stash of a run with no --checkpoint (rank 0's; the others
# add .rank<r>); a finished resume removes it
_DEFAULT_STASH = "outage_resume.msgpack"


def _command_line_flags() -> list:
    """The trainer's flags on this process's command line (after the
    front door's `train`, when it is there)."""
    args = sys.argv[1:]
    return args[1:] if args[:1] == ["train"] else args


def _run_geometry(tcfg, dcfg, global_batch: int) -> dict:
    """The fields whose change would re-interpret a step checkpoint,
    stamped into every manifest and checked at a directory resume (the
    JAX CLI's): (epoch, offset) address the same batches only under the
    same global batch, --limit and sampler, and the params fit only the
    same model."""
    return {"global_batch": int(global_batch), "limit": int(dcfg["limit"]),
            "sampler_rng": tcfg["sampler_rng"], "model": tcfg["model"],
            "param_scale": int(tcfg["param_scale"])}


def train(argv=None):
    """Everything `main` does; returns (TrainState, per-epoch arrays of the
    per-step losses) for callers that check the run. `argv` None reads the
    process's command line: the CLI context, the only one in which an
    outage retry may re-exec the process. A world's process group is torn
    down when it returns or raises."""
    from .. import telemetry
    from ..telemetry import flight
    from ..utils import faultpoints
    cli = argv is None
    cfg = configure(_command_line_flags() if cli else argv, cli=cli)
    tcfg = cfg["trainer"]
    # the fault specs parse before any work (a misspelt chaos spec must
    # not run fault-free); the rank binds after the wireup
    try:
        faultpoints.install(tcfg["fault"])
    except faultpoints.FaultSpecError as e:
        raise SystemExit(f"--fault: {e}") from None
    with contextlib.ExitStack() as closing:
        if tcfg["telemetry"]:
            # a run that raised leaves no trace, journal or dump directory
            # armed in the process (a clean end has closed them already)
            closing.callback(flight.set_dump_dir, None)
            closing.callback(telemetry.disable)
            closing.callback(telemetry.disable_journal, clean=False)
            # armed before any capture; the memory probes never touch the
            # card
            telemetry.install_compile_listener()
            telemetry.install_memory_watermarks()
            os.makedirs(tcfg["telemetry"], exist_ok=True)
            flight.set_dump_dir(tcfg["telemetry"])
            if cli:   # the command line owns the signal dispositions
                flight.install_sigterm_flush()
            if not tcfg["parallel"]:
                # a serial run is process 0; a world's trace opens after
                # its rendezvous, with the rank
                telemetry.enable(tcfg["telemetry"], process_index=0)
        if not tcfg["parallel"]:
            _wait_for_backend_at_start(tcfg["device"])
        device = resolve_device(tcfg["device"])
        # true f32 products, as the JAX package's kernels accumulate, and
        # bf16 products reduced in f32, as XLA's are
        matmul = torch.backends.cuda.matmul
        matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        matmul.allow_bf16_reduced_precision_reduction = False
        kernel = resolve_kernel(tcfg["kernel"], tcfg["dtype"], device.type)
        try:   # the scan layer's refusals, by name, before any work
            check_run_args(kernel, tcfg["dtype"], 1, 1, tcfg["impl"])
        except ValueError as e:
            raise SystemExit(str(e)) from None
        runtime, mesh, journal = Runtime(method="single"), None, None
        if tcfg["parallel"]:
            runtime, mesh = resolve_world(tcfg["wireup_method"], device)
            closing.callback(runtime.finalize)
            faultpoints.set_rank(runtime.rank)
            flight.set_rank(runtime.rank)
            if tcfg["telemetry"]:   # after the rendezvous: the rank is known
                telemetry.enable(tcfg["telemetry"],
                                 process_index=runtime.rank)
        if tcfg["journal"]:
            if kernel == "pallas":
                raise SystemExit("--journal needs the XLA step program; "
                                 "--kernel auto resolved to pallas here — "
                                 "pass --kernel xla to journal this run")
            journal = _open_journal(tcfg, runtime)
        return _train(cfg, kernel, runtime, mesh, device, cli, journal,
                      closing)


def _wait_for_backend_at_start(spec: str) -> None:
    """$PDMT_BACKEND_WAIT > 0 (a serial run): wait that many seconds for
    the card before the run's first CUDA query, as the JAX CLI waits for
    its backend, and exit by the JAX CLI's words if it never answers. The
    probes run in fresh processes (parallel/wireup.py
    `wait_for_fresh_backend`): a failed CUDA query would stay failed in
    this one."""
    from ..parallel.wireup import (BackendUnavailableError,
                                   backend_wait_env, wait_for_fresh_backend)
    wait_s = backend_wait_env(0.0)
    if wait_s > 0:
        try:
            wait_for_fresh_backend(wait_s, device_type="cpu" if spec == "cpu"
                                   else "cuda")
        except BackendUnavailableError as e:
            raise SystemExit(f"accelerator backend unavailable after "
                             f"PDMT_BACKEND_WAIT={wait_s:.0f}s: {e}") from None


def _open_journal(tcfg, runtime: Runtime):
    """--journal: this rank's collective journal and hang watchdog, then
    the startup barrier at seq 0, the anchor every cross-rank comparison
    rides. A timeout there (an injected `collective_timeout` or a dead
    peer) leaves the barrier's enter open and exits with the JAX CLI's
    named hang report."""
    from .. import telemetry
    from ..parallel.wireup import looks_like_backend_loss
    journal = telemetry.enable_journal(tcfg["telemetry"], rank=runtime.rank,
                                       world=runtime.size)
    try:
        runtime.barrier()
    except RuntimeError as e:
        if not looks_like_backend_loss(e):
            raise
        entry = journal.open_entry() or {"seq": 0, "kind": "barrier"}
        telemetry.cluster.report_hang(journal, entry)
        telemetry.disable_journal(clean=False)
        raise SystemExit(
            f"[cluster] collective timeout in the startup barrier "
            f"(seq {entry.get('seq')}): {e} — hang report in the "
            f"flight dump under {tcfg['telemetry']}; read it with "
            f"`trace report --cluster {tcfg['telemetry']}`") from None
    return journal


def _host_state(model, key) -> dict:
    """Host copies of the state an outage retry resumes from."""
    return {"params": {n: {k: v.detach().cpu().clone()
                           for k, v in layer.items()}
                       for n, layer in model.params().items()},
            "key": np.asarray(key, np.uint32)}


def _train(cfg, kernel: str, runtime: Runtime, mesh, device: torch.device,
           cli: bool = False, journal=None, closing=None):
    from .. import telemetry
    from ..telemetry.health import TrainingHealthError
    tcfg, dcfg = cfg["trainer"], cfg["data"]
    # the process's captures so far: the [telemetry] line counts this run's
    captures0 = telemetry.get_registry().counter("xla.compiles").value \
        if tcfg["telemetry"] else 0
    if mesh is not None:
        device = mesh[0]
        if tcfg["cached"]:
            try:   # the epoch kernel across processes, by name
                check_dp_run_args(mesh, kernel, tcfg["dtype"], 1, 1,
                                  tcfg["impl"], "auto", **_comm_kw(tcfg),
                                  model=tcfg["model"],
                                  param_scale=tcfg["param_scale"])
            except ValueError as e:
                raise SystemExit(f"--parallel --cached: {e}") from None
        if kernel == "pallas_epoch" and len(set(mesh)) > 1:
            raise SystemExit(
                f"--parallel --kernel pallas_epoch: the mesh spans "
                f"{len(set(mesh))} cards; the epoch kernel's ring (K6) runs "
                f"among replicas of one card, and across cards it needs peer "
                f"pointers, which wait for a machine with two or more cards "
                f"(ROADMAP.md queue 2, K6). Use --kernel pallas")
        if kernel == "pallas_epoch":
            # stderr: stdout stays the machine-parseable epoch lines
            print(f"[note] --kernel pallas_epoch --parallel: each step's "
                  f"gradient mean over the {len(mesh)} replica(s) runs in "
                  f"the epoch kernel's in-kernel ring (K6)"
                  f"{'; a 1-replica mesh is the serial kernel' if len(mesh) == 1 else ''}",
                  file=sys.stderr, flush=True)
    rank, world = runtime.rank, runtime.size
    if runtime.initialized and (device.type == "cuda" or dcfg["netcdf"]):
        # one build a node, before the first collective: the other ranks
        # load what local rank 0 built (the kernels on a card, the native
        # reader core for --netcdf)
        if runtime.local_rank == 0:
            if device.type == "cuda":
                _build.build_all()
            if dcfg["netcdf"]:
                native_available()
        runtime.barrier()
    log = print if rank == 0 else (lambda line: None)
    n_rep = replicas(mesh) if mesh is not None else 1
    global_batch = tcfg["batch_size"] * n_rep
    local_batch = tcfg["batch_size"] * (len(mesh) if mesh is not None else 1)

    data = load_data(dcfg, runtime, local_batch, tcfg["cached"], log,
                     num_workers=tcfg["num_workers"])
    x_test = normalize_images(data["test_images"])
    y_test = data["test_labels"].astype(np.int32)
    # the streaming path: each rank takes its own shard of the sampler; the
    # resident-dataset path: every rank builds the global sampler and takes
    # its columns of each global batch (train/scan.py `epoch_rows`), as the
    # JAX CLI's cached path does
    shards = (1, 0) if tcfg["cached"] else (world, rank)
    sampler = ShardedSampler(data["n_train"], num_replicas=shards[0],
                             rank=shards[1], shuffle=True, seed=42,
                             permutation=tcfg["sampler_rng"])
    eval_perm = None
    if tcfg["eval_shuffle"]:
        # the reference's shuffled test loader, from torch's own randperm
        # seeded --seed + epoch (its loader is unseeded): only the ref-unit
        # val_loss's batch segmentation changes
        n_test = len(y_test)
        eval_perm = lambda e: torch_randperm(n_test, tcfg["seed"] + e)  # noqa: E731

    spec = resolve_model(tcfg["model"], tcfg["param_scale"])
    model = spec.from_seed(tcfg["seed"]).to(device)
    key = key_data(tcfg["seed"] + 1)
    resume = _resume(tcfg, dcfg, model, mesh, kernel, global_batch)
    if resume["key"] is not None:
        key = resume["key"]
    if mesh is not None:
        try:
            check_replicated(mesh, model.params())
        except RuntimeError as e:
            raise SystemExit(str(e)) from None
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    mode = (f" cached{' fused' if tcfg['fused'] else ''}"
            if tcfg["cached"] else "")
    if mesh is not None:
        mode += f" parallel={n_rep}x{tcfg['batch_size']}"
    if runtime.initialized:
        mode += (f" world={world} rank={rank} backend={runtime.backend} "
                 f"wireup={runtime.method}")
    for flag, default in (("sampler_rng", "pcg64"), ("dropout_rng", "jax"),
                          ("ddp_comm", "pmean"), ("bf16_rounding", "nearest"),
                          ("overlap", False), ("quant_block", None),
                          ("error_feedback", True), ("input_workers", 0),
                          ("prefetch_depth", 1)):
        if tcfg[flag] != default:
            mode += f" {flag}={tcfg[flag]}"
    if not is_default_model(tcfg["model"], tcfg["param_scale"]):
        mode += f" model={tcfg['model']}@{tcfg['param_scale']}"
    log(f"pytorch_ddp_mnist_tpu_torch: device={device} ({name}) "
        f"params={param_count(model.params())} "
        f"batch={tcfg['batch_size']} kernel={kernel}{mode} "
        f"impl={tcfg['impl']} dtype={tcfg['dtype']}")

    # rank 0 saves --checkpoint after every epoch (the JAX CLI's epoch
    # checkpoint: a run killed in epoch k resumes from k - 1 with --resume
    # and --start_epoch k); in a world every rank then meets at a barrier,
    # which is the `barrier` fault point of the fit
    def epoch_hook(epoch, st):
        if stash is not None:
            stash.update(epoch=epoch, **_host_state(st.model, st.key))
        if rank == 0 and tcfg["checkpoint"]:
            save_checkpoint(tcfg["checkpoint"], st.model.params())
            resume["consume_sidecar"](tcfg["checkpoint"])
        runtime.barrier(epoch=epoch)

    # --outage_retries: host copies of the last completed epoch's state,
    # seeded with the starting state (epoch start_epoch - 1)
    stash = None
    if tcfg["outage_retries"]:
        stash = {"epoch": tcfg["start_epoch"] - 1,
                 **_host_state(model, key)}
    step_hook = _step_hook(tcfg, dcfg, global_batch, rank, world)
    nsteps = -(-len(sampler) // (global_batch if tcfg["cached"]
                                 else local_batch))
    watchdog = _watchdog(tcfg, dcfg, global_batch, rank,
                         TrainState(model, key, resume["resid"]),
                         resume["offset"], nsteps)
    profiler = (telemetry.DispatchProfiler(
        sample_every=int(tcfg["profile_dispatch"]))
        if tcfg["profile_dispatch"] else None)
    if tcfg["metrics_port"] is not None and rank == 0:
        # after the watchdog, so the first scrape shows the health gauges;
        # the memory watermarks without --telemetry too
        telemetry.install_memory_watermarks()
        server = telemetry.start_metrics_server(tcfg["metrics_port"])
        closing.callback(server.server_close)
        closing.callback(server.shutdown)
        host, port = server.server_address[:2]
        print(f"metrics on http://{host}:{port}/metrics", file=sys.stderr,
              flush=True)
    in_run = {"watchdog": watchdog, "dispatch_profiler": profiler}

    if tcfg["cached"]:
        def run_fit(st, start):
            key, history = fit_cached(
                st.model, st.key, data["train_images"],
                data["train_labels"].astype(np.int32), sampler, x_test,
                y_test, epochs=tcfg["n_epochs"], batch_size=global_batch,
                lr=tcfg["lr"], kernel=kernel, impl=tcfg["impl"],
                fused=tcfg["fused"], dtype=tcfg["dtype"], mesh=mesh,
                eval_perm=eval_perm, prefetch_depth=tcfg["prefetch_depth"],
                start_epoch=start,
                start_offset=(resume["offset"]
                              if start == tcfg["start_epoch"] else 0),
                ckpt_every_steps=tcfg["ckpt_every_steps"],
                step_hook=step_hook, epoch_hook=epoch_hook, resid=st.resid,
                log=log, **in_run,
                **(_comm_kw(tcfg) if mesh is not None else {}))
            comm = fit_cached.comm
            return TrainState(st.model, key,
                              comm.resid if comm is not None else None), \
                history
    else:
        loader = data["loader"]
        if loader is None:
            loader = BatchLoader(normalize_images(data["train_images"]),
                                 data["train_labels"], None,
                                 batch_size=local_batch)
        loader.sampler = sampler
        # the JAX trainer's serial streaming `xla` step takes no dtype: it
        # trains in f32 under --dtype bfloat16, and so does this one; its DP
        # steps take the dtype
        if mesh is not None and kernel == "pallas":
            step = make_pallas_dp_train_step(
                mesh, tcfg["lr"], dtype=tcfg["dtype"], comm=tcfg["ddp_comm"],
                bf16_rounding=tcfg["bf16_rounding"])
        elif mesh is not None:
            step = make_dp_train_step(mesh, tcfg["lr"], dtype=tcfg["dtype"],
                                      **_comm_kw(tcfg), model=tcfg["model"],
                                      param_scale=tcfg["param_scale"])
        elif tcfg["dropout_rng"] == "torch":
            # the mask stream's position is a function of the steps done:
            # a resume skips start_epoch epochs and the offset's steps
            step = make_torch_dropout_train_step(
                tcfg["lr"], tcfg["seed"],
                skip_steps=(tcfg["start_epoch"] * len(loader)
                            + resume["offset"]),
                batch_size=local_batch)
        else:
            step = (make_fused_train_step(tcfg["lr"], dtype=tcfg["dtype"])
                    if kernel == "pallas" else None)

        def run_fit(st, start):
            return fit(st, loader, x_test, y_test, epochs=tcfg["n_epochs"],
                       batch_size=global_batch,
                       lr=None if step else tcfg["lr"], train_step=step,
                       eval_perm=eval_perm,
                       input_workers=tcfg["input_workers"],
                       prefetch_depth=tcfg["prefetch_depth"],
                       model_apply=spec.apply, start_epoch=start,
                       start_offset=(resume["offset"]
                                     if start == tcfg["start_epoch"] else 0),
                       ckpt_every_steps=tcfg["ckpt_every_steps"],
                       step_hook=step_hook, epoch_hook=epoch_hook, log=log,
                       journal=journal, **in_run)

    try:
        state, history = _train_with_outage_retry(
            run_fit, TrainState(model, key, resume["resid"]), tcfg, stash,
            cli, rank, device, profile=tcfg["profile"])
    except TrainingHealthError as e:
        # --health abort: the watchdog has emitted its events and dumped
        # the flight ring; a diverged model exits by name
        raise SystemExit(f"[health] {e}") from None
    if journal is not None:
        # the clean trailer, before the final snapshot takes cluster.*
        telemetry.disable_journal()
    if tcfg["telemetry"]:
        _close_trace(tcfg, log, captures0)
    if runtime.initialized and device.type == "cuda":
        # stderr: stdout stays the machine-parseable epoch lines
        print(f"[world] rank {rank}: peak device memory "
              f"{torch.cuda.max_memory_allocated(device) / 2**20:.1f} MiB on "
              f"{device} ({name})", file=sys.stderr, flush=True)
    if tcfg["checkpoint"] and rank == 0:
        save_checkpoint(tcfg["checkpoint"], state.model.params())
        resume["consume_sidecar"](tcfg["checkpoint"])
        print(f"saved checkpoint to {tcfg['checkpoint']}")
    _drop_stale_stash(tcfg, rank)
    return state, history


def _watchdog(tcfg, dcfg, global_batch: int, rank: int, state,
              offset: int, nsteps: int):
    """--health: the watchdog (telemetry/health.py), seeded with the run's
    starting state; under checkpoint-and-warn rank 0's rescue saves the
    last good state through the step-checkpoint manager, pinned, with the
    run geometry. None with --health off."""
    if tcfg["health"] == "off":
        return None
    from ..telemetry.health import HealthConfig, Watchdog
    on_fatal = None
    if tcfg["health"] == "checkpoint-and-warn" and rank == 0:
        from ..train.ckpt_manager import CheckpointManager
        rescue = CheckpointManager(tcfg["checkpoint"] + ".steps",
                                   keep=tcfg["ckpt_keep"])

        def on_fatal(stash):
            # pinned: the run keeps training (warn semantics), and its
            # routine saves must not rotate the one good state away
            path = rescue.save(
                stash["params"], stash["key"], tcfg["impl"],
                step=stash["step"], epoch=stash["epoch"],
                offset=stash["offset"],
                meta=_run_geometry(tcfg, dcfg, global_batch), pin=True,
                resid=stash.get("resid"))
            print(f"[health] rescue checkpoint committed: {path}",
                  file=sys.stderr, flush=True)
    watchdog = Watchdog(HealthConfig(policy=tcfg["health"]), lr=tcfg["lr"],
                        on_fatal=on_fatal, rank=rank)
    watchdog.seed_good(state, epoch=tcfg["start_epoch"], offset=offset,
                       step=tcfg["start_epoch"] * nsteps + offset)
    return watchdog


def _close_trace(tcfg, log, captures0: int) -> None:
    """End of a --telemetry run: stamp the memory gauges, write the final
    registry snapshot as the trace's last record, close the trace, and
    print rank 0's `[telemetry]` line (`xla_compiles`: the CUDA-graph
    captures of this run, the process's count less `captures0`;
    `device_peak_mb`: the card's allocator peak, None on the CPU)."""
    from .. import telemetry
    reg = telemetry.get_registry()
    telemetry.collect_memory(reg)
    snap = reg.snapshot()
    telemetry.get_tracer().snapshot(reg)
    telemetry.disable()
    rss = snap["gauges"].get("host.rss_bytes")
    dev = snap["gauges"].get("device.peak_bytes_in_use")
    captures = snap["counters"].get("xla.compiles", 0) - captures0
    log(f"[telemetry] epochs={tcfg['n_epochs']} "
        f"xla_compiles={captures} "
        f"host_rss_mb={rss // 2**20 if rss else None} "
        f"device_peak_mb={dev // 2**20 if dev is not None else None} "
        f"trace={tcfg['telemetry']}")


def _resume(tcfg, dcfg, model, mesh, kernel: str, global_batch: int) -> dict:
    """--resume: a step directory's newest intact checkpoint (params, key,
    position, residual; the run geometry checked), or a file's params and,
    from its `.rng.npz` sidecar, the key. Loads the params into `model`,
    sets tcfg's start_epoch and impl from a directory, and returns
    {"key" (None: the seed's), "offset", "resid", "consume_sidecar"}: the
    last removes the sidecar at the first save to its checkpoint's path
    (not at load: a resume that dies before its first save must leave the
    pair for the next one)."""
    from ..train.checkpoint import CheckpointError, load_checkpoint
    from ..train.ckpt_manager import (CheckpointManager,
                                      geometry_mismatch_message)
    out = {"key": None, "offset": 0, "resid": None}
    box = {"sidecar": None, "ckpt": None}

    def consume_sidecar(saved: str) -> None:
        if box["sidecar"] and (os.path.abspath(saved)
                               == os.path.abspath(box["ckpt"])):
            try:
                os.remove(box["sidecar"])
            except FileNotFoundError:
                pass
            box["sidecar"] = None

    out["consume_sidecar"] = consume_sidecar
    path = tcfg["resume"]
    if not path:
        return out
    template = model.params()
    if os.path.isdir(path):
        if tcfg["start_epoch"]:
            raise SystemExit(
                "--start_epoch conflicts with a step-checkpoint directory "
                "--resume: the manifest carries the exact resume position")
        try:
            restored = CheckpointManager(
                path, keep=tcfg["ckpt_keep"]).restore_latest(template)
        except CheckpointError as e:
            raise SystemExit(f"--resume: {e}") from None
        if restored.epoch > tcfg["n_epochs"]:
            raise SystemExit(
                f"--resume: checkpoint at epoch {restored.epoch} is past "
                f"--n_epochs {tcfg['n_epochs']} (n_epochs is the TOTAL run "
                f"length)")
        geometry = _run_geometry(tcfg, dcfg, global_batch)
        refusal = geometry_mismatch_message(
            {k: v for k, v in restored.meta.items() if k in geometry},
            geometry)
        if refusal:
            raise SystemExit("--resume: " + refusal)
        absent = sorted(k for k in geometry if k not in restored.meta)
        if absent:
            print(f"[ckpt] warning: manifest carries no run-geometry stamp "
                  f"for {absent}; cannot verify this run matches the "
                  f"checkpoint's geometry", file=sys.stderr, flush=True)
        if restored.offset and (tcfg["fused"] or kernel == "pallas_epoch"):
            raise SystemExit(
                f"--resume: checkpoint is MID-epoch (offset "
                f"{restored.offset}) and needs step-granular replay; "
                + ("--fused runs all epochs as ONE device program"
                   if tcfg["fused"] else
                   "--kernel pallas_epoch splits its dropout key once per "
                   "EPOCH")
                + " — resume with plain --cached / --kernel xla|pallas")
        carries = tcfg["ddp_comm"] == "int8" and tcfg["error_feedback"]
        if restored.resid is not None and not carries:
            print(f"[ckpt] note: checkpoint carries an int8 error-feedback "
                  f"residual this run's comm strategy never reads "
                  f"(--ddp_comm {tcfg['ddp_comm']}); ignoring it",
                  file=sys.stderr, flush=True)
        if carries and restored.resid is not None and mesh is not None:
            rows = int(restored.resid.shape[0])
            if rows != replicas(mesh):
                raise SystemExit(
                    f"--resume: checkpoint's int8 error-feedback residual "
                    f"was saved on {rows} replica(s); this run has "
                    f"{replicas(mesh)} — per-replica residuals cannot be "
                    f"re-sharded across a different mesh size (resume on "
                    f"{rows} replica(s), or restart the run fresh and lose "
                    f"one step's quantization error)")
            out["resid"] = restored.resid
        _load_params(model, restored.params)
        out["key"] = tuple(int(w) for w in restored.key_data)
        out["offset"] = restored.offset
        tcfg["start_epoch"] = restored.epoch
        # the manifest's engine describes the restored key: what follows
        # (sidecars, new step checkpoints) describes that key too
        tcfg["impl"] = restored.impl
        print(f"[ckpt] resuming from {restored.path}: step {restored.step} "
              f"(epoch {restored.epoch}, offset {restored.offset})",
              file=sys.stderr, flush=True)
        return out
    try:
        _load_params(model, load_checkpoint(path, template))
    except (CheckpointError, ValueError, OSError) as e:
        raise SystemExit(f"--resume {path}: {e}") from None
    sidecar = path + ".rng.npz"
    if os.path.exists(sidecar):
        # the outage re-exec's key chain: the resumed dropout stream goes
        # on from the stashed epoch, not from --seed
        with np.load(sidecar) as z:
            out["key"] = tuple(int(w) for w in z["key"].ravel())
            tcfg["impl"] = str(z["impl"])
        box.update(sidecar=sidecar, ckpt=path)
    return out


def _step_hook(tcfg, dcfg, global_batch: int, rank: int, world: int):
    """Rank 0's step-checkpoint hook (--ckpt_every_steps): commit params,
    key, position and the int8 residual under <--checkpoint>.steps/. A
    failed save does not stop a healthy run: it becomes a flight record
    and a stderr line. None where there is nothing to save."""
    if not tcfg["ckpt_every_steps"] or rank != 0:
        return None
    from ..telemetry import flight
    from ..train.checkpoint import CheckpointError
    from ..train.ckpt_manager import CheckpointManager
    mgr = CheckpointManager(tcfg["checkpoint"] + ".steps",
                            keep=tcfg["ckpt_keep"])
    meta = _run_geometry(tcfg, dcfg, global_batch)
    warned = [False]

    def hook(epoch, offset, step, st):
        resid = st.resid
        if resid is not None and world > 1:
            # rank 0 holds its own replicas' rows only, and fetching the
            # others' would take a collective that only rank 0 runs: the
            # checkpoint commits without it (a resume restarts from zeros,
            # losing one step's quantization error, never the run)
            resid = None
            if not warned[0]:
                warned[0] = True
                flight.record("checkpoint_resid_skipped", step=step)
                print("[ckpt] int8 residual spans the ranks of a world; "
                      "step checkpoints commit without it — a resume "
                      "reseeds a zero residual", file=sys.stderr, flush=True)
        try:
            mgr.save(st.model.params(), np.asarray(st.key, np.uint32),
                     tcfg["impl"], step=step, epoch=epoch, offset=offset,
                     meta=meta, resid=resid)
        except CheckpointError as e:
            flight.record("checkpoint_save_failed", step=step,
                          error=str(e)[:500])
            print(f"[ckpt] step checkpoint save failed (training "
                  f"continues): {e}", file=sys.stderr, flush=True)

    return hook


def _persist_and_reexec(tcfg, stash: dict, remaining: int, rank: int,
                        why: str) -> None:
    """Save the stash (rank r's params to its own file, rank 0's to
    --checkpoint, with the key in a `.rng.npz` sidecar) and replace this
    process with the trainer resuming at the next epoch, with the retries
    left. Never returns."""
    from ..train.checkpoint import save_checkpoint as save
    ckpt = tcfg["checkpoint"] or _DEFAULT_STASH
    mine = ckpt if rank == 0 else f"{ckpt}.rank{rank}"
    save(mine, stash["params"])
    np.savez(mine + ".rng.npz", key=stash["key"], impl=tcfg["impl"])
    if not tcfg["parallel"]:
        # a serial re-exec happens once (the marker survives execv); a
        # world's re-exec is bounded by the retries it passes on
        os.environ["PDMT_NO_REEXEC"] = "1"
    print(f"[outage] {why}; re-exec'ing with --resume {mine} "
          f"--start_epoch {stash['epoch'] + 1}", file=sys.stderr, flush=True)
    sys.stdout.flush()
    sys.stderr.flush()
    os.execv(sys.executable, [
        sys.executable, "-m", "pytorch_ddp_mnist_tpu_torch", "train",
        *_command_line_flags(), "--resume", mine,
        "--start_epoch", str(stash["epoch"] + 1),
        "--outage_retries", str(remaining)])


def _train_with_outage_retry(run_fit, state, tcfg, stash, cli: bool,
                             rank: int, device: torch.device, *,
                             profile=None):
    """`run_fit(state, start_epoch)`, retried through a lost card or peer
    when --outage_retries > 0 (the JAX CLI's `_train_with_outage_retry`).
    Each attempt runs, with `profile` (--profile LOGDIR), under a
    torch.profiler session.

    Serial: an error with a backend-loss signature (parallel/wireup.py
    `looks_like_backend_loss`), or any RuntimeError while a fresh process
    cannot reach the card, waits for the card (`wait_for_backend`,
    $PDMT_BACKEND_WAIT, default 1 h) and resumes in the process from the
    stash (the last completed epoch's params and key) at the next epoch,
    bitwise the unbroken run. A sticky CUDA error poisons this process's
    context, and a card that answers only a fresh process is wedged: then
    the stash is persisted and the process re-execs with --resume,
    --start_epoch and the retries left (from the command line only, once).
    A card that stays down exits by name.

    A world (--parallel) retries on the signature only (the same verdict
    on every rank), waits until a fresh process reaches the card, and
    every rank persists its stash and re-execs; the new processes meet in
    a new rendezvous. With no retries this is one plain call."""
    from ..parallel.wireup import (BackendUnavailableError,
                                   BackendWedgedError,
                                   _subprocess_backend_healthy,
                                   backend_wait_env, is_sticky_cuda_error,
                                   looks_like_backend_loss, wait_for_backend,
                                   wait_for_fresh_backend)
    from ..telemetry import flight
    from ..utils.profiling import trace
    retries, start, attempt = tcfg["outage_retries"], tcfg["start_epoch"], 0
    while True:
        try:
            with trace(profile):
                return run_fit(state, start)
        except RuntimeError as e:
            if attempt >= retries:
                raise
            if tcfg["parallel"]:
                if not looks_like_backend_loss(e):
                    raise
            elif not looks_like_backend_loss(e) and \
                    _subprocess_backend_healthy(30.0, device.type):
                raise
            attempt += 1
            flight.record("train_outage", attempt=attempt, retries=retries,
                          epoch_stash=stash["epoch"], error=str(e)[:500])
            print(f"[outage] training interrupted mid-run: {e}; waiting for "
                  f"the backend (retry {attempt}/{retries})",
                  file=sys.stderr, flush=True)
            if tcfg["parallel"]:
                try:
                    wait_for_fresh_backend(backend_wait_env(3600.0),
                                           device_type=device.type)
                except BackendUnavailableError:
                    flight.dump(reason="parallel train outage: backend "
                                       "never recovered")
                    raise SystemExit(
                        "[outage] backend did not recover within the wait "
                        "budget after a mid-run interruption of the "
                        "parallel run") from e
                _persist_and_reexec(tcfg, stash, retries - attempt, rank,
                                    "backend answers again; coordinated "
                                    "parallel resume")
            try:
                if device.type == "cuda" and is_sticky_cuda_error(e):
                    raise BackendWedgedError(
                        f"a sticky CUDA error poisoned this process's "
                        f"context: {e}")
                wait_for_backend(max_wait_s=backend_wait_env(3600.0),
                                 device_type=device.type)
            except BackendWedgedError:
                if not cli or os.environ.get("PDMT_NO_REEXEC") == "1":
                    raise
                _persist_and_reexec(tcfg, stash, retries - attempt, rank,
                                    "the card answers a fresh process but "
                                    "not this one")
            except BackendUnavailableError as be:
                flight.dump(reason="train outage: backend never recovered")
                raise SystemExit(
                    f"[outage] backend did not recover within the wait "
                    f"budget after a mid-run interruption: {be}") from e
            start = stash["epoch"] + 1
            _load_params(state.model, stash["params"])
            state = TrainState(state.model,
                               tuple(int(w) for w in stash["key"]))


def _drop_stale_stash(tcfg, rank: int) -> None:
    """A run resumed from an outage stash that no save of its own replaces
    (rank r's `.rank<r>` file; rank 0's default stash when --checkpoint is
    empty) removes it and its sidecar once it has finished."""
    path = tcfg["resume"]
    if not path or os.path.isdir(path):
        return
    stale = ((rank > 0 and path.endswith(f".rank{rank}"))
             or (rank == 0 and not tcfg["checkpoint"]
                 and os.path.basename(path) == _DEFAULT_STASH))
    if stale:
        for f in (path, path + ".rng.npz"):
            try:
                os.remove(f)
            except FileNotFoundError:
                pass


def _comm_kw(tcfg) -> dict:
    """The gradient-communication knobs of the config, as the DP step makers
    take them."""
    return {"comm": tcfg["ddp_comm"], "bf16_rounding": tcfg["bf16_rounding"],
            "overlap": tcfg["overlap"], "quant_block": tcfg["quant_block"],
            "error_feedback": tcfg["error_feedback"]}


def load_data(dcfg, runtime: Runtime, local_batch: int, cached: bool,
              log, num_workers: int = 0) -> dict:
    """The run's data: {"n_train", "test_images", "test_labels", and either
    "loader" (the streaming --netcdf loader, its sampler still to assign)
    or "train_images"/"train_labels" (uint8 (n, 28, 28) and labels)}.

    --netcdf reads mnist_{train,test}_images.nc under --path (the PnetCDF
    configurations): the streaming path gathers each batch's rows from the
    train file, the resident path reads its first --limit rows whole, and
    the test file is read whole by every rank, as the serial reference's
    collective read does (mnist_pnetcdf_cpu.py:47). The `[data]` line names
    the reader core. Otherwise the IDX files under --path, fetched first
    with --download (in a world: rank 0 fetches, then every rank waits at a
    barrier before it probes the path), else the synthetic stand-in.
    `num_workers` is the streaming NetCDF loader's read-ahead threads."""
    limit = dcfg["limit"] if dcfg["limit"] and dcfg["limit"] > 0 else None
    if dcfg["netcdf"]:
        train_nc, test_nc = (os.path.join(dcfg["path"], f"mnist_{s}_images.nc")
                             for s in ("train", "test"))
        for path in (train_nc, test_nc):
            if not os.path.exists(path):
                raise SystemExit(
                    f"--netcdf: {path} not found; produce it with `python -m "
                    f"pytorch_ddp_mnist_tpu_torch convert`")
        loader = NetCDFShardLoader(train_nc, batch_size=local_batch,
                                   num_workers=num_workers)
        n_train = min(loader.num_samples, limit or loader.num_samples)
        test_reader, _ = open_reader(test_nc)
        out = {"n_train": n_train, "loader": loader,
               "test_images": test_reader.read("images"),
               "test_labels": test_reader.read("labels")}
        why = ("" if loader.core == "native" else
               f" (the native core is off: {native_build_error()})")
        log(f"[data] --netcdf {train_nc}: {n_train} of {loader.num_samples} "
            f"rows, read by the {loader.core} core{why}")
        if cached:
            out["train_images"], out["train_labels"] = loader.read_head(
                n_train)
            out["loader"] = None
        return out
    if dcfg["download"] and runtime.initialized and runtime.size > 1:
        if runtime.rank == 0:
            try:
                download_mnist(dcfg["path"])
            except Exception as e:  # noqa: BLE001 — rank 0 must reach the
                # barrier or every other rank waits in it for good; any
                # failure lands every rank on the synthetic fallback
                print(f"[data] MNIST download failed ({e}); synthetic "
                      f"fallback will be used")
        runtime.barrier()
    train = get_mnist(dcfg["path"], train=True, download=dcfg["download"])
    test = get_mnist(dcfg["path"], train=False, download=dcfg["download"])
    return {"n_train": len(train.images[:limit]), "loader": None,
            "train_images": train.images[:limit],
            "train_labels": train.labels[:limit],
            "test_images": test.images, "test_labels": test.labels}


def main(argv=None) -> int:
    train(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
