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

Trains the reference MLP on MNIST (or the synthetic stand-in), prints the
reference epoch line every epoch and saves the reference `.pt` state_dict at
the end. It runs on CUDA device `--device` (default 0); with no card it
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
"""

from __future__ import annotations

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
from ..train.scan import check_dp_run_args, check_run_args, fit_cached


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


def train(argv=None):
    """Everything `main` does; returns (TrainState, per-epoch arrays of the
    per-step losses) for callers that check the run. A world's process
    group is torn down when it returns or raises."""
    cfg = configure(argv)
    tcfg = cfg["trainer"]
    device = resolve_device(tcfg["device"])
    # true f32 products, as the JAX package's kernels accumulate, and bf16
    # products reduced in f32, as XLA's are
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    kernel = resolve_kernel(tcfg["kernel"], tcfg["dtype"], device.type)
    try:   # the scan layer's refusals, by name, before any work
        check_run_args(kernel, tcfg["dtype"], 1, 1, tcfg["impl"])
    except ValueError as e:
        raise SystemExit(str(e)) from None
    runtime, mesh = Runtime(method="single"), None
    if tcfg["parallel"]:
        runtime, mesh = resolve_world(tcfg["wireup_method"], device)
    try:
        return _train(cfg, kernel, runtime, mesh, device)
    finally:
        runtime.finalize()


def _train(cfg, kernel: str, runtime: Runtime, mesh, device: torch.device):
    tcfg, dcfg = cfg["trainer"], cfg["data"]
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
    key = key_data(tcfg["seed"] + 1)

    if tcfg["cached"]:
        key, history = fit_cached(
            model, key, data["train_images"],
            data["train_labels"].astype(np.int32), sampler, x_test, y_test,
            epochs=tcfg["n_epochs"], batch_size=global_batch,
            lr=tcfg["lr"], kernel=kernel, impl=tcfg["impl"],
            fused=tcfg["fused"], dtype=tcfg["dtype"], mesh=mesh,
            eval_perm=eval_perm, prefetch_depth=tcfg["prefetch_depth"],
            log=log, **(_comm_kw(tcfg) if mesh is not None else {}))
        comm = fit_cached.comm
        state = TrainState(model, key,
                           comm.resid if comm is not None else None)
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
            step = make_torch_dropout_train_step(tcfg["lr"], tcfg["seed"])
        else:
            step = (make_fused_train_step(tcfg["lr"], dtype=tcfg["dtype"])
                    if kernel == "pallas" else None)
        state, history = fit(TrainState(model, key), loader, x_test,
                             y_test, epochs=tcfg["n_epochs"],
                             batch_size=global_batch,
                             lr=None if step else tcfg["lr"], train_step=step,
                             eval_perm=eval_perm,
                             input_workers=tcfg["input_workers"],
                             prefetch_depth=tcfg["prefetch_depth"],
                             model_apply=spec.apply, log=log)
    if runtime.initialized and device.type == "cuda":
        # stderr: stdout stays the machine-parseable epoch lines
        print(f"[world] rank {rank}: peak device memory "
              f"{torch.cuda.max_memory_allocated(device) / 2**20:.1f} MiB on "
              f"{device} ({name})", file=sys.stderr, flush=True)
    if tcfg["checkpoint"] and rank == 0:
        save_checkpoint(tcfg["checkpoint"], state.model.params())
        print(f"saved checkpoint to {tcfg['checkpoint']}")
    return state, history


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
