"""Config / CLI layer of the serial trainer (port of a subset of
`pytorch_ddp_mnist_tpu/train/config.py`, plus the `--kernel auto` policy of
`train/scan.py::resolve_kernel` and the JAX CLI's refusals of unsound
combinations of `--cached`, `--fused` and `--kernel pallas_epoch`), with
`--parallel` over the mesh of the local cards or over a world of processes
(`--wireup_method`, parallel/wireup.py).

The ported flags keep the JAX trainer's names and defaults, so launch lines
carry over, except `--checkpoint`, which defaults to `model.pt` (the port
writes the reference's torch state_dict; msgpack needs flax). Every other
flag of the JAX trainer is recognised and rejected by name, with the
ROADMAP.md item that will port it.
"""

from __future__ import annotations

import argparse
from typing import Any, Dict

from ..ops.epoch_step import EPOCH_KERNEL_MAX_BATCH
from ..parallel.wireup import METHOD_ALIASES, METHODS

# the JAX trainer's --wireup_method choices and the reference's spellings,
# which also name a backend (parallel/wireup.py); 'tpu' is refused by name
WIREUP_CHOICES = METHODS + tuple(METHOD_ALIASES) + ("tpu",)

# flag of the JAX trainer -> where ROADMAP.md queues its port
NOT_YET_PORTED = {
    "--netcdf": "queue 1, item 1 (data plane)",
    "--download": "queue 1, item 1 (data plane)",
    "--hdf5": "queue 1, item 7 (training CLI)",
    "--label_map": "queue 1, item 7 (training CLI)",
    "--sampler_rng": "queue 1, item 3 (sampler)",
    "--dropout_rng": "queue 1, item 4 (train loop)",
    "--eval_shuffle": "queue 1, item 4 (train loop)",
    "--resume": "queue 1, item 8 (step checkpoints)",
    "--start_epoch": "queue 1, item 8 (step checkpoints)",
    "--ckpt_every_steps": "queue 1, item 8 (step checkpoints)",
    "--ckpt_keep": "queue 1, item 8 (step checkpoints)",
    "--fault": "queue 1, item 8 (step checkpoints)",
    "--outage_retries": "queue 1, item 8 (step checkpoints)",
    "--num_workers": "queue 1, item 10 (input pipeline)",
    "--input_workers": "queue 1, item 10 (input pipeline)",
    "--prefetch_depth": "queue 1, item 10 (input pipeline)",
    "--model": "queue 1, item 11 (workload zoo)",
    "--param_scale": "queue 1, item 11 (workload zoo)",
    "--ddp_comm": "queue 1, item 11 (gradient communication)",
    "--ddp-comm": "queue 1, item 11 (gradient communication)",
    "--overlap": "queue 1, item 11 (gradient communication)",
    "--quant_block": "queue 1, item 11 (gradient communication)",
    "--error_feedback": "queue 1, item 11 (gradient communication)",
    "--bf16_rounding": "queue 1, item 11 (gradient communication)",
    "--telemetry": "queue 1, item 12 (telemetry)",
    "--journal": "queue 1, item 12 (telemetry)",
    "--profile": "queue 1, item 12 (telemetry)",
    "--profile_dispatch": "queue 1, item 12 (telemetry)",
    "--health": "queue 1, item 12 (telemetry)",
    "--metrics_port": "queue 1, item 12 (telemetry)",
    "--elastic": "queue 1, item 13 (elastic training)",
    "--reshape": "queue 1, item 13 (elastic training)",
}


def configure(argv=None) -> Dict[str, Dict[str, Any]]:
    """Parse CLI args into the nested {trainer: {...}, data: {...}} config.
    Exits by name on a flag or value that is not ported yet."""
    p = argparse.ArgumentParser(
        prog="python -m pytorch_ddp_mnist_tpu_torch train",
        description="MNIST trainer, PyTorch/CUDA port of pytorch_ddp_mnist_tpu "
                    "(serial streaming path)", allow_abbrev=False)
    t = p.add_argument_group("trainer")
    t.add_argument("--batch_size", type=int, default=128)
    t.add_argument("--n_epochs", "--epochs", type=int, default=1)
    t.add_argument("--lr", type=float, default=0.01)
    t.add_argument("--seed", type=int, default=0)
    t.add_argument("--parallel", action="store_true",
                   help="data-parallel: over a launcher's world of processes "
                        "(one replica a rank, on the card of its local rank "
                        "or on the CPU with --device cpu), else over the "
                        "mesh of every local CUDA card (one card is a "
                        "1-replica mesh) or one CPU replica with --device "
                        "cpu: the per-rank batch is --batch_size, the "
                        "per-step gradient mean is in fixed replica order")
    t.add_argument("--wireup_method", choices=WIREUP_CHOICES, default="auto",
                   help="how --parallel finds its world: auto (SLURM, Open "
                        "MPI, MPICH, then RANK/WORLD_SIZE, else one "
                        "process), single, slurm, openmpi, mpich, env; the "
                        "reference's nccl-slurm, nccl-openmpi, nccl-mpich "
                        "ask for NCCL and gloo for gloo")
    t.add_argument("--device", type=str, default="0",
                   help="CUDA device ordinal (default 0), or 'cpu' to run "
                        "the plain PyTorch versions of the kernels on the CPU")
    t.add_argument("--checkpoint", type=str, default="model.pt",
                   help="final save as the reference's torch state_dict "
                        "(.pt/.pth); '' skips the save")
    t.add_argument("--dtype", choices=("float32", "bfloat16"), default="float32",
                   help="bfloat16: bf16 operands of the products with f32 "
                        "master weights in the kernels (and the whole "
                        "forward/backward of --cached --kernel xla); the "
                        "streaming --kernel xla step trains in float32, as "
                        "the JAX trainer's does")
    t.add_argument("--kernel", choices=("auto", "xla", "pallas", "pallas_rng",
                                        "pallas_epoch"), default="auto",
                   help="train step: 'pallas' is the fused step (the CUDA "
                        "kernel on a card, its plain version on the CPU), "
                        "'pallas_rng' the fused step with its dropout drawn "
                        "in the kernel (--cached only), 'xla' the plain "
                        "autograd step, 'pallas_epoch' the whole-epoch kernel "
                        "(--cached only), 'auto' (default) the fused step on "
                        "CUDA with float32 and 'xla' otherwise")
    t.add_argument("--cached", action="store_true",
                   help="keep the dataset on the device as uint8 and run "
                        "each epoch with no per-step host sync")
    t.add_argument("--fused", action="store_true",
                   help="with --cached: run all epochs with one fetch at the "
                        "end (per-epoch lines printed after)")
    t.add_argument("--impl", choices=("threefry2x32", "rbg"), default=None,
                   help="PRNG engine of the train key. threefry2x32 "
                        "(default) is jax's reference stream: the masks are "
                        "the JAX trainer's for the same seed; rbg (--cached "
                        "--kernel pallas_epoch only) selects the epoch "
                        "kernel's own Philox stream (same keep distribution, "
                        "other masks)")
    d = p.add_argument_group("data")
    d.add_argument("--path", "--data_path", type=str, default="data/",
                   help="dataset root (IDX files); synthetic data otherwise")
    d.add_argument("--limit", "--data_limit", type=int, default=-1,
                   help="truncate the train set to N samples")
    a, rest = p.parse_known_args(argv)
    for arg in rest:
        flag = arg.split("=", 1)[0]
        if flag in NOT_YET_PORTED:
            raise SystemExit(f"{flag} is not ported to the PyTorch package "
                             f"yet; see ROADMAP.md {NOT_YET_PORTED[flag]}")
    if rest:
        p.error(f"unrecognized arguments: {' '.join(rest)}")
    if a.kernel in ("pallas_rng", "pallas_epoch") and not a.cached:
        raise SystemExit(f"--kernel {a.kernel} runs inside the epoch scan; "
                         f"add --cached")
    if a.kernel == "pallas_epoch" and (
            a.batch_size % 8 != 0 or a.batch_size > EPOCH_KERNEL_MAX_BATCH):
        raise SystemExit(
            f"--kernel pallas_epoch needs a batch divisible by 8 and <= "
            f"{EPOCH_KERNEL_MAX_BATCH} (one block per step); got "
            f"{a.batch_size} — use --kernel pallas instead")
    if a.fused and not a.cached:
        raise SystemExit("--fused fuses the epoch scan; add --cached")
    if a.impl == "rbg" and not a.cached:
        raise SystemExit(
            "--impl rbg selects the epoch kernel's Philox stream (--cached "
            "--kernel pallas_epoch); the streaming path draws the TPU rbg "
            "stream per step in the JAX trainer, which the port does not "
            "have. Use --impl threefry2x32 here")
    if a.wireup_method == "tpu":
        raise SystemExit(
            "--wireup_method tpu reads a Cloud TPU pod's metadata; it has no "
            "counterpart on CUDA machines. Launch under torchrun, SLURM or "
            "MPI (--wireup_method auto), or use --wireup_method env "
            "(ROADMAP.md queue 1, item 8)")
    if a.wireup_method != "auto" and not a.parallel:
        raise SystemExit(f"--wireup_method {a.wireup_method} forms the world "
                         f"of --parallel; add --parallel")
    if a.checkpoint and not a.checkpoint.endswith((".pt", ".pth")):
        raise SystemExit(f"--checkpoint {a.checkpoint!r}: the PyTorch package "
                         f"writes .pt/.pth state_dicts only (msgpack needs "
                         f"flax)")
    return {
        "trainer": {
            "batch_size": a.batch_size, "n_epochs": a.n_epochs, "lr": a.lr,
            "seed": a.seed, "device": a.device, "checkpoint": a.checkpoint,
            "dtype": a.dtype, "kernel": a.kernel, "cached": a.cached,
            "fused": a.fused, "impl": a.impl or "threefry2x32",
            "parallel": a.parallel, "wireup_method": a.wireup_method,
        },
        "data": {"path": a.path, "limit": a.limit},
    }


def resolve_kernel(kernel: str, dtype: str, device_type: str) -> str:
    """The `--kernel auto` policy: the fused step on CUDA with float32, the
    plain autograd step ('xla') otherwise. Explicit choices pass through."""
    if kernel != "auto":
        return kernel
    return "pallas" if device_type == "cuda" and dtype == "float32" else "xla"
